"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds BENCHMARK.json. Exits non-zero,
printing no result, without enough cards or when JAX or the JAX package
has loaded in the process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "benchmark", ".cache")
# every build and kernel cache at a fixed path inside the checkout; the
# program's own kernels build into nnstreamer_tpu_torch/_build there
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--streams", type=int, default=None,
                    help="override the cell's stream count (the camera sweep)")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark.harness import cell

    return cell.run(ROOT, args, T_START)


if __name__ == "__main__":
    sys.exit(main())
