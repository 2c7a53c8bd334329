"""The readings the comparison's limits are set from, for one cell, in one
process: for each seed, a short window of the cell as ``run.py`` drives
it, its compared numbers against the reference (the lower readings), and
the control's (the reference in the lower precision in the program's
place, judged on the same frames: the upper readings).

    python benchmark/calibrate.py --workload <cell> --seeds 1,2,3 [--seconds 4]

Prints one JSON line a seed. Not run by the benchmark's own runs.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "benchmark", ".cache", "triton"))


def readings(workload: str, seed: int, seconds: float, device, config=None, streams=None,
             control: bool = True) -> dict:
    """One seed's program and control numbers."""
    import torch

    from benchmark.harness import cell as cellmod
    from benchmark.harness.cell import Cell
    from benchmark.harness.manifest import Manifest

    cell = Cell(Manifest(ROOT), workload, seed, device, streams=streams, config=config)
    try:
        cell.build()
        cell.warm(timeout=cellmod.FIRST_TIMEOUT_S)
        cell.measure(seconds, False)
        rec = cell.records()
        cell.stop()
        cell.free()
        program = cell.check()
        out = {"seed": seed, "program": program["numbers"], "compared": program["compared"],
               "failed": rec["failed"], "done": rec["done"], "work": cell.work}
        if control:
            keys = sorted(cell.captured)
            frames = cell.model_frames(keys)
            refs = cell.maker.reference(cell.state, frames, device)
            ctl = cell.maker.reference(cell.state, frames, device, control=True)
            outs = [cell.maker.as_output(cell.state, c) for c in ctl]
            out["control"] = cell.maker.judge(cell.state, list(zip(outs, refs)))
        torch.backends.cudnn.allow_tf32 = True
        return out
    finally:
        cell.cleanup()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control", type=int, default=1)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    device = torch.device("cuda", 0)
    for s in args.seeds.split(","):
        t0 = time.perf_counter()
        r = readings(args.workload, int(s), args.seconds, device, control=bool(args.control))
        r["s"] = time.perf_counter() - t0
        print(json.dumps(r, default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
