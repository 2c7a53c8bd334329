"""Where nms_sweep's time goes inside its one block, on the card.

    python3 scripts/nms_phase_split.py [--source PATH] [--k 256] [--reps 50]

Builds a copy of the kernel source (default: the package's
``csrc/nms_sweep.cu``) with ``clock64()`` stamps taken by thread 0 of block
0 at the kernel's start and after each ``__syncthreads()`` and
``cluster.sync()``, runs it on seeded
random boxes at K candidates and prints the SM cycles between consecutive
stamps (the phases: staging, the IoU build, the sweep), averaged over the
repetitions, with their shares. The committed source carries no switch for
this: the stamps are spliced into a copy under ``nnstreamer_tpu_torch/
_build/``. Any revision of the kernel with either C interface of the
package (with or without the scratch argument) can be measured, so a
parent commit's source can be held beside the current one.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nnstreamer_tpu_torch.ops.kernels import build  # noqa: E402

_PRELUDE = """
#include <cuda_runtime.h>
__device__ long long nns_stamps[64];
__device__ int nns_nstamps;
__device__ __forceinline__ void nns_stamp() {
  if (threadIdx.x == 0 && blockIdx.x == 0 && nns_nstamps < 64) {
    nns_stamps[nns_nstamps++] = clock64();
  }
}
extern "C" int nns_read_stamps(long long* out, int* n) {
  cudaError_t e = cudaMemcpyFromSymbol(out, nns_stamps, sizeof(long long) * 64);
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(n, nns_nstamps, sizeof(int));
  const int zero = 0;
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(nns_nstamps, &zero, sizeof(int));
  return static_cast<int>(e);
}
"""


def instrument(src: str) -> str:
    """The source with a stamp at each kernel's start and after each
    block or cluster barrier."""
    src = re.sub(r"(__global__[^{]*?nms_sweep_kernel\s*\([^)]*\)\s*\{)",
                 r"\1 nns_stamp();", src, flags=re.S)
    for barrier in ("__syncthreads();", "cluster.sync();"):
        src = src.replace(barrier, f"{barrier} nns_stamp();")
    return _PRELUDE + src


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", default=os.path.join(build.CSRC, "nms_sweep.cu"))
    ap.add_argument("--k", type=int, default=256)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("nms_phase_split: no CUDA device", file=sys.stderr)
        return 1
    with open(args.source) as f:
        src = f.read()
    new_abi = "scratch" in src
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    tag = f"nms_split_{os.getpid()}"
    cu = os.path.join(build.BUILD_DIR, f"{tag}.cu")
    so = os.path.join(build.BUILD_DIR, f"lib{tag}.so")
    with open(cu, "w") as f:
        f.write(instrument(src))
    subprocess.run([build.nvcc_path(), *build.COMMON_FLAGS,
                    *build.KERNEL_FLAGS["nms_sweep"], "-o", so, cu],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    p = ctypes.c_void_p
    fn = lib.nns_nms_sweep
    fn.argtypes = [p] * (7 if new_abi else 6) + [ctypes.c_int, ctypes.c_float,
                                                 ctypes.c_float, p]
    fn.restype = ctypes.c_int
    lib.nns_read_stamps.argtypes = [p, p]

    rng = np.random.default_rng(0)
    k = args.k
    c = rng.uniform(0.0, 1.0, (k, 2)).astype(np.float32)
    wh = rng.uniform(0.02, 0.4, (k, 2)).astype(np.float32)
    cols = [c[:, 0], c[:, 1], c[:, 0] + wh[:, 0], c[:, 1] + wh[:, 1],
            np.sort(rng.uniform(0, 1, k).astype(np.float32))[::-1].copy()]
    cols = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in cols]
    out = torch.empty(k, device="cuda")
    scratch = torch.empty(max(1, -(-k // 32) * (k | 1)), dtype=torch.int32,
                          device="cuda")
    stream = p(torch.cuda.current_stream().cuda_stream)
    stamps = (ctypes.c_longlong * 64)()
    n = ctypes.c_int()
    sums = None
    for rep in range(args.reps + 1):
        extra = [p(scratch.data_ptr())] if new_abi else []
        rc = fn(*(p(x.data_ptr()) for x in cols), p(out.data_ptr()), *extra, k,
                0.5, 0.5, stream)
        torch.cuda.synchronize()
        if rc != 0 or lib.nns_read_stamps(ctypes.byref(stamps), ctypes.byref(n)) != 0:
            raise RuntimeError(f"launch or stamp read failed ({rc})")
        d = np.diff(np.array(stamps[:n.value], dtype=np.int64))
        if rep == 0:
            continue  # warm-up
        sums = d if sums is None else sums + d
    mean = sums / args.reps
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True).stdout.split()[0]
    print(f"nms_sweep phases ({os.path.relpath(args.source)}, K {k}, "
          f"{args.reps} runs, SM clock {clock} MHz after the runs):")
    names = ["staging", "build", "sweep", "rest"]
    for i, cyc in enumerate(mean):
        name = names[i] if i < len(names) else f"phase {i}"
        print(f"  {name}: {cyc:.1f} cycles ({cyc / mean.sum():.3f}) = "
              f"{cyc / float(clock):.3f} us")
    print(f"  stamped total: {mean.sum():.1f} cycles = "
          f"{mean.sum() / float(clock):.3f} us")
    os.remove(cu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
