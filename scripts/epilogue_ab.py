"""Time class_reduce and segment_colorize against an earlier revision, in
turns, on the card.

    git archive REV | tar -x -C .scratch/earlier
    python3 scripts/epilogue_ab.py --earlier .scratch/earlier [--rounds 2]

``--earlier`` is the root of an earlier revision's tree. Its
``nnstreamer_tpu_torch/ops/kernels/epilogue.py`` is loaded under another
name and called through its own wrappers (``class_reduce(x)`` and
``segment_colorize(x, palette, pre_argmaxed)``), so their C interfaces may
differ from this revision's; its kernels build into that tree's own
``_build``. Each case is timed in the order earlier, current, current,
earlier (``--rounds`` times), as ``chip_smoke.py`` times a kernel: device
time per call from a CUDA graph of 20 calls replayed 20 times, after its
untimed warm-up rounds. The cases are the main paths' shapes: SSD's (2916,
91)[:, 1:] scores; DeepLab's (257, 257, 21) logits, the same input every
call (it stays in L2) and cycled over 20 inputs (111 MB, so each call
reads device memory); a batched frame's slice (4 bytes off 16-byte
alignment); strided (257, 257, 30)[..., 4:25] rows; 257 x 257 int32 ids.
Then, in turns with the current kernels: class_reduce against a probe
that makes the same loads and stores with a sum in place of the
comparisons (what one round trip costs), and the ids form against a probe
that takes 4 ids a thread in 16-byte loads and stores. Last, the launch
floor (a one-element fill_) and an empty kernel of each current grid,
replayed the same way. Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import os
import subprocess
import sys
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from nnstreamer_tpu_torch.ops.kernels import build  # noqa: E402
from nnstreamer_tpu_torch.ops.kernels import epilogue as ep  # noqa: E402

_P = ctypes.c_void_p
_PROBES = """
#include <cuda_runtime.h>
__global__ void nns_empty_kernel() {}
extern "C" int nns_empty(int grid, int block, void* stream) {
  nns_empty_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
// class_reduce's loads at a warp a row (3 a lane, all issued first), then
// a sum of their bits, one warp reduction and the two stores: the round
// trip without the comparisons
__global__ void nns_loads_kernel(const float* __restrict__ x, float* __restrict__ best,
                                 int* __restrict__ index, int n, int l, long long rs) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  const bool live = row < n;
  const int len = live ? l : 0;
  const float* xr = x + (live ? row : 0) * rs;
  unsigned acc = 0;
  for (int j0 = lane; j0 < len; j0 += 96) {
    float v[3];
#pragma unroll
    for (int m = 0; m < 3; ++m) v[m] = j0 + 32 * m < len ? xr[j0 + 32 * m] : 0.0f;
#pragma unroll
    for (int m = 0; m < 3; ++m) acc += __float_as_uint(v[m]);
  }
  acc = __reduce_add_sync(0xffffffffu, acc);
  if (live && lane == 0) {
    best[row] = __uint_as_float(acc);
    index[row] = static_cast<int>(acc);
  }
}
extern "C" int nns_loads(const float* x, float* best, int* index, int n, int l, long long rs,
                         void* stream) {
  nns_loads_kernel<<<(n + 7) / 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, best, index, n, l, rs);
  return static_cast<int>(cudaGetLastError());
}
// the ids form with 4 ids a thread in 16-byte loads and stores (the
// package's form takes one id a thread), 128 threads a block; the same
// lookup (ids in [0, n) here, as the caller passes)
__global__ void nns_ids16_kernel(const int* __restrict__ ids, const unsigned* __restrict__ pal,
                                 int n, unsigned* __restrict__ out, long long p) {
  __shared__ unsigned spal[256];
  const long long i = (static_cast<long long>(blockIdx.x) * 128 + threadIdx.x) * 4;
  int4 v = make_int4(0, 0, 0, 0);
  if (i + 4 <= p) v = __ldg(reinterpret_cast<const int4*>(ids + i));
  for (int k = threadIdx.x; k < n; k += 128) spal[k] = __ldg(pal + k);
  __syncthreads();
  const uint4 w = make_uint4(spal[v.x], spal[v.y], spal[v.z], spal[v.w]);
  if (i + 4 <= p) *reinterpret_cast<uint4*>(out + i) = w;
}
extern "C" int nns_ids16(const int* ids, const unsigned* pal, int n, unsigned* out, long long p,
                         void* stream) {
  nns_ids16_kernel<<<static_cast<unsigned>((p + 511) / 512), 128, 0,
                     static_cast<cudaStream_t>(stream)>>>(ids, pal, n, out, p);
  return static_cast<int>(cudaGetLastError());
}
"""


def _earlier_epilogue(tree: str):
    """The earlier tree's epilogue module, loaded as ``earlier_kernels``
    (the package's ``__init__`` is not run: only ``epilogue`` and the
    ``build`` it imports)."""
    pkg = types.ModuleType("earlier_kernels")
    pkg.__path__ = [os.path.join(tree, "nnstreamer_tpu_torch", "ops", "kernels")]
    sys.modules["earlier_kernels"] = pkg
    return importlib.import_module("earlier_kernels.epilogue")


def _probes() -> ctypes.CDLL:
    out = os.path.join(build.BUILD_DIR, "ab")
    os.makedirs(out, exist_ok=True)
    src, lib = os.path.join(out, "probes.cu"), os.path.join(out, "libprobes.so")
    with open(src, "w") as f:
        f.write(_PROBES)
    proc = subprocess.run([build.nvcc_path(), *build.COMMON_FLAGS, "-o", lib, src],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the probes:\n{proc.stdout}{proc.stderr}")
    probes = ctypes.CDLL(lib)
    probes.nns_empty.argtypes = [ctypes.c_int, ctypes.c_int, _P]
    probes.nns_loads.argtypes = [_P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, _P]
    probes.nns_ids16.argtypes = [_P, _P, ctypes.c_int, _P, ctypes.c_longlong, _P]
    return probes


def _stream() -> _P:
    return _P(torch.cuda.current_stream().cuda_stream)


def _turns(probe: list, rounds: int) -> str:
    times = [(who, cs._device_ms(fn)) for _ in range(rounds) for who, fn in probe + probe[::-1]]
    return ", ".join(f"{who} {t * 1e3:.4f}" for who, t in times) + " us"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier", required=True, help="root of an earlier revision's tree")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("epilogue_ab: no CUDA device", file=sys.stderr)
        return 1
    old = _earlier_epilogue(os.path.abspath(args.earlier))
    probes = _probes()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    scores = normal(2916, 91)[:, 1:]
    n, l = scores.shape
    pal = torch.from_numpy(rng.integers(0, 256, (256, 4), dtype=np.uint8)).to(dev)
    p = 257 * 257
    logits = normal(257, 257, 21)
    cold = [normal(257, 257, 21) for _ in range(20)]
    slice1 = normal(4, 257, 257, 21)[1:2][0]
    strided = normal(257, 257, 30)[..., 4:25]
    ids = torch.from_numpy(rng.integers(-300, 300, (257, 257)).astype(np.int32)).to(dev)
    turn = [0]

    def cycled(mod):
        def call():
            turn[0] = (turn[0] + 1) % len(cold)
            return mod.segment_colorize(cold[turn[0]], pal)
        return call

    cases = {
        "class_reduce (2916, 91)[:, 1:]": lambda m: lambda: m.class_reduce(scores),
        "segment_colorize (257, 257, 21), one input":
            lambda m: lambda: m.segment_colorize(logits, pal),
        "segment_colorize (257, 257, 21), 20 inputs cycled": cycled,
        "segment_colorize batched slice 1 (4 bytes off 16)":
            lambda m: lambda: m.segment_colorize(slice1, pal),
        "segment_colorize strided (257, 257, 30)[..., 4:25]":
            lambda m: lambda: m.segment_colorize(strided, pal),
        "segment_colorize ids 257x257 int32":
            lambda m: lambda: m.segment_colorize(ids, pal, pre_argmaxed=True),
    }
    cs._settle_timing(dev)
    for name, make in cases.items():
        print(f"{name}: " + _turns([("earlier", make(old)), ("current", make(ep))], args.rounds),
              flush=True)

    best = torch.empty(n, device=dev)
    index = torch.empty(n, device=dev, dtype=torch.int32)
    print("class_reduce against its loads alone (a warp a row, 3 loads a lane, a sum, one "
          "redux, two stores): " + _turns(
              [("loads only", lambda: probes.nns_loads(
                  scores.data_ptr(), best.data_ptr(), index.data_ptr(), n, l, scores.stride(0),
                  _stream())),
               ("class_reduce", lambda: ep.class_reduce(scores))], args.rounds), flush=True)
    # the 16-byte ids form, on ids in [0, 256) and a 4-aligned length (66048)
    pos = torch.from_numpy(rng.integers(0, 256, 66048).astype(np.int32)).to(dev)
    canvas = torch.empty((66048, 4), device=dev, dtype=torch.uint8)

    def ids16():
        return probes.nns_ids16(pos.data_ptr(), pal.data_ptr(), 256, canvas.data_ptr(), 66048,
                                _stream())

    ids16()
    if not torch.equal(canvas, ep.segment_colorize_plain(pos, pal, pre_argmaxed=True)):
        raise AssertionError("the 16-byte ids probe differs from the plain version")
    print("segment_colorize ids, 66048 int32 in [0, 256): " + _turns(
        [("16-byte form", ids16),
         ("package", lambda: ep.segment_colorize(pos, pal, pre_argmaxed=True))], args.rounds),
        flush=True)
    # the current grids: class_reduce a warp a row, 8 rows a block; both
    # colorize forms at C 21 take 256 pixels a block
    grids = {"class_reduce": -(-n // 8), "segment_colorize": -(-p // 256)}
    floor = cs._launch_floor_ms(dev)
    print(f"launch floor (one-element fill_): {floor * 1e3:.4f} us; " + "; ".join(
        f"empty kernel of {k}'s grid {g}x256: "
        f"{cs._device_ms(lambda: probes.nns_empty(g, 256, _stream())) * 1e3:.4f} us"
        for k, g in grids.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
