"""Time the epilogue's and the prologue's kernels against an earlier
revision, in turns, on the card.

    git archive REV | tar -x -C .scratch/earlier
    python3 scripts/epilogue_ab.py --earlier .scratch/earlier [--rounds 2]
        [--only epilogue|prologue] [--label NAME]

``--earlier`` is the root of an earlier revision's tree (or of any other
tree: ``--label`` names it in the output). Its
``nnstreamer_tpu_torch/ops/kernels/epilogue.py`` and ``preprocess.py`` are
loaded under another name and called through their own wrappers
(``class_reduce(x)``, ``segment_colorize(x, palette, pre_argmaxed)``,
``normalize_u8(x, scale, bias, out_dtype)``, ``quantize_affine(x, scale,
zero_point)``), so their C interfaces may differ from this revision's; its
kernels build into that tree's own ``_build``. Each case is timed in the
order earlier, current, current, earlier (``--rounds`` times), as
``chip_smoke.py`` times a kernel: device time per call from a CUDA graph of
20 calls replayed 20 times, after its untimed warm-up rounds.

Epilogue (``class_reduce``, ``segment_colorize``): the main paths' shapes: SSD's (2916,
91)[:, 1:] scores; DeepLab's (257, 257, 21) logits, the same input every
call (it stays in L2) and cycled over 20 inputs (111 MB, so each call
reads device memory); a batched frame's slice (4 bytes off 16-byte
alignment); strided (257, 257, 30)[..., 4:25] rows; 257 x 257 int32 ids.
Then, in turns with the current kernels: class_reduce against a probe
that makes the same loads and stores with a sum in place of the
comparisons (what one round trip costs), and the ids form against a probe
that takes 4 ids a thread in 16-byte loads and stores. Last, the launch
floor (a one-element fill_) and an empty kernel of each current grid,
replayed the same way.

Prologue (``normalize_u8``, ``quantize_affine``): first, every case's
output from the two trees must agree bit for bit. Then uint8 to bf16 and
to float32 and float32 to uint8 at 1920x1080x3 and 224x224x3, inputs
cycled over 100 MB as ``chip_smoke.py`` cycles them, each in the order
earlier, current, library, library, current, earlier (the library: one
PyTorch call of the same function, ``torch.add(bias, x, alpha=scale,
out=y)`` and ``torch.quantize_per_tensor``); the element path (a uint8
frame one byte off alignment, to float32) and one 1080p input replayed
from L2, in turns with the earlier tree; at 224, the current uint8 to
float32 beside a probe that moves the same bytes without the arithmetic
(one vector a thread), the kernel writing into one fixed buffer (as the
probe does) and an empty kernel of one block per SM; last, each
tree's registers and spills by instantiation (its build's ``-Xptxas -v``
log) and the current tiling.

Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import os
import shutil
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
from nnstreamer_tpu_torch.ops.kernels import preprocess as pp  # noqa: E402

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
// normalize_u8's round trip to float32 without its arithmetic: 4 bytes in
// and 16 out a thread (each byte widened to a word), one vector a thread
__global__ void nns_widen_kernel(const unsigned* __restrict__ x, uint4* __restrict__ y,
                                 long long n4) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i < n4) {
    const unsigned w = x[i];
    y[i] = make_uint4(w & 255u, (w >> 8) & 255u, (w >> 16) & 255u, w >> 24);
  }
}
extern "C" int nns_widen(const void* x, void* y, long long n4, void* stream) {
  nns_widen_kernel<<<static_cast<unsigned>((n4 + 255) / 256), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(x), static_cast<uint4*>(y), n4);
  return static_cast<int>(cudaGetLastError());
}
"""


def _earlier(tree: str, module: str):
    """The earlier tree's kernel module ``module`` (``epilogue`` or
    ``preprocess``), loaded as ``earlier_kernels.<module>`` (the package's
    ``__init__`` is not run: only the module and what it imports from
    ``ops/kernels``)."""
    if "earlier_kernels" not in sys.modules:
        pkg = types.ModuleType("earlier_kernels")
        pkg.__path__ = [os.path.join(tree, "nnstreamer_tpu_torch", "ops", "kernels")]
        sys.modules["earlier_kernels"] = pkg
    return importlib.import_module(f"earlier_kernels.{module}")


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
    probes.nns_widen.argtypes = [_P, _P, ctypes.c_longlong, _P]
    return probes


def _stream() -> _P:
    return _P(torch.cuda.current_stream().cuda_stream)


def _turns(probe: list, rounds: int) -> str:
    times = [(who, cs._device_ms(fn)) for _ in range(rounds) for who, fn in probe + probe[::-1]]
    return ", ".join(f"{who} {t * 1e3:.4f}" for who, t in times) + " us"


def _ptxas(log: str) -> list:
    """(kernel, registers, spill stores and loads) of each entry function
    in an ``nvcc -Xptxas -v`` log, demangled where ``c++filt`` is there."""
    rows, name, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line and name:
            spill = line.strip().split(", ", 1)[1]
        elif "Used" in line and "registers" in line and name:
            rows.append((name, line.split("Used ")[1].split(" registers")[0], spill))
            name = None
    if rows and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                             capture_output=True, text=True, timeout=60).stdout.splitlines()
        rows = [(n, r, s) for n, (_, r, s) in zip(out, rows)]
    return rows


def epilogue(old, probes, dev, rng, rounds: int, label: str) -> None:
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
    for name, make in cases.items():
        print(f"{name}: " + _turns([(label, make(old)), ("current", make(ep))], rounds),
              flush=True)

    best = torch.empty(n, device=dev)
    index = torch.empty(n, device=dev, dtype=torch.int32)
    print("class_reduce against its loads alone (a warp a row, 3 loads a lane, a sum, one "
          "redux, two stores): " + _turns(
              [("loads only", lambda: probes.nns_loads(
                  scores.data_ptr(), best.data_ptr(), index.data_ptr(), n, l, scores.stride(0),
                  _stream())),
               ("class_reduce", lambda: ep.class_reduce(scores))], rounds), flush=True)
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
         ("package", lambda: ep.segment_colorize(pos, pal, pre_argmaxed=True))], rounds),
        flush=True)
    # the current grids: class_reduce a warp a row, 8 rows a block; both
    # colorize forms at C 21 take 256 pixels a block
    grids = {"class_reduce": -(-n // 8), "segment_colorize": -(-p // 256)}
    floor = cs._launch_floor_ms(dev)
    print(f"launch floor (one-element fill_): {floor * 1e3:.4f} us; " + "; ".join(
        f"empty kernel of {k}'s grid {g}x256: "
        f"{cs._device_ms(lambda: probes.nns_empty(g, 256, _stream())) * 1e3:.4f} us"
        for k, g in grids.items()), flush=True)


def prologue(old, probes, dev, rng, rounds: int, label: str, tree: str) -> None:
    scale, zp = 1 / 127.5, 128
    frames = {shape: torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
              for shape in ((224, 224, 3), (1080, 1920, 3))}
    n_hd = frames[(1080, 1920, 3)].numel()
    unaligned = torch.from_numpy(rng.integers(0, 256, n_hd + 1, dtype=np.uint8)).to(dev)[1:]
    floats = torch.from_numpy(np.concatenate([
        [np.nan, np.inf, -np.inf, 1e9, -1e9, -0.0],
        rng.uniform(-1.2, 1.2, n_hd - 6)]).astype(np.float32)).to(dev)
    u8s, f32s = (*frames.values(), unaligned), (floats, floats[3:])
    for name, inputs, call in (
            ("normalize_u8 uint8 -> bf16", u8s, lambda m, x: m.normalize_u8(x)),
            ("normalize_u8 uint8 -> float32", u8s,
             lambda m, x: m.normalize_u8(x, out_dtype=torch.float32)),
            ("normalize_u8 float32 -> bf16", f32s, lambda m, x: m.normalize_u8(x)),
            ("quantize_affine float32 -> uint8", f32s,
             lambda m, x: m.quantize_affine(x, scale, zp)),
            ("quantize_affine bf16 -> uint8", f32s,
             lambda m, x: m.quantize_affine(x.to(torch.bfloat16), scale, zp))):
        for x in inputs:
            a, b = call(old, x), call(pp, x)
            torch.cuda.synchronize()
            if not torch.equal(a.view(torch.uint8), b.view(torch.uint8)):
                raise AssertionError(f"{name} {tuple(x.shape)}: {label} and current differ")
    print(f"prologue: {label} and current agree bit for bit on every case", flush=True)

    for shape, x in frames.items():
        bias = torch.full((), -1.0, device=dev)
        for od in (torch.bfloat16, torch.float32):
            cold, span = cs._rotating(lambda: torch.randint_like(x, 0, 256), x.numel())
            y = torch.empty(x.shape, dtype=od, device=dev)
            print(f"normalize_u8 {shape} uint8 -> {str(od)[6:]}, inputs cycled over {span:.1f} "
                  "MB: " + _turns(
                      [(label, lambda: old.normalize_u8(next(cold), out_dtype=od)),
                       ("current", lambda: pp.normalize_u8(next(cold), out_dtype=od)),
                       ("library", lambda: torch.add(bias, next(cold), alpha=scale, out=y))],
                      rounds), flush=True)
        cold, span = cs._rotating(lambda: torch.rand_like(x, dtype=torch.float32) * 2.4 - 1.2,
                                  x.numel() * 4)
        print(f"quantize_affine {shape} float32 -> uint8, inputs cycled over {span:.1f} MB: "
              + _turns([(label, lambda: old.quantize_affine(next(cold), scale, zp)),
                        ("current", lambda: pp.quantize_affine(next(cold), scale, zp)),
                        ("library", lambda: torch.quantize_per_tensor(
                            next(cold), scale, zp, torch.quint8))], rounds), flush=True)
    # what one round trip costs at 224: the same bytes moved without the
    # arithmetic, one vector a thread, into one buffer; the kernel into that
    # buffer too; an empty kernel of one block per SM
    x = frames[(224, 224, 3)]
    cold, _ = cs._rotating(lambda: torch.randint_like(x, 0, 256), x.numel())
    wide = torch.empty(x.shape, dtype=torch.float32, device=dev)
    probes.nns_widen(x.data_ptr(), wide.data_ptr(), x.numel() // 4, _stream())
    if not torch.equal(wide.view(torch.int32), x.int()):
        raise AssertionError("the widening probe differs from its input")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"normalize_u8 (224, 224, 3) uint8 -> float32 against its loads and stores alone "
          f"and an empty {sms}x256 grid: " + _turns(
              [("loads and stores", lambda: probes.nns_widen(
                  next(cold).data_ptr(), wide.data_ptr(), x.numel() // 4, _stream())),
               ("current", lambda: pp.normalize_u8(next(cold), out_dtype=torch.float32)),
               ("current into one buffer", lambda: pp._launch_normalize(
                   next(cold), wide, scale, -1.0)),
               ("empty", lambda: probes.nns_empty(sms, 256, _stream()))], rounds), flush=True)
    hd = frames[(1080, 1920, 3)]
    for name, fn in (
            ("normalize_u8 1080p uint8 -> float32, one input from L2",
             lambda m: lambda: m.normalize_u8(hd, out_dtype=torch.float32)),
            ("normalize_u8 1080p uint8 -> float32, a view 1 byte off (element path)",
             lambda m: lambda: m.normalize_u8(unaligned, out_dtype=torch.float32))):
        print(f"{name}: " + _turns([(label, fn(old)), ("current", fn(pp))], rounds), flush=True)

    for who, log in (("current", os.path.join(build.BUILD_DIR, "preprocess.log")),
                     (label, os.path.join(tree, "nnstreamer_tpu_torch", "_build",
                                          "preprocess.log"))):
        if not os.path.isfile(log):
            print(f"{who}: no build log (built before this run)", flush=True)
            continue
        with open(log) as f:
            for name, regs, spill in _ptxas(f.read()):
                print(f"{who} ptxas: {name}: {regs} registers, {spill}", flush=True)
    for src, out in ((torch.uint8, torch.bfloat16), (torch.uint8, torch.float32),
                     (torch.float32, torch.uint8), (torch.bfloat16, torch.uint8)):
        print(f"current tiling {str(src)[6:]} -> {str(out)[6:]}: "
              f"{json.dumps(pp.tiling(src, out, dev))}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier", required=True, help="root of an earlier revision's tree")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--only", choices=("epilogue", "prologue"))
    ap.add_argument("--label", default="earlier", help="the other tree's name in the output")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("epilogue_ab: no CUDA device", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.earlier)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    probes = _probes()
    cs._settle_timing(dev)
    if args.only != "prologue":
        epilogue(_earlier(tree, "epilogue"), probes, dev, rng, args.rounds, args.label)
    if args.only != "epilogue":
        prologue(_earlier(tree, "preprocess"), probes, dev, rng, args.rounds, args.label, tree)
    return 0


if __name__ == "__main__":
    sys.exit(main())
