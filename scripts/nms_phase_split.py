"""Where nms_sweep's time goes, phase by phase, on the card.

    python3 scripts/nms_phase_split.py [--source PATH] [--k 256 1917 ...]
                                       [--reps 50] [--json]

Builds a copy of the kernel source (default: the package's
``csrc/nms_sweep.cu``) with ``%globaltimer`` stamps (nanoseconds, one clock
for every SM and kernel) spliced in at each kernel's start and end and
after each ``__syncthreads()``, ``cluster.sync()`` and
``grid_dependency_wait()``. Thread 0 of every block stamps (at a wait, each
thread that waited), and each site keeps its earliest and latest stamp. It runs the kernel on
seeded random boxes at each K, and prints the phases averaged over the
repetitions, named by route:

  * one kernel (K <= 1024, or an older revision at any K): the time from
    each site to the next, as staging, build, sweep and output;
  * two kernels (K > 1024): build (the first build block's start to the
    last one's end), hand-off (to the sweep block's return from waiting for
    the build grid), sweep, output, with the sweep block's launch and
    prologue measured from the build's start; the sweep's time a 32-row
    chunk beside them.

``--json`` adds one ``nms_phase_split: {...}`` line a K. The committed
source carries no switch for this: the stamps go into a copy under
``nnstreamer_tpu_torch/_build/``. Any revision with either C interface of
the package (with or without the scratch argument) can be measured, so a
parent commit's source can be held beside the current one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nnstreamer_tpu_torch.ops.kernels import build  # noqa: E402
from nnstreamer_tpu_torch.ops.kernels import epilogue as ep  # noqa: E402

SITES = 64
_PRELUDE = f"""
#include <cuda_runtime.h>
__device__ unsigned long long nns_lo[{SITES}], nns_hi[{SITES}];
__device__ __forceinline__ void nns_stamp_here(int site) {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  atomicMin(&nns_lo[site], t);
  atomicMax(&nns_hi[site], t);
}}
__device__ __forceinline__ void nns_stamp(int site) {{
  if (threadIdx.x == 0) nns_stamp_here(site);
}}
extern "C" int nns_read_stamps(unsigned long long* lo, unsigned long long* hi) {{
  cudaError_t e = cudaMemcpyFromSymbol(lo, nns_lo, sizeof(nns_lo));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(hi, nns_hi, sizeof(nns_hi));
  return static_cast<int>(e);
}}
extern "C" int nns_reset_stamps() {{
  unsigned long long lo[{SITES}], hi[{SITES}];
  for (int i = 0; i < {SITES}; ++i) {{ lo[i] = ~0ull; hi[i] = 0ull; }}
  cudaError_t e = cudaMemcpyToSymbol(nns_lo, lo, sizeof(lo));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(nns_hi, hi, sizeof(hi));
  return static_cast<int>(e);
}}
"""
_KERNEL = re.compile(r"__global__[^{;]*?(\w+)\s*\([^)]*\)\s*\{", re.S)
_MARKS = ("__syncthreads();", "cluster.sync();", "grid_dependency_wait();")


def instrument(src: str) -> Tuple[str, List[Tuple[str, str]]]:
    """The source with stamps, and each site's (kernel, label) by its id."""
    sites: List[Tuple[str, str]] = []

    def stamp(kernel: str, label: str, here: bool = False) -> str:
        sites.append((kernel, label))
        if len(sites) > SITES:
            raise ValueError(f"more than {SITES} stamp sites")
        return f" nns_stamp{'_here' if here else ''}({len(sites) - 1});"

    out, pos = [], 0
    for m in _KERNEL.finditer(src):
        if m.start() < pos:
            continue
        name, depth, end = m.group(1), 1, m.end()
        while depth:  # the body's closing brace
            depth += {"{": 1, "}": -1}.get(src[end], 0)
            end += 1
        body = src[m.end():end - 1]
        seen: Dict[str, int] = {}

        def mark(b: re.Match) -> str:  # the thread that waits stamps its wait
            seen[b.group(0)] = seen.get(b.group(0), 0) + 1
            return b.group(0) + stamp(name, f"after {b.group(0)[:-1]} #{seen[b.group(0)]}",
                                      here=b.group(0) == _MARKS[2])

        out += [src[pos:m.end()], stamp(name, "start"),
                re.sub("|".join(re.escape(x) for x in _MARKS), mark, body),
                stamp(name, "end"), "}"]
        pos = end
    out.append(src[pos:])
    return _PRELUDE + "".join(out), sites


def phases(sites, lo, hi) -> List[Tuple[str, float]]:
    """Named phases in ns from one run's stamps (sites not reached drop
    out)."""
    hit = [(i, s) for i, s in enumerate(sites) if lo[i] != 2 ** 64 - 1]
    kernels = sorted({s[0] for _, s in hit}, key=lambda n: min(
        lo[i] for i, s in hit if s[0] == n))
    at = {s: i for i, s in hit}
    if len(kernels) == 1:
        order = sorted((lo[i], s[1]) for i, s in hit)
        names = {4: ["staging", "build", "sweep", "output"],
                 3: ["build", "sweep", "output"]}.get(
            len(order) - 1, [f"{a[1]} to {b[1]}" for a, b in zip(order, order[1:])])
        return [(n, float(b[0] - a[0])) for n, a, b in zip(names, order, order[1:])]
    bld, swp = kernels[0], kernels[1]
    start, end = lo[at[(bld, "start")]], hi[at[(bld, "end")]]
    s_sync = sorted(lo[i] for i, s in hit if s[0] == swp and "__syncthreads" in s[1])
    wait = min(lo[i] for i, s in hit if s[0] == swp and "grid_dependency_wait" in s[1])
    begun, done = lo[at[(swp, "start")]], lo[at[(swp, "end")]]
    return [("build", float(end - start)), ("hand-off", float(wait - end)),
            ("sweep", float(s_sync[-1] - wait)), ("output", float(done - s_sync[-1])),
            ("total", float(done - start)),
            ("build blocks started over", float(hi[at[(bld, "start")]] - start)),
            ("build blocks ended over", float(end - lo[at[(bld, "end")]])),
            ("sweep block launched", float(begun - start)),
            ("sweep block prologue", float(s_sync[0] - begun))]


def _boxes(k: int) -> List[torch.Tensor]:
    rng = np.random.default_rng(0)
    c = rng.uniform(0.0, 1.0, (k, 2)).astype(np.float32)
    wh = rng.uniform(0.02, 0.4, (k, 2)).astype(np.float32)
    cols = [c[:, 0], c[:, 1], c[:, 0] + wh[:, 0], c[:, 1] + wh[:, 1],
            np.sort(rng.uniform(0, 1, k).astype(np.float32))[::-1].copy()]
    return [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in cols]


def split(lib, sites, new_abi: bool, k: int, reps: int) -> Dict[str, float]:
    """The phases in us at K, averaged over ``reps`` runs after one."""
    p = ctypes.c_void_p
    cols = _boxes(k)
    out = torch.empty(k, device="cuda")
    # the current layout's scratch, or an older revision's (K | 1 rows)
    scratch = torch.empty(max(1, ep.nms_scratch_words(k), -(-k // 32) * (k | 1)),
                          dtype=torch.int32, device="cuda")
    stream = p(torch.cuda.current_stream().cuda_stream)
    lo, hi = (ctypes.c_ulonglong * SITES)(), (ctypes.c_ulonglong * SITES)()
    sums: Dict[str, float] = {}
    for rep in range(reps + 1):
        if lib.nns_reset_stamps() != 0:
            raise RuntimeError("stamp reset failed")
        extra = [p(scratch.data_ptr())] if new_abi else []
        rc = lib.nns_nms_sweep(*(p(x.data_ptr()) for x in cols), p(out.data_ptr()), *extra,
                               k, 0.5, 0.5, stream)
        torch.cuda.synchronize()
        if rc != 0 or lib.nns_read_stamps(ctypes.byref(lo), ctypes.byref(hi)) != 0:
            raise RuntimeError(f"launch or stamp read failed ({rc})")
        if rep == 0:
            continue  # warm-up
        for name, ns in phases(sites, lo, hi):
            sums[name] = sums.get(name, 0.0) + ns / 1e3
    return {name: v / reps for name, v in sums.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", default=os.path.join(build.CSRC, "nms_sweep.cu"))
    ap.add_argument("--k", type=int, nargs="+", default=[256])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("nms_phase_split: no CUDA device", file=sys.stderr)
        return 1
    with open(args.source) as f:
        src = f.read()
    new_abi = "scratch" in src
    text, sites = instrument(src)
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    tag = f"nms_split_{os.getpid()}"
    cu = os.path.join(build.BUILD_DIR, f"{tag}.cu")
    so = os.path.join(build.BUILD_DIR, f"lib{tag}.so")
    with open(cu, "w") as f:
        f.write(text)
    subprocess.run([build.nvcc_path(), *build.COMMON_FLAGS,
                    *build.KERNEL_FLAGS["nms_sweep"], "-o", so, cu],
                   check=True, capture_output=True, text=True)
    os.remove(cu)
    lib = ctypes.CDLL(so)
    p = ctypes.c_void_p
    lib.nns_nms_sweep.argtypes = [p] * (7 if new_abi else 6) + [
        ctypes.c_int, ctypes.c_float, ctypes.c_float, p]
    lib.nns_nms_sweep.restype = ctypes.c_int
    lib.nns_read_stamps.argtypes = [p, p]
    for k in args.k:
        got = split(lib, sites, new_abi, k, args.reps)
        chunks = -(-k // 32)
        per_chunk = got["sweep"] / chunks
        route = ("build kernel, then sweep kernel" if "hand-off" in got
                 else "one kernel")
        print(f"nms_sweep phases ({os.path.relpath(args.source)}, K {k}, {route}, "
              f"{args.reps} runs, %globaltimer):", flush=True)
        main_phases = ("staging", "build", "hand-off", "sweep", "output")
        shown = got.get("total", sum(got.values()))
        for name, us in got.items():
            share = f" ({us / shown:.3f})" if name in main_phases else ""
            print(f"  {name}: {us:.3f} us{share}", flush=True)
        print(f"  sweep a chunk: {per_chunk:.4f} us ({chunks} chunks of 32 rows)",
              flush=True)
        if args.json:
            print("nms_phase_split: " + json.dumps(
                {"k": k, "route": route, "phases_us": got, "chunks": chunks,
                 "sweep_us_a_chunk": per_chunk}), flush=True)
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True).stdout.split()
    print(f"  SM clock after the runs: {clock[0] if clock else '?'} MHz", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
