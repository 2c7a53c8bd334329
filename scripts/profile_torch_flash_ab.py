"""flash_attention's default launch against an earlier revision's kernel,
in turns, on the card.

    git archive REV nnstreamer_tpu_torch/ops/kernels/csrc | tar -x -C DIR
    python3 scripts/profile_torch_flash_ab.py --earlier DIR [--rounds 3]
        [--with-config] [--shape B,H,L,D ...] [--full]

Builds DIR's ``csrc/flash_attention.cu`` with this tree's nvcc flags and
calls its two C entry points (``nns_flash_attention_wgmma`` and
``nns_flash_attention_tf32x3``) with the signatures they had before the
launch-configuration argument, or, with ``--with-config``, with it (0, the
default launch: a tree whose kernel takes the tuner's launch
configurations), beside this tree's wrapper
with no configuration named (the default launch), at the flash prefill's
(8, 16, 1024, 64) causal (or each ``--shape``; ``--full`` drops the causal
mask), bf16 (``wgmma``, at D 64 and 128 only) and float32 (``tf32x3``):
whether the two outputs' bits are equal, their largest difference and each
one's against a float64 attention, and device ms a call (a CUDA graph of 5
calls replayed 10 times, ``chip_smoke.py``'s ``_device_ms``) in the order
earlier, current, current, earlier, ``--rounds`` times. Prints the card's
name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from nnstreamer_tpu_torch.ops.kernels import build  # noqa: E402
from nnstreamer_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402

_P = ctypes.c_void_p
SHAPE = (8, 16, 1024, 64)


def _earlier_lib(tree: str, with_config: bool) -> ctypes.CDLL:
    src = os.path.join(tree, "nnstreamer_tpu_torch", "ops", "kernels", "csrc",
                       "flash_attention.cu")
    out = os.path.join(tree, "libflash_earlier.so")
    subprocess.run([build.nvcc_path(), *build.COMMON_FLAGS, "-o", out, src],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(out)
    lib.nns_flash_attention_wgmma.argtypes = \
        [_P] * 6 + [ctypes.c_int] * 4 + [_P, ctypes.c_int, ctypes.c_float] \
        + [ctypes.c_int] * with_config + [_P]
    lib.nns_flash_attention_tf32x3.argtypes = \
        [_P] * 6 + [ctypes.c_int] * 4 + [_P, ctypes.c_int, ctypes.c_float, ctypes.c_int] \
        + [ctypes.c_int] * with_config + [_P]
    return lib


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--earlier", required=True,
                    help="root of the earlier tree (its csrc/flash_attention.cu)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--with-config", action="store_true",
                    help="the earlier entry points take the config argument")
    ap.add_argument("--shape", action="append", default=None,
                    help="B,H,L,D (repeatable; default 8,16,1024,64)")
    ap.add_argument("--full", action="store_true", help="no causal mask")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_flash_ab: no CUDA device", file=sys.stderr)
        return 1
    lib = _earlier_lib(args.earlier, args.with_config)
    print(cs._card(), flush=True)
    shapes = [tuple(int(n) for n in sh.split(",")) for sh in args.shape] \
        if args.shape else [SHAPE]
    causal = not args.full
    conf = (0,) if args.with_config else ()
    rng = np.random.default_rng(0)
    for shape, dt in [(sh, dt) for sh in shapes for dt in (torch.bfloat16, torch.float32)
                      if dt == torch.float32 or sh[3] in (64, 128)]:
        q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
                   .cuda().to(dt) for _ in range(3))
        route = fa._route(q, k, v)
        o = torch.empty_like(q)
        strides = (ctypes.c_longlong * 9)(*(s for t in (q, k, v) for s in (
            fa._tma_strides(t) if route == "wgmma" else t.stride()[:3])))

        def earlier():
            stream = _P(torch.cuda.current_stream().cuda_stream)
            head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None, None,
                    *shape, strides, int(causal), fa._scale(shape[3]))
            rc = lib.nns_flash_attention_wgmma(*head, *conf, stream) if route == "wgmma" \
                else lib.nns_flash_attention_tf32x3(*head, int(dt == torch.bfloat16), *conf,
                                                    stream)
            if rc:
                raise RuntimeError(f"earlier flash_attention launch failed: {rc}")
            return o

        def current():
            return fa.flash_attention(q, k, v, causal)

        want = earlier().clone()
        got = current()
        s64 = (q.double() @ k.double().transpose(-1, -2)) * fa._scale(shape[3])
        if causal:
            s64 = s64.masked_fill(torch.ones(shape[2], shape[2], dtype=torch.bool,
                                             device=q.device).triu(1), float("-inf"))
        exact = torch.softmax(s64, -1) @ v.double()
        errs = [(t.double() - exact).abs().max().item() for t in (want, got)]
        torch.cuda.synchronize()
        times = {"earlier": [], "current": []}
        for _ in range(args.rounds):
            for name in ("earlier", "current", "current", "earlier"):
                fn = earlier if name == "earlier" else current
                times[name].append(cs._device_ms(fn, 5, 10))
        print(f"flash {route} {str(dt)[6:]} {shape} {'causal' if causal else 'full'}, "
              f"default launch: outputs bit-equal {torch.equal(want, got)}, max abs diff "
              f"{(want.float() - got.float()).abs().max().item():.3e}, against float64 "
              f"earlier {errs[0]:.3e} current {errs[1]:.3e}; device ms earlier "
              f"{[round(t, 6) for t in times['earlier']]} current "
              f"{[round(t, 6) for t in times['current']]}; medians "
              f"{np.median(times['earlier']):.6f} / {np.median(times['current']):.6f}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
