"""chip_smoke.py's ``run_obs_layers`` phase alone, on the card.

    python3 scripts/profile_torch_obs_layers.py

Builds the kernels, then runs the obs layers' phase in a process of its
own (no earlier phase before it): SSD-300 through the CLI on the
DeviceEngine with slo, diag, quality and tune on and off in turns, the
tuner's bucket rungs, the paged w8a8 lane with deadlines and sessions, the
confidence admission beside the plain one, the obs split with each
capture's ``gc.collect()`` timed, the flash sweep and the prefill lanes
under the tuner. Prints what ``chip_smoke.py`` prints for that phase and
the phase's wall, beside the card's name and power limit.
"""

from __future__ import annotations

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_obs_layers: no CUDA device", file=sys.stderr)
        return 1
    from nnstreamer_tpu_torch.models.causal_lm import quantize_lm_params
    from nnstreamer_tpu_torch.ops.kernels import build
    from nnstreamer_tpu_torch.ops.kernels import epilogue as ep
    from nnstreamer_tpu_torch.ops.kernels import flash_attention as fa
    from nnstreamer_tpu_torch.ops.kernels import preprocess as pp

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    print(cs._card(), flush=True)
    module = {"flash_attention": fa, "normalize_u8": pp, "quantize_affine": pp}
    counters = cs._Counters({n: getattr(module.get(n, ep), n) for n in (
        "class_reduce", "nms_sweep", "segment_colorize", "flash_attention",
        "dequant_gelu_requant", "normalize_u8", "quantize_affine")})
    qparams = quantize_lm_params(cs._lm_params())
    t0 = time.perf_counter()
    launches = cs.run_obs_layers(qparams, counters)
    print(f"run_obs_layers {time.perf_counter() - t0:.1f} s, launches {launches}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
