"""A served frame with ReLU6 as one clamp against ReLU6 as
torch.maximum then torch.minimum, on the card.

    python3 scripts/relu6_ab.py [--iters 200]

The MobileNet-v2 family's ReLU6 (models/mobilenet_v2.py ``relu6``) has two
forms with the same values: ``x.clamp(0, 6)``, one elementwise kernel, and
``torch.minimum(torch.maximum(x, 0), 6)``, whose gradient at a tie is the
JAX model's. For MobileNet-v2 224, SSD-MobileNet-v2 300 and DeepLab-v3 257
it serves a seeded uint8 frame through ``SingleShot`` (the filter's invoke,
a CUDA graph replay) with each form patched in, in turns clamp, min/max,
min/max, clamp, a new graph each turn; every turn's output must equal the
first's byte for byte. Prints the card's name and power limit, each turn's
median device ms an invoke between CUDA events over ``--iters`` invokes
after 10 untimed ones, and one JSON line. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MODELS = {"mobilenet_v2": ("zoo://mobilenet_v2", 224),
          "ssd_mobilenet_v2": ("zoo://ssd_mobilenet_v2?size=300&num_classes=91", 300),
          "deeplab_v3": ("zoo://deeplab_v3?size=257&num_classes=21", 257)}

FORMS = {"clamp": lambda x: x.clamp(0.0, 6.0),
         "min/max": lambda x: torch.minimum(torch.maximum(x, x.new_zeros(())),
                                            x.new_full((), 6.0))}


def _turn(spec: str, frame: torch.Tensor, iters: int) -> tuple:
    """(median device ms an invoke, the outputs) of a new SingleShot."""
    from nnstreamer_tpu_torch.single import SingleShot

    with SingleShot(model=spec) as single:
        for _ in range(10):
            outs = single.invoke(frame)
        times = []
        for _ in range(iters):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            single.invoke(frame)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times)), [o.clone() for o in outs]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("relu6_ab: no CUDA device", file=sys.stderr)
        return 1
    from nnstreamer_tpu_torch.models import mobilenet_v2

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    kept = mobilenet_v2.relu6
    rng = np.random.default_rng(0)
    result = {}
    try:
        for name, (spec, size) in MODELS.items():
            frame = torch.from_numpy(
                rng.integers(0, 256, (1, size, size, 3), dtype=np.uint8)).cuda()
            turns, first = [], None
            for form in ("clamp", "min/max", "min/max", "clamp"):
                mobilenet_v2.relu6 = FORMS[form]
                ms, outs = _turn(spec, frame, args.iters)
                first = first or outs
                same = all(torch.equal(a.reshape(-1).view(torch.uint8),
                                       b.reshape(-1).view(torch.uint8))
                           for a, b in zip(first, outs))
                if not same:
                    raise AssertionError(f"{name}: {form} serves other bytes")
                turns.append({"form": form, "ms": ms})
            print(f"{name}: " + ", ".join(f"{t['form']} {t['ms']:.6f}" for t in turns)
                  + " ms an invoke (medians; outputs byte-equal)", flush=True)
            result[name] = turns
    finally:
        mobilenet_v2.relu6 = kept
    print(json.dumps({"card": card, "iters": args.iters, "models": result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
