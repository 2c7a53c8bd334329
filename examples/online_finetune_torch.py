"""Online fine-tuning demo on the port: a stream of (x, y) batches feeds a
tensor_trainer that takes one optimizer step a frame on the card; the
trained params are ready to hot-swap into a serving filter.

    python examples/online_finetune_torch.py [--device cuda|cpu]

The model is the ``(fn, params)`` form: a linear layer whose initial
weights come from an explicit ``torch.Generator`` seeded 0. Without a
card the default device raises; there is no fallback.
"""

import _bootstrap  # noqa: F401  (repo-root import shim for source checkouts)

import argparse
from typing import Any, List, Optional

import numpy as np
import torch


def initial_weights(seed: int = 0) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn((16, 4), generator=g) * 0.1


def _shapes(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_shapes(v) for v in tree)
    return tuple(tree.shape)


def finetune(w0: Any = None, device: Any = "cuda") -> List[float]:
    """Train from ``w0`` (default: ``initial_weights()``) over 50 seeded
    batches; returns the loss of every step."""
    from nnstreamer_tpu_torch.core import Caps, TensorsConfig, TensorsInfo
    from nnstreamer_tpu_torch.core.hw import resolve_device
    from nnstreamer_tpu_torch.graph import Pipeline

    dev = resolve_device(device)
    if w0 is None:
        w0 = initial_weights()

    rng = np.random.default_rng(1)
    true_w = rng.normal(size=(16, 4)).astype(np.float32)
    frames = []
    for _ in range(50):
        x = rng.normal(size=(8, 16)).astype(np.float32)
        y = np.argmax(x @ true_w, axis=-1).astype(np.int32)
        frames.append((x, y))

    p = Pipeline(device=dev)
    src = p.add_new("appsrc", caps=Caps.tensors(TensorsConfig(
        TensorsInfo.from_strings("16:8,8", "float32,int32"), 30)),
        data=frames)
    tr = p.add_new("tensor_trainer", model=(lambda w, x: x @ w, w0),
                   learning_rate=0.05, report_every=10)
    sink = p.add_new("fakesink")
    Pipeline.link(src, tr, sink)
    p.run(timeout=300)
    print(f"loss: {tr.losses[0]:.3f} → {tr.losses[-1]:.3f} "
          f"after {len(tr.losses)} online steps")
    trained = tr.trained_bundle()
    print("trained params ready for filter.update_model():",
          _shapes(trained.params))
    return [float(v) for v in tr.losses]


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    finetune(device=args.device)


if __name__ == "__main__":
    main()
