"""Adaptive micro-batched serving on the port: per-frame stream in,
per-frame labels out, with the card seeing full batches.

tensor_batch groups whatever frames are queued (up to --batch) within a
--budget-ms latency window — ONE host-to-device copy + ONE invoke per
group — and tensor_unbatch restores the per-frame stream, PTS intact. An
idle stream pays at most the budget in latency.

    python examples/adaptive_batch_serving_torch.py [--frames 400] [--batch 16]
        [--device cuda|cpu]

``--cpu`` is a synonym of ``--device cpu``. Without a card the default
device raises; there is no fallback.
"""

import _bootstrap  # noqa: F401  (repo-root import shim for source checkouts)

import argparse
import sys
import tempfile
import time
from typing import Any, List, Optional, Tuple


def serve(model: Any = None, frames: int = 400, size: int = 224,
          batch: int = 16, budget_ms: float = 50.0,
          device: Any = "cuda") -> List[Tuple[int, str]]:
    """Run the stream; returns every frame's (PTS, label) as it left the
    unbatch. ``model`` defaults to the zoo's MobileNet-v2 at ``size`` with
    a ``batch``-frame input."""
    from nnstreamer_tpu_torch.core.hw import resolve_device
    from nnstreamer_tpu_torch.graph import Pipeline

    dev = resolve_device(device)
    if model is None:
        model = f"zoo://mobilenet_v2?size={size}&batch={batch}"
    with tempfile.NamedTemporaryFile("w", suffix=".txt", delete=False) as f:
        f.write("\n".join(f"class{i}" for i in range(1001)))
        labels = f.name

    p = Pipeline(device=dev)
    src = p.add_new("videotestsrc", width=size, height=size,
                    pattern="random", num_buffers=frames)
    conv = p.add_new("tensor_converter")
    bat = p.add_new("tensor_batch", max_batch=batch, budget_ms=budget_ms)
    filt = p.add_new("tensor_filter", framework="torch-cuda", model=model)
    unb = p.add_new("tensor_unbatch")
    dec = p.add_new("tensor_decoder", mode="image_labeling", option1=labels,
                    async_depth=64)
    arrivals = []
    results = []

    def on_frame(b) -> None:
        arrivals.append(time.monotonic())
        results.append((b.pts, b.meta["label"]))

    sink = p.add_new("tensor_sink", new_data=on_frame)
    Pipeline.link(src, conv, bat, filt, unb, dec, sink)
    t0 = time.monotonic()
    p.run(timeout=600)
    wall = time.monotonic() - t0
    print(f"{len(arrivals)} per-frame results in {wall:.2f}s "
          f"({len(arrivals) / wall:.1f} FPS end-to-end, "
          f"batch={batch}, budget={budget_ms}ms)")
    return results


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=400)
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--budget-ms", type=float, default=50.0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--cpu", action="store_true", help="same as --device cpu")
    args = ap.parse_args(argv)
    serve(frames=args.frames, size=args.size, batch=args.batch,
          budget_ms=args.budget_ms,
          device="cpu" if args.cpu else args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
