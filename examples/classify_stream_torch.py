"""Streaming classification demo on the port: synthetic camera →
MobileNet-v2 → labels, with PyTorch on the card.

    python examples/classify_stream_torch.py [--frames 100] [--device cuda|cpu]

``--cpu`` is a synonym of ``--device cpu``. Without a card the default
device raises; there is no fallback.
"""

import _bootstrap  # noqa: F401  (repo-root import shim for source checkouts)

import argparse
import sys
import tempfile
from typing import Any, List, Optional


def classify(model: Any = None, frames: int = 100, size: int = 224,
             width: float = 1.0, device: Any = "cuda") -> List[str]:
    """Run the stream; returns every frame's label. ``model`` defaults to
    the zoo's MobileNet-v2 at ``width`` and ``size``."""
    from nnstreamer_tpu_torch.core.hw import resolve_device
    from nnstreamer_tpu_torch.graph import Pipeline
    from nnstreamer_tpu_torch.utils.trace import PipelineTracer

    dev = resolve_device(device)
    if model is None:
        model = f"zoo://mobilenet_v2?width={width}&size={size}"
    with tempfile.NamedTemporaryFile("w", suffix=".txt", delete=False) as f:
        f.write("\n".join(f"class{i}" for i in range(1001)))
        labels = f.name

    p = Pipeline(device=dev)
    src = p.add_new("videotestsrc", width=size, height=size,
                    pattern="random", num_buffers=frames)
    conv = p.add_new("tensor_converter")
    filt = p.add_new("tensor_filter", framework="torch-cuda", model=model)
    dec = p.add_new("tensor_decoder", mode="image_labeling", option1=labels)
    sink = p.add_new("tensor_sink", store=True,
                     new_data=lambda b: print(f"frame {b.offset}: "
                                              f"{b.meta['label']}"),
                     signal_rate=5)
    Pipeline.link(src, conv, filt, dec, sink)
    tracer = PipelineTracer.attach(p)
    p.run(timeout=600)
    print(f"\nfilter latency: {filt.latency} µs  throughput: "
          f"{filt.throughput / 1000:.1f} FPS")
    print(tracer.report())
    return [b.meta["label"] for b in sink.buffers]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--width", type=float, default=1.0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--cpu", action="store_true", help="same as --device cpu")
    args = ap.parse_args(argv)
    classify(frames=args.frames, size=args.size, width=args.width,
             device="cpu" if args.cpu else args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
