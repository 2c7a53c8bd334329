"""Train→export→serve deployment flow on the port (the tflite-file
analog, with a ``torch.export`` program).

Process A (training side) exports a serialized program; process B
(serving side) loads it by path in a pipeline string — no model Python
source, no zoo access, no checkpoint surgery at serving time. The archive
keeps the JAX example's ``.jaxexport`` name: the port's ``export_model``
writes a ``torch.export`` archive there, and its filter routes the
extension to ``load_exported`` (a JAX-written ``.jaxexport`` holds a
StableHLO program the port cannot run).

Run: python examples/deploy_serve_torch.py [--device cuda|cpu]

Without a card the default device raises; there is no fallback.
"""

import _bootstrap  # noqa: F401  (repo-root import shim for source checkouts)

import argparse
import os
import tempfile
from typing import Any, List, Optional

SPEC = "zoo://mobilenet_v2?width=0.25&size=96&num_classes=10&dtype=float32"


def deploy(bundle: Any = None, device: Any = "cuda") -> List[str]:
    """Export ``bundle`` (default: the zoo's ``SPEC``) and serve it by
    path; returns every served frame's label."""
    from nnstreamer_tpu_torch.core.hw import resolve_device
    from nnstreamer_tpu_torch.graph import Pipeline
    from nnstreamer_tpu_torch.graph.parse import parse_pipeline
    from nnstreamer_tpu_torch.models import export_model, get_model

    dev = resolve_device(device)
    td = tempfile.mkdtemp()
    path = os.path.join(td, "classifier.jaxexport")

    # --- "training" process: build + export -------------------------------- #
    if bundle is None:
        bundle = get_model(SPEC, device=dev)
    export_model(path, bundle)  # cpu+cuda platforms by default
    print(f"exported {os.path.getsize(path)/1e3:.0f} kB -> {path}")

    # --- "serving" process: pipeline string by file path ------------------- #
    labels = os.path.join(td, "labels.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"class{i}" for i in range(10)))
    p = parse_pipeline(
        f"videotestsrc width=96 height=96 num_buffers=8 pattern=random ! "
        f"tensor_converter ! "
        f"tensor_filter framework=torch-cuda model={path} ! "
        f"tensor_decoder mode=image_labeling option1={labels} ! "
        f"tensor_sink name=out store=true", Pipeline(device=dev))
    p.run(timeout=300)
    out = p.get_by_name("out")
    print(f"served {out.num_buffers} frames; "
          f"first label: {out.buffers[0].meta['label']}")
    return [b.meta["label"] for b in out.buffers]


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    deploy(device=args.device)


if __name__ == "__main__":
    main()
