"""Serve the reference's own model files on the port — every family,
verbatim strings.

The point of this example: a user of the reference (NNStreamer) can point
their existing pipeline descriptions at this framework and their model
files load unmodified. Each block below is the reference's own SSAT
pipeline string (paths aside) for one backend family:

* ``.tflite``  — from-scratch flatbuffer importer lowered to torch, run on
  the card (tests/nnstreamer_filter_tensorflow2_lite/runTest.sh:74)
* ``.pb``      — frozen TensorFlow GraphDefs via framework=tensorflow,
  which needs the ``tensorflow`` package and runs it on the host
  (tests/nnstreamer_filter_tensorflow/runTest.sh:78)
* ``.pt``      — TorchScript via framework=pytorch, including the
  torch-1.0-era legacy zip format modern torch rejects
  (tests/nnstreamer_filter_pytorch/runTest.sh:72)

Run:  python examples/serve_reference_models_torch.py [--device cuda|cpu]

Without a card the default device raises; there is no fallback.
"""

import _bootstrap  # noqa: F401  (repo-root import shim for source checkouts)

import argparse
import os
import sys
import tempfile
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

MODELS = "/root/reference/tests/test_models/models"
DATA = "/root/reference/tests/test_models/data"
LABELS = "/root/reference/tests/test_models/labels/labels.txt"
BLOCKS = ("tflite", "tensorflow", "pytorch")


def serve_reference(blocks: Sequence[str] = BLOCKS, device: Any = "cuda",
                    models: Optional[str] = None, data: Optional[str] = None,
                    labels: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """Run ``blocks`` over the model files in ``models`` (default: the
    module's ``MODELS``, likewise ``data`` and ``labels``); returns each
    block's answer (the tflite label, the two digits), or None when the
    model directory is absent."""
    from nnstreamer_tpu_torch.core.hw import resolve_device
    from nnstreamer_tpu_torch.graph import Pipeline
    from nnstreamer_tpu_torch.graph.parse import parse_pipeline

    models = MODELS if models is None else models
    data = DATA if data is None else data
    labels = LABELS if labels is None else labels
    if not os.path.isdir(models):
        print("reference test models not mounted; nothing to demo")
        return None
    dev = resolve_device(device)

    def run(description: str) -> None:
        parse_pipeline(description, Pipeline(device=dev)).run(timeout=300)

    workdir = tempfile.mkdtemp(prefix="nns_demo_")
    found: Dict[str, Any] = {}

    if "tflite" in blocks:
        # 1. tflite: mobilenet quant classifies orange.png
        out = os.path.join(workdir, "tflite.out")
        run(f"filesrc location={data}/orange.png ! pngdec ! videoscale ! "
            "imagefreeze ! videoconvert ! "
            "video/x-raw,format=RGB,framerate=0/1 ! tensor_converter ! "
            f"tensor_filter framework=tensorflow2-lite "
            f"model={models}/mobilenet_v2_1.0_224_quant.tflite ! "
            f"filesink location={out}")
        scores = np.frombuffer(open(out, "rb").read(), np.uint8)
        names = open(labels).read().splitlines()
        found["tflite"] = names[int(scores.argmax())]
        print(f"tflite   mobilenet_v2_quant: {found['tflite']!r}")

    if "tensorflow" in blocks:
        # 2. tensorflow: frozen GraphDef, named feeds/fetches
        out = os.path.join(workdir, "tf.out")
        run(f"filesrc location={data}/9.raw ! application/octet-stream ! "
            "tensor_converter input-dim=784:1 input-type=uint8 ! "
            "tensor_transform mode=arithmetic "
            "option=typecast:float32,add:-127.5,div:127.5 ! "
            f"tensor_filter framework=tensorflow model={models}/mnist.pb "
            "input=784:1 inputtype=float32 inputname=input "
            "output=10:1 outputtype=float32 outputname=softmax ! "
            f"filesink location={out}")
        found["tensorflow"] = int(
            np.frombuffer(open(out, "rb").read(), np.float32).argmax())
        print(f"tensorflow mnist.pb: digit {found['tensorflow']}")

    if "pytorch" in blocks:
        # 3. pytorch: the legacy torch-1.0 TorchScript zip
        out = os.path.join(workdir, "torch.out")
        run(f"filesrc location={data}/9.png ! pngdec ! videoscale ! "
            "imagefreeze ! videoconvert ! "
            "video/x-raw,format=GRAY8,framerate=0/1 ! tensor_converter ! "
            f"tensor_filter framework=pytorch "
            f"model={models}/pytorch_lenet5.pt "
            "input=1:28:28:1 inputtype=uint8 output=10:1:1:1 "
            f"outputtype=uint8 ! filesink location={out}")
        found["pytorch"] = int(
            np.frombuffer(open(out, "rb").read(), np.uint8).argmax())
        print(f"pytorch  pytorch_lenet5.pt (legacy format): "
              f"digit {found['pytorch']}")
    return found


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    serve_reference(device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
