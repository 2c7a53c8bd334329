"""The TFLite SSD-MobileNet-v2 path of one or more trees, in turns, on the card.

    python3 scripts/tflite_ssd_ab.py [--frames 128] NAME=TREE [NAME=TREE ...]

For each ``NAME=TREE`` in the order given (a checkout of this repository,
such as a parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists), runs that tree's ``chip_smoke.py`` SSD-MobileNet-v2
300 ``.tflite`` phase in a fresh process from the tree, and prints

  * the device ms of one frame: the imported model with its
    ``TFLite_Detection_PostProcess`` captured in a CUDA graph, 5 frames a
    graph replayed 10 times, three rounds;
  * the steady frames/s of the ``tensor_filter framework=tensorflow2-lite !
    tensor_decoder`` pipeline with graphs and eagerly over ``--frames``
    frames.

The kernels' comparison with their plain versions inside the op is left to
``chip_smoke.py``. Give the trees in turns (a, b, b, a) to compare two
versions on one card: the frames/s are set by the host and move between
runs; the device ms do not.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile


def one(name: str, tree: str, frames: int) -> None:
    """The measurement in this process, from ``tree``."""
    root = os.path.abspath(tree)
    os.chdir(root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from nnstreamer_tpu_torch.ops.kernels import epilogue as ep
    from nnstreamer_tpu_torch.ops.kernels import flash_attention as fa
    from nnstreamer_tpu_torch.ops.kernels import preprocess as pp

    torch.backends.cudnn.allow_tf32 = False  # as chip_smoke.main sets them
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cs._settle_timing(dev)
    cs._tfl_inside_the_op = lambda *a, **k: {}
    cs.TFL_FRAMES = frames
    wrappers = {"class_reduce": ep.class_reduce, "nms_sweep": ep.nms_sweep,
                "segment_colorize": ep.segment_colorize,
                "flash_attention": fa.flash_attention,
                "dequant_gelu_requant": ep.dequant_gelu_requant,
                "normalize_u8": pp.normalize_u8, "quantize_affine": pp.quantize_affine}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ssd_mobilenet_v2_coco.tflite")
        cs.write_ssd_mobilenet_v2_tflite(path, **cs.TFL_SSD)
        card, _ = cs._tfl_load(path, "cuda")
        frame = cs._tfl_frames(cs.TFL_SSD["size"], 41)[0]
        x = torch.from_numpy(((frame.astype(np.float32) - 127.5) / 127.5)[None]).to(dev)
        with torch.inference_mode():
            ms = [cs._device_ms(lambda: card.fn()(x), 5, 10) for _ in range(3)]
        cs._tfl_ssd(tmp, cs._Counters(wrappers))
    got = cs.GRAPH_PATHS["tflite ssd"]
    print(f"tflite ssd {name}: device ms a frame (model and post-process in a CUDA "
          f"graph) {', '.join(f'{m:.6f}' for m in ms)}; {frames} frames, steady fps "
          f"graphs {got['graphs']:.2f}, eager {got['eager']:.2f}; {cs._card()}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", metavar="NAME=TREE")
    ap.add_argument("--frames", type=int, default=128)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("tflite_ssd_ab: no CUDA device", file=sys.stderr)
        return 1
    if args.one:
        name, tree = args.trees[0].split("=", 1)
        one(name, tree, args.frames)
        return 0
    for spec in args.trees:
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                              "--frames", str(args.frames), spec], timeout=900)
        if run.returncode != 0:
            return run.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
