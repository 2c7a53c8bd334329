"""Where one detection or segmentation frame spends its time on the GPU.

    python3 scripts/profile_torch_ssd.py [--model ssd|deeplab] [--frames 32]

Runs the torch port's invoke the way the pipeline does — the ``torch-cuda``
filter with the decoder's device reduce fused in — then the decoder's host
side, over seeded random frames, first timed without the profiler, then
under ``torch.profiler``:

  * ``ssd`` (default): SSD-MobileNet-v2 300x300, 91 classes. Invoke = H2D
    copy of the uint8 frame, model, box decode, ``class_reduce`` and
    ``nms_sweep`` kernels; host side = D2H of the (256, 6) rows, box and
    label drawing.
  * ``deeplab``: DeepLab-v3 257x257, 21 classes. Invoke = H2D copy, model
    (MobileNet-v2 at output stride 16, ASPP, float32 bilinear upsample),
    ``segment_colorize`` kernel; host side = D2H of the (257, 257, 4)
    canvas and the decoder's copy of it.

Prints per frame: host wall time of the invoke and of the host decode,
device busy time and its share of the invoke's wall time, device time by
kernel category, and the top kernels; then one JSON line with the same
numbers. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SPECS = {"ssd": ("zoo://ssd_mobilenet_v2?size=300&num_classes=91", 300),
         "deeplab": ("zoo://deeplab_v3?size=257&num_classes=21", 257)}

CATEGORIES = (
    ("class_reduce", ("class_reduce",)),
    ("nms_sweep", ("nms_sweep",)),
    ("segment_colorize", ("colorize",)),
    ("upsample", ("upsample", "interpolate")),
    ("convolution", ("conv", "xmma", "implicit", "cudnn", "gemm", "depthwise",
                     "sm90")),
    ("copy", ("memcpy", "memset")),
    ("sort", ("sort", "radix")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "pointwise")),
)


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(SPECS), default="ssd")
    ap.add_argument("--frames", type=int, default=32)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_ssd: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.core.buffer import Buffer, TensorMemory
    from nnstreamer_tpu_torch.core.hw import resolve_device
    from nnstreamer_tpu_torch.decoders.bounding_box import BoundingBox
    from nnstreamer_tpu_torch.decoders.image_segment import ImageSegment
    from nnstreamer_tpu_torch.filters.base import FilterProps
    from nnstreamer_tpu_torch.filters.torch_cuda import TorchCudaFilter
    from nnstreamer_tpu_torch.models.ssd_mobilenet import write_box_priors

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)

    spec, size = SPECS[args.model]
    print(f"model {spec}", flush=True)
    if args.model == "ssd":
        with tempfile.TemporaryDirectory() as tmp:
            priors = os.path.join(tmp, "priors.txt")
            write_box_priors(priors, size=300)
            dec = BoundingBox()
            dec.init({1: "mobilenet-ssd", 3: priors, 4: "300:300",
                      5: "300:300"})
    else:
        dec = ImageSegment()
        dec.init({1: "tflite-deeplab"})
    dec._fused_epilogue = True
    fw = TorchCudaFilter()
    fw.open(FilterProps(model=spec, device=resolve_device("cuda")))
    fw.set_fused_epilogue(lambda outs, _r=dec.epilogue_reduce(): (_r(outs),))

    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (1, size, size, 3), dtype=np.uint8)
              for _ in range(args.frames)]

    def invoke(frame):
        return fw.invoke([TensorMemory(frame)])[0]

    for frame in frames[:4]:  # warm-up: cuDNN plans, kernel build
        invoke(frame).host()
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    rows = [invoke(f) for f in frames]
    for r in rows:
        r.host()
    invoke_ms = (time.perf_counter() - t0) * 1e3 / len(frames)
    t0 = time.perf_counter()
    for r in rows:
        dec.decode(Buffer([r]), None)
    decode_ms = (time.perf_counter() - t0) * 1e3 / len(frames)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in frames:
            invoke(f).host()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / len(frames)

    by_kernel = collections.Counter()
    launches = collections.Counter()
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        by_kernel[evt.key] += us
        launches[evt.key] += evt.count
    n = len(frames)
    device_ms = sum(by_kernel.values()) / 1e3 / n
    by_cat = collections.Counter()
    for name, us in by_kernel.items():
        by_cat[category(name)] += us / 1e3 / n
    print(f"per frame: invoke wall {invoke_ms:.4f} ms (profiled {profiled_ms:.4f}), "
          f"host decode {decode_ms:.4f} ms, device busy "
          + (f"{device_ms:.4f} ms = {device_ms / profiled_ms:.3f} of the "
             "profiled invoke" if device_ms > 0 else "not measured"),
          flush=True)
    print(f"device launches per frame: {sum(launches.values()) / n:.1f}", flush=True)
    for cat, ms in by_cat.most_common():
        print(f"  {cat:12s} {ms:.4f} ms/frame", flush=True)
    for name, us in by_kernel.most_common(10):
        print(f"  {us / 1e3 / n:.4f} ms/frame x{launches[name] / n:.0f}  {name[:110]}",
              flush=True)
    print(json.dumps({
        "card": card, "model": args.model, "frames": n, "invoke_wall_ms": invoke_ms,
        "profiled_invoke_wall_ms": profiled_ms, "host_decode_ms": decode_ms,
        "device_busy_ms": device_ms if device_ms > 0 else None,
        "device_launches_per_frame": sum(launches.values()) / n,
        "device_ms_by_category": dict(by_cat)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
