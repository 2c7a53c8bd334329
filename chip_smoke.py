"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, drive, time.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines are printed):
  1. build the CUDA kernels from ``nnstreamer_tpu_torch/ops/kernels/csrc``
     (one nvcc per source, started together) and print the build time;
  2. print the card's name and power limit (nvidia-smi);
  3. hold each kernel bit-exact against its plain PyTorch version on the card,
     at the detection path's shapes and at edge cases, then time kernel,
     plain version and (where one exists) the one-call PyTorch yardstick:
     device time per call from CUDA-graph replay (the ``ms`` numbers of the
     kernels line), and the eager per-call time, which the host's launch
     path sets for calls this small;
  4. drive the SSD-MobileNet-v2 300x300 detection pipeline (91 classes,
     width 1.0, seeded random weights) over 64 random frames with the
     kernels' launch counts reset just before and read just after: the
     counts must equal the frame count, the model output must stay on the
     card, detections must come out, and one frame's fused device reduce
     must agree with the host decode path (rtol 1e-4);
  5. drive the MobileNet-v2 224 classification pipeline over a few frames
     and check each label against the model's own argmax;
  6. print the ``kernels`` JSON line, then the device line last.

Exits non-zero without a card or without the package beside it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from fractions import Fraction

import numpy as np
import torch

SSD_SPEC = "zoo://ssd_mobilenet_v2?size=300&num_classes=91"
CLS_SPEC = "zoo://mobilenet_v2"
SSD_FRAMES = 64
CLS_FRAMES = 8

#: H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and float32
#: operations/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

#: IoU arithmetic per candidate pair in nms_sweep: 2 min, 2 max, 2 sub,
#: 2 clamp, 1 mul, 1 add, 1 sub, 1 div, 1 compare
NMS_OPS_PER_PAIR = 13


def _bound_ms(nbytes: float, ops: float) -> tuple:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _eager_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    """Per call, back to back from Python: for launches this small the
    host's launch path, not the device, sets this number."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, per_graph: int = 20, replays: int = 20) -> float:
    """Device time per call: ``per_graph`` calls captured into one CUDA
    graph and replayed, so no host launch gap sits between them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * per_graph)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal values, NaN where the other has NaN."""
    return a.shape == b.shape and a.dtype == b.dtype \
        and torch.equal(a.isnan(), b.isnan()) \
        and torch.equal(a[~a.isnan()], b[~b.isnan()])


def _max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def _random_boxes(rng, k: int, dev) -> list:
    c = rng.uniform(0.0, 1.0, (k, 2)).astype(np.float32)
    wh = rng.uniform(0.02, 0.4, (k, 2)).astype(np.float32)
    cols = [c[:, 0], c[:, 1], c[:, 0] + wh[:, 0], c[:, 1] + wh[:, 1],
            np.sort(rng.uniform(0, 1, k).astype(np.float32))[::-1].copy()]
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in cols]


def check_class_reduce(ep, dev, rng) -> dict:
    cases = []
    x = torch.from_numpy(rng.normal(size=(2916, 91)).astype(np.float32)).to(dev)
    cases.append(("slice (2916, 91)[:, 1:]", x[:, 1:]))
    ties = torch.from_numpy(rng.integers(0, 4, (300, 45)).astype(np.float32)).to(dev)
    ties[0] = 2.0  # all-equal row
    cases.append(("ties, L=45", ties))
    cases.append(("L=1", torch.from_numpy(rng.normal(size=(7, 1)).astype(np.float32)).to(dev)))
    odd = torch.from_numpy(rng.normal(size=(33, 97)).astype(np.float32)).to(dev)
    odd[3, 5] = float("nan")
    odd[4] = float("-inf")
    cases.append(("L=97, NaN and -inf rows", odd))
    for name, t in cases:
        got = ep.class_reduce(t)
        want = ep.class_reduce_plain(t)
        torch.cuda.synchronize()
        if not (_same(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"class_reduce differs from plain: {name}")
    main = cases[0][1]
    n, l = main.shape
    err = _max_abs_err(ep.class_reduce(main)[0], ep.class_reduce_plain(main)[0])
    calls = {"kernel": lambda: ep.class_reduce(main),
             "plain": lambda: ep.class_reduce_plain(main),
             "library": lambda: torch.max(main, dim=-1)}
    dev = {k: _device_ms(f) for k, f in calls.items()}
    eager = {k: _eager_ms(f) for k, f in calls.items()}
    ms, plain_ms, library_ms = dev["kernel"], dev["plain"], dev["library"]
    bound, by = _bound_ms(n * l * 4 + n * 8, n * l)
    print(f"class_reduce N={n} L={l} device ms/call (CUDA graph): kernel={ms:.6f} "
          f"plain={plain_ms:.6f} library(torch.max)={library_ms:.6f}; "
          f"eager ms/call: kernel={eager['kernel']:.6f} plain={eager['plain']:.6f} "
          f"library={eager['library']:.6f}; bound_ms={bound:.8f} ({by})",
          flush=True)
    return {"name": "class_reduce", "route": "cuda",
            "source": "nnstreamer_tpu_torch/ops/kernels/csrc/class_reduce.cu",
            "replaces": "nnstreamer_tpu/ops/pallas/epilogue.py:157",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": library_ms}


def check_nms_sweep(ep, dev, rng) -> dict:
    def run_both(cols, iou, thr, name):
        got = ep.nms_sweep(*cols, iou_threshold=iou, threshold=thr)
        want = ep.nms_sweep_plain(*cols, iou_threshold=iou, threshold=thr)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"nms_sweep differs from plain: {name}")

    for k in (1, 7, 64, 256, 300, 512):
        run_both(_random_boxes(rng, k, dev), 0.5, 0.5, f"K={k}")
    cols = _random_boxes(rng, 256, dev)
    run_both(cols, 0.5, 2.0, "all below threshold")
    zero = _random_boxes(rng, 64, dev)
    zero[2][::3] = zero[0][::3]  # zero-width boxes
    run_both(zero, 0.5, 0.1, "zero-area boxes")
    same = [c.clone() for c in _random_boxes(rng, 64, dev)]
    for c in same[:4]:
        c[10:20] = c[10]  # identical boxes: IoU exactly 1
    run_both(same, 0.5, 0.0, "duplicate boxes")
    run_both(cols, 0.3, 0.2, "thresholds 0.3/0.2")

    k = 256
    main = _random_boxes(rng, k, dev)
    call = lambda: ep.nms_sweep(*main, iou_threshold=0.5, threshold=0.5)  # noqa: E731
    err = _max_abs_err(call(), ep.nms_sweep_plain(
        *main, iou_threshold=0.5, threshold=0.5))
    plain = lambda: ep.nms_sweep_plain(  # noqa: E731
        *main, iou_threshold=0.5, threshold=0.5)
    ms = _device_ms(call)
    plain_ms = _device_ms(plain, per_graph=2, replays=5)
    eager_ms = _eager_ms(call)
    eager_plain_ms = _eager_ms(plain, iters=10, warmup=2)
    bound, by = _bound_ms(6 * k * 4, NMS_OPS_PER_PAIR * k * (k - 1) / 2)
    print(f"nms_sweep K={k} device ms/call (CUDA graph): kernel={ms:.6f} "
          f"plain={plain_ms:.6f} library=none; eager ms/call: kernel={eager_ms:.6f} "
          f"plain={eager_plain_ms:.6f}; bound_ms={bound:.8f} ({by}) "
          f"sequential_steps={k}", flush=True)
    return {"name": "nms_sweep", "route": "cuda",
            "source": "nnstreamer_tpu_torch/ops/kernels/csrc/nms_sweep.cu",
            "replaces": "nnstreamer_tpu/ops/pallas/epilogue.py:107",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None}


def run_detection(ep, tmp: str) -> dict:
    from nnstreamer_tpu_torch.decoders import bounding_box as bb
    from nnstreamer_tpu_torch.decoders.util import nms
    from nnstreamer_tpu_torch.elements.decoder import TensorDecoder
    from nnstreamer_tpu_torch.graph import Pipeline
    from nnstreamer_tpu_torch.models.ssd_mobilenet import write_box_priors

    priors = os.path.join(tmp, "box_priors.txt")
    n_anchors = write_box_priors(priors, size=300)
    labels = os.path.join(tmp, "coco.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"c{i}" for i in range(91)))
    opts = dict(option1="mobilenet-ssd", option2=labels, option3=priors,
                option4="300:300", option5="300:300")

    def build(frames):
        p = Pipeline("ssd")
        src = p.add_new("videotestsrc", width=300, height=300,
                        pattern="random", num_buffers=frames)
        conv = p.add_new("tensor_converter")
        filt = p.add_new("tensor_filter", framework="xla-tpu", model=SSD_SPEC)
        dec = p.add_new("tensor_decoder", mode="bounding_box", **opts)
        arrivals = []
        sink = p.add_new("tensor_sink", store=True,
                         new_data=lambda b: arrivals.append(time.perf_counter()))
        Pipeline.link(src, conv, filt, dec, sink)
        return p, filt, sink, arrivals

    t0 = time.perf_counter()
    warm, _, _, _ = build(4)
    warm.run(timeout=600)
    torch.cuda.synchronize()
    print(f"ssd warm-up (model build + 4 frames): {time.perf_counter() - t0:.3f} s",
          flush=True)

    # the decoder's input is the filter's output: record where it lives
    devices = set()
    chain = TensorDecoder.chain

    def watching_chain(self, pad, buf):
        devices.update(str(m.device().device) for m in buf.memories)
        return chain(self, pad, buf)

    p, filt, sink, arrivals = build(SSD_FRAMES)
    TensorDecoder.chain = watching_chain
    try:
        ep.class_reduce.launches = 0
        ep.nms_sweep.launches = 0
        t0 = time.perf_counter()
        p.run(timeout=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"class_reduce": ep.class_reduce.launches,
                    "nms_sweep": ep.nms_sweep.launches}
    finally:
        TensorDecoder.chain = chain
    if p._epilogue_count != 1:
        raise AssertionError(f"decoder not fused: {p._epilogue_count}")
    if sink.num_buffers != SSD_FRAMES:
        raise AssertionError(f"{sink.num_buffers} of {SSD_FRAMES} frames out")
    for name, n in launches.items():
        if n != SSD_FRAMES:
            raise AssertionError(f"{name} launched {n} times for {SSD_FRAMES} frames")
    if not devices or any(not d.startswith("cuda") for d in devices):
        raise AssertionError(f"filter output left the card: {devices}")
    counts = [len(b.meta["detections"]) for b in sink.buffers]
    if sum(counts) == 0:
        raise AssertionError("no detections")
    steady = (len(arrivals) - 1) / (arrivals[-1] - arrivals[0])
    print(f"ssd_mobilenet_v2 300x300 91 classes: {SSD_FRAMES} frames in "
          f"{wall:.3f} s, steady fps={steady:.2f}, detections/frame "
          f"min={min(counts)} max={max(counts)}, anchors={n_anchors}, "
          f"launches={launches}, output devices={sorted(devices)}", flush=True)

    # one frame: fused device reduce (kernels) vs the host decode path,
    # through the filter's own (memoized) bundle
    from nnstreamer_tpu_torch.core.buffer import Buffer
    from nnstreamer_tpu_torch.models.zoo import get_model
    bundle = get_model(SSD_SPEC, device="cuda")
    frame = np.random.default_rng(7).integers(0, 256, (1, 300, 300, 3),
                                              dtype=np.uint8)
    with torch.inference_mode():
        locs, raw = bundle.fn()(torch.from_numpy(frame).cuda())
    dec = bb.BoundingBox()
    dec.init({1: opts["option1"], 2: labels, 3: priors, 4: "300:300",
              5: "300:300"})
    with torch.inference_mode():
        rows = dec.epilogue_reduce()((locs, raw)).cpu().numpy()
    dev_objs = rows[rows[:, 4] >= dec.threshold]
    host = Buffer.of(locs.cpu().numpy(), raw.cpu().numpy())
    host_objs = nms(dec._objects_mobilenet_ssd(host), dec.iou_threshold)
    if len(dev_objs) != len(host_objs) or len(dev_objs) == 0:
        raise AssertionError(f"device reduce kept {len(dev_objs)} boxes, host "
                             f"decode {len(host_objs)}")
    np.testing.assert_array_equal(dev_objs[:, 5], host_objs[:, 5])
    np.testing.assert_allclose(dev_objs[:, :5], host_objs[:, :5], rtol=1e-4,
                               atol=1e-5)
    print(f"ssd fused device reduce == host decode on one frame: "
          f"{len(dev_objs)} boxes", flush=True)
    return launches


def run_classification(tmp: str) -> None:
    from nnstreamer_tpu_torch.core.types import Caps
    from nnstreamer_tpu_torch.graph import Pipeline
    from nnstreamer_tpu_torch.models.zoo import get_model

    labels = os.path.join(tmp, "imagenet.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"l{i}" for i in range(1001)))
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 256, (224, 224, 3), dtype=np.uint8)
              for _ in range(CLS_FRAMES)]
    caps = Caps("video/x-raw", {"format": "RGB", "width": 224, "height": 224,
                                "framerate": Fraction(30)})
    p = Pipeline("cls")
    src = p.add_new("appsrc", caps=caps, data=frames)
    conv = p.add_new("tensor_converter")
    filt = p.add_new("tensor_filter", framework="xla-tpu", model=CLS_SPEC)
    dec = p.add_new("tensor_decoder", mode="image_labeling", option1=labels)
    sink = p.add_new("tensor_sink", store=True)
    Pipeline.link(src, conv, filt, dec, sink)
    t0 = time.perf_counter()
    p.run(timeout=600)
    wall = time.perf_counter() - t0
    if sink.num_buffers != CLS_FRAMES:
        raise AssertionError(f"{sink.num_buffers} of {CLS_FRAMES} labels out")
    bundle = get_model(CLS_SPEC, device="cuda")
    for frame, buf in zip(frames, sink.buffers):
        with torch.inference_mode():
            logits = bundle.fn()(torch.from_numpy(frame[None]).cuda())
        want = int(logits.argmax(dim=-1)[0])
        if buf.meta["label_index"] != want:
            raise AssertionError(f"label {buf.meta['label_index']} != argmax {want}")
    print(f"mobilenet_v2 224 image_labeling: {CLS_FRAMES} frames in {wall:.3f} s "
          f"(incl. model build), labels {[b.meta['label'] for b in sink.buffers]}",
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import nnstreamer_tpu_torch  # noqa: F401 — fails outside the repo
    from nnstreamer_tpu_torch.ops.kernels import build
    from nnstreamer_tpu_torch.ops.kernels import epilogue as ep

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.3f} s "
          f"({', '.join(sorted(logs)) or 'cached'})", flush=True)
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    kernels = [check_class_reduce(ep, dev, rng), check_nms_sweep(ep, dev, rng)]

    with tempfile.TemporaryDirectory() as tmp:
        launches = run_detection(ep, tmp)
        run_classification(tmp)
    for k in kernels:
        k["launches"] = launches[k["name"]]

    print(json.dumps({"kernels": [
        {key: k[key] for key in ("name", "route", "source", "replaces",
                                 "launches", "max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms")}
        for k in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
