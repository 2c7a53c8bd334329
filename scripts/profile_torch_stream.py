"""Where a frame of the port's stream paths spends its time on the GPU.

    python3 scripts/profile_torch_stream.py [--path crop|lstm|media|train]
                                            [--frames N]

Runs ``chip_smoke.py``'s pipelines on the same seeded inputs, with CUDA
graphs and then eagerly (``graphs.disabled()``) in one process, each mode
first timed with its stages' host time measured, then under
``torch.profiler`` for the device:

  * ``crop`` (default): path (b), tensor_crop → tensor_filter
    model=zoo://mobilenet_v2 custom="bucket=4,resize=224:224" → tensor_sink
    over 1920x1080 frames of 1-9 regions (``--frames``, default 64). Stages
    per frame: the crop (``tensor_crop._emit`` less its push downstream),
    the regions' resize (``resize_region``: host pad, copy to the card, the
    bilinear taps), stacking and padding the batch, the model's invoke (one
    graph replay a padded size) and the sink's read of the logits.
  * ``lstm``: path (a), the repo-LSTM loop with one frame in flight
    (``--frames`` timed after 16 warm-up ones, default 192). Stages per
    frame: tensor_mux (less its push), the filter's invoke, tensor_demux
    (less its pushes), the sink's read; the rest of the round trip is the
    hand-offs between threads (appsrc, the two queues, the repo slot).
  * ``media``: the video path, 1920x1080 random frames ``! videoscale !
    video/x-raw,width=300,height=300 ! videoconvert ! tensor_converter !
    tensor_filter model=SSD-300 ! tensor_decoder mode=bounding_box``
    (``--frames``, default 64). Stages per frame: the source's frame
    (``videotestsrc.create``, the host's stand-in for a decode), the copy
    into videoscale's pinned staging and the start of the copy up
    (``VideoScale._upload``), the scale's launches (the rest of
    ``VideoScale.chain`` less its push), the filter's invoke and the
    decoder; and two device times a frame, timed alone with CUDA events:
    the 1080p copy up from pinned memory and the scale.
  * ``train``: ``tensor_trainer`` on full-width MobileNet-v2 (224, 1001
    classes, bf16 compute, float32 masters, adam lr 1e-3), 16 images a step
    (``--frames`` steps after 3 warm-up ones, default 24). Device ms a step
    between CUDA events around each part of ``TensorTrainer.step``: the
    masters' cast to bf16, the forward with the loss, the backward (with
    the gradients' concatenation) and the optimizer (the card idles inside
    them while the host launches); the step's wall; and the device's busy
    ms and kernels a step over 4 more steps under ``torch.profiler``.

Host times are wall milliseconds on the pipeline's threads, medians over the
steady frames (a padded size's first frame, or the loop's 16 warm-up ones,
left out); "frame" is the median arrival-to-arrival period. Device busy is
the profiled run's kernel time over all its frames (warm-ups included), a
frame. Prints the card, one line a mode and one JSON line with both. Needs
a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


@contextlib.contextmanager
def stage_timers(targets):
    """Time the calls of each ``(name, owner, attribute)`` in ``targets``
    while inside: ``calls[name]`` lists their host wall seconds in call
    order (each stage of these paths runs once a frame, in frame order). A
    collecting element's ``_emit`` runs at every arrival, with no set when
    none is ready: only the calls with sets are kept."""
    calls = collections.defaultdict(list)
    lock = threading.Lock()
    saved = []
    for name, owner, attr in targets:
        fn = getattr(owner, attr)
        saved.append((owner, attr, fn, attr in vars(owner)))

        def timed(*a, _fn=fn, _name=name, _sets=attr == "_emit", **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                if not _sets or a[1]:
                    with lock:
                        calls[_name].append(time.perf_counter() - t0)

        setattr(owner, attr, timed)
    try:
        yield calls
    finally:
        for owner, attr, fn, own in reversed(saved):
            if own:
                setattr(owner, attr, fn)
            else:  # inherited: drop the override
                delattr(owner, attr)


def _median_ms(xs) -> float:
    return float(np.median(xs)) * 1e3


def _crop_run(n_frames):
    """Path (b). Steady frames: those whose padded size came before (a
    size's first frame warms up and captures its graph, or eagerly lets
    cuDNN choose); each stage's median over them."""
    import chip_smoke as cs
    from nnstreamer_tpu_torch.elements.crop import TensorCrop
    from nnstreamer_tpu_torch.filters import torch_cuda

    frames, boxes = cs._crop_inputs()
    frames, boxes = frames[:n_frames], boxes[:n_frames]
    sizes = [-(-len(b) // 4) for b in boxes]
    steady = [k for k in range(1, len(boxes)) if sizes[k] in sizes[:k]]
    bounds = np.cumsum([0] + [len(b) for b in boxes])
    targets = [("emit", TensorCrop, "_emit"), ("push", TensorCrop, "push"),
               ("invoke", torch_cuda.TorchCudaFilter, "_invoke_bucketed"),
               ("resize", torch_cuda, "resize_region"),
               ("model", torch_cuda.TorchCudaFilter, "_run")]

    def run():
        arrived, reads = [], []

        def on_logits(b):
            t0 = time.perf_counter()
            b.memories[0].host()
            reads.append(time.perf_counter() - t0)
            arrived.append(time.perf_counter())

        with stage_timers(targets) as c:
            cs._crop_pipeline(frames, boxes, on_logits).run(timeout=900)
        resize = [sum(c["resize"][bounds[k]:bounds[k + 1]]) for k in range(len(boxes))]
        per = {"crop": [c["emit"][k] - c["push"][k] for k in steady],
               "resize": [resize[k] for k in steady],
               "stack+pad": [c["invoke"][k] - resize[k] - c["model"][k] for k in steady],
               "model invoke": [c["model"][k] for k in steady],
               "sink read": [reads[k] for k in steady]}
        frame = _median_ms([arrived[k] - arrived[k - 1] for k in steady])
        return frame, {k: _median_ms(v) for k, v in per.items()}, len(arrived)

    return run, {"regions_per_frame": float(np.mean([len(b) for b in boxes])),
                 "steady_frames": len(steady)}


def _lstm_run(n_frames):
    """Path (a). Steady frames: the ``n_frames`` after the 16 warm-up ones
    (the first captures the invoke's graph); each stage's median over them,
    and the round trip's."""
    import chip_smoke as cs
    from nnstreamer_tpu_torch.core.buffer import TensorMemory
    from nnstreamer_tpu_torch.elements.mux_demux import TensorDemux, TensorMux
    from nnstreamer_tpu_torch.filters import torch_cuda

    rng = np.random.default_rng(7)
    n = cs.LSTM_WARM + n_frames
    frames = [rng.standard_normal((1, cs.LSTM_DIN)).astype(np.float32) for _ in range(n)]
    targets = [("mux", TensorMux, "_emit"), ("mux push", TensorMux, "push"),
               ("invoke", torch_cuda.TorchCudaFilter, "invoke"),
               ("demux", TensorDemux, "chain"), ("demux push", TensorDemux, "push"),
               ("sink read", TensorMemory, "host")]

    def run():
        with stage_timers(targets) as c:
            _, pushed, arrived, _ = cs._repo_loop("cuda", frames, cs.LSTM_SPEC)
        steady = range(cs.LSTM_WARM, n)
        # demux pushes twice a frame: y, then the state
        per = {"mux": [c["mux"][k] - c["mux push"][k] for k in steady],
               "filter invoke": [c["invoke"][k] for k in steady],
               "demux": [c["demux"][k] - c["demux push"][2 * k]
                         - c["demux push"][2 * k + 1] for k in steady],
               "sink read": [c["sink read"][k] for k in steady]}
        stages = {k: _median_ms(v) for k, v in per.items()}
        stages["round trip"] = _median_ms([arrived[k] - pushed[k] for k in steady])
        stages["hand-offs"] = stages["round trip"] - sum(
            stages[k] for k in ("mux", "filter invoke", "demux", "sink read"))
        frame = _median_ms([arrived[k] - arrived[k - 1] for k in steady])
        return frame, stages, n

    return run, {"steady_frames": n_frames}


def _media_run(n_frames):
    """The video path. Steady frames: all but the first (it captures the
    invoke's graph, or eagerly lets cuDNN choose)."""
    import tempfile

    import chip_smoke as cs
    from nnstreamer_tpu_torch.elements.decoder import TensorDecoder
    from nnstreamer_tpu_torch.elements.media import VideoScale
    from nnstreamer_tpu_torch.elements.sources import VideoTestSrc
    from nnstreamer_tpu_torch.filters import torch_cuda
    from nnstreamer_tpu_torch.graph import Pipeline
    from nnstreamer_tpu_torch.graph.parse import parse_pipeline
    from nnstreamer_tpu_torch.models.ssd_mobilenet import write_box_priors

    tmp = tempfile.mkdtemp()
    priors, labels = os.path.join(tmp, "priors.txt"), os.path.join(tmp, "labels.txt")
    write_box_priors(priors, size=300)
    with open(labels, "w") as f:
        f.write("\n".join(f"c{i}" for i in range(91)))
    desc = cs._media_ssd_string(n_frames, labels, priors)
    targets = [("source", VideoTestSrc, "create"), ("upload", VideoScale, "_upload"),
               ("scale", VideoScale, "chain"), ("scale push", VideoScale, "push"),
               ("invoke", torch_cuda.TorchCudaFilter, "invoke"),
               ("decoder", TensorDecoder, "chain")]

    def run():
        p = parse_pipeline(desc, Pipeline("media", device="cuda"))
        sink = next(e for e in p.elements.values() if e.ELEMENT_NAME == "tensor_sink")
        arrived = []
        sink.new_data = lambda b: arrived.append(time.perf_counter())
        with stage_timers(targets) as c:
            p.run(timeout=900)
        steady = range(1, n_frames)
        per = {"source frame": [c["source"][k] for k in steady],
               "copy into staging + copy up": [c["upload"][k] for k in steady],
               "scale launches": [c["scale"][k] - c["scale push"][k] - c["upload"][k]
                                  for k in steady],
               "filter invoke": [c["invoke"][k] for k in steady],
               "decoder": [c["decoder"][k] for k in steady]}
        frame = _median_ms([arrived[k] - arrived[k - 1] for k in steady])
        return frame, {k: _median_ms(v) for k, v in per.items()}, len(arrived)

    return run, {"steady_frames": n_frames - 1, **_media_device_ms()}


def _events_ms(fn, n=20) -> float:
    """Median device ms of ``fn`` between two CUDA events, ``n`` calls."""
    out = []
    for _ in range(n + 3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return float(np.median(out[3:]))


def _media_device_ms() -> dict:
    """A 1080p frame's copy up from pinned memory and its scale to 300x300,
    each timed alone on the card."""
    from nnstreamer_tpu_torch.ops import resample

    host = torch.randint(0, 256, (1080, 1920, 3), dtype=torch.uint8).pin_memory()
    dev = host.cuda()
    return {"copy_up_device_ms": _events_ms(lambda: host.to("cuda", non_blocking=True)),
            "scale_device_ms": _events_ms(lambda: resample.resize(dev, 300, 300))}


def _train_steps(n_steps) -> dict:
    """Device ms a step between CUDA events at the parts of
    ``TensorTrainer.step`` (its ``mark`` hook), medians over ``n_steps``
    after 3 warm-up ones, the step's wall (its loss read back, as the
    element does), and the device busy ms a step over 4 more steps under
    ``torch.profiler``."""
    import chip_smoke as cs
    from nnstreamer_tpu_torch.elements.trainer import TensorTrainer

    tr = TensorTrainer(model=cs.TRAIN_SPEC, optimizer="adam", learning_rate=1e-3)
    tr.start()
    frames = cs._train_frames(n_steps + 3, cs.TRAIN_BATCH)
    frames = [(torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()) for x, y in frames]
    parts = collections.defaultdict(list)
    for k, (x, y) in enumerate(frames):
        torch.cuda.synchronize()
        ev = {"start": torch.cuda.Event(enable_timing=True)}

        def mark(part):
            ev[part] = torch.cuda.Event(enable_timing=True)
            ev[part].record()

        t0 = time.perf_counter()
        ev["start"].record()
        float(tr.step(x, y, mark))
        wall = time.perf_counter() - t0
        ev["optimizer"].synchronize()
        if k >= 3:
            names = list(ev)
            for a, b in zip(names, names[1:]):
                parts[b].append(ev[a].elapsed_time(ev[b]))
            parts["step wall"].append(wall * 1e3)
    out = {k: float(np.median(v)) for k, v in parts.items()}

    def four_steps():
        for x, y in frames[:4]:
            float(tr.step(x, y))
        return None, None, 4

    out["device busy"], out["kernels"] = device_busy_ms(four_steps)
    return out


def device_busy_ms(run) -> tuple:
    """One profiled run: device busy ms and kernels a frame."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, n = run()
        torch.cuda.synchronize()
    busy, kernels = 0.0, 0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        busy += evt.self_cuda_time_total if us is None else us
        kernels += evt.count
    return (busy / 1e3 / n if busy > 0 else None), kernels / n


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("crop", "lstm", "media", "train"),
                    default="crop")
    ap.add_argument("--frames", type=int, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_stream: no CUDA device", file=sys.stderr)
        return 1
    from nnstreamer_tpu_torch.core import graphs

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.path == "train":
        steps = args.frames or 24
        stats = _train_steps(steps)
        print(f"train mobilenet_v2 224 batch 16: device ms a step between events "
              + ", ".join(f"{k} {stats[k]:.4f}" for k in ("cast", "forward", "backward",
                                                            "optimizer", "step wall"))
              + f" (medians over {steps} steps); device busy "
              + (f"{stats['device busy']:.4f} ms" if stats["device busy"] else "not measured")
              + f", {stats['kernels']:.1f} kernels a step", flush=True)
        print(json.dumps({"card": card, "path": "train", "steps": steps,
                          "ms": stats}), flush=True)
        return 0
    frames = args.frames or {"crop": 64, "lstm": 192, "media": 64}[args.path]
    run, info = {"crop": _crop_run, "lstm": _lstm_run, "media": _media_run}[args.path](frames)
    modes = {}
    for mode in ("graphs", "eager"):
        with graphs.disabled() if mode == "eager" else contextlib.nullcontext():
            frame, stages, _ = run()
            busy, kernels = device_busy_ms(run)
        modes[mode] = {"frame_ms": frame, "stages_ms": stages,
                       "device_busy_ms": busy, "device_kernels_per_frame": kernels}
        print(f"[{mode}] {args.path}: frame {frame:.4f} ms; "
              + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
              + f" ms (medians over steady frames); device busy "
              + (f"{busy:.4f} ms" if busy else "not measured")
              + f", {kernels:.1f} kernels a frame", flush=True)
    print(json.dumps({"card": card, "path": args.path, "frames": frames, **info,
                      "modes": modes}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
