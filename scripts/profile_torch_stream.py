"""Where a frame of the port's two stream paths spends its time on the GPU.

    python3 scripts/profile_torch_stream.py [--path crop|lstm] [--frames N]

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
    ap.add_argument("--path", choices=("crop", "lstm"), default="crop")
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
    frames = args.frames or (64 if args.path == "crop" else 192)
    run, info = (_crop_run if args.path == "crop" else _lstm_run)(frames)
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
