"""Where one detection or segmentation frame, or one LM decode step, spends
its time on the GPU.

    python3 scripts/profile_torch_ssd.py [--model ssd|deeplab|lm] [--frames 32]
                                         [--quant float32|w8a8]

Runs the torch port's invoke the way the pipeline does — the ``torch-cuda``
filter with the decoder's device reduce fused in — then the decoder's host
side, over seeded random frames, first timed without the profiler, then
under ``torch.profiler``; in two modes, one after the other in the same
process: with CUDA graphs (the port's default: the invoke, or the engine's
decode chunk, replays one captured graph per signature) and eagerly
(``graphs.disabled()``, every kernel launched from Python):

  * ``ssd`` (default): SSD-MobileNet-v2 300x300, 91 classes. Invoke = H2D
    copy of the uint8 frame, model, box decode, ``class_reduce`` and
    ``nms_sweep`` kernels; host side = D2H of the (256, 6) rows, box and
    label drawing.
  * ``deeplab``: DeepLab-v3 257x257, 21 classes. Invoke = H2D copy, model
    (MobileNet-v2 at output stride 16, ASPP, float32 bilinear upsample),
    ``segment_colorize`` kernel; host side = D2H of the (257, 257, 4)
    canvas and the decoder's copy of it.
  * ``lm``: one decode step of the serving engine at the bench LM's full
    width (V 8192, d_model 1024, 16 heads, 8 layers; max_len 1024, 8 slots
    filled by prompts of the bench's serving mix), over float32 params or
    (``--quant w8a8``) their w8a8 form: ``LMEngine._run_chunk`` of 16 steps,
    the engine's unit of work between scheduler interventions, including
    its one read-back of the chunk's tokens. ``--frames`` counts decode
    steps (rounded to whole chunks). Then the device ms of one admit
    prefill of a prompt filling its bucket (64, 256 and 512 tokens), in
    each form the module has: ``lm_prefill_window`` (the engines' admit
    prefill) and ``lm_prefill_masked`` (the dense form), each captured
    into a CUDA graph and replayed.

Prints for each mode, per frame (per decode step for ``lm``): host wall
time of the invoke and of the host decode, device busy time and its share
of the profiled wall time, the device's kernel launches and the host's
launch calls (``cudaLaunchKernel`` and its kin, ``cudaGraphLaunch``), device
time by kernel category, and the top kernels; then one JSON line with both
modes' numbers. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
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
#: the bench LM (bench.py _LM_DIMS: vocab, d_model, heads, layers) and its
#: serving engine's shape
LM_DIMS, LM_MAX_LEN, LM_SLOTS, LM_CHUNK = (8192, 1024, 16, 8), 1024, 8, 16

CATEGORIES = (
    ("flash_attention", ("flash_kernel",)),
    ("dequant_gelu_requant", ("dgr_kernel",)),
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


#: the LM's kernels by what they compute: its GEMMs before the convolution
#: keys (cuBLAS and its int8 path name theirs gemm, gemv, sm90 or cutlass)
LM_CATEGORIES = (
    ("matmul", ("gemm", "gemv", "sm90", "cutlass", "xmma", "dot")),
    ("softmax", ("softmax",)),
    ("index/scatter", ("index", "scatter", "gather")),
)


def category(name: str, lm: bool = False) -> str:
    low = name.lower()
    for cat, keys in (CATEGORIES[:2] + LM_CATEGORIES + CATEGORIES[2:]
                      if lm else CATEGORIES):
        if any(k in low for k in keys):
            return cat
    return "other"


def _frame_work(model: str, n_frames: int):
    """The filter's fused invoke over seeded frames: (frames, run all of
    them, host decode ms per frame)."""
    from nnstreamer_tpu_torch.core.buffer import Buffer, TensorMemory
    from nnstreamer_tpu_torch.core.hw import resolve_device
    from nnstreamer_tpu_torch.decoders.bounding_box import BoundingBox
    from nnstreamer_tpu_torch.decoders.image_segment import ImageSegment
    from nnstreamer_tpu_torch.filters.base import FilterProps
    from nnstreamer_tpu_torch.filters.torch_cuda import TorchCudaFilter
    from nnstreamer_tpu_torch.models.ssd_mobilenet import write_box_priors

    spec, size = SPECS[model]
    if model == "ssd":
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
              for _ in range(n_frames)]

    def invoke(frame):
        return fw.invoke([TensorMemory(frame)])[0]

    for frame in frames[:4]:  # warm-up: cuDNN plans, kernel build
        invoke(frame).host()
    rows = [invoke(f) for f in frames]
    for r in rows:
        r.host()
    t0 = time.perf_counter()
    for r in rows:
        dec.decode(Buffer([r]), None)
    decode_ms = (time.perf_counter() - t0) * 1e3 / len(frames)

    def run(profiled: bool) -> None:
        if profiled:  # one frame at a time, each read back before the next
            for f in frames:
                invoke(f).host()
            return
        for r in [invoke(f) for f in frames]:
            r.host()

    return len(frames), run, decode_ms


def _lm_work(quant: str, n_steps: int):
    """Decode chunks of the full-width serving engine with every slot
    holding a prompt of the bench's serving mix: (steps, run them, None)."""
    from nnstreamer_tpu_torch.models import causal_lm
    from nnstreamer_tpu_torch.models.convert import causal_lm_params
    from nnstreamer_tpu_torch.serving import LMEngine

    v, d, h, n_layers = LM_DIMS
    params = causal_lm_params(causal_lm.init_causal_lm(
        0, v, d, h, n_layers, LM_MAX_LEN), "cuda")
    if quant == "w8a8":
        params = causal_lm.quantize_lm_params(params)
    eng = LMEngine(params, h, LM_MAX_LEN, n_slots=LM_SLOTS, chunk=LM_CHUNK)
    rng = np.random.default_rng(5)
    for i in range(LM_SLOTS):
        eng.submit(rng.integers(0, v, (64, 192, 384, 512)[i % 4]), max_new=256)
    eng._admit()  # prefill every slot
    chunks = max(1, n_steps // LM_CHUNK)
    eng._run_chunk(LM_CHUNK).cpu()  # warm-up

    def run(profiled: bool) -> None:
        for _ in range(chunks):
            eng._run_chunk(LM_CHUNK).cpu()  # the engine's one read-back

    return chunks * LM_CHUNK, run, None


def _graph_ms(fn, replays: int = 5) -> float:
    """Device ms of ``fn()``: warmed up on a side stream, captured into a
    CUDA graph, replayed ``replays`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
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
    return start.elapsed_time(end) / replays


def _prefill_ms(quant: str) -> dict:
    """Device ms of one admit prefill by form and bucket (a prompt filling
    its bucket), at the bench LM's width."""
    from nnstreamer_tpu_torch.models import causal_lm
    from nnstreamer_tpu_torch.models.convert import causal_lm_params

    v, d, h, n_layers = LM_DIMS
    params = causal_lm_params(causal_lm.init_causal_lm(
        0, v, d, h, n_layers, LM_MAX_LEN), "cuda")
    if quant == "w8a8":
        params = causal_lm.quantize_lm_params(params)
    rng = np.random.default_rng(6)
    out = {}
    for bucket in (64, 256, 512):
        tok = torch.from_numpy(rng.integers(0, v, (1, bucket)).astype(np.int32)).cuda()
        for name in ("lm_prefill_window", "lm_prefill_masked"):
            form = getattr(causal_lm, name, None)
            if form is not None:
                out[f"{name} {bucket}"] = _graph_ms(
                    lambda: form(params, tok, bucket, h, LM_MAX_LEN))
    return out


#: the host's CUDA launch calls, as the profiler names them: kernels one by
#: one, and a whole captured graph
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                     "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch")


def measure(run, n: int, unit: str, lm: bool) -> dict:
    """One mode: the unprofiled wall per unit, then a profiled run's device
    busy time, launches and categories."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(profiled=False)
    torch.cuda.synchronize()
    invoke_ms = (time.perf_counter() - t0) * 1e3 / n

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(profiled=True)
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / n

    by_kernel = collections.Counter()
    launches = collections.Counter()
    host_calls = collections.Counter()
    for evt in prof.key_averages():
        if evt.key in HOST_LAUNCH_CALLS:
            host_calls[evt.key] += evt.count
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        by_kernel[evt.key] += us
        launches[evt.key] += evt.count
    device_ms = sum(by_kernel.values()) / 1e3 / n
    by_cat = collections.Counter()
    for name, us in by_kernel.items():
        by_cat[category(name, lm)] += us / 1e3 / n
    return {"wall_ms": invoke_ms, "profiled_wall_ms": profiled_ms,
            "device_busy_ms": device_ms if device_ms > 0 else None,
            "busy_share": device_ms / profiled_ms if device_ms > 0 else None,
            "device_launches_per_unit": sum(launches.values()) / n,
            "host_launch_calls_per_unit": {k: c / n for k, c in host_calls.items()},
            "device_ms_by_category": dict(by_cat),
            "top": [(name, us / 1e3 / n, launches[name] / n)
                    for name, us in by_kernel.most_common(10)]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(SPECS) + ["lm"], default="ssd")
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--quant", choices=("float32", "w8a8"), default="float32")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_ssd: no CUDA device", file=sys.stderr)
        return 1
    from nnstreamer_tpu_torch.core import graphs

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)

    lm = args.model == "lm"
    print(f"model causal_lm {LM_DIMS} ({args.quant})" if lm
          else f"model {SPECS[args.model][0]}", flush=True)
    n, run, decode_ms = (_lm_work(args.quant, args.frames) if lm
                         else _frame_work(args.model, args.frames))
    unit = "decode step" if lm else "frame"
    modes = {}
    for mode in ("graphs", "eager"):
        with graphs.disabled() if mode == "eager" else contextlib.nullcontext():
            graphs.reset_stats()
            m = modes[mode] = measure(run, n, unit, lm)
            m["graph_stats"] = graphs.stats()
        busy = (f"{m['device_busy_ms']:.4f} ms = {m['busy_share']:.3f} of the "
                "profiled wall" if m["device_busy_ms"] else "not measured")
        print(f"[{mode}] per {unit}: {'wall' if lm else 'invoke wall'} "
              f"{m['wall_ms']:.4f} ms (profiled {m['profiled_wall_ms']:.4f})"
              + ("" if lm else f", host decode {decode_ms:.4f} ms")
              + f", device busy {busy}", flush=True)
        print(f"[{mode}] device launches per {unit}: "
              f"{m['device_launches_per_unit']:.1f}; host launch calls per {unit}: "
              f"{json.dumps(m['host_launch_calls_per_unit'])}; graphs "
              f"{json.dumps(m['graph_stats'])}", flush=True)
        for cat, ms in sorted(m["device_ms_by_category"].items(), key=lambda kv: -kv[1]):
            print(f"[{mode}]   {cat:20s} {ms:.4f} ms/{unit}", flush=True)
        for name, ms, count in m["top"]:
            print(f"[{mode}]   {ms:.4f} ms/{unit} x{count:.1f}  {name[:100]}", flush=True)
    prefill = None
    if lm:
        prefill = _prefill_ms(args.quant)
        print("admit prefill, device ms a prompt filling its bucket: "
              + ", ".join(f"{k} {ms:.4f}" for k, ms in prefill.items()), flush=True)
    print(json.dumps({
        "card": card, "model": args.model, "quant": args.quant if lm else None,
        "units": n, "unit": unit, "host_decode_ms": decode_ms, "prefill_ms": prefill,
        "modes": {k: {key: v for key, v in m.items() if key != "top"}
                  for k, m in modes.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
