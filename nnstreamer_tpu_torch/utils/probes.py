"""Performance probes: per-phase H2D/compute/D2H splits, FLOPs, MFU, and the
on-card smoke lane.

Port of nnstreamer_tpu/utils/probes.py. The reference exposes per-filter
invoke latency / throughput as runtime props (tensor_filter.c:366-400,
tensor_filter_common.c:967-981) but cannot say *where* an invoke's time
goes. These probes measure each phase the way streaming pipelines run it:
**pipelined**, K transfers/invokes in flight, reporting the amortized
per-frame cost, with one synchronous round trip for the latency floor.

``model_flops`` counts an invoke's FLOPs with PyTorch's
``FlopCounterMode`` (matrix products and convolutions, 2 per
multiply-add), where the JAX package asks XLA's cost analysis; ``mfu``
relates achieved FLOP/s to the card's peak.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

#: per-card peak dense FLOP/s, keyed by a substring of the lower-cased CUDA
#: device name, by operand type: bf16 and "tf32" on the tensor cores,
#: float32 outside them (NVIDIA's H100 SXM data sheet; "cpu" is nominal,
#: MFU there means nothing)
PEAK_FLOPS = {
    "h100": {torch.bfloat16: 989e12, "tf32": 495e12, torch.float32: 67e12},
    "cpu": {torch.bfloat16: 1e11, "tf32": 1e11, torch.float32: 1e11},
}
DEFAULT_PEAK = PEAK_FLOPS["h100"]

#: per-card peak device-memory bandwidth (bytes/s), same keying — the
#: roofline's memory ceiling (H100 SXM HBM3)
PEAK_HBM_BW = {
    "h100": 3.35e12,
    "cpu": 50e9,  # nominal DDR figure; roofline on the CPU is not meaningful
}
DEFAULT_HBM_BW = PEAK_HBM_BW["h100"]


def _device_name(device: Any = None) -> str:
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device).lower()
    return device.type


def _by_device_name(table: Dict[str, Any], default: Any, device: Any = None) -> Any:
    name = _device_name(device)
    for key, val in table.items():
        if key in name:
            return val
    return default


def chip_peak_flops(device: Any = None, dtype: Any = torch.bfloat16) -> float:
    """Peak dense FLOP/s of ``device`` (None: the current CUDA card) for
    ``dtype`` operands: torch.bfloat16, "tf32" (float32 operands rounded
    for the tensor cores) or torch.float32 (the CUDA cores)."""
    return _by_device_name(PEAK_FLOPS, DEFAULT_PEAK, device)[dtype]


def chip_peak_hbm_bw(device: Any = None) -> float:
    return _by_device_name(PEAK_HBM_BW, DEFAULT_HBM_BW, device)


def ridge_intensity(device: Any = None, dtype: torch.dtype = torch.bfloat16) -> float:
    """Roofline ridge point (FLOPs/byte): operational intensity below
    this is memory-bound, above it compute-bound, on this card."""
    return chip_peak_flops(device, dtype) / chip_peak_hbm_bw(device)


def model_flops(fn: Callable, *example_args: Any) -> Optional[float]:
    """Per-invoke FLOPs of one call ``fn(*example_args)`` (None when it
    runs no counted operation)."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        fn(*example_args)
    flops = float(counter.get_total_flops())
    return flops if flops > 0 else None


def mfu(flops_per_frame: Optional[float], fps: float, device: Any = None,
        dtype: torch.dtype = torch.bfloat16) -> Optional[float]:
    """Model FLOPs utilization: achieved FLOP/s over the card's peak. Only
    an *MFU* when fps is measured over device-busy time (a saturating or
    synced loop). For an end-to-end pipeline rate — where batching
    budgets and host stages sit between frames — use ``pipeline_util``,
    which is the same ratio under its honest name."""
    if not flops_per_frame or not np.isfinite(fps):
        return None
    return flops_per_frame * fps / chip_peak_flops(device, dtype)


def pipeline_util(flops_per_frame: Optional[float], fps: float, device: Any = None,
                  dtype: torch.dtype = torch.bfloat16) -> Optional[float]:
    """Fraction of the card's peak consumed by a pipeline running end to
    end at ``fps``: (per-frame FLOPs × fps) / peak. Deliberately NOT called
    MFU: wall-clock fps includes everything that is not the card
    (batch-formation budgets, queue waits, host pre/post), so tiny values
    mean "the card is mostly idle between frames", not "the model runs
    inefficiently"."""
    return mfu(flops_per_frame, fps, device, dtype)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _pipelined(run_one: Callable[[int], Any], k: int,
               finish: Callable[[Sequence[Any]], None]) -> float:
    """Launch k ops back-to-back, block at the end; per-op seconds."""
    finish([run_one(i) for i in range(k)])
    t0 = time.perf_counter()
    finish([run_one(i) for i in range(k)])
    return (time.perf_counter() - t0) / k


def phase_split(fn: Callable, example: Sequence[np.ndarray], device: Any = None,
                k: int = 32) -> Dict[str, float]:
    """Amortized per-frame cost of each pipeline phase, in µs:

      * ``rtt_us``     — one synchronous tiny-transfer round trip (the
        latency floor any per-frame sync point pays);
      * ``h2d_us``     — pipelined host→device upload of one input frame;
      * ``compute_us`` — pipelined invoke with inputs already resident;
      * ``d2h_us``     — pipelined device→host readback of the outputs
        (asynchronous copies, then one synchronize — the decoder's drain
        path).

    These are throughput costs: what a deep streaming pipeline pays per
    frame, not what a lone blocking call observes.
    """
    device = torch.device("cuda" if device is None else device)
    host_frames = [torch.from_numpy(np.ascontiguousarray(a)) for a in example]
    cuda = device.type == "cuda"
    if cuda:
        host_frames = [t.pin_memory() for t in host_frames]

    def flat(outs) -> list:
        out = []
        for o in outs:
            out.extend(o if isinstance(o, (tuple, list)) else [o])
        return out

    with torch.inference_mode():
        resident = [t.to(device) for t in host_frames]
        fn(*resident)  # warm-up: allocator, library handles
        _sync(device)

        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            torch.zeros(4).to(device).cpu()
            ts.append(time.perf_counter() - t0)
        rtt = float(np.median(ts))

        h2d = _pipelined(lambda i: [t.to(device, non_blocking=True)
                                    for t in host_frames],
                         k, lambda outs: _sync(device))
        compute = _pipelined(lambda i: fn(*resident), k, lambda outs: _sync(device))

        def read_back(outs):
            for o in flat(outs):
                o.to("cpu", non_blocking=cuda)
            _sync(device)

        d2h = _pipelined(lambda i: fn(*resident), k, read_back) - compute
    return {
        "rtt_us": round(rtt * 1e6, 1),
        "h2d_us": round(h2d * 1e6, 1),
        "compute_us": round(compute * 1e6, 1),
        "d2h_us": round(max(d2h, 0.0) * 1e6, 1),
    }


#: the ``.py`` model file ``gpu_smoke``'s model_forms item writes: a
#: function of a parameter tree, in the dict form, with string infos
_PROBE_MODEL_PY = """
import torch


def make_model(device=None, scale="2"):
    w = torch.full((4,), float(scale), dtype=torch.float32, device=device)
    return {"name": "probe_scale", "apply": lambda p, x: x * p, "params": w,
            "in_info": ("4:2", "float32"), "out_info": ("4:2", "float32")}
"""


def gpu_smoke(device: Any = None) -> Dict[str, str]:
    """On-card smoke lane (the JAX package's ``tpu_smoke``): exercises the
    paths the CPU test suite runs on the CPU and reports pass/fail per item.

    Items: device-resident element flow, decoder submit/complete device
    reduce, ``tpu_smoke``'s ``bucketed_invoke`` (``custom="bucket=4"``: a
    frame's three tensors stacked, padded to 4, invoked once, three rows
    out) and ``donate_invoke`` (``custom="donate=true,sync=true"`` on a
    device-resident input), ``model_forms`` (a ``.py`` file exporting
    ``make_model`` and a ``(fn, params)`` pair through the filter), and the
    CUDA ``normalize_u8`` kernel launched on a CUDA tensor, its output
    quantized back to the input by ``quantize_affine`` (an item that fails
    off the card, as ``tpu_smoke``'s Pallas item fails off the TPU). Each
    filter item invokes twice: on the card the first invoke is captured
    into a CUDA graph and the second replays it.
    """
    device = torch.device("cuda" if device is None else device)
    results: Dict[str, str] = {"device": str(device)}

    def run(name: str, thunk: Callable[[], None]) -> None:
        try:
            thunk()
            results[name] = "pass"
        except Exception as e:  # noqa: BLE001 — report per item, run the rest
            results[name] = f"FAIL: {type(e).__name__}: {e}"[:200]

    def device_resident_flow():
        from fractions import Fraction

        from ..core import Caps
        from ..graph import Pipeline

        p = Pipeline(device=device)
        frames = [np.random.default_rng(i).integers(0, 255, (16, 16, 3))
                  .astype(np.uint8) for i in range(4)]
        src = p.add_new("appsrc", caps=Caps("video/x-raw", {
            "format": "RGB", "width": 16, "height": 16,
            "framerate": Fraction(0, 1)}), data=frames)
        conv = p.add_new("tensor_converter")
        filt = p.add_new("tensor_filter", framework="torch-cuda",
                         model="zoo://scaler?dims=3:16:16:1&types=uint8&scale=2")
        sink = p.add_new("tensor_sink", store=True)
        Pipeline.link(src, conv, filt, sink)
        p.run(timeout=300)
        assert sink.num_buffers == 4
        out = sink.buffers[0].memories[0]
        assert out.is_device and out.device().device.type == device.type, \
            "output left the device"

    def submit_complete():
        from ..core.buffer import Buffer
        from ..core.types import TensorsConfig, TensorsInfo
        from ..decoders.base import find_decoder

        seg = np.random.default_rng(0).normal(size=(1, 8, 8, 5)).astype(np.float32)
        cfg = TensorsConfig(TensorsInfo.from_strings("5:8:8:1", "float32"))
        d = find_decoder("image_segment")()
        d.init({1: "tflite-deeplab"})
        tok = d.submit(Buffer.of(torch.from_numpy(seg).to(device)), cfg)
        assert isinstance(tok, tuple), "device reduce path not taken"
        out = d.complete(tok, cfg)
        ref = d.decode(Buffer.of(seg), cfg)
        np.testing.assert_array_equal(out.memories[0].host(),
                                      ref.memories[0].host())

    def cuda_kernel():
        from ..ops.kernels import preprocess

        assert device.type == "cuda", "the kernel probe needs a CUDA device"
        x = torch.arange(256, dtype=torch.uint8, device=device).reshape(2, 128)
        before = preprocess.normalize_u8.launches
        out = preprocess.normalize_u8(x, scale=1 / 255.0, bias=0.0,
                                      out_dtype=torch.float32)
        assert preprocess.normalize_u8.launches == before + 1, "kernel not launched"
        assert torch.equal(out, preprocess.normalize_u8_plain(
            x, scale=1 / 255.0, bias=0.0, out_dtype=torch.float32))
        np.testing.assert_allclose(
            out.cpu().numpy(),
            np.arange(256, dtype=np.float32).reshape(2, 128) / 255.0, rtol=1e-6)
        before = preprocess.quantize_affine.launches
        back = preprocess.quantize_affine(out, scale=1 / 255.0, zero_point=0)
        assert preprocess.quantize_affine.launches == before + 1, "kernel not launched"
        assert torch.equal(back, x), "quantize_affine does not invert normalize_u8"

    def twice(model: Any, custom: str, inputs: Callable[[], list],
              check: Callable[[list], None]) -> None:
        from ..filters.base import FilterProps
        from ..filters.torch_cuda import TorchCudaFilter

        f = TorchCudaFilter()
        f.open(FilterProps(model=model, custom=custom, device=device))
        try:
            for _ in range(2):  # on the card: a capture, then a replay
                outs = f.invoke(inputs())
                assert all(o.is_device for o in outs), "output left the device"
                check([o.host() for o in outs])
        finally:
            f.close()

    def bucketed():
        from ..core.buffer import TensorMemory

        frames = [np.full((3, 3), i, np.float32) for i in range(3)]

        def check(outs):
            assert outs[0].shape == (3, 3, 3)
            np.testing.assert_array_equal(outs[0], np.stack(frames) * 2)

        twice("zoo://scaler?scale=2", "bucket=4",
              lambda: [TensorMemory(x) for x in frames], check)

    def donate():
        from ..core.buffer import TensorMemory

        x = np.ones((4, 4), np.float32)
        twice("zoo://scaler?scale=3", "donate=true,sync=true",
              lambda: [TensorMemory(torch.from_numpy(x).to(device))],
              lambda outs: np.testing.assert_allclose(outs[0], x * 3))

    def model_forms():
        import os
        import tempfile

        from ..core.buffer import TensorMemory

        x = np.arange(8, dtype=np.float32).reshape(2, 4)
        w = torch.full((4,), 5.0, device=device)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "probe_model.py")
            with open(path, "w", encoding="utf-8") as fh:
                fh.write(_PROBE_MODEL_PY)
            for model, custom, scale in ((path, "scale=3", 3.0),
                                         ((lambda p, t: t * p, w), "", 5.0)):
                twice(model, custom, lambda: [TensorMemory(x)],
                      lambda outs, s=scale: np.testing.assert_array_equal(
                          outs[0], x * s))

    run("device_resident_flow", device_resident_flow)
    run("decoder_submit_complete", submit_complete)
    run("bucketed_invoke", bucketed)
    run("donate_invoke", donate)
    run("model_forms", model_forms)
    run("cuda_kernel", cuda_kernel)
    return results
