"""The port's obs.profile against the JAX package's.

Every case of tests/test_profile.py that applies, run against
``nnstreamer_tpu_torch.obs.profile``: the zero-overhead-when-off hook
contract, the profiler core (ring, samples, program-cache and compile
telemetry, engine records), the Perfetto export (host, device and serving
lanes), ``/debug/profile`` on the exporter's dispatch table, the LM engine's
MFU gauges and the probes' roofline helpers. Then what is the port's own: a
sampled dispatch on CPU tensors takes its wall as ``device_ns``, the cost
comes from ``FlopCounterMode`` during the eager run (never inside a
capture), and a kernel label is kept once per eager (label, shape, dtype)
and at every capture; the seven wrappers' kernel records equal the JAX
package's Pallas kernels run in interpret mode, by (name after the dot,
shape, dtype). The CUDA-event timing and a capture with the profiler on are
``cuda`` tests: they skip without a card.
"""

import json
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nnstreamer_tpu.obs import profile as jax_profile
from nnstreamer_tpu.ops.pallas import epilogue as jep
from nnstreamer_tpu.ops.pallas import flash_attention as jfa
from nnstreamer_tpu.ops.pallas import preprocess as jpp
from nnstreamer_tpu_torch.core import graphs
from nnstreamer_tpu_torch.core.buffer import TensorMemory
from nnstreamer_tpu_torch.core.types import Caps, TensorsConfig, TensorsInfo
from nnstreamer_tpu_torch.graph import Pipeline
from nnstreamer_tpu_torch.graph import element as gel
from nnstreamer_tpu_torch.obs import metrics as obs_metrics
from nnstreamer_tpu_torch.obs import profile
from nnstreamer_tpu_torch.obs import tracing
from nnstreamer_tpu_torch.obs.exporter import start_exporter
from nnstreamer_tpu_torch.ops import epilogue as epi
from nnstreamer_tpu_torch.ops.kernels import epilogue as tep
from nnstreamer_tpu_torch.ops.kernels import flash_attention as tfa
from nnstreamer_tpu_torch.ops.kernels import preprocess as tpp
from nnstreamer_tpu_torch.utils import probes

CPU = torch.device("cpu")


def tensor_caps(dims, types, rate=30):
    return Caps.tensors(TensorsConfig(TensorsInfo.from_strings(dims, types),
                                      rate))


@pytest.fixture
def global_metrics():
    was = obs_metrics.enabled()
    yield obs_metrics.registry()
    (obs_metrics.enable if was else obs_metrics.disable)()


def _reset(mod):
    mod.disable()
    mod.profiler().reset()
    mod.profiler().sample_every = mod.DEFAULT_SAMPLE_EVERY
    mod.profiler().resize(mod.DEFAULT_MAX_RECORDS)


@pytest.fixture
def prof():
    """Profiling off + profiler reset around every test in this file."""
    _reset(profile)
    yield profile
    _reset(profile)


@pytest.fixture
def global_tracing():
    was = tracing.enabled()
    tracing.store().reset()
    yield tracing
    tracing.store().reset()
    (tracing.enable if was else tracing.disable)()


def _tiny_pipeline():
    p = Pipeline(device="cpu")
    src = p.add_new("videotestsrc", width=8, height=8, num_buffers=2)
    conv = p.add_new("tensor_converter")
    sink = p.add_new("tensor_sink")
    Pipeline.link(src, conv, sink)
    return p, conv


def _scaler_filter():
    from nnstreamer_tpu_torch.filters.base import FilterProps
    from nnstreamer_tpu_torch.filters.torch_cuda import TorchCudaFilter

    f = TorchCudaFilter()
    f.open(FilterProps(model="zoo://scaler?dims=4:1&types=float32&scale=2",
                       custom="sync=true", device=CPU))
    return f


def _invoke(f, n=1):
    out = None
    for _ in range(n):
        out = f.invoke([TensorMemory(np.ones((1, 4), np.float32))])
    return out


# --------------------------------------------------------------------------- #
# The hook contract
# --------------------------------------------------------------------------- #

def test_hooks_are_none_when_off(prof):
    assert profile.DISPATCH_HOOK is None and profile.ENGINE_HOOK is None
    assert profile.KERNEL_HOOK is None and profile.SCHED_HOOK is None
    assert gel.PROFILE_CHAIN_HOOK is None and epi.EPILOGUE_SELECT_HOOK is None
    assert not profile.enabled()


def test_enable_installs_and_disable_clears(prof):
    p = profile.profiler()
    profile.enable()
    try:
        assert profile.DISPATCH_HOOK is p and profile.ENGINE_HOOK is p
        assert profile.SCHED_HOOK is p
        assert profile.KERNEL_HOOK == p.record_kernel
        assert gel.PROFILE_CHAIN_HOOK == p.profiled_chain
        assert epi.EPILOGUE_SELECT_HOOK == p.epilogue_select
        assert profile.enabled()
    finally:
        profile.disable()
    assert profile.DISPATCH_HOOK is None and profile.KERNEL_HOOK is None
    assert gel.PROFILE_CHAIN_HOOK is None and epi.EPILOGUE_SELECT_HOOK is None


def test_disabled_run_records_nothing(prof, global_metrics):
    obs_metrics.disable()
    p, conv = _tiny_pipeline()
    p.run(timeout=30)
    assert profile.profiler().records() == []
    assert profile.profiler().stats()["dispatches"] == 0
    assert "_chain_entry" not in conv.__dict__


def test_disabled_dispatch_skips_profiler(prof, global_metrics):
    out = _invoke(_scaler_filter())
    np.testing.assert_array_equal(out[0].host(),
                                  np.full((1, 4), 2.0, np.float32))
    assert profile.profiler().records() == []


def test_enabled_chain_hook_times_elements(prof, global_metrics):
    obs_metrics.disable()
    profile.enable()
    p, conv = _tiny_pipeline()
    p.run(timeout=30)
    recs = profile.profiler().records("element")
    assert {r["label"] for r in recs} >= {conv.name}
    assert all(r["dur_ns"] >= 0 for r in recs)


# --------------------------------------------------------------------------- #
# Profiler core
# --------------------------------------------------------------------------- #

def test_ring_is_bounded_and_counts_drops(prof):
    p = profile.Profiler(max_records=4)
    for i in range(10):
        p.record_kernel(f"k{i}", (1,), "float32")
    assert len(p.records()) == 4 and p.stats()["dropped"] == 6
    assert [r["label"] for r in p.records()] == ["k6", "k7", "k8", "k9"]
    p.resize(3)
    assert [r["label"] for r in p.records()] == ["k7", "k8", "k9"]


def test_dispatch_records_and_samples(prof, global_metrics):
    obs_metrics.enable()
    profile.enable(sample_every=1)
    _invoke(_scaler_filter(), n=3)
    p = profile.profiler()
    recs = p.records("dispatch")
    assert len(recs) == 3 and [r["label"] for r in recs] == ["scaler"] * 3
    # on CPU tensors the sampled device time is the call's own wall
    assert all(r["device_ns"] == r["dur_ns"] and r["args"]["wait_ns"] == 0
               for r in recs)
    assert sum(r["gap_ns"] is not None for r in recs) == 2
    (s,) = p.samples()
    assert s["n"] == 3 and s["device_n"] == 3 and s["device"] == "cpu"
    assert s["shapes"] == ((1, 4),) and s["dtypes"] == ("float32",)
    assert s["mean_host_us"] > 0
    # bytes: no weights, one (1, 4) float32 input and output
    assert s["bytes"] == 32.0 and s["flops"] == 0.0


def test_sampling_cadence(prof, global_metrics):
    profile.enable(sample_every=2)
    _invoke(_scaler_filter(), n=4)
    assert [r["device_ns"] is not None
            for r in profile.profiler().records("dispatch")] == \
        [False, True, False, True]


def test_jit_cache_and_compile_telemetry(prof, global_metrics):
    obs_metrics.enable()
    profile.enable()

    def counts():
        fam = obs_metrics.registry().snapshot().get(
            "nnstpu_profile_jit_cache_total", {"series": []})
        return {(s["labels"]["site"], s["labels"]["event"]): s["value"]
                for s in fam["series"]}

    before = counts()
    f = _scaler_filter()
    _invoke(f, n=3)
    f2 = _scaler_filter()  # the same bundle and configuration again
    after = counts()
    d = {k: after[k] - before.get(k, 0) for k in after}
    assert d[("executable", "miss")] == 1 and d[("executable", "hit")] == 2
    assert d[("bundle", "hit")] >= 1
    del f2
    snap = obs_metrics.registry().snapshot()
    assert any(s["labels"]["site"] == "xla" and s["count"] >= 1
               for s in snap["nnstpu_profile_compile_seconds"]["series"])
    assert any(s["labels"] == {"kind": "xla", "clock": "host"}
               and s["count"] >= 3
               for s in snap["nnstpu_profile_dispatch_seconds"]["series"])


def test_cost_counts_matmul_flops_and_weight_bytes(prof, global_metrics):
    """A (fn, params) model: FLOPs from FlopCounterMode during the first
    (eager) call, bytes = weights + input + output."""
    from nnstreamer_tpu_torch.filters.base import FilterProps
    from nnstreamer_tpu_torch.filters.torch_cuda import TorchCudaFilter

    w = torch.ones(16, 8)
    f = TorchCudaFilter()
    f.open(FilterProps(model=(lambda prm, x: x @ prm["w"], {"w": w}),
                       device=CPU, input_info=TensorsInfo.from_strings(
                           "16:4", "float32")))
    profile.enable(sample_every=1)
    for _ in range(2):
        f.invoke([TensorMemory(np.ones((4, 16), np.float32))])
    (s,) = profile.profiler().samples()
    assert s["flops"] == 2 * 4 * 16 * 8
    assert s["bytes"] == 16 * 8 * 4 + 4 * 16 * 4 + 4 * 8 * 4
    assert profile.profiler().stats()["lanes"]["xla"]["n"] == 1


def test_costing_runs_a_captured_fn_eagerly_once():
    """graphs.costing hands the next eager run of a CapturedFn a dispatch
    mode, which that call uses up; inside a capture nothing runs under it."""
    from torch.utils.flop_counter import FlopCounterMode

    fn = graphs.CapturedFn(lambda x: x @ x, "square")
    mode = FlopCounterMode(display=False)
    x = torch.ones(3, 3)
    with graphs.costing(mode):
        fn(x)
        fn(x)
    assert mode.get_total_flops() == 2 * 27
    assert not graphs.capturing()
    with graphs.recording([]):
        assert graphs.capturing()


def test_record_engine_updates_mfu_lane(prof, global_metrics):
    obs_metrics.enable()
    profile.enable()
    eng = SimpleNamespace(params={"w": torch.ones(64, 64)},
                          _engine_label="lm")
    p = profile.profiler()
    p.record_engine(eng, "decode", 0, 10_000_000, tokens=8, steps=8,
                    active=2, queued=1, slots=4)
    assert p.records("engine")[0]["label"] == "lm.decode"
    assert p.records("occupancy")[0]["args"]["active"] == 2
    st = p.stats()["lanes"]["lm"]
    assert st["flops_s"] == pytest.approx(2 * 64 * 64 * 8 / 0.01)
    assert st["intensity"] == pytest.approx(2 * 8 / (4 * 8))


def test_record_engine_equals_jax_on_the_same_interval(prof):
    """The analytic 2·N·tokens FLOPs and 4·N bytes a step, as the JAX
    profiler reckons them, on numpy and on torch leaves alike."""
    mine, ref = profile.Profiler(), jax_profile.Profiler()
    for p, params in ((mine, {"a": {"w": torch.ones(8, 8)},
                              "b": torch.zeros(3)}),
                      (ref, {"a": {"w": np.ones((8, 8))}, "b": np.zeros(3)})):
        eng = SimpleNamespace(params=params, _engine_label="lm")
        p.record_engine(eng, "decode", 0, 4_000_000, tokens=6, steps=2,
                        active=1, queued=0, slots=2)
    assert mine.stats()["lanes"] == ref.stats()["lanes"]
    strip = lambda rs: [{k: v for k, v in r.items() if k != "tid"}  # noqa
                        for r in rs]
    assert strip(mine.records()) == strip(ref.records())


def test_first_use_interval_is_compile_not_compute(prof, global_metrics):
    obs_metrics.enable()
    profile.enable()
    eng = SimpleNamespace(params={"w": torch.ones(8, 8)}, _engine_label="lm")
    p = profile.profiler()
    p.record_engine(eng, "prefill", 0, 5_000_000, tokens=4, compiled=True)
    assert "lm" not in p.stats()["lanes"]
    comp = obs_metrics.registry().snapshot()[
        "nnstpu_profile_compile_seconds"]["series"]
    assert any(s["labels"]["site"] == "engine" and s["count"] >= 1
               for s in comp)


def test_dump_samples_roundtrip(prof, tmp_path):
    p = profile.Profiler()
    p._record_sample(("lbl", ((1, 4),), ("float32",)), 1000, 900,
                     {"flops": 8.0, "bytes": 32.0}, [])
    path = str(tmp_path / "samples.json")
    assert p.dump_samples(path) == 1
    doc = json.loads(open(path).read())
    assert doc["version"] == 1
    (row,) = doc["samples"]
    assert row["label"] == "lbl" and row["flops"] == 8.0


def test_report_smoke(prof):
    profile.enable()
    profile.profiler().record_kernel("k", (2, 2), "float32")
    assert "records" in profile.report()


def test_epilogue_select_vetoes_only_measured_negligible_chains(prof):
    p = profile.Profiler()
    assert p.epilogue_select("f", ["dec"]) is True
    p._append({"kind": "element", "label": "dec", "t0_ns": 0, "dur_ns": 10,
               "device_ns": None, "gap_ns": None, "tid": 0, "args": {}})
    assert p.epilogue_select("f", ["dec"]) is False
    assert jax_profile.Profiler.epilogue_select(p, "f", ["dec"]) is False


# --------------------------------------------------------------------------- #
# Kernel labels
# --------------------------------------------------------------------------- #

def test_kernel_label_once_per_eager_signature_and_at_every_capture(prof):
    profile.enable()
    x = torch.rand(8, 5)
    for _ in range(3):
        tep.class_reduce(x)
    tep.class_reduce(torch.rand(4, 5))
    with graphs.recording([]):   # what a capture's thread sees
        tep.class_reduce(x)
        tep.class_reduce(x)
    recs = profile.profiler().records("kernel")
    assert [(r["args"]["shape"], r["args"]["capture"]) for r in recs] == [
        ((8, 5), False), ((4, 5), False), ((8, 5), True), ((8, 5), True)]
    assert {r["label"] for r in recs} == {"cuda.class_reduce"}


def _kernel_calls(rng):
    """The same inputs for the seven kernels, as numpy arrays."""
    scores = np.sort(rng.random(64).astype(np.float32))[::-1].copy()
    x0 = rng.random(64).astype(np.float32)
    y0 = rng.random(64).astype(np.float32)
    return dict(
        cls=rng.random((96, 7)).astype(np.float32),
        boxes=(x0, y0, x0 + 0.2, y0 + 0.3, scores),
        logits=rng.random((9, 11, 21)).astype(np.float32),
        palette=rng.integers(0, 256, (256, 4)).astype(np.uint8),
        dgr=(rng.integers(-4000, 4000, (8, 256)).astype(np.int32),
             rng.uniform(1e-4, 1e-3, (8, 1)).astype(np.float32),
             rng.uniform(1e-4, 1e-3, (256,)).astype(np.float32)),
        qkv=[rng.standard_normal((1, 2, 32, 16)).astype(np.float32)
             for _ in range(3)],
        u8=rng.integers(0, 256, (6, 10, 3)).astype(np.uint8),
        f32=rng.random((6, 10, 3)).astype(np.float32))


def _run_jax_kernels(a):
    jep.class_reduce(a["cls"], interpret=True)
    jep.nms_sweep(*a["boxes"], iou_threshold=0.5, threshold=0.1,
                  interpret=True)
    jep.segment_colorize(a["logits"], a["palette"], interpret=True)
    jep.dequant_gelu_requant(*a["dgr"], out_dtype=jnp.float32, interpret=True)
    jfa.flash_attention(*a["qkv"], causal=True, interpret=True)
    jpp.normalize_u8(a["u8"], out_dtype=jnp.float32, interpret=True)
    jpp.quantize_affine(a["f32"], 1.0 / 255.0, interpret=True)


def _run_port_kernels(a):
    t = torch.from_numpy
    tep.class_reduce(t(a["cls"]))
    tep.nms_sweep(*(t(b) for b in a["boxes"]), iou_threshold=0.5,
                  threshold=0.1)
    tep.segment_colorize(t(a["logits"]), t(a["palette"]))
    tep.dequant_gelu_requant(*(t(b) for b in a["dgr"]),
                             out_dtype=torch.float32)
    tfa.flash_attention(*(t(b) for b in a["qkv"]), causal=True)
    tpp.normalize_u8(t(a["u8"]), out_dtype=torch.float32)
    tpp.quantize_affine(t(a["f32"]), 1.0 / 255.0)


def _kernel_set(records):
    return sorted((r["label"].split(".", 1)[1], tuple(r["args"]["shape"]),
                   str(r["args"]["dtype"])) for r in records)


def test_kernel_records_equal_jax_interpret(prof):
    """The seven wrappers' kernel records, by (name after the dot, shape,
    dtype), equal the JAX package's Pallas kernels run in interpret mode on
    the same seeded inputs; the port's names are ``cuda.<kernel>``."""
    a = _kernel_calls(np.random.default_rng(4))
    _reset(jax_profile)
    jax_profile.enable()
    try:
        _run_jax_kernels(a)
        want = _kernel_set(jax_profile.profiler().records("kernel"))
    finally:
        _reset(jax_profile)
    profile.enable()
    _run_port_kernels(a)
    recs = profile.profiler().records("kernel")
    assert _kernel_set(recs) == want
    assert len(want) == 7
    assert all(r["label"].startswith("cuda.") for r in recs)


# --------------------------------------------------------------------------- #
# Perfetto export
# --------------------------------------------------------------------------- #

def test_empty_trace_is_valid_json(prof):
    doc = profile.perfetto_trace()
    assert json.loads(json.dumps(doc))["displayTimeUnit"] == "ms"
    assert doc["otherData"]["profile_enabled"] is False
    names = {e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert names == {"host", "device", "serving", "sched"}
    want = jax_profile.perfetto_trace(prof=jax_profile.Profiler())
    assert set(doc["otherData"]) == set(want["otherData"])


def test_composite_pipeline_all_three_lane_groups(prof, global_metrics,
                                                  global_tracing):
    tracing.enable()
    profile.enable(sample_every=1)
    p = Pipeline(device="cpu")
    src = p.add_new("appsrc", caps=tensor_caps("4:1", "float32"),
                    data=[np.ones((1, 4), np.float32)] * 3)
    filt = p.add_new("tensor_filter", framework="xla-tpu",
                     model="zoo://scaler?dims=4:1&types=float32&scale=2")
    sink = p.add_new("tensor_sink")
    Pipeline.link(src, filt, sink)
    p.run(timeout=60)
    tracing.store().start_span("serving.prefill", attrs={"engine": "lm"}).end()
    doc = profile.perfetto_trace(span_store=tracing.store())
    json.dumps(doc)
    slices = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert {e["pid"] for e in slices} >= {1, 2, 3}
    host = [e for e in slices if e["pid"] == 1]
    dev = [e for e in slices if e["pid"] == 2]
    srv = [e for e in slices if e["pid"] == 3]
    assert any(e["name"].startswith("tensor_filter") for e in host)
    assert any("scaler" in e["name"] for e in dev)
    assert any(e["args"]["clock"] == "device" for e in dev)
    assert [e["name"] for e in srv] == ["prefill"]
    assert all(e["ts"] > 0 and e["dur"] >= 0 for e in slices)


def test_element_records_are_host_lane_fallback(prof, global_metrics):
    obs_metrics.disable()
    profile.enable()
    p, conv = _tiny_pipeline()
    p.run(timeout=30)
    host = [e for e in profile.perfetto_trace()["traceEvents"]
            if e["ph"] == "X" and e["pid"] == 1]
    assert any(e["name"] == conv.name for e in host)


def test_occupancy_and_sched_counter_tracks(prof):
    profile.enable()
    eng = SimpleNamespace(params={}, _engine_label="lm")
    profile.profiler().record_engine(eng, "decode", 0, 1000, tokens=1,
                                     active=3, queued=2, slots=4)
    profile.profiler().record_sched("e", "cam", 10, 20, width=2,
                                    tenants=["a", "b"], queued=1)
    cs = {e["name"]: e for e in profile.perfetto_trace()["traceEvents"]
          if e["ph"] == "C"}
    assert cs["lm.slots"]["args"] == {"active": 3, "queued": 2}
    assert cs["e.coalesce"]["args"] == {"width": 2, "queued": 1,
                                        "inflight": 0}


def test_sched_engine_feeds_the_sched_hook(prof):
    from nnstreamer_tpu_torch.sched import DeviceEngine

    profile.enable()
    clock = {"t": 0.0}
    eng = DeviceEngine("prof", autostart=False, clock=lambda: clock["t"])
    t = eng.register("cam")
    fut = eng._submit(t, None, None, None, lambda: 7, None, "op")
    assert eng.step() and fut.result(5) == 7
    (rec,) = profile.profiler().records("sched")
    assert rec["label"] == "prof.op" and rec["args"]["tenants"] == ["cam"]


# --------------------------------------------------------------------------- #
# /debug/profile and the LM engine's gauges
# --------------------------------------------------------------------------- #

def test_debug_profile_serves_trace_json(prof, global_metrics):
    profile.enable()
    profile.profiler().record_kernel("cuda.k", (1,), "float32")
    with start_exporter(port=0) as exp:
        base = f"http://127.0.0.1:{exp.port}"
        doc = json.loads(urllib.request.urlopen(f"{base}/debug/profile",
                                                timeout=5).read())
        samples = json.loads(urllib.request.urlopen(
            f"{base}/debug/profile/samples", timeout=5).read())
    assert doc["otherData"]["profile_enabled"] is True
    assert any(e.get("cat") == "kernel" for e in doc["traceEvents"])
    assert samples == {"version": 1, "profile_enabled": True, "samples": []}


def test_debug_profile_off_is_still_200(prof, global_metrics):
    with start_exporter(port=0) as exp:
        doc = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{exp.port}/debug/profile", timeout=5).read())
    assert doc["otherData"]["profile_enabled"] is False


def test_lm_engine_run_exposes_mfu_family(prof, global_metrics):
    from nnstreamer_tpu_torch.models import causal_lm
    from nnstreamer_tpu_torch.models.convert import causal_lm_params
    from nnstreamer_tpu_torch.serving.lm_engine import LMEngine

    obs_metrics.enable()
    profile.enable()
    params = causal_lm_params(causal_lm.init_causal_lm(7, 97, 32, 4, 2, 64),
                              "cpu")
    eng = LMEngine(params, 4, 64, n_slots=2, chunk=4, device="cpu")
    rid = eng.submit(np.arange(1, 6, dtype=np.int32), max_new=6)
    assert len(eng.run()[rid]) == 6
    recs = profile.profiler().records("engine")
    assert {r["label"] for r in recs} >= {"lm.prefill", "lm.decode"}
    with start_exporter(port=0) as exp:
        text = urllib.request.urlopen(exp.url, timeout=5).read().decode()
    for fam in ("mfu_ratio", "roofline_ratio", "achieved_flops"):
        assert f'nnstpu_profile_{fam}{{engine="lm"}}' in text
    mfu = float(next(ln.rsplit(" ", 1)[1] for ln in text.splitlines()
                     if ln.startswith('nnstpu_profile_mfu_ratio{engine="lm"}')))
    assert 0.0 <= mfu <= 1.0


def test_peaks_are_read_at_enable_not_on_a_scrape(prof, monkeypatch):
    """The gauges' callbacks run on the exporter's thread: the card's peaks
    are read once, when profiling is enabled, and never again."""
    p = profile.profiler()
    p._peak_cache = None
    profile.enable()
    assert p._peak_cache == (probes.chip_peak_flops(CPU),
                             probes.chip_peak_hbm_bw(CPU))
    monkeypatch.setattr(torch.cuda, "is_available",
                        lambda: pytest.fail("asked the card on a scrape"))
    p._update_util("lm", 1e9, 1e6, 0.5)
    assert p._mfu_of("lm") > 0 and p._roofline_of("lm") > 0


def test_peak_tables_and_ridge():
    assert probes.chip_peak_flops(CPU) > 0 and probes.chip_peak_hbm_bw(CPU) > 0
    assert probes.ridge_intensity(CPU) == pytest.approx(
        probes.chip_peak_flops(CPU) / probes.chip_peak_hbm_bw(CPU))
    assert probes.PEAK_FLOPS["h100"][torch.bfloat16] == 989e12
    assert probes.PEAK_FLOPS["h100"][torch.float32] == 67e12
    assert probes.PEAK_HBM_BW["h100"] == 3.35e12


# --------------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------------- #

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA events and graph capture)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_sampled_dispatch_is_timed_by_cuda_events(cuda_device, prof):
    from nnstreamer_tpu_torch.filters.base import FilterProps
    from nnstreamer_tpu_torch.filters.torch_cuda import TorchCudaFilter

    f = TorchCudaFilter()
    f.open(FilterProps(model=(lambda prm, x: torch.tanh(x @ prm["w"]),
                              {"w": torch.randn(512, 512,
                                                device=cuda_device)}),
                       device=cuda_device, input_info=TensorsInfo.from_strings(
                           "512:64", "float32")))
    profile.enable(sample_every=1)
    for _ in range(4):
        f.invoke([TensorMemory(torch.randn(64, 512, device=cuda_device))])
    recs = profile.profiler().records("dispatch")
    assert len(recs) == 4
    for r in recs:
        assert 0 < r["device_ns"] <= r["dur_ns"] + r["args"]["wait_ns"]
    assert profile.profiler().samples()[0]["flops"] == 2 * 64 * 512 * 512


@pytest.mark.cuda
def test_capture_succeeds_with_the_profiler_on(cuda_device, prof):
    """The filter's first call of a signature captures a CUDA graph while
    the profiler labels the kernels and times the dispatch: the capture
    holds, replays equal eager, and the kernel is labelled at capture."""
    profile.enable(sample_every=1)
    fn = graphs.CapturedFn(lambda x: tep.class_reduce(x)[0], "reduce")
    x = torch.rand(2916, 90, device=cuda_device)
    first = fn(x)
    second = fn(x)
    with graphs.disabled():
        eager = fn(x)
    assert torch.equal(first, eager) and torch.equal(second, eager)
    caps = [r for r in profile.profiler().records("kernel")
            if r["args"]["capture"]]
    assert len(caps) == 1 and caps[0]["label"] == "cuda.class_reduce"
