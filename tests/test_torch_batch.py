"""The torch port's tensor_batch / tensor_unbatch against the JAX package's.

The same seeded frames go through both packages' elements: group sizes,
padding by repeating the last frame, the ``batch_*`` meta contract, the
EOS flush of a partial group, caps renegotiation, fixed and auto budgets
driven by a fake clock, and the batched segmentation pipeline
(``tensor_batch ! tensor_filter ! tensor_unbatch ! tensor_decoder``) whose
canvases must equal the per-frame pipeline's and the JAX package's bit for
bit. Batching is exact: every comparison here is equality.
"""

import dataclasses
import time
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import nnstreamer_tpu.core.types as jt  # noqa: E402
import nnstreamer_tpu_torch.core.types as tt  # noqa: E402
from nnstreamer_tpu.core.buffer import Buffer as JaxBuffer  # noqa: E402
from nnstreamer_tpu.elements.batch import TensorBatch as JaxBatch  # noqa: E402
from nnstreamer_tpu.graph import Pipeline as JaxPipeline  # noqa: E402
from nnstreamer_tpu.graph.element import make_element as jax_make_element  # noqa: E402
from nnstreamer_tpu.graph.events import Event as JaxEvent  # noqa: E402
from nnstreamer_tpu.models.zoo import get_model as jax_get_model  # noqa: E402
from nnstreamer_tpu_torch.core.buffer import Buffer  # noqa: E402
from nnstreamer_tpu_torch.elements.batch import TensorBatch  # noqa: E402
from nnstreamer_tpu_torch.graph import Pipeline  # noqa: E402
from nnstreamer_tpu_torch.graph.element import make_element  # noqa: E402
from nnstreamer_tpu_torch.graph.events import Event  # noqa: E402

PACKAGES = {"jax": (JaxPipeline, jt), "port": (Pipeline, tt)}


def _tensor_caps(types, dims: str, dtype: str = "float32",
                 rate=Fraction(30, 1)):
    return types.Caps.tensors(types.TensorsConfig(
        types.TensorsInfo.from_strings(dims, dtype), rate))


def _frames(n, shape=(1, 4, 4, 3), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


def _run(pkg: str, frames, *middle, framerate=Fraction(30, 1)):
    """appsrc(frames) ! <middle elements> ! tensor_sink in one package."""
    pipeline_cls, types = PACKAGES[pkg]
    p = pipeline_cls(**({"device": "cpu"} if pkg == "port" else {}))
    src = p.add_new("appsrc", caps=_tensor_caps(types, "3:4:4:1"),
                    data=frames, framerate=framerate)
    els = [p.add_new(kind, **props) for kind, props in middle]
    sink = p.add_new("tensor_sink", store=True)
    pipeline_cls.link(src, *els, sink)
    p.run(timeout=60)
    return sink, els


def _host(buf):
    return [np.asarray(m.host()) for m in buf.memories]


# --------------------------------------------------------------------------- #
# grouping, padding and the meta contract
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("n,max_batch", [(12, 4), (10, 4), (1, 8), (5, 1)],
                         ids=["full", "partial_eos", "lone", "max1"])
def test_groups_match_jax(n, max_batch):
    frames = _frames(n)
    batch = ("tensor_batch", dict(max_batch=max_batch, budget_ms=1000.0))
    out = {pkg: _run(pkg, frames, batch)[0] for pkg in PACKAGES}
    want, got = out["jax"].buffers, out["port"].buffers
    assert len(got) == len(want) == -(-n // max_batch)
    for g, w in zip(got, want):
        for key in ("batch_frames", "batch_n", "batch_pts", "batch_offsets",
                    "batch_durations"):
            assert g.meta[key] == w.meta[key], key
        assert (g.pts, g.offset, g.duration) == (w.pts, w.offset, w.duration)
        for a, b in zip(_host(g), _host(w)):
            assert a.shape == (max_batch, 4, 4, 3)
            np.testing.assert_array_equal(a, b)
        assert g.config.info[0].shape == w.config.info[0].shape
    last = got[-1]
    k = last.meta["batch_n"]
    pad = _host(last)[0][k:]  # padding repeats the last valid frame
    np.testing.assert_array_equal(pad, np.repeat(frames[-1], max_batch - k, 0))


def test_batch_filter_unbatch_matches_jax():
    frames = _frames(10, seed=3)
    middle = [("tensor_batch", dict(max_batch=4, budget_ms=1000.0)),
              ("tensor_filter", dict(framework="xla-tpu",
                                     model=lambda x: x * 2.0)),
              ("tensor_unbatch", {})]
    out = {pkg: _run(pkg, frames, *middle) for pkg in PACKAGES}
    (got, gels), (want, _) = out["port"], out["jax"]
    assert got.num_buffers == want.num_buffers == 10
    for i, (g, w) in enumerate(zip(got.buffers, want.buffers)):
        assert (g.pts, g.offset, g.duration) == (w.pts, w.offset, w.duration)
        assert not any(k.startswith("batch_") for k in g.meta)
        np.testing.assert_array_equal(_host(g)[0], _host(w)[0])
        np.testing.assert_array_equal(_host(g)[0], frames[i] * 2.0)
        # unbatch slices the filter's output in place: still torch tensors
        assert g.memories[0].is_device
        assert g.config.info[0].shape == (1, 4, 4, 3)
    assert gels[0].groups_emitted == 3 and gels[0].frames_grouped == 10


def test_unbatch_per_frame_caps_use_the_ports_dtypes():
    unb = make_element("tensor_unbatch")
    sink = make_element("tensor_sink", store=True)
    Pipeline.link(unb, sink)
    unb._event_entry(unb.sink_pad, Event.caps(
        _tensor_caps(tt, "2:4,3:4,1:4", "float32,bfloat16,uint8")))
    mems = [torch.zeros((4, 2)), torch.zeros((4, 3), dtype=torch.bfloat16),
            torch.zeros((4, 1), dtype=torch.uint8)]
    unb._chain_entry(unb.sink_pad, Buffer.of(
        *mems, meta={"batch_frames": 2, "batch_n": 2, "batch_pts": [0, 1]}))
    assert sink.num_buffers == 2
    info = sink.buffers[0].config.info
    assert [str(i.dtype) for i in info] == ["float32", "bfloat16", "uint8"]
    assert [i.shape for i in info] == [(2, 2), (2, 3), (2, 1)]
    assert [b.pts for b in sink.buffers] == [0, 1]


def test_unbatch_passthrough_without_metadata():
    frames = _frames(3)
    sink, _ = _run("port", frames, ("tensor_unbatch", {}))
    assert sink.num_buffers == 3 and sink.sink_pad.caps is not None
    np.testing.assert_array_equal(_host(sink.buffers[2])[0], frames[2])


@pytest.mark.parametrize("props", [dict(max_batch=0), dict(budget_ms=-1.0)])
def test_invalid_properties_rejected(props):
    with pytest.raises(ValueError):
        Pipeline().add_new("tensor_batch", **props)


def test_caps_renegotiation_flushes_pending_group_like_jax():
    """A mid-stream caps change flushes the old-shape partial group under
    the OLD config before the new caps; both packages emit the same."""
    results = {}
    for pkg, mk, buffer_cls, event_cls in (
            ("jax", jax_make_element, JaxBuffer, JaxEvent),
            ("port", make_element, Buffer, Event)):
        pipeline_cls, types = PACKAGES[pkg]
        bat = mk("tensor_batch", max_batch=4, budget_ms=10000.0)
        sink = mk("tensor_sink", store=True)
        pipeline_cls.link(bat, sink)
        sink.start()
        bat.start()
        try:
            bat._event_entry(bat.sink_pad,
                             event_cls.caps(_tensor_caps(types, "3:4:4:1")))
            for i in range(2):
                bat._chain_entry(bat.sink_pad, buffer_cls.of(
                    np.full((1, 4, 4, 3), i, np.float32)))
            bat._event_entry(bat.sink_pad,
                             event_cls.caps(_tensor_caps(types, "3:8:8:1")))
            bat._chain_entry(bat.sink_pad, buffer_cls.of(
                np.full((1, 8, 8, 3), 9, np.float32)))
            bat._event_entry(bat.sink_pad, event_cls.eos())
            deadline = time.monotonic() + 10
            while sink.num_buffers < 2 and time.monotonic() < deadline:
                time.sleep(0.01)
        finally:
            bat.stop()
        results[pkg] = [(b.meta["batch_n"], b.config.info[0].shape,
                         _host(b)[0].tobytes()) for b in sink.buffers]
    assert results["port"] == results["jax"]
    assert [r[:2] for r in results["port"]] == [(2, (4, 4, 4, 3)),
                                                (1, (4, 8, 8, 3))]


# --------------------------------------------------------------------------- #
# budgets under a fake clock
# --------------------------------------------------------------------------- #

class _FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.mark.parametrize("max_batch,budget_ms", [(8, 100.0), (4, 5.0),
                                                 (1, 0.5)])
def test_fixed_budget_matches_jax(max_batch, budget_ms):
    port = TensorBatch(max_batch=max_batch, budget_ms=budget_ms)
    ref = JaxBatch(max_batch=max_batch, budget_ms=budget_ms)
    assert port._budget_s() == ref._budget_s() == budget_ms / 1000.0
    assert port._sched_engine is None  # enrolled on no engine


@pytest.mark.parametrize("gaps", [
    [0.004] * 6,  # steady 4 ms: EMA converges to the gap exactly
    [0.001, 0.009, 0.004, 0.02, 0.002],  # irregular
    [0.004, 2.0, 0.004, 0.004],  # an idle pause (> 1 s) is not a rate
    [0.0001] * 5,  # clamped to the 2 ms floor
    [0.3, 0.4, 0.5],  # clamped to the 500 ms ceiling
], ids=["steady", "irregular", "idle_pause", "floor", "ceiling"])
def test_auto_budget_matches_jax_under_fake_clock(gaps):
    els = {"port": TensorBatch(max_batch=8, budget_ms=0),
           "jax": JaxBatch(max_batch=8, budget_ms=0)}
    bufs = {"port": Buffer, "jax": JaxBuffer}
    for name, el in els.items():
        clock = _FakeClock()
        el._clock = clock
        assert el._budget_s() == 1.3 * 8 * 0.005  # no arrivals yet
        for gap in [0.0] + gaps:
            clock.advance(gap)
            el._enqueue(bufs[name].of(np.ones((1, 4), np.float32)))
    assert els["port"]._ema_interval == els["jax"]._ema_interval
    assert els["port"]._budget_s() == els["jax"]._budget_s()
    assert 0.002 <= els["port"]._budget_s() <= 0.5


# --------------------------------------------------------------------------- #
# the budget under a multi-tenant engine (JAX tests/test_batch.py
# TestTenantAwareBudget): a backed-up DeviceEngine shrinks the window
# --------------------------------------------------------------------------- #

class _FakeEngine:
    def __init__(self, depth=0):
        self.depth = depth

    def pending(self):
        return self.depth


class _BrokenEngine:
    def pending(self):
        raise RuntimeError("engine mid-teardown")


def _both_batches(**props):
    return {"port": TensorBatch(**props), "jax": JaxBatch(**props)}


def test_sched_fixed_budget_unchanged_without_engine():
    for el in _both_batches(max_batch=8, budget_ms=100.0).values():
        assert el._budget_s() == 0.1


def test_sched_engine_depth_shrinks_budget():
    for el in _both_batches(max_batch=8, budget_ms=100.0).values():
        eng = _FakeEngine(depth=8)
        el.sched_enroll(eng, tenant=None)
        # depth == max_batch -> budget halves
        assert abs(el._budget_s() - 0.05) < 1e-9
        eng.depth = 24  # 3x max_batch -> quarter
        assert abs(el._budget_s() - 0.025) < 1e-9
        eng.depth = 0  # idle engine -> full window again
        assert el._budget_s() == 0.1


def test_sched_detach_restores_full_budget():
    for el in _both_batches(max_batch=8, budget_ms=100.0).values():
        el.sched_enroll(_FakeEngine(depth=16), tenant=None)
        assert el._budget_s() < 0.1
        el.sched_detach()
        assert el._budget_s() == 0.1
        assert el._sched_engine is None


def test_sched_engine_error_falls_back_to_full_budget():
    for el in _both_batches(max_batch=8, budget_ms=100.0).values():
        el.sched_enroll(_BrokenEngine(), tenant=None)
        assert el._budget_s() == 0.1


def test_sched_auto_budget_with_fake_clock_and_load():
    """The arrival EMA through the injectable clock: exactly 4 ms gaps give
    a deterministic auto window, then the engine's depth shrinks it, equal
    in both packages."""
    budgets = {}
    bufs = {"port": Buffer, "jax": JaxBuffer}
    for name, el in _both_batches(max_batch=8, budget_ms=0).items():
        clock = _FakeClock()
        el._clock = clock
        for _ in range(6):
            el._enqueue(bufs[name].from_arrays([np.ones((1, 4), np.float32)]))
            clock.advance(0.004)
        assert abs(el._ema_interval - 0.004) < 1e-12
        base = el._budget_s()
        assert abs(base - min(max(1.3 * 8 * 0.004, 0.002), 0.5)) < 1e-9
        el.sched_enroll(_FakeEngine(depth=16), tenant=None)
        budgets[name] = (base, el._budget_s())
        assert abs(budgets[name][1] - base / 3.0) < 1e-9
    assert budgets["port"] == budgets["jax"]


def test_sched_deadline_math_uses_injected_clock():
    for el in _both_batches(max_batch=8, budget_ms=50.0).values():
        clock = _FakeClock()
        el._clock = clock
        deadline = el._clock() + el._budget_s()
        assert deadline == 100.05
        clock.advance(0.049)
        assert deadline - el._clock() > 0
        clock.advance(0.002)
        assert deadline - el._clock() <= 0


def test_sched_enrolled_pipeline_budget_reads_the_engine():
    """A tensor_batch in a pipeline attached to a DeviceEngine is offered
    the engine at start and dropped at stop."""
    from nnstreamer_tpu_torch.sched import DeviceEngine

    eng = DeviceEngine("batch", autostart=False)
    p = Pipeline("batched", scheduler=eng, device="cpu")
    src = p.add_new("appsrc", caps=_tensor_caps(tt, "3:4:4:1"),
                    data=_frames(2), framerate=Fraction(30, 1))
    bat = p.add_new("tensor_batch", max_batch=2, budget_ms=1000.0)
    Pipeline.link(src, bat, p.add_new("tensor_unbatch"),
                  p.add_new("tensor_sink"))
    p.start()
    try:
        assert bat._sched_engine is eng
        assert p.wait_eos(60)
    finally:
        p.stop()
    assert bat._sched_engine is None and eng.tenants() == []


def test_budget_deadline_flushes_a_partial_group_on_the_fake_clock():
    bat = make_element("tensor_batch", max_batch=4, budget_ms=50.0)
    sink = make_element("tensor_sink", store=True)
    Pipeline.link(bat, sink)
    clock = _FakeClock()
    bat._clock = clock
    sink.start()
    bat.start()
    try:
        bat._event_entry(bat.sink_pad, Event.caps(_tensor_caps(tt, "3:4:4:1")))
        for f in _frames(2):
            bat._chain_entry(bat.sink_pad, Buffer.of(f))
        time.sleep(0.2)  # real time passes; the fake clock does not
        assert sink.num_buffers == 0
        clock.advance(0.051)  # past the group's deadline
        deadline = time.monotonic() + 10
        while sink.num_buffers < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert sink.num_buffers == 1
        assert sink.buffers[0].meta["batch_n"] == 2
        assert bat.groups_emitted == 1 and bat.frames_grouped == 2
    finally:
        bat.stop()


# --------------------------------------------------------------------------- #
# the batched segmentation pipeline
# --------------------------------------------------------------------------- #

SEG = 33


def _seg_spec(batch: int) -> str:
    return (f"zoo://deeplab_v3?size={SEG}&width=0.25&num_classes=5"
            f"&dtype=float32&batch={batch}")


def _segment(pkg: str, frames, batch: int, model, async_depth: int = 2):
    pipeline_cls, types = PACKAGES[pkg]
    p = pipeline_cls(**({"device": "cpu"} if pkg == "port" else {}))
    caps = types.Caps("video/x-raw", {"format": "RGB", "width": SEG,
                                      "height": SEG, "framerate": Fraction(30)})
    chain = [p.add_new("appsrc", caps=caps, data=frames),
             p.add_new("tensor_converter")]
    if batch > 1:
        chain.append(p.add_new("tensor_batch", max_batch=batch,
                               budget_ms=1000.0))
    chain.append(p.add_new("tensor_filter", framework="xla-tpu", model=model))
    if batch > 1:
        chain.append(p.add_new("tensor_unbatch"))
    chain.append(p.add_new("tensor_decoder", mode="image_segment",
                           option1="tflite-deeplab", async_depth=async_depth))
    sink = p.add_new("tensor_sink", store=True)
    chain.append(sink)
    pipeline_cls.link(*chain)
    p.run(timeout=300)
    return p, sink


def test_batched_segmentation_matches_per_frame_and_jax():
    from nnstreamer_tpu_torch.models.convert import from_flax_variables
    from nnstreamer_tpu_torch.models.deeplab import make_deeplab_v3

    rng = np.random.default_rng(12)
    frames = [rng.integers(0, 256, (SEG, SEG, 3), dtype=np.uint8)
              for _ in range(6)]
    # both packages' bundles carry one set of JAX variables
    jb = jax_get_model(_seg_spec(3))
    variables = jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                       jb.params)
    jax_bundle = dataclasses.replace(
        jb, params=jax.tree_util.tree_map(jnp.asarray, variables), metadata={})
    port = {}
    for b in (1, 3):
        port[b] = make_deeplab_v3(device=torch.device("cpu"), width="0.25",
                                  size=str(SEG), num_classes="5",
                                  dtype="float32", batch=str(b))
        from_flax_variables(variables, port[b].module)
    # precondition of bit-equal canvases: each pixel's best logit leads by
    # far more than the batched, per-frame and JAX logits differ
    x = np.stack(frames[:3])
    want = np.asarray(jax_bundle.fn()(x))
    with torch.inference_mode():
        grouped = port[3].fn()(torch.from_numpy(x)).numpy()
        single = np.concatenate([port[1].fn()(torch.from_numpy(f[None])).numpy()
                                 for f in frames[:3]])
    top2 = np.sort(want, axis=-1)[..., -2:]
    diff = max(np.abs(grouped - want).max(), np.abs(single - want).max())
    assert (top2[..., 1] - top2[..., 0]).min() > 10 * diff

    bp, batched = _segment("port", frames, 3, port[3])
    _, per_frame = _segment("port", frames, 1, port[1])
    _, ref = _segment("jax", frames, 3, jax_bundle)
    assert bp._epilogue_count == 0  # unbatch between filter and decoder
    assert batched.num_buffers == per_frame.num_buffers == ref.num_buffers == 6
    for b, s, r in zip(batched.buffers, per_frame.buffers, ref.buffers):
        assert b.pts == s.pts == r.pts
        np.testing.assert_array_equal(b.memories[0].host(),
                                      s.memories[0].host())
        np.testing.assert_array_equal(b.memories[0].host(),
                                      r.memories[0].host())


def test_batched_segmentation_at_default_depth_colorizes_each_slice(
        monkeypatch):
    """At the decoder's default async_depth=0 the unbatched device slices
    still go through segment_colorize, one call per frame, and give the
    canvases of the async path."""
    from nnstreamer_tpu_torch.models.convert import from_flax_variables
    from nnstreamer_tpu_torch.models.deeplab import make_deeplab_v3
    from nnstreamer_tpu_torch.ops.kernels import epilogue as tep

    rng = np.random.default_rng(13)
    frames = [rng.integers(0, 256, (SEG, SEG, 3), dtype=np.uint8)
              for _ in range(5)]
    variables = jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                       jax_get_model(_seg_spec(2)).params)
    model = make_deeplab_v3(device=torch.device("cpu"), width="0.25",
                            size=str(SEG), num_classes="5", dtype="float32",
                            batch="2")
    from_flax_variables(variables, model.module)
    calls = []
    colorize = tep.segment_colorize

    def counting(x, palette, pre_argmaxed=False):
        calls.append(tuple(x.shape))
        return colorize(x, palette, pre_argmaxed)

    monkeypatch.setattr(tep, "segment_colorize", counting)
    p, sync = _segment("port", frames, 2, model, async_depth=0)
    assert p._epilogue_count == 0
    assert calls == [(SEG, SEG, 5)] * len(frames)  # x[0] of each slice
    _, pipelined = _segment("port", frames, 2, model, async_depth=2)
    assert len(calls) == 2 * len(frames)
    assert sync.num_buffers == pipelined.num_buffers == len(frames)
    for a, b in zip(sync.buffers, pipelined.buffers):
        assert a.pts == b.pts
        np.testing.assert_array_equal(a.memories[0].host(),
                                      b.memories[0].host())
    assert len(np.unique(sync.buffers[0].memories[0].host().reshape(-1, 4),
                         axis=0)) > 1
