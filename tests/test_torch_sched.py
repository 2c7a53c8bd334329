"""The port's multi-tenant device engine (nnstreamer_tpu_torch/sched) against
the JAX package's (nnstreamer_tpu/sched).

Every case of ``tests/test_sched.py`` runs here against the port: weighted
DRR fairness and the hard starvation bound on a fake clock, coalesced
outputs bit-identical to direct invokes (the ``tanh(x @ w)`` model, plain,
bucketed and donating), deadline shedding, tenant lifecycle, the
zero-overhead-when-off contract, ``install``/``uninstall`` and eight
concurrent pipelines equal to their serial runs. The JAX file's two cases
that read obs counters (the bucket ladder's miss counter and the shed
counter) read the engine's and tenants' ``stats`` instead: the counters
wait for the port of obs.

Against the JAX package: 40 seeded scenarios (random weights, priorities,
``starve_ms``, knobs, deadlines on the fake clock, submit/advance/step
interleavings) drive both engines with ``autostart=False``: the same
batches in the same order with the same tenants, the same sheds, stats,
waits and deficits. Eight pipelines through each package's engine: the
``tanh(x @ w)`` model bit-equal to each package's own serial run and within
the float32 rounding bound of the other package's; MobileNet-v2 (width
0.25, size 32, the JAX bundle's params converted) labels equal and logits
within rtol 1e-4 / atol 1e-4 of the largest (the classification slice's
bound). Two fused SSD tenants fall back to serial in both packages, the
same number of times, and the port runs no model at the coalesced width.
The LM engine enrolled beside a pipeline gives the JAX enrolled engine's
greedy tokens. ``--sched``/``--sched-tenants`` parse and fail as the JAX
CLI does.

Threaded cases wait with deadlines (``run(timeout=)``, ``wait_eos``,
``result(timeout)``).
"""

import dataclasses
import sys
import time
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import nnstreamer_tpu.core.types as jtypes  # noqa: E402
import nnstreamer_tpu_torch.core.types as ttypes  # noqa: E402
from nnstreamer_tpu import sched as jsched  # noqa: E402
from nnstreamer_tpu.graph import Pipeline as JaxPipeline  # noqa: E402
from nnstreamer_tpu_torch import sched  # noqa: E402
from nnstreamer_tpu_torch.core import graphs  # noqa: E402
from nnstreamer_tpu_torch.core.buffer import TensorMemory  # noqa: E402
from nnstreamer_tpu_torch.filters.base import FilterProps  # noqa: E402
from nnstreamer_tpu_torch.filters.torch_cuda import TorchCudaFilter  # noqa: E402
from nnstreamer_tpu_torch.graph import Pipeline  # noqa: E402
from nnstreamer_tpu_torch.sched import SHED, DeviceEngine  # noqa: E402
from nnstreamer_tpu_torch.sched.engine import _coalesce_key  # noqa: E402

CPU = torch.device("cpu")
TIMEOUT = 120


class FakeClock:
    """Injectable monotonic-seconds source (no sleeping in fairness
    tests)."""

    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class TagFilter:
    """Minimal filter double: distinct instances never coalesce with each
    other (the coalesce key includes id(filt))."""

    def __init__(self, name="f", log=None):
        self.name = name
        self.log = log if log is not None else []

    def invoke(self, inputs):
        self.log.append(self.name)
        return [inputs[0].host() * 2]


def _mem():
    return TensorMemory(np.ones((2, 2), np.float32))


# -- fairness ---------------------------------------------------------------- #

def test_drr_service_tracks_weights():
    clock = FakeClock()
    eng = DeviceEngine("t", autostart=False, clock=clock, max_coalesce=1)
    a = eng.register("a", weight=3.0)
    b = eng.register("b", weight=1.0)
    fa, fb = TagFilter("a"), TagFilter("b")
    for _ in range(40):
        a.submit(fa, [_mem()])
        b.submit(fb, [_mem()])
    for _ in range(40):
        assert eng.step()
    total = a.stats["completed"] + b.stats["completed"]
    assert total == 40
    # weight 3:1 → a gets ~30 of the first 40 services
    assert 26 <= a.stats["completed"] <= 34


def test_equal_weights_alternate():
    clock = FakeClock()
    eng = DeviceEngine("t", autostart=False, clock=clock, max_coalesce=1)
    a = eng.register("a")
    b = eng.register("b")
    order = []
    fa, fb = TagFilter("a", order), TagFilter("b", order)
    for _ in range(6):
        a.submit(fa, [_mem()])
        b.submit(fb, [_mem()])
    for _ in range(12):
        eng.step()
    # round-robin cursor: neither tenant serves 3+ in a row
    for i in range(len(order) - 2):
        assert len(set(order[i:i + 3])) > 1
    assert order.count("a") == order.count("b") == 6


def test_priority_class_served_first():
    clock = FakeClock()
    eng = DeviceEngine("t", autostart=False, clock=clock, max_coalesce=1)
    low = eng.register("low", priority=0)
    high = eng.register("high", priority=1)
    order = []
    fl, fh = TagFilter("low", order), TagFilter("high", order)
    for _ in range(3):
        low.submit(fl, [_mem()])
        high.submit(fh, [_mem()])
    for _ in range(6):
        eng.step()
    # inside the starvation bound, the higher class drains completely
    # before the lower one sees the device
    assert order == ["high"] * 3 + ["low"] * 3


def test_starvation_bound_forces_service():
    clock = FakeClock()
    eng = DeviceEngine("t", autostart=False, clock=clock,
                       max_coalesce=1, starve_ms=100.0)
    low = eng.register("low", priority=0)
    high = eng.register("high", priority=1)
    order = []
    fl, fh = TagFilter("low", order), TagFilter("high", order)
    low.submit(fl, [_mem()])
    for _ in range(8):
        high.submit(fh, [_mem()])
    for _ in range(3):
        eng.step()
    assert order == ["high"] * 3  # low bypassed while inside the bound
    clock.advance(0.15)  # past starve_ms
    eng.step()
    assert order[-1] == "low"
    assert eng.stats["starvation_reliefs"] >= 1
    assert low.stats["completed"] == 1


def test_starved_tenant_wait_never_exceeds_bound_plus_service():
    """With continuous competing load, no tenant's dispatch wait exceeds the
    fairness bound by more than one service round."""
    clock = FakeClock()
    eng = DeviceEngine("t", autostart=False, clock=clock,
                       max_coalesce=1, starve_ms=50.0)
    heavy = eng.register("heavy", weight=100.0)
    meek = eng.register("meek", weight=0.01)
    fh, fm = TagFilter("heavy"), TagFilter("meek")
    for _ in range(200):
        heavy.submit(fh, [_mem()])
    meek.submit(fm, [_mem()])
    while meek.stats["completed"] == 0:
        eng.step()
        clock.advance(0.01)  # 10ms per service round
    # bound: starve_ms plus one relief round-robin lap (|tenants| = 2)
    assert meek.waits[-1] <= 0.05 + 2 * 0.01 + 1e-6


# -- coalescing --------------------------------------------------------------- #

class CoalesceFilter:
    """Counts invocation modes; invoke_coalesced mirrors TorchCudaFilter's
    contract (per-group output lists, order-aligned)."""

    def __init__(self):
        self.serial = 0
        self.coalesced = 0

    def invoke(self, inputs):
        self.serial += 1
        return [inputs[0].host() + 1]

    def invoke_coalesced(self, groups):
        self.coalesced += 1
        return [[g[0].host() + 1] for g in groups]


def test_same_key_heads_coalesce_across_tenants():
    clock = FakeClock()
    eng = DeviceEngine("t", autostart=False, clock=clock, max_coalesce=8)
    filt = CoalesceFilter()
    futs = [eng.register(f"t{i}").submit(filt, [_mem()]) for i in range(4)]
    assert eng.step()
    assert filt.coalesced == 1 and filt.serial == 0
    for f in futs:
        np.testing.assert_array_equal(
            np.asarray(f.result(1.0)[0]), np.full((2, 2), 2, np.float32))
    assert eng.coalesce_stats()["max"] == 4


def test_coalesce_failure_falls_back_to_serial():
    class Broken(CoalesceFilter):
        def invoke_coalesced(self, groups):
            raise RuntimeError("not coalescible after all")

    clock = FakeClock()
    eng = DeviceEngine("t", autostart=False, clock=clock)
    filt = Broken()
    futs = [eng.register(f"t{i}").submit(filt, [_mem()]) for i in range(3)]
    eng.step()
    assert eng.stats["coalesce_fallbacks"] == 1
    assert filt.serial == 3
    for f in futs:
        assert f.result(1.0)[0].shape == (2, 2)


def _tanh_filter(w, custom=""):
    wt = torch.from_numpy(w)

    def model(x):
        return torch.tanh(x @ wt)

    f = TorchCudaFilter()
    f.open(FilterProps(model=model, custom=custom, device=CPU))
    return f


def test_xla_coalesced_bit_identical_to_direct_invoke():
    """invoke_coalesced concatenates groups into ONE dispatch; every
    scattered row must equal the direct per-item invoke exactly."""
    rng = np.random.default_rng(11)
    f = _tanh_filter(rng.normal(size=(16, 8)).astype(np.float32))
    items = [[TensorMemory(rng.normal(size=(4, 16)).astype(np.float32))]
             for _ in range(5)]
    direct = [np.asarray(f.invoke(g)[0].host()) for g in items]
    together = f.invoke_coalesced(items)
    assert len(together) == len(items)
    for got, want in zip(together, direct):
        np.testing.assert_array_equal(np.asarray(got[0].host()), want)


def test_xla_coalesced_bucketed_bit_identical():
    f = TorchCudaFilter()
    f.open(FilterProps(model=lambda x: x * 3.0, custom="bucket=4",
                       device=CPU))
    rng = np.random.default_rng(3)
    groups = [[TensorMemory(rng.normal(size=(2, 2)).astype(np.float32))
               for _ in range(k)] for k in (1, 3, 2)]
    direct = [np.asarray(f.invoke(g)[0].host()) for g in groups]
    together = f.invoke_coalesced(groups)
    for got, want in zip(together, direct):
        np.testing.assert_array_equal(np.asarray(got[0].host()), want)
    # the groups ride the bucket ladder: no coalesced program was made
    assert "_coalesced_fns" not in f._bundle.metadata


def test_xla_coalesced_donating_bit_identical():
    """donate=True releases the concatenated scratch early — outputs must
    be bit-identical to the non-donating coalesce AND to the direct
    per-group invoke (donation changes buffer ownership, never
    arithmetic)."""
    rng = np.random.default_rng(17)
    f = _tanh_filter(rng.normal(size=(16, 8)).astype(np.float32))
    assert f.supports_donate_coalesce

    def groups():
        g = np.random.default_rng(23)
        return [[TensorMemory(g.normal(size=(4, 16)).astype(np.float32))]
                for _ in range(5)]

    direct = [np.asarray(f.invoke(g)[0].host()) for g in groups()]
    plain = f.invoke_coalesced(groups())
    donated = f.invoke_coalesced(groups(), donate=True)
    assert len(plain) == len(donated) == len(direct)
    for got_d, got_p, want in zip(donated, plain, direct):
        np.testing.assert_array_equal(np.asarray(got_p[0].host()), want)
        np.testing.assert_array_equal(np.asarray(got_d[0].host()), want)


def test_engine_donates_through_coalesce_gate():
    """The engine's batched dispatch passes donate=True only to filters that
    advertise supports_donate_coalesce — other coalescible filters keep the
    old call shape (no TypeError → no silent permanent serial fallback)."""
    class Donatable(CoalesceFilter):
        supports_donate_coalesce = True

        def __init__(self):
            super().__init__()
            self.donate_flags = []

        def invoke_coalesced(self, groups, donate=False):
            self.donate_flags.append(donate)
            return super().invoke_coalesced(groups)

    clock = FakeClock()
    eng = DeviceEngine("t", autostart=False, clock=clock)
    filt = Donatable()
    futs = [eng.register(f"t{i}").submit(filt, [_mem()]) for i in range(3)]
    assert eng.step()
    assert filt.donate_flags == [True]
    for f in futs:
        assert f.result(1.0)[0].shape == (2, 2)

    legacy = CoalesceFilter()  # no donate kwarg at all
    futs = [eng.register(f"u{i}").submit(legacy, [_mem()]) for i in range(2)]
    assert eng.step()
    assert legacy.coalesced == 1 and legacy.serial == 0
    for f in futs:
        assert f.result(1.0)[0].shape == (2, 2)


# -- bounded bucket ladder ---------------------------------------------------- #

def test_bucket_ladder_capped_and_chunked():
    """More tensors than bucket_max chunk at the cap and stay correct,
    through the engine as directly (the JAX case reads the scheduler's
    bucket-miss counter; the port reads the engine's and tenant's stats)."""
    f = TorchCudaFilter()
    f.open(FilterProps(model=lambda x: x + 1.0,
                       custom="bucket=2,bucket_max=4", device=CPU))
    assert f._bucket_max == 4
    inputs = [TensorMemory(np.full((3,), i, np.float32))
              for i in range(11)]  # 11 > cap of 4 → 3 chunks
    want = np.stack([np.full((3,), i + 1.0, np.float32) for i in range(11)])
    np.testing.assert_array_equal(np.asarray(f.invoke(inputs)[0].host()), want)
    eng = DeviceEngine("t", autostart=False, clock=FakeClock())
    t = eng.register("a")
    fut = t.submit(f, inputs)
    assert eng.step()
    got = np.asarray(fut.result(1.0)[0].host())
    assert got.shape == (11, 3)
    np.testing.assert_array_equal(got, want)
    assert eng.stats["batches"] == eng.stats["items"] == 1
    assert t.stats == {"submitted": 1, "completed": 1, "shed": 0, "errors": 0}


def test_bucket_default_cap_is_8x():
    f = TorchCudaFilter()
    f.open(FilterProps(model=lambda x: x, custom="bucket=4", device=CPU))
    assert f._bucket_max == 32


# -- deadlines ---------------------------------------------------------------- #

class StubDeadline:
    def __init__(self, expired=False):
        self._expired = expired

    def expired(self):
        return self._expired


def test_expired_at_submit_sheds_immediately():
    clock = FakeClock()
    eng = DeviceEngine("t", autostart=False, clock=clock)
    t = eng.register("a")
    fut = t.submit(TagFilter(), [_mem()], deadline=StubDeadline(True))
    assert fut.result(0.1) is SHED
    assert t.stats["shed"] == 1 and eng.stats["shed"] == 1
    assert t.pending() == 0


def test_expired_in_queue_sheds_before_dispatch():
    clock = FakeClock()
    eng = DeviceEngine("t", autostart=False, clock=clock)
    t = eng.register("a")
    filt = TagFilter()
    dead = StubDeadline(False)
    fut = t.submit(filt, [_mem()], deadline=dead)
    dead._expired = True  # expires while queued
    assert eng.step() is False  # shed, nothing dispatched
    assert fut.result(0.1) is SHED
    assert filt.log == []
    assert t.stats["shed"] == 1


def test_tenant_default_deadline_applies():
    eng = DeviceEngine("t", autostart=False)
    t = eng.register("a", deadline_ms=0.0)  # everything is already late
    fut = t.submit(TagFilter(), [_mem()])
    assert fut.result(0.1) is SHED


def test_shed_rides_resilience_accounting(monkeypatch):
    """Each shed goes through resilience.record_shed (site ``sched``) and
    the engine's and tenant's shed counts (the JAX case reads the obs
    counter, which waits for the port of obs)."""
    from nnstreamer_tpu_torch.resilience import policy

    calls = []
    monkeypatch.setattr(policy, "record_shed",
                        lambda site, msg, **kw: calls.append((site, kw)))
    eng = DeviceEngine("t", autostart=False)
    t = eng.register("a")
    t.submit(TagFilter(), [_mem()], deadline=StubDeadline(True))
    assert calls == [("sched", {"tenant": "a", "label": "f"})]
    assert eng.stats["shed"] == t.stats["shed"] == 1
    assert t.stats["submitted"] == 0 and t.stats["completed"] == 0


def test_filter_sheds_a_buffer_whose_deadline_passed():
    """A buffer carrying an expired ``resilience.Deadline`` reaches an
    enrolled tensor_filter: the engine sheds it and the chain drops it (the
    graph's soft drop) without invoking; a live one is served."""
    from nnstreamer_tpu_torch.core.buffer import Buffer
    from nnstreamer_tpu_torch.graph.element import FlowReturn, make_element
    from nnstreamer_tpu_torch.resilience.policy import (Deadline, deadline_of,
                                                         set_deadline)

    calls = []
    filt = make_element("tensor_filter", device="cpu",
                        model=lambda x: calls.append(1) or x + 1)
    filt.start()
    eng = DeviceEngine("t", autostart=True)
    try:
        tenant = eng.register("a")
        filt.sched_enroll(eng, tenant)
        pushed = []
        filt.push = lambda buf, i=0: pushed.append(buf) or FlowReturn.OK
        late = Buffer.of(np.ones((1, 3), np.float32))
        set_deadline(late, Deadline.after_ms(-1.0))
        assert deadline_of(late).expired()
        assert filt.chain(filt.sink_pad, late) is FlowReturn.OK
        assert pushed == [] and calls == [] and tenant.stats["shed"] == 1
        live = Buffer.of(np.ones((1, 3), np.float32))
        set_deadline(live, Deadline.after_s(60.0))
        filt.chain(filt.sink_pad, live)
        assert len(pushed) == 1 and calls == [1]
        np.testing.assert_array_equal(pushed[0].memories[0].host(),
                                      np.full((1, 3), 2.0, np.float32))
    finally:
        filt.stop()
        eng.stop()
    assert filt._sched_exec is None


# -- tenant lifecycle --------------------------------------------------------- #

def test_duplicate_tenant_name_rejected():
    eng = DeviceEngine("t", autostart=False)
    eng.register("a")
    with pytest.raises(ValueError, match="duplicate"):
        eng.register("a")


def test_deregister_resolves_leftovers_to_shed():
    eng = DeviceEngine("t", autostart=False)
    t = eng.register("a")
    fut = t.submit(TagFilter(), [_mem()])
    eng.deregister(t)
    assert fut.result(0.1) is SHED
    assert eng.tenants() == []


def test_preset_overrides_registration():
    eng = DeviceEngine("t", autostart=False)
    eng.preset("cam", weight=4.0, priority=2)
    t = eng.register("cam", weight=1.0)
    assert t.weight == 4.0 and t.priority == 2
    # suffixed pipeline tenants inherit the base-name preset
    t2 = eng.register("cam#1")
    assert t2.weight == 4.0


def test_opaque_call_runs_under_fair_share():
    eng = DeviceEngine("t", autostart=True)
    try:
        t = eng.register("srv")
        assert t.call(lambda: 41 + 1) == 42
        assert t.stats["completed"] == 1
    finally:
        eng.stop()


def test_inflight_window_is_bounded_and_drained_at_stop():
    """One window entry a batch (a CUDA event on the card; None for CPU
    outputs, which record nothing), at most ``inflight`` outstanding, none
    after stop()."""
    from nnstreamer_tpu_torch.sched.engine import _batch_event

    eng = DeviceEngine("t", autostart=False, clock=FakeClock(), inflight=2,
                       max_coalesce=1)
    t = eng.register("a")
    futs = [t.submit(TagFilter(), [_mem()]) for _ in range(5)]
    for _ in range(5):
        assert eng.step()
    assert all(f.result(0.1)[0].shape == (2, 2) for f in futs)
    assert _batch_event([[TensorMemory(torch.ones(2))]]) is None
    assert list(eng._inflight_q) == [None, None]
    eng.start()
    eng.stop()
    assert len(eng._inflight_q) == 0 and eng.stats["batches"] == 5


def test_dispatch_error_propagates_to_future():
    class Boom:
        def invoke(self, inputs):
            raise RuntimeError("device on fire")

    eng = DeviceEngine("t", autostart=False)
    t = eng.register("a")
    fut = t.submit(Boom(), [_mem()])
    eng.step()
    with pytest.raises(RuntimeError, match="device on fire"):
        fut.result(0.1)
    assert t.stats["errors"] == 1


# -- zero-overhead-when-off contract ------------------------------------------ #

def test_no_scheduler_means_no_hook_and_no_wrapper():
    from nnstreamer_tpu_torch.graph import pipeline as gp

    assert gp.SCHED_PIPELINE_HOOK is None
    assert sched.installed() is None
    p = Pipeline(device="cpu")
    src = p.add_new("videotestsrc", width=32, height=32, num_buffers=2)
    conv = p.add_new("tensor_converter")
    filt = p.add_new("tensor_filter",
                     model=lambda x: x.to(torch.float32).mean(dim=(1, 2, 3)))
    sink = p.add_new("tensor_sink", store=True)
    Pipeline.link(src, conv, filt, sink)
    p.run(timeout=TIMEOUT)
    # the chain never grew a scheduler wrapper: the gate attribute stayed
    # None the whole run and no engine ever existed
    assert all(el._sched_exec is None for el in p.elements.values())
    assert p._sched_engine is None
    assert sink.num_buffers == 2


def test_install_uninstall_default_engine():
    from nnstreamer_tpu_torch.graph import pipeline as gp

    eng = sched.install("dflt", max_coalesce=4)
    try:
        assert sched.installed() is eng
        assert sched.install() is eng  # idempotent
        assert gp.SCHED_PIPELINE_HOOK is not None
        p = Pipeline("hookpipe", device="cpu")
        src = p.add_new("videotestsrc", width=32, height=32, num_buffers=2)
        conv = p.add_new("tensor_converter")
        filt = p.add_new("tensor_filter",
                         model=lambda x: x.to(torch.float32).mean(dim=(1, 2, 3)))
        sink = p.add_new("tensor_sink", store=True)
        Pipeline.link(src, conv, filt, sink)
        p.run(timeout=TIMEOUT)
        assert sink.num_buffers == 2
        assert eng.stats["items"] >= 2  # invokes went through the engine
        assert filt._sched_exec is None  # stop() detached
    finally:
        sched.uninstall()
    assert sched.installed() is None
    assert gp.SCHED_PIPELINE_HOOK is None


def test_failed_start_detaches_from_the_engine():
    """A pipeline whose source fails to start rolls back and leaves no
    tenant behind (JAX pipeline.py:366-385)."""
    eng = DeviceEngine("t", autostart=False)
    p = Pipeline("broken", scheduler=eng, device="cpu")
    src = p.add_new("videotestsrc", width=8, height=8, num_buffers=1)
    sink = p.add_new("tensor_sink")
    Pipeline.link(src, p.add_new("tensor_converter"), sink)

    def refuse():
        raise RuntimeError("no source today")

    src.start = refuse
    with pytest.raises(RuntimeError, match="no source today"):
        p.start()
    assert eng.tenants() == [] and p._sched_engine is None


# -- E2E: 8 concurrent pipelines, one engine ---------------------------------- #

def _build(model, n, scheduler=None, buffers=4):
    p = Pipeline(f"pipe{n}", scheduler=scheduler, device="cpu")
    src = p.add_new("videotestsrc", width=32, height=32,
                    num_buffers=buffers, pattern="random", seed=100 + n)
    conv = p.add_new("tensor_converter")
    filt = p.add_new("tensor_filter", framework="xla-tpu", model=model)
    sink = p.add_new("tensor_sink", store=True)
    Pipeline.link(src, conv, filt, sink)
    return p, sink


def _outputs(sink):
    return [np.asarray(b.memories[0].host()) for b in sink.buffers]


def test_eight_pipelines_multiplex_identical_to_serial():
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.normal(size=(3, 7)).astype(np.float32))

    def model(x):
        return torch.tanh(x.to(torch.float32) @ w)

    serial = []
    for i in range(8):
        p, sink = _build(model, i)
        p.run(timeout=TIMEOUT)
        serial.append(_outputs(sink))

    eng = DeviceEngine("e2e", autostart=True, max_coalesce=8)
    try:
        built = [_build(model, i, scheduler=eng) for i in range(8)]
        for p, _ in built:
            p.start()
        for p, _ in built:
            assert p.wait_eos(TIMEOUT)
        for p, _ in built:
            p.stop()
        assert len(eng.tenants()) == 0  # every stop() detached cleanly
        assert eng.stats["items"] == 8 * 4
        for i, (_, sink) in enumerate(built):
            got = _outputs(sink)
            assert len(got) == len(serial[i]) == 4
            for a, b in zip(got, serial[i]):
                np.testing.assert_array_equal(a, b)
    finally:
        eng.stop()


def test_coalesce_key_shared_across_xla_filter_instances():
    # the zoo memoizes equal specs, so two filters over one spec publish the
    # same coalesce_token — N pipelines share device batches; any
    # result-affecting config difference splits the key again
    spec = ("zoo://mobilenet_v2?width=0.25&size=32&num_classes=16"
            "&dtype=float32")
    mem = TensorMemory(np.zeros((1, 32, 32, 3), np.float32))
    a, b, c = TorchCudaFilter(), TorchCudaFilter(), TorchCudaFilter()
    a.open(FilterProps(model=spec, device=CPU))
    b.open(FilterProps(model=spec, device=CPU))
    c.open(FilterProps(model=spec, custom="precision=bf16", device=CPU))
    try:
        assert _coalesce_key(a, [mem]) == _coalesce_key(b, [mem])
        assert _coalesce_key(c, [mem]) != _coalesce_key(a, [mem])
        other = TensorMemory(np.zeros((2, 32, 32, 3), np.float32))
        assert _coalesce_key(a, [other]) != _coalesce_key(a, [mem])
    finally:
        for f in (a, b, c):
            f.close()


# --------------------------------------------------------------------------- #
# coalesce tokens and the fused chains
# --------------------------------------------------------------------------- #

SPEC = "zoo://mobilenet_v2?width=0.25&size=32&num_classes=16&dtype=float32"


def _opened(custom=""):
    f = TorchCudaFilter()
    f.open(FilterProps(model=SPEC, custom=custom, device=CPU))
    return f


def _fused_filter(p, chain):
    """The filter of ``videotestsrc ! tensor_converter ! <chain> !
    tensor_filter ! tensor_sink`` in ``p``, after fusion and start."""
    src = p.add_new("videotestsrc", width=32, height=32, num_buffers=1)
    els = [p.add_new("tensor_converter")]
    els += [p.add_new("tensor_transform", **props) for props in chain]
    override = {"input": "3:32:32:1", "inputtype": "float32"} if chain else {}
    filt = p.add_new("tensor_filter", framework="xla-tpu", model=SPEC,
                     **override)
    Pipeline.link(src, *els, filt, p.add_new("tensor_sink"))
    return filt


@pytest.mark.parametrize("case", ["same", "bf16", "shape", "sync", "bucket"])
def test_coalesce_token_splits_on_every_result_affecting_knob(case):
    a = _opened()
    other = {"same": "", "bf16": "precision=bf16", "shape": "",
             "sync": "sync=true", "bucket": "bucket=2"}[case]
    b = _opened(other)
    mem = TensorMemory(np.zeros((1, 32, 32, 3), np.float32))
    wide = TensorMemory(np.zeros((2, 32, 32, 3), np.float32))
    try:
        if case == "same":
            assert a.coalesce_token == b.coalesce_token
            assert _coalesce_key(a, [mem]) == _coalesce_key(b, [mem])
        elif case == "shape":
            assert _coalesce_key(a, [mem]) != _coalesce_key(b, [wide])
        elif case == "sync":
            # sync changes when the invoke returns, not its result
            assert a.coalesce_token == b.coalesce_token
        else:
            assert a.coalesce_token != b.coalesce_token
    finally:
        a.close()
        b.close()
    assert a.coalesce_token is None  # a closed filter anchors on identity


ARITH = {"mode": "arithmetic", "option": "typecast:float32,add:-127.5,div:127.5"}
ARITH2 = {"mode": "arithmetic", "option": "typecast:float32,add:-127.0,div:128.0"}


@pytest.mark.parametrize("chains,equal", [
    (([ARITH], [ARITH]), True),
    (([ARITH], [ARITH2]), False),
    (([ARITH], []), False),
], ids=["same_chain", "other_chain", "fused_vs_unfused"])
def test_coalesce_token_follows_the_fused_prologue(chains, equal):
    ps = [Pipeline(f"fz{i}", device="cpu") for i in range(2)]
    filts = [_fused_filter(p, chain) for p, chain in zip(ps, chains)]
    try:
        for p in ps:
            p.start()
        toks = [f.fw.coalesce_token for f in filts]
        assert (toks[0] == toks[1]) is equal
        for tok, chain in zip(toks, chains):
            if chain:
                assert tok[-1] == ("pre", f"{chain[0]['mode']}:{chain[0]['option']}")
        for p in ps:
            assert p.wait_eos(TIMEOUT)
    finally:
        for p in ps:
            p.stop()


def test_coalesce_token_follows_the_fused_epilogue():
    def build(name, option):
        p = Pipeline(name, device="cpu")
        src = p.add_new("videotestsrc", width=32, height=32, num_buffers=1)
        filt = p.add_new("tensor_filter", framework="xla-tpu", model=SPEC)
        tr = p.add_new("tensor_transform", mode="arithmetic", option=option)
        Pipeline.link(src, p.add_new("tensor_converter"), filt, tr,
                      p.add_new("tensor_sink"))
        return p, filt

    built = [build("e0", "mul:2.0"), build("e1", "mul:2.0"),
             build("e2", "mul:3.0")]
    try:
        for p, _ in built:
            p.start()
        toks = [f.fw.coalesce_token for _, f in built]
        assert toks[0][-1] == ("post", "transform[arithmetic:mul:2.0]")
        assert toks[0] == toks[1] and toks[0] != toks[2]
        # an elementwise epilogue keeps the rows: it may coalesce
        assert built[0][1].fw._post_batch_led
        for p, _ in built:
            assert p.wait_eos(TIMEOUT)
    finally:
        for p, _ in built:
            p.stop()


def test_coalesced_program_is_shared_by_one_token():
    """Filters computing one function share one coalesced program (one CUDA
    graph per width on the card), kept on the bundle."""
    a, b = _opened(), _opened()
    rng = np.random.default_rng(0)
    groups = [[TensorMemory(rng.integers(0, 256, (1, 32, 32, 3), dtype=np.uint8))]
              for _ in range(3)]
    try:
        want = [np.asarray(a.invoke(g)[0].host()) for g in groups]
        got_a = a.invoke_coalesced(groups)
        got_b = b.invoke_coalesced(groups)
        programs = a._bundle.metadata["_coalesced_fns"]
        assert programs[a.coalesce_token] is a._coalesced_fn() is b._coalesced_fn()
        for ga, gb, w in zip(got_a, got_b, want):
            # the coalesced convolution may sum in another order than the
            # batch-1 one: labels equal, logits within the slice's bound
            for g in (ga, gb):
                x = np.asarray(g[0].host())
                assert x.argmax(-1).tolist() == w.argmax(-1).tolist()
                np.testing.assert_allclose(x, w, rtol=1e-4,
                                           atol=1e-4 * np.abs(w).max())
    finally:
        a.close()
        b.close()


def test_coalesce_rejects_arity_mismatch_and_non_batch_led_outputs():
    f = TorchCudaFilter()
    f.open(FilterProps(model=lambda x: x.sum(), device=CPU))
    g = [TensorMemory(np.ones((2, 3), np.float32))]
    with pytest.raises(ValueError, match="not batch-led"):
        f.invoke_coalesced([g, g])
    with pytest.raises(ValueError, match="arity mismatch"):
        f.invoke_coalesced([g, g + g])


# --------------------------------------------------------------------------- #
# the port's engine against the JAX engine: seeded scenarios
# --------------------------------------------------------------------------- #

class _Mem:
    """A tensor's metadata as the engines read it (shape, dtype), with a tag
    naming the work item."""

    def __init__(self, tag, rows):
        self.tag = tag
        self.shape = (rows, 4)
        self.dtype = "float32"


class _ClockDeadline:
    """A deadline on the scenario's fake clock."""

    def __init__(self, clock, at):
        self.clock, self.at = clock, at

    def expired(self):
        return self.clock() >= self.at


class _LogFilter:
    """Records every dispatch: serial invokes and coalesced batches, by the
    items' tags. ``kind`` "coal" coalesces, "serial" has no
    invoke_coalesced, "broken" raises in it (the engine falls back)."""

    def __init__(self, name, kind, log):
        self.name, self.log = name, log
        self.coalesce_token = ("model", name)
        if kind == "coal":
            self.invoke_coalesced = self._coalesced
        elif kind == "broken":
            self.invoke_coalesced = self._broken

    def invoke(self, inputs):
        self.log.append(("invoke", self.name, inputs[0].tag))
        return [inputs[0].tag]

    def _coalesced(self, groups):
        self.log.append(("coalesced", self.name, [g[0].tag for g in groups]))
        return [[g[0].tag] for g in groups]

    def _broken(self, groups):
        self.log.append(("refused", self.name, [g[0].tag for g in groups]))
        raise ValueError("not batch-led")


def _scenario(seed):
    rng = np.random.default_rng(seed)
    knobs = dict(max_coalesce=int(rng.choice([1, 2, 4, 8])),
                 quantum=float(rng.choice([1.0, 2.0, 3.0])),
                 starve_ms=float(rng.choice([20.0, 50.0, 100.0])),
                 inflight=int(rng.choice([1, 2])))
    tenants = [dict(name=f"t{i}", weight=float(rng.choice([0.25, 1.0, 2.0, 3.0])),
                    priority=int(rng.choice([0, 0, 1])))
               for i in range(int(rng.integers(2, 6)))]
    presets = [(tenants[0]["name"], 2.0, 1)] if rng.random() < 0.3 else []
    kinds = ["coal", "coal", "serial", "broken"]
    events, now, tag = [], 0.0, 0
    for _ in range(70):
        r = rng.random()
        if r < 0.5:
            deadline = None
            d = rng.random()
            if d < 0.05:
                deadline = now  # already expired at submit
            elif d < 0.25:
                deadline = now + float(rng.uniform(0.0, 0.06))
            events.append(("submit", int(rng.integers(len(tenants))),
                           int(rng.integers(len(kinds))),
                           int(rng.choice([1, 2])), deadline, tag))
            tag += 1
        elif r < 0.55:
            events.append(("call", int(rng.integers(len(tenants))), tag))
            tag += 1
        elif r < 0.75:
            dt = float(rng.choice([0.0, 0.005, 0.012, 0.03, 0.11]))
            now += dt
            events.append(("advance", dt))
        else:
            events.append(("step",))
    return knobs, tenants, presets, kinds, events


def _drive(engine_cls, seed):
    """Run one scenario on one package's engine; everything it observed."""
    knobs, tenant_specs, presets, kinds, events = _scenario(seed)
    shed = sys.modules[engine_cls.__module__].SHED  # the package's sentinel
    clock = FakeClock()
    eng = engine_cls("parity", autostart=False, clock=clock, **knobs)
    for name, w, prio in presets:
        eng.preset(name, weight=w, priority=prio)
    tenants = [eng.register(t["name"], weight=t["weight"],
                            priority=t["priority"]) for t in tenant_specs]
    log = []
    filters = [_LogFilter(f"m{k}", kind, log) for k, kind in enumerate(kinds)]
    futures, trace = {}, []

    def step():
        before = len(log)
        ran = eng.step()
        trace.append((ran, log[before:],
                      sorted(t for t, f in futures.items()
                             if f.done() and f.result(0) is shed)))

    for ev in events:
        if ev[0] == "submit":
            _, ti, fi, rows, deadline, tag = ev
            dl = None if deadline is None else _ClockDeadline(clock, deadline)
            futures[tag] = tenants[ti].submit(filters[fi], [_Mem(tag, rows)],
                                              deadline=dl, label=f"l{fi}")
        elif ev[0] == "call":
            _, ti, tag = ev
            futures[tag] = eng._submit(
                tenants[ti], None, None, None,
                lambda tag=tag: log.append(("call", tag)) or tag, None, "call")
        elif ev[0] == "advance":
            clock.advance(ev[1])
        else:
            step()
    for _ in range(400):  # drain what is left
        if eng.pending() == 0:
            break
        step()
        clock.advance(0.004)
    results = {tag: ("SHED" if f.result(0) is shed else f.result(0))
               for tag, f in futures.items()}
    return dict(
        trace=trace, results=results, stats=dict(eng.stats),
        widths=list(eng.widths),
        tenants=[(t.name, t.weight, t.priority, dict(t.stats), list(t.waits),
                  round(t.deficit, 9)) for t in tenants])


@pytest.mark.parametrize("seed", range(40))
def test_dispatch_order_matches_jax(seed):
    want = _drive(jsched.DeviceEngine, seed)
    got = _drive(DeviceEngine, seed)
    assert got["trace"] == want["trace"]
    assert got["results"] == want["results"]
    assert got["stats"] == want["stats"]
    assert got["widths"] == want["widths"]
    assert got["tenants"] == want["tenants"]
    assert sum(got["stats"].values()) > 0


def test_scenarios_cover_every_rule():
    """The 40 seeded scenarios between them coalesce, fall back, shed at
    submit and in the queue, relieve starvation and run opaque calls."""
    seen = {"coalesced": 0, "refused": 0, "shed": 0, "relief": 0, "call": 0}
    for seed in range(40):
        run = _drive(DeviceEngine, seed)
        for _, entries, _ in run["trace"]:
            for e in entries:
                if e[0] in seen:
                    seen[e[0]] += 1
        seen["shed"] += run["stats"]["shed"]
        seen["relief"] += run["stats"]["starvation_reliefs"]
    assert all(v > 0 for v in seen.values()), seen


# --------------------------------------------------------------------------- #
# eight pipelines through each package's engine
# --------------------------------------------------------------------------- #

N_PIPES, N_FRAMES = 8, 4


def _appsrc_caps(types, dims, dtype):
    return types.Caps.tensors(types.TensorsConfig(
        types.TensorsInfo.from_strings(dims, dtype), Fraction(30, 1)))


def _multiplex(pkg, model, frames, dims, dtype, scheduler_cls=None):
    """N_PIPES pipelines ``appsrc ! tensor_filter ! tensor_sink`` of one
    package, through one engine of that package when ``scheduler_cls`` is
    given (started once every pipeline's first frame is queued, so the
    first batch is N_PIPES wide), else each run alone. Returns each
    pipeline's outputs and the engine."""
    pipeline_cls, types = ((JaxPipeline, jtypes) if pkg == "jax"
                           else (Pipeline, ttypes))
    eng = None if scheduler_cls is None else scheduler_cls(
        f"{pkg}-e2e", autostart=False, max_coalesce=N_PIPES)
    built = []
    for i in range(N_PIPES):
        kw = {} if pkg == "jax" else {"device": "cpu"}
        p = pipeline_cls(f"pipe{i}", scheduler=eng, **kw)
        src = p.add_new("appsrc", caps=_appsrc_caps(types, dims, dtype),
                        data=list(frames[i]))
        filt = p.add_new("tensor_filter", framework="xla-tpu", model=model)
        sink = p.add_new("tensor_sink", store=True)
        pipeline_cls.link(src, filt, sink)
        built.append((p, sink))
    try:
        if eng is None:
            for p, _ in built:
                p.run(timeout=TIMEOUT)
        else:
            for p, _ in built:
                p.start()
            t0 = time.monotonic()
            while eng.pending() < N_PIPES:
                assert time.monotonic() - t0 < TIMEOUT, "tenants never queued"
                time.sleep(0.005)
            eng.start()
            for p, _ in built:
                assert p.wait_eos(TIMEOUT)
    finally:
        for p, _ in built:
            p.stop()
        if eng is not None:
            eng.stop()
    return [[np.asarray(b.memories[0].host()) for b in s.buffers]
            for _, s in built], eng


def _check_engine_run(eng):
    assert eng.stats["items"] == N_PIPES * N_FRAMES
    assert eng.coalesce_stats()["max"] == N_PIPES  # the first batch
    assert eng.stats["coalesce_fallbacks"] == 0
    assert eng.tenants() == []


def test_eight_pipelines_tanh_model_against_jax():
    """``tanh(x @ w)`` on uint8 frames: each package's engine run bit-equal
    to its own serial run; the two packages within the float32 rounding
    bound (a K-term dot product rounds within K·2^-24·(|x|·|w|), tanh
    within a few ulp of 1)."""
    rng = np.random.default_rng(5)
    w = rng.normal(size=(3, 7)).astype(np.float32)
    frames = [[rng.integers(0, 256, (1, 8, 8, 3), dtype=np.uint8)
               for _ in range(N_FRAMES)] for _ in range(N_PIPES)]
    wj, wt = jnp.asarray(w), torch.from_numpy(w)

    def jmodel(x):
        return jnp.tanh(jnp.asarray(x, jnp.float32) @ wj)

    def tmodel(x):
        return torch.tanh(x.to(torch.float32) @ wt)

    from nnstreamer_tpu.models.zoo import ModelBundle as JaxBundle
    from nnstreamer_tpu_torch.models.zoo import ModelBundle

    # one bundle shared by the eight filters: its identity is what lets
    # their work coalesce (a bare callable makes a bundle per filter)
    runs = {}
    for pkg, model, cls in (("jax", JaxBundle("tanh", jmodel), jsched.DeviceEngine),
                            ("port", ModelBundle("tanh", tmodel, device=CPU),
                             DeviceEngine)):
        serial, _ = _multiplex(pkg, model, frames, "3:8:8:1", "uint8")
        multi, eng = _multiplex(pkg, model, frames, "3:8:8:1", "uint8", cls)
        _check_engine_run(eng)
        for a, b in zip(multi, serial):
            assert len(a) == len(b) == N_FRAMES
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        runs[pkg] = multi
    for i in range(N_PIPES):
        for x, got, want in zip(frames[i], runs["port"][i], runs["jax"][i]):
            bound = 3 * 2.0**-24 * (x.astype(np.float32) @ np.abs(w)) * 2 \
                + 8 * 2.0**-24
            assert np.all(np.abs(got - want) <= bound)


@pytest.fixture(scope="module")
def mobilenet_models():
    from nnstreamer_tpu.models.zoo import get_model as jax_get_model
    from nnstreamer_tpu_torch.models.convert import from_flax_variables
    from nnstreamer_tpu_torch.models.mobilenet_v2 import make_mobilenet_v2

    # float32 in both packages: the comparison is of the same arithmetic
    jb = jax_get_model("zoo://mobilenet_v2?width=0.25&size=32&dtype=float32")
    variables = jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                       jb.params)
    pb = make_mobilenet_v2(device=CPU, width="0.25", size="32",
                           dtype="float32")
    from_flax_variables(variables, pb.module)
    return dataclasses.replace(jb, metadata={}), pb


def test_eight_pipelines_mobilenet_against_jax(mobilenet_models):
    """zoo://mobilenet_v2?width=0.25&size=32 with the JAX bundle's params
    converted: through each package's engine, labels equal to the other
    package's and to the port's own serial run, logits within rtol 1e-4 /
    atol 1e-4 of the largest (a coalesced convolution sums in another
    order than batch 1)."""
    jb, pb = mobilenet_models
    rng = np.random.default_rng(9)
    frames = [[rng.integers(0, 256, (1, 32, 32, 3), dtype=np.uint8)
               for _ in range(N_FRAMES)] for _ in range(N_PIPES)]
    jax_multi, jeng = _multiplex("jax", jb, frames, "3:32:32:1", "uint8",
                                 jsched.DeviceEngine)
    port_multi, teng = _multiplex("port", pb, frames, "3:32:32:1", "uint8",
                                  DeviceEngine)
    port_serial, _ = _multiplex("port", pb, frames, "3:32:32:1", "uint8")
    for eng in (jeng, teng):
        _check_engine_run(eng)
    for i in range(N_PIPES):
        for got, want, alone in zip(port_multi[i], jax_multi[i], port_serial[i]):
            assert got.argmax(-1).tolist() == want.argmax(-1).tolist() \
                == alone.argmax(-1).tolist()
            for ref in (want, alone):
                np.testing.assert_allclose(got, ref, rtol=1e-4,
                                           atol=1e-4 * np.abs(ref).max())


# --------------------------------------------------------------------------- #
# two fused SSD tenants: serial fallback in both packages
# --------------------------------------------------------------------------- #

SSD_SPEC = "zoo://ssd_mobilenet_v2?size=64&num_classes=4&width=0.35"
SSD_FRAMES = 3


@pytest.fixture(scope="module")
def ssd_files(tmp_path_factory):
    from nnstreamer_tpu_torch.models.ssd_mobilenet import write_box_priors

    d = tmp_path_factory.mktemp("ssd")
    priors, labels = d / "priors.txt", d / "labels.txt"
    write_box_priors(str(priors), size=64)
    labels.write_text("\n".join(f"c{i}" for i in range(4)))
    return str(labels), str(priors)


def _ssd_string(i, labels, priors):
    return (f"videotestsrc pattern=random seed={7 + i} width=64 height=64 "
            f"num-buffers={SSD_FRAMES} ! video/x-raw,format=RGB ! tensor_converter ! "
            f'tensor_filter framework=xla-tpu model="{SSD_SPEC}" ! '
            f"tensor_decoder mode=bounding_box option1=mobilenet-ssd option2={labels} "
            f"option3={priors} option4=64:64 option5=64:64 ! tensor_sink store=true")


def _ssd_tenants(pkg, files, engine=None):
    """Two fused SSD pipelines; with an engine, stepped from this thread
    once both tenants have a frame queued, so every batch is 2 wide."""
    if pkg == "jax":
        from nnstreamer_tpu.graph.parse import parse_pipeline as parse
        ps = [parse(_ssd_string(i, *files), JaxPipeline(f"ssd{i}", scheduler=engine))
              for i in range(2)]
    else:
        from nnstreamer_tpu_torch.graph.parse import parse_pipeline as parse
        ps = [parse(_ssd_string(i, *files),
                    Pipeline(f"ssd{i}", scheduler=engine, device="cpu"))
              for i in range(2)]
    try:
        for p in ps:
            p.start()
        if engine is not None:
            for _ in range(SSD_FRAMES):
                t0 = time.monotonic()
                while engine.pending() < 2:
                    assert time.monotonic() - t0 < TIMEOUT, "tenants never queued"
                    time.sleep(0.002)
                assert engine.step()
        for p in ps:
            assert p.wait_eos(TIMEOUT)
        sinks = [next(e for e in p.elements.values()
                      if e.ELEMENT_NAME == "tensor_sink") for p in ps]
        filters = [next(e for e in p.elements.values()
                        if e.ELEMENT_NAME == "tensor_filter") for p in ps]
        return ([[(b.meta["detections"], b.memories[0].host().tobytes())
                  for b in s.buffers] for s in sinks],
                filters[0].fw._bundle if pkg == "port" else None)
    finally:
        for p in ps:
            p.stop()


def test_fused_ssd_tenants_fall_back_to_serial_like_jax(ssd_files):
    """A fused box decode + NMS reduces one frame into (K, 6) rows, so two
    SSD tenants cannot share a batch: the JAX filter fails at trace time
    and the engine falls back to serial invokes; the port's filter refuses
    before any device work (no program at the coalesced width is made), and
    the engine falls back the same number of times, with boxes byte-equal to
    the pipelines run without an engine."""
    jeng = jsched.DeviceEngine("jssd", autostart=False, max_coalesce=8)
    _ssd_tenants("jax", ssd_files, jeng)
    teng = DeviceEngine("tssd", autostart=False, max_coalesce=8)
    got, bundle = _ssd_tenants("port", ssd_files, teng)
    want, _ = _ssd_tenants("port", ssd_files)
    assert jeng.stats["coalesce_fallbacks"] == teng.stats["coalesce_fallbacks"] \
        == SSD_FRAMES
    assert jeng.stats["items"] == teng.stats["items"] == 2 * SSD_FRAMES
    assert list(teng.widths) == list(jeng.widths) == [2] * SSD_FRAMES
    assert "_coalesced_fns" not in bundle.metadata
    assert got == want and len(got[0]) == SSD_FRAMES


# --------------------------------------------------------------------------- #
# the LM engine enrolled beside a pipeline
# --------------------------------------------------------------------------- #

V, D, H, L, MAXLEN = 128, 64, 4, 2, 128


def _lm_requests():
    rng = np.random.default_rng(3)
    return [(rng.integers(0, V, n).astype(np.int32), g)
            for n, g in ((5, 6), (12, 11), (20, 16), (9, 3), (33, 7))]


def _enrolled_run(pkg, params, engine_cls, lm_cls):
    """The LM engine enrolled on an engine while a pipeline tenant streams
    on it; returns the tokens, the engine's view of the LM tenant, and
    whether the pipeline ran through the engine."""
    eng = engine_cls(f"{pkg}-lm", max_coalesce=4)
    kw = {} if pkg == "jax" else {"device": CPU}
    lm = lm_cls(params, H, MAXLEN, n_slots=3, chunk=4,
                **({"kv_page_size": 0} if pkg == "jax" else kw))
    lm.enroll(eng, weight=2.0)
    pipe_cls = JaxPipeline if pkg == "jax" else Pipeline
    p = pipe_cls("cam", scheduler=eng, **({} if pkg == "jax" else {"device": "cpu"}))
    src = p.add_new("videotestsrc", width=8, height=8, num_buffers=12)
    filt = p.add_new("tensor_filter", framework="xla-tpu",
                     model=(lambda x: x * 2) if pkg == "port"
                     else (lambda x: jnp.asarray(x) * 2))
    pipe_cls.link(src, p.add_new("tensor_converter"), filt,
                  p.add_new("tensor_sink"))
    try:
        p.start()
        rids = [lm.submit(prompt, max_new=g) for prompt, g in _lm_requests()]
        res = lm.run()
        assert p.wait_eos(TIMEOUT)
        lm_tenant = next(t for t in eng.tenants() if t.name == "lm")
        tenant = (lm_tenant.weight, lm_tenant.stats["completed"] > 0)
        via_engine = eng.stats["items"] > lm_tenant.stats["completed"]
        lm.unenroll()
        assert lm._sched_tenant is None
        assert [t.name for t in eng.tenants()] == ["cam"]
        # unenrolled: step_iteration runs direct again
        rid = lm.submit(_lm_requests()[0][0], max_new=4)
        before = eng.stats["items"]
        after = lm.run()
        assert eng.stats["items"] == before
    finally:
        p.stop()
        eng.stop()
    return [res[r] for r in rids] + [after[rid]], tenant, via_engine


def test_enrolled_lm_engine_matches_jax():
    from nnstreamer_tpu.models import causal_lm as jlm
    from nnstreamer_tpu.serving import LMEngine as JaxLM
    from nnstreamer_tpu_torch.models.convert import causal_lm_params
    from nnstreamer_tpu_torch.serving import LMEngine

    jparams = jlm.init_causal_lm(jax.random.PRNGKey(0), V, D, H, L, MAXLEN)
    tparams = causal_lm_params(jax.tree_util.tree_map(np.asarray, jparams), CPU)
    want, jtenant, jvia = _enrolled_run("jax", jparams, jsched.DeviceEngine, JaxLM)
    got, ttenant, tvia = _enrolled_run("port", tparams, DeviceEngine, LMEngine)
    assert got == want
    assert ttenant == jtenant == (2.0, True)
    assert tvia and jvia
    # and the tokens the engine serves alone, never enrolled
    direct = LMEngine(tparams, H, MAXLEN, n_slots=3, chunk=4, device=CPU)
    rids = [direct.submit(p, max_new=g) for p, g in _lm_requests()]
    res = direct.run()
    assert [res[r] for r in rids] == got[:-1]


# --------------------------------------------------------------------------- #
# the CLI
# --------------------------------------------------------------------------- #

CLI_PIPELINE = ("videotestsrc num-buffers=3 width=32 height=32 ! tensor_converter ! "
                'tensor_filter framework=xla-tpu model="zoo://mobilenet_v2?width=0.25'
                '&size=32&num_classes=16&dtype=float32" ! tensor_sink')


@pytest.mark.parametrize("argv", [
    ["--sched", CLI_PIPELINE],
    ["--sched", "4", CLI_PIPELINE],
    ["--sched", "8", "--sched-tenants", "pipeline:4:1,lm:1", CLI_PIPELINE],
    [CLI_PIPELINE, "--sched"],
], ids=["bare", "width", "presets", "trailing"])
def test_cli_sched_runs_and_reports(argv, capsys):
    from nnstreamer_tpu_torch.cli import _normalize_argv, main

    assert main(["--device", "cpu"] + argv) == 0
    err = capsys.readouterr().err
    assert "multiplexing (coalesce<=" in err
    assert "sched: 3 batches / 3 items, median width 1.0, occupancy" in err
    assert sched.installed() is None
    from nnstreamer_tpu.cli import _normalize_argv as jax_normalize

    assert _normalize_argv(argv) == jax_normalize(argv)


@pytest.mark.parametrize("argv", [
    ["--sched", "0"],                          # width must be >= 1
    ["--sched-tenants", "cam:4"],              # presets need --sched
    ["--sched", "--sched-tenants", "cam"],     # missing weight
    ["--sched", "--sched-tenants", "cam:0"],   # weight must be > 0
    ["--sched", "--sched-tenants", "cam:x"],   # weight must be numeric
], ids=["zero-width", "tenants-alone", "no-weight", "zero-weight",
        "bad-weight"])
def test_cli_sched_validation_matches_jax(argv, capsys):
    from nnstreamer_tpu.cli import main as jax_main
    from nnstreamer_tpu_torch.cli import main

    line = ["videotestsrc num-buffers=1 ! tensor_converter ! tensor_sink"]
    messages = []
    for run in (jax_main, main):
        with pytest.raises(SystemExit) as ei:
            run(argv + line)
        assert ei.value.code == 2
        err = capsys.readouterr().err.strip().splitlines()[-1]
        messages.append(err.split("error: ", 1)[1])
    assert messages[0] == messages[1]
    assert sched.installed() is None and jsched.installed() is None


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_coalesced_widths_capture_once_and_replay_eager_bits(cuda_device):
    """On the card a coalesced batch of width N replays one CUDA graph per
    width, shared by the filters of one token (two filters, widths 2 and 3
    twice each: two captures), bit-equal to the same coalesced call run
    eagerly; a bucketed filter's groups capture nothing beyond its ladder."""
    spec = "zoo://mobilenet_v2?width=0.5&size=64"
    a, b = TorchCudaFilter(), TorchCudaFilter()
    for f in (a, b):
        f.open(FilterProps(model=spec, device=cuda_device))
    rng = np.random.default_rng(0)

    def groups(n):
        return [[TensorMemory(rng.integers(0, 256, (1, 64, 64, 3), dtype=np.uint8))]
                for _ in range(n)]

    calls = [(a, groups(2)), (b, groups(3)), (b, groups(2)), (a, groups(3))]
    graphs.reset_stats()
    got = [[m.device().clone() for g in f.invoke_coalesced(gs) for m in g]
           for f, gs in calls]
    torch.cuda.synchronize()
    st = graphs.stats()
    assert st["captures"] == 2 and st["replays"] == 2
    with graphs.disabled():
        want = [[m.device() for g in f.invoke_coalesced(gs) for m in g]
                for f, gs in calls]
    for g, w in zip(got, want):
        assert all(torch.equal(x, y) for x, y in zip(g, w))
    bucketed = TorchCudaFilter()
    bucketed.open(FilterProps(model=spec, custom="bucket=4", device=cuda_device))
    frame = [TensorMemory(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8))]
    bucketed.invoke(frame)  # the ladder's rung of 4
    graphs.reset_stats()
    bucketed.invoke_coalesced([frame, frame, frame])
    assert graphs.stats()["captures"] == 0
    for f in (a, b, bucketed):
        f.close()
