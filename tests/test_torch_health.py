"""The port's obs.health + obs.events against the JAX package's.

Every case of tests/test_health.py that applies, run against
``nnstreamer_tpu_torch.obs`` (the flight-recorder ring, the component
health model and readiness, each watchdog rule driven through
``check_now()``, the end-to-end stalled-element path, the zero-overhead
guarantee, ``/debug/events``), then parity with the JAX package: the
watchdog's verdict sequence (statuses and event types, in order) under the
same stall scenarios, the sched counters and events after seeded scenarios
of tests/test_torch_sched.py, and the LM engine's serving counters and KV
gauges after a seeded paged run, each equal to the JAX package's. Every
thread test waits with a deadline; every socket binds port 0.
"""

import json
import logging
import threading
import time
import urllib.request

import numpy as np
import pytest

from nnstreamer_tpu.obs import events as jax_events
from nnstreamer_tpu.obs import health as jax_health
from nnstreamer_tpu.obs import metrics as jax_metrics
from nnstreamer_tpu_torch.core.types import Caps, TensorsConfig, TensorsInfo
from nnstreamer_tpu_torch.graph import Pipeline
from nnstreamer_tpu_torch.obs import events as obs_events
from nnstreamer_tpu_torch.obs import health as obs_health
from nnstreamer_tpu_torch.obs import metrics as obs_metrics
from nnstreamer_tpu_torch.obs import tracing as obs_tracing
from nnstreamer_tpu_torch.obs.events import EventRing
from nnstreamer_tpu_torch.obs.health import Status

_THRESHOLDS = ("stall_after_s", "queue_dwell_s", "reconnect_storm",
               "reconnect_window_s", "admission_deadline_s",
               "starvation_storm", "starvation_window_s", "interval_s")


def _tensor_caps(dims: str, types: str) -> Caps:
    return Caps.tensors(TensorsConfig(TensorsInfo.from_strings(dims, types),
                                      30))


def _isolated(health_mod, events_mod):
    """Reset a package's health registry and event ring; returns the
    restore callable (thresholds, flags and taps as they were)."""
    reg, ring = health_mod.registry(), events_mod.ring()
    was_h, was_e = reg.is_enabled, ring.is_enabled
    saved = {k: getattr(reg, k) for k in _THRESHOLDS}
    reg.reset()
    ring.reset()

    def restore():
        reg.reset()
        for k, v in saved.items():
            setattr(reg, k, v)
        reg._enabled = was_h
        events_mod.disable()
        ring.reset()
        ring._enabled = was_e

    return restore


@pytest.fixture
def health():
    restore = _isolated(obs_health, obs_events)
    yield obs_health
    restore()


@pytest.fixture
def events():
    restore = _isolated(obs_health, obs_events)
    yield obs_events
    restore()


@pytest.fixture
def both():
    """Both packages' health and events, isolated. Each package's event
    ring chains ``threading.excepthook`` on enable and restores its own
    predecessor on disable; tests enable the two in either order, so the
    hook found here is put back at the end."""
    hook = threading.excepthook
    r1 = _isolated(jax_health, jax_events)
    r2 = _isolated(obs_health, obs_events)
    yield {"jax": (jax_health, jax_events), "torch": (obs_health, obs_events)}
    r1()
    r2()
    threading.excepthook = hook


@pytest.fixture
def tracing_off_after():
    was = obs_tracing.enabled()
    yield obs_tracing
    (obs_tracing.enable if was else obs_tracing.disable)()
    obs_tracing.store().reset()


def _typed(events_mod, etype):
    return [e for e in events_mod.ring().snapshot() if e["type"] == etype]


# --------------------------------------------------------------------------- #
# Event ring
# --------------------------------------------------------------------------- #

def test_ring_disabled_records_nothing():
    r = EventRing(enabled=False)
    r.record("pipeline.state", "nope")
    assert len(r) == 0 and r.snapshot() == []


def test_ring_records_fields():
    r = EventRing(enabled=True)
    r.record("pipeline.state", "PLAYING", pipeline="p0")
    r.record("pipeline.error", "boom", severity="error")
    evs = r.snapshot()
    assert [e["seq"] for e in evs] == [0, 1]
    assert evs[0]["type"] == "pipeline.state"
    assert evs[0]["message"] == "PLAYING"
    assert evs[0]["severity"] == "info"
    assert evs[0]["attrs"] == {"pipeline": "p0"}
    assert evs[0]["trace_id"] is None
    assert evs[1]["severity"] == "error"
    assert evs[1]["ts"] == pytest.approx(time.time(), abs=30)


def test_ring_fields_equal_jax():
    """The same records give dicts of the same keys and values (times
    aside) in both packages."""
    mine, ref = EventRing(enabled=True), jax_events.EventRing(enabled=True)
    for r in (mine, ref):
        r.record("pipeline.state", "PLAYING", pipeline="p0")
        r.record("serving.admission_reject", "lm: empty prompt",
                 severity="warning", engine="lm", reason="empty prompt")
    strip = lambda evs: [{k: v for k, v in e.items()  # noqa: E731
                          if k not in ("ts", "mono_ns")} for e in evs]
    assert strip(mine.snapshot()) == strip(ref.snapshot())


def test_ring_is_bounded_and_counts_drops():
    r = EventRing(capacity=4, enabled=True)
    for i in range(7):
        r.record("pipeline.state", f"m{i}")
    assert len(r) == 4 and r.dropped == 3
    assert [e["message"] for e in r.snapshot()] == ["m3", "m4", "m5", "m6"]
    assert [e["message"] for e in r.snapshot(limit=2)] == ["m5", "m6"]


def test_trace_correlation(events, tracing_off_after):
    events.enable()
    obs_tracing.enable()
    with obs_tracing.start_span("pipeline.element") as span:
        events.record("pipeline.error", "inside a traced chain")
    ev = events.ring().snapshot()[-1]
    assert ev["trace_id"] == span.context.trace_id
    assert ev["span_id"] == span.context.span_id
    events.record("pipeline.stall", "verdict", trace_id="feedbeef")
    assert events.ring().snapshot()[-1]["trace_id"] == "feedbeef"


def test_log_bridge_taps_the_port_logger(events):
    from nnstreamer_tpu_torch.core.log import logger

    events.enable()
    logger("healthtest").warning("something smells")
    logger("healthtest").debug("too quiet to bridge")
    logging.getLogger("nns_tpu.healthtest").warning("the JAX tree's")
    evs = _typed(events, "core.log")
    assert len(evs) == 1
    assert evs[0]["severity"] == "warning"
    assert "something smells" in evs[0]["message"]
    events.disable()
    logger("healthtest").warning("after disable")
    assert all("after disable" not in e["message"]
               for e in events.ring().snapshot())


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_pipeline_thread_crash_dumps_ring(events, capsys):
    events.enable()

    def die():
        raise RuntimeError("synthetic crash")

    t = threading.Thread(target=die, name="src:crash-test")
    t.start()
    t.join(10)
    evs = _typed(events, "pipeline.crash")
    assert len(evs) == 1
    assert "RuntimeError" in evs[0]["message"]
    assert evs[0]["attrs"]["thread"] == "src:crash-test"
    assert "flight recorder" in capsys.readouterr().err


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_non_pipeline_thread_crash_ignored(events):
    events.enable()

    def die():
        raise RuntimeError("not ours")

    t = threading.Thread(target=die, name="user-thread")
    t.start()
    t.join(10)
    assert not _typed(events, "pipeline.crash")


def test_dump_jsonl_and_text(events, tmp_path, capsys):
    events.enable()
    events.record("pipeline.state", "PLAYING", pipeline="p0")
    path = tmp_path / "events.jsonl"
    events.dump_jsonl(str(path))
    lines = path.read_text().strip().splitlines()
    assert json.loads(lines[-1])["type"] == "pipeline.state"
    events.dump()
    assert "pipeline.state" in capsys.readouterr().err


# --------------------------------------------------------------------------- #
# Health model
# --------------------------------------------------------------------------- #

def test_disabled_returns_shared_noop(health):
    health.registry()._enabled = False
    c1, c2 = health.component("a"), health.component("b")
    assert c1 is c2 is obs_health.NOOP_COMPONENT
    c1.beat()
    c1.set_status(Status.FAILED, "ignored")
    c1.count("x")
    assert health.snapshot() == {"status": "ok", "ok": True,
                                 "components": []}
    assert health.readiness() == (True, {})


def test_aggregate_is_worst_component(health):
    health.enable()
    health.component("a").set_status(Status.OK)
    health.component("b").set_status(Status.DEGRADED, "meh")
    assert health.registry().aggregate() is Status.DEGRADED
    snap = health.snapshot()
    assert snap["status"] == "degraded" and snap["ok"] is True
    health.component("c").set_status(Status.FAILED, "dead")
    snap = health.snapshot()
    assert snap["status"] == "failing" and snap["ok"] is False
    assert {c["name"]: c for c in snap["components"]}["c"]["detail"] == "dead"


def test_component_get_or_create_and_beat(health):
    health.enable()
    c = health.component("x", kind="element")
    assert health.component("x") is c
    assert c.last_beat_ns is None
    c.beat()
    assert c.last_beat_ns is not None
    assert c.snapshot()["last_beat_age_s"] < 5.0


def test_readiness_semantics(health):
    health.enable()
    assert health.readiness() == (False, {})
    health.add_readiness("a", lambda: True)
    health.add_readiness("b", lambda: False)
    assert health.readiness() == (False, {"a": True, "b": False})
    health.add_readiness("b", lambda: True)
    assert health.readiness()[0] is True
    health.add_readiness("c", lambda: None)
    ready, conds = health.readiness()
    assert "c" not in conds and ready is True
    assert "c" not in health.registry()._conditions


def test_probe_retires_component(health):
    health.enable(interval_s=60.0)
    health.component("gone", kind="element", probe=lambda: None)
    health.component("err", kind="element",
                     probe=lambda: (_ for _ in ()).throw(RuntimeError))
    health.check_now()
    names = [c["name"] for c in health.snapshot()["components"]]
    assert "gone" not in names and "err" in names


def test_watchdog_thread_starts_lazily(health):
    health.enable(interval_s=60.0)
    assert "obs-health-watchdog" not in [t.name for t in threading.enumerate()]
    health.component("first")
    assert "obs-health-watchdog" in [t.name for t in threading.enumerate()]


def test_unported_kinds_are_tracked_not_judged(health, events):
    """slo and quality components (their layers wait for ROADMAP §A7) keep
    the status their owner sets; the watchdog adds no verdict."""
    events.enable()
    health.enable(interval_s=60.0)
    c = health.component("slo:cam", kind="slo",
                         probe=lambda: {"breached": True, "worst_burn": 9.0})
    health.check_now()
    assert c.status is Status.OK and not events.ring().snapshot()


# --------------------------------------------------------------------------- #
# Watchdog rules: the JAX cases on the port, then the verdict sequences of
# both packages under the same scenarios
# --------------------------------------------------------------------------- #

def _scenario_element_stall(h, ev):
    ev.enable()
    h.enable(stall_after_s=0.05, interval_s=60.0)
    c = h.component("element:p:sink0", kind="element",
                    probe=lambda: {"running": True, "eos": False},
                    attrs={"element": "sink0"})
    c.beat()
    c.last_trace_id = "cafe1234"
    time.sleep(0.1)
    h.check_now()
    yield c
    h.check_now()   # still stalled: the verdict is not recorded again
    yield c
    c.beat()        # a fresh beat: the age is back under the threshold
    h.check_now()
    yield c


def _scenario_stopped(h, ev):
    ev.enable()
    h.enable(stall_after_s=0.0, interval_s=60.0)
    c = h.component("element:p:sink0", kind="element",
                    probe=lambda: {"running": False, "eos": False})
    c.beat()
    time.sleep(0.01)
    h.check_now()
    yield c


def _scenario_queue_dwell(h, ev):
    ev.enable()
    h.enable(stall_after_s=1000.0, queue_dwell_s=0.0, interval_s=60.0)
    state = {"depth": 4}
    c = h.component("element:p:q0", kind="element",
                    probe=lambda: {"running": True, "eos": False,
                                   "depth": state["depth"], "bound": 4})
    c.beat()
    h.check_now()
    yield c
    time.sleep(0.01)
    h.check_now()
    yield c
    state["depth"] = 0
    h.check_now()
    yield c


def _scenario_reconnect_storm(h, ev):
    ev.enable()
    h.enable(reconnect_storm=3, reconnect_window_s=0.0, interval_s=60.0)
    c = h.component("query.client:qc0", kind="query")
    h.check_now()
    c.count("reconnect", 3)
    h.check_now()
    yield c
    h.check_now()
    yield c


def _scenario_storm_never_masks_failed(h, ev):
    ev.enable()
    h.enable(reconnect_storm=1, reconnect_window_s=0.0, interval_s=60.0)
    c = h.component("query.client:qc0", kind="query")
    h.check_now()
    c.set_status(h.Status.FAILED, "connect failed")
    c.count("reconnect", 5)
    h.check_now()
    yield c


def _scenario_admission(h, ev):
    ev.enable()
    h.enable(admission_deadline_s=0.01, interval_s=60.0)
    state = {"wait": 5.0}
    c = h.component("serving.engine:lm", kind="serving",
                    probe=lambda: {"oldest_wait_s": state["wait"]},
                    attrs={"engine": "lm"})
    h.check_now()
    yield c
    state["wait"] = 0.0
    h.check_now()
    yield c


def _scenario_starvation(h, ev):
    ev.enable()
    h.enable(starvation_storm=2, starvation_window_s=0.0, interval_s=60.0)
    state = {"n": 0}
    c = h.component("sched:e", kind="sched",
                    probe=lambda: {"starvation_reliefs": state["n"]},
                    attrs={"engine": "e"})
    h.check_now()
    state["n"] = 3
    h.check_now()
    yield c
    h.check_now()
    yield c


SCENARIOS = {
    "element_stall": _scenario_element_stall,
    "stopped_pipeline": _scenario_stopped,
    "queue_dwell": _scenario_queue_dwell,
    "reconnect_storm": _scenario_reconnect_storm,
    "storm_never_masks_failed": _scenario_storm_never_masks_failed,
    "admission_stall": _scenario_admission,
    "starvation_storm": _scenario_starvation,
}

#: the verdicts tests/test_health.py asserts, per scenario step
EXPECTED = {
    "element_stall": ["stalled", "stalled", "ok"],
    "stopped_pipeline": ["ok"],
    "queue_dwell": ["ok", "degraded", "ok"],
    "reconnect_storm": ["degraded", "ok"],
    "storm_never_masks_failed": ["failing"],
    "admission_stall": ["stalled", "ok"],
    "starvation_storm": ["degraded", "ok"],
}


def _verdicts(h, ev, scenario):
    steps = [h.status_string(c.status) for c in SCENARIOS[scenario](h, ev)]
    evs = [(e["type"], e["severity"], e["trace_id"],
            {k: v for k, v in e["attrs"].items() if not k.endswith("_s")})
           for e in ev.ring().snapshot()]
    return steps, evs


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_watchdog_verdicts_equal_jax(both, scenario):
    """Statuses after every step and the events recorded, in order (type,
    severity, trace id, attributes but the measured ages), equal the JAX
    watchdog's under the same scenario; statuses as tests/test_health.py
    asserts them."""
    mine = _verdicts(*both["torch"], scenario)
    ref = _verdicts(*both["jax"], scenario)
    assert mine == ref
    assert mine[0] == EXPECTED[scenario]


def test_element_stall_event_fields(health, events):
    steps = list(_scenario_element_stall(health, events))
    assert steps[-1].status is Status.OK
    (ev,) = _typed(events, "pipeline.stall")
    assert ev["attrs"]["element"] == "sink0"
    assert ev["attrs"]["stall_s"] > 0.05
    assert ev["trace_id"] == "cafe1234"
    assert len(_typed(events, "pipeline.recover")) == 1


# --------------------------------------------------------------------------- #
# End to end
# --------------------------------------------------------------------------- #

def test_stalled_element_reported_within_2x_threshold(
        health, events, tracing_off_after):
    """A sink that stops receiving buffers shows up STALLED — with the
    element name, stall age and a correlated trace id — in the health
    snapshot and the event ring within 2x the threshold of the stall."""
    threshold = 0.4
    events.enable()
    obs_tracing.enable()
    health.enable(stall_after_s=threshold)
    release = threading.Event()
    sent = []

    def feed():
        if len(sent) < 2:
            sent.append(1)
            return np.zeros((8,), np.float32)
        release.wait(15)   # wedge: emitted 2 buffers, then nothing
        return None

    p = Pipeline(device="cpu")
    src = p.add_new("appsrc", caps=_tensor_caps("8", "float32"),
                    callback=feed)
    sink = p.add_new("tensor_sink")
    Pipeline.link(src, sink)
    p.start()
    try:
        deadline = time.monotonic() + 2 * threshold + 1.0
        stall = None
        while time.monotonic() < deadline and stall is None:
            evs = [e for e in _typed(events, "pipeline.stall")
                   if e["attrs"].get("element") == sink.name]
            stall = evs[0] if evs else None
            time.sleep(0.02)
        assert stall is not None, "watchdog never flagged the stall"
        assert stall["attrs"]["stall_s"] >= threshold
        assert stall["severity"] == "warning"
        assert stall["trace_id"] is not None
        snap = health.snapshot()
        assert snap["status"] == "stalled" and snap["ok"] is False
        assert any(c["name"].endswith(sink.name) and c["status"] == "stalled"
                   for c in snap["components"])
    finally:
        release.set()
        p.stop()


def test_zero_overhead_when_disabled(health, events):
    """With health, metrics and tracing off: no watchdog thread, nothing
    registered, element chains the plain class methods."""
    health.registry()._enabled = False
    was_m, was_t = obs_metrics.enabled(), obs_tracing.enabled()
    obs_metrics.disable()
    obs_tracing.disable()
    try:
        p = Pipeline(device="cpu")
        src = p.add_new("videotestsrc", width=8, height=8, num_buffers=2)
        conv = p.add_new("tensor_converter")
        sink = p.add_new("tensor_sink")
        Pipeline.link(src, conv, sink)
        p.run(timeout=30)
        assert "_chain_entry" not in conv.__dict__
        assert "_obs_registries" not in conv.__dict__
        assert "obs-health-watchdog" not in \
            [t.name for t in threading.enumerate()]
        assert health.snapshot()["components"] == []
    finally:
        (obs_metrics.enable if was_m else obs_metrics.disable)()
        (obs_tracing.enable if was_t else obs_tracing.disable)()


def test_queue_element_health_probe(health):
    """The queue reports its occupancy and bound to the dwell rule."""
    health.enable(interval_s=60.0)
    p = Pipeline(device="cpu")
    src = p.add_new("videotestsrc", width=8, height=8, num_buffers=2)
    q = p.add_new("queue")
    sink = p.add_new("tensor_sink")
    Pipeline.link(src, q, sink)
    assert q.health_probe() == {"depth": 0, "bound": q.max_size_buffers}
    p.run(timeout=30)
    comps = {c["name"]: c for c in health.snapshot()["components"]}
    assert comps[f"element:{p.name}:{q.name}"]["probe"]["bound"] == \
        q.max_size_buffers


def test_debug_events_endpoint(health, events):
    from nnstreamer_tpu_torch.obs.exporter import start_exporter
    from nnstreamer_tpu_torch.obs.metrics import MetricsRegistry

    events.enable()
    events.record("pipeline.state", "PLAYING", pipeline="p0")
    events.record("pipeline.error", "boom", severity="error")
    with start_exporter(port=0, registry=MetricsRegistry()) as exp:
        base = f"http://127.0.0.1:{exp.port}/debug/events"
        body = json.loads(urllib.request.urlopen(base, timeout=5).read())
        assert body["events_enabled"] is True
        types = [e["type"] for e in body["events"]]
        assert "pipeline.state" in types and "pipeline.error" in types
        body = json.loads(urllib.request.urlopen(base + "?n=1",
                                                 timeout=5).read())
        assert [e["type"] for e in body["events"]] == ["pipeline.error"]


# --------------------------------------------------------------------------- #
# Sched counters and events against the JAX engine's
# --------------------------------------------------------------------------- #

def _series(snap, prefixes):
    """{(family, labels): value, or count for a histogram} of the
    families under ``prefixes``."""
    out = {}
    for name, fam in snap.items():
        if not name.startswith(prefixes):
            continue
        for s in fam["series"]:
            key = (name, tuple(sorted(s["labels"].items())))
            out[key] = s["count"] if fam["type"] == "histogram" \
                else s["value"]
    return out


def _delta(before, after, snap, gauge_labels):
    """What a run moved: counters and histogram counts as differences
    (unchanged series left out: other tests in the process own them), and
    the gauges labelled with one of ``gauge_labels`` as read after it."""
    types = {name: fam["type"] for name, fam in snap.items()}
    out = {}
    for key, v in after.items():
        if types[key[0]] == "gauge":
            if any(lv in gauge_labels for _, lv in key[1]):
                out[key] = v
        elif v != before.get(key, 0):
            out[key] = v - before.get(key, 0)
    return out


def _measured(metrics, run, prefixes, gauge_labels):
    """Run ``run()`` with the package's metrics on; the series it moved."""
    was = metrics.enabled()
    metrics.enable()
    try:
        before = _series(metrics.registry().snapshot(), prefixes)
        out = run()
        snap = metrics.registry().snapshot()
        return out, _delta(before, _series(snap, prefixes), snap,
                           gauge_labels)
    finally:
        (metrics.enable if was else metrics.disable)()


@pytest.mark.parametrize("seed", [0, 3, 5, 11])
def test_sched_counters_and_events_equal_jax(both, seed):
    """The nnstpu_sched_* series a seeded scenario of
    tests/test_torch_sched.py moves (batches, items carried, waits counted,
    bucket and queue-depth series) and the sched.* events it records, in
    order, equal the JAX engine's."""
    import nnstreamer_tpu.sched as jax_sched
    from test_torch_sched import _drive

    from nnstreamer_tpu_torch.sched import DeviceEngine

    got = {}
    for name, cls, metrics in (("jax", jax_sched.DeviceEngine, jax_metrics),
                               ("torch", DeviceEngine, obs_metrics)):
        both[name][1].enable()
        run, series = _measured(metrics, lambda cls=cls: _drive(cls, seed),
                                ("nnstpu_sched_", "nnstpu_resilience_"),
                                {"parity"})
        evs = [(e["type"], e["attrs"].get("tenant"), e["attrs"].get("label"))
               for e in both[name][1].ring().snapshot()
               if e["type"].startswith(("sched.", "resilience."))]
        got[name] = (run["stats"], series, evs)
    assert got["torch"] == got["jax"]
    stats, series, evs = got["torch"]
    assert series[("nnstpu_sched_batches_total",
                   (("engine", "parity"),))] == stats["batches"]
    assert series[("nnstpu_sched_coalesced_total",
                   (("engine", "parity"),))] == stats["items"]
    assert [e for e in evs if e[0] == "sched.tenant_register"]


# --------------------------------------------------------------------------- #
# Serving counters and KV gauges against the JAX engine's
# --------------------------------------------------------------------------- #

def test_serving_counters_and_kv_gauges_equal_jax(both):
    """A seeded paged run (shared prefix, evictions) and four rejected
    submissions on each package's engine: streams, tokens, prefills by
    bucket, first-use buckets, rejects by reason, the KV pool gauges and
    hit/evict counters equal the JAX engine's, and the KV series equal the
    engine's own ``kv_stats``."""
    import jax

    from nnstreamer_tpu.models import causal_lm as jax_lm
    from nnstreamer_tpu.serving import LMEngine as JaxEngine
    from nnstreamer_tpu_torch.models import convert
    from nnstreamer_tpu_torch.serving.lm_engine import LMEngine, live_engines

    jparams = jax_lm.init_causal_lm(jax.random.PRNGKey(3), 61, 32, 4, 2, 64)
    tparams = convert.causal_lm_params(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(11)
    prefix = rng.integers(1, 61, 24).astype(np.int32)
    prompts = [np.concatenate([prefix if i % 2 else prefix[::-1],
                               rng.integers(1, 61, int(n))]).astype(np.int32)
               for i, n in enumerate(rng.integers(2, 12, 8))]
    got, engines = {}, {}
    for name, make in (("jax", lambda: JaxEngine(
            jparams, 4, 64, n_slots=2, chunk=4, kv_page_size=8,
            kv_pages=8)), ("torch", lambda: LMEngine(
                tparams, 4, 64, n_slots=2, chunk=4, kv_page_size=8,
                kv_pages=8, device="cpu"))):
        metrics = jax_metrics if name == "jax" else obs_metrics
        both[name][1].enable()
        budgets = np.random.default_rng(12).integers(3, 9, len(prompts))

        def run(make=make):
            eng = make()
            for bad, new in (([], 2), ([1] * 70, 2), ([1, 2], 0),
                             ([1] * 40, 30)):
                with pytest.raises(ValueError):
                    eng.submit(bad, max_new=new)
            for p, n in zip(prompts, budgets):
                eng.submit(p, max_new=int(n))
            return eng, eng.run()

        (eng, tokens), series = _measured(
            metrics, run, ("nnstpu_serving_", "nnstpu_resilience_"), {"lm"})
        engines[name] = eng
        rejects = [e["attrs"]["reason"]
                   for e in both[name][1].ring().snapshot()
                   if e["type"] == "serving.admission_reject"]
        # latency histograms count as many observations in both; their
        # sums are times
        got[name] = (tokens, series, rejects, eng.kv_stats)
    assert got["torch"] == got["jax"]
    tokens, series, rejects, kv = got["torch"]
    assert len(rejects) == 4
    lbl = (("engine", "lm"),)
    assert series[("nnstpu_serving_kv_prefix_hit_total", lbl)] == \
        kv["hit_tokens"] > 0
    assert series[("nnstpu_serving_kv_evict_total", lbl)] == \
        kv["evictions"] > 0
    assert series[("nnstpu_serving_kv_total_pages", lbl)] == 8
    assert series[("nnstpu_serving_tokens_total", lbl)] == \
        sum(len(t) for t in tokens.values())
    assert engines["torch"] in live_engines()
