"""The port's obs.diag against the JAX package's.

Every case of tests/test_diag.py that needs no fleet layer and no session
migration, run against ``nnstreamer_tpu_torch`` (the zero-overhead hook
contract, the trigger engine on a fake clock, ``SpanStore.add_span``, the
critical-path conservation contract on synthetic trees and a real
coalesced DeviceEngine batch, the bundle store, the watchdog trigger, a
seeded SLO breach bundling itself, the LM engine's retire tap,
nns-diag-torch, the exporter routes); then parity: ``critpath.analyze``
over one span set gives the JAX package's segments, and each package's
bundles read back with the other's CLI. Every socket binds port 0.
"""

import inspect
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from nnstreamer_tpu_torch.core.buffer import TensorMemory
from nnstreamer_tpu_torch.obs import diag
from nnstreamer_tpu_torch.obs import events as obs_events
from nnstreamer_tpu_torch.obs import fleet as obs_fleet
from nnstreamer_tpu_torch.obs import health as obs_health
from nnstreamer_tpu_torch.obs import metrics as obs_metrics
from nnstreamer_tpu_torch.obs import slo as obs_slo
from nnstreamer_tpu_torch.obs import tracing
from nnstreamer_tpu_torch.obs.diag import bundle as diag_bundle
from nnstreamer_tpu_torch.obs.diag import cli as diag_cli
from nnstreamer_tpu_torch.obs.diag import critpath
from nnstreamer_tpu_torch.obs.diag.triggers import CAUSE_KINDS, TriggerEngine
from nnstreamer_tpu_torch.obs.exporter import start_exporter
from nnstreamer_tpu_torch.sched import DeviceEngine


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class TagFilter:
    def __init__(self, name="f"):
        self.name = name

    def invoke(self, inputs):
        return [inputs[0].host() * 2]


def _mem():
    return TensorMemory(np.ones((2, 2), np.float32))


_HEALTH_THRESHOLDS = (
    "stall_after_s", "queue_dwell_s", "reconnect_storm",
    "reconnect_window_s", "admission_deadline_s", "interval_s",
    "starvation_storm", "starvation_window_s")


@pytest.fixture
def diag_off():
    """Diag off and fresh around every test in this file."""
    diag.disable()
    yield diag
    diag.disable()


@pytest.fixture
def tracing_on():
    was = tracing.enabled()
    tracing.store().reset()
    tracing.enable()
    yield tracing.store()
    (tracing.enable if was else tracing.disable)()
    tracing.store().sample_every = 1
    tracing.store().reset()


@pytest.fixture
def events():
    ring = obs_events.ring()
    was = ring.is_enabled
    ring.reset()
    obs_events.enable()
    yield obs_events
    obs_events.disable()
    ring.reset()
    ring._enabled = was


@pytest.fixture
def health():
    reg = obs_health.registry()
    was = reg.is_enabled
    saved = {k: getattr(reg, k) for k in _HEALTH_THRESHOLDS}
    reg.reset()
    yield obs_health
    reg.reset()
    for k, v in saved.items():
        setattr(reg, k, v)
    reg._enabled = was


@pytest.fixture
def slo_off():
    obs_slo.disable()
    yield obs_slo
    obs_slo.disable()


@pytest.fixture
def global_metrics():
    was = obs_metrics.enabled()
    yield obs_metrics.registry()
    (obs_metrics.enable if was else obs_metrics.disable)()


def _enable(tmp_path, **kw):
    kw.setdefault("min_interval_s", 0.0)
    kw.setdefault("dedup_window_s", 0.0)
    return diag.enable(str(tmp_path / "bundles"), **kw)


# --------------------------------------------------------------------------- #
# Hook contract: zero overhead when off
# --------------------------------------------------------------------------- #

class TestHookContract:
    def test_hook_defaults_off(self):
        assert diag.DIAG_HOOK is None
        assert diag.enabled() is False
        assert diag.engine() is None
        assert diag.snapshot() is None

    def test_enable_installs_and_disable_clears(self, diag_off, tmp_path):
        eng = _enable(tmp_path)
        assert diag.DIAG_HOOK is eng
        assert diag.enabled() is True
        # idempotent: a second enable returns the installed engine
        assert diag.enable(str(tmp_path / "other")) is eng
        diag.disable()
        assert diag.DIAG_HOOK is None

    def test_hot_paths_pay_exactly_one_none_check(self):
        """The acceptance pin: with diag disabled each hot-path tap is
        ONE additional DIAG_HOOK attribute load + None test — counted
        in the source of the three tap sites so a second load can't
        sneak in."""
        from nnstreamer_tpu_torch.serving.lm_engine import LMEngine

        for fn in (DeviceEngine._submit, DeviceEngine._execute,
                   LMEngine._retire_if_done):
            src = inspect.getsource(fn)
            assert src.count("DIAG_HOOK") == 1, fn.__qualname__

    def test_disabled_run_synthesizes_nothing(self, diag_off, tracing_on):
        """Diag off: the sched run leaves no synthetic spans and no
        work item carries a diag tap."""
        clock = FakeClock()
        eng = DeviceEngine("dz", autostart=False, clock=clock,
                           max_coalesce=4)
        ten = eng.register("a")
        filt = TagFilter()
        with tracing_on.start_span("serving.request"):
            futs = [ten.submit(filt, [_mem()]) for _ in range(3)]
        while eng.pending():
            eng.step()
        for f in futs:
            assert f.result() is not None
        names = {s.name for tid in
                 {sm["trace_id"] for sm in tracing_on.summaries()}
                 for s in tracing_on.spans_of(tid)}
        assert not any(n.startswith("diag.") for n in names)
        assert diag.DIAG_HOOK is None

    def test_env_enable(self, tmp_path):
        import subprocess
        import sys

        bdir = tmp_path / "envbundles"
        out = subprocess.run(
            [sys.executable, "-c",
             "from nnstreamer_tpu_torch.obs import diag; "
             "print(diag.enabled(), diag.engine().bundles.directory)"],
            capture_output=True, text=True,
            env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
                 "NNSTPU_DIAG": str(bdir)})
        assert out.returncode == 0, out.stderr
        assert out.stdout.split() == ["True", str(bdir)]


# --------------------------------------------------------------------------- #
# Trigger engine: fake-clock determinism
# --------------------------------------------------------------------------- #

class TestTriggerEngine:
    def _eng(self, clock, **kw):
        fired = []

        def capture(cause):
            fired.append(cause)
            return f"b{len(fired)}"

        kw.setdefault("min_interval_s", 30.0)
        kw.setdefault("dedup_window_s", 300.0)
        eng = TriggerEngine(capture, clock=clock, **kw)
        return eng, fired

    def test_rate_limit_is_global(self, diag_off):
        clock = FakeClock()
        eng, fired = self._eng(clock)
        assert eng.offer("slo_burn", "t1") == "b1"
        # different cause inside the interval: rate-limited, not deduped
        assert eng.offer("watchdog_degraded", "c1") is None
        assert eng.stats["rate_limited"] == 1
        clock.advance(30.0)
        assert eng.offer("watchdog_degraded", "c1") == "b2"
        assert eng.stats == {"offered": 3, "fired": 2, "rate_limited": 1,
                             "deduped": 0, "capture_declined": 0}
        assert [c["kind"] for c in fired] == ["slo_burn",
                                              "watchdog_degraded"]

    def test_dedup_by_cause_outlives_rate_limit(self, diag_off):
        clock = FakeClock()
        eng, fired = self._eng(clock)
        assert eng.offer("slo_burn", "tenant:rt") == "b1"
        clock.advance(60.0)  # past the rate limit, inside dedup window
        assert eng.offer("slo_burn", "tenant:rt") is None
        assert eng.stats["deduped"] == 1
        assert eng.stats["rate_limited"] == 0
        # a DIFFERENT key of the same kind is a new incident
        assert eng.offer("slo_burn", "tenant:bulk") == "b2"
        clock.advance(300.0)  # past the dedup window: same cause refires
        assert eng.offer("slo_burn", "tenant:rt") == "b3"
        assert len(fired) == 3

    def test_unknown_kind_rejected(self, diag_off):
        eng, fired = self._eng(FakeClock())
        assert eng.offer("coffee_spill", "desk") is None
        assert eng.stats["offered"] == 0 and not fired
        assert "coffee_spill" not in CAUSE_KINDS

    def test_capture_failure_never_raises(self, diag_off):
        def boom(cause):
            raise RuntimeError("disk full")

        eng = TriggerEngine(boom, min_interval_s=0.0,
                            dedup_window_s=0.0, clock=FakeClock())
        assert eng.offer("slo_burn", "t") is None
        assert eng.stats["capture_declined"] == 1
        assert eng.stats["fired"] == 0

    def test_cost_anomaly_z_threshold(self, diag_off):
        clock = FakeClock()
        eng, fired = self._eng(clock, min_interval_s=0.0,
                               dedup_window_s=0.0, z_threshold=4.0,
                               min_samples=16)
        # a stable label: tight distribution around 100µs
        for i in range(20):
            assert eng.observe_cost("dz.mm", 100.0 + (i % 3)) is None
        # 100x spike: way past 4 sigma
        bid = eng.observe_cost("dz.mm", 10000.0)
        assert bid is not None
        cause = fired[-1]
        assert cause["kind"] == "cost_anomaly" and cause["key"] == "dz.mm"
        assert cause["detail"]["z"] >= 4.0
        assert cause["detail"]["samples"] >= 16

    def test_cost_anomaly_needs_min_samples(self, diag_off):
        eng, fired = self._eng(FakeClock(), min_interval_s=0.0,
                               dedup_window_s=0.0, min_samples=16)
        for _ in range(8):
            eng.observe_cost("dz.mm", 100.0)
        # would be a huge z, but the distribution isn't trusted yet
        assert eng.observe_cost("dz.mm", 10000.0) is None
        assert not fired

    def test_cost_anomaly_uses_model_residual(self, diag_off):
        """With a tune/ expectation the residual feeds the
        distribution: measurements tracking a GROWING prediction are
        not anomalous, the same raw jump without the model is."""
        eng, fired = self._eng(FakeClock(), min_interval_s=0.0,
                               dedup_window_s=0.0, min_samples=4)
        for i in range(10):
            expected = 100.0 * (i + 1)
            assert eng.observe_cost("dz.big", expected + 1.0,
                                    expected_us=expected) is None
        assert not fired


# --------------------------------------------------------------------------- #
# SpanStore.add_span (the synthetic-span substrate)
# --------------------------------------------------------------------------- #

class TestAddSpan:
    def test_add_span_records_exact_ints(self, tracing_on):
        with tracing_on.start_span("serving.request") as root:
            pass
        ctx = tracing_on.add_span(
            "diag.sched_wait", root.context.trace_id,
            root.context.span_id, root.start_ns + 5,
            root.start_ns + 105, attrs={"engine": "dz"})
        assert ctx is not None and ctx.trace_id == root.context.trace_id
        spans = tracing_on.spans_of(root.context.trace_id)
        syn = next(s for s in spans if s.name == "diag.sched_wait")
        assert syn.start_ns == root.start_ns + 5
        assert syn.end_ns == root.start_ns + 105
        assert syn.context.parent_id == root.context.span_id
        assert syn.attrs["engine"] == "dz"

    def test_add_span_clamps_inverted_interval(self, tracing_on):
        with tracing_on.start_span("serving.request") as root:
            pass
        tracing_on.add_span("diag.sched_run", root.context.trace_id,
                            root.context.span_id, 1000, 900)
        syn = next(s for s in tracing_on.spans_of(root.context.trace_id)
                   if s.name == "diag.sched_run")
        assert syn.end_ns == syn.start_ns == 1000

    def test_add_span_disabled_store_is_none(self):
        tracing.store().reset()
        assert not tracing.enabled()
        assert tracing.store().add_span("diag.sched_run", "t", None,
                                        0, 1) is None


# --------------------------------------------------------------------------- #
# Critical path: conservation contract
# --------------------------------------------------------------------------- #

class TestCritpath:
    def test_segment_table(self):
        assert critpath.segment_of("serving.admission_wait") \
            == "admission_wait"
        assert critpath.segment_of("diag.sched_wait") == "sched_wait"
        assert critpath.segment_of("diag.sched_run") == "device_compute"
        assert critpath.segment_of("query.send") == "wire"
        assert critpath.segment_of("disagg.xfer") == "kv_transfer"
        assert critpath.segment_of("fleet.migrate") == "migration"
        assert critpath.segment_of("serving.prefill") == "device_compute"
        assert critpath.segment_of(
            "serving.prefill", {"re_prefill": True}) == "re_prefill"
        assert critpath.segment_of("pipeline.element") == "host_other"

    def test_conservation_on_synthetic_tree(self, tracing_on):
        """Overlapping + nested + orphan spans: the sweep still sums to
        the root duration exactly (deepest-covering wins each slice)."""
        with tracing_on.start_span("serving.request") as root:
            pass
        r0 = root.start_ns
        tid, rid = root.context.trace_id, root.context.span_id
        add = tracing_on.add_span
        # child covering [r0+10, r0+40]; grandchild [r0+20, r0+30]
        c = add("serving.admission_wait", tid, rid, r0 + 10, r0 + 40)
        add("diag.sched_run", tid, c.span_id, r0 + 20, r0 + 30)
        # overlapping sibling [r0+35, r0+60]: deeper-at-tie rules apply
        add("query.send", tid, rid, r0 + 35, r0 + 60)
        # orphan (unknown parent) hangs off the root
        add("disagg.xfer", tid, "feedfacedeadbeef", r0 + 70, r0 + 80)
        # span leaking past the root end must be clipped
        add("fleet.migrate", tid, rid, r0 + 90, root.end_ns + 10_000)

        res = critpath.analyze(tracing_on.spans_of(tid))
        assert res is not None
        assert sum(res["segments"].values()) == res["total_ns"]
        assert res["total_ns"] == root.end_ns - root.start_ns
        seg = res["segments"]
        # [35,40] ties admission_wait at depth 1: latest start (the
        # sibling query.send) wins it, so 30 - 10 (grandchild) - 5
        assert seg["admission_wait"] == 15
        assert seg["device_compute"] == 10
        assert seg["wire"] == 25
        assert seg["kv_transfer"] == 10
        assert seg["migration"] == root.end_ns - (r0 + 90)
        assert "exact" in critpath.waterfall(res)

    def test_incomplete_trace_is_none(self, tracing_on):
        span = tracing_on.start_span("serving.request")
        res = critpath.analyze(
            tracing_on.snapshot_spans(span.context.trace_id))
        assert res is None
        span.end()

    def test_conservation_on_coalesced_sched_run(self, diag_off,
                                                 tracing_on, tmp_path):
        """THE acceptance pin: a real coalesced DeviceEngine batch, the
        diag taps writing synthetic sched_wait/sched_run spans, and the
        segment sums equal to the root's measured duration to the
        integer nanosecond."""
        _enable(tmp_path)
        clock = FakeClock()
        eng = DeviceEngine("dcv", autostart=False, clock=clock,
                           max_coalesce=4)
        filt = TagFilter()
        # same-key heads coalesce ACROSS tenants (single-tenant DRR
        # allowance is 1/round), so four tenants ride one device batch
        with tracing_on.start_span("serving.request",
                                   attrs={"tenant": "acme"}) as root:
            futs = [eng.register(f"t{i}").submit(filt, [_mem()],
                                                 label="mm")
                    for i in range(4)]
            while eng.pending():
                eng.step()
            for f in futs:
                assert f.result() is not None
        spans = tracing_on.spans_of(root.context.trace_id)
        names = [s.name for s in spans]
        assert "diag.sched_run" in names
        assert "diag.sched_wait" in names
        runs = [s for s in spans if s.name == "diag.sched_run"]
        # coalesced: the batch tap stamps the width on every item
        assert any(s.attrs.get("width", 0) > 1 for s in runs)

        res = critpath.analyze(spans)
        assert res is not None
        # best-effort identity: first tenant attr in store order (a
        # sched_run span beats the root's attr here)
        assert res["tenant"] in {"acme", "t0", "t1", "t2", "t3"}
        assert sum(res["segments"].values()) == res["total_ns"]
        assert res["total_ns"] == root.end_ns - root.start_ns
        assert res["segments"]["device_compute"] > 0
        assert res["coverage_ratio"] > 0.0
        assert "exact" in critpath.waterfall(res)

    def test_rollup_per_tenant_p99(self, tracing_on):
        for i, tenant in enumerate(["rt", "rt", "bulk"]):
            with tracing_on.start_span(
                    "serving.request", attrs={"tenant": tenant}) as root:
                tracing_on.add_span(
                    "serving.admission_wait", root.context.trace_id,
                    root.context.span_id, root.start_ns,
                    root.start_ns + 100 * (i + 1))
        out = critpath.rollup(tracing_on)
        assert out["traces_analyzed"] == 3
        assert set(out["tenants"]) == {"rt", "bulk"}
        rt = out["tenants"]["rt"]
        assert rt["requests"] == 2
        assert rt["p99_ms"] > 0
        assert rt["p99_trace"]["trace_id"]
        assert abs(sum(rt["segments_share"].values()) - 1.0) < 1e-9


# --------------------------------------------------------------------------- #
# Bundle store
# --------------------------------------------------------------------------- #

class TestBundleStore:
    def test_capture_list_get_roundtrip(self, diag_off, tracing_on,
                                        tmp_path):
        store = diag_bundle.BundleStore(str(tmp_path / "b"))
        with tracing_on.start_span("serving.request",
                                   attrs={"tenant": "acme"}):
            pass
        bid = store.capture({"kind": "slo_burn", "key": "tenant:acme",
                             "detail": {"burn": 2.0}})
        assert bid is not None
        doc = store.get(bid)
        assert doc["v"] == diag_bundle.BUNDLE_VERSION
        assert doc["id"] == bid
        assert doc["cause"]["key"] == "tenant:acme"
        # evidence stanzas present (value may be None/empty, key must be)
        for key in ("events", "profile", "sched", "routing",
                    "fleet_actions", "slo", "health", "build",
                    "traces", "critpath"):
            assert key in doc, key
        assert doc["traces"]["slowest"][0]["spans"]
        assert store.list()[0]["id"] == bid
        assert store.refs()[0]["cause"]["kind"] == "slo_burn"
        # offline loader round-trips the same doc
        path = tmp_path / "b" / f"{bid}.json"
        assert diag_bundle.load_bundle(str(path))["id"] == bid

    def test_eviction_keeps_newest(self, diag_off, tmp_path):
        store = diag_bundle.BundleStore(str(tmp_path / "b"),
                                        max_bundles=3, collectors={})
        ids = [store.capture({"kind": "manual", "key": f"k{i}"})
               for i in range(5)]
        listed = [e["id"] for e in store.list()]
        assert len(listed) == 3
        assert listed == list(reversed(ids[-3:]))
        assert store.stats["evicted"] == 2

    def test_collector_error_degrades_to_stanza(self, diag_off, tmp_path):
        def boom():
            raise RuntimeError("ring on fire")

        store = diag_bundle.BundleStore(
            str(tmp_path / "b"), collectors={"events": boom})
        bid = store.capture({"kind": "manual", "key": ""})
        doc = store.get(bid)
        assert "ring on fire" in doc["events"]["error"]
        assert store.stats["collector_errors"] == 1

    def test_id_sanitization(self, diag_off, tmp_path):
        store = diag_bundle.BundleStore(str(tmp_path / "b"),
                                        collectors={})
        bid = store.capture({"kind": "slo_burn",
                             "key": "tenant:a/b c\\d"})
        assert "/" not in bid and " " not in bid and "\\" not in bid
        assert store.get(bid) is not None
        # traversal-ish ids can't escape the directory
        assert store.get("../../etc/passwd") is None

    def test_load_bundle_rejects_junk(self, tmp_path):
        p = tmp_path / "x.json"
        p.write_text("{\"not\": \"a bundle\"}")
        with pytest.raises(ValueError, match="not a debug bundle"):
            diag_bundle.load_bundle(str(p))
        with pytest.raises(ValueError, match="directory"):
            diag_bundle.load_bundle(str(tmp_path))


# --------------------------------------------------------------------------- #
# Trigger wiring: the cold-path taps fire the capture automatically
# --------------------------------------------------------------------------- #

class _StubBackends:
    def backends(self):
        return []


class _StubRouter:
    backends = _StubBackends()


class TestTriggerWiring:
    def test_watchdog_degraded_captures(self, diag_off, health, events,
                                        tmp_path):
        eng = _enable(tmp_path, dedup_window_s=300.0)
        health.enable(interval_s=3600.0)
        comp = health.component("sched:dz", "sched")
        comp.set_status(obs_health.Status.DEGRADED, "queue stuck")
        bundles = eng.bundles.list()
        assert len(bundles) == 1
        assert bundles[0]["cause"]["kind"] == "watchdog_degraded"
        assert bundles[0]["cause"]["key"] == "sched:dz"
        # repeated same-component escalation inside the window dedups
        comp.set_status(obs_health.Status.OK)
        comp.set_status(obs_health.Status.DEGRADED, "again")
        assert eng.triggers.stats["fired"] == 1

    def test_fleet_action_journal_captures_with_signals(
            self, diag_off, tmp_path):
        from nnstreamer_tpu_torch.fleet.controller import FleetController

        eng = _enable(tmp_path)
        ctl = FleetController(_StubRouter(), policy=None,
                              clock=FakeClock())
        ctl._last_signals = {"occupancy": 0.93, "replicas": 2}
        ctl._journal_add("scale_up", "occupancy above target",
                         endpoint="h:1")
        # the journal entry itself records the deciding evidence
        entry = ctl.actions()[-1]
        assert entry["signals"]["occupancy"] == 0.93
        bundles = eng.bundles.list()
        assert len(bundles) == 1
        cause = bundles[0]["cause"]
        assert cause["kind"] == "fleet_action" and cause["key"] == "scale_up"
        assert cause["detail"]["signals"]["replicas"] == 2
        # holds/skips are bookkeeping, not incidents
        ctl._journal_add("scale_up_skipped", "cooldown")
        assert eng.triggers.stats["fired"] == 1

    def test_push_doc_carries_bundle_refs(self, diag_off, tmp_path):
        eng = _enable(tmp_path)
        bid = eng.on_burn_alert("tenant:acme", {"burn": 2.0})
        doc = obs_fleet.build_push("w-diag", "worker", 1)
        assert doc["diag"]["bundles"][0]["id"] == bid
        assert doc["diag"]["triggers"]["fired"] == 1
        agg = obs_fleet.enable_aggregator(ttl_s=30.0)
        try:
            agg.ingest(doc)
            rolled = agg.diag_rollup()
            assert rolled["w-diag"]["bundles"][0]["id"] == bid
        finally:
            obs_fleet.disable_aggregator()

    def test_push_doc_diag_field_none_when_off(self, diag_off):
        assert obs_fleet.build_push("w-off", "worker", 1)["diag"] is None


# --------------------------------------------------------------------------- #
# E2E: seeded SLO breach -> automatic bundle with the evidence
# --------------------------------------------------------------------------- #

class TestBreachE2E:
    def test_breach_auto_bundles_offending_tenant(
            self, diag_off, tracing_on, events, health, slo_off,
            tmp_path):
        """The acceptance scenario: a deterministic (fake-clock,
        seeded-outcome) SLO breach run. Nobody calls capture — the
        burn alert does. The bundle holds the offending tenant's spans
        and the fleet action that followed, and the critical path it
        freezes is conservation-exact offline. (The bundle's routing
        stanza is the live routers' view, its fleet stanza the fleet
        controller's snapshot: None with no controller enabled.)"""
        from nnstreamer_tpu_torch.fleet.controller import FleetController

        deng = _enable(tmp_path)
        health.enable(interval_s=3600.0)
        fc = FakeClock()
        obs_slo.enable(fast_window_s=10.0, slow_window_s=100.0, clock=fc)
        obs_slo.set_objective("rt", goodput_ratio=0.9)

        # the offending tenant's traffic: a traced coalesced sched run
        clock = FakeClock()
        eng = DeviceEngine("de2e", autostart=False, clock=clock,
                           max_coalesce=4)
        ten = eng.register("rt")
        filt = TagFilter()
        with tracing_on.start_span("serving.request",
                                   attrs={"tenant": "rt"}) as root:
            futs = [ten.submit(filt, [_mem()], label="mm")
                    for _ in range(4)]
            while eng.pending():
                eng.step()
            for f in futs:
                assert f.result() is not None

        # seeded breach: every rt outcome misses, the watchdog notices
        reg = obs_slo.slo_registry()
        for _ in range(10):
            reg.record_outcome("rt", "missed", 0.2)
        assert deng.bundles.list() == []  # nothing manual so far
        health.check_now()

        # the breach fires TWO causes (the burn alert itself, and the
        # watchdog component it degrades) — with dedup/rate-limit off
        # both capture; the burn bundle is the one the pin is about
        bundles = deng.bundles.list()
        assert bundles, "burn alert must auto-capture"
        burn = [b for b in bundles
                if b["cause"]["kind"] == "slo_burn"]
        assert len(burn) == 1
        assert burn[0]["cause"]["key"] == "slo:rt"
        n_breach = len(bundles)
        doc = deng.bundles.get(burn[0]["id"])
        # offending tenant's spans are in the frozen evidence
        slowest = doc["traces"]["slowest"]
        target = next(t for t in slowest
                      if t["trace_id"] == root.context.trace_id)
        names = {s["name"] for s in target["spans"]}
        assert "diag.sched_run" in names
        assert any(s["attrs"].get("tenant") == "rt"
                   for s in target["spans"])
        # burn state rode along
        assert doc["slo"]["tenants"]["rt"]["burn"]["breached"] is True
        # the bundle's critpath rollup blames the right tenant
        assert "rt" in doc["critpath"]["tenants"]

        from nnstreamer_tpu_torch.query import router as qrouter

        assert doc["routing"] == qrouter.routing_view()
        assert doc["fleet_actions"] is None

        # the remediation that follows the breach is captured too
        ctl = FleetController(_StubRouter(), policy=None,
                              clock=FakeClock())
        ctl._last_signals = {"occupancy": 0.99, "breached": ["rt"]}
        ctl._journal_add("scale_up", "rt burn", endpoint="h:2")
        bundles = deng.bundles.list()
        assert len(bundles) == n_breach + 1
        assert bundles[0]["cause"]["kind"] == "fleet_action"
        assert bundles[0]["cause"]["detail"]["signals"]["breached"] \
            == ["rt"]

        # offline: nns-diag reproduces a conservation-exact waterfall
        views = diag_cli._trace_spans(doc)[root.context.trace_id]
        res = critpath.analyze(views)
        assert sum(res["segments"].values()) == res["total_ns"]
        assert res["total_ns"] == root.end_ns - root.start_ns


# --------------------------------------------------------------------------- #
# Serving taps: request observations + re-prefill attribution
# --------------------------------------------------------------------------- #

class TestServingTaps:
    @pytest.fixture(scope="class")
    def params(self):
        import jax

        from nnstreamer_tpu.models import causal_lm
        from nnstreamer_tpu_torch.models import convert

        return convert.causal_lm_params(jax.tree_util.tree_map(
            np.asarray, causal_lm.init_causal_lm(
                jax.random.PRNGKey(7), 97, 32, 4, 2, 64)), "cpu")

    def _mkeng(self, params):
        from nnstreamer_tpu_torch.serving import LMEngine

        return LMEngine(params, 4, 64, n_slots=2, chunk=4,
                        kv_page_size=8, kv_pages=32, device="cpu")

    def test_retire_tap_records_request(self, diag_off, tracing_on,
                                        params, tmp_path):
        deng = _enable(tmp_path)
        eng = self._mkeng(params)
        p = np.arange(12, dtype=np.int32) % 97
        rid = eng.submit(p, 4, session="sess-rt")
        eng.run()
        assert len(eng.results[rid]) == 4
        reqs = deng.recent_requests()
        assert len(reqs) == 1
        assert reqs[0]["rid"] == rid
        assert reqs[0]["tenant"] == "sess-rt"
        assert reqs[0]["trace_id"]
        assert reqs[0]["latency_ms"] >= 0
        # the critpath endpoint view joins requests to the rollup
        view = deng.critpath()
        assert view["requests"][-1]["rid"] == rid

    def test_resume_session_marks_next_prefill(self, diag_off,
                                               tracing_on, params):
        """Migration-absorb recompute: the first prefill after
        resume_session carries re_prefill=True, so its device time
        bills to the re_prefill segment, once."""
        eng = self._mkeng(params)
        p = np.arange(12, dtype=np.int32) % 97
        eng.submit(p, 2, session="sess-m")
        eng.run()
        eng.freeze_session("sess-m")
        eng.resume_session("sess-m")
        rid = eng.submit(p, 2, session="sess-m")
        eng.run()
        assert len(eng.results[rid]) == 2

        def prefills():
            return [s for sm in tracing_on.summaries()
                    for s in tracing_on.spans_of(sm["trace_id"])
                    if s.name == "serving.prefill"]

        marked = [s for s in prefills() if s.attrs.get("re_prefill")]
        assert len(marked) == 1
        assert critpath.segment_of(marked[0].name, marked[0].attrs) \
            == "re_prefill"
        # the marker is consumed: a further request is a plain prefill
        eng.submit(p, 2, session="sess-m")
        eng.run()
        assert len([s for s in prefills()
                    if s.attrs.get("re_prefill")]) == 1



# --------------------------------------------------------------------------- #
# nns-diag CLI
# --------------------------------------------------------------------------- #

class TestCli:
    def _bundle(self, tracing_on, tmp_path):
        with tracing_on.start_span("serving.request",
                                   attrs={"tenant": "acme"}) as root:
            tracing_on.add_span(
                "serving.admission_wait", root.context.trace_id,
                root.context.span_id, root.start_ns, root.start_ns + 500)
        store = diag_bundle.BundleStore(str(tmp_path / "b"))
        bid = store.capture({"kind": "slo_burn", "key": "tenant:acme",
                             "detail": {}})
        return store, bid, root.context.trace_id

    def test_waterfall_is_exact(self, diag_off, tracing_on, tmp_path,
                                capsys):
        store, bid, tid = self._bundle(tracing_on, tmp_path)
        rc = diag_cli.main([str(tmp_path / "b" / f"{bid}.json")])
        out = capsys.readouterr().out
        assert rc == 0
        assert f"bundle {bid}" in out
        assert "slo_burn[tenant:acme]" in out
        assert f"trace {tid}" in out
        assert "(exact)" in out and "DRIFT" not in out

    def test_json_and_trace_filter(self, diag_off, tracing_on, tmp_path,
                                   capsys):
        store, bid, tid = self._bundle(tracing_on, tmp_path)
        path = str(tmp_path / "b" / f"{bid}.json")
        rc = diag_cli.main([path, "--json", "--trace", tid])
        assert rc == 0
        doc = json.loads(capsys.readouterr().out)
        res = doc["critpath"][0]
        assert res["trace_id"] == tid
        assert sum(res["segments"].values()) == res["total_ns"]
        # unknown trace id is a hard error
        assert diag_cli.main([path, "--trace", "feedbeef"]) == 2

    def test_perfetto_lanes(self, diag_off, tracing_on, tmp_path,
                            capsys):
        store, bid, tid = self._bundle(tracing_on, tmp_path)
        pf = tmp_path / "trace.json"
        rc = diag_cli.main([str(tmp_path / "b" / f"{bid}.json"),
                            "--perfetto", str(pf)])
        assert rc == 0
        doc = json.loads(pf.read_text())
        evs = doc["traceEvents"]
        assert any(e["ph"] == "M" and tid in e["args"]["name"]
                   for e in evs)
        xs = [e for e in evs if e["ph"] == "X"]
        assert {e["cat"] for e in xs} >= {"host_other", "admission_wait"}
        assert all(e["ts"] >= 0 and e["dur"] >= 0 for e in xs)

    def test_directory_listing(self, diag_off, tracing_on, tmp_path,
                               capsys):
        store, bid, _tid = self._bundle(tracing_on, tmp_path)
        assert diag_cli.main([str(tmp_path / "b")]) == 0
        assert bid in capsys.readouterr().out
        empty = tmp_path / "empty"
        empty.mkdir()
        assert diag_cli.main([str(empty)]) == 1

    def test_missing_file_is_error(self, tmp_path, capsys):
        assert diag_cli.main([str(tmp_path / "nope.json")]) == 2


# --------------------------------------------------------------------------- #
# Exporter routes + build info
# --------------------------------------------------------------------------- #

class TestExporterRoutes:
    def _get(self, port, path):
        return json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=5).read().decode())

    def test_debug_version_and_build_info_gauge(self, diag_off,
                                                global_metrics):
        import nnstreamer_tpu_torch

        with start_exporter(port=0) as exp:
            doc = self._get(exp.port, "/debug/version")
            text = urllib.request.urlopen(exp.url, timeout=5).read()
        assert doc["version"] == nnstreamer_tpu_torch.__version__
        assert set(doc) >= {"version", "torch", "device_kind", "python"}
        assert b"nnstpu_build_info" in text

    def test_critpath_route_works_without_diag(self, diag_off,
                                               tracing_on,
                                               global_metrics):
        with tracing_on.start_span("serving.request",
                                   attrs={"tenant": "acme"}):
            pass
        with start_exporter(port=0) as exp:
            doc = self._get(exp.port, "/debug/diag/critpath")
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{exp.port}"
                    "/debug/diag/critpath?min_ms=banana", timeout=5)
            assert ei.value.code == 400
        assert doc["diag_enabled"] is False
        assert doc["traces_analyzed"] == 1
        assert "acme" in doc["tenants"]

    def test_bundle_routes(self, diag_off, tracing_on, global_metrics,
                           tmp_path):
        eng = _enable(tmp_path)
        with tracing_on.start_span("serving.request"):
            pass
        bid = eng.on_burn_alert("tenant:acme", {"burn": 3.0})
        with start_exporter(port=0) as exp:
            listing = self._get(exp.port, "/debug/bundles")
            full = self._get(exp.port, f"/debug/bundles/{bid}")
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{exp.port}/debug/bundles/nope",
                    timeout=5)
            assert ei.value.code == 404
        assert listing["diag_enabled"] is True
        assert listing["bundles"][0]["id"] == bid
        assert listing["triggers"]["fired"] == 1
        assert full["id"] == bid and full["cause"]["key"] == "tenant:acme"

    def test_bundle_detail_503_when_off(self, diag_off, global_metrics):
        with start_exporter(port=0) as exp:
            listing = self._get(exp.port, "/debug/bundles")
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{exp.port}/debug/bundles/x",
                    timeout=5)
            assert ei.value.code == 503
        assert listing["diag_enabled"] is False
        assert listing["bundles"] == []

    def test_404_hint_includes_new_routes(self, diag_off, global_metrics):
        with start_exporter(port=0) as exp:
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{exp.port}/nope", timeout=5)
            assert ei.value.code == 404
            hint = ei.value.read().decode()
        for route in ("/debug/version", "/debug/diag/critpath",
                      "/debug/bundles"):
            assert route in hint


# --------------------------------------------------------------------------- #
# Parity with the JAX package
# --------------------------------------------------------------------------- #

def _seeded_tree(store, seed):
    """A seeded span tree in ``store``: a root and 12 children, nested,
    overlapping, orphaned and leaking past the root, their names drawn from
    every segment's table entry and some unknown ones."""
    rng = np.random.default_rng(seed)
    names = ["serving.admission_wait", "diag.sched_wait", "diag.sched_run",
             "serving.prefill", "serving.decode", "query.send",
             "disagg.xfer", "fleet.migrate", "pipeline.element", "other"]
    with store.start_span("serving.request",
                          attrs={"tenant": f"t{seed}"}) as root:
        pass
    tid, r0 = root.context.trace_id, root.start_ns
    span_ids = [root.context.span_id]
    for _ in range(12):
        a = int(rng.integers(-50, 2000))
        b = a + int(rng.integers(0, 800))
        parent = span_ids[int(rng.integers(len(span_ids)))] \
            if rng.random() < 0.85 else "feedfacedeadbeef"
        attrs = {"re_prefill": True} if rng.random() < 0.2 else None
        ctx = store.add_span(names[int(rng.integers(len(names)))], tid,
                             parent, r0 + a, r0 + b, attrs=attrs)
        span_ids.append(ctx.span_id)
    return tid


@pytest.mark.parametrize("seed", range(6))
def test_critpath_analyze_equals_jax(seed, tracing_on):
    """One span set through both packages' critpath sweeps: the same
    segments, total, coverage and contributors."""
    from nnstreamer_tpu.obs.diag import critpath as jax_critpath

    tid = _seeded_tree(tracing_on, seed)
    spans = tracing_on.spans_of(tid)
    got, want = critpath.analyze(spans), jax_critpath.analyze(spans)
    assert got == want
    assert sum(got["segments"].values()) == got["total_ns"]
    assert critpath.waterfall(got) == jax_critpath.waterfall(want)
    assert critpath.rollup(tracing_on) == jax_critpath.rollup(tracing_on)


def test_bundles_read_back_across_packages(diag_off, tracing_on, tmp_path,
                                           capsys):
    """A bundle the port writes reads back with the JAX package's nns-diag
    and one the JAX package writes with nns-diag-torch, the waterfalls
    conservation-exact both ways."""
    from nnstreamer_tpu.obs import tracing as jax_tracing
    from nnstreamer_tpu.obs.diag import bundle as jax_bundle
    from nnstreamer_tpu.obs.diag import cli as jax_cli

    tid = _seeded_tree(tracing_on, 7)
    bid = diag_bundle.BundleStore(str(tmp_path / "t")).capture(
        {"kind": "slo_burn", "key": "tenant:t7"})
    jstore = jax_tracing.store()
    was = jax_tracing.enabled()
    jstore.reset()
    jax_tracing.enable()
    try:
        jtid = _seeded_tree(jstore, 8)
        jbid = jax_bundle.BundleStore(str(tmp_path / "j")).capture(
            {"kind": "slo_burn", "key": "tenant:t8"})
    finally:
        (jax_tracing.enable if was else jax_tracing.disable)()
        jstore.reset()
    outs = {}
    for name, main, path in (
            ("jax reads torch", jax_cli.main,
             tmp_path / "t" / f"{bid}.json"),
            ("torch reads jax", diag_cli.main,
             tmp_path / "j" / f"{jbid}.json"),
            ("torch reads torch", diag_cli.main,
             tmp_path / "t" / f"{bid}.json")):
        assert main([str(path), "--json"]) == 0, name
        outs[name] = json.loads(capsys.readouterr().out)
    assert outs["jax reads torch"] == outs["torch reads torch"]
    for doc, want in ((outs["jax reads torch"], tid),
                      (outs["torch reads jax"], jtid)):
        res = next(r for r in doc["critpath"] if r["trace_id"] == want)
        assert sum(res["segments"].values()) == res["total_ns"]
    assert diag_cli.main([str(tmp_path / "j" / f"{jbid}.json")]) == 0
    assert "(jax " in capsys.readouterr().out
