"""The port's obs.slo against the JAX package's.

Every case of tests/test_slo.py, run against ``nnstreamer_tpu_torch``
(the zero-overhead-when-off hook contract,
per-tenant cost-attribution conservation against DeviceEngine totals,
goodput and shed accounting, fake-clock multi-window burn-rate evaluation,
the health-registry breach/recovery loop, the sched starvation-storm
watchdog rule, the /debug/slo and /debug/profile/samples routes with the
fleet rollup, the fleet aggregator's SLO rollup and the push document's
``slo`` field, the Perfetto per-tenant goodput lane, and the --slo spec
parser); then parity
with the JAX package: spec parsing, burn verdicts under the same injected
clock, the SLO ledger after the seeded sched scenarios of
tests/test_torch_sched.py, and a seeded paged LM run with deadlines and
sessions. Every socket binds port 0.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from nnstreamer_tpu_torch.core.buffer import TensorMemory
from nnstreamer_tpu_torch.obs import events as obs_events
from nnstreamer_tpu_torch.obs import fleet as obs_fleet
from nnstreamer_tpu_torch.obs import health as obs_health
from nnstreamer_tpu_torch.obs import metrics as obs_metrics
from nnstreamer_tpu_torch.obs import profile as obs_profile
from nnstreamer_tpu_torch.obs import slo
from nnstreamer_tpu_torch.obs.exporter import start_exporter
from nnstreamer_tpu_torch.obs.fleet import FleetAggregator
from nnstreamer_tpu_torch.obs.health import Status
from nnstreamer_tpu_torch.sched import SHED, DeviceEngine


class FakeClock:
    """Injectable monotonic-seconds source (no sleeping in burn tests)."""

    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class FakeDeadline:
    def __init__(self, expired: bool) -> None:
        self._expired = expired

    def expired(self) -> bool:
        return self._expired


class TagFilter:
    """Minimal filter double (distinct instances never coalesce)."""

    def __init__(self, name="f"):
        self.name = name

    def invoke(self, inputs):
        return [inputs[0].host() * 2]


def _mem(rows=2):
    return TensorMemory(np.ones((rows, 2), np.float32))


_THRESHOLDS = ("stall_after_s", "queue_dwell_s", "reconnect_storm",
               "reconnect_window_s", "admission_deadline_s", "interval_s",
               "starvation_storm", "starvation_window_s")


@pytest.fixture
def slo_off():
    """SLO capture off and fresh around every test in this file."""
    slo.disable()
    yield slo
    slo.disable()


@pytest.fixture
def global_metrics():
    was = obs_metrics.enabled()
    yield obs_metrics.registry()
    (obs_metrics.enable if was else obs_metrics.disable)()


@pytest.fixture
def health():
    reg = obs_health.registry()
    was = reg.is_enabled
    saved = {k: getattr(reg, k) for k in _THRESHOLDS}
    reg.reset()
    yield obs_health
    reg.reset()
    for k, v in saved.items():
        setattr(reg, k, v)
    reg._enabled = was


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


def _etypes(events_mod):
    return [e["type"] for e in events_mod.ring().snapshot()]


# --------------------------------------------------------------------------- #
# Zero-overhead-when-off hook contract
# --------------------------------------------------------------------------- #

class TestSloHooks:
    def test_hooks_are_none_when_off(self, slo_off):
        assert slo.SCHED_SLO_HOOK is None
        assert slo.ENGINE_SLO_HOOK is None
        assert slo.ROUTER_SLO_HOOK is None
        assert not slo.enabled()
        assert slo.snapshot() == {"enabled": False, "tenants": {}}
        assert slo.push_data() is None
        assert slo.trace_points() == []
        assert slo.report() == "slo: off"

    def test_enable_installs_and_disable_clears(self, slo_off):
        reg = slo.enable()
        try:
            assert slo.SCHED_SLO_HOOK is reg
            assert slo.ENGINE_SLO_HOOK is reg
            assert slo.ROUTER_SLO_HOOK is reg
            assert slo.enabled() and slo.slo_registry() is reg
        finally:
            slo.disable()
        assert slo.SCHED_SLO_HOOK is None
        assert slo.ENGINE_SLO_HOOK is None
        assert slo.ROUTER_SLO_HOOK is None
        assert not slo.enabled()

    def test_disabled_run_records_nothing(self, slo_off, global_metrics):
        """A full engine run with capture off leaves no accounts behind
        (the hook sites were never called, not merely filtered)."""
        obs_metrics.disable()
        clock = FakeClock()
        eng = DeviceEngine("slo-off", autostart=False, clock=clock,
                           max_coalesce=1)
        t = eng.register("a")
        f = TagFilter("a")
        for _ in range(4):
            t.submit(f, [_mem()])
        while eng.step():
            pass
        assert slo.snapshot() == {"enabled": False, "tenants": {}}
        # a later enable starts from an empty ledger
        reg = slo.enable()
        assert reg.snapshot()["tenants"] == {}

    def test_set_objective_requires_enable(self, slo_off):
        with pytest.raises(RuntimeError):
            slo.set_objective("rt", p99_ms=50.0)


# --------------------------------------------------------------------------- #
# Cost attribution: conservation against engine totals
# --------------------------------------------------------------------------- #

class TestConservation:
    def test_per_tenant_sums_match_engine_totals(self, slo_off,
                                                 global_metrics):
        """The acceptance invariant: Σ device_seconds == busy_seconds
        and Σ wait_seconds == wait_seconds, within float tolerance."""
        obs_metrics.disable()
        slo.enable()
        clock = FakeClock()
        eng = DeviceEngine("slo-c", autostart=False, clock=clock,
                           max_coalesce=4)
        a = eng.register("a")
        b = eng.register("b")
        f = TagFilter("shared")  # one filter: a+b coalesce into batches
        for i in range(6):
            a.submit(f, [_mem()])
            clock.advance(0.01 * (i + 1))  # staggered, nonzero waits
            b.submit(f, [_mem()])
            clock.advance(0.02)
        while eng.step():
            pass
        assert eng.busy_seconds > 0.0
        assert eng.wait_seconds > 0.0
        snap = slo.snapshot()
        rows = snap["tenants"]
        assert set(rows) == {"a", "b"}
        dev_sum = sum(r["device_seconds"] for r in rows.values())
        wait_sum = sum(r["wait_seconds"] for r in rows.values())
        assert dev_sum == pytest.approx(eng.busy_seconds, rel=1e-9)
        assert wait_sum == pytest.approx(eng.wait_seconds, rel=1e-9)
        done = sum(sum(r["outcomes"].values()) for r in rows.values())
        assert done == 12

    def test_shed_feeds_outcomes_but_not_wait_account(self, slo_off,
                                                      global_metrics):
        """Shed work never reached the device: it lands as a shed
        outcome (with its queue wait as latency) but charges neither
        device_seconds nor wait_seconds — conservation stays exact."""
        obs_metrics.disable()
        slo.enable()
        clock = FakeClock()
        eng = DeviceEngine("slo-s", autostart=False, clock=clock,
                           max_coalesce=1)
        t = eng.register("a")
        fut = t.submit(TagFilter(), [_mem()],
                       deadline=FakeDeadline(True))  # shed at submit
        assert fut.result() is SHED
        row = slo.snapshot()["tenants"]["a"]
        assert row["outcomes"]["shed"] == 1
        assert row["shed_total"] == 1
        assert row["device_seconds"] == 0.0
        assert row["wait_seconds"] == 0.0
        assert eng.wait_seconds == 0.0


# --------------------------------------------------------------------------- #
# Registry accounting (driven directly, no engine)
# --------------------------------------------------------------------------- #

class TestRegistryAccounting:
    def test_busy_splits_proportional_to_rows(self, slo_off):
        reg = slo.SloRegistry(clock=FakeClock())
        reg.record_sched_batch(
            "dev0", 0.4,
            [("a", 0.1, 4, None), ("b", 0.2, 12, None)])
        rows = reg.snapshot()["tenants"]
        assert rows["a"]["device_seconds"] == pytest.approx(0.1)
        assert rows["b"]["device_seconds"] == pytest.approx(0.3)
        assert rows["a"]["wait_seconds"] == pytest.approx(0.1)
        assert rows["b"]["wait_seconds"] == pytest.approx(0.2)
        assert rows["a"]["outcomes"]["met"] == 1
        assert rows["b"]["outcomes"]["met"] == 1

    def test_expired_deadline_counts_as_missed(self, slo_off):
        reg = slo.SloRegistry(clock=FakeClock())
        reg.record_sched_batch(
            "dev0", 0.1,
            [("a", 0.0, 1, FakeDeadline(True)),
             ("b", 0.0, 1, FakeDeadline(False))])
        rows = reg.snapshot()["tenants"]
        assert rows["a"]["outcomes"]["missed"] == 1
        assert rows["b"]["outcomes"]["met"] == 1

    def test_engine_phase_charges_device_time(self, slo_off):
        reg = slo.SloRegistry(clock=FakeClock())
        reg.record_engine_phase("lm", "prefill", 0.25)
        reg.record_engine_phase("lm", "decode", 0.75)
        assert reg.snapshot()["tenants"]["lm"]["device_seconds"] \
            == pytest.approx(1.0)

    def test_tenant_overflow_folds(self, slo_off):
        reg = slo.SloRegistry(max_tenants=2, clock=FakeClock())
        for name in ("a", "b", "c", "d"):
            reg.record_outcome(name, "met", 0.01)
        rows = reg.snapshot()["tenants"]
        assert set(rows) == {"a", "b", slo.OVERFLOW_TENANT}
        assert rows[slo.OVERFLOW_TENANT]["outcomes"]["met"] == 2

    def test_unknown_router_session_folds_to_other(self, slo_off):
        reg = slo.SloRegistry(clock=FakeClock())
        reg.set_objective("rt", p99_ms=50.0)
        reg.record_dispatch("rt", 100, 200)
        reg.record_dispatch("random-session-9f3a", 7, 11)
        reg.record_dispatch(None, 1, 2)
        rows = reg.snapshot()["tenants"]
        assert rows["rt"]["bytes_tx"] == 100
        assert rows["rt"]["bytes_rx"] == 200
        assert rows[slo.OTHER_TENANT]["bytes_tx"] == 8
        assert rows[slo.OTHER_TENANT]["bytes_rx"] == 13


# --------------------------------------------------------------------------- #
# Burn-rate evaluation (fake clock, deterministic)
# --------------------------------------------------------------------------- #

class TestBurnRate:
    def _reg(self):
        fc = FakeClock()
        reg = slo.SloRegistry(fast_window_s=10.0, slow_window_s=100.0,
                              clock=fc)
        return reg, fc

    def test_empty_windows_burn_zero(self, slo_off):
        reg, _fc = self._reg()
        reg.set_objective("rt", p99_ms=50.0, goodput_ratio=0.99)
        ev = reg.evaluate("rt")
        assert not ev["breached"]
        assert ev["worst_burn"] == 0.0
        for w in ("fast", "slow"):
            assert ev["windows"][w]["burn"] == {"goodput": 0.0, "p99": 0.0}

    def test_goodput_burn_is_budget_normalized(self, slo_off):
        reg, fc = self._reg()
        reg.set_objective("rt", goodput_ratio=0.9)  # 10% bad budget
        for _ in range(8):
            reg.record_outcome("rt", "met", 0.01)
        reg.record_outcome("rt", "missed", 0.2)
        reg.record_shed("rt", "sched")
        # 2 bad of 10 = 20% observed over the 10% budget -> burn 2.0
        ev = reg.evaluate("rt", now=fc.t)
        assert ev["windows"]["fast"]["burn"]["goodput"] \
            == pytest.approx(2.0)
        assert ev["breached"] and ev["breached_objectives"] == ["goodput"]
        assert ev["worst_objective"] == "goodput"

    def test_p99_burn_counts_slow_and_shed(self, slo_off):
        reg, fc = self._reg()
        reg.set_objective("rt", p99_ms=50.0)
        for _ in range(9):
            reg.record_outcome("rt", "met", 0.001)
        reg.record_outcome("rt", "met", 0.2)  # met, but over the target
        # 1 slow of 10 = 10% over the 1% p99 budget -> burn 10.0
        ev = reg.evaluate("rt", now=fc.t)
        assert ev["windows"]["fast"]["burn"]["p99"] == pytest.approx(10.0)
        assert ev["breached"]

    def test_breach_requires_both_windows(self, slo_off):
        """Multi-window semantics: once the fast window drains, the old
        misses still burning the slow window no longer alert."""
        reg, fc = self._reg()
        reg.set_objective("rt", goodput_ratio=0.9)
        for _ in range(10):
            reg.record_outcome("rt", "missed", 0.2)
        assert reg.evaluate("rt")["breached"]
        fc.advance(50.0)  # past fast (10s), inside slow (100s)
        ev = reg.evaluate("rt")
        assert ev["windows"]["fast"]["burn"]["goodput"] == 0.0
        assert ev["windows"]["slow"]["burn"]["goodput"] \
            == pytest.approx(10.0)
        assert not ev["breached"]
        fc.advance(100.0)  # everything aged out
        ev = reg.evaluate("rt")
        assert ev["windows"]["slow"]["burn"]["goodput"] == 0.0

    def test_objective_validation(self, slo_off):
        reg, _fc = self._reg()
        with pytest.raises(ValueError):
            reg.set_objective("rt")
        with pytest.raises(ValueError):
            reg.set_objective("rt", p99_ms=0.0)
        with pytest.raises(ValueError):
            reg.set_objective("rt", goodput_ratio=1.0)


# --------------------------------------------------------------------------- #
# Health integration: breach -> DEGRADED -> recovery
# --------------------------------------------------------------------------- #

class TestHealthIntegration:
    def test_miss_storm_degrades_only_offending_tenant(
            self, slo_off, health, events):
        health.enable(interval_s=60.0)
        fc = FakeClock()
        slo.enable(fast_window_s=10.0, slow_window_s=100.0, clock=fc)
        slo.set_objective("rt", goodput_ratio=0.9)
        slo.set_objective("bulk", goodput_ratio=0.5)
        reg = slo.slo_registry()
        for _ in range(10):
            reg.record_outcome("rt", "missed", 0.2)
            reg.record_outcome("bulk", "met", 0.2)
        health.check_now()
        by_name = {c["name"]: c for c in
                   health.snapshot()["components"]}
        assert by_name["slo:rt"]["status"] == "degraded"
        assert "SLO burn" in by_name["slo:rt"]["detail"]
        assert by_name["slo:bulk"]["status"] == "ok"
        alerts = [e for e in events.ring().snapshot()
                  if e["type"] == "slo.burn_alert"]
        assert len(alerts) == 1 and alerts[0]["attrs"]["tenant"] == "rt"
        # /debug/slo-visible snapshot reflects the breach
        assert slo.snapshot()["tenants"]["rt"]["burn"]["breached"]

        # drain both windows: the same watchdog pass recovers it
        fc.advance(200.0)
        health.check_now()
        by_name = {c["name"]: c for c in
                   health.snapshot()["components"]}
        assert by_name["slo:rt"]["status"] == "ok"
        assert "slo.recover" in _etypes(events)
        assert not slo.snapshot()["tenants"]["rt"]["burn"]["breached"]
        # alert does not re-fire while already recovered
        health.check_now()
        assert _etypes(events).count("slo.recover") == 1

    def test_disable_retires_components(self, slo_off, health):
        health.enable(interval_s=60.0)
        slo.enable()
        slo.set_objective("rt", p99_ms=50.0)
        health.check_now()
        names = [c["name"] for c in health.snapshot()["components"]]
        assert "slo:rt" in names
        slo.disable()
        health.check_now()  # probe returns None: component retired
        names = [c["name"] for c in health.snapshot()["components"]]
        assert "slo:rt" not in names


# --------------------------------------------------------------------------- #
# Sched starvation-storm watchdog rule
# --------------------------------------------------------------------------- #

class TestStarvationWatchdog:
    def test_relief_storm_degrades_and_recovers(self, health, events):
        health.enable(interval_s=60.0)
        health.registry().configure(starvation_storm=3,
                                    starvation_window_s=0.0)
        eng = DeviceEngine("wd", autostart=False, clock=FakeClock(),
                           max_coalesce=1)
        health.check_now()  # opens the counting window
        by_name = {c["name"]: c for c in
                   health.snapshot()["components"]}
        assert by_name["sched:wd"]["status"] == "ok"
        eng.stats["starvation_reliefs"] += 3
        health.check_now()  # window elapsed (0s): delta 3 >= storm 3
        by_name = {c["name"]: c for c in
                   health.snapshot()["components"]}
        assert by_name["sched:wd"]["status"] == "degraded"
        assert "starvation" in by_name["sched:wd"]["detail"]
        assert "sched.starvation_storm" in _etypes(events)
        health.check_now()  # quiet window: recovery
        by_name = {c["name"]: c for c in
                   health.snapshot()["components"]}
        assert by_name["sched:wd"]["status"] == "ok"
        assert "sched.recover" in _etypes(events)

    def test_below_threshold_stays_ok(self, health, events):
        health.enable(interval_s=60.0)
        health.registry().configure(starvation_storm=5,
                                    starvation_window_s=0.0)
        eng = DeviceEngine("wd2", autostart=False, clock=FakeClock(),
                           max_coalesce=1)
        health.check_now()
        eng.stats["starvation_reliefs"] += 2
        health.check_now()
        by_name = {c["name"]: c for c in
                   health.snapshot()["components"]}
        assert by_name["sched:wd2"]["status"] == "ok"
        assert "sched.starvation_storm" not in _etypes(events)


# --------------------------------------------------------------------------- #
# Exporter routes
# --------------------------------------------------------------------------- #

class TestExporterRoutes:
    def _get(self, port, path):
        return json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=5).read().decode())

    def test_debug_slo_off_is_still_200(self, slo_off, global_metrics):
        with start_exporter(port=0) as exp:
            doc = self._get(exp.port, "/debug/slo")
        assert doc["enabled"] is False and doc["tenants"] == {}
        assert "fleet" not in doc

    def test_debug_slo_serves_snapshot_and_fleet_rollup(
            self, slo_off, global_metrics):
        slo.enable(fast_window_s=10.0, slow_window_s=100.0)
        slo.set_objective("rt", goodput_ratio=0.9)
        reg = slo.slo_registry()
        for _ in range(4):
            reg.record_outcome("rt", "missed", 0.2)
        obs_fleet.enable_aggregator(ttl_s=30.0)
        try:
            with start_exporter(port=0) as exp:
                doc = self._get(exp.port, "/debug/slo")
        finally:
            obs_fleet.disable_aggregator()
        assert doc["enabled"] is True
        assert doc["tenants"]["rt"]["burn"]["breached"] is True
        assert "rt" in doc["fleet"]["breached"]
        assert any(s.get("enabled")
                   for s in doc["fleet"]["instances"].values())

    def test_debug_profile_samples_route(self, slo_off, global_metrics):
        with start_exporter(port=0) as exp:
            doc = self._get(exp.port, "/debug/profile/samples")
        assert doc["version"] == 1
        assert doc["profile_enabled"] is obs_profile.enabled()
        assert isinstance(doc["samples"], list)

    def test_404_hint_includes_new_routes(self, slo_off, global_metrics):
        with start_exporter(port=0) as exp:
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{exp.port}/nope", timeout=5)
            assert ei.value.code == 404
            hint = ei.value.read().decode()
        assert "/debug/slo" in hint
        assert "/debug/profile/samples" in hint


# --------------------------------------------------------------------------- #
# Fleet rollup
# --------------------------------------------------------------------------- #

class TestFleetRollup:
    def test_rollup_merges_local_and_remote_breaches(self, slo_off):
        agg = FleetAggregator(instance="agg:1")
        agg.ingest({
            "v": 1, "instance": "w1:1", "seq": 1,
            "slo": {"enabled": True,
                    "tenants": {"rt": {"burn": {"breached": True}}}},
        })
        local = {"enabled": True,
                 "tenants": {"bulk": {"burn": {"breached": True}},
                             "ok-t": {"burn": {"breached": False}}}}
        roll = agg.slo_rollup(local)
        assert set(roll["instances"]) == {"agg:1", "w1:1"}
        assert roll["breached"] == ["bulk", "rt"]

    def test_rollup_skips_disabled_snapshots(self, slo_off):
        agg = FleetAggregator(instance="agg:1")
        agg.ingest({"v": 1, "instance": "w1:1", "seq": 1,
                    "slo": {"enabled": False, "tenants": {}}})
        roll = agg.slo_rollup(None)
        assert roll == {"instances": {}, "breached": []}

    def test_push_document_carries_slo(self, slo_off):
        from nnstreamer_tpu_torch.obs.fleet import build_push
        from nnstreamer_tpu_torch.obs.metrics import MetricsRegistry
        from nnstreamer_tpu_torch.obs.tracing import SpanStore

        def push():
            return build_push(
                "w1:1", "worker", 1, interval_s=2.0,
                registry=MetricsRegistry(enabled=True),
                health_registry=obs_health.HealthRegistry(),
                span_store=SpanStore())

        assert push()["slo"] is None  # disabled: no payload bytes
        slo.enable()
        slo.slo_registry().record_outcome("rt", "met", 0.01)
        doc = push()
        assert doc["slo"]["enabled"] is True
        assert "rt" in doc["slo"]["tenants"]


# --------------------------------------------------------------------------- #
# Perfetto per-tenant goodput lane (pid 5)
# --------------------------------------------------------------------------- #

class TestPerfettoLane:
    def test_goodput_counter_track(self, slo_off):
        slo.enable()
        reg = slo.slo_registry()
        reg.record_outcome("rt", "met", 0.01)
        reg.record_outcome("rt", "missed", 0.2)
        reg.record_shed("rt", "sched")
        doc = obs_profile.perfetto_trace()
        assert doc["otherData"]["slo_enabled"] is True
        pts = [e for e in doc["traceEvents"]
               if e.get("ph") == "C" and e.get("name") == "rt.goodput"]
        assert len(pts) == 3
        assert all(p["pid"] == 5 for p in pts)
        assert pts[-1]["args"] == {"met": 1, "missed": 1, "shed": 1}

    def test_no_lane_while_off(self, slo_off):
        doc = obs_profile.perfetto_trace()
        assert doc["otherData"]["slo_enabled"] is False
        assert not any(e.get("name", "").endswith(".goodput")
                       for e in doc["traceEvents"])


# --------------------------------------------------------------------------- #
# --slo spec parser
# --------------------------------------------------------------------------- #

class TestParseSloSpec:
    def test_full_spec(self):
        spec = slo.parse_slo_spec("rt:p99=50:goodput=0.99,batch:goodput=0.9")
        assert spec == {
            "rt": {"p99_ms": 50.0, "goodput_ratio": 0.99},
            "batch": {"goodput_ratio": 0.9},
        }

    @pytest.mark.parametrize("bad", [
        "rt:p99=50,",                # empty trailing entry
        ":p99=50",                   # missing tenant
        "rt:p99=50,rt:goodput=0.9",  # duplicate tenant
        "rt",                        # no objectives
        "rt:p42=50",                 # unknown key
        "rt:p99=abc",                # non-numeric value
        "rt:p99=0",                  # out of range
        "rt:goodput=1.5",            # out of range
        "rt:p99",                    # missing '='
    ])
    def test_malformed_specs_raise(self, bad):
        with pytest.raises(ValueError):
            slo.parse_slo_spec(bad)


# --------------------------------------------------------------------------- #
# Parity with the JAX package
# --------------------------------------------------------------------------- #

_SPECS = ["rt:p99=50:goodput=0.99,batch:goodput=0.9", "cam:p99=12.5",
          "a:goodput=0.5,b:p99=1,c:p99=2:goodput=0.75",
          "rt:p99=50,", ":p99=50", "rt:p99=50,rt:goodput=0.9", "rt",
          "rt:p42=50", "rt:p99=abc", "rt:p99=0", "rt:goodput=1.5", "rt:p99"]


def _parsed(mod, spec):
    try:
        return mod.parse_slo_spec(spec)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("spec", _SPECS)
def test_parse_slo_spec_equals_jax(spec):
    from nnstreamer_tpu.obs import slo as jax_slo

    assert _parsed(slo, spec) == _parsed(jax_slo, spec)


def _burn_script(mod, seed):
    """A seeded stream of outcomes, sheds and clock advances on one
    package's registry; every evaluate() along the way."""
    rng = np.random.default_rng(seed)
    fc = FakeClock()
    reg = mod.SloRegistry(fast_window_s=10.0, slow_window_s=60.0,
                          burn_threshold=float(rng.choice([0.5, 1.0, 2.0])),
                          window_events=64, clock=fc)
    reg.set_objective("rt", p99_ms=50.0, goodput_ratio=0.9)
    reg.set_objective("bulk", goodput_ratio=0.5)
    verdicts = []
    for _ in range(120):
        r = rng.random()
        tenant = "rt" if rng.random() < 0.6 else "bulk"
        if r < 0.55:
            reg.record_outcome(tenant, "met", float(rng.choice([0.001, 0.2])))
        elif r < 0.7:
            reg.record_outcome(tenant, "missed", 0.3)
        elif r < 0.8:
            reg.record_shed(tenant, "sched", wait_s=0.01)
        else:
            fc.advance(float(rng.choice([1.0, 5.0, 20.0])))
            verdicts.append([reg.evaluate(t) for t in ("rt", "bulk")])
    snap = reg.snapshot()
    return verdicts, {k: (v["outcomes"], v["shed_total"], v.get("burn"))
                      for k, v in snap["tenants"].items()}


@pytest.mark.parametrize("seed", range(4))
def test_burn_verdicts_under_injected_clock_equal_jax(seed, slo_off):
    from nnstreamer_tpu.obs import slo as jax_slo

    got, want = _burn_script(slo, seed), _burn_script(jax_slo, seed)
    assert got == want
    assert any(v["breached"] for vs in got[0] for v in vs)


@pytest.mark.parametrize("seed", [0, 3, 5, 11, 17])
def test_sched_slo_ledger_after_seeded_scenarios_equals_jax(seed, slo_off):
    """The seeded scenarios of tests/test_torch_sched.py on each package's
    engine with its SLO layer on: per-tenant outcomes, sheds and queue waits
    (the engine's fake clock) equal the JAX engine's; device seconds (the
    host's clock) still sum to each engine's busy time."""
    import nnstreamer_tpu.sched as jax_sched
    from nnstreamer_tpu.obs import slo as jax_slo
    from test_torch_sched import _drive

    got = {}
    for name, mod, cls in (("jax", jax_slo, jax_sched.DeviceEngine),
                           ("torch", slo, DeviceEngine)):
        mod.enable(clock=FakeClock())
        try:
            run = _drive(cls, seed)
            rows = mod.snapshot()["tenants"]
        finally:
            mod.disable()
        got[name] = {t: (r["outcomes"], r["shed_total"],
                         round(r["wait_seconds"], 9))
                     for t, r in rows.items()}
        assert sum(r["outcomes"]["shed"] for r in rows.values()) \
            == run["stats"]["shed"]
    assert got["torch"] == got["jax"]
    assert sum(sum(o.values()) for o, _, _ in got["torch"].values()) > 0


class _FlipDeadline:
    """A deadline the test expires by hand: live at submit, expired once
    ``flip()`` is called (the CPU stand-in for time passing in the queue)."""

    def __init__(self, expired=False):
        self.is_expired = expired

    def flip(self):
        self.is_expired = True

    def expired(self):
        return self.is_expired


_LM_CACHE = {}


def _lm_params():
    """One seeded narrow causal LM, as the JAX tree and the port's."""
    if not _LM_CACHE:
        import jax

        from nnstreamer_tpu.models import causal_lm as jax_lm
        from nnstreamer_tpu_torch.models import convert

        jparams = jax_lm.init_causal_lm(jax.random.PRNGKey(5), 61, 32, 4, 2,
                                        64)
        _LM_CACHE["jax"] = jparams
        _LM_CACHE["torch"] = convert.causal_lm_params(
            jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return _LM_CACHE


def lm_layers_run(pkg, bundle_dir):
    """A seeded paged LM run on one package's engine (``pkg`` "jax" or
    "torch") with its slo, diag and quality layers on: 10 requests in two
    prefix groups, one session per group; 2 deadlines expired at submit, 2
    expired while queued, the rest far off. Returns the results and what
    each layer recorded."""
    import importlib

    root = "nnstreamer_tpu" if pkg == "jax" else "nnstreamer_tpu_torch"
    slo_m = importlib.import_module(root + ".obs.slo")
    q_m = importlib.import_module(root + ".obs.quality")
    d_m = importlib.import_module(root + ".obs.diag")
    engine_cls = importlib.import_module(root + ".serving.lm_engine").LMEngine
    params = _lm_params()[pkg]
    rng = np.random.default_rng(21)
    prefixes = [rng.integers(1, 61, 16).astype(np.int32) for _ in range(2)]
    kw = dict(n_slots=2, chunk=4, kv_page_size=8, kv_pages=12)
    if pkg == "torch":
        kw["device"] = "cpu"
    slo_m.enable(clock=FakeClock())
    q_m.enable()
    d_m.enable(str(bundle_dir))
    try:
        eng = engine_cls(params, 4, 64, **kw)
        flips = []
        for i in range(10):
            g = i % 2
            prompt = np.concatenate([prefixes[g], rng.integers(
                1, 61, int(rng.integers(2, 9)))]).astype(np.int32)
            if i in (1, 6):
                dl = _FlipDeadline(True)
            elif i in (3, 8):
                dl = _FlipDeadline()
                flips.append(dl)
            else:
                dl = _FlipDeadline()
            eng.submit(prompt, max_new=int(rng.integers(2, 7)), deadline=dl,
                       session=f"s{g}")
        for dl in flips:
            dl.flip()
        results = eng.run()
        slo_rows = {t: (r["outcomes"], r["shed_total"])
                    for t, r in slo_m.snapshot()["tenants"].items()}
        conf = q_m.snapshot()["confidence"]
        requests = [(r["engine"], r["rid"], r["tenant"], r["shed"])
                    for r in d_m.engine().recent_requests()]
    finally:
        slo_m.disable()
        q_m.disable()
        d_m.disable()
    return dict(results={k: list(map(int, v)) for k, v in results.items()},
                slo=slo_rows, conf=conf, requests=requests)


def test_lm_deadlines_and_sessions_equal_jax(slo_off, tmp_path):
    """The same seeded paged run on both engines: tokens, SLO outcomes and
    sheds, diag's request observations and quality's confidence aggregates
    (within rtol 1e-5) equal the JAX engine's."""
    got = lm_layers_run("torch", tmp_path / "t")
    want = lm_layers_run("jax", tmp_path / "j")
    assert got["results"] == want["results"]
    assert sorted(k for k, v in got["results"].items() if not v) == [1, 3, 6, 8]
    assert got["slo"] == want["slo"]
    assert got["slo"]["lm"][0] == {"met": 6, "missed": 0, "shed": 4}
    assert got["requests"] == want["requests"]
    assert {t for _, _, t, _ in got["requests"]} == {"s0", "s1"}
    for scope in ("tenants", "sessions"):
        assert set(got["conf"][scope]) == set(want["conf"][scope])
        for k, agg in got["conf"][scope].items():
            ref = want["conf"][scope][k]
            assert agg["n"] == ref["n"]
            for sig in ("entropy", "top1", "margin"):
                assert agg[sig]["mean"] == pytest.approx(
                    ref[sig]["mean"], rel=1e-5, abs=1e-7)


# --------------------------------------------------------------------------- #
# The CLI: --slo, --diag, --quality, --quality-record, --tune
# --------------------------------------------------------------------------- #

_PIPE = "videotestsrc num-buffers=4 width=8 height=8 ! tensor_converter ! " \
        "tensor_sink"


@pytest.mark.parametrize("argv", [
    ["--tune", _PIPE], ["--tune", "s.json", _PIPE], ["--tune=s.json", _PIPE],
    ["--diag", _PIPE], ["--diag", "dir", _PIPE], ["--quality", _PIPE],
    ["--quality", "taps=chain", _PIPE], ["--sched", "--diag", _PIPE],
    ["--slo", "cam:p99=5", "--quality-record", "b.json", "--quality", _PIPE],
], ids=lambda a: " ".join(a)[:40])
def test_obs_layer_flags_parse_as_jax(argv):
    """The five flags normalize and parse to the JAX CLI's values."""
    import argparse

    from nnstreamer_tpu.cli import _normalize_argv as jax_normalize
    from nnstreamer_tpu_torch.cli import _normalize_argv

    got = _normalize_argv(list(argv))
    assert got == jax_normalize(list(argv))
    ap = argparse.ArgumentParser()
    ap.add_argument("pipeline", nargs="?")
    ap.add_argument("--sched", type=int, nargs="?", const=8)
    for flag in ("--tune", "--diag", "--quality"):
        ap.add_argument(flag, nargs="?", const="", default=None)
    ap.add_argument("--slo")
    ap.add_argument("--quality-record")
    assert ap.parse_args(got).pipeline == _PIPE


@pytest.mark.parametrize("argv,msg", [
    (["--slo", "cam:p42=5"], "--slo: unknown objective key"),
    (["--quality", "bogus=1"], "--quality: unknown --quality key"),
    (["--quality-record", "b.json"], "--quality-record needs --quality"),
])
def test_obs_layer_flag_errors(argv, msg, capsys):
    from nnstreamer_tpu_torch.cli import main

    with pytest.raises(SystemExit) as e:
        main(argv + ["--device", "cpu", _PIPE])
    assert e.value.code == 2
    assert msg in capsys.readouterr().err


def test_cli_obs_layers_run(tmp_path, capsys, slo_off):
    """All five flags on a CPU pipeline on the DeviceEngine: exit 0, each
    layer's setup line and exit report, the drift baseline written, every
    layer off again after the run."""
    from nnstreamer_tpu_torch import tune
    from nnstreamer_tpu_torch.cli import main
    from nnstreamer_tpu_torch.obs import diag, quality, tracing

    base, store = tmp_path / "base.json", tmp_path / "tune.json"
    was_t = tracing.enabled()
    try:
        rc = main(["--device", "cpu", "--sched", "--slo",
                   "cli:p99=10000:goodput=0.5", "--diag", str(tmp_path / "d"),
                   "--quality", "--quality-record", str(base), "--tune",
                   str(store), "--metrics-port", "0", "--watchdog", "30",
                   _PIPE])
    finally:
        (tracing.enable if was_t else tracing.disable)()
        tracing.store().reset()
        obs_events.disable()
        obs_events.ring().reset()
        obs_health.disable()
        obs_health.registry().reset()
        obs_metrics.disable()
    err = capsys.readouterr().err
    assert rc == 0, err
    for line in ("slo: tracking 1 objective tenant(s): cli",
                 "diag: bundles -> ", "quality: data-plane telemetry on",
                 "tune: autotuner on (0 stored config(s)",
                 "slo: per-tenant accounting", "autotuner:",
                 "quality: data-plane observation", "chain:tensor_sink",
                 f"quality: baseline -> {base}", "diag: 0 bundle(s)"):
        assert line in err, line
    assert json.loads(base.read_text())["taps"]
    assert not (slo.enabled() or diag.enabled() or quality.enabled()
                or tune.enabled())
