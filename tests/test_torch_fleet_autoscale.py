"""The port's fleet/ autoscaling: every case of
tests/test_fleet_autoscale.py, run against ``nnstreamer_tpu_torch`` on the
CPU with the JAX package's seeded params carried over by
``models.convert`` — the policies on a fake clock, live session migration
token-equal to no migration, the reconcile loop's scale-up, drain and
scale-in with zero stream loss, the launcher's ``/readyz`` gate on
``sys.executable -c`` stubs, and the action journal in push docs and
``/debug/fleet/actions``. Each case runs
under a timeout of its own (SIGALRM) and leaves no controller, fleet hook
or chaos plan behind.
"""


import json
import signal
import sys
import urllib.request

import numpy as np
import pytest

import jax

from nnstreamer_tpu_torch import fleet
from nnstreamer_tpu_torch.fleet.autoscale import (
    AutoscalePolicy, PricedPolicy, parse_autoscale_spec)
from nnstreamer_tpu_torch.fleet.controller import (BackendLauncher,
                                                   FleetController)
from nnstreamer_tpu_torch.fleet.migrate import LM_CAPS, SessionMigrator
from nnstreamer_tpu.models import causal_lm as jlm
from nnstreamer_tpu_torch.models.convert import causal_lm_params
from nnstreamer_tpu_torch.obs import events as obs_events
from nnstreamer_tpu_torch.obs import fleet as obs_fleet
from nnstreamer_tpu_torch.obs import slo as obs_slo
from nnstreamer_tpu_torch.obs.exporter import start_exporter
from nnstreamer_tpu_torch.obs.metrics import MetricsRegistry
from nnstreamer_tpu_torch.query.router import (
    SESSION_PIN_LIMIT, BackendSet, QueryRouter)
from nnstreamer_tpu_torch.resilience import chaos
from nnstreamer_tpu_torch.resilience import policy as rp
from nnstreamer_tpu_torch.serving import LMEngine as _LMEngine, disagg


#: each case's own limit, seconds
CASE_TIMEOUT_S = 60


@pytest.fixture(autouse=True)
def _case_guard():
    """A timeout of the case's own (SIGALRM), and no chaos plan, fleet
    hook, pusher, aggregator, controller or import target left for the
    next case."""
    def expire(signum, frame):
        raise TimeoutError(f"case exceeded {CASE_TIMEOUT_S} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(CASE_TIMEOUT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
        from nnstreamer_tpu_torch import fleet as _fleet_pkg
        from nnstreamer_tpu_torch.obs import fleet as _obs_fleet
        from nnstreamer_tpu_torch.resilience import chaos as _chaos
        from nnstreamer_tpu_torch.serving import disagg as _disagg

        _fleet_pkg.disable()
        _obs_fleet.disable_push()
        _obs_fleet.disable_aggregator()
        _disagg.clear_import_target()
        _chaos.uninstall()


def LMEngine(*args, **kw):
    """The port's engine on the CPU (its default device is the card)."""
    kw.setdefault("device", "cpu")
    return _LMEngine(*args, **kw)


V, D, H, L, MAXLEN = 97, 32, 4, 2, 64
PS = 8


@pytest.fixture(scope="module")
def params():
    # the JAX package's seeded params, carried over by models.convert
    return causal_lm_params(jax.tree_util.tree_map(
        np.asarray, jlm.init_causal_lm(
            jax.random.PRNGKey(7), V, D, H, L, MAXLEN)), "cpu")


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
def agg():
    a = obs_fleet.enable_aggregator(ttl_s=30.0)
    yield a
    obs_fleet.disable_aggregator()


@pytest.fixture
def fleet_off_after():
    yield
    fleet.disable()


@pytest.fixture
def slo_off_after():
    yield
    obs_slo.disable()


def events_of(etype):
    return [e for e in obs_events.ring().snapshot() if e["type"] == etype]


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def mkeng(params, pages=32, slots=2):
    return LMEngine(params, H, MAXLEN, n_slots=slots, chunk=4,
                    kv_page_size=PS, kv_pages=pages)


def mkfleet(params, n, name="fleet-test"):
    """n unified DisaggWorkers behind one QueryRouter."""
    engines = [mkeng(params) for _ in range(n)]
    workers = [disagg.DisaggWorker(e) for e in engines]
    router = QueryRouter(
        BackendSet([(w.host, w.port) for w in workers], name), name)
    router.set_caps_provider(lambda: LM_CAPS)
    return workers, router


def lm_dispatch(router, prompt, session, max_new=6):
    rmeta, _ = router.dispatch(
        {"lm": {"prompt": [int(x) for x in prompt], "max_new": max_new,
                "session": session}},
        b"", session=session)
    return [int(t) for t in rmeta.get("tokens", [])]


def stop_all(router, workers):
    router.close()
    for w in workers:
        w.stop()


# --------------------------------------------------------------------------- #
# Policy discipline
# --------------------------------------------------------------------------- #

class TestPolicy:
    def mkpol(self, clk, **kw):
        kw.setdefault("hysteresis", 2)
        kw.setdefault("cooldown_s", 10.0)
        return AutoscalePolicy(1, 4, clock=clk, **kw)

    def test_hysteresis_gates_action(self):
        clk = FakeClock()
        pol = self.mkpol(clk)
        up = {"replicas": 2, "queue_depth": 100.0, "occupancy": 0.0}
        assert pol.decide(up).action == "hold"          # streak 1/2
        assert pol.decide(up).action == "scale_up"      # streak 2/2

    def test_cooldown_blocks_consecutive_actions(self):
        clk = FakeClock()
        pol = self.mkpol(clk)
        up = {"replicas": 2, "queue_depth": 100.0, "occupancy": 0.0}
        pol.decide(up)
        assert pol.decide(up).action == "scale_up"
        # still pressured, but inside the cooldown window
        assert pol.decide(up).action == "hold"
        assert pol.decide(up).action == "hold"
        clk.advance(11.0)
        # streak kept building through the cooldown holds, so the first
        # post-cooldown tick acts
        assert pol.decide(up).action == "scale_up"

    def test_deadband_resets_both_streaks(self):
        clk = FakeClock()
        pol = self.mkpol(clk)
        up = {"replicas": 2, "queue_depth": 100.0, "occupancy": 0.0}
        mid = {"replicas": 2, "queue_depth": 4.0, "occupancy": 0.5}
        pol.decide(up)                                   # up streak 1
        d = pol.decide(mid)                              # deadband
        assert d.action == "hold" and "between" in d.reason
        # the earlier streak must NOT carry over
        assert pol.decide(up).action == "hold"

    def test_oscillation_never_flaps(self):
        """A signal alternating across the scale-in threshold can never
        accumulate the hysteresis streak — zero actions, ever."""
        clk = FakeClock()
        pol = self.mkpol(clk)
        low = {"replicas": 3, "queue_depth": 0.0, "occupancy": 0.0}
        mid = {"replicas": 3, "queue_depth": 4.0, "occupancy": 0.5}
        actions = []
        for i in range(40):
            actions.append(pol.decide(low if i % 2 == 0 else mid).action)
            clk.advance(60.0)                            # cooldown never binds
        assert set(actions) == {"hold"}

    def test_min_max_clamp(self):
        clk = FakeClock()
        pol = self.mkpol(clk, hysteresis=1)
        up = {"replicas": 4, "queue_depth": 100.0, "occupancy": 0.0}
        d = pol.decide(up)
        assert d.action == "hold" and "max_replicas" in d.reason
        clk.advance(11.0)
        down = {"replicas": 1, "queue_depth": 0.0, "occupancy": 0.0}
        d = pol.decide(down)
        assert d.action == "hold" and "min_replicas" in d.reason

    def test_breach_is_up_pressure(self):
        clk = FakeClock()
        pol = self.mkpol(clk, hysteresis=1)
        d = pol.decide({"replicas": 2, "queue_depth": 0.0,
                        "occupancy": 0.0, "breached": ["tenant-a"]})
        assert d.action == "scale_up" and "tenant-a" in d.reason

    def test_parse_spec(self):
        assert parse_autoscale_spec("2:8") == (2, 8, "default")
        assert parse_autoscale_spec("1:4:priced") == (1, 4, "priced")
        for bad in ("3", "0:4", "4:2", "2:8:nope", "a:b", "2:8:x:y"):
            with pytest.raises(ValueError):
                parse_autoscale_spec(bad)


class TestPricedPolicy:
    def test_scale_up_priced_out_when_backlog_drains_first(self):
        clk = FakeClock()
        pol = PricedPolicy(1, 4, hysteresis=1, cooldown_s=0.0,
                           spawn_cost_s=5.0, service_rate=4.0, clock=clk)
        # queue 10 over 2 replicas * 4/s = 1.25s to drain < 5s spawn
        d = pol.decide({"replicas": 2, "queue_depth": 10.0,
                        "occupancy": 0.0})
        assert d.action == "hold" and "priced out" in d.reason
        # a backlog worth the spawn goes through
        d = pol.decide({"replicas": 2, "queue_depth": 100.0,
                        "occupancy": 0.0})
        assert d.action == "scale_up"

    def test_breach_overrides_the_price(self):
        clk = FakeClock()
        pol = PricedPolicy(1, 4, hysteresis=1, cooldown_s=0.0, clock=clk)
        d = pol.decide({"replicas": 2, "queue_depth": 0.0,
                        "occupancy": 0.0, "breached": ["t"]})
        assert d.action == "scale_up"

    def test_scale_in_priced_out_by_migration_census(self):
        clk = FakeClock()
        pol = PricedPolicy(1, 4, hysteresis=1, cooldown_s=0.0,
                           max_migration_sessions=8, clock=clk)
        down = {"replicas": 3, "queue_depth": 0.0, "occupancy": 0.0,
                "victim_sessions": 9}
        d = pol.decide(down)
        assert d.action == "hold" and "9 sessions" in d.reason
        d = pol.decide(dict(down, victim_sessions=3))
        assert d.action == "scale_in"


# --------------------------------------------------------------------------- #
# Router session tables + eager drain re-pin
# --------------------------------------------------------------------------- #

class TestSessionTables:
    def mkset(self, n=3):
        eps = [("127.0.0.1", 40001 + i) for i in range(n)]
        return BackendSet(eps, "pins-test"), [f"{h}:{p}" for h, p in eps]

    def test_pin_wins_placement(self):
        bs, eps = self.mkset()
        for _ in range(4):
            bs.pin_session("s1", eps[2])
            be = bs.pick(session="s1")
            assert be is not None and be.endpoint == eps[2]

    def test_pin_respects_exclude(self):
        bs, eps = self.mkset()
        bs.pin_session("s1", eps[2])
        be = bs.pick(session="s1", exclude=frozenset({eps[2]}))
        assert be is not None and be.endpoint != eps[2]

    def test_note_session_updates_ownership_census(self):
        bs, eps = self.mkset()
        bs.note_session("s1", eps[0])
        bs.note_session("s2", eps[0])
        bs.note_session("s2", eps[1])               # moved
        assert bs.sessions_owned(eps[0]) == ["s1"]
        assert bs.sessions_owned(eps[1]) == ["s2"]

    def test_drain_eagerly_repins_all_owned_sessions(self, events):
        bs, eps = self.mkset()
        for i in range(6):
            bs.note_session(f"s{i}", eps[0])
        bs.drain(eps[0])
        # every session re-homed NOW, not lazily at its next request
        assert bs.sessions_owned(eps[0]) == []
        rehomed = {s for ep in eps[1:] for s in bs.sessions_owned(ep)}
        assert rehomed == {f"s{i}" for i in range(6)}
        for i in range(6):
            be = bs.pick(session=f"s{i}")
            assert be is not None and be.endpoint != eps[0]
        evs = events_of("router.repin")
        assert len(evs) == 1 and evs[0]["attrs"]["sessions"] == 6

    def test_remove_drops_pins_naming_the_endpoint(self):
        bs, eps = self.mkset()
        bs.pin_session("s1", eps[1])
        bs.remove(eps[1], drain=False)
        assert bs.sessions_owned(eps[1]) == []
        # placement falls back to the ring, never a dead endpoint
        be = bs.pick(session="s1")
        assert be is not None and be.endpoint != eps[1]

    def test_session_tables_are_bounded(self):
        bs, eps = self.mkset()
        for i in range(SESSION_PIN_LIMIT + 50):
            bs.note_session(f"s{i}", eps[0])
        assert len(bs._owners) <= SESSION_PIN_LIMIT
        # LRU: the newest survive
        assert f"s{SESSION_PIN_LIMIT + 49}" in bs._owners
        assert "s0" not in bs._owners


# --------------------------------------------------------------------------- #
# Engine freeze / export / resume
# --------------------------------------------------------------------------- #

class TestEngineFreeze:
    def test_frozen_submit_refused_and_resume_lifts(self, params):
        eng = mkeng(params)
        p = np.arange(12, dtype=np.int32) % V
        rid = eng.submit(p, 4, session="sess-a")
        eng.run()
        assert len(eng.results[rid]) == 4
        assert eng.freeze_session("sess-a") is True     # path recorded
        with pytest.raises(ValueError, match="frozen for migration"):
            eng.submit(p, 4, session="sess-a")
        # other sessions unaffected
        eng.submit(p, 2, session="sess-b")
        eng.run()
        eng.resume_session("sess-a")
        rid = eng.submit(p, 4, session="sess-a")
        eng.run()
        assert len(eng.results[rid]) == 4

    def test_export_session_produces_page_doc(self, params):
        eng = mkeng(params)
        p = np.arange(2 * PS + 3, dtype=np.int32) % V
        eng.submit(p, 4, session="sess-x")
        eng.run()
        doc = eng.export_session("sess-x")
        assert doc is not None and len(doc["entries"]) >= 2
        # export froze the session as a side effect
        with pytest.raises(ValueError, match="frozen"):
            eng.submit(p, 2, session="sess-x")

    def test_export_unknown_session_is_none(self, params):
        eng = mkeng(params)
        assert eng.export_session("never-seen") is None


# --------------------------------------------------------------------------- #
# Live migration over the wire
# --------------------------------------------------------------------------- #

class TestMigrationWire:
    def test_migrate_moves_pages_and_repins(self, params, events):
        workers, router = mkfleet(params, 2)
        try:
            prompt = np.arange(2 * PS + 5, dtype=np.int32) % V
            out1 = lm_dispatch(router, prompt, "mig-s")
            assert len(out1) == 6
            src_ep = router.backends.sessions_owned(
                workers[0].endpoint) and workers[0].endpoint \
                or workers[1].endpoint
            source = router.backends.get(src_ep)
            target = router.backends.pick(session="mig-s",
                                          exclude=frozenset({src_ep}))
            mig = SessionMigrator(router)
            res = mig.migrate("mig-s", source, target)
            assert res["ok"] and not res["absorbed"]
            assert res["pages"] >= 2
            assert mig.stats["migrated"] == 1
            assert mig.stats["pages_moved"] == res["pages"]
            # pinned to the target: the next turn dials it directly
            be = router.backends.pick(session="mig-s")
            assert be is not None and be.endpoint == target.endpoint
            # and the stream keeps decoding — same prompt, same greedy
            # tokens on the migrated backend
            out2 = lm_dispatch(router, prompt, "mig-s")
            assert out2 == out1
            assert len(events_of("fleet.migrate_start")) == 1
            assert len(events_of("fleet.migrate_done")) == 1
        finally:
            stop_all(router, workers)

    def test_partitioned_transfer_absorbs(self, params, events):
        """Chaos partition on the KV_PAGE_XFER wire: the export ships
        nothing, the migration reports absorbed, the pin STILL moves,
        and the stream survives via target re-prefill."""
        workers, router = mkfleet(params, 2)
        try:
            prompt = np.arange(2 * PS + 5, dtype=np.int32) % V
            out1 = lm_dispatch(router, prompt, "abs-s")
            owned0 = router.backends.sessions_owned(workers[0].endpoint)
            source = router.backends.get(
                workers[0].endpoint if "abs-s" in owned0
                else workers[1].endpoint)
            target = router.backends.pick(
                session="abs-s", exclude=frozenset({source.endpoint}))
            plan = chaos.FaultPlan(
                [chaos.Fault(kind="partition", target="send",
                             cmd="KV_PAGE_XFER", nth=1)], seed=7)
            chaos.install(plan)
            try:
                mig = SessionMigrator(router)
                res = mig.migrate("abs-s", source, target)
            finally:
                chaos.uninstall()
            assert res["absorbed"] and not res["ok"]
            assert res["pages"] == 0
            assert mig.stats["absorbed"] == 1
            be = router.backends.pick(session="abs-s")
            assert be is not None and be.endpoint == target.endpoint
            # zero loss: the target re-prefills and the greedy stream
            # is token-identical to the warm path
            out2 = lm_dispatch(router, prompt, "abs-s")
            assert out2 == out1
            assert len(events_of("fleet.migrate_abandon")) == 1
        finally:
            stop_all(router, workers)

    def test_dead_source_absorbs(self, params):
        workers, router = mkfleet(params, 2)
        try:
            prompt = np.arange(12, dtype=np.int32) % V
            lm_dispatch(router, prompt, "dead-s")
            owned0 = router.backends.sessions_owned(workers[0].endpoint)
            src_w, tgt_w = (workers if "dead-s" in owned0
                            else workers[::-1])
            source = router.backends.get(src_w.endpoint)
            target = router.backends.get(tgt_w.endpoint)
            # kill the owner: listener down AND the pooled connection
            # dropped, so the export round trip must dial a dead port
            src_w.stop()
            source.close()
            mig = SessionMigrator(router, timeout_s=2.0)
            res = mig.migrate("dead-s", source, target)
            assert res["absorbed"]
            be = router.backends.pick(session="dead-s")
            assert be is not None and be.endpoint == target.endpoint
        finally:
            stop_all(router, workers)


# --------------------------------------------------------------------------- #
# Aggregator hygiene: tombstone compaction + confirmed drain
# --------------------------------------------------------------------------- #

class TestAggregatorHygiene:
    def test_tombstone_compaction_is_oldest_first(self, agg, monkeypatch):
        monkeypatch.setattr(obs_fleet, "TOMBSTONE_LIMIT", 2)
        with agg._lock:
            for iid, t in (("w-a", 3.0), ("w-b", 1.0),
                           ("w-c", 2.0), ("w-d", 4.0)):
                agg._tombstones[iid] = {"role": "worker",
                                        "expired_mono": t}
            agg._compact_tombstones()
            left = set(agg._tombstones)
        assert left == {"w-a", "w-d"}                  # newest deaths stay

    def test_compaction_tiebreak_is_deterministic(self, agg, monkeypatch):
        monkeypatch.setattr(obs_fleet, "TOMBSTONE_LIMIT", 1)
        with agg._lock:
            # equal expiry: lexicographically smallest id evicted first
            for iid in ("w-z", "w-a", "w-m"):
                agg._tombstones[iid] = {"role": "worker",
                                        "expired_mono": 5.0}
            agg._compact_tombstones()
            left = set(agg._tombstones)
        assert left == {"w-z"}

    def test_confirm_drain_clears_record_and_tombstone(self, agg, events):
        agg.ingest(obs_fleet.build_push("w-gone", "worker", 1))
        assert "w-gone" in agg.routing_view()
        assert agg.confirm_drain("w-gone") is True
        view = agg.routing_view()
        assert "w-gone" not in view
        with agg._lock:
            assert "w-gone" not in agg._tombstones
        assert agg.confirm_drain("w-gone") is False    # idempotent
        assert len(events_of("fleet.drain_confirmed")) == 1

    def test_confirm_drain_clears_a_tombstone(self, agg):
        with agg._lock:
            agg._tombstones["w-stone"] = {"role": "worker",
                                          "expired_mono": 1.0}
        assert agg.confirm_drain("w-stone") is True
        with agg._lock:
            assert "w-stone" not in agg._tombstones


# --------------------------------------------------------------------------- #
# Controller
# --------------------------------------------------------------------------- #

class _FakeLauncher:
    """In-process 'subprocess': launches a real DisaggWorker."""

    def __init__(self, params, fail=False):
        self.params = params
        self.fail = fail
        self.live = {}
        self.terminated = []

    def launch(self):
        from nnstreamer_tpu_torch.fleet.controller import LaunchHandle

        if self.fail:
            raise RuntimeError("boom: worker crash-loop")
        w = disagg.DisaggWorker(mkeng(self.params))
        self.live[w.endpoint] = w
        return LaunchHandle(w.endpoint, 0, None)

    def terminate(self, handle):
        self.terminated.append(handle.endpoint)
        w = self.live.pop(handle.endpoint, None)
        if w is not None:
            w.stop()

    def stop_all(self):
        for w in list(self.live.values()):
            w.stop()
        self.live.clear()


class TestController:
    def test_scale_up_launches_and_routes(self, params, events,
                                          fleet_off_after):
        workers, router = mkfleet(params, 1)
        launcher = _FakeLauncher(params)
        clk = FakeClock()
        pol = AutoscalePolicy(1, 3, hysteresis=1, cooldown_s=0.0,
                              clock=clk)
        ctl = FleetController(router, pol, launcher=launcher, clock=clk)
        try:
            ctl.observe_occupancy("eng0", 0.95)        # up-pressure
            d = ctl.reconcile_once()
            assert d.action == "scale_up"
            assert ctl.stats["scale_up"] == 1
            eps = {be.endpoint for be in router.backends.backends()}
            assert len(eps) == 2
            # the new backend actually serves
            out = lm_dispatch(router, np.arange(10, dtype=np.int32) % V,
                              None, max_new=2)
            assert len(out) == 2
            assert any(a["action"] == "scale_up" for a in ctl.actions())
            assert len(events_of("fleet.scale_up")) == 1
        finally:
            stop_all(router, workers)
            launcher.stop_all()

    def test_scale_up_failure_journals_and_feeds_breaker(self, params,
                                                         fleet_off_after):
        workers, router = mkfleet(params, 1)
        clk = FakeClock()
        pol = AutoscalePolicy(1, 3, hysteresis=1, cooldown_s=0.0,
                              clock=clk)
        ctl = FleetController(router, pol,
                              launcher=_FakeLauncher(params, fail=True),
                              clock=clk)
        try:
            ctl.observe_occupancy("eng0", 0.95)
            for _ in range(ctl._breaker.failure_threshold):
                ctl.reconcile_once()
            acts = [a["action"] for a in ctl.actions()]
            assert acts.count("scale_up_failed") == \
                ctl._breaker.failure_threshold
            # breaker now open: the next tick skips without launching
            assert ctl._breaker.state == rp.OPEN
            ctl.reconcile_once()
            assert ctl.actions()[-1]["action"] == "scale_up_skipped"
            assert "breaker open" in ctl.actions()[-1]["reason"]
        finally:
            stop_all(router, workers)

    def test_scale_in_migrates_census_then_drains(self, params, agg,
                                                  events, fleet_off_after):
        workers, router = mkfleet(params, 3)
        for w in workers:
            w.push_fleet(agg)
        clk = FakeClock()
        pol = AutoscalePolicy(1, 3, hysteresis=1, cooldown_s=0.0,
                              clock=clk)
        ctl = FleetController(router, pol, aggregator=agg, clock=clk)
        try:
            prompt = np.arange(2 * PS + 3, dtype=np.int32) % V
            outs = {s: lm_dispatch(router, prompt, s)
                    for s in ("c-s0", "c-s1", "c-s2", "c-s3")}
            d = ctl.reconcile_once()                   # idle fleet: down
            assert d.action == "scale_in"
            active = [be for be in router.backends.backends()
                      if be.state == "active"]
            assert len(active) == 2
            # the drained instance was confirmed out of the aggregator
            assert len(agg.routing_view()) == 2
            # zero loss: every stream still answers, token-identical
            for s, first in outs.items():
                assert lm_dispatch(router, prompt, s) == first
            assert len(events_of("fleet.scale_in")) == 1
            entry = [a for a in ctl.actions()
                     if a["action"] == "scale_in"][0]
            assert entry["migrated"] + entry["absorbed"] >= 0
        finally:
            stop_all(router, workers)

    def test_victim_choice_is_deterministic(self, params, fleet_off_after):
        workers, router = mkfleet(params, 3)
        try:
            clk = FakeClock()
            pol = AutoscalePolicy(1, 3, hysteresis=1, cooldown_s=0.0,
                                  clock=clk)
            ctl = FleetController(router, pol, clock=clk)
            eps = sorted(w.endpoint for w in workers)
            # load two backends; the empty lexicographically-first one
            # must be the victim, every time
            router.backends.note_session("v-a", eps[1])
            router.backends.note_session("v-b", eps[2])
            active = [be for be in router.backends.backends()
                      if be.state == "active"]
            picks = {ctl._pick_victim(active).endpoint for _ in range(5)}
            assert picks == {eps[0]}
        finally:
            stop_all(router, workers)

    def test_snapshot_shape(self, params, fleet_off_after):
        workers, router = mkfleet(params, 1)
        try:
            clk = FakeClock()
            ctl = FleetController(
                router, AutoscalePolicy(1, 2, clock=clk), clock=clk)
            ctl.reconcile_once()
            snap = ctl.snapshot()
            assert snap["policy"] == "default"
            assert snap["min_replicas"] == 1
            assert snap["stats"]["ticks"] == 1
            assert isinstance(snap["actions"], list)
        finally:
            stop_all(router, workers)


# --------------------------------------------------------------------------- #
# Hook wiring: zero-overhead-when-off + journal federation
# --------------------------------------------------------------------------- #

class TestHookWiring:
    def test_hook_defaults_off(self):
        assert fleet.AUTOSCALE_HOOK is None
        assert obs_fleet.FLEET_ACTIONS_HOOK is None
        assert fleet.enabled() is False
        assert fleet.snapshot() is None

    def test_enable_installs_both_hooks(self, params, fleet_off_after):
        workers, router = mkfleet(params, 1)
        try:
            ctl = fleet.enable(router, 1, 2, clock=FakeClock())
            assert fleet.AUTOSCALE_HOOK is ctl
            assert obs_fleet.FLEET_ACTIONS_HOOK == ctl.actions
            # idempotent: a second enable returns the installed one
            assert fleet.enable(router, 1, 8) is ctl
            fleet.disable()
            assert fleet.AUTOSCALE_HOOK is None
            assert obs_fleet.FLEET_ACTIONS_HOOK is None
        finally:
            stop_all(router, workers)

    def test_journal_rides_push_docs(self, params, agg, fleet_off_after):
        workers, router = mkfleet(params, 1)
        try:
            ctl = fleet.enable(router, 1, 2, clock=FakeClock())
            ctl._journal_add("scale_up", "test entry", endpoint="x:1")
            doc = obs_fleet.build_push("w-journal", "worker", 1)
            assert doc["fleet_actions"][-1]["action"] == "scale_up"
            agg.ingest(doc)
            rolled = agg.actions_rollup()
            assert rolled["w-journal"][-1]["reason"] == "test entry"
        finally:
            stop_all(router, workers)

    def test_sched_occupancy_tap(self, params, fleet_off_after):
        """The sched/engine.py hook site: one attribute load, None test,
        then observe_occupancy lands in the controller's signal set."""
        workers, router = mkfleet(params, 1)
        try:
            ctl = fleet.enable(router, 1, 2, clock=FakeClock())
            hook = fleet.AUTOSCALE_HOOK
            assert hook is not None
            hook.observe_occupancy("dev0", 0.42)
            assert ctl.observe()["occupancy"] == pytest.approx(0.42)
        finally:
            stop_all(router, workers)


# --------------------------------------------------------------------------- #
# Launcher readiness gating
# --------------------------------------------------------------------------- #

_READY_WORKER = """
import http.server, sys, time
time.sleep(0.2)
port = int(sys.argv[1])
class H(http.server.BaseHTTPRequestHandler):
    def do_GET(self):
        self.send_response(200 if self.path == "/readyz" else 404)
        self.end_headers()
    def log_message(self, *a):
        pass
http.server.HTTPServer(("127.0.0.1", port), H).serve_forever()
"""


class TestLauncher:
    def test_launch_waits_for_readyz(self):
        launcher = BackendLauncher(
            [sys.executable, "-c", _READY_WORKER, "{ready_port}"],
            ready_timeout_s=10.0, poll_interval_s=0.05)
        handle = launcher.launch()
        try:
            assert handle.proc.poll() is None          # up and serving
        finally:
            launcher.terminate(handle)
        assert handle.proc.poll() is not None

    def test_early_exit_raises(self):
        launcher = BackendLauncher(
            [sys.executable, "-c", "import sys; sys.exit(3)"],
            ready_timeout_s=5.0, poll_interval_s=0.05)
        with pytest.raises(RuntimeError, match="rc=3"):
            launcher.launch()

    def test_never_ready_times_out(self):
        launcher = BackendLauncher(
            [sys.executable, "-c", "import time; time.sleep(60)"],
            ready_timeout_s=0.5, poll_interval_s=0.05)
        with pytest.raises(TimeoutError):
            launcher.launch()


# --------------------------------------------------------------------------- #
# /debug/fleet/actions
# --------------------------------------------------------------------------- #

class TestDebugRoute:
    def test_route_off_and_on(self, params, agg, fleet_off_after):
        workers, router = mkfleet(params, 1)
        try:
            with start_exporter(port=0,
                                registry=MetricsRegistry(enabled=True)
                                ) as exp:
                url = (f"http://127.0.0.1:{exp.port}"
                       f"/debug/fleet/actions")
                with urllib.request.urlopen(url, timeout=5) as r:
                    body = json.loads(r.read())
                assert body["enabled"] is False and body["local"] is None
                ctl = fleet.enable(router, 1, 2, clock=FakeClock())
                ctl.reconcile_once()
                with urllib.request.urlopen(url, timeout=5) as r:
                    body = json.loads(r.read())
                assert body["enabled"] is True
                assert body["local"]["stats"]["ticks"] == 1
                assert isinstance(body["fleet"], dict)
        finally:
            stop_all(router, workers)


# --------------------------------------------------------------------------- #
# Acceptance: halve the fleet under load, zero loss, SLO holds
# --------------------------------------------------------------------------- #

class TestAcceptance:
    N_SESSIONS = 6
    N_TURNS = 4
    GEN = 5

    def _prompts(self):
        rng = np.random.default_rng(11)
        return [rng.integers(0, V, 2 * PS + 4 + i).astype(np.int32)
                for i in range(self.N_SESSIONS)]

    def _run_turn(self, router, prompts, outputs, reg=None):
        for i, p in enumerate(prompts):
            sid = f"acc-s{i}"
            t0 = __import__("time").monotonic()
            toks = lm_dispatch(router, p, sid, max_new=self.GEN)
            if reg is not None:
                reg.record_outcome(
                    "streams", "met" if len(toks) == self.GEN
                    else "missed", __import__("time").monotonic() - t0)
            outputs.setdefault(sid, []).append(toks)

    def test_halving_under_chaos_keeps_streams_and_slo(
            self, params, agg, events, fleet_off_after, slo_off_after):
        prompts = self._prompts()

        # -- control: same load, fleet never touched ------------------
        workers, router = mkfleet(params, 4, name="acc-ctl")
        control = {}
        try:
            for _ in range(self.N_TURNS):
                self._run_turn(router, prompts, control)
        finally:
            stop_all(router, workers)

        # -- the run under test: 4 -> 2 mid-load ----------------------
        reg = obs_slo.enable()
        reg.set_objective("streams", goodput_ratio=0.9)
        workers, router = mkfleet(params, 4, name="acc-run")
        for w in workers:
            w.push_fleet(agg)
        clk = FakeClock()
        pol = AutoscalePolicy(2, 4, hysteresis=2, cooldown_s=10.0,
                              clock=clk)
        controller = FleetController(router, pol, aggregator=agg,
                                     clock=clk)
        outputs = {}
        try:
            self._run_turn(router, prompts, outputs, reg)
            # tick 1: idle fleet is down-pressure, hysteresis 1/2
            assert controller.reconcile_once().action == "hold"
            # tick 2: first scale-in, clean wire — pages migrate
            assert controller.reconcile_once().action == "scale_in"
            self._run_turn(router, prompts, outputs, reg)
            clk.advance(11.0)                          # clear cooldown
            # second scale-in under a seeded chaos partition of the
            # transfer wire: every shipment dies, every migration
            # must absorb — and no stream may die with it
            plan = chaos.FaultPlan(
                [chaos.Fault(kind="partition", target="send",
                             cmd="KV_PAGE_XFER", nth=1)], seed=7)
            controller.reconcile_once()                # hysteresis 1/2
            chaos.install(plan)
            try:
                assert controller.reconcile_once().action == "scale_in"
            finally:
                chaos.uninstall()
            for _ in range(self.N_TURNS - 2):
                self._run_turn(router, prompts, outputs, reg)

            # fleet really halved, and the policy floor holds
            active = [be for be in router.backends.backends()
                      if be.state == "active"]
            assert len(active) == 2
            clk.advance(11.0)
            for _ in range(4):
                d = controller.reconcile_once()
                assert d.action == "hold"              # at min_replicas
                clk.advance(11.0)

            # zero stream loss: every turn of every session completed
            for sid, turns in outputs.items():
                assert len(turns) == self.N_TURNS
                assert all(len(t) == self.GEN for t in turns)
            # token-identical to the unhalved control run — migration
            # (clean AND absorbed) never corrupted a stream
            assert outputs == control

            # SLO: burn under threshold on BOTH windows
            ev = reg.evaluate("streams")
            assert ev["breached"] is False
            assert ev["windows"]["fast"]["burn"]["goodput"] \
                < reg.burn_threshold
            assert ev["windows"]["slow"]["burn"]["goodput"] \
                < reg.burn_threshold
            assert ev["windows"]["fast"]["n"] == \
                self.N_SESSIONS * self.N_TURNS

            # both migration modes actually exercised
            assert controller.migrator.stats["migrated"] \
                + controller.migrator.stats["absorbed"] \
                == controller.stats["migrations"]
            assert len(events_of("fleet.scale_in")) == 2
            # drained instances confirmed out of the aggregator
            assert len(agg.routing_view()) == 2
        finally:
            stop_all(router, workers)

    def test_halving_schedule_is_deterministic(self, params, agg,
                                               fleet_off_after):
        """Same signals + same injected clock => the same action tape,
        run to run — the controller adds no hidden nondeterminism."""
        def tape():
            workers, router = mkfleet(params, 4, name="acc-det")
            clk = FakeClock()
            pol = AutoscalePolicy(2, 4, hysteresis=2, cooldown_s=10.0,
                                  clock=clk)
            ctl = FleetController(router, pol, clock=clk)
            acts = []
            try:
                for _ in range(8):
                    acts.append(ctl.reconcile_once().action)
                    clk.advance(6.0)
            finally:
                stop_all(router, workers)
            return acts

        t1, t2 = tape(), tape()
        assert t1 == t2
        assert t1.count("scale_in") == 2               # 4 -> 3 -> 2, floor
