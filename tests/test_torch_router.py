"""The port's query.router: every case of tests/test_router.py, run
against ``nnstreamer_tpu_torch`` on the CPU — endpoint parsing,
two-random-choice placement, the fleet aggregator's load signals
(routing view scalars, tombstones, stale instances, the shallow fleet
queue), session affinity (stability, minimal remap, spill-on-death),
graceful drain, endpoint-scoped chaos faults with the
latching ``partition`` kind, hedged dispatch (first response wins, the
loser's connection stays in protocol sync), deadline admission at the
router door, and the last-resort fallback when every backend is down.

E2E acceptance: three live backends, a seeded plan partitions one
mid-stream — the pipeline finishes with zero errored buffers, at least
one ``router.failover`` re-dispatch is recorded (event + counter), the
dead backend's breaker opens, and after the net heals routing resumes
onto it. With ``backends=`` unset no router object exists at all (the
zero-overhead contract). Each case runs under a timeout of its own
(SIGALRM) and leaves no fault plan or repo slot behind.
"""

import random
import signal
import socket
import time

import numpy as np
import pytest

from nnstreamer_tpu_torch.core import Buffer, Caps, TensorsConfig, TensorsInfo
from nnstreamer_tpu_torch.graph import Pipeline
from nnstreamer_tpu_torch.graph import element as gel
from nnstreamer_tpu_torch.graph.element import FlowReturn
from nnstreamer_tpu_torch.obs import events as obs_events
from nnstreamer_tpu_torch.obs import fleet as obs_fleet
from nnstreamer_tpu_torch.obs import health as obs_health
from nnstreamer_tpu_torch.query import protocol
from nnstreamer_tpu_torch.query import router as qrouter
from nnstreamer_tpu_torch.query.protocol import (
    Cmd,
    buffer_to_payload,
    payload_to_buffer,
)
from nnstreamer_tpu_torch.resilience import chaos, policy


#: each case's own limit, seconds
CASE_TIMEOUT_S = 90


@pytest.fixture(autouse=True)
def _case_guard():
    """A timeout of the case's own, and no chaos plan or repo slot left
    for the next case."""
    def expire(signum, frame):
        raise TimeoutError(f"case exceeded {CASE_TIMEOUT_S} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(CASE_TIMEOUT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
        from nnstreamer_tpu_torch.elements.repo import reset_repo

        chaos.uninstall()
        reset_repo()


def caps_of(dims, types, rate=30):
    return Caps.tensors(TensorsConfig(
        TensorsInfo.from_strings(dims, types), rate))


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def server_pipeline(port, sid=0):
    """One tensor_query server (x*10 filter). ``sid`` keys the
    serversrc/serversink pairing registry — every concurrently running
    server in one process needs its own id."""
    sp = Pipeline(f"server{sid}", device="cpu")
    ssrc = sp.add_new("tensor_query_serversrc", host="127.0.0.1",
                      port=port, id=sid, dims="4:1", types="float32")
    filt = sp.add_new("tensor_filter", model=lambda x: x * 10)
    ssink = sp.add_new("tensor_query_serversink", id=sid)
    Pipeline.link(ssrc, filt, ssink)
    return sp


@pytest.fixture
def metrics():
    from nnstreamer_tpu_torch.obs import metrics as obs_metrics
    reg = obs_metrics.registry()
    was = reg.is_enabled
    reg.enable()
    yield obs_metrics
    reg._enabled = was


@pytest.fixture
def events():
    ring = obs_events.ring()
    was = ring.is_enabled
    ring.reset()
    yield obs_events
    obs_events.disable()
    ring.reset()
    ring._enabled = was


@pytest.fixture
def health():
    reg = obs_health.registry()
    was = reg.is_enabled
    reg.reset()
    yield obs_health
    reg.reset()
    reg._enabled = was


def events_of(etype):
    return [e for e in obs_events.ring().snapshot() if e["type"] == etype]


def mkset(endpoints, owner, **kw):
    return qrouter.BackendSet(qrouter.parse_endpoints(endpoints),
                              owner=owner, **kw)


# --------------------------------------------------------------------------- #
# Endpoint parsing
# --------------------------------------------------------------------------- #

class TestParseEndpoints:
    def test_string_and_list_forms(self):
        assert qrouter.parse_endpoints("a:1, b:2 ,c:3") == \
            [("a", 1), ("b", 2), ("c", 3)]
        assert qrouter.parse_endpoints(["a:1", "b:2"]) == \
            [("a", 1), ("b", 2)]
        assert qrouter.parse_endpoints("a:1,") == [("a", 1)]

    def test_rejects_malformed(self):
        with pytest.raises(ValueError, match="host:port"):
            qrouter.parse_endpoints("justahost")
        with pytest.raises(ValueError, match="non-integer"):
            qrouter.parse_endpoints("a:http")
        with pytest.raises(ValueError, match="out of range"):
            qrouter.parse_endpoints("a:70000")
        with pytest.raises(ValueError, match="twice"):
            qrouter.parse_endpoints("a:1,a:1")

    def test_backend_set_needs_one(self):
        with pytest.raises(ValueError, match="at least one"):
            qrouter.BackendSet([], owner="empty")


# --------------------------------------------------------------------------- #
# Placement: two-choice, breakers, affinity, drain
# --------------------------------------------------------------------------- #

class TestPlacement:
    EPS = "127.0.0.1:9001,127.0.0.1:9002,127.0.0.1:9003"

    def test_two_choice_never_picks_the_loaded_backend(self):
        # both sampled candidates compare loads, so a backend carrying
        # in-flight work loses every pairing it appears in
        bs = mkset(self.EPS, "p2c", rng=random.Random(5))
        bs.get("127.0.0.1:9001").inflight = 5
        picks = [bs.pick().endpoint for _ in range(50)]
        assert "127.0.0.1:9001" not in picks
        assert set(picks) == {"127.0.0.1:9002", "127.0.0.1:9003"}

    def test_exclude_and_single_candidate(self):
        bs = mkset(self.EPS, "excl", rng=random.Random(0))
        only = bs.pick(exclude=frozenset(
            {"127.0.0.1:9001", "127.0.0.1:9002"}))
        assert only.endpoint == "127.0.0.1:9003"
        assert bs.pick(exclude=frozenset(
            {"127.0.0.1:9001", "127.0.0.1:9002",
             "127.0.0.1:9003"})) is None

    def test_open_breaker_removes_backend_from_placement(self):
        bs = mkset(self.EPS, "brk", breaker_threshold=1,
                   rng=random.Random(1))
        bs.get("127.0.0.1:9001").breaker.record_failure()
        assert all(bs.pick().endpoint != "127.0.0.1:9001"
                   for _ in range(30))
        for ep in ("127.0.0.1:9002", "127.0.0.1:9003"):
            bs.get(ep).breaker.record_failure()
        assert bs.pick() is None  # nothing routable: caller's fallback

    def test_affinity_is_stable_and_spreads_sessions(self):
        bs = mkset(self.EPS, "aff", rng=random.Random(2))
        homes = {f"s{i}": bs.pick(session=f"s{i}").endpoint
                 for i in range(120)}
        for s, home in homes.items():
            assert all(bs.pick(session=s).endpoint == home
                       for _ in range(5))
        assert len(set(homes.values())) == 3  # not all piled on one

    def test_affinity_remap_on_add_is_bounded(self):
        bs = mkset(self.EPS, "remap", rng=random.Random(3))
        before = {f"s{i}": bs.pick(session=f"s{i}").endpoint
                  for i in range(300)}
        bs.add("127.0.0.1:9004")
        after = {s: bs.pick(session=s).endpoint for s in before}
        moved = sum(1 for s in before if before[s] != after[s])
        # consistent hashing: adding 1 of 4 remaps ~1/4 of sessions,
        # never the wholesale reshuffle a modulo hash would cause
        assert 0 < moved < 150
        assert all(after[s] == "127.0.0.1:9004"
                   for s in before if before[s] != after[s])

    def test_affinity_spills_with_event_when_home_dies(self, events):
        # an UNPLANNED death (breaker open) spills loudly — the remote
        # prefix cache is lost; a planned drain remaps silently via the
        # ring rebuild instead (no false alarms on scale-down)
        events.enable()
        bs = mkset(self.EPS, "spill", breaker_threshold=1,
                   rng=random.Random(4))
        sess = next(f"s{i}" for i in range(200)
                    if bs.pick(session=f"s{i}").endpoint
                    == "127.0.0.1:9001")
        bs.get("127.0.0.1:9001").breaker.record_failure()
        got = bs.pick(session=sess)
        assert got is not None and got.endpoint != "127.0.0.1:9001"
        spills = events_of("router.spill")
        assert spills and spills[0]["attrs"]["backend"] == "127.0.0.1:9001"

    def test_drain_and_remove_lifecycle(self, events):
        events.enable()
        bs = mkset(self.EPS, "drain")
        bs.drain("127.0.0.1:9001")
        # idle at drain time: reaped (closed) immediately, never placed
        assert bs.get("127.0.0.1:9001").state == qrouter.CLOSED
        assert all(bs.pick().endpoint != "127.0.0.1:9001"
                   for _ in range(30))
        bs.remove("127.0.0.1:9001")
        assert len(bs) == 2 and bs.get("127.0.0.1:9001") is None
        for et in ("router.drain", "router.backend_closed",
                   "router.backend_remove"):
            assert events_of(et), f"missing {et}"

    def test_duplicate_add_rejected(self):
        bs = mkset(self.EPS, "dup")
        with pytest.raises(ValueError, match="already"):
            bs.add("127.0.0.1:9001")


class TestFleetSignals:
    def _doc(self, iid, depth=None, ready=True, seq=1):
        doc = {"instance": iid, "seq": seq, "role": "worker",
               "ready": {"ready": ready}}
        if depth is not None:
            doc["metrics"] = {"nnstpu_serving_queue_depth": {
                "type": "gauge", "help": "",
                "series": [{"labels": {}, "value": float(depth)}]}}
        return doc

    def test_routing_view_scalars_and_tombstones(self):
        agg = obs_fleet.FleetAggregator(ttl_s=30.0, expire_after_s=0.15,
                                        instance="agg-test")
        agg.ingest(self._doc("w1", depth=3.0), via="test")
        agg.ingest(self._doc("w2", ready=False), via="test")
        view = agg.routing_view()
        assert view["w1"]["routable"] and view["w1"]["queue_depth"] == 3.0
        assert not view["w2"]["routable"]  # self-reported not ready
        assert agg.snapshot()["instances"][0]["queue_depth"] == 3.0
        time.sleep(0.2)  # past expire_after_s: both expire
        view = agg.routing_view()
        # expiry leaves tombstones, not silence: "known dead", with a
        # queue depth no placement comparison can ever prefer
        for iid in ("w1", "w2"):
            assert view[iid]["expired"] and not view[iid]["routable"]
            assert view[iid]["queue_depth"] == float("inf")
        assert sorted(agg.snapshot()["expired"]) == ["w1", "w2"]
        agg.ingest(self._doc("w1", depth=0.0, seq=2), via="test")
        view = agg.routing_view()  # a returning instance sheds its stone
        assert view["w1"]["routable"] and "expired" not in view["w1"]
        assert agg.snapshot()["expired"] == ["w2"]

    def test_stale_instance_not_routable_but_present(self):
        agg = obs_fleet.FleetAggregator(ttl_s=0.05, expire_after_s=60.0,
                                        instance="agg-stale")
        agg.ingest(self._doc("w1", depth=1.0), via="test")
        time.sleep(0.1)  # past ttl, before expiry
        view = agg.routing_view()
        assert view["w1"]["stale"] and not view["w1"]["routable"]
        assert "expired" not in view["w1"]

    def test_pick_prefers_the_shallow_fleet_queue(self, monkeypatch):
        agg = obs_fleet.FleetAggregator(ttl_s=30.0, expire_after_s=60.0,
                                        instance="agg-place")
        agg.ingest(self._doc("w1", depth=50.0), via="test")
        agg.ingest(self._doc("w2", depth=0.0), via="test")
        monkeypatch.setattr(obs_fleet, "_AGGREGATOR", agg)
        bs = mkset("127.0.0.1:9101,127.0.0.1:9102", "fleetp",
                   rng=random.Random(6))
        bs.get("127.0.0.1:9101").instance = "w1"
        bs.get("127.0.0.1:9102").instance = "w2"
        assert all(bs.pick().endpoint == "127.0.0.1:9102"
                   for _ in range(20))
        # w2 stops reporting ready: inf load flips the preference
        agg.ingest(self._doc("w2", ready=False, seq=2), via="test")
        assert all(bs.pick().endpoint == "127.0.0.1:9101"
                   for _ in range(20))


# --------------------------------------------------------------------------- #
# Endpoint-scoped chaos + the partition fault
# --------------------------------------------------------------------------- #

class TestChaosEndpoint:
    E = "10.0.0.1:5001"

    def test_endpoint_selector_scopes_the_counter(self):
        plan = chaos.FaultPlan(
            [chaos.Fault(kind="drop", target="send", cmd="DATA",
                         endpoint=self.E, nth=1)], seed=0)
        # traffic to OTHER peers neither fires nor advances the count
        assert plan.decide("send", "DATA", endpoint="10.0.0.2:5001") == []
        assert plan.decide("send", "DATA", endpoint=None) == []
        hits = plan.decide("send", "DATA", endpoint=self.E)
        assert [f.kind for f in hits] == ["drop"]
        assert plan.fired[0]["endpoint"] == self.E

    def test_partition_latches_until_heal(self):
        plan = chaos.FaultPlan(
            [chaos.Fault(kind="partition", target="send", cmd="DATA",
                         endpoint=self.E, nth=2)], seed=0)
        assert plan.decide("send", "DATA", endpoint=self.E) == []  # n=1
        assert plan.decide("send", "DATA", endpoint=self.E) != []  # latch
        for _ in range(5):  # every later matching frame keeps dying
            assert plan.decide("send", "DATA", endpoint=self.E) != []
        assert plan.decide("send", "DATA",
                           endpoint="10.0.0.2:5001") == []  # one side only
        assert len(plan.fired) == 1  # audited once, at the latch
        plan.heal()
        assert plan.decide("send", "DATA", endpoint=self.E) == []

    def test_wire_hook_partition_raises_with_single_event(self, events):
        events.enable()
        plan = chaos.FaultPlan(
            [chaos.Fault(kind="partition", target="send", cmd="DATA",
                         endpoint=self.E, nth=1)], seed=0)
        chaos.install(plan)
        try:
            for _ in range(3):
                with pytest.raises(ConnectionError, match="partition"):
                    chaos._wire_hook("send", Cmd.DATA, {}, b"x", self.E)
            # untargeted traffic flows
            assert chaos._wire_hook("send", Cmd.DATA, {}, b"x",
                                    "10.0.0.2:1") == b"x"
        finally:
            chaos.uninstall()
        assert len(events_of("chaos.inject")) == 1  # latch, not per frame

    def test_from_spec_accepts_endpoint(self):
        plan = chaos.FaultPlan.from_spec({"seed": 1, "faults": [
            {"kind": "partition", "target": "send", "cmd": "DATA",
             "endpoint": self.E, "nth": 1}]})
        assert plan.faults[0].endpoint == self.E


# --------------------------------------------------------------------------- #
# Router dispatch units (no live servers)
# --------------------------------------------------------------------------- #

class TestDispatchUnits:
    def test_expired_deadline_shed_at_the_door(self, events):
        events.enable()
        bs = mkset(f"127.0.0.1:{free_port()}", "shed-unit")
        r = qrouter.QueryRouter(bs, "shed-unit")
        with pytest.raises(qrouter._ShedSignal):
            r.dispatch({}, b"", deadline=policy.Deadline.after_ms(0))
        shed = events_of("resilience.shed")
        assert shed and shed[0]["attrs"]["site"] == "router"

    def test_all_backends_down_raises_router_error(self):
        bs = mkset(f"127.0.0.1:{free_port()},127.0.0.1:{free_port()}",
                   "down-unit", timeout_s=0.3)
        r = qrouter.QueryRouter(
            bs, "down-unit", max_request_retry=2,
            retry_policy=policy.RetryPolicy(base_s=0.001, max_s=0.002))
        with pytest.raises(qrouter.RouterError):
            r.dispatch({}, b"\x00")

    def test_add_refused_while_draining(self):
        bs = mkset(f"127.0.0.1:{free_port()}", "drain-unit")
        r = qrouter.QueryRouter(bs, "drain-unit")
        r.draining = True
        with pytest.raises(RuntimeError, match="draining"):
            r.add_backend("127.0.0.1:9999")
        assert len(r.backends) == 1

    def test_hedge_delay_floors_at_prop_until_enough_samples(self):
        bs = mkset(f"127.0.0.1:{free_port()}", "hd-unit")
        r = qrouter.QueryRouter(bs, "hd-unit", hedge_ms=25.0)
        assert r.hedge_delay_s() == pytest.approx(0.025)
        for _ in range(30):
            r._observe_latency(0.004)
        r._observe_latency(0.9)  # one outlier can't drag P95 that far
        assert r.hedge_delay_s() == pytest.approx(0.025)
        for _ in range(40):
            r._observe_latency(0.2)  # now P95 genuinely above the floor
        assert r.hedge_delay_s() > 0.025

    def test_auto_hedge_arms_from_observed_p95(self, tmp_path):
        """With no manual --hedge-ms, the autotuner hook arms hedging
        once the latency window holds >= 20 samples; tune off (or too
        few samples) keeps the plain single-dispatch path."""
        from nnstreamer_tpu_torch import tune

        bs = mkset(f"127.0.0.1:{free_port()},127.0.0.1:{free_port()}",
                   "ah-unit")
        r = qrouter.QueryRouter(bs, "ah-unit")  # hedge_ms defaults to 0
        calls = {"direct": 0, "hedged": 0}
        be = r.backends.backends()[0]
        be.request = lambda meta, payload, caps: (
            calls.__setitem__("direct", calls["direct"] + 1)
            or ({"ok": 1}, b""))
        r._hedged = lambda *a, **k: (
            calls.__setitem__("hedged", calls["hedged"] + 1)
            or ({"ok": 1}, b""))
        try:
            assert tune.TUNE_HOOK is None
            r._attempt(be, {}, b"", None, None, set())
            assert calls == {"direct": 1, "hedged": 0}  # tune off

            tune.enable(str(tmp_path / "s.json"), fit_from_profiler=False)
            r._attempt(be, {}, b"", None, None, set())
            assert calls == {"direct": 2, "hedged": 0}  # < 20 samples

            for _ in range(25):
                r._observe_latency(0.004)
            r._attempt(be, {}, b"", None, None, set())
            assert calls == {"direct": 2, "hedged": 1}  # armed

            tune.tuner().auto_hedge = False  # explicit opt-out respected
            r._attempt(be, {}, b"", None, None, set())
            assert calls == {"direct": 3, "hedged": 1}
        finally:
            tune.disable(save=False)


# --------------------------------------------------------------------------- #
# Drain-never-dials (client) + zero-overhead contract
# --------------------------------------------------------------------------- #

class TestClientContracts:
    def test_eos_drain_refuses_to_dial(self):
        qc = gel.make_element("tensor_query_client", port=free_port())
        qc._draining = True
        with pytest.raises(ConnectionError, match="draining"):
            qc._connect()

    def test_on_eos_blocks_dials_and_router_growth(self):
        # the old drain/reconnect race: during the EOS drain nothing may
        # open a connection, and the router may not grow membership
        qc = gel.make_element(
            "tensor_query_client",
            backends=f"127.0.0.1:{free_port()}", drain_timeout_s=0.1)
        qc.start()
        try:
            seen = {}

            def spy(timeout=None):
                seen["draining"] = qc._draining
                with pytest.raises(ConnectionError, match="draining"):
                    qc._connect()
                with pytest.raises(RuntimeError, match="draining"):
                    qc.router.add_backend("127.0.0.1:9999")

            qc._drain_pending = spy
            qc.on_eos()
            assert seen["draining"] is True
            assert qc._draining is False  # reset once the drain is over
        finally:
            qc.stop()

    def test_no_backends_means_no_router_object(self):
        # the zero-overhead contract: unset ⇒ chain() pays one is-None
        # check; there is no router to consult, no routed state at all
        qc = gel.make_element("tensor_query_client", port=free_port())
        qc.start()
        try:
            assert qc._router is None and qc.router is None
        finally:
            qc.stop()

    def test_stop_tears_down_router_start_rebuilds(self):
        eps = f"127.0.0.1:{free_port()},127.0.0.1:{free_port()}"
        qc = gel.make_element("tensor_query_client", backends=eps)
        qc.start()
        first = qc.router
        assert first is not None and len(first.backends) == 2
        qc.stop()
        assert qc.router is None
        for be in first.backends.backends():
            assert be.state == qrouter.CLOSED
        qc.start()
        try:
            assert qc.router is not None and qc.router is not first
        finally:
            qc.stop()


# --------------------------------------------------------------------------- #
# E2E: routed offload, failover acceptance, hedging, last resort
# --------------------------------------------------------------------------- #

class TestRoutedEndToEnd:
    def _drive(self, qc, sink, frames, start_offset=0):
        for i, arr in enumerate(frames):
            buf = Buffer.of(arr)
            buf.offset = start_offset + i
            assert qc._chain_entry(qc.sink_pad, buf) == FlowReturn.OK

    def test_routed_offload_spreads_across_backends(self):
        ports = [free_port() for _ in range(2)]
        pipes = [server_pipeline(p, sid=i) for i, p in enumerate(ports)]
        for sp in pipes:
            sp.start()
        qc = gel.make_element(
            "tensor_query_client", timeout_s=2.0,
            backends=",".join(f"127.0.0.1:{p}" for p in ports))
        sink = gel.make_element("tensor_sink", store=True)
        qc.src_pads[0].link(sink.sink_pads[0])
        try:
            time.sleep(0.2)
            sink.start()
            qc.start()
            qc.router.backends._rng = random.Random(7)
            qc.on_caps(qc.sink_pad, caps_of("4:1", "float32"))
            frames = [np.full((1, 4), i, np.float32) for i in range(10)]
            self._drive(qc, sink, frames)
            assert sink.num_buffers == 10
            for i, out in enumerate(sink.buffers):
                np.testing.assert_array_equal(out.memories[0].host(),
                                              frames[i] * 10)
                assert out.offset == i
            snap = qc.router.snapshot()
            served = {b["endpoint"]: b["dispatched"]
                      for b in snap["backends"]}
            assert sum(served.values()) == 10
            assert all(n > 0 for n in served.values())  # genuine spread
        finally:
            qc.stop()
            for sp in pipes:
                sp.stop()

    def test_single_backend_list_routes_fine(self):
        port = free_port()
        sp = server_pipeline(port, sid=0)
        sp.start()
        qc = gel.make_element("tensor_query_client", timeout_s=2.0,
                              backends=[f"127.0.0.1:{port}"])
        sink = gel.make_element("tensor_sink", store=True)
        qc.src_pads[0].link(sink.sink_pads[0])
        try:
            time.sleep(0.2)
            sink.start()
            qc.start()
            qc.on_caps(qc.sink_pad, caps_of("4:1", "float32"))
            frames = [np.full((1, 4), i, np.float32) for i in range(3)]
            self._drive(qc, sink, frames)
            assert sink.num_buffers == 3
            np.testing.assert_array_equal(
                sink.buffers[2].memories[0].host(), frames[2] * 10)
        finally:
            qc.stop()
            sp.stop()

    @pytest.mark.chaos
    def test_partition_failover_breaker_and_recovery(self, events,
                                                     metrics):
        """The acceptance run: 3 backends, a seeded plan partitions one
        mid-stream. Zero errored buffers, every frame delivered with the
        right result, >=1 failover re-dispatch (event + counter), the
        dead backend's breaker opens, and routing resumes onto it after
        the net heals and the breaker's half-open probe succeeds."""
        events.enable()
        ports = [free_port() for _ in range(3)]
        eps = [f"127.0.0.1:{p}" for p in ports]
        pipes = [server_pipeline(p, sid=i) for i, p in enumerate(ports)]
        for sp in pipes:
            sp.start()
        qc = gel.make_element(
            "tensor_query_client", backends=",".join(eps),
            max_request_retry=4, timeout_s=2.0, retry_base_s=0.01,
            retry_max_s=0.05, breaker_threshold=1, breaker_reset_s=0.3)
        sink = gel.make_element("tensor_sink", store=True)
        qc.src_pads[0].link(sink.sink_pads[0])
        fail_before = qrouter._FAILOVER_TOTAL.labels(qc.name).value
        plan = chaos.FaultPlan(
            [chaos.Fault(kind="partition", target="send", cmd="DATA",
                         endpoint=eps[0], nth=1)], seed=11)
        try:
            time.sleep(0.2)
            sink.start()
            qc.start()
            qc.router.backends._rng = random.Random(7)
            qc.on_caps(qc.sink_pad, caps_of("4:1", "float32"))
            frames = [np.full((1, 4), i, np.float32) for i in range(18)]
            self._drive(qc, sink, frames[:6])  # healthy warm-up
            chaos.install(plan)  # eps[0] black-holes from its next DATA
            self._drive(qc, sink, frames[6:12], start_offset=6)
            dead = qc.router.backends.get(eps[0])
            assert plan.fired, "seeded plan never latched the partition"
            assert dead.breaker.state == policy.OPEN
            fovers = events_of("router.failover")
            assert fovers and all(
                e["attrs"]["backend"] != eps[0] for e in fovers)
            assert qrouter._FAILOVER_TOTAL.labels(qc.name).value \
                > fail_before
            served_dead = dead.dispatched
            plan.heal()  # the "restart": the net comes back
            time.sleep(0.35)  # past breaker_reset_s: half-open probe due
            self._drive(qc, sink, frames[12:], start_offset=12)
            assert dead.dispatched > served_dead  # probe landed + closed
            assert sink.num_buffers == 18  # zero errored/lost buffers
            for i, out in enumerate(sink.buffers):
                np.testing.assert_array_equal(out.memories[0].host(),
                                              frames[i] * 10)
                assert out.offset == i
        finally:
            chaos.uninstall()
            qc.stop()
            for sp in pipes:
                sp.stop()

    @pytest.mark.chaos
    def test_hedged_dispatch_first_response_wins(self, events):
        """A delay fault makes one backend the slow primary; the hedge
        fires after the configured floor and the fast peer's response
        wins, while the slow round trip completes in the background and
        leaves its connection in protocol sync."""
        events.enable()
        ports = [free_port() for _ in range(2)]
        eps = [f"127.0.0.1:{p}" for p in ports]
        pipes = [server_pipeline(p, sid=i) for i, p in enumerate(ports)]
        for sp in pipes:
            sp.start()
        bs = mkset(",".join(eps), "hedge-e2e", timeout_s=2.0)
        r = qrouter.QueryRouter(bs, "hedge-e2e", hedge_ms=50.0)
        r.set_caps_provider(lambda: str(caps_of("4:1", "float32")))
        plan = chaos.FaultPlan(
            [chaos.Fault(kind="delay", target="send", cmd="DATA",
                         endpoint=eps[0], p=1.0, delay_s=0.6)], seed=2)
        try:
            time.sleep(0.2)
            slow = bs.get(eps[0])
            meta, payload = buffer_to_payload(
                Buffer.of(np.full((1, 4), 3.0, np.float32)))
            chaos.install(plan)
            t0 = time.monotonic()
            rmeta, rpayload = r._attempt(slow, meta, payload, None,
                                         None, set())
            elapsed = time.monotonic() - t0
            assert elapsed < 0.5  # the 0.6s primary did NOT gate us
            out = payload_to_buffer(rmeta, rpayload)
            np.testing.assert_array_equal(
                out.memories[0].host(), np.full((1, 4), 30.0, np.float32))
            hedges = events_of("resilience.hedge")
            assert hedges and hedges[0]["attrs"]["backend"] == eps[1]
            # let the loser's delayed round trip finish in background...
            t1 = time.monotonic()
            while slow.inflight > 0 and time.monotonic() - t1 < 3.0:
                time.sleep(0.02)
            assert slow.inflight == 0
            chaos.uninstall()
            # ...then prove its connection is still in protocol sync
            rmeta2, rpayload2 = slow.request(meta, payload,
                                             str(caps_of("4:1", "float32")))
            out2 = payload_to_buffer(rmeta2, rpayload2)
            np.testing.assert_array_equal(
                out2.memories[0].host(),
                np.full((1, 4), 30.0, np.float32))
        finally:
            chaos.uninstall()
            r.close()
            for sp in pipes:
                sp.stop()

    def test_live_add_and_drain_reroutes(self, events):
        events.enable()
        ports = [free_port() for _ in range(2)]
        eps = [f"127.0.0.1:{p}" for p in ports]
        pipes = [server_pipeline(p, sid=i) for i, p in enumerate(ports)]
        pipes[0].start()
        bs = mkset(eps[0], "liveadd", timeout_s=2.0)
        r = qrouter.QueryRouter(bs, "liveadd")
        r.set_caps_provider(lambda: str(caps_of("4:1", "float32")))
        try:
            time.sleep(0.2)
            meta, payload = buffer_to_payload(
                Buffer.of(np.full((1, 4), 2.0, np.float32)))
            r.dispatch(meta, payload)
            pipes[1].start()
            time.sleep(0.2)
            r.add_backend(eps[1])  # scale up: placeable immediately
            r.drain_backend(eps[0])  # scale down: idle -> closed now
            assert bs.get(eps[0]).state == qrouter.CLOSED
            for _ in range(3):
                rmeta, rpayload = r.dispatch(meta, payload)
            out = payload_to_buffer(rmeta, rpayload)
            np.testing.assert_array_equal(
                out.memories[0].host(), np.full((1, 4), 20.0, np.float32))
            assert bs.get(eps[1]).dispatched == 3  # all post-drain traffic
            assert events_of("router.backend_add")
            assert events_of("router.drain")
        finally:
            r.close()
            for sp in pipes:
                sp.stop()

    def test_all_backends_down_takes_local_fallback(self, events, health):
        """Last resort: every backend dead routes into the client's
        existing fallback= path — the pipeline COMPLETES and health
        reports DEGRADED, not failed."""
        events.enable()
        health.enable()
        eps = f"127.0.0.1:{free_port()},127.0.0.1:{free_port()}"
        cp = Pipeline("routed-fb", device="cpu")
        frames = [np.full((1, 4), i, np.float32) for i in range(4)]
        src = cp.add_new("appsrc", caps=caps_of("4:1", "float32"),
                         data=frames)
        qc = cp.add_new("tensor_query_client", backends=eps,
                        max_request_retry=2, timeout_s=0.3,
                        retry_base_s=0.001, retry_max_s=0.002,
                        breaker_threshold=1, breaker_reset_s=600.0,
                        fallback="passthrough")
        sink = cp.add_new("tensor_sink", store=True)
        Pipeline.link(src, qc, sink)
        cp.run(timeout=60)  # degradation, not a pipeline error
        assert sink.num_buffers == 4
        for i, out in enumerate(sink.buffers):
            np.testing.assert_array_equal(out.memories[0].host(),
                                          frames[i])
        assert events_of("resilience.fallback")
        snap = obs_health.snapshot()
        comp = next(c for c in snap["components"]
                    if c["name"] == f"query.client:{qc.name}")
        assert comp["status"] == "degraded"
        assert snap["ok"] is True
