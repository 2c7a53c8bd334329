"""The port's resilience layer: every case of tests/test_resilience.py,
run against ``nnstreamer_tpu_torch`` on the CPU (the LM engine's params
are the JAX case's seeded tree, carried over by ``models.convert``). Each
case runs under a timeout of its own (SIGALRM) and leaves no fault plan or
repo slot behind.

Resilience layer tests — retry backoff + shared budgets, the circuit
breaker transition machine (injectable clock, no sleeping), deadline
wire semantics + load shedding (client-side and LMEngine admission),
fallback routing with DEGRADED health, thread-leak visibility, the EOS
drain budget, and the deterministic chaos harness (same seed ⇒ same
schedule; zero-overhead hooks when off). E2E acceptance: a server
killed and restarted mid-stream, a breaker-open run on a dead port
completing through the fallback, and a full offload run under a fault
plan with drops + a forced disconnect.
"""

import random
import signal
import socket
import threading
import time

import numpy as np
import pytest

from nnstreamer_tpu_torch.core import Buffer, Caps, TensorsConfig, TensorsInfo
from nnstreamer_tpu_torch.graph import Pipeline
from nnstreamer_tpu_torch.graph import element as gel
from nnstreamer_tpu_torch.graph.element import FlowReturn
from nnstreamer_tpu_torch.obs import events as obs_events
from nnstreamer_tpu_torch.obs import health as obs_health
from nnstreamer_tpu_torch.query import protocol
from nnstreamer_tpu_torch.query.client import TensorQueryClient
from nnstreamer_tpu_torch.query.protocol import Cmd
from nnstreamer_tpu_torch.resilience import chaos, policy
from nnstreamer_tpu_torch.serving.lm_engine import LMEngine

V, D, H, L, MAXLEN = 97, 32, 4, 2, 64

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


@pytest.fixture(scope="module")
def lm_params():
    """The JAX case's seeded tree, as the port's tensors on the CPU."""
    import jax

    from nnstreamer_tpu.models import causal_lm
    from nnstreamer_tpu_torch.models import convert

    tree = causal_lm.init_causal_lm(jax.random.PRNGKey(7), V, D, H, L, MAXLEN)
    return convert.causal_lm_params(jax.tree_util.tree_map(np.asarray, tree),
                                    "cpu")


def caps_of(dims, types, rate=30):
    return Caps.tensors(TensorsConfig(
        TensorsInfo.from_strings(dims, types), rate))


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def server_pipeline(port):
    sp = Pipeline("server", device="cpu")
    ssrc = sp.add_new("tensor_query_serversrc", host="127.0.0.1",
                      port=port, id=0, dims="4:1", types="float32")
    filt = sp.add_new("tensor_filter", model=lambda x: x * 10)
    ssink = sp.add_new("tensor_query_serversink", id=0)
    Pipeline.link(ssrc, filt, ssink)
    return sp


_THRESHOLDS = ("stall_after_s", "queue_dwell_s", "reconnect_storm",
               "reconnect_window_s", "admission_deadline_s", "interval_s")


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
    yield obs_events
    obs_events.disable()
    ring.reset()
    ring._enabled = was


def events_of(etype):
    return [e for e in obs_events.ring().snapshot() if e["type"] == etype]


# --------------------------------------------------------------------------- #
# Retry policy + budget
# --------------------------------------------------------------------------- #

class TestRetry:
    def test_cap_grows_exponentially_to_ceiling(self):
        pol = policy.RetryPolicy(base_s=0.05, max_s=0.4, multiplier=2.0)
        assert pol.cap(0) == pytest.approx(0.05)
        assert pol.cap(1) == pytest.approx(0.1)
        assert pol.cap(2) == pytest.approx(0.2)
        assert pol.cap(3) == pytest.approx(0.4)
        assert pol.cap(10) == pytest.approx(0.4)  # ceiling holds
        assert pol.cap(-3) == pytest.approx(0.05)  # clamped, not tiny

    def test_full_jitter_stays_within_window(self):
        pol = policy.RetryPolicy(base_s=0.05, max_s=0.4,
                                 rng=random.Random(3))
        for attempt in range(10):
            for _ in range(20):
                d = pol.delay(attempt)
                assert 0.0 <= d <= pol.cap(attempt)

    def test_seeded_rng_is_deterministic(self):
        a = policy.RetryPolicy(rng=random.Random(11))
        b = policy.RetryPolicy(rng=random.Random(11))
        assert [a.delay(i) for i in range(8)] == \
               [b.delay(i) for i in range(8)]

    def test_jitter_off_returns_exact_cap(self):
        pol = policy.RetryPolicy(base_s=0.1, max_s=1.0, jitter=False)
        assert pol.delay(2) == pol.cap(2)

    def test_invalid_parameters_rejected(self):
        with pytest.raises(ValueError):
            policy.RetryPolicy(base_s=0.0)
        with pytest.raises(ValueError):
            policy.RetryPolicy(multiplier=0.5)

    def test_budget_shared_across_nested_loops(self):
        # the retry² collapse: two loops drawing from ONE pool can never
        # exceed the pool size combined
        budget = policy.RetryBudget(3)
        attempts = 0
        while budget.take():  # "outer" loop
            attempts += 1
            if budget.take():  # "inner" loop draws from the same pool
                attempts += 1
        assert attempts == 3
        assert budget.exhausted and budget.remaining == 0
        assert not budget.take()

    def test_budget_floor_is_one_attempt(self):
        assert policy.RetryBudget(0).attempts == 1
        assert policy.RetryBudget(-5).take()


# --------------------------------------------------------------------------- #
# Circuit breaker
# --------------------------------------------------------------------------- #

class TestCircuitBreaker:
    def test_full_transition_sequence(self, events):
        events.enable()
        now = [100.0]
        b = policy.CircuitBreaker("t.seq", failure_threshold=3,
                                  reset_s=10.0, clock=lambda: now[0])
        assert b.state == policy.CLOSED and b.allow()
        b.record_failure()
        b.record_failure()
        assert b.state == policy.CLOSED  # below threshold
        b.record_failure()
        assert b.state == policy.OPEN
        assert not b.allow()  # cooldown running
        now[0] += 9.9
        assert not b.allow()
        now[0] += 0.2  # cooldown elapsed
        assert b.allow()  # the half-open probe
        assert b.state == policy.HALF_OPEN
        assert not b.allow()  # probe quota (1) spent
        b.record_success()
        assert b.state == policy.CLOSED and b.allow()
        types = [e["type"] for e in obs_events.ring().snapshot()]
        assert "resilience.breaker_open" in types
        assert "resilience.breaker_half_open" in types
        assert "resilience.breaker_close" in types

    def test_half_open_failure_reopens_and_restarts_cooldown(self):
        now = [0.0]
        b = policy.CircuitBreaker("t.reopen", failure_threshold=1,
                                  reset_s=5.0, clock=lambda: now[0])
        b.record_failure()
        assert b.state == policy.OPEN
        now[0] = 5.1
        assert b.allow()
        b.record_failure()  # probe failed
        assert b.state == policy.OPEN
        now[0] = 10.0  # only 4.9s into the NEW cooldown
        assert not b.allow()
        now[0] = 10.3
        assert b.allow()

    def test_success_resets_consecutive_failure_count(self):
        b = policy.CircuitBreaker("t.reset", failure_threshold=2)
        b.record_failure()
        b.record_success()
        b.record_failure()
        assert b.state == policy.CLOSED  # never 2 CONSECUTIVE failures

    def test_multiple_probes_quota(self):
        now = [0.0]
        b = policy.CircuitBreaker("t.probes", failure_threshold=1,
                                  reset_s=1.0, half_open_probes=2,
                                  clock=lambda: now[0])
        b.record_failure()
        now[0] = 1.5
        assert b.allow() and b.allow()
        assert not b.allow()

    def test_invalid_parameters_rejected(self):
        with pytest.raises(ValueError):
            policy.CircuitBreaker("t.bad", failure_threshold=0)


# --------------------------------------------------------------------------- #
# Deadlines
# --------------------------------------------------------------------------- #

class TestDeadline:
    def test_expiry_and_remaining(self):
        d = policy.Deadline.after_s(60)
        assert not d.expired()
        assert 59.0 < d.remaining_s() <= 60.0
        assert policy.Deadline.after_ms(0).expired()
        assert policy.Deadline.after_ms(-50).expired()

    def test_wire_roundtrip_carries_remaining_budget(self):
        d = policy.Deadline.after_ms(80)
        w = d.to_wire()
        assert 0.0 < w <= 80.0  # remaining ms, not an absolute stamp
        d2 = policy.Deadline.from_wire(w)
        assert abs(d2.remaining_s() - d.remaining_s()) < 0.05

    def test_expired_deadline_encodes_zero(self):
        assert policy.Deadline.after_ms(-100).to_wire() == 0.0

    def test_from_wire_rejects_garbage(self):
        assert policy.Deadline.from_wire("junk") is None
        assert policy.Deadline.from_wire(None) is None
        assert policy.Deadline.from_wire("25.0") is not None

    def test_buffer_meta_helpers(self):
        buf = Buffer.of(np.zeros((1, 4), np.float32))
        assert policy.deadline_of(buf) is None
        d = policy.Deadline.after_s(1)
        policy.set_deadline(buf, d)
        assert policy.deadline_of(buf) is d
        buf.meta[policy.DEADLINE_META_KEY] = "not-a-deadline"
        assert policy.deadline_of(buf) is None


# --------------------------------------------------------------------------- #
# Client-side shedding + EOS drain budget
# --------------------------------------------------------------------------- #

class TestClientShedAndDrain:
    def test_expired_buffer_shed_before_send(self, events):
        # legal drop: OK without pushing, no socket ever touched
        events.enable()
        qc = TensorQueryClient(name="qshed")
        buf = Buffer.of(np.zeros((1, 4), np.float32))
        policy.set_deadline(buf, policy.Deadline.after_ms(0))
        assert qc.chain(qc.sink_pad, buf) == FlowReturn.OK
        assert qc._sock is None
        shed = events_of("resilience.shed")
        assert shed and shed[0]["attrs"]["site"] == "query"

    def test_deadline_ms_prop_stamps_ingress(self, events):
        events.enable()
        # a budget small enough to be spent by the time chain() checks
        # it: the buffer gets stamped AND shed without touching a socket
        qc = TensorQueryClient(name="qstamp", deadline_ms=0.0001)
        buf = Buffer.of(np.zeros((1, 4), np.float32))
        assert qc.chain(qc.sink_pad, buf) == FlowReturn.OK
        assert isinstance(policy.deadline_of(buf), policy.Deadline)
        assert qc._last_deadline is policy.deadline_of(buf)
        # an upstream deadline always wins over the element's prop
        buf2 = Buffer.of(np.zeros((1, 4), np.float32))
        upstream = policy.Deadline.after_ms(0)
        policy.set_deadline(buf2, upstream)
        qc.chain(qc.sink_pad, buf2)
        assert qc._last_deadline is upstream

    def test_drain_abandoned_records_pending_count(self, events):
        events.enable()
        qc = TensorQueryClient(name="qdrain", drain_timeout_s=0.05)
        qc._pending.append([0, 0, 0, True, 0.0, None, None])
        qc._pending.append([0, 0, 1, True, 0.0, None, None])
        t0 = time.monotonic()
        qc._drain_pending()
        assert time.monotonic() - t0 < 2.0
        evs = events_of("query.drain_abandoned")
        assert evs and evs[0]["attrs"]["pending"] == 2

    def test_drain_honors_last_deadline(self, events):
        events.enable()
        qc = TensorQueryClient(name="qdrain2", drain_timeout_s=60.0)
        qc._pending.append([0, 0, 0, True, 0.0, None, None])
        qc._last_deadline = policy.Deadline.after_ms(30)
        t0 = time.monotonic()
        qc._drain_pending()  # waits the deadline, not the 60s prop
        assert time.monotonic() - t0 < 2.0
        assert events_of("query.drain_abandoned")


# --------------------------------------------------------------------------- #
# Thread-leak visibility
# --------------------------------------------------------------------------- #

class TestThreadLeak:
    def test_join_timeout_warns_and_records_event(self, events, caplog):
        events.enable()
        release = threading.Event()
        t = threading.Thread(target=release.wait, daemon=True,
                             name="leaky-worker")
        t.start()
        try:
            with caplog.at_level("WARNING"):
                assert gel.join_or_warn(t, "queue0", timeout=0.05) is False
        finally:
            release.set()
            t.join()
        assert any("leaked" in r.message for r in caplog.records)
        evs = events_of("pipeline.thread_leak")
        assert evs and evs[0]["attrs"]["thread"] == "leaky-worker"
        assert evs[0]["attrs"]["element"] == "queue0"

    def test_clean_exit_returns_true_silently(self, events):
        events.enable()
        t = threading.Thread(target=lambda: None)
        t.start()
        assert gel.join_or_warn(t, "queue0", timeout=5.0) is True
        assert not events_of("pipeline.thread_leak")


# --------------------------------------------------------------------------- #
# Chaos harness
# --------------------------------------------------------------------------- #

class TestChaosPlan:
    def test_nth_fires_on_exact_matching_calls(self):
        plan = chaos.FaultPlan(
            [chaos.Fault(kind="drop", target="send", cmd="DATA",
                         nth=(1, 3))], seed=0)
        fires = [bool(plan.decide("send", "DATA")) for _ in range(4)]
        assert fires == [True, False, True, False]

    def test_cmd_filter_skips_non_matching_calls(self):
        plan = chaos.FaultPlan(
            [chaos.Fault(kind="drop", target="send", cmd="DATA", nth=1)],
            seed=0)
        # the handshake never advances the DATA counter
        assert plan.decide("send", "INFO_REQ") == []
        assert plan.decide("recv", "DATA") == []
        assert plan.decide("send", "DATA") != []

    def test_chain_target_prefix_matching(self):
        plan = chaos.FaultPlan(
            [chaos.Fault(kind="drop", target="chain", nth=(1, 2)),
             chaos.Fault(kind="delay", target="chain:sinkA", nth=1)],
            seed=0)
        hits = plan.decide("chain:sinkB")
        assert [f.kind for f in hits] == ["drop"]  # bare chain matches all
        hits = plan.decide("chain:sinkA")
        assert sorted(f.kind for f in hits) == ["delay", "drop"]

    def test_max_fires_caps_without_disturbing_draws(self):
        spec = {"seed": 9, "faults": [
            {"kind": "drop", "target": "send", "p": 0.5}]}
        uncapped = chaos.FaultPlan.from_spec(spec)
        free = [bool(uncapped.decide("send", "DATA")) for _ in range(40)]
        spec["faults"][0]["max_fires"] = 2
        capped = chaos.FaultPlan.from_spec(spec)
        limited = [bool(capped.decide("send", "DATA")) for _ in range(40)]
        assert sum(limited) == 2
        # the fires it DID take are the first would-be fires of the
        # uncapped schedule: the PRNG sequence was not disturbed
        assert [i for i, f in enumerate(limited) if f] == \
               [i for i, f in enumerate(free) if f][:2]

    def test_same_seed_same_schedule(self):
        spec = {"seed": 7, "faults": [
            {"kind": "drop", "target": "send", "cmd": "DATA", "p": 0.3},
            {"kind": "delay", "target": "recv", "p": 0.2},
            {"kind": "drop", "target": "chain", "p": 0.25}]}
        a, b = chaos.FaultPlan.from_spec(spec), chaos.FaultPlan.from_spec(spec)
        calls = [("send", "DATA")] * 50 + [("recv", None)] * 30 + \
                [("chain:sink", None)] * 30
        da = [[f.kind for f in a.decide(t, c)] for t, c in calls]
        db = [[f.kind for f in b.decide(t, c)] for t, c in calls]
        assert da == db
        assert a.fired == b.fired

    def test_different_seed_different_schedule(self):
        mk = lambda seed: chaos.FaultPlan(
            [chaos.Fault(kind="drop", target="send", p=0.3)], seed=seed)
        a, b = mk(1), mk(2)
        da = [bool(a.decide("send", "DATA")) for _ in range(50)]
        db = [bool(b.decide("send", "DATA")) for _ in range(50)]
        assert da != db

    def test_unknown_kind_rejected(self):
        with pytest.raises(ValueError, match="unknown fault kind"):
            chaos.Fault(kind="explode")

    def test_corrupt_inverts_first_byte_only(self):
        assert chaos._corrupt(b"\x00abc") == b"\xffabc"
        assert chaos._corrupt(b"") == b""

    def test_plan_from_env(self, monkeypatch):
        monkeypatch.setenv(chaos.ENV_VAR, '{"seed": 5, "faults": '
                           '[{"kind": "drop", "target": "send", "p": 0.1}]}')
        plan = chaos.plan_from_env()
        assert plan is not None and plan.seed == 5
        assert len(plan.faults) == 1
        monkeypatch.setenv(chaos.ENV_VAR, "{not json")
        assert chaos.plan_from_env() is None  # typo must never be fatal
        monkeypatch.setenv(chaos.ENV_VAR,
                           '{"faults": [{"kind": "nope"}]}')
        assert chaos.plan_from_env() is None
        monkeypatch.delenv(chaos.ENV_VAR)
        assert chaos.plan_from_env() is None


class TestChaosHooks:
    def test_hooks_are_none_when_off(self):
        # the zero-overhead contract: disabled cost is one global load
        # + `is None` in send/recv/push — nothing else to pay
        assert protocol.CHAOS_HOOK is None
        assert gel.CHAOS_CHAIN_HOOK is None
        assert chaos.active() is None

    def test_install_sets_and_uninstall_clears(self):
        plan = chaos.FaultPlan([], seed=0)
        chaos.install(plan)
        try:
            assert protocol.CHAOS_HOOK is chaos._wire_hook
            assert gel.CHAOS_CHAIN_HOOK is chaos._chain_hook
            assert chaos.active() is plan
        finally:
            chaos.uninstall()
        assert protocol.CHAOS_HOOK is None
        assert gel.CHAOS_CHAIN_HOOK is None
        assert chaos.active() is None

    def test_wire_hook_semantics(self):
        plan = chaos.FaultPlan(
            [chaos.Fault(kind="drop", target="send", cmd="DATA", nth=1),
             chaos.Fault(kind="corrupt", target="send", cmd="DATA", nth=2),
             chaos.Fault(kind="disconnect", target="send", cmd="DATA",
                         nth=3)], seed=0)
        chaos.install(plan)
        try:
            assert chaos._wire_hook("send", Cmd.DATA, {}, b"\x01x") is None
            assert chaos._wire_hook("send", Cmd.DATA, {}, b"\x01x") \
                == b"\xfex"
            with pytest.raises(ConnectionError, match="chaos"):
                chaos._wire_hook("send", Cmd.DATA, {}, b"\x01x")
            # clean call passes the payload through untouched
            assert chaos._wire_hook("send", Cmd.DATA, {}, b"\x01x") \
                == b"\x01x"
        finally:
            chaos.uninstall()
        assert [f["kind"] for f in plan.fired] == \
            ["drop", "corrupt", "disconnect"]


# --------------------------------------------------------------------------- #
# LMEngine admission shedding
# --------------------------------------------------------------------------- #

class TestEngineShedding:
    def test_expired_at_submit_finishes_empty(self, lm_params, events):
        events.enable()
        eng = LMEngine(lm_params, H, MAXLEN, n_slots=2, chunk=4,
                       device="cpu")
        ok = eng.submit([1, 2, 3], max_new=6,
                        deadline=policy.Deadline.after_s(600))
        dead = eng.submit([4, 5, 6], max_new=6,
                          deadline=policy.Deadline.after_ms(0))
        res = eng.run()
        assert res[dead] == []  # shed at the door, never prefilled
        assert len(res[ok]) == 6  # live deadline generates normally
        shed = events_of("resilience.shed")
        assert shed and shed[0]["attrs"]["site"] == "serving"

    def test_expired_in_queue_shed_at_admission(self, lm_params, events):
        events.enable()
        eng = LMEngine(lm_params, H, MAXLEN, n_slots=1, chunk=4,
                       device="cpu")
        r1 = eng.submit([1, 2, 3], max_new=8)
        r2 = eng.submit([4, 5], max_new=4,
                        deadline=policy.Deadline.after_ms(1))
        time.sleep(0.05)  # r2's budget expires while it waits for a slot
        res = eng.run()
        assert len(res[r1]) == 8
        assert res[r2] == []
        assert eng.stats["prefills"] == 1  # the shed request cost nothing
        assert events_of("resilience.shed")


# --------------------------------------------------------------------------- #
# E2E: reconnect, fallback degradation, chaos acceptance
# --------------------------------------------------------------------------- #

class TestEndToEnd:
    def test_server_killed_then_restarted_stream_completes(self):
        """Kill the server mid-stream, restart it on the same port: the
        client's shared retry budget + backoff must redial and finish
        the remaining frames with correct results."""
        port = free_port()
        sp = server_pipeline(port)
        sp.start()
        sp2 = None
        # the client is driven directly (no source element) so the test
        # controls exactly which frame meets the dead server
        qc = gel.make_element("tensor_query_client", host="127.0.0.1",
                              port=port, max_request_retry=60,
                              timeout_s=2.0, retry_base_s=0.02,
                              retry_max_s=0.1)
        sink = gel.make_element("tensor_sink", store=True)
        qc.src_pads[0].link(sink.sink_pads[0])
        try:
            time.sleep(0.2)
            sink.start()
            qc.start()
            qc.on_caps(qc.sink_pad, caps_of("4:1", "float32"))
            frames = [np.full((1, 4), i, np.float32) for i in range(6)]
            for i in range(3):
                buf = Buffer.of(frames[i])
                buf.offset = i
                assert qc._chain_entry(qc.sink_pad, buf) == FlowReturn.OK
            sp.stop()  # server dies with the client connection live
            sp2 = server_pipeline(port)
            sp2.start()
            time.sleep(0.2)
            for i in range(3, 6):  # first of these rides the dead socket
                buf = Buffer.of(frames[i])
                buf.offset = i
                assert qc._chain_entry(qc.sink_pad, buf) == FlowReturn.OK
            assert sink.num_buffers == 6
            for i, out in enumerate(sink.buffers):
                np.testing.assert_array_equal(out.memories[0].host(),
                                              frames[i] * 10)
                assert out.offset == i
        finally:
            qc.stop()
            sp.stop()
            if sp2 is not None:
                sp2.stop()

    def test_breaker_open_routes_fallback_and_degrades(self, events, health):
        """Nothing listening: the breaker opens after threshold failures
        and every later buffer takes the passthrough fallback — the
        pipeline COMPLETES, and health says DEGRADED (/healthz verdict
        stays ok), not failed."""
        events.enable()
        health.enable()
        port = free_port()  # never bound
        cp = Pipeline("fb-client", device="cpu")
        frames = [np.full((1, 4), i, np.float32) for i in range(5)]
        src = cp.add_new("appsrc", caps=caps_of("4:1", "float32"),
                         data=frames)
        qc = cp.add_new("tensor_query_client", host="127.0.0.1", port=port,
                        max_request_retry=1, timeout_s=0.3,
                        retry_base_s=0.001, retry_max_s=0.002,
                        breaker_threshold=2, breaker_reset_s=600.0,
                        fallback="passthrough")
        sink = cp.add_new("tensor_sink", store=True)
        Pipeline.link(src, qc, sink)
        cp.run(timeout=60)  # no PipelineError: degradation, not failure
        assert sink.num_buffers == 5
        for i, out in enumerate(sink.buffers):  # passthrough = unchanged
            np.testing.assert_array_equal(out.memories[0].host(), frames[i])
        assert qc._breaker.state == policy.OPEN
        assert events_of("resilience.breaker_open")
        assert events_of("resilience.fallback")
        snap = obs_health.snapshot()
        comp = next(c for c in snap["components"]
                    if c["name"] == f"query.client:{qc.name}")
        assert comp["status"] == "degraded"
        assert snap["ok"] is True  # impaired but alive — not a 503

    def test_fallback_element_processes_locally(self, events):
        """fallback=<kind>: a local element produces the degraded
        output (here an on-host tensor_filter standing in for the
        remote one)."""
        events.enable()
        port = free_port()
        cp = Pipeline("fb-local", device="cpu")
        src = cp.add_new("appsrc", caps=caps_of("4:1", "float32"),
                         data=[np.full((1, 4), 3.0, np.float32)])
        qc = cp.add_new("tensor_query_client", host="127.0.0.1", port=port,
                        max_request_retry=1, timeout_s=0.3,
                        retry_base_s=0.001, retry_max_s=0.002,
                        breaker_threshold=1,
                        fallback=lambda x: x + 1)
        sink = cp.add_new("tensor_sink", store=True)
        Pipeline.link(src, qc, sink)
        cp.run(timeout=60)
        assert sink.num_buffers == 1
        np.testing.assert_array_equal(
            sink.buffers[0].memories[0].host(),
            np.full((1, 4), 4.0, np.float32))

    @pytest.mark.chaos
    def test_offload_completes_under_fault_plan(self):
        """Acceptance: a full offload run with injected DATA drops and
        one forced disconnect still completes with correct results —
        the drop surfaces as a recv timeout, the disconnect as a raised
        ConnectionError, both absorbed by the shared retry budget."""
        port = free_port()
        sp = server_pipeline(port)
        sp.start()
        plan = chaos.FaultPlan(
            [chaos.Fault(kind="drop", target="send", cmd="DATA", nth=2),
             chaos.Fault(kind="disconnect", target="send", cmd="DATA",
                         nth=5)], seed=11)
        chaos.install(plan)
        try:
            time.sleep(0.2)
            cp = Pipeline("chaos-client", device="cpu")
            frames = [np.full((1, 4), i, np.float32) for i in range(6)]
            src = cp.add_new("appsrc", caps=caps_of("4:1", "float32"),
                             data=frames)
            qc = cp.add_new("tensor_query_client", host="127.0.0.1",
                            port=port, max_request_retry=4, timeout_s=0.5,
                            retry_base_s=0.01, retry_max_s=0.03)
            sink = cp.add_new("tensor_sink", store=True)
            Pipeline.link(src, qc, sink)
            cp.run(timeout=60)
            assert sink.num_buffers == 6
            for i, out in enumerate(sink.buffers):
                np.testing.assert_array_equal(out.memories[0].host(),
                                              frames[i] * 10)
            assert [f["kind"] for f in plan.fired] == ["drop", "disconnect"]
        finally:
            chaos.uninstall()
            sp.stop()

    @pytest.mark.chaos
    def test_chain_drop_fault_drops_buffer(self):
        """chain:<element> faults drop buffers with the graph's legal
        drop semantics — downstream simply sees fewer buffers."""
        plan = chaos.FaultPlan(
            [chaos.Fault(kind="drop", target="chain:csink", nth=2)],
            seed=0)
        chaos.install(plan)
        try:
            cp = Pipeline("chain-chaos", device="cpu")
            src = cp.add_new("appsrc", caps=caps_of("4:1", "float32"),
                             data=[np.full((1, 4), i, np.float32)
                                   for i in range(4)])
            sink = cp.add_new("tensor_sink", name="csink", store=True)
            Pipeline.link(src, sink)
            cp.run(timeout=60)
            assert sink.num_buffers == 3  # frame #2 vanished
            assert [f["call"] for f in plan.fired] == [2]
        finally:
            chaos.uninstall()
