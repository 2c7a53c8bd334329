"""The port's fleet/checkpoint.py: every case of
tests/test_fleet_checkpoint.py, run against ``nnstreamer_tpu_torch`` on
the CPU with the JAX package's seeded params carried over by
``models.convert`` — the blob format and its digest, the three stores,
the daemon's watermarks, crash restore of warm sessions token-equal to a
run without the crash, the stale, corrupt and missing fallbacks, and the
diag critical path's restore and re-prefill attribution. Each case runs
under a timeout of its own (SIGALRM) and leaves no daemon, controller,
fleet hook or chaos plan behind.
"""


import signal
import time

import numpy as np
import pytest

import jax

from nnstreamer_tpu_torch import fleet
from nnstreamer_tpu_torch.fleet import checkpoint as ckpt
from nnstreamer_tpu_torch.fleet.autoscale import AutoscalePolicy
from nnstreamer_tpu_torch.fleet.controller import FleetController, LaunchHandle
from nnstreamer_tpu_torch.fleet.migrate import LM_CAPS
from nnstreamer_tpu.models import causal_lm as jlm
from nnstreamer_tpu_torch.models.convert import causal_lm_params
from nnstreamer_tpu_torch.obs import events as obs_events
from nnstreamer_tpu_torch.obs import fleet as obs_fleet
from nnstreamer_tpu_torch.obs import metrics as obs_metrics
from nnstreamer_tpu_torch.obs import slo as obs_slo
from nnstreamer_tpu_torch.obs.diag import critpath
from nnstreamer_tpu_torch.query.router import BackendSet, QueryRouter
from nnstreamer_tpu_torch.resilience import chaos
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
def metrics_on():
    reg = obs_metrics.registry()
    was = reg.is_enabled
    reg.enable()
    yield
    if not was:
        reg.disable()


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


def mkfleet(params, n, name="ckpt-test"):
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


def serve_session(eng, prompt, session, max_new=4):
    """Run one turn directly on an engine so its session table has a
    committed path for the daemon to checkpoint."""
    rid = eng.submit(np.asarray(prompt, np.int32), max_new, None,
                     session=session)
    eng.run()
    return [int(t) for t in eng.results.get(rid, [])]


def hold_policy(clk):
    """A policy that never scales — restore/upgrade paths only."""
    return AutoscalePolicy(1, 8, hysteresis=99, cooldown_s=1e9,
                           clock=clk)


class _FakeLauncher:
    """In-process 'subprocess': launches a real DisaggWorker."""

    def __init__(self, params):
        self.params = params
        self.live = {}
        self.terminated = []

    def launch(self):
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


# --------------------------------------------------------------------------- #
# Blob format
# --------------------------------------------------------------------------- #

class TestBlobFormat:
    def test_path_only_roundtrip(self):
        blob = ckpt.build_blob("s-a", 3, [1, 2, 3], None)
        out = ckpt.parse_blob(blob)
        assert out["session"] == "s-a"
        assert out["seq"] == 3
        assert out["path"] == [1, 2, 3]
        assert out["doc"] is None

    def test_pages_roundtrip(self, params):
        eng = mkeng(params)
        serve_session(eng, np.arange(2 * PS + 3) % V, "s-b")
        path, doc = eng.checkpoint_session("s-b")
        blob = ckpt.build_blob("s-b", int(path.size), path, doc)
        out = ckpt.parse_blob(blob)
        assert out["path"] == [int(t) for t in path]
        assert out["seq"] == int(path.size)
        assert out["doc"] is not None
        assert len(out["doc"]["entries"]) == len(doc["entries"])

    def test_truncation_rejected(self, params):
        eng = mkeng(params)
        serve_session(eng, np.arange(2 * PS + 3) % V, "s-c")
        path, doc = eng.checkpoint_session("s-c")
        blob = ckpt.build_blob("s-c", int(path.size), path, doc)
        with pytest.raises(ValueError, match="digest|truncated"):
            ckpt.parse_blob(blob[:-7])

    def test_bit_flip_rejected(self, params):
        eng = mkeng(params)
        serve_session(eng, np.arange(2 * PS + 3) % V, "s-d")
        path, doc = eng.checkpoint_session("s-d")
        blob = ckpt.build_blob("s-d", int(path.size), path, doc)
        poisoned = blob[:-1] + bytes([blob[-1] ^ 0xFF])
        with pytest.raises(ValueError, match="digest"):
            ckpt.parse_blob(poisoned)

    def test_missing_header_end_rejected(self):
        with pytest.raises(ValueError, match="truncated"):
            ckpt.parse_blob(b'{"v": 1}')

    def test_unreadable_header_rejected(self):
        with pytest.raises(ValueError, match="unreadable"):
            ckpt.parse_blob(b"not-json\n")

    def test_newer_version_rejected(self):
        import json
        header = {"v": ckpt.BLOB_VERSION + 1, "session": "s", "seq": 1,
                  "path": [1], "pages": None, "digest": "00"}
        blob = json.dumps(header).encode() + b"\n"
        with pytest.raises(ValueError, match="newer"):
            ckpt.parse_blob(blob)


# --------------------------------------------------------------------------- #
# Stores
# --------------------------------------------------------------------------- #

class TestMemoryStore:
    def test_latest_and_watermarks(self):
        st = ckpt.MemoryStore()
        for seq in (2, 5, 3):
            st.put("m-s", seq, ckpt.build_blob("m-s", seq,
                                               list(range(seq)), None))
        assert st.latest("m-s")["seq"] == 5
        assert st.watermarks() == {"m-s": 5}
        assert st.latest("nope") is None

    def test_corrupt_newest_falls_back(self, events):
        st = ckpt.MemoryStore()
        st.put("m-f", 4, ckpt.build_blob("m-f", 4, [1, 2, 3, 4], None))
        st.put("m-f", 9, b"garbage with no header end")
        out = st.latest("m-f")
        assert out is not None and out["seq"] == 4
        assert len(events_of("fleet.checkpoint_reject")) == 1

    def test_retention_evicts_oldest(self):
        st = ckpt.MemoryStore(retention=2)
        for seq in range(1, 6):
            st.put("m-r", seq, ckpt.build_blob("m-r", seq, [seq], None))
        assert sorted(st._blobs["m-r"]) == [4, 5]


class TestLocalDirStore:
    def test_atomic_write_no_tmp_leftovers(self, tmp_path):
        st = ckpt.LocalDirStore(str(tmp_path))
        st.put("d-s", 7, ckpt.build_blob("d-s", 7, [1] * 7, None))
        files = [p.name for p in tmp_path.rglob("*") if p.is_file()]
        assert files == ["000000000007.ckpt"]
        assert st.latest("d-s")["seq"] == 7

    def test_retention_evicts_oldest_files(self, tmp_path):
        st = ckpt.LocalDirStore(str(tmp_path), retention=3)
        for seq in range(1, 7):
            st.put("d-r", seq, ckpt.build_blob("d-r", seq, [seq], None))
        seqs = [sq for sq, _ in st._seq_files(st._sdir("d-r"))]
        assert seqs == [4, 5, 6]

    def test_corrupt_newest_falls_back(self, tmp_path, events):
        st = ckpt.LocalDirStore(str(tmp_path))
        st.put("d-f", 3, ckpt.build_blob("d-f", 3, [1, 2, 3], None))
        st.put("d-f", 8, ckpt.build_blob("d-f", 8, [1] * 8, None))
        newest = st._seq_files(st._sdir("d-f"))[-1][1]
        with open(newest, "wb") as fp:
            fp.write(b"half a blo")                     # torn write
        out = st.latest("d-f")
        assert out is not None and out["seq"] == 3
        assert len(events_of("fleet.checkpoint_reject")) == 1

    def test_rescan_watermarks_survive_the_writer(self, tmp_path):
        first = ckpt.LocalDirStore(str(tmp_path))
        first.put("d-w", 5, ckpt.build_blob("d-w", 5, [1] * 5, None))
        first.put("d-x", 2, ckpt.build_blob("d-x", 2, [1, 2], None))
        reborn = ckpt.LocalDirStore(str(tmp_path))   # new process
        assert reborn.watermarks() == {"d-w": 5, "d-x": 2}
        assert reborn.latest("d-w")["seq"] == 5


class TestNeighborStore:
    def test_ship_lands_on_neighbor_shelf(self, params):
        workers, router = mkfleet(params, 2)
        try:
            st = ckpt.NeighborStore([workers[1].endpoint])
            blob = ckpt.build_blob("n-s", 4, [1, 2, 3, 4], None)
            st.put("n-s", 4, blob)
            assert st.watermarks() == {"n-s": 4}
            shelf = workers[1]._ckpt_shelf()
            assert shelf.latest("n-s")["seq"] == 4
            assert st.latest("n-s") is None     # blobs live remotely
            st.close()
        finally:
            stop_all(router, workers)

    def test_all_neighbors_dead_raises(self):
        st = ckpt.NeighborStore(["127.0.0.1:1"], timeout_s=0.5)
        with pytest.raises(OSError, match="no neighbor accepted"):
            st.put("n-d", 1, ckpt.build_blob("n-d", 1, [1], None))
        assert st.watermarks() == {}
        st.close()

    def test_dead_neighbor_skipped_live_one_acks(self, params):
        workers, router = mkfleet(params, 1)
        try:
            st = ckpt.NeighborStore(
                ["127.0.0.1:1", workers[0].endpoint], timeout_s=0.5)
            st.put("n-m", 2, ckpt.build_blob("n-m", 2, [1, 2], None))
            assert st.watermarks() == {"n-m": 2}
            assert workers[0]._ckpt_shelf().latest("n-m")["seq"] == 2
            st.close()
        finally:
            stop_all(router, workers)


# --------------------------------------------------------------------------- #
# CheckpointDaemon
# --------------------------------------------------------------------------- #

class TestCheckpointDaemon:
    def test_run_once_writes_then_skips_unchanged(self, params):
        eng = mkeng(params)
        serve_session(eng, np.arange(2 * PS + 3) % V, "cd-a")
        st = ckpt.MemoryStore()
        d = ckpt.CheckpointDaemon(eng, st)
        assert d.run_once() == 1
        seq0 = d.watermarks()["cd-a"]
        assert st.latest("cd-a")["seq"] == seq0
        # no new committed tokens: the next pass writes nothing
        assert d.run_once() == 0
        assert d.stats["written"] == 1 and d.stats["skipped"] >= 1

    def test_seq_is_monotone_across_turns(self, params):
        eng = mkeng(params)
        toks = serve_session(eng, np.arange(2 * PS + 3) % V, "cd-b")
        st = ckpt.MemoryStore()
        d = ckpt.CheckpointDaemon(eng, st)
        d.run_once()
        seq0 = d.watermarks()["cd-b"]
        longer = list(np.arange(2 * PS + 3) % V) + toks
        serve_session(eng, longer, "cd-b")
        assert d.run_once() == 1
        assert d.watermarks()["cd-b"] > seq0
        assert st.latest("cd-b")["seq"] == d.watermarks()["cd-b"]

    def test_min_new_tokens_gates_churn(self, params):
        eng = mkeng(params)
        serve_session(eng, np.arange(2 * PS + 3) % V, "cd-c")
        d = ckpt.CheckpointDaemon(eng, ckpt.MemoryStore(),
                                  min_new_tokens=10_000)
        assert d.run_once() == 0                      # bar never met
        assert d.stats["skipped"] == 1

    def test_store_failure_journals_and_continues(self, params, events):
        class BadStore(ckpt.CheckpointStore):
            def put(self, session, seq, blob):
                raise OSError("disk on fire")

        eng = mkeng(params)
        serve_session(eng, np.arange(2 * PS + 3) % V, "cd-d")
        d = ckpt.CheckpointDaemon(eng, BadStore())
        assert d.run_once() == 0
        assert d.stats["failed"] == 1
        assert len(events_of("fleet.checkpoint_fail")) == 1
        assert "cd-d" not in d.watermarks()           # retried next pass

    def test_hook_rides_push_docs(self, params):
        eng = mkeng(params)
        serve_session(eng, np.arange(2 * PS + 3) % V, "cd-e")
        d = ckpt.CheckpointDaemon(eng, ckpt.MemoryStore())
        d.run_once()
        assert obs_fleet.CHECKPOINT_HOOK is None
        d.install_hook()
        try:
            doc = obs_fleet.build_push("w-hook", "worker", 1)
            assert doc["checkpoints"] == d.watermarks()
            # first daemon wins; a second install is a no-op
            d2 = ckpt.CheckpointDaemon(eng, ckpt.MemoryStore())
            d2.install_hook()
            d2.uninstall_hook()
            assert obs_fleet.CHECKPOINT_HOOK is not None
        finally:
            d.uninstall_hook()
        assert obs_fleet.CHECKPOINT_HOOK is None
        assert obs_fleet.build_push("w-hook", "worker", 2)[
            "checkpoints"] is None


class TestEnvAutoAttach:
    def test_ckpt_dir_env_starts_a_daemon(self, params, tmp_path,
                                          monkeypatch):
        """The nns-launch-torch --checkpoint-dir path: NNS_FLEET_CKPT_DIR
        auto-attaches a LocalDirStore + daemon to the worker."""
        monkeypatch.setenv("NNS_FLEET_CKPT_DIR", str(tmp_path))
        monkeypatch.setenv("NNS_FLEET_CKPT_INTERVAL", "0.05")
        w = disagg.DisaggWorker(mkeng(params))
        try:
            assert isinstance(w.checkpoint_store, ckpt.LocalDirStore)
            assert w.checkpoint_store.root == str(tmp_path)
            assert w._ckpt_daemon is not None
            assert w._ckpt_daemon.interval_s == pytest.approx(0.05)
            assert w._ckpt_daemon._thread is not None
        finally:
            w.stop()
        assert w._ckpt_daemon._thread is None         # stop() owns it
        assert obs_fleet.CHECKPOINT_HOOK is None


# --------------------------------------------------------------------------- #
# Freeze/export race (lm_engine.py satellite fix)
# --------------------------------------------------------------------------- #

class TestFreezeExportRace:
    def test_frozen_submit_refused(self, params):
        eng = mkeng(params)
        p = np.arange(2 * PS + 3) % V
        serve_session(eng, p, "fr-a")
        assert eng.freeze_session("fr-a") is True
        with pytest.raises(ValueError, match="frozen for migration"):
            eng.submit(np.asarray(p, np.int32), 2, None, session="fr-a")
        eng.resume_session("fr-a")
        assert len(serve_session(eng, p, "fr-a")) == 4

    def test_export_ships_freeze_time_snapshot(self, params):
        """A retire replacing the recorded path mid-migration must not
        change what the already-started export ships."""
        eng = mkeng(params)
        p = np.arange(2 * PS + 3) % V
        toks = serve_session(eng, p, "fr-b")
        eng.freeze_session("fr-b")
        frozen = eng._frozen_paths["fr-b"]
        n0 = int(frozen.size)
        # simulate the racing retire: paths are REPLACED, never mutated
        eng._session_paths["fr-b"] = np.concatenate(
            [frozen, np.asarray(toks, np.int32)])
        doc = eng.export_session("fr-b")
        assert int(eng._frozen_paths["fr-b"].size) == n0
        want = eng._kv.export_pages(frozen)
        assert doc is not None and want is not None
        assert len(doc["entries"]) == len(want["entries"])


# --------------------------------------------------------------------------- #
# Tombstones: restore payload handoff + compaction protection
# --------------------------------------------------------------------------- #

class TestTombstoneRestore:
    def _expire(self, agg, iid):
        with agg._lock:
            agg._instances[iid].last_mono -= 1e6

    def test_tombstone_carries_checkpoints_and_endpoint(self, agg,
                                                        events):
        agg.ingest(obs_fleet.build_push(
            "w-dead", "worker", 1, checkpoints={"s0": 12},
            endpoint="127.0.0.1:9009"))
        self._expire(agg, "w-dead")
        rows = agg.restorables()
        assert len(rows) == 1
        assert rows[0]["instance"] == "w-dead"
        assert rows[0]["endpoint"] == "127.0.0.1:9009"
        assert rows[0]["checkpoints"] == {"s0": 12}
        assert len(events_of("fleet.expire")) == 1

    def test_consume_restore_is_first_claimant_wins(self, agg):
        agg.ingest(obs_fleet.build_push(
            "w-once", "worker", 1, checkpoints={"s1": 4},
            endpoint="127.0.0.1:9010"))
        self._expire(agg, "w-once")
        assert agg.restorables()
        payload = agg.consume_restore("w-once")
        assert payload == {"instance": "w-once",
                           "endpoint": "127.0.0.1:9010",
                           "checkpoints": {"s1": 4}}
        # claimed: gone from the backlog, second claim gets None
        assert agg.restorables() == []
        assert agg.consume_restore("w-once") is None
        with agg._lock:   # the stone stays for the routing view
            assert "w-once" in agg._tombstones
            assert "checkpoints" not in agg._tombstones["w-once"]

    def test_no_endpoint_means_not_restorable(self, agg):
        agg.ingest(obs_fleet.build_push("w-noep", "worker", 1,
                                        checkpoints={"s2": 3}))
        self._expire(agg, "w-noep")
        assert agg.restorables() == []
        assert agg.consume_restore("w-noep") is None

    def test_compaction_protects_unconsumed_checkpoint_stones(
            self, agg, monkeypatch):
        monkeypatch.setattr(obs_fleet, "TOMBSTONE_LIMIT", 2)
        now = time.monotonic()
        with agg._lock:
            # w-ck died LAST-BUT-OLDEST among plain stones it would
            # normally lose to; its unconsumed checkpoints shield it
            agg._tombstones["w-ck"] = {
                "role": "worker", "endpoint": "e:1",
                "checkpoints": {"s": 1}, "expired_mono": now - 1.0}
            for iid, dt in (("w-p1", 0.5), ("w-p2", 0.3),
                            ("w-p3", 0.1)):
                agg._tombstones[iid] = {"role": "worker",
                                        "expired_mono": now - dt}
            agg._compact_tombstones()
            left = set(agg._tombstones)
        assert "w-ck" in left and len(left) == 2

    def test_consumed_stone_loses_protection(self, agg, monkeypatch):
        monkeypatch.setattr(obs_fleet, "TOMBSTONE_LIMIT", 1)
        now = time.monotonic()
        with agg._lock:
            agg._tombstones["w-used"] = {
                "role": "worker", "endpoint": "e:2",
                "checkpoints": {"s": 1}, "expired_mono": now - 1.0}
            agg._tombstones["w-new"] = {"role": "worker",
                                        "expired_mono": now}
        assert agg.consume_restore("w-used") is not None
        with agg._lock:
            agg._compact_tombstones()
            left = set(agg._tombstones)
        assert left == {"w-new"}                       # oldest evicted


# --------------------------------------------------------------------------- #
# Chaos kill -9
# --------------------------------------------------------------------------- #

class TestChaosKill:
    def test_kill_fault_crashes_backend_and_stream_fails_over(
            self, params, events):
        workers, router = mkfleet(params, 2)
        victim, other = workers
        p = np.arange(2 * PS + 3) % V
        try:
            chaos.register_kill_target(victim.endpoint, victim.kill)
            plan = chaos.install(chaos.FaultPlan(
                [chaos.Fault(kind="kill", target="send", cmd="DATA",
                             endpoint=victim.endpoint, nth=1,
                             max_fires=1)], seed=23))
            try:
                router.backends.pin_session("ck-s", victim.endpoint)
                toks = lm_dispatch(router, p, "ck-s")
            finally:
                chaos.uninstall()
            # mid-stream failover served the stream anyway...
            assert len(toks) == 6
            # ...on the survivor: the retry excluded the corpse, the
            # stale pin was dropped, and the success path's
            # note_session moved the ownership census. (pick() may
            # still ring-hash to the victim until the restorer removes
            # the dead backend — the census is the contract here.)
            assert "ck-s" in router.backends.sessions_owned(
                other.endpoint)
            assert "ck-s" not in router.backends.sessions_owned(
                victim.endpoint)
            assert [f["kind"] for f in plan.fired] == ["kill"]
            with pytest.raises(OSError):
                victim._listener.getsockname()
        finally:
            chaos.unregister_kill_target(victim.endpoint)
            stop_all(router, workers)

    def test_unregistered_endpoint_is_noted_not_fatal(self):
        note = chaos._do_kill("nowhere:1")
        assert "no kill target registered" in note

    def test_uninstalled_hooks_are_none(self):
        from nnstreamer_tpu_torch.query import protocol as _protocol
        assert _protocol.CHAOS_HOOK is None


# --------------------------------------------------------------------------- #
# SessionRestorer: fresh splice vs stale fallback
# --------------------------------------------------------------------------- #

class TestSessionRestorer:
    def _fleet_with_checkpoints(self, params):
        workers, router = mkfleet(params, 2)
        w0, w1 = workers
        p = np.arange(2 * PS + 3) % V
        router.backends.pin_session("rs-s", w0.endpoint)
        toks = lm_dispatch(router, p, "rs-s")
        daemon = ckpt.CheckpointDaemon(
            w0.engine, ckpt.NeighborStore([w1.endpoint]),
            lock=w0._elock, name="rs")
        assert daemon.run_once() == 1
        return workers, router, daemon, p, toks

    def test_fresh_checkpoint_restores_warm(self, params, events,
                                            metrics_on):
        workers, router, daemon, p, toks = \
            self._fleet_with_checkpoints(params)
        w0, w1 = workers
        try:
            before = ckpt._RESTORED.labels("checkpoint").value
            w0.kill()
            restorer = ckpt.SessionRestorer(router)
            report = restorer.restore_instance(
                w0.instance, w0.endpoint, daemon.watermarks())
            assert report["restored"] == 1
            assert report["re_prefilled"] == 0
            (row,) = report["sessions"]
            assert row["outcome"] == "checkpoint"
            assert row["target"] == w1.endpoint
            assert ckpt._RESTORED.labels("checkpoint").value \
                == before + 1
            # adopted warm: the next prefill is billed as "restore"
            # and rides the spliced pages (prefix hit, not recompute)
            assert "rs-s" in w1.engine._restored_sessions
            hit0 = w1.engine._kv.stats["hit_tokens"]
            assert lm_dispatch(router, p, "rs-s") == toks
            assert w1.engine._kv.stats["hit_tokens"] > hit0
            assert len(events_of("fleet.restore_done")) == 1
        finally:
            stop_all(router, workers)

    def test_stale_checkpoint_falls_back_to_reprefill(self, params,
                                                      events,
                                                      metrics_on):
        workers, router, daemon, p, toks = \
            self._fleet_with_checkpoints(params)
        w0, w1 = workers
        try:
            # the session advances past the shelved blob, and the dead
            # worker's last push CLAIMED that newer watermark — as if
            # the fresher checkpoint was acked but the neighbor lost it
            longer = list(p) + toks
            toks2 = lm_dispatch(router, longer, "rs-s")
            with w0._elock:
                claimed = {s: int(q) for s, q in
                           w0.engine.session_watermarks().items()}
            daemon._last = dict(claimed)
            before = ckpt._RESTORED.labels("re_prefill").value
            w0.kill()
            restorer = ckpt.SessionRestorer(router)
            report = restorer.restore_instance(
                w0.instance, w0.endpoint, daemon.watermarks())
            assert report["restored"] == 0
            assert report["re_prefilled"] == 1
            assert report["sessions"][0]["outcome"] == "re_prefill"
            assert ckpt._RESTORED.labels("re_prefill").value \
                == before + 1
            assert len(events_of("fleet.restore_fallback")) == 1
            assert "rs-s" in w1.engine._reprefill_sessions
            # token-identical anyway: greedy decode recomputes the
            # same continuation from the resent history
            assert lm_dispatch(router, longer, "rs-s") == toks2
        finally:
            stop_all(router, workers)

    def test_diag_attribution_segments(self):
        assert critpath.segment_of(
            "serving.prefill", {"restore": True}) == "restore"
        assert critpath.segment_of(
            "serving.prefill", {"re_prefill": True}) == "re_prefill"
        assert critpath.segment_of("serving.prefill", {}) \
            == "device_compute"


# --------------------------------------------------------------------------- #
# Controller: the restore reconcile action
# --------------------------------------------------------------------------- #

class TestControllerRestore:
    def test_reconcile_restores_the_dead(self, params, agg, events,
                                         fleet_off_after):
        workers, router = mkfleet(params, 2)
        w0, w1 = workers
        p = np.arange(2 * PS + 3) % V
        try:
            router.backends.pin_session("cr-s", w0.endpoint)
            toks = lm_dispatch(router, p, "cr-s")
            daemon = ckpt.CheckpointDaemon(
                w0.engine, ckpt.NeighborStore([w1.endpoint]),
                lock=w0._elock, name="cr")
            daemon.run_once()
            w0.attach_checkpoint_daemon(daemon)
            for w in workers:
                w.push_fleet(agg)
            w0.kill()
            with agg._lock:
                agg._instances[w0.instance].last_mono -= 1e6
            clk = FakeClock()
            ctl = FleetController(router, hold_policy(clk),
                                  aggregator=agg, clock=clk)
            ctl.reconcile_once()
            assert ctl.stats["restores"] == 1
            entry = [a for a in ctl.actions()
                     if a["action"] == "restore"][0]
            assert entry["restored"] == 1
            assert entry["endpoint"] == w0.endpoint
            # claimed + confirmed: record and stone both cleared
            assert agg.restorables() == []
            assert list(agg.routing_view()) == [w1.instance]
            # a second tick finds nothing to restore
            ctl.reconcile_once()
            assert ctl.stats["restores"] == 1
            # the stream kept going, token-identically
            assert lm_dispatch(router, p, "cr-s") == toks
        finally:
            stop_all(router, workers)


# --------------------------------------------------------------------------- #
# Rolling upgrade
# --------------------------------------------------------------------------- #

class TestRollingUpgrade:
    N_SESSIONS = 4
    GEN = 5

    def test_upgrade_replaces_fleet_without_dropping_streams(
            self, params, agg, events, fleet_off_after, slo_off_after):
        rng = np.random.default_rng(19)
        prompts = [rng.integers(0, V, 2 * PS + 4 + i).astype(np.int32)
                   for i in range(self.N_SESSIONS)]
        workers, router = mkfleet(params, 1, name="upg")
        launcher = _FakeLauncher(params)
        clk = FakeClock()
        ctl = FleetController(router, hold_policy(clk),
                              launcher=launcher, aggregator=agg,
                              clock=clk)
        reg = obs_slo.enable()
        reg.set_objective("streams", goodput_ratio=0.9)
        try:
            for _ in range(2):
                h = launcher.launch()
                router.add_backend(h.endpoint)
                ctl._launched[h.endpoint] = h
            old_eps = sorted(be.endpoint
                             for be in router.backends.backends())
            assert len(old_eps) == 3

            def run_turn(out):
                for i, p in enumerate(prompts):
                    t0 = time.monotonic()
                    toks = lm_dispatch(router, p, f"up-s{i}",
                                       max_new=self.GEN)
                    reg.record_outcome(
                        "streams",
                        "met" if len(toks) == self.GEN else "missed",
                        time.monotonic() - t0)
                    out.setdefault(f"up-s{i}", []).append(toks)

            outputs = {}
            run_turn(outputs)
            report = ctl.upgrade()
            assert report["aborted"] is None
            assert len(report["upgraded"]) == 3
            assert sorted(report["plan"]) == old_eps
            new_eps = sorted(be.endpoint
                             for be in router.backends.backends()
                             if be.state == "active")
            assert len(new_eps) == 3
            assert not set(new_eps) & set(old_eps)     # all replaced
            run_turn(outputs)
            # zero dropped streams, token-identical across the upgrade
            for sid, turns in outputs.items():
                assert len(turns) == 2
                assert turns[0] == turns[1]
                assert len(turns[0]) == self.GEN
            ev = reg.evaluate("streams")
            assert ev["breached"] is False
            assert ev["windows"]["fast"]["burn"]["goodput"] \
                < reg.burn_threshold
            assert ev["windows"]["slow"]["burn"]["goodput"] \
                < reg.burn_threshold
            assert ctl.stats["upgrades"] == 1
            acts = [a["action"] for a in ctl.actions()]
            assert acts.count("upgrade_step") == 3
            assert acts[-1] == "upgrade_done"
            assert len(events_of("fleet.upgrade")) == 2  # start + done
        finally:
            stop_all(router, workers)
            launcher.stop_all()

    def test_upgrade_without_launcher_skips(self, params, agg,
                                            fleet_off_after):
        workers, router = mkfleet(params, 2, name="upg-nl")
        try:
            clk = FakeClock()
            ctl = FleetController(router, hold_policy(clk),
                                  aggregator=agg, clock=clk)
            report = ctl.upgrade()
            assert report["aborted"] == "no launcher"
            assert report["upgraded"] == []
            # nothing was drained
            assert len([be for be in router.backends.backends()
                        if be.state == "active"]) == 2
        finally:
            stop_all(router, workers)


# --------------------------------------------------------------------------- #
# Acceptance: seeded kill -9 of one of 3 workers mid multi-turn load
# --------------------------------------------------------------------------- #

class TestKillAcceptance:
    N_SESSIONS = 6
    N_TURNS = 4
    GEN = 5

    def _prompts(self):
        rng = np.random.default_rng(11)
        return [rng.integers(0, V, 2 * PS + 4 + i).astype(np.int32)
                for i in range(self.N_SESSIONS)]

    def _run_turn(self, router, prompts, outputs, reg=None):
        for i, p in enumerate(prompts):
            sid = f"ka-s{i}"
            t0 = time.monotonic()
            toks = lm_dispatch(router, p, sid, max_new=self.GEN)
            if reg is not None:
                reg.record_outcome(
                    "streams", "met" if len(toks) == self.GEN
                    else "missed", time.monotonic() - t0)
            outputs.setdefault(sid, []).append(toks)

    def test_kill_minus_nine_restores_streams_token_identically(
            self, params, agg, events, metrics_on, fleet_off_after,
            slo_off_after):
        prompts = self._prompts()

        # -- control: same load, nobody dies --------------------------
        workers, router = mkfleet(params, 3, name="ka-ctl")
        control = {}
        try:
            for _ in range(self.N_TURNS):
                self._run_turn(router, prompts, control)
        finally:
            stop_all(router, workers)

        # -- the run under test: SIGKILL one of 3 mid-load ------------
        reg = obs_slo.enable()
        reg.set_objective("streams", goodput_ratio=0.9)
        workers, router = mkfleet(params, 3, name="ka-run")
        eps = [w.endpoint for w in workers]
        daemons = []
        for i, w in enumerate(workers):
            d = ckpt.CheckpointDaemon(
                w.engine,
                ckpt.NeighborStore([e for e in eps if e != w.endpoint]),
                lock=w._elock, name=f"ka-{i}")
            w.attach_checkpoint_daemon(d)
            daemons.append(d)
        outputs = {}
        victim = None
        try:
            self._run_turn(router, prompts, outputs, reg)
            # checkpoint pass + fleet push BEFORE the crash: blobs on
            # the neighbors, watermarks in the aggregator's records.
            # Affinity does not guarantee every worker owns a session,
            # so only the victim (the busiest worker) must have
            # shelved something.
            victim = max(workers, key=lambda w: len(
                router.backends.sessions_owned(w.endpoint)))
            owned = router.backends.sessions_owned(victim.endpoint)
            assert owned                               # someone to lose
            for d, w in zip(daemons, workers):
                wrote = d.run_once()
                if w is victim:
                    assert wrote >= 1
                w.push_fleet(agg)

            # kill -9 via the seeded chaos plan: a probe stream pinned
            # to the victim trips the fault; the real sessions' pins
            # stay on the corpse for the restore to claim
            chaos.register_kill_target(victim.endpoint, victim.kill)
            plan = chaos.install(chaos.FaultPlan(
                [chaos.Fault(kind="kill", target="send", cmd="DATA",
                             endpoint=victim.endpoint, nth=1,
                             max_fires=1)], seed=29))
            try:
                router.backends.pin_session("ka-probe", victim.endpoint)
                probe = lm_dispatch(router, prompts[0], "ka-probe",
                                    max_new=self.GEN)
            finally:
                chaos.uninstall()
                chaos.unregister_kill_target(victim.endpoint)
            assert [f["kind"] for f in plan.fired] == ["kill"]
            assert len(probe) == self.GEN              # failover served
            # the dead worker never drained: its sessions still pin it
            assert router.backends.sessions_owned(victim.endpoint) \
                == owned

            # heartbeats stop; force the TTL to lapse
            with agg._lock:
                agg._instances[victim.instance].last_mono -= 1e6
            restored_before = ckpt._RESTORED.labels("checkpoint").value
            clk = FakeClock()
            controller = FleetController(router, hold_policy(clk),
                                         aggregator=agg, clock=clk)
            controller.reconcile_once()

            # the restore reconcile action ran, from checkpoints
            assert controller.stats["restores"] == 1
            entry = [a for a in controller.actions()
                     if a["action"] == "restore"][0]
            assert entry["restored"] >= 1
            assert ckpt._RESTORED.labels("checkpoint").value \
                > restored_before
            survivors = [w for w in workers if w is not victim]
            assert any(w.engine._restored_sessions for w in survivors)
            assert agg.restorables() == []
            assert len([be for be in router.backends.backends()
                        if be.state == "active"]) == 2

            for _ in range(self.N_TURNS - 1):
                self._run_turn(router, prompts, outputs, reg)

            # zero streams lost: every turn of every session completed
            for sid, turns in outputs.items():
                assert len(turns) == self.N_TURNS
                assert all(len(t) == self.GEN for t in turns)
            # token-identical to the unkilled control run
            assert outputs == control

            # SLO: burn under threshold on BOTH windows
            ev = reg.evaluate("streams")
            assert ev["breached"] is False
            assert ev["windows"]["fast"]["burn"]["goodput"] \
                < reg.burn_threshold
            assert ev["windows"]["slow"]["burn"]["goodput"] \
                < reg.burn_threshold
        finally:
            stop_all(router, workers)
