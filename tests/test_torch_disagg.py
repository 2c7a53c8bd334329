"""The port's serving.disagg: every case of tests/test_disagg.py, run
against ``nnstreamer_tpu_torch`` on the CPU with the JAX package's seeded
params carried over by ``models.convert`` — the page codec round trip and
its rejections, export/import bit-exactness (COW forks, another page
budget, all-or-nothing exhaustion), the disaggregated path token-equal to
a unified engine (greedy and sampled) with pages sent == pages received,
prefix-aware placement over the wire, a seeded partition of the prefill
backend absorbed by re-prefill under the original deadline, and spill to a
neighbour. Each case runs under a timeout of its own (SIGALRM) and leaves
no fleet hook, chaos plan or import target behind.
"""


import random
import signal
import time

import numpy as np
import pytest

import jax

from nnstreamer_tpu.models import causal_lm as jlm
from nnstreamer_tpu_torch.models.convert import causal_lm_params
from nnstreamer_tpu_torch.obs import events as obs_events
from nnstreamer_tpu_torch.obs import fleet as obs_fleet
from nnstreamer_tpu_torch.resilience import chaos, policy
from nnstreamer_tpu_torch.serving import LMEngine as _LMEngine, disagg
from nnstreamer_tpu_torch.serving.kv_cache import prompt_path_hashes


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
PS = 8  # page size: 8 pages per max_len


@pytest.fixture(scope="module")
def params():
    # the JAX package's seeded params, carried over by models.convert
    return causal_lm_params(jax.tree_util.tree_map(
        np.asarray, jlm.init_causal_lm(
            jax.random.PRNGKey(7), V, D, H, L, MAXLEN)), "cpu")


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
    obs_events.enable()
    yield obs_events
    obs_events.disable()
    ring.reset()
    ring._enabled = was


@pytest.fixture
def fleet():
    agg = obs_fleet.enable_aggregator(ttl_s=30.0)
    yield agg
    obs_fleet.disable_aggregator()


def events_of(etype):
    return [e for e in obs_events.ring().snapshot() if e["type"] == etype]


def mkeng(params, role=None, pages=32, slots=2, page_size=PS):
    return LMEngine(params, H, MAXLEN, n_slots=slots, chunk=4,
                    kv_page_size=page_size, kv_pages=pages, role=role)


def shared_prefix_jobs(n, prefix_pages=2, max_new=6, seed=5):
    """n prompts sharing a ``prefix_pages``-page prefix + random tails."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, V, prefix_pages * PS).astype(np.int32)
    jobs = []
    for _ in range(n):
        tail = rng.integers(0, V, rng.integers(1, 12)).astype(np.int32)
        jobs.append((np.concatenate([pre, tail]), max_new))
    return jobs


def unified_outputs(params, jobs, **sample_kw):
    eng = mkeng(params)
    outs = []
    for i, (p, mn) in enumerate(jobs):
        kw = {k: (v + i if k == "seed" else v)
              for k, v in sample_kw.items()}
        rid = eng.submit(p, mn, **kw)
        eng.run()
        outs.append(eng.results[rid])
    return outs


# --------------------------------------------------------------------------- #
# Wire framing
# --------------------------------------------------------------------------- #

class TestWireFraming:
    def _doc(self, params):
        eng = mkeng(params)
        p = np.arange(3 * PS + 2, dtype=np.int32) % V
        eng.submit(p, 2)
        eng.run()
        doc = eng._kv.export_pages(p)
        assert doc is not None and len(doc["entries"]) == 3
        return doc

    def test_encode_decode_roundtrip_bits(self, params):
        doc = self._doc(params)
        meta, payload = disagg.encode_pages(doc)
        assert len(payload) == sum(
            e["k"].nbytes + e["v"].nbytes for e in doc["entries"])
        back = disagg.decode_pages(meta, payload)
        for fld in ("v", "page_size", "lh", "hd", "dtype"):
            assert back[fld] == doc[fld]
        assert len(back["entries"]) == len(doc["entries"])
        for a, b in zip(doc["entries"], back["entries"]):
            assert list(a["key"]) == list(b["key"])
            np.testing.assert_array_equal(np.asarray(a["k"]), b["k"])
            np.testing.assert_array_equal(np.asarray(a["v"]), b["v"])

    def test_malformed_meta_rejected(self, params):
        doc = self._doc(params)
        meta, payload = disagg.encode_pages(doc)
        with pytest.raises(ValueError, match="header"):
            disagg.decode_pages({"keys": meta["keys"]}, payload)
        with pytest.raises(ValueError, match="header"):
            disagg.decode_pages({"header": meta["header"], "keys": []},
                                payload)

    def test_truncated_payload_rejected(self, params):
        doc = self._doc(params)
        meta, payload = disagg.encode_pages(doc)
        with pytest.raises(ValueError, match="payload"):
            disagg.decode_pages(meta, payload[:-4])
        with pytest.raises(ValueError, match="payload"):
            disagg.decode_pages(meta, payload + b"\x00" * 8)


# --------------------------------------------------------------------------- #
# Export/import round trip (engine-level, no wire)
# --------------------------------------------------------------------------- #

class TestExportImport:
    def test_roundtrip_bit_identity_and_generation(self, params):
        a, b = mkeng(params), mkeng(params)
        p = np.arange(2 * PS + 5, dtype=np.int32) % V
        rid = a.submit(p, 6)
        a.run()
        want = a.results[rid]
        doc = a._kv.export_pages(p)
        assert doc is not None and len(doc["entries"]) == 2
        spliced = b._kv.import_pages(doc)
        assert spliced == 2
        # the spliced path exports back bit-identically
        back = b._kv.export_pages(p)
        assert back is not None
        for src, dst in zip(doc["entries"], back["entries"]):
            np.testing.assert_array_equal(np.asarray(src["k"]),
                                          np.asarray(dst["k"]))
            np.testing.assert_array_equal(np.asarray(src["v"]),
                                          np.asarray(dst["v"]))
        # and the importing engine generates the exact same tokens,
        # prefix-hitting the imported pages instead of re-prefilling
        rid = b.submit(p, 6)
        b.run()
        assert b.results[rid] == want
        assert b.kv_stats["hit_tokens"] >= 2 * PS

    def test_cow_forked_partial_chunks_roundtrip(self, params):
        """COW divergence on the partial chunk does not corrupt the
        full-page prefix: both forks export the same prefix pages and
        an importer regenerates both forks token-for-token."""
        a, b = mkeng(params), mkeng(params)
        rng = np.random.default_rng(11)
        pre = rng.integers(0, V, 2 * PS + 3).astype(np.int32)  # partial tail
        p1 = np.concatenate([pre, [1, 2]]).astype(np.int32)
        p2 = np.concatenate([pre, [3, 4, 5]]).astype(np.int32)
        want = []
        for p in (p1, p2):
            rid = a.submit(p, 5)
            a.run()
            want.append(a.results[rid])
        assert a.kv_stats["cow_copies"] >= 1  # the forks really forked
        d1, d2 = a._kv.export_pages(p1), a._kv.export_pages(p2)
        # both forks share the same 2 full-page entries bit-for-bit
        assert len(d1["entries"]) == len(d2["entries"]) == 2
        for e1, e2 in zip(d1["entries"], d2["entries"]):
            assert list(e1["key"]) == list(e2["key"])
            np.testing.assert_array_equal(np.asarray(e1["k"]),
                                          np.asarray(e2["k"]))
        assert b._kv.import_pages(d1) == 2
        assert b._kv.import_pages(d2) == 0  # same path: dedup splice
        for p, w in zip((p1, p2), want):
            rid = b.submit(p, 5)
            b.run()
            assert b.results[rid] == w

    def test_import_into_smaller_page_budget(self, params):
        a = mkeng(params, pages=32)
        b = mkeng(params, pages=6)
        p = np.arange(3 * PS, dtype=np.int32) % V
        a.submit(p, 2)
        a.run()
        doc = a._kv.export_pages(p)
        assert b._kv.import_pages(doc) == 3
        rid = b.submit(p, 4)
        b.run()
        a2 = mkeng(params)
        rid2 = a2.submit(p, 4)
        a2.run()
        assert b.results[rid] == a2.results[rid2]

    def test_exhaustion_rejects_cleanly(self, params):
        a = mkeng(params)
        b = mkeng(params, pages=2)
        p = np.arange(3 * PS, dtype=np.int32) % V
        a.submit(p, 2)
        a.run()
        doc = a._kv.export_pages(p)
        assert len(doc["entries"]) == 3
        used = b._kv.used_pages()
        with pytest.raises(RuntimeError, match="import rejected"):
            b._kv.import_pages(doc)
        # all-or-nothing: nothing half-spliced, nothing leaked
        assert b._kv.used_pages() == used
        assert b._kv.stats["imported_pages"] == 0
        # and the pool still accepts a document that fits
        small = a._kv.export_pages(p[:PS])
        assert b._kv.import_pages(small) == 1

    def test_geometry_mismatch_rejected(self, params):
        a = mkeng(params)
        b = mkeng(params, page_size=4)
        p = np.arange(2 * PS, dtype=np.int32) % V
        a.submit(p, 2)
        a.run()
        doc = a._kv.export_pages(p)
        used = b._kv.used_pages()
        with pytest.raises(ValueError, match="geometry mismatch"):
            b._kv.import_pages(doc)
        assert b._kv.used_pages() == used


# --------------------------------------------------------------------------- #
# E2E over the wire: workers + client
# --------------------------------------------------------------------------- #

def _fast_retry():
    return policy.RetryPolicy(base_s=0.01, max_s=0.02,
                              rng=random.Random(3))


class _Deployment:
    """One prefill worker + n decode workers + the client, torn down
    as a unit."""

    def __init__(self, params, n_decode=1, pages=32, **client_kw):
        self.pre_eng = mkeng(params, role="prefill", pages=pages)
        self.dec_engs = [mkeng(params, role="decode", pages=pages)
                         for _ in range(n_decode)]
        self.pre_w = disagg.DisaggWorker(self.pre_eng)
        self.dec_ws = [disagg.DisaggWorker(e) for e in self.dec_engs]
        kw = dict(page_size=PS, retry_policy=_fast_retry(), timeout_s=5.0)
        kw.update(client_kw)
        self.client = disagg.DisaggClient(
            [(self.pre_w.host, self.pre_w.port)],
            [(w.host, w.port) for w in self.dec_ws], **kw)

    def stop(self):
        self.client.close()
        for w in [self.pre_w] + self.dec_ws:
            w.stop()


class TestDisaggE2E:
    def test_matches_unified_greedy(self, params, metrics):
        jobs = shared_prefix_jobs(6)
        want = unified_outputs(params, jobs)
        sent0 = disagg._PAGES_SENT.labels().value
        recv0 = disagg._PAGES_RECV.labels().value
        dep = _Deployment(params)
        try:
            got = [dep.client.generate(p, mn) for p, mn in jobs]
        finally:
            dep.stop()
        assert got == want  # token-for-token, over the wire
        sent = disagg._PAGES_SENT.labels().value - sent0
        recv = disagg._PAGES_RECV.labels().value - recv0
        assert sent == recv > 0  # clean run: every shipped page landed
        assert dep.client.stats["reprefills"] == 0
        assert dep.client.stats["pages_sent"] == sent

    def test_matches_unified_sampled(self, params):
        """Position-folded sampling keys make the handoff exact under
        temperature sampling too, not just argmax."""
        jobs = shared_prefix_jobs(4, seed=9)
        kw = dict(temperature=0.9, top_k=20, seed=100)
        want = unified_outputs(params, jobs, **kw)
        dep = _Deployment(params)
        try:
            got = [dep.client.generate(p, mn, temperature=0.9, top_k=20,
                                       seed=100 + i)
                   for i, (p, mn) in enumerate(jobs)]
        finally:
            dep.stop()
        assert got == want

    def test_prefill_engine_rejects_multi_token(self, params):
        eng = mkeng(params, role="prefill")
        with pytest.raises(ValueError):
            eng.submit(np.arange(PS, dtype=np.int32), 4)

    def test_role_needs_paged_cache(self, params):
        with pytest.raises(ValueError, match="paged KV cache"):
            LMEngine(params, H, MAXLEN, n_slots=2, chunk=4,
                     role="prefill")

    def test_prefix_routing_places_on_holder(self, params, events,
                                             fleet, metrics):
        """Over the wire: after the fleet digest round trip, a request
        sharing a cached prefix lands on the decode backend that holds
        it, not wherever two-choice falls."""
        dep = _Deployment(params, n_decode=2)
        try:
            jobs = shared_prefix_jobs(4, seed=21)
            p0, mn0 = jobs[0]
            out0 = dep.client.generate(p0, mn0)
            assert out0  # warm one backend with the shared prefix
            # the decode fleet publishes its radix digests
            for w in dep.dec_ws:
                w.push_fleet(fleet)
            hashes = prompt_path_hashes(
                [int(x) for x in p0], PS)
            inst, depth = fleet.longest_prefix(hashes)
            assert inst is not None and depth >= 2
            holder = next(w for w in dep.dec_ws if w.instance == inst)
            holder_hits0 = holder.engine.kv_stats["hit_tokens"]
            want = unified_outputs(params, jobs[1:])
            got = [dep.client.generate(p, mn) for p, mn in jobs[1:]]
            assert got == want
            placed = events_of("router.prefix_place")
            assert placed, "prefix-aware placement never fired"
            assert all(e["attrs"]["backend"] == holder.endpoint
                       for e in placed)
            assert all(e["attrs"]["depth"] >= 2 for e in placed)
            # the holder actually served them from the shared prefix
            assert holder.engine.kv_stats["hit_tokens"] > holder_hits0
        finally:
            dep.stop()

    @pytest.mark.chaos
    def test_prefill_death_reprefills_under_original_deadline(
            self, params, events, metrics):
        """The acceptance run: a seeded plan partitions the prefill
        backend after the first transfers complete. Every one of the 18
        requests still returns the unified engine's exact tokens under
        its ORIGINAL deadline — the decode backend re-prefills from
        scratch (disagg.reprefill event + counter), no request is lost
        or wrong."""
        jobs = shared_prefix_jobs(18, seed=33)
        want = unified_outputs(params, jobs)
        rep0 = disagg._REPREFILL.labels().value
        dep = _Deployment(params)
        plan = chaos.FaultPlan(
            [chaos.Fault(kind="partition", target="send", cmd="DATA",
                         endpoint=dep.pre_w.endpoint, nth=4)], seed=11)
        try:
            got = []
            for i, (p, mn) in enumerate(jobs):
                if i == 3:
                    chaos.install(plan)  # prefill black-holes mid-run
                dl = policy.Deadline.after_s(30.0)
                got.append(dep.client.generate(p, mn, deadline=dl))
                assert not dl.expired()  # finished inside the budget
        finally:
            chaos.uninstall()
            dep.stop()
        assert plan.fired, "seeded plan never latched the partition"
        assert got == want  # all 18 exact, dead prefill absorbed
        reps = events_of("disagg.reprefill")
        assert reps and dep.client.stats["reprefills"] >= 1
        assert disagg._REPREFILL.labels().value - rep0 \
            == dep.client.stats["reprefills"]

    def test_spill_sheds_cold_pages_to_neighbor(self, params, events,
                                                metrics):
        """Pressure relief over the same transfer path: the hot pool
        sheds cold ref-0 paths to the neighbor, which imports them;
        shed pages are freed locally and counted as spills."""
        src = mkeng(params, pages=8)
        dec = mkeng(params, role="decode", pages=32)
        w = disagg.DisaggWorker(dec)
        neighbor = disagg.PageTransferClient(w.host, w.port)
        try:
            for p, mn in shared_prefix_jobs(3, prefix_pages=1, seed=41):
                src.submit(p, mn)
                src.run()
            kv = src._kv
            assert kv.used_pages() >= 4  # genuinely hot
            spiller = disagg.PageSpiller(kv, neighbor, watermark=0.5,
                                         max_nodes=2)
            used_before = kv.used_pages()
            freed = spiller.maybe_spill()
            assert freed > 0
            assert kv.used_pages() == used_before - freed
            assert kv.stats["spilled_pages"] == freed
            assert dec.kv_stats["imported_pages"] > 0
            spills = events_of("disagg.spill")
            assert spills and all(
                e["attrs"]["peer"] == w.endpoint for e in spills)
            # below the watermark nothing moves: one comparison, no wire
            calm = disagg.PageSpiller(kv, neighbor, watermark=1.0)
            assert calm.maybe_spill() == 0
        finally:
            neighbor.close()
            w.stop()

    def test_spec_string_and_parse(self):
        pre, dec = disagg.parse_disagg_spec(
            "127.0.0.1:7001,127.0.0.1:7002;127.0.0.1:7003")
        assert pre == [("127.0.0.1", 7001), ("127.0.0.1", 7002)]
        assert dec == [("127.0.0.1", 7003)]
        for bad in ("127.0.0.1:7001", ";127.0.0.1:7003", "a:1;"):
            with pytest.raises(ValueError):
                disagg.parse_disagg_spec(bad)
        with pytest.raises(ValueError, match="both fleets"):
            disagg.DisaggClient("127.0.0.1:1", page_size=PS)


class TestWorkerKvDigestHook:
    """DisaggWorker default fleet wiring: starting a worker installs
    fleet.KV_DIGEST_HOOK (first worker wins) so any plain FleetPusher
    in the process advertises the engine's radix-prefix digest;
    stop() clears only the hook this worker installed."""

    class _Eng:
        role = "decode"

        def kv_prefix_digest(self):
            return ["aa11", "bb22"]

    def test_install_and_clear(self):
        assert obs_fleet.KV_DIGEST_HOOK is None
        w = disagg.DisaggWorker(self._Eng())
        try:
            assert w._digest_hook_installed
            doc = obs_fleet.build_push("i0", "decode", 1)
            assert doc["kv_prefix"] == ["aa11", "bb22"]
        finally:
            w.stop()
        assert obs_fleet.KV_DIGEST_HOOK is None

    def test_first_worker_wins_second_does_not_steal(self):
        w1 = disagg.DisaggWorker(self._Eng())
        w2 = disagg.DisaggWorker(self._Eng())
        try:
            assert w1._digest_hook_installed
            assert not w2._digest_hook_installed
            w2.stop()
            # w1's hook survives w2's stop
            assert obs_fleet.KV_DIGEST_HOOK is not None
        finally:
            w1.stop()
        assert obs_fleet.KV_DIGEST_HOOK is None

    def test_engine_without_digest_skipped(self):
        class Bare:
            role = "decode"

        w = disagg.DisaggWorker(Bare())
        try:
            assert not w._digest_hook_installed
            assert obs_fleet.KV_DIGEST_HOOK is None
        finally:
            w.stop()
