"""The port's paged KV cache (nnstreamer_tpu_torch/serving/kv_cache.py, the
paged causal-LM forms and the engine's paging) against the JAX package's.

Every case of tests/test_kv_paging.py runs here against the JAX package at
its sizes (V 97, d 32, 4 heads, 2 layers, max_len 64, page 8), the params
converted from the JAX tree:

- allocator units run the same operations on both caches: free lists, page
  ids, reserved counts, LRU lengths and ``stats`` are equal;
- the paged forms equal the port's contiguous forms bit for bit (the gather
  is the contiguous layout) and the JAX paged forms within rtol 1e-4 /
  atol 1e-5 (logits and pages 1..n; the null page 0 is never compared:
  which duplicate write lands there is unordered);
- engine cases (no hit, prefix hit, COW, exhaustion, eviction, offload,
  mid-flight admission, sampling, speculation, bounded slot view,
  constructor and environment): the port's paged tokens equal the JAX paged
  engine's and the port's contiguous engine's, its ``kv_stats`` equal
  JAX's, its error messages the JAX engine's;
- page documents exported by either package import into the other;
- a paged engine enrolled on ``sched.DeviceEngine`` gives the same tokens;
- the CLI's --kv-page-size/--kv-pages give the JAX CLI's errors and
  environment.

The JAX file's ``test_tp_engine_rejects_paging`` waits for the port of the
tensor-parallel engine (ROADMAP §A10). The ``cuda`` case (an admission with
a COW copy and a re-upload, replayed as CUDA graphs, against the eager run)
runs on the card with ``-m cuda``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nnstreamer_tpu.models import causal_lm as jlm  # noqa: E402
from nnstreamer_tpu.serving import LMEngine as JaxEngine  # noqa: E402
from nnstreamer_tpu.serving import PagedKVCache as JaxKV  # noqa: E402
from nnstreamer_tpu.serving.kv_cache import empty_page_pool as jax_pool  # noqa: E402
from nnstreamer_tpu_torch.models import causal_lm as tlm  # noqa: E402
from nnstreamer_tpu_torch.models.convert import causal_lm_params  # noqa: E402
from nnstreamer_tpu_torch.serving import LMEngine, PagedKVCache  # noqa: E402
from nnstreamer_tpu_torch.serving import prompt_path_hashes  # noqa: E402
from nnstreamer_tpu_torch.serving.kv_cache import empty_page_pool  # noqa: E402

V, D, H, L, MAXLEN = 97, 32, 4, 2, 64
PS = 8  # page size of every engine case: 8 pages per max_len
CPU = torch.device("cpu")
RTOL, ATOL = 1e-4, 1e-5
KV_ENV = ("NNS_LM_KV_PAGE_SIZE", "NNS_LM_KV_PAGES", "NNS_LM_KV_SLOT_PAGES",
          "NNS_LM_KV_OFFLOAD")


@pytest.fixture(autouse=True)
def _no_kv_env(monkeypatch):
    for name in KV_ENV:
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module")
def jparams():
    return jlm.init_causal_lm(jax.random.PRNGKey(7), V, D, H, L, MAXLEN)


@pytest.fixture(scope="module")
def tparams(jparams):
    return causal_lm_params(jax.tree_util.tree_map(np.asarray, jparams), CPU)


def prompts_rng(n, lo=1, hi=24, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, V, rng.integers(lo, hi)).astype(np.int32)
            for _ in range(n)]


def _run(engine, jobs, **submit):
    rids = [engine.submit(p, max_new=mn, **submit) for p, mn in jobs]
    res = engine.run()
    return [res[r] for r in rids]


def _three(jparams, tparams, jobs, **kw):
    """The jobs through the JAX paged engine, the port's paged engine and
    the port's contiguous engine: (tokens of each, the two kv_stats, the
    port's paged engine)."""
    jeng = JaxEngine(jparams, H, MAXLEN, **kw)
    teng = LMEngine(tparams, H, MAXLEN, device=CPU, **kw)
    cont_kw = {k: v for k, v in kw.items() if not k.startswith("kv_")}
    ceng = LMEngine(tparams, H, MAXLEN, device=CPU, **cont_kw)
    return ((_run(jeng, jobs), _run(teng, jobs), _run(ceng, jobs)),
            (jeng.kv_stats, teng.kv_stats), teng)


def _assert_three(jparams, tparams, jobs, **kw):
    (want, got, cont), (jkv, tkv), teng = _three(jparams, tparams, jobs, **kw)
    assert got == want
    assert got == cont
    assert tkv == jkv
    return got, tkv, teng


# --------------------------------------------------------------------------- #
# allocator units: the same operations on both caches
# --------------------------------------------------------------------------- #

def _caches(n_pages=8, ps=4, **kw):
    return (JaxKV(1, 1, ps, n_pages, 2, **kw),
            PagedKVCache(1, 1, ps, n_pages, 2, device=CPU, **kw))


def _state(kv):
    return (list(kv.free), kv.reserved, dict(kv.stats), len(kv._lru),
            kv.shared_pages(), kv.used_pages(), kv.available())


def _toks(seed, n):
    return np.random.default_rng(seed).integers(0, 50, n).astype(np.int32)


def test_reservation_accounting_balances():
    for kv in _caches():
        prompt = _toks(0, 10)
        plan = kv.lookup(prompt)
        assert plan.hit_len == 0
        lease = kv.admit(plan, b_needed=4)
        assert len(lease.pages) == 3 and lease.reserved == 1
        assert kv.reserved == 1 and kv.available() == 8 - 4
        kv.lease_alloc(lease)
        assert lease.reserved == 0 and kv.reserved == 0
        with pytest.raises(RuntimeError, match="reservation"):
            kv.lease_alloc(lease)
        kv.release(lease, prompt)
        assert kv.reserved == 0
        assert kv.available() == 8 and len(kv._lru) == 2
    jkv, tkv = _caches()
    for kv in (jkv, tkv):
        lease = kv.admit(kv.lookup(_toks(0, 10)), b_needed=4)
        kv.lease_alloc(lease)
        kv.release(lease, _toks(0, 10))
    assert _state(tkv) == _state(jkv)


def test_admissible_gates_and_lazy_eviction_reclaims():
    states, pages = [], []
    for kv in _caches(n_pages=4):
        p1, p2, p3 = _toks(1, 8), _toks(2, 8), _toks(3, 8)
        l1 = kv.admit(kv.lookup(p1), b_needed=2)
        kv.admit(kv.lookup(p2), b_needed=2)
        plan3 = kv.lookup(p3)
        assert not kv.admissible(plan3, b_needed=2)
        kv.release(l1, p1)
        assert kv.admissible(plan3, b_needed=2)
        l3 = kv.admit(plan3, b_needed=2)
        assert len(l3.pages) == 2
        assert kv.stats["evictions"] == 2
        states.append(_state(kv))
        pages.append(l3.pages)
    assert states[0] == states[1] and pages[0] == pages[1]


def test_lookup_caps_hit_at_t_minus_1_and_cow_matches():
    states = []
    for kv in _caches():
        prompt = _toks(4, 8)
        kv.release(kv.admit(kv.lookup(prompt), b_needed=2), prompt)
        plan = kv.lookup(prompt)
        assert len(plan.nodes) == 1
        assert plan.cow is not None and plan.cow[1] == 3
        assert plan.hit_len == 7
        lease = kv.admit(plan, b_needed=2)
        assert kv.stats["cow_copies"] == 1
        assert plan.cow[0].page not in lease.own
        states.append((_state(kv), lease.pages, sorted(lease.own)))
    assert states[0] == states[1]


def test_cow_copy_preserves_page_bits():
    jkv, tkv = _caches()
    prompt = _toks(5, 8)
    other = np.concatenate([prompt[:2], _toks(6, 6)])
    l0 = jkv.admit(jkv.lookup(prompt), b_needed=2)
    jkv.kpool = jkv.kpool.at[l0.pages[0]].set(1.5)
    jkv.release(l0, prompt)
    t0 = tkv.admit(tkv.lookup(prompt), b_needed=2)
    tkv.kpool[t0.pages[0]] = 1.5
    tkv.release(t0, prompt)
    jplan, tplan = jkv.lookup(other), tkv.lookup(other)
    assert tplan.nodes == [] and tplan.cow is not None and tplan.cow[1] == 2
    jl, tl = jkv.admit(jplan, b_needed=2), tkv.admit(tplan, b_needed=2)
    assert tl.pages == jl.pages
    np.testing.assert_array_equal(tkv.kpool[tl.pages[0]].numpy(),
                                  np.full((1, 4, 2), 1.5, np.float32))
    np.testing.assert_array_equal(tkv.kpool.numpy()[1:],
                                  np.asarray(jkv.kpool)[1:])
    assert _state(tkv) == _state(jkv)


def test_eviction_is_deterministic():
    def drive(kv):
        for seed in range(6):
            p = _toks(seed, 12)
            kv.release(kv.admit(kv.lookup(p), b_needed=3), p)
        return list(kv.free), dict(kv.stats)

    jkv, tkv = _caches(n_pages=6)
    a, b = drive(jkv), drive(tkv)
    assert a == b and a[1]["evictions"] > 0
    assert drive(_caches(n_pages=6)[1]) == b


def test_host_offload_roundtrips_page_bits():
    jkv, tkv = _caches(n_pages=2, host_offload=True)
    prompt = _toks(7, 8)
    jl, tl = (kv.admit(kv.lookup(prompt), b_needed=2) for kv in (jkv, tkv))
    assert tl.pages == jl.pages
    p1, p2 = tl.pages
    jkv.kpool = jkv.kpool.at[p1].set(1.25).at[p2].set(3.75)
    jkv.vpool = jkv.vpool.at[p1].set(2.5)
    tkv.kpool[p1], tkv.kpool[p2], tkv.vpool[p1] = 1.25, 3.75, 2.5
    other = _toks(8, 8)
    for kv, lease in ((jkv, jl), (tkv, tl)):
        kv.release(lease, prompt)
        kv.release(kv.admit(kv.lookup(other), b_needed=2), other)
        assert kv.stats["offloads"] == 2 and kv.stats["evictions"] == 2
        plan = kv.lookup(prompt)
        assert len(plan.nodes) == 1 and plan.cow is None
    # the port's pools are written in place after the offload: the host
    # copies must not alias them
    tkv.kpool.fill_(-1.0)
    tkv.vpool.fill_(-1.0)
    leases = [kv.admit(kv.lookup(prompt), b_needed=2) for kv in (jkv, tkv)]
    assert leases[0].pages == leases[1].pages
    assert tkv.stats["reuploads"] == 1
    pid = leases[1].pages[0]
    np.testing.assert_array_equal(tkv.kpool[pid].numpy(),
                                  np.full((1, 4, 2), 1.25, np.float32))
    np.testing.assert_array_equal(tkv.vpool[pid].numpy(),
                                  np.full((1, 4, 2), 2.5, np.float32))
    assert _state(tkv) == _state(jkv)


def test_pool_validation():
    with pytest.raises(ValueError, match=">= 1"):
        PagedKVCache(1, 1, 0, 4, 2, device=CPU)
    with pytest.raises(ValueError, match=">= 1"):
        PagedKVCache(1, 1, 4, 0, 2, device=CPU)
    assert empty_page_pool(3, 2, 2, 4, 5, CPU)[0].shape == (4, 4, 4, 5)


@pytest.mark.parametrize("offload", [False, True], ids=["drop", "offload"])
@pytest.mark.parametrize("seed", range(4))
def test_random_operation_sequences_match_jax(seed, offload):
    # lookups, trims, admissions, decode allocations and releases in a
    # seeded order over a small pool: every state and page id equal
    rng = np.random.default_rng(100 + seed)
    jkv, tkv = _caches(n_pages=10, ps=4, host_offload=offload)
    base = _toks(seed, 9)
    live = []
    for _ in range(40):
        if live and (rng.random() < 0.4 or len(live) > 3):
            i = int(rng.integers(len(live)))
            prompt, jl, tl = live.pop(i)
            seq = np.concatenate([prompt, _toks(int(rng.integers(99)), 3)])
            jkv.release(jl, seq)
            tkv.release(tl, seq)
        else:
            n = int(rng.integers(2, 14))
            prompt = np.concatenate([base[:int(rng.integers(0, 9))],
                                     _toks(int(rng.integers(99)), n)])[:14]
            budget = -(-(prompt.size + 3) // 4)
            jp, tp = jkv.lookup(prompt), tkv.lookup(prompt)
            if rng.random() < 0.3:
                jp.drop_tail()
                tp.drop_tail()
            assert tp.hit_len == jp.hit_len
            ok = tkv.admissible(tp, budget)
            assert ok == jkv.admissible(jp, budget)
            if ok:
                jl, tl = jkv.admit(jp, budget), tkv.admit(tp, budget)
                while tl.reserved and rng.random() < 0.5:
                    assert tkv.lease_alloc(tl) == jkv.lease_alloc(jl)
                assert tl.pages == jl.pages and tl.own == jl.own
                live.append((prompt, jl, tl))
        assert _state(tkv) == _state(jkv)
        assert tkv.prefix_digest() == jkv.prefix_digest()


def test_prompt_path_hashes_and_digest_match_jax():
    from nnstreamer_tpu.serving import prompt_path_hashes as jhashes

    for n in (0, 3, 8, 21):
        assert prompt_path_hashes(_toks(n, n), 4) == jhashes(_toks(n, n), 4)
    jkv, tkv = _caches()
    for kv in (jkv, tkv):
        for seed in (1, 2):
            p = _toks(seed, 12)
            kv.release(kv.admit(kv.lookup(p), b_needed=3), p)
    assert tkv.prefix_digest() == jkv.prefix_digest() != []
    assert tkv.prefix_digest(2) == jkv.prefix_digest(2)
    assert tkv.prefix_hit_rate() == jkv.prefix_hit_rate()


# --------------------------------------------------------------------------- #
# page documents: export from either package, import into the other
# --------------------------------------------------------------------------- #

def _filled(kv, seed, prompt):
    """Admit and release ``prompt`` after writing seeded bits into its
    pages; returns the bits by page."""
    lease = kv.admit(kv.lookup(prompt), b_needed=-(-prompt.size // 4))
    bits = {}
    for i, pid in enumerate(lease.pages):
        k = np.random.default_rng(seed + i).standard_normal((1, 4, 2)).astype(np.float32)
        bits[pid] = (k, -k)
        if isinstance(kv, PagedKVCache):
            kv.kpool[pid], kv.vpool[pid] = torch.from_numpy(k), torch.from_numpy(-k)
        else:
            kv.kpool = kv.kpool.at[pid].set(k)
            kv.vpool = kv.vpool.at[pid].set(-k)
    kv.release(lease, prompt)
    return bits


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_page_documents_interchange(direction):
    jkv, tkv = _caches()
    src, dst = (tkv, jkv) if direction == "port_to_jax" else (jkv, tkv)
    prompt = _toks(9, 12)
    bits = _filled(src, 40, prompt)
    doc = src.export_pages(prompt)
    assert doc["dtype"] == "float32" and len(doc["entries"]) == 3
    assert src.export_pages(_toks(10, 3)) is None
    assert dst.import_pages(doc) == 3
    assert dst.stats["imported_pages"] == 3
    back = dst.export_pages(prompt)
    for ent, (pid, (k, v)) in zip(back["entries"], sorted(bits.items())):
        np.testing.assert_allclose(np.asarray(ent["k"]), k, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(np.asarray(ent["v"]), v, rtol=RTOL, atol=ATOL)
    # the imported chunks hit like locally released prefix state
    plan = dst.lookup(prompt)
    assert plan.hit_len == 11
    # splicing again uploads nothing (same chunk path, same bits)
    assert dst.import_pages(doc) == 0
    # the leaf's path alone, from the spill API
    leaf = src.coldest(1)[0]
    path_doc = src.export_path(leaf)
    assert [e["key"] for e in path_doc["entries"]] == \
        [e["key"] for e in doc["entries"]][:len(path_doc["entries"])]


def test_page_document_errors_match_jax():
    jkv, tkv = _caches()
    prompt = _toks(11, 8)
    _filled(jkv, 3, prompt)
    doc = jkv.export_pages(prompt)
    cases = [dict(doc, v=2), dict(doc, page_size=8), dict(doc, dtype="bfloat16"),
             dict(doc, entries=[dict(doc["entries"][0], key=[1, 2])]),
             dict(doc, entries=[dict(doc["entries"][0],
                                     k=np.zeros((1, 4, 3), np.float32))]), [1]]
    for bad in cases:
        with pytest.raises(ValueError) as want:
            JaxKV(1, 1, 4, 8, 2).import_pages(bad)
        with pytest.raises(ValueError) as got:
            tkv.import_pages(bad)
        assert str(got.value) == str(want.value)
    small_j, small_t = JaxKV(1, 1, 4, 1, 2), PagedKVCache(1, 1, 4, 1, 2, device=CPU)
    with pytest.raises(RuntimeError) as want:
        small_j.import_pages(doc)
    with pytest.raises(RuntimeError) as got:
        small_t.import_pages(doc)
    assert str(got.value) == str(want.value)
    assert _state(small_t) == _state(small_j)
    # shed: a cold leaf leaves the tree; a pinned node refuses
    for kv in (jkv, tkv):
        if kv is tkv:
            _filled(kv, 3, prompt)
        leaf = kv.coldest(4)[-1]
        assert kv.shed(leaf) == 1 and kv.stats["spilled_pages"] == 1
        kv._pin(kv.coldest(1)[0])
        pinned = next(n for n in kv.root.children.values() if n.ref)
        with pytest.raises(RuntimeError, match="pinned"):
            kv.shed(pinned)


# --------------------------------------------------------------------------- #
# the paged forms
# --------------------------------------------------------------------------- #

def _both_pools(kc_j, vc_j, ps=PS):
    """One flat (LH, M, hd) JAX cache scattered into fresh pools of both
    packages (pages 1..M/ps in order): (jax kpool, vpool, table, port
    kpool, vpool, table)."""
    lh, m, hd = kc_j.shape
    b = m // ps
    kp, vp = jax_pool(b, 1, lh, ps, hd)
    table = jnp.arange(1, b + 1, dtype=jnp.int32)
    kp = kp.at[table].set(kc_j.reshape(lh, b, ps, hd).transpose(1, 0, 2, 3))
    vp = vp.at[table].set(vc_j.reshape(lh, b, ps, hd).transpose(1, 0, 2, 3))
    return (kp, vp, table, torch.from_numpy(np.array(kp)),
            torch.from_numpy(np.array(vp)), torch.arange(1, b + 1))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_paged_view_is_the_contiguous_layout(jparams, tparams):
    prompt = prompts_rng(1, lo=10, hi=11, seed=20)[0]
    _, kc, vc, _ = jlm.lm_prefill(jparams, jnp.asarray(prompt[None]), H, MAXLEN)
    kp, _, table, tkp, _, ttable = _both_pools(kc, vc)
    view = tlm.paged_view_slots(tkp, ttable[None])[0]
    np.testing.assert_array_equal(view.numpy(), np.asarray(kc))
    np.testing.assert_array_equal(
        view.numpy(), np.asarray(jlm.paged_view_slots(kp, table[None])[0]))
    np.testing.assert_array_equal(tlm._paged_view(tkp, ttable).numpy(),
                                  view.numpy())


def test_paged_decode_steps_match(jparams, tparams):
    prompt = prompts_rng(1, lo=9, hi=10, seed=21)[0]
    lg, kc, vc, pos = jlm.lm_prefill(jparams, jnp.asarray(prompt[None]), H, MAXLEN)
    kp, vp, table, tkp, tvp, ttable = _both_pools(kc, vc)
    tables, poss = table[None], pos[None]
    tpos = torch.from_numpy(np.array(poss))
    # the port's contiguous slot caches, the reference its paged step must
    # equal bit for bit
    tkc = torch.from_numpy(np.array(kc))[None].clone()
    tvc = torch.from_numpy(np.array(vc))[None].clone()
    tpos_c = tpos.clone()
    tok = jnp.argmax(lg, -1).astype(jnp.int32)[:, None][None]
    step_p = jax.jit(jlm.lm_decode_step_paged, static_argnums=(6,))
    for _ in range(2 * PS + 3):  # across two page boundaries
        ttok = torch.from_numpy(np.array(tok))
        lg_j, kp, vp, poss = step_p(jparams, tok, kp, vp, tables, poss, H)
        lg_t, _, _, tpos = tlm.lm_decode_step_paged(tparams, ttok, tkp, tvp,
                                                    ttable[None], tpos, H)
        lg_c, _, _, tpos_c = tlm.lm_decode_step_slots(tparams, ttok, tkc, tvc,
                                                      tpos_c, H)
        np.testing.assert_array_equal(lg_t.numpy(), lg_c.numpy())
        np.testing.assert_array_equal(tpos.numpy(), tpos_c.numpy())
        _close(lg_t, lg_j)
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(poss))
        tok = jnp.argmax(lg_j, -1).astype(jnp.int32)[:, :, None]
    np.testing.assert_array_equal(
        tlm.paged_view_slots(tkp, ttable[None]).numpy(), tkc.numpy())
    _close(tkp[1:], np.asarray(kp)[1:])
    _close(tvp[1:], np.asarray(vp)[1:])


def test_paged_verify_window_matches(jparams, tparams):
    rng = np.random.default_rng(22)
    prompt = rng.integers(0, V, (1, 12)).astype(np.int32)
    _, kc, vc, pos = jlm.lm_prefill(jparams, jnp.asarray(prompt), H, MAXLEN)
    window = rng.integers(0, V, (1, 5)).astype(np.int32)
    kp, vp, table, tkp, tvp, ttable = _both_pools(kc, vc)
    jl, kp, vp, jpos = jlm.lm_verify_window_paged(
        jparams, jnp.asarray(window), kp, vp, table[None], pos[None], H)
    tkc = torch.from_numpy(np.array(kc))[None].clone()
    tvc = torch.from_numpy(np.array(vc))[None].clone()
    tpos = torch.from_numpy(np.array(pos))[None]
    wl, _, _, wpos = tlm.lm_verify_window_slots(
        tparams, torch.from_numpy(window), tkc, tvc, tpos.clone(), H)
    tl, rk, rv, tpos2 = tlm.lm_verify_window_paged(
        tparams, torch.from_numpy(window), tkp, tvp, ttable[None], tpos, H)
    assert rk is tkp and rv is tvp  # written in place, never rebound
    np.testing.assert_array_equal(tl.numpy(), wl.numpy())
    np.testing.assert_array_equal(tpos2.numpy(), wpos.numpy())
    np.testing.assert_array_equal(
        tlm.paged_view_slots(tkp, ttable[None]).numpy(), tkc.numpy())
    _close(tl, jl)
    np.testing.assert_array_equal(tpos2.numpy(), np.asarray(jpos))
    _close(tkp[1:], np.asarray(kp)[1:])


@pytest.mark.parametrize("pos0,suffix", [(8, 5), (12, 9), (16, 16)],
                         ids=["page_start", "mid_page", "two_pages"])
def test_prefill_paged_matches_jax(jparams, tparams, pos0, suffix):
    rng = np.random.default_rng(23 + pos0)
    prompt = rng.integers(0, V, (1, pos0)).astype(np.int32)
    _, kc, vc, _ = jlm.lm_prefill(jparams, jnp.asarray(prompt), H, MAXLEN)
    kp, vp, table, tkp, tvp, ttable = _both_pools(kc, vc)
    window = np.zeros((1, 16), np.int32)
    window[0, :suffix] = rng.integers(0, V, suffix)
    jl, kp, vp, jpos = jlm.lm_prefill_paged(
        jparams, jnp.asarray(window), kp, vp, table, jnp.int32(pos0),
        jnp.int32(suffix), H)
    tl, _, _, tpos = tlm.lm_prefill_paged(
        tparams, torch.from_numpy(window), tkp, tvp, ttable,
        torch.tensor(pos0, dtype=torch.int32),
        torch.tensor(suffix, dtype=torch.int32), H)
    assert tl.shape == (1, V) and int(tpos[0]) == int(jpos[0]) == pos0 + suffix
    _close(tl, jl)
    _close(tkp[1:], np.asarray(kp)[1:])
    _close(tvp[1:], np.asarray(vp)[1:])


def test_touch_span_bounds():
    for w, ps, b in ((1, 8, 8), (8, 8, 8), (9, 8, 8), (64, 8, 8), (16, 64, 16)):
        assert tlm.paged_touch_span(w, ps, b) == jlm.paged_touch_span(w, ps, b)
    assert tlm.paged_touch_span(64, 8, 8) == 8  # capped at the table


def test_scatter_clips_its_window_to_the_table():
    # a window starting on the table's last page is left-clipped: it
    # rewrites the page before with the bits it gathered
    pool = torch.arange(5 * 2 * 4 * 3, dtype=torch.float32).view(5, 2, 4, 3)
    tables = torch.tensor([[2, 4, 1], [0, 0, 0]])
    views = tlm.paged_view_slots(pool, tables)
    views[0, :, 9] = -1.0  # slot 0 writes position 9, its third page
    before = pool.clone()
    tlm.paged_update_slots(pool, views, tables, torch.tensor([9, 30]), 2)
    want = before.clone()
    want[1, :, 1] = -1.0
    np.testing.assert_array_equal(pool[1:].numpy(), want[1:].numpy())


# --------------------------------------------------------------------------- #
# the rows' bits do not depend on the route, the row count or the columns
# --------------------------------------------------------------------------- #

def test_tree_sum_is_a_sum_and_ignores_zero_tails():
    x = torch.from_numpy(np.random.default_rng(60).standard_normal((3, 50, 7))
                         .astype(np.float32))
    for dim in (0, 1, 2, -1):
        np.testing.assert_allclose(tlm._tree_sum(x, dim).numpy(),
                                   x.sum(dim).numpy(), rtol=1e-5, atol=1e-5)
    # zeros past a power of two change no bit: the halves they pair with
    # pass through
    head = x[:, :32]
    padded = torch.cat([head, torch.zeros((3, 96, 7))], dim=1)
    assert torch.equal(tlm._tree_sum(padded, 1), tlm._tree_sum(head, 1))
    assert tlm.attend_cols(1, 64) == 1 and tlm.attend_cols(33, 64) == 64
    assert tlm.attend_cols(200, 128) == 128 and tlm.attend_cols(96, 1024) == 128


def test_row_blocked_gemm_rows_do_not_depend_on_the_row_count():
    from nnstreamer_tpu_torch.ops.int8 import MIN_ROWS, matmul_any

    rng = np.random.default_rng(61)
    x = torch.from_numpy(rng.standard_normal((100, 48)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((48, 40)).astype(np.float32))
    full = matmul_any(x, w, row_blocks=True)
    for n in (1, 5, MIN_ROWS, MIN_ROWS + 1, 64, 99):
        assert torch.equal(matmul_any(x[:n], w, row_blocks=True), full[:n])
    np.testing.assert_allclose(full.numpy(), (x @ w).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quant", ["float32", "w8a8"])
def test_window_prefill_and_prefix_hit_give_the_same_bits(jparams, quant):
    # the two admission routes of a prompt sharing a 2-page prefix: its
    # suffix K/V rows and first-token logits bit-equal; the hit over the
    # columns its window can see bit-equal to the hit over the whole view
    tree = jlm.quantize_lm_params(jparams) if quant == "w8a8" else jparams
    params = causal_lm_params(jax.tree_util.tree_map(np.asarray, tree), CPU)
    rng = np.random.default_rng(62)
    prefix = rng.integers(0, V, 16).astype(np.int32)
    table = torch.arange(1, MAXLEN // PS + 1)
    for n in (1, 7, 16, 30):
        prompt = np.concatenate([prefix, rng.integers(0, V, n).astype(np.int32)])
        t = prompt.size
        padded = torch.zeros((1, min(MAXLEN, max(16, 1 << (t - 1).bit_length()))),
                             dtype=torch.int32)
        padded[0, :t] = torch.from_numpy(prompt)
        lg_a, kc, vc, pos = tlm.lm_prefill_window(params, padded, t, H, MAXLEN)
        assert int(pos[0]) == t
        kp, vp = empty_page_pool(MAXLEN // PS, L, H, PS, D // H, CPU)
        for pool, c in ((kp, kc), (vp, vc)):  # the shared prefix's two pages
            pool.index_copy_(0, table[:2], c.view(L * H, MAXLEN // PS, PS, D // H)
                             .transpose(0, 1)[:2])
        window = torch.zeros((1, max(16, 1 << (n - 1).bit_length())), dtype=torch.int32)
        window[0, :n] = torch.from_numpy(prompt[16:])
        full = (kp.clone(), vp.clone())
        args = (table, torch.tensor(16), torch.tensor(n), H)
        lg_f, _, _, _ = tlm.lm_prefill_paged(params, window, *full, *args)
        lg_b, _, _, pos_b = tlm.lm_prefill_paged(
            params, window, kp, vp, *args, tlm.attend_cols(16 + window.shape[1], MAXLEN))
        assert int(pos_b[0]) == t
        assert torch.equal(lg_a, lg_b) and torch.equal(lg_f, lg_b)
        assert torch.equal(full[0][1:], kp[1:]) and torch.equal(full[1][1:], vp[1:])
        view_k = tlm.paged_view_slots(kp, table[None])[0]
        view_v = tlm.paged_view_slots(vp, table[None])[0]
        assert torch.equal(view_k[:, :t], kc[:, :t])
        assert torch.equal(view_v[:, :t], vc[:, :t])


def test_window_prefill_matches_the_jax_masked_prefill(jparams, tparams):
    rng = np.random.default_rng(63)
    for t, tb in ((5, 16), (19, 32), (64, 64)):
        tok = np.zeros((1, tb), np.int32)
        tok[0, :t] = rng.integers(0, V, t)
        jl, jk, jv, jpos = jlm.lm_prefill_masked(jparams, jnp.asarray(tok),
                                                 jnp.int32(t), H, MAXLEN)
        tl, tk, tv, tpos = tlm.lm_prefill_window(
            tparams, torch.from_numpy(tok), torch.tensor(t), H, MAXLEN)
        _close(tl, jl)
        _close(tk[:, :t], np.asarray(jk)[:, :t])
        _close(tv[:, :t], np.asarray(jv)[:, :t])
        assert int(tpos[0]) == int(jpos[0]) == t


def test_paged_decode_step_is_batch_invariant_at_min_rows(tparams):
    # 32 slots, ops/int8.MIN_ROWS: each slot's logits and page writes equal
    # the slot stepped alone, bit for bit
    from nnstreamer_tpu_torch.ops.int8 import MIN_ROWS

    rng = np.random.default_rng(64)
    own = 3
    kp, vp = empty_page_pool(MIN_ROWS * own, L, H, PS, D // H, CPU)
    kp.normal_(generator=torch.Generator().manual_seed(0))
    vp.normal_(generator=torch.Generator().manual_seed(1))
    tables = torch.zeros((MIN_ROWS, MAXLEN // PS), dtype=torch.int64)
    for s_ in range(MIN_ROWS):
        tables[s_, :own] = torch.arange(1 + s_ * own, 1 + (s_ + 1) * own)
    pos = torch.from_numpy(rng.integers(0, own * PS, (MIN_ROWS, 1)).astype(np.int32))
    tok = torch.from_numpy(rng.integers(0, V, (MIN_ROWS, 1, 1)).astype(np.int32))
    k32, v32 = kp.clone(), vp.clone()
    lg32, _, _, _ = tlm.lm_decode_step_paged(tparams, tok, k32, v32, tables, pos, H)
    for s_ in (0, 13, MIN_ROWS - 1):
        k1, v1 = kp.clone(), vp.clone()
        lg1, _, _, _ = tlm.lm_decode_step_paged(tparams, tok[s_:s_ + 1], k1, v1,
                                                tables[s_:s_ + 1], pos[s_:s_ + 1], H)
        mine = tables[s_, :own]
        assert torch.equal(lg1[0], lg32[s_])
        assert torch.equal(k1[mine], k32[mine]) and torch.equal(v1[mine], v32[mine])


# --------------------------------------------------------------------------- #
# engine: the port's paged tokens against the JAX paged engine's and the
# port's contiguous engine's
# --------------------------------------------------------------------------- #

def test_paged_engine_bit_identical_to_contiguous(jparams, tparams):
    jobs = [(p, 6 + i % 5) for i, p in enumerate(prompts_rng(7, seed=30))]
    _, kv, _ = _assert_three(jparams, tparams, jobs, n_slots=2, chunk=4,
                             kv_page_size=PS)
    assert kv["pages_peak"] > 0


def test_prefix_sharing_hits_and_stays_exact(jparams, tparams):
    prefix = prompts_rng(1, lo=16, hi=17, seed=31)[0]  # 2 full pages
    jobs = [(np.concatenate([prefix, s]), 8)
            for s in prompts_rng(5, lo=4, hi=12, seed=32)]
    _, kv, teng = _assert_three(jparams, tparams, jobs, n_slots=2, chunk=4,
                                kv_page_size=PS)
    assert kv["hit_requests"] >= 3 and kv["hit_tokens"] >= 3 * 16
    assert teng.prefix_hit_rate == kv["hit_tokens"] / kv["prompt_tokens"]
    assert teng.kv_prefix_digest()[0] == prompt_path_hashes(prefix, PS)[0]


def test_cow_divergence_stays_exact(jparams, tparams):
    prefix = prompts_rng(1, lo=12, hi=13, seed=33)[0]
    jobs = [(np.concatenate([prefix, s]), 7)
            for s in prompts_rng(4, lo=3, hi=10, seed=34)]
    _, kv, _ = _assert_three(jparams, tparams, jobs, n_slots=2, chunk=4,
                             kv_page_size=PS)
    assert kv["cow_copies"] >= 1


def test_pool_exhaustion_defers_admission_fifo(jparams, tparams):
    jobs = [(p, 8) for p in prompts_rng(6, lo=20, hi=24, seed=35)]
    _, kv, _ = _assert_three(jparams, tparams, jobs, n_slots=2, chunk=4,
                             kv_page_size=PS, kv_pages=8)
    assert kv["pages_peak"] <= 8


def test_engine_eviction_deterministic(jparams, tparams):
    jobs = [(p, 8) for p in prompts_rng(6, lo=18, hi=28, seed=36)]
    out_a, kv_a, _ = _assert_three(jparams, tparams, jobs, n_slots=2, chunk=4,
                                   kv_page_size=PS, kv_pages=8)
    eng = LMEngine(tparams, H, MAXLEN, n_slots=2, chunk=4, kv_page_size=PS,
                   kv_pages=8, device=CPU)
    assert _run(eng, jobs) == out_a and eng.kv_stats == kv_a
    assert kv_a["evictions"] > 0


def test_engine_host_offload_reuploads_and_stays_exact(jparams, tparams):
    base = prompts_rng(1, lo=24, hi=25, seed=37)[0]
    churn = prompts_rng(2, lo=22, hi=26, seed=38)
    kw = dict(n_slots=2, chunk=4, kv_page_size=PS, kv_pages=8,
              kv_host_offload=True)
    jeng = JaxEngine(jparams, H, MAXLEN, **kw)
    teng = LMEngine(tparams, H, MAXLEN, device=CPU, **kw)
    ceng = LMEngine(tparams, H, MAXLEN, n_slots=2, chunk=4, device=CPU)
    for jobs in ([(base, 8)], [(p, 8) for p in churn], [(base, 8)]):
        got = _run(teng, jobs)
        assert got == _run(jeng, jobs) == _run(ceng, jobs)
        assert teng.kv_stats == jeng.kv_stats
    kv = teng.kv_stats
    assert kv["offloads"] >= 1 and kv["reuploads"] >= 1 and kv["hit_tokens"] > 0


def test_mid_flight_admission_paged(jparams, tparams):
    prompts = prompts_rng(5, seed=39)
    outs = []
    for eng in (JaxEngine(jparams, H, MAXLEN, n_slots=2, chunk=4, kv_page_size=PS),
                LMEngine(tparams, H, MAXLEN, n_slots=2, chunk=4, kv_page_size=PS,
                         device=CPU),
                LMEngine(tparams, H, MAXLEN, n_slots=2, chunk=4, device=CPU)):
        rids = [eng.submit(p, max_new=10) for p in prompts[:2]]
        eng.step_iteration()
        eng.step_iteration()
        rids += [eng.submit(p, max_new=10) for p in prompts[2:]]
        res = eng.run()
        outs.append(([res[r] for r in rids], eng.kv_stats))
    assert outs[1][0] == outs[0][0] == outs[2][0]
    assert outs[1][1] == outs[0][1]


def test_paged_waste_invariant_and_sampling(jparams, tparams):
    greedy = prompts_rng(3, seed=40)
    sampled = prompts_rng(1, seed=41)[0]
    outs = []
    for eng in (JaxEngine(jparams, H, MAXLEN, n_slots=2, chunk=4, kv_page_size=PS),
                LMEngine(tparams, H, MAXLEN, n_slots=2, chunk=4, kv_page_size=PS,
                         device=CPU),
                LMEngine(tparams, H, MAXLEN, n_slots=2, chunk=4, device=CPU)):
        rids = [eng.submit(p, max_new=3 + 4 * i) for i, p in enumerate(greedy)]
        rs = eng.submit(sampled, max_new=6, temperature=0.9, top_k=11, seed=3)
        res = eng.run()
        st = eng.stats
        assert eng.n_slots * st["decode_steps"] == \
            (st["tokens_out"] - st["prefills"]) + st["wasted_slot_steps"]
        outs.append(([res[r] for r in rids] + [res[rs]],
                     {k: v for k, v in st.items() if k != "wall_s"}))
    assert outs[1] == outs[0]
    assert outs[1][0] == outs[2][0]
    # the sampled stream alone, on a prefix-hit admission: the key folds in
    # pos0 + true_len, so it draws what a full prefill would
    solo = LMEngine(tparams, H, MAXLEN, n_slots=2, chunk=4, kv_page_size=PS,
                    device=CPU)
    _run(solo, [(sampled, 2)])
    r = solo.submit(sampled, max_new=6, temperature=0.9, top_k=11, seed=3)
    assert solo.run()[r] == outs[1][0][-1]
    assert solo.kv_stats["hit_requests"] == 1


def _repetitive(n):
    base = [5, 9, 2, 7]
    return np.array((base * (n // 4 + 1))[:n], np.int32)


def test_spec_paged_identical_and_accepting(jparams, tparams):
    jobs = [(_repetitive(10), 20), (_repetitive(6), 12)]
    _, _, teng = _assert_three(jparams, tparams, jobs, n_slots=2, chunk=4,
                               spec_draft=4, kv_page_size=PS)
    assert teng.stats["spec_iterations"] > 0 and teng.stats["spec_accepted"] > 0
    plain = _run(LMEngine(tparams, H, MAXLEN, n_slots=2, chunk=4, device=CPU), jobs)
    assert _run(LMEngine(tparams, H, MAXLEN, n_slots=2, chunk=4, spec_draft=4,
                         kv_page_size=PS, device=CPU), jobs) == plain


def test_bounded_slot_view_gates_spec_and_stays_exact(jparams, tparams):
    jobs = [(_repetitive(20), 13)]  # 20 + 13 - 1 == 32 fills the view exactly
    got, _, _ = _assert_three(jparams, tparams, jobs, n_slots=1, chunk=3,
                              spec_draft=8, kv_page_size=PS, kv_slot_pages=4)
    assert got == _run(LMEngine(tparams, H, MAXLEN, n_slots=1, chunk=3,
                                device=CPU), jobs)


def _same_error(exc, make_jax, make_port):
    with pytest.raises(exc) as want:
        make_jax()
    with pytest.raises(exc) as got:
        make_port()
    assert str(got.value) == str(want.value)


def test_bounded_slot_view_rejects_oversize(jparams, tparams):
    for kw, prompt in ((dict(kv_page_size=PS, kv_slot_pages=4),
                        np.arange(30, dtype=np.int32) % V),
                       (dict(kv_page_size=PS, kv_pages=2),
                        np.arange(20, dtype=np.int32) % V)):
        jeng = JaxEngine(jparams, H, MAXLEN, **kw)
        teng = LMEngine(tparams, H, MAXLEN, device=CPU, **kw)
        _same_error(ValueError, lambda: jeng.submit(prompt, max_new=8),
                    lambda: teng.submit(prompt, max_new=8))


@pytest.mark.parametrize("kw", [dict(kv_page_size=7),
                                dict(kv_page_size=PS, kv_slot_pages=9),
                                dict(kv_page_size=PS, kv_slot_pages=0),
                                dict(kv_page_size=-1),
                                dict(kv_page_size=PS, kv_slot_pages=1,
                                     spec_draft=8)],
                         ids=["divide", "slot_pages_over", "slot_pages_zero",
                              "negative", "spec_draft"])
def test_constructor_validation(jparams, tparams, kw):
    _same_error(ValueError, lambda: JaxEngine(jparams, H, MAXLEN, **kw),
                lambda: LMEngine(tparams, H, MAXLEN, device=CPU, **kw))


def test_env_transport_and_explicit_override(jparams, tparams, monkeypatch):
    monkeypatch.setenv("NNS_LM_KV_PAGE_SIZE", str(PS))
    monkeypatch.setenv("NNS_LM_KV_PAGES", "12")
    monkeypatch.setenv("NNS_LM_KV_SLOT_PAGES", "4")
    monkeypatch.setenv("NNS_LM_KV_OFFLOAD", "1")
    eng = LMEngine(tparams, H, MAXLEN, n_slots=2, device=CPU)
    jeng = JaxEngine(jparams, H, MAXLEN, n_slots=2)
    assert eng._kv is not None and eng._kv.n_pages == jeng._kv.n_pages == 12
    assert eng._m_slot == jeng._m_slot == 32
    assert eng._kv.host_offload and jeng._kv.host_offload
    assert eng._kc is None and eng._table.shape == (2, 4)
    eng0 = LMEngine(tparams, H, MAXLEN, n_slots=2, kv_page_size=0, device=CPU)
    assert eng0._kv is None and eng0.kv_stats is None
    assert eng0.prefix_hit_rate is None and eng0.kv_prefix_digest() == []
    monkeypatch.setenv("NNS_LM_KV_PAGE_SIZE", "junk")
    _same_error(ValueError, lambda: JaxEngine(jparams, H, MAXLEN, n_slots=2),
                lambda: LMEngine(tparams, H, MAXLEN, n_slots=2, device=CPU))


def test_env_paged_engine_stays_exact(jparams, tparams, monkeypatch):
    monkeypatch.setenv("NNS_LM_KV_PAGE_SIZE", str(PS))
    prompt = prompts_rng(1, lo=10, hi=11, seed=42)[0]
    got, _, teng = _assert_three(jparams, tparams, [(prompt, 9)], n_slots=2,
                                 chunk=4)
    assert teng._kv is not None


def test_w8a8_paged_matches_jax(jparams):
    jq = jlm.quantize_lm_params(jparams)
    tq = causal_lm_params(jax.tree_util.tree_map(np.asarray, jq), CPU)
    prefix = prompts_rng(1, lo=12, hi=13, seed=43)[0]
    jobs = [(np.concatenate([prefix, s]), 6)
            for s in prompts_rng(4, lo=2, hi=10, seed=44)]
    _, kv, _ = _assert_three(jq, tq, jobs, n_slots=2, chunk=4, kv_page_size=PS)
    assert kv["hit_requests"] >= 2


def test_admit_prefill_program_writes_the_jax_pages(jparams, tparams):
    # one admission each way (no hit, then a prefix hit): each slot's page
    # table, its prompt positions' K/V, position and first token against the
    # JAX engine's (the padded rows' K/V are garbage in both, overwritten
    # before attended: the port's admit prefill is a verify window, whose
    # padded rows attend each other)
    prefix = prompts_rng(1, lo=16, hi=17, seed=45)[0]
    jobs = [(np.concatenate([prefix, s]), 1) for s in prompts_rng(2, 3, 9, 46)]
    jeng = JaxEngine(jparams, H, MAXLEN, n_slots=2, chunk=4, kv_page_size=PS)
    teng = LMEngine(tparams, H, MAXLEN, n_slots=2, chunk=4, kv_page_size=PS,
                    device=CPU)
    for p, g in jobs:
        jeng.submit(p, max_new=g)
        teng.submit(p, max_new=g)
    jeng._admit()
    teng._admit()
    np.testing.assert_array_equal(teng._table_host, jeng._table_host)
    for slot, (p, _) in enumerate(jobs):
        table = jeng._table_host[slot]
        for tpool, jpool in ((teng._kv.kpool, jeng._kv.kpool),
                             (teng._kv.vpool, jeng._kv.vpool)):
            got = tlm.paged_view_slots(tpool, torch.from_numpy(table)[None])[0]
            want = jlm.paged_view_slots(jpool, jnp.asarray(table)[None])[0]
            _close(got[:, :len(p)], np.asarray(want)[:, :len(p)])
    np.testing.assert_array_equal(teng._pos.numpy(), np.asarray(jeng._pos))
    np.testing.assert_array_equal(teng._tokens.numpy(), np.asarray(jeng._tokens))
    assert teng.kv_stats == jeng.kv_stats and teng.kv_stats["hit_requests"] == 1


def test_paged_engine_enrolled_on_device_engine(tparams):
    from nnstreamer_tpu_torch.sched import DeviceEngine

    prefix = prompts_rng(1, lo=16, hi=17, seed=47)[0]
    jobs = [(np.concatenate([prefix, s]), 7) for s in prompts_rng(4, 3, 10, 48)]
    direct = LMEngine(tparams, H, MAXLEN, n_slots=2, chunk=4, kv_page_size=PS,
                      device=CPU)
    want = _run(direct, jobs)
    eng = DeviceEngine("kv-lm", max_coalesce=4)
    try:
        lm = LMEngine(tparams, H, MAXLEN, n_slots=2, chunk=4, kv_page_size=PS,
                      device=CPU)
        lm.enroll(eng)
        assert _run(lm, jobs) == want
        assert lm.kv_stats == direct.kv_stats
        tenant = next(t for t in eng.tenants() if t.name == "lm")
        assert tenant.stats["completed"] > 0
        lm.unenroll()
    finally:
        eng.stop()


# --------------------------------------------------------------------------- #
# the CLI's flags
# --------------------------------------------------------------------------- #

def _cli_error(main, argv, capsys):
    with pytest.raises(SystemExit) as e:
        main(argv + ["videotestsrc num-buffers=1 ! tensor_converter ! tensor_sink"])
    return e.value.code, capsys.readouterr().err.strip().splitlines()[-1]


@pytest.mark.parametrize("argv", [["--kv-pages", "8"], ["--kv-page-size", "0"],
                                  ["--kv-page-size", "8", "--kv-pages", "0"]],
                         ids=["pages-alone", "zero-ps", "zero-pages"])
def test_cli_kv_flag_errors_match_jax(argv, capsys):
    import os

    from nnstreamer_tpu.cli import main as jax_cli
    from nnstreamer_tpu_torch.cli import main as port_cli

    want = _cli_error(jax_cli, argv, capsys)
    got = _cli_error(port_cli, argv, capsys)
    assert got[0] == want[0] == 2
    assert got[1].split(": ", 1)[1] == want[1].split(": ", 1)[1]
    assert "NNS_LM_KV_PAGE_SIZE" not in os.environ
    assert "NNS_LM_KV_PAGES" not in os.environ


def test_cli_kv_flags_set_env_transport():
    import os

    from nnstreamer_tpu_torch.cli import main as port_cli

    try:
        rc = port_cli(["--device", "cpu", "--kv-page-size", "8", "--kv-pages", "64",
                       "--timeout", "30", "videotestsrc num-buffers=2 width=8 "
                       "height=8 ! tensor_converter ! tensor_sink"])
        assert rc == 0
        assert os.environ["NNS_LM_KV_PAGE_SIZE"] == "8"
        assert os.environ["NNS_LM_KV_PAGES"] == "64"
        eng = LMEngine(causal_lm_params(tlm.init_causal_lm(0, V, D, H, L, MAXLEN),
                                        CPU), H, MAXLEN, n_slots=2, device=CPU)
        assert eng._kv.page_size == 8 and eng._kv.n_pages == 64
    finally:
        os.environ.pop("NNS_LM_KV_PAGE_SIZE", None)
        os.environ.pop("NNS_LM_KV_PAGES", None)


# --------------------------------------------------------------------------- #
# stress (excluded from tier-1) and the card
# --------------------------------------------------------------------------- #

@pytest.mark.slow
def test_many_requests_through_small_pool_stress(jparams, tparams):
    prefix = prompts_rng(1, lo=16, hi=17, seed=50)[0]
    rng = np.random.default_rng(51)
    jobs = []
    for i in range(24):
        if i % 3:
            p = np.concatenate([prefix, rng.integers(0, V, rng.integers(2, 14))
                                .astype(np.int32)])
        else:
            p = rng.integers(0, V, rng.integers(8, 30)).astype(np.int32)
        jobs.append((p, 4 + i % 9))
    _, kv, _ = _assert_three(jparams, tparams, jobs, n_slots=8, chunk=4,
                             kv_page_size=PS, kv_pages=32)
    assert kv["pages_peak"] <= 32 and kv["hit_requests"] > 0


@pytest.mark.cuda
def test_cow_and_reupload_admissions_replay_equal_to_eager(jparams):
    # the allocator's page writes (a COW copy, re-uploads) land between
    # replays of the engine's graphs: a replayed run must equal the eager
    # one token for token and page for page (pages 1..n)
    from nnstreamer_tpu_torch.core import graphs

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs)")
    params = causal_lm_params(jax.tree_util.tree_map(np.asarray, jparams), "cuda")
    prefix = prompts_rng(1, lo=12, hi=13, seed=52)[0]
    first = np.concatenate([prefix, prompts_rng(1, 8, 9, 53)[0]])
    jobs = [(first, 8), (np.concatenate([prefix, prompts_rng(1, 8, 9, 54)[0]]), 8),
            (prompts_rng(1, 20, 21, 55)[0], 8), (prompts_rng(1, 20, 21, 56)[0], 8),
            (first, 8)]

    def serve():
        eng = LMEngine(params, H, MAXLEN, n_slots=1, chunk=4, kv_page_size=PS,
                       kv_pages=6, kv_host_offload=True, device="cuda")
        outs = [_run(eng, [job]) for job in jobs]
        torch.cuda.synchronize()
        return outs, eng.kv_stats, eng._kv.kpool[1:].cpu(), eng._kv.vpool[1:].cpu()

    graphs.reset_stats()
    replayed = serve()
    assert graphs.stats()["replays"] > 0
    with graphs.disabled():
        eager = serve()
    assert replayed[0] == eager[0] and replayed[1] == eager[1]
    assert min(eager[1]["cow_copies"], eager[1]["offloads"], eager[1]["reuploads"]) > 0
    assert torch.equal(replayed[2], eager[2]) and torch.equal(replayed[3], eager[3])
    cont = LMEngine(params, H, MAXLEN, n_slots=2, chunk=4, device="cuda")
    assert [o[0] for o in replayed[0]] == _run(cont, jobs)
