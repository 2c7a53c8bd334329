"""The port's tensor-parallel serving engine (nnstreamer_tpu_torch/serving/
tp_engine.py ``TPLMEngine``) against the port's ``LMEngine`` and the JAX
package's engines.

Every case of tests/test_tp_engine.py at its sizes (V 89, d 64, 8 heads, 2
layers, max_len 96, 4 ranks) and test_kv_paging.py's
``test_tp_engine_rejects_paging``, the port on gloo CPU ranks (every rank
builds the engine and makes the same submits), both packages on the JAX
tree's params:

- the mixed greedy and sampled workload: the TP engine's tokens equal the
  port's single-card ``LMEngine``'s and the JAX ``TPLMEngine``'s, float32
  and w8a8; one decode step's logits equal the single-card step's bit for
  bit in w8a8 and within rtol 1e-5 / atol 1e-6 in float32 (the wo and w2
  partials are summed across ranks);
- speculative decoding: tokens equal the plain engine's, acceptance counts
  the single-card speculative engine's; slot reuse with more requests than
  slots;
- the K/V stores hold H/n heads a rank; bad heads and paging are refused
  (the paging environment does not leak in);
- port-only: the lockstep check raises on every rank when one rank's
  submits differ, and a deadline is decided by rank 0's clock.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import torch_ranks as tr  # noqa: E402
from nnstreamer_tpu.models import causal_lm  # noqa: E402
from nnstreamer_tpu.serving import LMEngine as JaxEngine  # noqa: E402
from nnstreamer_tpu.serving import TPLMEngine as JaxTP  # noqa: E402

V, D, H, L, MAXLEN = 89, 64, 8, 2, 96
N = 4
AXES = {"model": N}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def groups():
    g = tr.Groups()
    yield g
    g.close()


@pytest.fixture(scope="module")
def params():
    return causal_lm.init_causal_lm(jax.random.PRNGKey(5), V, D, H, L, MAXLEN)


@pytest.fixture(scope="module")
def jmesh():
    return Mesh(np.array(jax.devices()[:N]), ("model",))


def _jobs():
    rng = np.random.default_rng(2)
    return [
        (rng.integers(0, V, 11), 14, {}),                            # greedy
        (rng.integers(0, V, 5), 10, dict(temperature=1.0, seed=4)),  # sampled
        (rng.integers(0, V, 21), 12, dict(temperature=0.8, top_k=12, seed=9)),
        (rng.integers(0, V, 7), 16, {}),                             # greedy
        (rng.integers(0, V, 9), 8, dict(temperature=1.2, top_p=0.9, seed=1)),
    ]


def _run_jax(eng, jobs):
    rids = [eng.submit(np.asarray(p, np.int32), max_new=m, **kw)
            for p, m, kw in jobs]
    res = eng.run()
    return [res[r] for r in rids], dict(eng.stats)


def _run_port_single(tree, jobs, **kw):
    import torch  # noqa: F401 — the port's single-card engine, on the CPU

    from nnstreamer_tpu_torch.models.convert import causal_lm_params
    from nnstreamer_tpu_torch.serving import LMEngine

    eng = LMEngine(causal_lm_params(_np(tree), "cpu"), H, MAXLEN,
                   device="cpu", **kw)
    rids = [eng.submit(np.asarray(p, np.int32), max_new=m, **k)
            for p, m, k in jobs]
    res = eng.run()
    return [res[r] for r in rids], dict(eng.stats)


@pytest.mark.parametrize("quant", [False, True], ids=["float32", "w8a8"])
def test_tp_engine_matches_single_device(groups, params, jmesh, quant):
    tree = causal_lm.quantize_lm_params(params) if quant else params
    jobs = _jobs()
    want, _ = _run_port_single(tree, jobs, n_slots=3, chunk=4)
    jax_tp, _ = _run_jax(JaxTP(tree, H, MAXLEN, jmesh, n_slots=3, chunk=4),
                         jobs)
    got = groups.run(N, tr.tp_engine, _np(tree), H, MAXLEN, AXES, False, jobs,
                     dict(n_slots=3, chunk=4))
    assert jax_tp == want
    for r, res in enumerate(got):
        assert res["tokens"] == want, f"rank {r}"
        assert res["lockstep"] > 0


@pytest.mark.parametrize("quant", [False, True], ids=["float32", "w8a8"])
def test_tp_step_logits_match_the_single_card_step(groups, params, quant):
    """w8a8 bit for bit; float32 within rtol 1e-5 / atol 1e-6."""
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, V, n).astype(np.int32) for n in (5, 17, 30)]
    tokens = rng.integers(0, V, 3).astype(np.int32)
    got = groups.run(N, tr.tp_step_vs_single, _np(params), H, MAXLEN, AXES,
                     quant, prompts, tokens)
    for lt, ls in got:
        if quant:
            np.testing.assert_array_equal(lt, ls)
        else:
            np.testing.assert_allclose(lt, ls, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(lt, got[0][0])  # replicated bits


def test_tp_engine_cache_is_sharded(groups, params):
    got = groups.run(N, tr.tp_engine, _np(params), H, MAXLEN, AXES, False,
                     [(np.arange(6), 6, {})], dict(n_slots=2, chunk=2))
    for res in got:
        # (slots, L·H/n, max_len, hd): a quarter of the heads a rank
        assert res["kc_shape"] == (2, L * H // N, MAXLEN, D // H)
        assert len(res["tokens"][0]) == 6


def test_tp_engine_rejects_bad_heads(groups, params):
    with pytest.raises(ValueError):
        JaxTP(params, H, MAXLEN, Mesh(np.array(jax.devices()[:3]), ("model",)))
    got = groups.run(3, tr.tp_engine_error, _np(params), H, MAXLEN,
                     {"model": 3}, {}, {})
    assert all(r["error"] and "not divisible" in r["error"] for r in got), got


@pytest.mark.parametrize("quant", [False, True], ids=["float32", "w8a8"])
def test_tp_engine_speculative_matches_single_device(groups, params, quant):
    tree = causal_lm.quantize_lm_params(params) if quant else params
    rep = np.array([5, 9, 2, 7] * 5, np.int32)  # prompt lookup finds these
    other = np.random.default_rng(11).integers(0, V, 7).astype(np.int32)
    jobs = [(rep, 16, {}), (other, 10, {})]
    plain, _ = _run_port_single(tree, jobs, n_slots=2, chunk=4)
    single, st_s = _run_port_single(tree, jobs, n_slots=2, spec_draft=4)
    got = groups.run(N, tr.tp_engine, _np(tree), H, MAXLEN, AXES, False, jobs,
                     dict(n_slots=2, spec_draft=4))
    assert single == plain
    for res in got:
        assert res["tokens"] == plain
        assert res["stats"]["spec_iterations"] > 0
        assert res["stats"]["spec_accepted"] == st_s["spec_accepted"]


def test_tp_engine_slot_reuse_more_requests_than_slots(groups, params):
    rng = np.random.default_rng(7)
    jobs = [(rng.integers(0, V, 4 + i).astype(np.int32), 5 + i % 4, {})
            for i in range(6)]
    want, _ = _run_jax(JaxEngine(params, H, MAXLEN, n_slots=2, chunk=3), jobs)
    got = groups.run(N, tr.tp_engine, _np(params), H, MAXLEN, AXES, False, jobs,
                     dict(n_slots=2, chunk=3))
    for res in got:
        assert res["tokens"] == want
        assert res["stats"]["prefills"] == 6


def test_tp_engine_rejects_paging(groups, params):
    """test_kv_paging.py's case: kv_* options raise; the paging environment
    does not turn paging on."""
    got = groups.run(2, tr.tp_engine_error, _np(params), H, MAXLEN,
                     {"model": 2}, dict(kv_page_size=8), {})
    assert all("paged KV cache" in r["error"] for r in got), got
    got = groups.run(2, tr.tp_engine_error, _np(params), H, MAXLEN,
                     {"model": 2}, {}, {"NNS_LM_KV_PAGE_SIZE": "8"})
    assert all(r["error"] is None and r["paged"] is False for r in got), got


def test_tp_engine_takes_only_its_rank_device(groups, params):
    """device= naming the rank's own device is taken; another is refused
    (here on CPU ranks: "cuda", which this machine may not even have)."""
    got = groups.run(2, tr.tp_engine_error, _np(params), H, MAXLEN,
                     {"model": 2}, dict(device="cpu"), {})
    assert all(r["error"] is None for r in got), got
    got = groups.run(2, tr.tp_engine_error, _np(params), H, MAXLEN,
                     {"model": 2}, dict(device="cuda"), {})
    assert all(r["error"] and ("no CUDA device" in r["error"]
                               or "rank's device" in r["error"])
               for r in got), got


def test_tp_engine_lockstep_check_raises_on_every_rank(groups, params):
    """Rank 1 submits another prompt: every rank raises LockstepError at the
    next iteration instead of hanging in a collective."""
    got = groups.run(2, tr.tp_engine_diverging, _np(params), H, MAXLEN,
                     {"model": 2})
    assert all(e and "lockstep" in e for e in got), got


def test_tp_engine_deadline_is_rank_zeros(groups, params):
    """Rank 0's deadline has passed, rank 1's has not: both shed the
    request (finished empty) and serve the other."""
    got = groups.run(2, tr.tp_engine_deadlines, _np(params), H, MAXLEN,
                     {"model": 2})
    for res in got:
        assert res["shed"] == []
        assert len(res["served"]) == 3
    assert got[0]["served"] == got[1]["served"]
