"""The port's LM serving (nnstreamer_tpu_torch/serving) against the JAX
package's.

Sampling: ``seed_key``/``fold_in``/``step_keys`` give the JAX keys bit for
bit, the random bits and the categorical draws are ``jax.random``'s, and
``sample_logits`` draws the same tokens as the JAX sampler at several
seeds, consumed counts and controls (tokens equal; Gumbel noise within
1e-6 relative, the two libraries' logs), with the controls as Python
numbers or as tensors.

Engine: the port's ``LMEngine`` (device="cpu") over the JAX package's
params converted with ``models/convert.causal_lm_params`` serves the same
requests as the JAX ``LMEngine``: greedy, sampled, speculative
(``spec_draft=4``), static (``gang=True``) and w8a8 outputs are equal token
for token, and the ``stats`` counters equal (wall time aside); the admit
prefill program installs the JAX ``_prefill_admit``'s first token,
position and seed key, and its cache within rtol 1e-4 / atol 1e-5. Model:
V 128, D 64, 4 heads, 2 layers, max_len 128 (examples/serve_lm.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nnstreamer_tpu.models import causal_lm as jlm  # noqa: E402
from nnstreamer_tpu.serving import LMEngine as JaxEngine  # noqa: E402
from nnstreamer_tpu.serving import sampling as jsamp  # noqa: E402
from nnstreamer_tpu_torch.models import causal_lm as tlm  # noqa: E402
from nnstreamer_tpu_torch.models.convert import causal_lm_params  # noqa: E402
from nnstreamer_tpu_torch.serving import LMEngine, sampling  # noqa: E402

V, D, H, L, MAXLEN = 128, 64, 4, 2, 128
CPU = torch.device("cpu")
SEEDS = [0, 1, 7, 123456789, 2**31 - 1, 2**32 - 1]
CONSUMED = [0, 1, 5, 127, 1000, 2**20 + 3]


# --------------------------------------------------------------------------- #
# sampling: keys, bits, draws
# --------------------------------------------------------------------------- #

def _jkeys(seeds, consumed):
    return np.stack([np.asarray(jax.random.fold_in(jax.random.PRNGKey(s), c))
                     for s, c in zip(seeds, consumed)])


@pytest.mark.parametrize("seed", SEEDS)
def test_seed_key_bit_equal(seed):
    want = np.asarray(jax.random.PRNGKey(seed)).astype(np.int64)
    np.testing.assert_array_equal(sampling.seed_key(seed, CPU).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_and_step_keys_bit_equal(seed):
    want = _jkeys([seed] * len(CONSUMED), CONSUMED).astype(np.int64)
    base = sampling.seed_key(seed, CPU)
    got = torch.stack([sampling.fold_in(base, torch.tensor(c))
                       for c in CONSUMED])
    np.testing.assert_array_equal(got.numpy(), want)
    # the engine's batched form, and JAX's own vmapped step_keys
    seeds = base[None].repeat(len(CONSUMED), 1)
    got_b = sampling.step_keys(seeds, torch.tensor(CONSUMED, dtype=torch.int32))
    np.testing.assert_array_equal(got_b.numpy(), want)
    jk = jsamp.step_keys(jnp.stack([jsamp.seed_key(seed)] * len(CONSUMED)),
                         jnp.asarray(CONSUMED, jnp.int32))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(jk).astype(np.int64))


@pytest.mark.parametrize("n", [1, 7, 128, 1000])
def test_random_bits_bit_equal(n):
    keys = _jkeys(SEEDS, CONSUMED)
    want = np.stack([np.asarray(jax.random.bits(jnp.asarray(k), (n,)))
                     for k in keys]).astype(np.int64)
    got = sampling.random_bits(torch.from_numpy(keys.astype(np.int64)), n)
    np.testing.assert_array_equal(got.numpy(), want)


def test_gumbel_matches_jax():
    keys = _jkeys(SEEDS, CONSUMED)
    want = np.stack([np.asarray(jax.random.gumbel(jnp.asarray(k), (V,)))
                     for k in keys])
    got = sampling.gumbel(torch.from_numpy(keys.astype(np.int64)), V).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# temperature, top_k, top_p per row: greedy, plain, top-k, nucleus, both,
# disabled nucleus (0 and 1), top-k past V
CONTROLS = [(0.0, 0, 1.0), (1.0, 0, 1.0), (0.8, 16, 1.0), (1.2, 0, 0.9),
            (0.7, 8, 0.5), (1.0, 0, 0.0), (2.0, 0, 1.0), (1.0, 1000, 1.0)]


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_sample_logits_draws_jax_tokens(seed):
    rng = np.random.default_rng(seed)
    n = len(CONTROLS)
    logits = (rng.standard_normal((n, V)) * 3).astype(np.float32)
    logits[2, 40:44] = logits[2].max()  # ties at the top
    temp, topk, topp = (np.asarray(c, dt) for c, dt in zip(
        zip(*CONTROLS), (np.float32, np.int32, np.float32)))
    for consumed in (1, 17, 500):
        keys = _jkeys([seed * 100 + i for i in range(n)], [consumed] * n)
        want = np.asarray(jsamp.sample_logits(
            jnp.asarray(logits), jnp.asarray(keys), jnp.asarray(temp),
            jnp.asarray(topk), jnp.asarray(topp)))
        got = sampling.sample_logits(
            torch.from_numpy(logits), torch.from_numpy(keys.astype(np.int64)),
            torch.from_numpy(temp), torch.from_numpy(topk),
            torch.from_numpy(topp))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_sample_row_matches_categorical_when_filters_disabled():
    logits = np.random.default_rng(5).standard_normal(V).astype(np.float32)
    for s in range(20):
        key = jax.random.fold_in(jax.random.PRNGKey(s), 9)
        want = int(jax.random.categorical(key, jnp.asarray(logits)))
        got = sampling.sample_row(torch.from_numpy(logits),
                                  torch.from_numpy(np.asarray(key).astype(np.int64)),
                                  1.0, 0, 1.0)
        assert int(got) == want


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_sample_row_takes_tensor_controls_and_keys(seed):
    # the engine's admit prefill hands the slot's controls over as tensors
    # of one value: the draws are the Python-number form's and JAX's
    logits = (np.random.default_rng(seed).standard_normal(V) * 3).astype(np.float32)
    for i, (t, k, p) in enumerate(CONTROLS):
        key = jax.random.fold_in(jax.random.PRNGKey(seed * 10 + i), 7)
        tkey = torch.from_numpy(np.asarray(key).astype(np.int64))
        want = int(jsamp.sample_row(jnp.asarray(logits), key, jnp.float32(t),
                                    jnp.int32(k), jnp.float32(p)))
        plain = sampling.sample_row(torch.from_numpy(logits), tkey, t, k, p)
        tensors = sampling.sample_row(
            torch.from_numpy(logits), tkey, torch.tensor([t]),
            torch.tensor([k], dtype=torch.int32), torch.tensor(p))
        assert int(plain) == int(tensors) == want
        assert tensors.dtype == torch.int32 and tensors.shape == ()


# --------------------------------------------------------------------------- #
# the engine against the JAX engine
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def jparams():
    return jlm.init_causal_lm(jax.random.PRNGKey(0), V, D, H, L, MAXLEN)


@pytest.fixture(scope="module")
def tparams(jparams):
    return causal_lm_params(jax.tree_util.tree_map(np.asarray, jparams), CPU)


def _requests(n, seed, repetitive=False):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if repetitive:
            base = rng.integers(0, V, 4)
            p = np.tile(base, 5)[: 6 + 3 * i]
        else:
            p = rng.integers(0, V, (5, 12, 20, 33, 9)[i % 5])
        out.append((p.astype(np.int32), (6, 11, 16, 3)[i % 4]))
    return out


def _serve(engine_cls, params, reqs, sample=None, **kw):
    eng = engine_cls(params, H, MAXLEN, **kw)
    rids = []
    for i, (p, g) in enumerate(reqs):
        opts = sample(i) if sample else {}
        rids.append(eng.submit(p, max_new=g, **opts))
    res = eng.run()
    stats = {k: v for k, v in eng.stats.items() if k != "wall_s"}
    return [res[r] for r in rids], stats


def _both(jp, tp, reqs, sample=None, **kw):
    want = _serve(JaxEngine, jp, reqs, sample, kv_page_size=0, **kw)
    got = _serve(LMEngine, tp, reqs, sample, device=CPU, **kw)
    return got, want


@pytest.mark.parametrize("kw", [dict(n_slots=4, chunk=8),
                                dict(n_slots=3, chunk=5),
                                dict(n_slots=2, chunk=4, gang=True)],
                         ids=["slots4_chunk8", "slots3_chunk5_tails", "gang"])
def test_engine_greedy_matches_jax(jparams, tparams, kw):
    (got, gstats), (want, wstats) = _both(jparams, tparams, _requests(7, 1), **kw)
    assert got == want
    assert gstats == wstats


def test_engine_sampled_matches_jax(jparams, tparams):
    def sample(i):
        return [dict(), dict(temperature=1.0, seed=7),
                dict(temperature=1.2, top_p=0.9, seed=8),
                dict(temperature=0.8, top_k=16, seed=9)][i % 4]

    (got, gstats), (want, wstats) = _both(jparams, tparams, _requests(6, 2),
                                          sample, n_slots=4, chunk=8)
    assert got == want
    assert gstats == wstats


def test_engine_speculative_matches_jax(jparams, tparams):
    reqs = _requests(5, 3, repetitive=True)
    (got, gstats), (want, wstats) = _both(jparams, tparams, reqs,
                                          n_slots=2, chunk=4, spec_draft=4)
    assert got == want
    assert gstats == wstats
    assert gstats["spec_iterations"] > 0
    plain, _ = _serve(LMEngine, tparams, reqs, n_slots=2, chunk=4, device=CPU)
    assert got == plain  # speculation leaves greedy output unchanged


def test_engine_w8a8_matches_jax(jparams):
    jq = jlm.quantize_lm_params(jparams)
    tq = causal_lm_params(jax.tree_util.tree_map(np.asarray, jq), CPU)
    (got, gstats), (want, wstats) = _both(jq, tq, _requests(5, 4),
                                          n_slots=4, chunk=8)
    assert got == want
    assert gstats == wstats


def test_engine_eos_stops_like_jax(jparams, tparams):
    reqs = _requests(4, 5)
    free, _ = _serve(LMEngine, tparams, reqs, n_slots=2, chunk=4, device=CPU)
    eos = free[0][2]

    def run(cls, params, **kw):
        eng = cls(params, H, MAXLEN, n_slots=2, chunk=4, **kw)
        rids = [eng.submit(p, max_new=g, eos=eos) for p, g in reqs]
        res = eng.run()
        return [res[r] for r in rids], eng.stats["wasted_slot_steps"]

    assert run(LMEngine, tparams, device=CPU) == run(JaxEngine, jparams,
                                                     kv_page_size=0)
    assert run(LMEngine, tparams, device=CPU)[0][0][-1] == eos


def test_batched_streams_match_isolated_runs(tparams):
    reqs = _requests(5, 6)
    together, _ = _serve(LMEngine, tparams, reqs, n_slots=4, chunk=8,
                         device=CPU)
    for (p, g), out in zip(reqs, together):
        alone, _ = _serve(LMEngine, tparams, [(p, g)], n_slots=1, chunk=8,
                          device=CPU)
        assert alone[0] == out


def test_engine_admission_rules(tparams):
    with pytest.raises(NotImplementedError, match="paged KV"):
        LMEngine(tparams, H, MAXLEN, kv_page_size=16, device=CPU)
    with pytest.raises(ValueError, match="spec_draft"):
        LMEngine(tparams, H, MAXLEN, spec_draft=MAXLEN, device=CPU)
    eng = LMEngine(tparams, H, MAXLEN, device=CPU)
    with pytest.raises(ValueError, match="exceeds cache"):
        eng.submit(np.zeros(100, np.int32), max_new=30)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit([], max_new=3)
    eng.submit(np.zeros(100, np.int32), max_new=29)  # exactly at capacity
    assert eng.pending() == 1
    # the slot state lives where the params do; cuda is the default device
    with pytest.raises(Exception):
        LMEngine(tparams, H, MAXLEN)


@pytest.mark.parametrize("temperature,seed", [(0.0, 0), (0.9, 5), (1.3, 77)])
def test_admit_prefill_program_installs_the_jax_admit_state(jparams, tparams,
                                                            temperature, seed):
    # the prefill program (prompt, true length and slot as device tensors,
    # seed key and controls read from the slot state) against the JAX
    # engine's jitted _prefill_admit on the same padded prompt
    from nnstreamer_tpu.serving.lm_engine import _prefill_admit
    from nnstreamer_tpu_torch.serving.lm_engine import _Request

    prompt = np.random.default_rng(seed).integers(0, V, 21).astype(np.int32)
    padded = np.zeros((1, 32), np.int32)
    padded[0, :21] = prompt
    eng = LMEngine(tparams, H, MAXLEN, n_slots=3, device=CPU)
    req = _Request(0, prompt, 5, None, temperature=temperature, top_k=12,
                   top_p=0.95, seed=seed)
    first = eng._prefill_into(2, padded, 21, req)
    jfirst, jkc, jvc, jpos = _prefill_admit(
        jparams, jnp.asarray(padded), jnp.int32(21), jax.random.PRNGKey(seed),
        jnp.float32(temperature), jnp.int32(12), jnp.float32(0.95),
        n_heads=H, max_len=MAXLEN)
    assert int(first) == int(jfirst)
    assert int(eng._tokens[2, 0, 0]) == int(jfirst) and int(eng._pos[2, 0]) == 21
    np.testing.assert_allclose(eng._kc[2].numpy(), np.asarray(jkc),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(eng._vc[2].numpy(), np.asarray(jvc),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(eng._skeys[2].numpy(),
                                  np.asarray(jax.random.PRNGKey(seed)))
    # the other slots are untouched
    assert not eng._kc[:2].any() and not eng._pos[:2].any()


def test_bucket_and_tail_rules():
    from nnstreamer_tpu.serving import next_pow2_bucket as jbucket
    from nnstreamer_tpu_torch.serving import next_pow2_bucket

    for n in (1, 15, 16, 17, 100, 513):
        assert next_pow2_bucket(n) == jbucket(n)
