"""The port's tensor-parallel prefill (nnstreamer_tpu_torch/parallel/
tp_prefill.py) against the JAX package's.

Every case of tests/test_tp_prefill.py at its sizes (V 71, d 64, 8 heads, 2
layers, max_len 64, 4 ranks), the port on gloo CPU ranks, both packages on
the JAX tree's params:

- the TP prefill's logits equal JAX's single-device ``lm_prefill`` (and
  ``lm_prefill_masked`` for a padded prompt) within rtol 2e-4 / atol 2e-5,
  the JAX test's tolerance; the port prefills as one verify window (the
  engines' admit prefill), JAX densely;
- the greedy continuation through ``make_tp_generate`` equals JAX's
  single-device tokens, float32 and w8a8;
- each rank's K/V equal the JAX single-device cache resharded within rtol
  1e-5 / atol 1e-6 (the JAX test's tolerance), and the port's own
  single-card admit prefill cut to the rank's heads bit for bit in w8a8
  (float32: within rtol 1e-5 / atol 1e-6, the q/k/v GEMMs run on column
  slices);
- oversized prompts and out-of-range ``true_len`` raise on the host.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import torch_ranks as tr  # noqa: E402
from nnstreamer_tpu.models import causal_lm  # noqa: E402
from nnstreamer_tpu.parallel.tp_decode import tp_shard_cache  # noqa: E402

V, D, H, L, MAXLEN = 71, 64, 8, 2, 64
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
    return causal_lm.init_causal_lm(jax.random.PRNGKey(21), V, D, H, L, MAXLEN)


@pytest.fixture(scope="module")
def jmesh():
    return Mesh(np.array(jax.devices()[:N]), ("model",))


def _single_generate(params, prompt, n_steps):
    logits, kc, vc, pos = causal_lm.lm_prefill(params, jnp.asarray(prompt), H,
                                               MAXLEN)
    first = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    toks, tok = [], first
    for _ in range(n_steps):
        lg, kc, vc, pos = causal_lm.lm_decode_step(params, tok, kc, vc, pos, H)
        tok = jnp.argmax(lg, -1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(tok[:, 0]))
    return np.asarray(first[:, 0]), np.stack(toks, 1)


def test_tp_prefill_logits_and_continuation(groups, params):
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, V, (2, 9)).astype(np.int32)
    sfirst, want = _single_generate(params, prompt, 10)
    ref_logits, _, _, ref_pos = causal_lm.lm_prefill(
        params, jnp.asarray(prompt), H, MAXLEN)
    got = groups.run(N, tr.tp_prefill_then_generate, _np(params), H, MAXLEN,
                     AXES, False, prompt, None, 10)
    for r, res in enumerate(got):
        np.testing.assert_allclose(res["logits"], np.asarray(ref_logits),
                                   rtol=2e-4, atol=2e-5, err_msg=f"rank {r}")
        assert int(res["pos"][0]) == int(np.asarray(ref_pos)[0])
        np.testing.assert_array_equal(res["first"], sfirst)
        np.testing.assert_array_equal(res["tokens"], want)


def test_tp_prefill_cache_matches_resharded_single_device(groups, params, jmesh):
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, V, (1, 11)).astype(np.int32)
    _, kc, vc, _ = causal_lm.lm_prefill(params, jnp.asarray(prompt), H, MAXLEN)
    kc_ref, vc_ref = (np.asarray(c) for c in tp_shard_cache(kc, vc, L, 1, H,
                                                             jmesh))
    got = groups.run(N, tr.tp_prefill_then_generate, _np(params), H, MAXLEN,
                     AXES, False, prompt, None, 0)
    for r, res in enumerate(got):
        np.testing.assert_allclose(res["kc"], kc_ref[r], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(res["vc"], vc_ref[r], rtol=1e-5, atol=1e-6)


def test_tp_prefill_cache_matches_the_ports_window_prefill(groups, params):
    """Against the port's own single-card admit prefill, cut to the rank's
    heads: float32 within rtol 1e-5 / atol 1e-6 (K/V and logits; the q/k/v
    GEMMs run on column slices, the wo/w2 partials are summed across
    ranks)."""
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, V, (2, 12)).astype(np.int32)
    got = groups.run(N, tr.tp_prefill_vs_window, _np(params), H, MAXLEN, AXES,
                     prompt)
    for kt, ks, vt, vs, lt, ls in got:
        np.testing.assert_allclose(kt, ks, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(vt, vs, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(lt, ls, rtol=1e-5, atol=1e-6)


def test_tp_prefill_true_len_matches_masked(groups, params):
    """A right-padded prompt: the logits of row true_len - 1 equal
    lm_prefill_masked's, pos is true_len."""
    rng = np.random.default_rng(3)
    tl = 6
    padded = np.zeros((1, 16), np.int32)
    padded[0, :tl] = rng.integers(0, V, tl)
    ref_logits, _, _, ref_pos = causal_lm.lm_prefill_masked(
        params, jnp.asarray(padded), jnp.int32(tl), H, MAXLEN)
    got = groups.run(N, tr.tp_prefill_then_generate, _np(params), H, MAXLEN,
                     AXES, False, padded, tl, 0)
    for res in got:
        np.testing.assert_allclose(res["logits"], np.asarray(ref_logits),
                                   rtol=2e-4, atol=2e-5)
        assert int(res["pos"][0]) == tl == int(np.asarray(ref_pos)[0])


def test_tp_prefill_w8a8_bit_exact_cache_and_tokens(groups, params, jmesh):
    """w8a8: the rank's K/V codes are the single-card codes — bit-equal to
    the port's single-card admit prefill cut to its heads, and within
    rtol 1e-5 / atol 1e-6 of JAX's resharded quantized prefill — and the
    greedy continuation equals JAX's single-device quantized tokens."""
    qp = causal_lm.quantize_lm_params(params)
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, V, (2, 8)).astype(np.int32)
    sfirst, want = _single_generate(qp, prompt, 9)
    _, kc, vc, _ = causal_lm.lm_prefill(qp, jnp.asarray(prompt), H, MAXLEN)
    kc_ref, vc_ref = (np.asarray(c) for c in tp_shard_cache(kc, vc, L, 2, H,
                                                            jmesh))
    got = groups.run(N, tr.tp_prefill_then_generate, _np(qp), H, MAXLEN, AXES,
                     False, prompt, None, 9)
    window = groups.run(N, tr.tp_prefill_vs_window, _np(qp), H, MAXLEN, AXES,
                        prompt)
    for r, (res, (kt, ks, vt, vs, lt, ls)) in enumerate(zip(got, window)):
        np.testing.assert_array_equal(kt, ks)
        np.testing.assert_array_equal(vt, vs)
        np.testing.assert_array_equal(lt, ls)
        np.testing.assert_allclose(res["kc"], kc_ref[r], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(res["vc"], vc_ref[r], rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(res["first"], sfirst)
        np.testing.assert_array_equal(res["tokens"], want)


@pytest.mark.parametrize("case", ["oversized", "true_len_zero",
                                  "true_len_past_prompt"])
def test_tp_prefill_rejects_oversized_prompt(groups, params, case):
    prompt, tl, match = {
        "oversized": (np.zeros((1, MAXLEN + 1), np.int32), None, "exceeds"),
        "true_len_zero": (np.zeros((1, 8), np.int32), 0, "outside"),
        "true_len_past_prompt": (np.zeros((1, 8), np.int32), 9, "outside"),
    }[case]
    err = groups.run(N, tr.tp_prefill_error, _np(params), H, MAXLEN, AXES,
                     prompt, tl)
    assert all(e and match in e for e in err), err
