"""The port's tensor-parallel decode (nnstreamer_tpu_torch/parallel/
tp_decode.py and ops/int8.py's TP helpers) against the JAX package's.

Every case of tests/test_tp_decode.py, and test_lm_w8a8.py's
``test_tp_decode_quantized_matches_single_device`` and
``test_tp_shard_params_quantized_layout``, at the JAX tests' sizes and world
sizes: the JAX side on the 8-device virtual CPU mesh in this process, the
port on gloo ranks on the CPU (parallel/launch.py; one rank group per world
size for the module). Both packages get the same params (the JAX tree as
numpy) and the same single-device prefill caches (JAX's, resharded by each
package's ``tp_shard_cache``):

- greedy tokens of the port's TP decode equal the JAX TP decode's and the
  JAX single-device loop's, token for token, float32 (the JAX test's own
  contract) and w8a8;
- each rank's ``tp_shard_params`` leaves equal index [rank] of the JAX
  stacks bit for bit, float32 and w8a8 (the global ``wo_s``/``w2_s`` grids
  whole);
- w8a8's row-sharded GEMM is exact: the activation codes and grids equal
  JAX's ``quant_act`` of the whole row, the int32 partials summed over the
  ranks equal the whole int32 product, and the result equals JAX's
  single-device ``int8_matmul`` bit for bit;
- heads that do not divide the axis are refused, one generator program per
  length, decoding past capacity raises on the host.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import torch_ranks as tr  # noqa: E402
from nnstreamer_tpu.models import causal_lm  # noqa: E402
from nnstreamer_tpu.ops import int8 as ji8  # noqa: E402
from nnstreamer_tpu.parallel.tp_decode import (  # noqa: E402
    make_tp_generate, tp_shard_cache, tp_shard_params)

V, D, H, L, MAXLEN = 89, 64, 8, 3, 96


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def groups():
    g = tr.Groups()
    yield g
    g.close()


@pytest.fixture(scope="module")
def params():
    return causal_lm.init_causal_lm(jax.random.PRNGKey(11), V, D, H, L, MAXLEN)


def _jmesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("model",))


def _single_device_generate(params, prompt, n_steps, heads=H, max_len=MAXLEN):
    logits, kc, vc, pos = causal_lm.lm_prefill(params, jnp.asarray(prompt),
                                               heads, max_len)
    first = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    toks, tok = [], first
    for _ in range(n_steps):
        lg, kc, vc, pos = causal_lm.lm_decode_step(params, tok, kc, vc, pos,
                                                   heads)
        tok = jnp.argmax(lg, -1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(tok[:, 0]))
    return first, np.stack(toks, 1)


@pytest.fixture(scope="module")
def reference(params):
    """The JAX single-device prefill and greedy loop every world size is
    held against."""
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, V, (2, 13)).astype(np.int32)
    first, want = _single_device_generate(params, prompt, 20)
    _, kc, vc, pos = causal_lm.lm_prefill(params, jnp.asarray(prompt), H,
                                          MAXLEN)
    return first, want, kc, vc, pos


@pytest.mark.parametrize("n_model", [2, 4, 8])
def test_tp_decode_matches_single_device(groups, params, reference, n_model):
    """Exact: the port's TP tokens == the JAX TP tokens == the JAX
    single-device loop's, from the same prefill cache."""
    first, want, kc, vc, pos = reference
    mesh = _jmesh(n_model)
    kc_tp, vc_tp = tp_shard_cache(kc, vc, L, 2, H, mesh)
    jax_tp = np.asarray(make_tp_generate(H, MAXLEN, mesh)(
        tp_shard_params(params, H, mesh), first, kc_tp, vc_tp, pos, 20))
    got = groups.run(n_model, tr.tp_generate, _np(params), H, MAXLEN,
                     {"model": n_model}, False, np.asarray(first),
                     np.asarray(kc), np.asarray(vc), np.asarray(pos), 20, L, 2)
    np.testing.assert_array_equal(jax_tp, want)
    for r, toks in enumerate(got):
        np.testing.assert_array_equal(toks, want, err_msg=f"rank {r}")


@pytest.mark.parametrize("quant", [False, True], ids=["float32", "w8a8"])
def test_tp_shard_params_slices_equal_jax_stacks(groups, params, quant):
    """Each rank's slice == index [rank] of the JAX tp_shard_params stacks,
    bit for bit; replicated leaves and the w8a8 global grids whole."""
    tree = causal_lm.quantize_lm_params(params) if quant else params
    mesh = _jmesh(4)
    jtp = _np(tp_shard_params(tree, H, mesh))
    got = groups.run(4, tr.tp_slices, _np(tree), H, {"model": 4}, False)
    device_keys = ("wq", "wk", "wv", "wo", "w1", "w2")
    for r, mine in enumerate(got):
        assert set(mine) == set(jtp)
        for k, want in jtp.items():
            if k in device_keys:
                want = jax.tree_util.tree_map(lambda a: a[r], want)
            jax.tree_util.tree_map(
                lambda a, b: np.testing.assert_array_equal(
                    a, b, err_msg=f"rank {r} {k}"), mine[k], want)
            for a, b in zip(jax.tree_util.tree_leaves(mine[k]),
                            jax.tree_util.tree_leaves(want)):
                assert a.dtype == b.dtype, (k, a.dtype, b.dtype)


def test_tp_requires_divisible_heads(groups, params):
    err = groups.run(3, tr.tp_shard_error, _np(params), H, {"model": 3})
    assert all(e and "not divisible" in e for e in err), err
    with pytest.raises(ValueError):
        tp_shard_params(params, H, _jmesh(3))  # the JAX package's refusal


def test_tp_generate_is_one_executable_per_length(groups, params):
    prompt = np.arange(6, dtype=np.int32)[None]
    logits, kc, vc, pos = causal_lm.lm_prefill(params, jnp.asarray(prompt),
                                               H, MAXLEN)
    first = np.asarray(jnp.argmax(logits, -1)[:, None].astype(jnp.int32))
    _, want = _single_device_generate(params, prompt, 8)
    got = groups.run(2, tr.tp_generate_twice, _np(params), H, MAXLEN,
                     {"model": 2}, first, np.asarray(kc), np.asarray(vc),
                     np.asarray(pos), 8, L, 1)
    for r in got:
        np.testing.assert_array_equal(r["outs"][0], r["outs"][1])
        np.testing.assert_array_equal(r["outs"][0], want)
        assert r["programs"] == 1  # one program per distinct n_steps
        assert r["overflow"] and "past cache capacity" in r["overflow"]


# -- w8a8 (tests/test_lm_w8a8.py's TP cases, at its sizes) ------------------ #

QV, QD, QH, QL, QT = 64, 64, 4, 2, 16


@pytest.fixture(scope="module")
def qparams():
    p = causal_lm.init_causal_lm(jax.random.PRNGKey(0), QV, QD, QH, QL, QT)
    return causal_lm.quantize_lm_params(p)


@pytest.mark.parametrize("n_model", [2, 4])
def test_tp_decode_quantized_matches_single_device(groups, qparams, n_model):
    """Exact: w8a8 TP tokens (port) == JAX TP == JAX single-device."""
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, QV, (2, 7)).astype(np.int32)
    n_steps = 8  # pos 7 + 8 steps = 15 <= max_len 16
    first, want = _single_device_generate(qparams, prompt, n_steps, QH, QT)
    _, kc, vc, pos = causal_lm.lm_prefill(qparams, jnp.asarray(prompt), QH, QT)
    mesh = _jmesh(n_model)
    kc_tp, vc_tp = tp_shard_cache(kc, vc, QL, 2, QH, mesh)
    jax_tp = np.asarray(make_tp_generate(QH, QT, mesh)(
        tp_shard_params(qparams, QH, mesh), first, kc_tp, vc_tp, pos, n_steps))
    got = groups.run(n_model, tr.tp_generate, _np(qparams), QH, QT,
                     {"model": n_model}, False, np.asarray(first),
                     np.asarray(kc), np.asarray(vc), np.asarray(pos), n_steps,
                     QL, 2)
    np.testing.assert_array_equal(jax_tp, want)
    for r, toks in enumerate(got):
        np.testing.assert_array_equal(toks, want, err_msg=f"rank {r}")


def test_tp_shard_params_quantized_layout(groups):
    """Sliced int8 payloads and scales are the single-device codes'
    slices; the row-sharded grids stay global."""
    p = causal_lm.init_causal_lm(jax.random.PRNGKey(5), QV, QD, QH, 1, 8)
    qp = _np(causal_lm.quantize_lm_params(p))
    got = groups.run(2, tr.tp_slices, qp, QH, {"model": 2}, False)
    qw = qp["wqkv"][ji8.W8A8_TAG]
    for r, tp in enumerate(got):
        wq = tp["wq"][ji8.W8A8_TAG][0]
        np.testing.assert_array_equal(
            wq, qw[0, :, r * QD // 2:(r + 1) * QD // 2])
        np.testing.assert_array_equal(tp["wo_s"], qp["wo"]["s"])
        np.testing.assert_array_equal(tp["w2_s"], qp["w2"]["s"])
        assert wq.dtype == np.int8


@pytest.mark.parametrize("n_model", [2, 4])
def test_int8_row_sharded_matmul_is_exact(groups, n_model):
    """quant_act_global's codes and grid == JAX quant_act of the whole row;
    the int32 partials summed over the ranks == the whole int32 product;
    the result == JAX's single-device int8_matmul, bit for bit."""
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((5, 64)) * 3).astype(np.float32)
    x[2] = 0.0  # an all-zero row: grid 1
    w = jnp.asarray(rng.standard_normal((64, 24)).astype(np.float32))
    qw = ji8.quantize_weight(w)
    xq, xs = ji8.quant_act(jnp.asarray(x))
    whole = np.asarray(jax.lax.dot_general(
        xq, qw[ji8.W8A8_TAG], (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32))
    want = np.asarray(ji8.int8_matmul(jnp.asarray(x), qw))
    got = groups.run(n_model, tr.int8_row_sharded, x,
                     np.asarray(qw[ji8.W8A8_TAG]), np.asarray(qw["s"]),
                     {"model": n_model})
    k = 64 // n_model
    parts = 0
    for r, res in enumerate(got):
        np.testing.assert_array_equal(res["q"],
                                      np.asarray(xq)[:, r * k:(r + 1) * k])
        np.testing.assert_array_equal(res["s"], np.asarray(xs))
        assert res["partial"].dtype == np.int32
        parts = parts + res["partial"]
        np.testing.assert_array_equal(res["sum"], whole)
        np.testing.assert_array_equal(res["out"], want)
    np.testing.assert_array_equal(parts, whole)
