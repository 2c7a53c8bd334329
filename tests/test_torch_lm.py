"""The port's causal LM (nnstreamer_tpu_torch/models/causal_lm.py), its
quantizing passes and its zoo/filter surface against the JAX package.

The JAX package's params (``init_causal_lm``, and ``quantize_lm_params``
for w8a8) are converted with ``models/convert.causal_lm_params`` and the
same numpy tokens go through every execution form of both packages:
``lm_forward``, dense and flash ``lm_prefill`` (the JAX flash kernel in
interpret mode), ``lm_prefill_masked`` (its true length an int or, as the
serving engine's graphs give it, a 0-dim tensor), the decode step, the verify window
and the per-slot forms, including windows past the cache. Tolerance:
logits and caches within rtol 1e-4 / atol 1e-5 (float32 GEMMs contract in
a different order in XLA and in torch) and greedy argmax equal; the w8a8
tree, its int8 codes and scales, bit-equal. Model: V 128, D 64, 4 heads,
2 layers, max_len 128 (examples/serve_lm.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nnstreamer_tpu.models import causal_lm as jlm  # noqa: E402
from nnstreamer_tpu.models import quantize as jquant  # noqa: E402
from nnstreamer_tpu_torch.models import causal_lm as tlm  # noqa: E402
from nnstreamer_tpu_torch.models import quantize as tquant  # noqa: E402
from nnstreamer_tpu_torch.models.convert import causal_lm_params  # noqa: E402
from nnstreamer_tpu_torch.ops import int8 as ti8  # noqa: E402

V, D, H, L, MAXLEN = 128, 64, 4, 2, 128
HD = D // H
CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def trees():
    """{"float": (jax params, port params), "w8a8": (...)}"""
    jp = jlm.init_causal_lm(jax.random.PRNGKey(0), V, D, H, L, MAXLEN)
    jq = jlm.quantize_lm_params(jp)
    return {"float": (jp, causal_lm_params(_np(jp), CPU)),
            "w8a8": (jq, causal_lm_params(_np(jq), CPU))}


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, V, shape).astype(np.int32)


def _close(got, want, **tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **(tol or TOL))


def _same_argmax(got, want):
    np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                  np.asarray(want).argmax(-1))


# --------------------------------------------------------------------------- #
# execution forms, float and w8a8
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("kind", ["float", "w8a8"])
def test_forward_matches_jax(trees, kind):
    jp, tp = trees[kind]
    tok = _tokens((2, 24), 1)
    want = jlm.lm_forward(jp, jnp.asarray(tok), H)
    got = tlm.lm_forward(tp, torch.from_numpy(tok), H)
    assert got.shape == (2, 24, V) and got.dtype == torch.float32
    _close(got, want)
    _same_argmax(got, want)


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
@pytest.mark.parametrize("kind", ["float", "w8a8"])
def test_prefill_matches_jax(trees, kind, flash):
    jp, tp = trees[kind]
    tok = _tokens((2, 40), 2)
    jl, jk, jv, jpos = jlm.lm_prefill(jp, jnp.asarray(tok), H, MAXLEN,
                                      flash=flash)
    tl, tk, tv, tpos = tlm.lm_prefill(tp, torch.from_numpy(tok), H, MAXLEN,
                                      flash=flash)
    assert tk.shape == (L * 2 * H, MAXLEN, HD)
    _close(tl, jl)
    _same_argmax(tl, jl)
    _close(tk, jk)
    _close(tv, jv)
    assert int(tpos[0]) == int(jpos[0]) == 40


def test_flash_env_switch_and_one_launch_per_layer(trees, monkeypatch):
    _, tp = trees["float"]
    calls = []
    real = tlm.flash_attention

    def counting(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(tlm, "flash_attention", counting)
    tok = torch.from_numpy(_tokens((1, 20), 3))
    dense = tlm.lm_prefill(tp, tok, H, MAXLEN)[0]
    assert not calls
    monkeypatch.setenv("NNS_LM_FLASH", "1")
    flash = tlm.lm_prefill(tp, tok, H, MAXLEN)[0]
    assert calls == [(1, H, 20, HD)] * L
    _close(flash, dense.numpy())
    # a padded prompt keeps the dense branch even under NNS_LM_FLASH=1
    tlm.lm_prefill_masked(tp, tok, 12, H, MAXLEN)
    assert len(calls) == L
    with pytest.raises(ValueError, match="true_len"):
        tlm._lm_prefill(tp, tok, H, MAXLEN, flash=True, true_len=12)


@pytest.mark.parametrize("kind", ["float", "w8a8"])
def test_prefill_masked_matches_jax(trees, kind):
    jp, tp = trees[kind]
    tok = np.zeros((1, 32), np.int32)
    tok[0, :19] = _tokens(19, 4)
    jl, jk, jv, jpos = jlm.lm_prefill_masked(jp, jnp.asarray(tok), 19, H,
                                             MAXLEN)
    tl, tk, tv, tpos = tlm.lm_prefill_masked(tp, torch.from_numpy(tok), 19, H,
                                             MAXLEN)
    _close(tl, jl)
    _same_argmax(tl, jl)
    _close(tk, jk)
    _close(tv, jv)
    assert int(tpos[0]) == int(jpos[0]) == 19
    # the logits are the unpadded prompt's
    _close(tl, tlm.lm_prefill(tp, torch.from_numpy(tok[:, :19]), H,
                              MAXLEN)[0].numpy())
    with pytest.raises(ValueError, match="true_len"):
        tlm.lm_prefill_masked(tp, torch.from_numpy(tok), 33, H, MAXLEN)


@pytest.mark.parametrize("kind", ["float", "w8a8"])
@pytest.mark.parametrize("true_len", [1, 19, 32])
def test_prefill_masked_takes_a_tensor_true_len(trees, kind, true_len):
    # the serving engine's graph form: true_len a 0-dim device tensor, as
    # the JAX engine traces it; bit-equal to the int form, and within the
    # float tolerance of the jitted JAX function
    jp, tp = trees[kind]
    tok = np.zeros((1, 32), np.int32)
    tok[0, :true_len] = _tokens(true_len, 6)
    want = tlm.lm_prefill_masked(tp, torch.from_numpy(tok), true_len, H, MAXLEN)
    for dtype in (torch.int32, torch.int64):
        got = tlm.lm_prefill_masked(tp, torch.from_numpy(tok),
                                    torch.tensor(true_len, dtype=dtype), H, MAXLEN)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)
    jl, jk, jv, jpos = jax.jit(jlm.lm_prefill_masked, static_argnums=(3, 4))(
        jp, jnp.asarray(tok), jnp.int32(true_len), H, MAXLEN)
    _close(got[0], jl)
    _same_argmax(got[0], jl)
    _close(got[1], jk)
    _close(got[2], jv)
    assert int(got[3][0]) == int(jpos[0]) == true_len


@pytest.mark.parametrize("kind", ["float", "w8a8"])
def test_decode_steps_match_jax_and_forward(trees, kind):
    jp, tp = trees[kind]
    tok = _tokens((2, 30), 5)
    _, jk, jv, jpos = jlm.lm_prefill(jp, jnp.asarray(tok[:, :20]), H, MAXLEN)
    _, tk, tv, tpos = tlm.lm_prefill(tp, torch.from_numpy(tok[:, :20]), H,
                                     MAXLEN)
    step_logits = []
    for i in range(20, 30):
        t = tok[:, i:i + 1]
        jl, jk, jv, jpos = jlm.lm_decode_step(jp, jnp.asarray(t), jk, jv,
                                              jpos, H)
        tl, tk, tv, tpos = tlm.lm_decode_step(tp, torch.from_numpy(t), tk, tv,
                                              tpos, H)
        _close(tl, jl)
        _same_argmax(tl, jl)
        step_logits.append(tl)
    _close(tk, jk)
    _close(tv, jv)
    assert int(tpos[0]) == int(jpos[0]) == 30
    # step decoding reproduces the full forward's logits
    fwd = tlm.lm_forward(tp, torch.from_numpy(tok), H)[:, 20:]
    _close(torch.stack(step_logits, 1), fwd.numpy())


@pytest.mark.parametrize("kind", ["float", "w8a8"])
def test_verify_window_matches_jax(trees, kind):
    jp, tp = trees[kind]
    tok = _tokens((1, 25), 6)
    _, jk, jv, jpos = jlm.lm_prefill(jp, jnp.asarray(tok[:, :21]), H, MAXLEN)
    _, tk, tv, tpos = tlm.lm_prefill(tp, torch.from_numpy(tok[:, :21]), H,
                                     MAXLEN)
    win = tok[:, 21:25]
    jl, jk, jv, jpos = jlm.lm_verify_window(jp, jnp.asarray(win), jk, jv,
                                            jpos, H)
    tl, tk, tv, tpos = tlm.lm_verify_window(tp, torch.from_numpy(win), tk, tv,
                                            tpos, H)
    assert tl.shape == (1, 4, V)
    _close(tl, jl)
    _same_argmax(tl, jl)
    _close(tk, jk)
    _close(tv, jv)
    assert int(tpos[0]) == int(jpos[0]) == 25


def _slot_state(jp, tp, lengths, seed):
    """Per-slot caches prefilled to different lengths, both packages."""
    toks = [_tokens((1, n), seed + i) for i, n in enumerate(lengths)]
    jst = [jlm.lm_prefill(jp, jnp.asarray(t), H, MAXLEN) for t in toks]
    tst = [tlm.lm_prefill(tp, torch.from_numpy(t), H, MAXLEN) for t in toks]
    jk = jnp.stack([s[1] for s in jst])
    jv = jnp.stack([s[2] for s in jst])
    jpos = jnp.stack([s[3] for s in jst])
    tk = torch.stack([s[1] for s in tst])
    tv = torch.stack([s[2] for s in tst])
    tpos = torch.stack([s[3] for s in tst])
    return (jk, jv, jpos), (tk, tv, tpos)


@pytest.mark.parametrize("kind", ["float", "w8a8"])
def test_slot_forms_match_jax(trees, kind):
    jp, tp = trees[kind]
    (jk, jv, jpos), (tk, tv, tpos) = _slot_state(jp, tp, (5, 17, 40), 7)
    tok = _tokens((3, 1, 1), 8)
    jl, jk, jv, jpos = jlm.lm_decode_step_slots(jp, jnp.asarray(tok), jk, jv,
                                                jpos, H)
    tl, tk2, tv2, tpos = tlm.lm_decode_step_slots(tp, torch.from_numpy(tok),
                                                  tk, tv, tpos, H)
    assert tk2 is tk and tl.shape == (3, 1, V)  # written in place
    _close(tl, jl)
    _same_argmax(tl, jl)
    win = _tokens((3, 3), 9)
    jl, jk, jv, jpos = jlm.lm_verify_window_slots(jp, jnp.asarray(win), jk, jv,
                                                  jpos, H)
    tl, tk, tv, tpos = tlm.lm_verify_window_slots(tp, torch.from_numpy(win),
                                                  tk, tv, tpos, H)
    _close(tl, jl)
    _same_argmax(tl, jl)
    _close(tk, jk)
    _close(tv, jv)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    assert tpos.tolist() == [[9], [21], [44]]


@pytest.mark.parametrize("kind", ["float", "w8a8"])
def test_decode_step_is_batch_invariant(trees, kind):
    # the serving engine's exactness contract: a slot's K/V writes and
    # logits from a step over many slots equal the same slot stepped alone,
    # bit for bit (w8a8 turns an ulp into a whole int8 step otherwise)
    _, tp = trees[kind]
    lengths = (5, 17, 40, 9, 33, 64, 1, 20)
    tk = torch.zeros((8, L * H, MAXLEN, HD))
    tv = torch.zeros_like(tk)
    tpos = torch.zeros((8, 1), dtype=torch.int32)
    for s, n in enumerate(lengths):
        _, tk[s], tv[s], tpos[s] = tlm.lm_prefill(
            tp, torch.from_numpy(_tokens((1, n), 20 + s)), H, MAXLEN)
    tok = torch.from_numpy(_tokens((8, 1, 1), 30))
    k8, v8 = tk.clone(), tv.clone()
    lg8, _, _, _ = tlm.lm_decode_step_slots(tp, tok, k8, v8, tpos.clone(), H)
    for s in range(8):
        k1, v1 = tk[s:s + 1].clone(), tv[s:s + 1].clone()
        lg1, _, _, _ = tlm.lm_decode_step_slots(tp, tok[s:s + 1], k1, v1,
                                                tpos[s:s + 1].clone(), H)
        assert torch.equal(k1[0], k8[s]) and torch.equal(v1[0], v8[s])
        assert torch.equal(lg1[0], lg8[s])


@pytest.mark.parametrize("kind", ["float", "w8a8"])
def test_overflow_poisons_logits_and_clamps_writes(trees, kind):
    jp, tp = trees[kind]
    (jk, jv, jpos), (tk, tv, tpos) = _slot_state(jp, tp, (6, 10), 10)
    # slot 0 continues as if MAXLEN - 2 tokens were cached
    jpos = jpos.at[0].set(MAXLEN - 2)
    tpos[0] = MAXLEN - 2
    win = _tokens((2, 4), 11)
    jl, jk, jv, jpos = jlm.lm_verify_window_slots(jp, jnp.asarray(win), jk, jv,
                                                  jpos, H)
    tl, tk, tv, tpos = tlm.lm_verify_window_slots(tp, torch.from_numpy(win),
                                                  tk, tv, tpos, H)
    # the slot past capacity is NaN, the other slot is untouched by it
    assert torch.isnan(tl[0]).all() and np.isnan(np.asarray(jl[0])).all()
    assert torch.isfinite(tl[1]).all()
    _close(tl[1], jl[1])
    # the write lands on the last W rows (dynamic_update_slice's clamp),
    # the pos_embed slice likewise: the caches agree with JAX's
    _close(tk, jk)
    _close(tv, jv)
    assert tpos.tolist() == [[MAXLEN + 2], [14]]
    # the single-stream step past the end: NaN logits, last row rewritten
    tk1, tv1 = tk[1].clone(), tv[1].clone()
    jl1, jk1, _, _ = jlm.lm_decode_step(jp, jnp.asarray(win[:1, :1]),
                                        jk[1], jv[1], jnp.asarray([MAXLEN]), H)
    tl1, tk1, _, _ = tlm.lm_decode_step(tp, torch.from_numpy(win[:1, :1]),
                                        tk1, tv1, torch.tensor([MAXLEN]), H)
    assert torch.isnan(tl1).all() and np.isnan(np.asarray(jl1)).all()
    _close(tk1, jk1)


def test_w8a8_long_prefill_code_flips_are_rare(trees):
    # w8a8 quantizes each activation row on its own grid: where XLA's and
    # torch's float32 sums differ by an ulp, a code sitting on a rounding
    # boundary moves by one step. Over a 126-token prefill that shows on
    # at most 1 % of the cached rows (by 1e-2 at most), never in the
    # logits' tolerance or argmax
    jp, tp = trees["w8a8"]
    tok = _tokens((1, MAXLEN - 2), 10)
    jl, jk, _, _ = jlm.lm_prefill(jp, jnp.asarray(tok), H, MAXLEN)
    tl, tk, _, _ = tlm.lm_prefill(tp, torch.from_numpy(tok), H, MAXLEN)
    _close(tl, jl)
    _same_argmax(tl, jl)
    diff = np.abs(tk.numpy() - np.asarray(jk))
    bad_rows = (diff > TOL["atol"] + TOL["rtol"] * np.abs(np.asarray(jk))
                ).any(-1)
    assert bad_rows.sum() <= bad_rows.size // 100
    assert diff.max() < 1e-2


def test_bf16_params_write_float32_caches(trees):
    # the engine's stores are float32 whatever the params: K/V are cast to
    # the cache's dtype before the write
    jp, _ = trees["float"]
    tb = causal_lm_params(_np(jp), CPU, dtype=torch.bfloat16)
    # a JAX bf16 tree (ml_dtypes leaves) converts to the same tensors
    jb = causal_lm_params(_np(jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16), jp)), CPU)
    assert all(torch.equal(tb[k], jb[k]) for k in tb)
    assert tb["wqkv"].dtype == torch.bfloat16
    tok = torch.from_numpy(_tokens((1, 1), 12))
    _, pk, pv, _ = tlm.lm_prefill(tb, tok, H, MAXLEN)
    assert pk.dtype == torch.bfloat16
    k0, v0, p0 = tlm.empty_cache(L, 1, H, MAXLEN, HD, device=CPU)
    tl, tk, tv, _ = tlm.lm_decode_step(tb, tok, k0, v0, p0, H)
    assert tk.dtype == tv.dtype == torch.float32
    assert torch.isfinite(tl).all()
    # layer 0's K/V are the same bf16 products in both forms, cast exactly
    # (later layers see the float32 cache through attention's promotion)
    assert torch.equal(tk[:H], pk[:H].float())
    assert torch.equal(tv[:H], pv[:H].float())


# --------------------------------------------------------------------------- #
# pinned contracts
# --------------------------------------------------------------------------- #

def test_layernorm_eps_and_no_bias():
    x = (np.random.default_rng(13).standard_normal((3, D)) * 1e-3
         ).astype(np.float32)  # variance ~1e-6: the epsilon matters
    scale = np.linspace(0.5, 2, D).astype(np.float32)
    want = np.asarray(jlm._ln(jnp.asarray(x), jnp.asarray(scale)))
    got = tlm._ln(torch.from_numpy(x), torch.from_numpy(scale)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    torch_ln = torch.nn.functional.layer_norm(
        torch.from_numpy(x), (D,), torch.from_numpy(scale), eps=1e-5).numpy()
    assert np.abs(torch_ln - want).max() > 1e-2  # the trap: torch's 1e-5


def test_dense_mask_fill_is_finite():
    q = torch.ones((1, 1, 2, 4))
    v = torch.arange(8, dtype=torch.float32).reshape(1, 1, 2, 4)
    mask = torch.tensor([[False, False], [True, True]])
    out = tlm._attend(q, q, v, mask)
    # a fully masked row averages v (fill -1e30), it does not turn NaN (-inf)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out[0, 0, 0].numpy(), v[0, 0].mean(0).numpy())


def test_float32_matmuls_ignore_a_tf32_setting(trees):
    _, tp = trees["float"]
    tok = torch.from_numpy(_tokens((1, 16), 14))
    want = tlm.lm_forward(tp, tok, H)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        seen = []
        real = ti8.matmul_any

        def spy(x, w):
            seen.append(torch.get_float32_matmul_precision())
            return real(x, w)

        tlm.matmul_any = spy
        try:
            got = tlm.lm_forward(tp, tok, H)
        finally:
            tlm.matmul_any = real
        assert set(seen) == {"highest"}
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert torch.equal(got, want)


def test_quantize_lm_params_bit_equal_to_jax(trees):
    jq, tq = trees["w8a8"]
    _, tp = trees["float"]
    mine = tlm.quantize_lm_params(tp)
    for k in tlm.GEMM_KEYS:
        assert ti8.is_quantized(mine[k]) and ti8.stack_shape(mine[k]) == \
            ti8.stack_shape(tq[k])
        assert torch.equal(mine[k][ti8.W8A8_TAG], tq[k][ti8.W8A8_TAG])
        assert torch.equal(mine[k]["s"], tq[k]["s"])
    assert mine["embed"] is tp["embed"]


def test_init_layout_and_statistics():
    want = jlm.init_causal_lm(jax.random.PRNGKey(0), V, D, H, L, MAXLEN)
    got = tlm.init_causal_lm(0, V, D, H, L, MAXLEN)
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    assert all(v.dtype == np.float32 for v in got.values())
    for k in ("embed", "wqkv", "w2"):
        assert abs(got[k].std() / np.asarray(want[k]).std() - 1) < 0.05
    assert (got["ln1"] == 1).all() and (got["lnf"] == 1).all()
    assert np.array_equal(got["wo"], tlm.init_causal_lm(0, V, D, H, L,
                                                        MAXLEN)["wo"])


def test_flops_and_empty_cache_match_jax():
    assert tlm.prefill_flops(8, 1024, 1024, 8, 8192) == \
        jlm.prefill_flops(8, 1024, 1024, 8, 8192)
    assert tlm.decode_flops(8, 100, 16, 1024, 8, 8192) == \
        jlm.decode_flops(8, 100, 16, 1024, 8, 8192)
    k, v, p = tlm.empty_cache(L, 2, H, MAXLEN, HD, device=CPU)
    jk, _, jp = jlm.empty_cache(L, 2, H, MAXLEN, HD)
    assert k.shape == jk.shape and k.dtype == torch.float32
    assert p.dtype == torch.int32 and int(p[0]) == int(jp[0]) == 0


# --------------------------------------------------------------------------- #
# quantizing passes, zoo and filter
# --------------------------------------------------------------------------- #

def test_quantize_params_w8_bit_equal_to_jax():
    tree = tlm.init_causal_lm(3, V, D, H, L, MAXLEN)
    tree["w1"][1, :, 5] = 0.0  # an all-zero channel
    want = jquant.quantize_params(tree)
    got = tquant.quantize_params(causal_lm_params(tree, CPU))
    for k in ("wqkv", "w1", "embed"):
        np.testing.assert_array_equal(got[k]["__w8__"].numpy(),
                                      np.asarray(want[k]["__w8__"]))
        np.testing.assert_array_equal(got[k]["scale"].numpy(),
                                      np.asarray(want[k]["scale"]))
    assert isinstance(got["lnf"], torch.Tensor)  # rank 1 stays float
    back = tquant.dequantize_params(got, dtype=None)
    jback = jquant.dequantize_params(want, dtype=None)
    np.testing.assert_array_equal(back["w2"].numpy(), np.asarray(jback["w2"]))
    assert back["w2"].dtype == torch.float32


def _zoo_spec():
    return f"zoo://causal_lm?vocab={V}&dim={D}&heads={H}&layers={L}&max_len=16"


def _decode_pipeline(custom, frames):
    from nnstreamer_tpu_torch.core.types import Caps, TensorsConfig, TensorsInfo
    from nnstreamer_tpu_torch.graph import Pipeline

    info = TensorsInfo.from_strings(
        f"1:1,{HD}:16:{L * H},{HD}:16:{L * H},1",
        "int32,float32,float32,int32")
    p = Pipeline(device="cpu")
    src = p.add_new("appsrc", caps=Caps.tensors(TensorsConfig(info)),
                    data=frames)
    filt = p.add_new("tensor_filter", framework="torch-cuda",
                     model=_zoo_spec(), custom=custom)
    sink = p.add_new("tensor_sink", store=True)
    Pipeline.link(src, filt, sink)
    p.run(timeout=120)
    return [[np.asarray(m.host()) for m in b.memories] for b in sink.buffers]


@pytest.mark.parametrize("quant", ["w8a8", "w8"])
def test_zoo_causal_lm_quantized_pipeline_matches_jax(quant):
    k, v, _ = jlm.empty_cache(L, 1, H, 16, HD)
    frames = [(np.asarray([[t]], np.int32), k, v, np.asarray([i], np.int32))
              for i, t in enumerate((3, 77, 5))]
    outs = _decode_pipeline(f"quant={quant}", frames)
    from nnstreamer_tpu_torch.models.zoo import get_model

    bundle = get_model(_zoo_spec(), device=CPU).metadata[
        "_w8a8_bundle" if quant == "w8a8" else "_w8_bundle"]
    assert bundle.metadata["quantized"] == quant
    assert bundle.name == f"causal_lm:{quant}"
    # the JAX package's decode step over the same (port zoo) weights
    tree = tlm.init_causal_lm(0, V, D, H, L, 16)
    jp = jlm.quantize_lm_params(tree) if quant == "w8a8" else \
        jquant.dequantize_params(jquant.quantize_params(tree), dtype=None)
    assert len(outs) == 3
    for (tok, kc, vc, pos), out in zip(frames, outs):
        want = jlm.lm_decode_step(jp, tok, kc, vc, pos, H)
        assert [o.shape for o in out] == [np.shape(w) for w in want]
        _close(out[0], want[0])
        _close(out[1], want[1])
        assert int(out[3][0]) == int(pos[0]) + 1


def test_filter_quant_errors_match_jax():
    from nnstreamer_tpu_torch.filters.torch_cuda import TorchCudaFilter
    from nnstreamer_tpu_torch.models.zoo import get_model

    bundle = get_model(_zoo_spec(), device=CPU)
    with pytest.raises(ValueError, match="unknown quant mode 'int4'"):
        TorchCudaFilter._maybe_quantize(bundle, {"quant": "int4"})
    # one pass per bundle: the quantized bundle memoizes on the base
    a = TorchCudaFilter._maybe_quantize(bundle, {"quant": "w8a8"})
    assert TorchCudaFilter._maybe_quantize(bundle, {"quant": "w8a8"}) is a
    assert TorchCudaFilter._maybe_quantize(bundle, {"quant": "int8"}) is \
        TorchCudaFilter._maybe_quantize(bundle, {"quant": "w8"})
    assert TorchCudaFilter._maybe_quantize(bundle, {}) is bundle
    mobilenet = get_model("zoo://mobilenet_v2?width=0.35&size=32", device=CPU)
    with pytest.raises(ValueError, match="w8a8"):
        tquant.quantize_bundle_w8a8(mobilenet)
    with pytest.raises(ValueError, match="quant=w8"):
        tquant.quantize_bundle(mobilenet)


def test_prefill_bundle_flash_matches_dense_bf16(trees):
    # the flash prefill pipeline's model at a small size: bf16 params, the
    # same tokens through flash and dense attention
    jp, _ = trees["float"]
    tb = causal_lm_params(_np(jp), CPU, dtype=torch.bfloat16)
    tok = torch.from_numpy(_tokens((2, 64), 15))
    flash = tlm.prefill_bundle(tb, H, 64, 2, flash=True).fn()(tok)
    dense = tlm.prefill_bundle(tb, H, 64, 2, flash=False).fn()(tok)
    assert flash.shape == (2, V) and flash.dtype == torch.float32
    # bf16 end to end: the flash path keeps f32 scores, the dense one bf16
    np.testing.assert_allclose(flash.numpy(), dense.numpy(), rtol=5e-2,
                               atol=3e-2)
    # and the same model in JAX (its flash kernel in interpret mode)
    jb = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
    want = jlm._lm_prefill(jb, jnp.asarray(tok.numpy()), H, 64, flash=True)[0]
    np.testing.assert_allclose(flash.numpy(), np.asarray(want, np.float32),
                               rtol=5e-2, atol=3e-2)
