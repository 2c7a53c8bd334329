"""The port's w8a8 int8 path (nnstreamer_tpu_torch/ops/int8.py) and its
``dequant_gelu_requant`` kernel against the JAX package.

On the CPU the wrapper runs ``dequant_gelu_requant_plain``, held against
the jitted ``dequant_gelu_requant_reference`` (eager XLA contracts the
dequant chain differently; tests/test_epilogue.py) and against the Pallas
kernel in interpret mode, on the same numpy inputs. Tolerances:
  * float32: codes equal except for at most 1 in 10,000 off by one, scales
    within rtol 1e-6 — XLA's tanh and torch's differ by an ulp on a few
    inputs, which can move a row's absmax by an ulp;
  * bfloat16: codes within 1, scales within rtol 1e-2, the JAX package's
    own bound (XLA keeps bf16 intermediates in float32 inside a fusion,
    torch rounds after every op).
``quantize_weight`` and ``quant_act`` are bit-equal. The CUDA kernel is held
bit-exact against the plain version on the card (``cuda`` marker).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nnstreamer_tpu.ops import int8 as ji8  # noqa: E402
from nnstreamer_tpu.ops.pallas import epilogue as jep  # noqa: E402
from nnstreamer_tpu_torch.ops import int8 as ti8  # noqa: E402
from nnstreamer_tpu_torch.ops.kernels import epilogue as tep  # noqa: E402

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _dgr_inputs(r, f, seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(-40000, 40000, (r, f)).astype(np.int32)
    xs = rng.uniform(1e-4, 1e-3, (r, 1)).astype(np.float32)
    ws = rng.uniform(1e-4, 1e-3, (f,)).astype(np.float32)
    y[1] = 0  # an all-zero row: scale 1
    return y, xs, ws


def _plain(y, xs, ws, dt):
    q, s = tep.dequant_gelu_requant_plain(torch.from_numpy(y),
                                          torch.from_numpy(xs),
                                          torch.from_numpy(ws), dt)
    return q.numpy(), s.numpy()


@pytest.mark.parametrize("rows,f", [(8, 4096), (64, 4096), (17, 130)],
                         ids=["decode_8x4096", "prefill_64x4096", "ragged_17x130"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dgr_plain_matches_jitted_reference_and_pallas(rows, f, dtype):
    tdt, jdt = DTYPES[dtype]
    y, xs, ws = _dgr_inputs(rows, f, seed=rows + f)
    pq, ps = _plain(y, xs, ws, tdt)
    ref = jax.jit(functools.partial(jep.dequant_gelu_requant_reference,
                                    out_dtype=jdt))
    outs = [ref(y, xs, ws),
            jep.dequant_gelu_requant(y, xs, ws, out_dtype=jdt, interpret=True)]
    assert pq.dtype == np.int8 and ps.dtype == np.float32
    assert ps[1, 0] == 1.0 and not pq[1].any()
    for jq, js in outs:
        dq = np.abs(np.asarray(jq, np.int32) - pq.astype(np.int32))
        assert dq.max() <= 1
        if dtype == "float32":
            assert np.count_nonzero(dq) <= max(1, dq.size // 10000)
            np.testing.assert_allclose(ps, np.asarray(js), rtol=1e-6)
        else:
            np.testing.assert_allclose(ps, np.asarray(js, np.float32),
                                       rtol=1e-2)


def test_dgr_plain_zero_row_scale_is_one():
    y = np.zeros((4, 130), np.int32)
    xs = np.full((4, 1), 1e-3, np.float32)
    ws = np.full((130,), 1e-3, np.float32)
    for dt in (torch.float32, torch.bfloat16):
        q, s = _plain(y, xs, ws, dt)
        assert (s == 1.0).all() and not q.any()


def test_gelu_tanh_is_jax_gelu_not_erf():
    x = np.linspace(-6, 6, 4001).astype(np.float32)
    got = tep.gelu_tanh(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jax.nn.gelu)(x))
    # tanh differs by an ulp between the libraries; near -6 gelu is ~1e-8
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - want).max() > 1e-4  # the trap: torch defaults to erf


def test_gelu_constants_match_jax_casts():
    for tdt, jdt in DTYPES.values():
        c0, c1 = tep.gelu_constants(tdt)
        assert c0 == float(np.asarray(np.sqrt(2 / np.pi)).astype(jdt))
        assert c1 == float(jnp.asarray(0.044715, jdt))


@pytest.mark.parametrize("shape", [(16, 8), (3, 64, 96), (5, 1)])
def test_quantize_weight_bit_equal(shape):
    rng = np.random.default_rng(len(shape))
    w = rng.normal(size=shape).astype(np.float32)
    if len(shape) == 3:
        w[1, :, 7] = 0.0  # an all-zero output channel: scale 1
    want = ji8.quantize_weight(w)
    got = ti8.quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(np.asarray(want[ji8.W8A8_TAG]),
                                  got[ti8.W8A8_TAG].numpy())
    np.testing.assert_array_equal(np.asarray(want["s"]), got["s"].numpy())
    assert ti8.stack_shape(got) == shape


def test_quant_act_bit_equal_with_zero_row():
    x = np.random.default_rng(3).normal(size=(2, 7, 64)).astype(np.float32)
    x[0, 3] = 0.0
    jq, js = ji8.quant_act(jnp.asarray(x))
    tq, ts = ti8.quant_act(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    assert ts[0, 3, 0] == 1.0


def test_int8_matmul_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64, 48)).astype(np.float32)
    want = np.asarray(jax.jit(ji8.int8_matmul)(x, ji8.quantize_weight(w)))
    got = ti8.int8_matmul(torch.from_numpy(x),
                          ti8.quantize_weight(torch.from_numpy(w))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_mlp_matmul_w8a8_is_the_unfused_composition_bit_for_bit():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2, 9, 64)).astype(np.float32))
    w1 = ti8.quantize_weight(torch.from_numpy(
        rng.normal(size=(64, 256)).astype(np.float32) / 8))
    w2 = ti8.quantize_weight(torch.from_numpy(
        rng.normal(size=(256, 64)).astype(np.float32) / 16))
    fused = ti8.mlp_matmul(x, w1, w2)
    unfused = ti8.matmul_any(tep.gelu_tanh(ti8.matmul_any(x, w1)), w2)
    assert torch.equal(fused, unfused)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "w8a8"])
def test_mlp_matmul_matches_jax(quant):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 9, 64)).astype(np.float32)
    w1 = (rng.normal(size=(64, 256)) / 8).astype(np.float32)
    w2 = (rng.normal(size=(256, 64)) / 16).astype(np.float32)
    if quant:
        jw = (ji8.quantize_weight(w1), ji8.quantize_weight(w2))
        tw = tuple(ti8.quantize_weight(torch.from_numpy(w)) for w in (w1, w2))
    else:
        jw = (w1, w2)
        tw = (torch.from_numpy(w1), torch.from_numpy(w2))
    want = np.asarray(jax.jit(ji8.mlp_matmul)(x, *jw))
    got = ti8.mlp_matmul(torch.from_numpy(x), *tw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_matmul_any_promotes_mixed_float_dtypes_as_jax():
    x = torch.ones((2, 4), dtype=torch.bfloat16)
    w = torch.full((4, 3), 0.5, dtype=torch.float32)
    assert ti8.matmul_any(x, w).dtype == torch.float32


def test_dgr_wrapper_cpu_runs_plain_and_raises_elsewhere():
    y, xs, ws = (torch.from_numpy(a) for a in _dgr_inputs(8, 64, seed=2))
    before = tep.dequant_gelu_requant.launches
    q, s = tep.dequant_gelu_requant(y, xs, ws, torch.float32)
    pq, ps = tep.dequant_gelu_requant_plain(y, xs, ws, torch.float32)
    assert tep.dequant_gelu_requant.launches == before
    assert torch.equal(q, pq) and torch.equal(s, ps)
    with pytest.raises(ValueError, match="unsupported device"):
        tep.dequant_gelu_requant(y.to("meta"), xs.to("meta"), ws.to("meta"))


# --------------------------------------------------------------------------- #
# on the card: the kernel against its plain version, bit for bit
# --------------------------------------------------------------------------- #

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [8, 512])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dgr_kernel_bit_exact_with_plain(cuda_device, rows, dtype):
    tdt = DTYPES[dtype][0]
    y, xs, ws = (torch.from_numpy(a).to(cuda_device)
                 for a in _dgr_inputs(rows, 4096, seed=rows))
    before = tep.dequant_gelu_requant.launches
    q, s = tep.dequant_gelu_requant(y, xs, ws, tdt)
    pq, ps = tep.dequant_gelu_requant_plain(y, xs, ws, tdt)
    torch.cuda.synchronize()
    assert tep.dequant_gelu_requant.launches == before + 1
    assert torch.equal(q, pq) and torch.equal(s, ps)


@pytest.mark.cuda
def test_mlp_matmul_on_card_is_the_composition(cuda_device):
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(8, 1024)).astype(np.float32)).to(cuda_device)
    w1 = ti8.quantize_weight(torch.from_numpy(
        rng.normal(size=(1024, 4096)).astype(np.float32) / 32).to(cuda_device))
    w2 = ti8.quantize_weight(torch.from_numpy(
        rng.normal(size=(4096, 1024)).astype(np.float32) / 64).to(cuda_device))
    fused = ti8.mlp_matmul(x, w1, w2)
    unfused = ti8.matmul_any(tep.gelu_tanh(ti8.matmul_any(x, w1)), w2)
    assert torch.equal(fused, unfused)


@pytest.mark.parametrize("rows,f,want", [
    (1, 4096, 8), (3, 4096, 8), (8, 4096, 8), (17, 4096, 7), (33, 4096, 4),
    (66, 4096, 2), (131, 4096, 1), (132, 4096, 1), (512, 4096, 1),
    (8, 1000, 4), (8, 256, 1), (8, 257, 2), (1, 11, 1), (1, 1 << 20, 8)])
def test_dgr_cluster_size(rows, f, want):
    # at most 132 blocks in all, at most 8 a row, one per 256 columns
    assert tep.dgr_cluster_size(rows, f) == want
    assert 1 <= want <= tep.MAX_CLUSTER


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 3, 8, 33, 132, 512])
@pytest.mark.parametrize("f", [4096, 1000, 11, 70000])  # 70000: recomputed columns
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dgr_cluster_kernel_bit_exact_with_plain(cuda_device, rows, f, dtype):
    tdt = DTYPES[dtype][0]
    y, xs, ws = _dgr_inputs(max(rows, 2), f, seed=rows * f)
    y, xs = y[:rows].copy(), xs[:rows].copy()
    y[0] = 0  # an all-zero row at every R: scale 1
    y, xs, ws = (torch.from_numpy(a).to(cuda_device) for a in (y, xs, ws))
    before = tep.dequant_gelu_requant.launches
    q, s = tep.dequant_gelu_requant(y, xs, ws, tdt)
    pq, ps = tep.dequant_gelu_requant_plain(y, xs, ws, tdt)
    torch.cuda.synchronize()
    assert tep.dequant_gelu_requant.launches == before + 1
    assert float(s[0, 0]) == 1.0
    assert torch.equal(q, pq) and torch.equal(s, ps)
