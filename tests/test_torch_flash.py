"""The port's flash attention (nnstreamer_tpu_torch/ops/kernels/
flash_attention.py) against the JAX package's Pallas kernel.

On the CPU the wrapper runs ``flash_attention_plain``, held against
``nnstreamer_tpu.ops.pallas.flash_attention.flash_attention`` in interpret
mode on the same numpy inputs. Tolerances: float32 within 1e-5 abs and
rel (the block sizes differ, 64 keys here against the TPU kernel's padded
single block, and XLA's exp differs from torch's by an ulp on some
inputs); bfloat16 within the JAX package's own bf16 bound
(tests/test_pallas.py: rtol 5e-2, atol 3e-2). Residual mode returns the
unnormalised accumulator and the per-row m and l; m is a maximum of the
same scaled scores (equal up to the scores' own ulps). The CUDA kernel is
held against the plain version on the card (``cuda`` marker).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from nnstreamer_tpu.ops.pallas.flash_attention import \
    flash_attention as jflash  # noqa: E402
from nnstreamer_tpu_torch.ops.kernels import \
    flash_attention as tfa  # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=5e-2, atol=3e-2)


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("length", [64, 200])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret(causal, length, d, dtype):
    q, k, v = _qkv((1, 2, length, d), seed=length + d)
    if dtype == "float32":
        want = np.asarray(jflash(q, k, v, causal=causal, interpret=True))
        got = tfa.flash_attention_plain(
            *(torch.from_numpy(x) for x in (q, k, v)), causal=causal)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **F32)
    else:
        want = np.asarray(jflash(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                                 causal=causal, interpret=True), np.float32)
        got = tfa.flash_attention_plain(
            *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
            causal=causal)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, **BF16)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_residual_mode_matches_pallas_interpret(causal):
    q, k, v = _qkv((2, 2, 200, 64), seed=3)
    jacc, jm, jl = (np.asarray(x) for x in jflash(
        q, k, v, causal=causal, interpret=True, return_residuals=True))
    acc, m, l_sum = tfa.flash_attention_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
        return_residuals=True)
    assert acc.shape == (2, 2, 200, 64) and m.shape == l_sum.shape == (2, 2, 200)
    np.testing.assert_allclose(acc.numpy(), jacc, **F32)
    np.testing.assert_allclose(m.numpy(), jm, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(l_sum.numpy(), jl, **F32)
    # the residuals normalise to the plain output
    out = tfa.flash_attention_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                                    causal=causal)
    np.testing.assert_allclose((acc / l_sum[..., None]).numpy(), out.numpy(),
                               **F32)


def test_plain_takes_split_head_views():
    # the causal LM hands the kernel (B, H, T, hd) views of a (B, T, 3D)
    # projection: strided everywhere but the head axis
    qkv = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 50, 3 * 64)).astype(np.float32))
    views = [t.reshape(2, 50, 4, 16).transpose(1, 2) for t in qkv.split(64, -1)]
    assert not views[0].is_contiguous()
    got = tfa.flash_attention(*views, causal=True)
    want = tfa.flash_attention_plain(*(t.contiguous() for t in views))
    assert torch.equal(got, want)


def test_wrapper_cpu_runs_plain_and_raises_elsewhere():
    q, k, v = (torch.from_numpy(x) for x in _qkv((1, 1, 20, 16), seed=5))
    before = tfa.flash_attention.launches
    assert torch.equal(tfa.flash_attention(q, k, v),
                       tfa.flash_attention_plain(q, k, v))
    assert tfa.flash_attention.launches == before
    meta = q.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_attention(meta, meta, meta)


def test_causal_first_row_attends_only_itself():
    q, k, v = (torch.from_numpy(x) for x in _qkv((1, 1, 70, 16), seed=6))
    out = tfa.flash_attention_plain(q, k, v, causal=True)
    np.testing.assert_allclose(out[0, 0, 0].numpy(), v[0, 0, 0].numpy(),
                               rtol=1e-6)


# --------------------------------------------------------------------------- #
# on the card: the kernel against its plain version
# --------------------------------------------------------------------------- #

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,causal", [
    ((8, 16, 1024, 64), torch.bfloat16, True),
    ((8, 16, 1024, 64), torch.float32, True),
    ((2, 4, 1000, 64), torch.float32, False),
    ((2, 3, 200, 16), torch.float32, True),
    ((1, 2, 130, 128), torch.bfloat16, False),
], ids=["prefill_bf16", "prefill_f32", "L1000_full", "D16", "D128_bf16"])
@pytest.mark.parametrize("residual", [False, True], ids=["normalised", "residual"])
def test_kernel_matches_plain(cuda_device, shape, dtype, causal, residual):
    q, k, v = (torch.from_numpy(x).to(dtype).to(cuda_device)
               for x in _qkv(shape, seed=7))
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, causal, return_residuals=residual)
    want = tfa.flash_attention_plain(q, k, v, causal, return_residuals=residual)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    tol = F32 if dtype == torch.float32 else BF16
    if not residual:
        torch.testing.assert_close(got.float(), want.float(), **tol)
        return
    # the accumulator scales with l (hundreds of keys' weights): it is held
    # as acc / l, m and l within float32 summation order
    (acc, m, l_sum), (racc, rm, rl) = got, want
    torch.testing.assert_close(acc / l_sum[..., None], racc / rl[..., None], **tol)
    torch.testing.assert_close(m, rm, **F32)
    torch.testing.assert_close(l_sum, rl, **F32)
