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
@pytest.mark.parametrize("d", [192, 256])
def test_plain_matches_pallas_interpret_wide_heads(d, causal):
    # the heads the card refused before the tf32x3 route (D > 128); the
    # Pallas kernel pads them to a multiple of 128
    q, k, v = _qkv((1, 2, 130, d), seed=d)
    want = np.asarray(jflash(q, k, v, causal=causal, interpret=True))
    got = tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              causal=causal)
    assert got.shape == (1, 2, 130, d)
    np.testing.assert_allclose(got.numpy(), want, **F32)
    jacc, jm, jl = (np.asarray(x) for x in jflash(
        q, k, v, causal=causal, interpret=True, return_residuals=True))
    acc, m, l_sum = tfa.flash_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
        return_residuals=True)
    np.testing.assert_allclose(acc.numpy(), jacc, **F32)
    np.testing.assert_allclose(m.numpy(), jm, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(l_sum.numpy(), jl, **F32)


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


# --------------------------------------------------------------------------- #
# the two routes: which kernel a launch takes, and when TMA needs a copy
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("d", [16, 32, 40, 63, 64, 96, 100, 128,
                               1, 136, 192, 256, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_route_is_wgmma_only_for_bf16_at_d64_and_d128(dtype, d):
    # every float32 call, at every D, takes the tf32x3 route
    q = torch.zeros((1, 2, 10, d), dtype=dtype)
    want = "wgmma" if dtype == torch.bfloat16 and d in (64, 128) else "tf32x3"
    assert tfa._route(q, q, q) == want
    # the layout never changes the route
    wide = torch.zeros((1, 10, 2, d + 8), dtype=dtype)[..., 1:d + 1]
    assert tfa._route(*(wide.transpose(1, 2),) * 3) == want


def _split_heads(b, t, h, d, extra=0, dtype=torch.bfloat16):
    proj = torch.zeros((b, t, 3 * h * d + extra), dtype=dtype)
    return [z.reshape(b, t, h, d).transpose(1, 2)
            for z in proj[..., :3 * h * d].split(h * d, -1)]


@pytest.mark.parametrize("d", [64, 128])
def test_tma_ready_takes_the_lm_split_head_views(d):
    # d_model 1024: an L stride of 3 * 1024 elements (6144 bytes at D 64),
    # view offsets of 1024 elements (2048 bytes): no copy
    views = _split_heads(2, 50, 1024 // d, d)
    assert all(not t.is_contiguous() and tfa._tma_ready(t) for t in views)
    assert tfa._tma_strides(views[1]) == (50 * 3 * 1024, d, 3 * 1024)


@pytest.mark.parametrize("case", ["offset_one_element", "l_stride_odd",
                                  "h_stride_odd", "head_axis_strided"])
def test_tma_ready_refuses_what_tma_cannot_read(case):
    base = torch.zeros((2, 4, 30, 64 + 8), dtype=torch.bfloat16)
    if case == "offset_one_element":
        t = base.flatten()[1:1 + 2 * 4 * 30 * 64].view(2, 4, 30, 64)
    elif case == "l_stride_odd":
        t = _split_heads(2, 30, 4, 64, extra=3)[0]
        assert t.stride(2) % 8 != 0
    elif case == "h_stride_odd":
        t = torch.zeros((2, 30, 4 * 65), dtype=torch.bfloat16).reshape(
            2, 30, 4, 65)[..., :64].transpose(1, 2)
    else:
        t = torch.zeros((2, 4, 30, 128), dtype=torch.bfloat16)[..., ::2]
    assert not tfa._tma_ready(t)
    # the copy the wrapper makes is always ready
    assert tfa._tma_ready(t.clone(memory_format=torch.contiguous_format))


def test_tma_strides_fill_in_size_one_axes():
    t = torch.zeros((1, 1, 30, 64), dtype=torch.bfloat16)
    odd = t.as_strided(t.shape, (7, 3, 64, 1))
    assert tfa._tma_strides(odd) == (30 * 64, 30 * 64, 64)
    assert tfa._tma_ready(odd)


def _route_delta(before):
    return {r: tfa.flash_attention.launches_by_route[r] - before[r]
            for r in before}


@pytest.mark.cuda
@pytest.mark.parametrize("length", [70, 200, 1000])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("residual", [False, True], ids=["normalised", "residual"])
def test_wgmma_route_matches_plain(cuda_device, length, causal, d, residual):
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16).to(cuda_device)
               for x in _qkv((2, 3, length, d), seed=length + d))
    before = dict(tfa.flash_attention.launches_by_route)
    got = tfa.flash_attention(q, k, v, causal, return_residuals=residual)
    want = tfa.flash_attention_plain(q, k, v, causal, return_residuals=residual)
    torch.cuda.synchronize()
    assert _route_delta(before) == {"wgmma": 1, "tf32x3": 0}
    if not residual:
        torch.testing.assert_close(got.float(), want.float(), **BF16)
        return
    (acc, m, l_sum), (racc, rm, rl) = got, want
    torch.testing.assert_close(acc / l_sum[..., None], racc / rl[..., None], **BF16)
    torch.testing.assert_close(m, rm, **F32)
    torch.testing.assert_close(l_sum, rl, **F32)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_wgmma_route_takes_lm_split_head_views_without_copy(cuda_device, d):
    proj = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (2, 300, 3 * 1024)).astype(np.float32)).to(torch.bfloat16).to(cuda_device)
    views = [z.reshape(2, 300, 1024 // d, d).transpose(1, 2)
             for z in proj.split(1024, -1)]
    before, copies = dict(tfa.flash_attention.launches_by_route), tfa.flash_attention.tma_copies
    got = tfa.flash_attention(*views, causal=True)
    want = tfa.flash_attention_plain(*views, causal=True)
    torch.cuda.synchronize()
    assert _route_delta(before) == {"wgmma": 1, "tf32x3": 0}
    assert tfa.flash_attention.tma_copies == copies
    torch.testing.assert_close(got.float(), want.float(), **BF16)


@pytest.mark.cuda
def test_wgmma_route_copies_an_unaligned_view(cuda_device):
    flat = torch.from_numpy(np.random.default_rng(12).standard_normal(
        2 * 3 * 200 * 64 + 1).astype(np.float32)).to(torch.bfloat16).to(cuda_device)
    q = flat[1:].view(2, 3, 200, 64)  # 2 bytes off 16-byte alignment
    k, v = (torch.from_numpy(x).to(torch.bfloat16).to(cuda_device)
            for x in _qkv((2, 3, 200, 64), seed=13)[:2])
    assert q.data_ptr() % 16 != 0
    before, copies = dict(tfa.flash_attention.launches_by_route), tfa.flash_attention.tma_copies
    got = tfa.flash_attention(q, k, v, causal=True)
    want = tfa.flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert _route_delta(before) == {"wgmma": 1, "tf32x3": 0}
    assert tfa.flash_attention.tma_copies == copies + 1
    torch.testing.assert_close(got.float(), want.float(), **BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((2, 3, 200, 64), torch.float32), ((2, 3, 200, 32), torch.bfloat16),
    ((1, 2, 130, 96), torch.bfloat16)], ids=["f32_D64", "bf16_D32", "bf16_D96"])
def test_simt_route_takes_the_rest(cuda_device, shape, dtype):
    # the CUDA-core route is gone: what it took now takes tf32x3
    q, k, v = (torch.from_numpy(x).to(dtype).to(cuda_device)
               for x in _qkv(shape, seed=14))
    before = dict(tfa.flash_attention.launches_by_route)
    got = tfa.flash_attention(q, k, v, True)
    want = tfa.flash_attention_plain(q, k, v, True)
    torch.cuda.synchronize()
    assert _route_delta(before) == {"wgmma": 0, "tf32x3": 1}
    torch.testing.assert_close(got.float(), want.float(),
                               **(F32 if dtype == torch.float32 else BF16))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (1, 1, 1, 1), (2, 3, 63, 8), (2, 3, 65, 40), (1, 2, 1000, 64),
    (1, 2, 130, 136), (2, 2, 200, 192), (1, 2, 129, 256), (1, 1, 70, 512)],
    ids=["L1_D1", "L63_D8", "L65_D40", "L1000_D64", "D136", "D192", "D256",
         "D512"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("residual", [False, True], ids=["normalised", "residual"])
def test_tf32x3_route_matches_plain(cuda_device, shape, dtype, causal, residual):
    if dtype == torch.bfloat16 and shape[-1] == 64:
        shape = shape[:-1] + (72,)  # bf16 at D 64 is the wgmma route's
    q, k, v = (torch.from_numpy(x).to(dtype).to(cuda_device)
               for x in _qkv(shape, seed=sum(shape)))
    before = dict(tfa.flash_attention.launches_by_route)
    got = tfa.flash_attention(q, k, v, causal, return_residuals=residual)
    want = tfa.flash_attention_plain(q, k, v, causal, return_residuals=residual)
    torch.cuda.synchronize()
    assert _route_delta(before) == {"wgmma": 0, "tf32x3": 1}
    tol = F32 if dtype == torch.float32 else BF16
    if not residual:
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), **tol)
        return
    (acc, m, l_sum), (racc, rm, rl) = got, want
    torch.testing.assert_close(acc / l_sum[..., None], racc / rl[..., None], **tol)
    torch.testing.assert_close(m, rm, **F32)
    torch.testing.assert_close(l_sum, rl, **F32)


@pytest.mark.cuda
def test_tf32x3_route_takes_unaligned_and_strided_float32(cuda_device):
    # the 4-byte copy path: a base off 16-byte alignment, odd L strides
    flat = torch.from_numpy(np.random.default_rng(15).standard_normal(
        3 * 2 * 3 * 90 * 48 + 1).astype(np.float32)).to(cuda_device)
    q, k, v = (flat[1 + i * 2 * 3 * 90 * 48:].as_strided(
        (2, 3, 90, 45), (3 * 90 * 48, 90 * 48, 48, 1)) for i in range(3))
    before = dict(tfa.flash_attention.launches_by_route)
    got = tfa.flash_attention(q, k, v, True)
    want = tfa.flash_attention_plain(q, k, v, True)
    torch.cuda.synchronize()
    assert _route_delta(before) == {"wgmma": 0, "tf32x3": 1}
    torch.testing.assert_close(got, want, **F32)
