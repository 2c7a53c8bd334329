"""Sharded serving and the sequence-parallel models on the card: B5 at the
shapes the sequence-parallel transformers launch and at the long sums
fault C7 showed, sharded serving through the leader's filter on ranks
sharing the card, and sp×ep in the flash modes. Every case is marked
``cuda`` and skips without a card; this file imports no JAX (the card's
machine has no flax), and holds the card against the port's own plain
versions and single-card bundles. Run on the card with ``python -m pytest
tests/test_torch_sharded_cuda.py -m cuda -q``.

Tolerances: B5 against its plain version rtol / atol 1e-5 (the kernel's
float32 contract, FLASH_TOL in chip_smoke.py), and at L 8192 within 1e-6
of a float64 attention (the plain version's own distance there is about
1.2e-7, the kernel's 2.5e-7 after C7's repair); the sharded MobileNet-v2 and
sp×ep outputs rtol 2e-4 / atol 2e-5 of the single-card bundle (JAX's
tolerance for these cases), expert counts equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_ranks as tr  # noqa: E402
from nnstreamer_tpu_torch.models.zoo import get_model  # noqa: E402

BATCH, SIZE = 8, 16
SPEC = (f"zoo://mobilenet_v2?width=0.25&size={SIZE}&num_classes=8"
        f"&batch={BATCH}&dtype=float32")
MOE_SPEC = ("zoo://moe_transformer?layers=2&dim=32&heads=4&experts=2&seq=16"
            "&dtype=float32")
TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,residual", [
    ((1, 8, 1024, 16), True),    # ring-flash shard pair, sp 4 at seq 4096
    ((1, 2, 4096, 16), False),   # a2a-flash after the all_to_all, sp 4
    ((1, 8, 2048, 16), True),    # the MoE transformer's, sp 2
    ((1, 4, 4096, 16), False),
], ids=["ring_sp4", "a2a_sp4", "ring_sp2", "a2a_sp2"])
def test_flash_at_the_sequence_parallel_shapes_on_the_card(shape, residual):
    """B5 at the shapes the stream and MoE transformers launch under
    sequence parallelism (float32, full), one launch each, within rtol /
    atol 1e-5 of its plain version (m and l too)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from nnstreamer_tpu_torch.ops.kernels import flash_attention as fa

    rng = np.random.default_rng(31)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda()
               for _ in range(3))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, False, return_residuals=residual)
    want = fa.flash_attention_plain(q, k, v, False, return_residuals=residual)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    if residual:
        (acc, m, l_sum), (racc, rm, rl) = got, want
        torch.testing.assert_close(acc / l_sum[..., None], racc / rl[..., None],
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(m, rm, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(l_sum, rl, rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)



@pytest.mark.cuda
@pytest.mark.parametrize("shape,residual", [
    ((1, 2, 8192, 16), False),
    ((1, 2, 8192, 64), False),
    ((1, 2, 70, 512), True),
], ids=["L8192_D16", "L8192_D64", "D512_residual"])
def test_flash_long_sums_keep_float32_on_the_card(shape, residual):
    """C7: the tf32x3 route adds each 8-wide step of P.V (and of a D > 128
    score) in IEEE float32, outside the tensor core's truncating sum: at
    L 8192 the output stays within 1e-6 of a float64 attention (carried
    through the tensor core it drifted toward zero, 1.1e-5 off), and at
    D 512 the residual m and l within 1e-5 of the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from nnstreamer_tpu_torch.ops.kernels import flash_attention as fa

    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda()
               for _ in range(3))
    got = fa.flash_attention(q, k, v, False, return_residuals=residual)
    want = fa.flash_attention_plain(q, k, v, False, return_residuals=residual)
    torch.cuda.synchronize()
    if residual:
        (acc, m, l_sum), (racc, rm, rl) = got, want
        torch.testing.assert_close(m, rm, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(l_sum, rl, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(acc / l_sum[..., None], racc / rl[..., None],
                                   rtol=1e-5, atol=1e-5)
        return
    s = (q.double() @ k.double().transpose(-1, -2)) * fa._scale(shape[3])
    exact = torch.softmax(s, -1) @ v.double()
    assert (got.double() - exact).abs().max().item() < 1e-6
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_sharded_filter_on_the_card():
    """Two ranks sharing the card (gloo): the sharded bundle through the
    leader's filter on uneven batches, each within JAX's tolerance of the
    unsharded bundle on the card, never captured."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the ranks run on the card)")
    from nnstreamer_tpu_torch.parallel import launch

    rng = np.random.default_rng(0)
    xs = [rng.normal(size=(n, SIZE, SIZE, 3)).astype(np.float32)
          for n in (BATCH + 1, BATCH - 3, 1)]
    with launch.RankGroup(2, device="cuda", timeout=60, quiet=True) as g:
        res = g.run(tr.sharded_uneven, SPEC, None, {"data": 2, "model": 1}, xs)
    lead = res[0]
    assert not lead["captured"] and lead["batch_multiple"] == 2
    bundle = get_model(SPEC, device="cuda")
    for got, x in zip(lead["outs"], xs):
        with torch.inference_mode():
            want = bundle.apply(torch.from_numpy(x).cuda()).cpu().numpy()
        np.testing.assert_allclose(got, want, **TOL)
    assert res[1] == {"invokes": 3}



@pytest.mark.cuda
@pytest.mark.parametrize("sp_mode", ["ring-flash", "a2a-flash"])
def test_sp_ep_flash_on_the_card(sp_mode):
    """sp×ep over two ranks sharing the card (gloo, {sp 2, expert 1}) in
    the flash modes: equal to the single-card bundle within the tolerance
    above, with B5 launched as the code implies (ring: 2 a layer a rank;
    a2a: 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the ranks run on the card)")
    from nnstreamer_tpu_torch.parallel import launch

    spec = MOE_SPEC
    x = np.random.default_rng(2).normal(size=(1, 16, 32)).astype(np.float32)
    with launch.RankGroup(2, device="cuda", timeout=60, quiet=True) as g:
        res = g.run(tr.sp_ep_infer, spec, None, {"sp": 2, "expert": 1}, x,
                    sp_mode, True)
    single = {}
    bundle = get_model(spec, device="cuda")
    with torch.inference_mode():
        want = bundle.module(torch.from_numpy(x).cuda(), metrics=single).cpu().numpy()
    for r in res:
        np.testing.assert_allclose(r["y"], want, **TOL)
        np.testing.assert_array_equal(r["metrics"]["moe_block_1"]["expert_counts"],
                                      single["moe_block_1"]["expert_counts"].cpu().numpy())
        assert r["launches"] == (4 if sp_mode == "ring-flash" else 2)
