"""The torch port's probes and tiny zoo models, on the CPU.

``utils/probes.py``: the H100 peak lookup by CUDA device name, the MFU and
pipeline-utilization arithmetic (the JAX package's formulas), FLOP counts
of a small convolution and a matrix product against the analytic count,
the phase split's keys, and ``gpu_smoke``'s items (the kernel item fails
off the card, as the JAX package's Pallas item fails off the TPU).
``models/simple.py``'s four models against the JAX package's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from nnstreamer_tpu.models.zoo import get_model as jax_get_model  # noqa: E402
from nnstreamer_tpu.utils import probes as jprobes  # noqa: E402
from nnstreamer_tpu_torch.models.zoo import get_model  # noqa: E402
from nnstreamer_tpu_torch.utils import probes  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def on_h100(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a, **k: H100)


def test_h100_peaks_by_device_name(on_h100):
    assert probes.chip_peak_flops("cuda:0") == 989e12
    assert probes.chip_peak_flops("cuda:0", torch.float32) == 67e12
    assert probes.chip_peak_flops("cuda:0", "tf32") == 495e12
    assert probes.chip_peak_hbm_bw("cuda:0") == 3.35e12
    assert probes.ridge_intensity("cuda:0") == pytest.approx(989e12 / 3.35e12)
    assert probes.ridge_intensity("cuda:0", torch.float32) == pytest.approx(20.0, rel=1e-2)


def test_unknown_card_falls_back_to_the_h100(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a, **k: "Some GPU")
    assert probes.chip_peak_flops("cuda") == probes.DEFAULT_PEAK[torch.bfloat16]
    assert probes.chip_peak_hbm_bw("cuda") == probes.DEFAULT_HBM_BW
    assert probes.chip_peak_hbm_bw("cpu") == 50e9


@pytest.mark.parametrize("flops,fps", [(1e9, 30.0), (4.2e12, 7.5), (3e8, 1000.0)])
def test_mfu_and_pipeline_util_arithmetic(on_h100, flops, fps):
    want = flops * fps / 989e12
    assert probes.mfu(flops, fps, "cuda") == pytest.approx(want)
    assert probes.pipeline_util(flops, fps, "cuda") == pytest.approx(want)
    assert probes.mfu(flops, fps, "cuda", torch.float32) == pytest.approx(flops * fps / 67e12)
    # the JAX package's formula on its own table: the same ratio
    assert jprobes.mfu(flops, fps) == pytest.approx(flops * fps / jprobes.chip_peak_flops())


@pytest.mark.parametrize("flops,fps", [(None, 30.0), (0.0, 30.0), (1e9, float("nan")),
                                       (1e9, float("inf"))])
def test_mfu_is_none_without_a_rate(flops, fps):
    assert probes.mfu(flops, fps, "cpu") is None
    assert jprobes.mfu(flops, fps) is None


@pytest.mark.parametrize("m,k,n", [(8, 16, 4), (1, 256, 256), (33, 7, 5)])
def test_model_flops_of_a_matmul(m, k, n):
    a, b = torch.ones(m, k), torch.ones(k, n)
    assert probes.model_flops(lambda x, y: x @ y, a, b) == 2 * m * k * n


@pytest.mark.parametrize("cin,cout,kh,hw,stride,groups", [
    (3, 8, 3, 10, 1, 1), (16, 16, 3, 12, 2, 16), (8, 24, 1, 7, 1, 1)])
def test_model_flops_of_a_convolution(cin, cout, kh, hw, stride, groups):
    conv = torch.nn.Conv2d(cin, cout, kh, stride=stride, groups=groups, bias=False)
    out = (hw - kh) // stride + 1
    want = 2 * cout * out * out * (cin // groups) * kh * kh
    assert probes.model_flops(conv, torch.ones(1, cin, hw, hw)) == want


def test_model_flops_is_none_without_counted_ops():
    assert probes.model_flops(lambda x: x + 1, torch.ones(4)) is None


def test_phase_split_keys_on_the_cpu():
    out = probes.phase_split(lambda x: x * 2, [np.ones((8, 8), np.float32)],
                             device="cpu", k=2)
    assert sorted(out) == sorted(["rtt_us", "h2d_us", "compute_us", "d2h_us"])
    assert all(v >= 0 for v in out.values())


def test_gpu_smoke_items_on_the_cpu():
    res = probes.gpu_smoke("cpu")
    assert res["device"] == "cpu"
    assert res["device_resident_flow"] == "pass"
    assert res["decoder_submit_complete"] == "pass"
    # tpu_smoke's bucketed_invoke and donate_invoke, and the filter's .py
    # and (fn, params) model forms
    assert res["bucketed_invoke"] == "pass"
    assert res["donate_invoke"] == "pass"
    assert res["model_forms"] == "pass"
    assert res["cuda_kernel"].startswith("FAIL: AssertionError")


# --------------------------------------------------------------------------- #
# models/simple.py against the JAX package's
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("spec,dtype", [
    ("zoo://passthrough?dims=3:4:4:1&types=uint8", np.uint8),
    ("zoo://scaler?dims=3:4:4:1&types=uint8&scale=2", np.uint8),
    ("zoo://scaler?dims=4:2&types=float32&scale=0.1", np.float32),
    ("zoo://average?dims=3:4:4:2&types=float32", np.float32),
    ("zoo://average?dims=3:4:4:2&types=uint8", np.uint8),
])
def test_simple_models_match_jax(spec, dtype):
    jb, pb = jax_get_model(spec), get_model(spec, device="cpu")
    shape = jb.in_info[0].shape
    x = np.random.default_rng(0).uniform(0, 255, shape).astype(dtype)
    want = np.asarray(jb.fn()(jnp.asarray(x)))
    got = pb.fn()(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert str(pb.in_info) == str(jb.in_info) and str(pb.out_info) == str(jb.out_info)
    # average sums in another order than XLA (float32, 48 values)
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64),
                               rtol=1e-6 if "average" in spec else 0, atol=0)


def test_matmul_model_matches_jax_with_its_weights():
    jb = jax_get_model("zoo://matmul?n=64&batch=2")
    pb = get_model("zoo://matmul?n=64&batch=2", device="cpu")
    x = np.random.default_rng(1).normal(size=(2, 64)).astype(np.float32)
    want = np.asarray(jb.fn()(jnp.asarray(x)))
    got = pb.apply_params(torch.from_numpy(np.array(jb.params)), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert tuple(pb.fn()(torch.from_numpy(x)).shape) == (2, 64)
