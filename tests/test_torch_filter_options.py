"""The port's filter options (nnstreamer_tpu_torch/filters/torch_cuda.py)
against the JAX filter (nnstreamer_tpu/filters/xla.py XLAFilter).

The same numpy inputs go through both filters on the CPU. ``bucket=`` and
``bucket_max=`` are held bit for bit, with ``flexible_output`` and the
caps the element sends downstream. ``resize=H:W`` is held bit for bit
against the JAX filter run op by op (``jax.disable_jit``): under jit, XLA
rewrites the sample-coordinate division ``* hf / th - 0.5`` into a
multiply by the reciprocal fused with the subtraction, so the jitted
filter differs from its own op-by-op run by float32 rounding of the sample
coordinates; against it the port is held within rtol 1e-5 and an atol of
1e-5 of the input's range. ``sync=`` and ``donate=`` change no output and
share one bundle with the filter that lacks them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from nnstreamer_tpu.core import Caps as JCaps  # noqa: E402
from nnstreamer_tpu.core import TensorFormat as JFormat  # noqa: E402
from nnstreamer_tpu.core import TensorsConfig as JConfig  # noqa: E402
from nnstreamer_tpu.core import TensorsInfo as JInfo  # noqa: E402
from nnstreamer_tpu.core.buffer import TensorMemory as JMem  # noqa: E402
from nnstreamer_tpu.filters.base import FilterProps as JProps  # noqa: E402
from nnstreamer_tpu.filters.xla import XLAFilter  # noqa: E402
from nnstreamer_tpu.graph import Pipeline as JPipeline  # noqa: E402
from nnstreamer_tpu_torch.core.buffer import TensorMemory as TMem  # noqa: E402
from nnstreamer_tpu_torch.core.types import (Caps, TensorFormat,  # noqa: E402
                                             TensorsConfig, TensorsInfo)
from nnstreamer_tpu_torch.filters.base import FilterProps as TProps  # noqa: E402
from nnstreamer_tpu_torch.filters.torch_cuda import (  # noqa: E402
    TorchCudaFilter, resolve_model)
from nnstreamer_tpu_torch.graph import Pipeline  # noqa: E402

CPU = torch.device("cpu")


def _ident(x):
    return x


def _region_max(x):  # (B, H, W, C) -> (B, C), exact on both packages
    if isinstance(x, torch.Tensor):
        return x.amax(dim=(1, 2))
    return x.max(axis=(1, 2))


def _open(model, custom, device=CPU):
    j = XLAFilter()
    j.open(JProps(model=model, custom=custom))
    t = TorchCudaFilter()
    t.open(TProps(model=model, custom=custom, device=device))
    return j, t


def _invoke(j, t, arrays):
    oj = [np.asarray(m.host()) for m in j.invoke([JMem(a) for a in arrays])]
    ot = [m.host() for m in t.invoke([TMem(torch.from_numpy(a)) for a in arrays])]
    return oj, ot


def _same(oj, ot):
    assert len(oj) == len(ot)
    for a, b in zip(oj, ot):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)


def test_bucket_stacks_a_frame_like_jax():
    # the repaired fault: the port emitted two (3,) tensors here
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal(3).astype(np.float32) for _ in range(2)]
    j, t = _open("zoo://passthrough", "bucket=4")
    assert j.flexible_output and t.flexible_output
    oj, ot = _invoke(j, t, arrays)
    assert [o.shape for o in ot] == [(2, 3)]
    _same(oj, ot)


@pytest.mark.parametrize("custom,n", [
    ("bucket=4", 1), ("bucket=4", 4), ("bucket=4", 5), ("bucket=3", 7),
    ("bucket=2,bucket_max=4", 4), ("bucket=2,bucket_max=4", 9),
    ("bucket=2", 17), ("bucket=4,bucket_max=2", 5)])
def test_bucket_and_bucket_max_match_jax(custom, n):
    # n above the cap (bucket_max, default 8 * bucket) is chunked into
    # cap-sized invokes whose outputs are concatenated
    rng = np.random.default_rng(n)
    arrays = [rng.integers(0, 255, (4, 5, 2)).astype(np.uint8)
              for _ in range(n)]
    j, t = _open(_region_max, custom)
    oj, ot = _invoke(j, t, [a.astype(np.float32) for a in arrays])
    assert ot[0].shape == (n, 2)
    _same(oj, ot)
    j, t = _open("zoo://passthrough", custom)
    _same(*_invoke(j, t, arrays))


def test_bucket_refuses_mixed_shapes_like_jax():
    arrays = [np.zeros((2, 2), np.float32), np.zeros((4, 4), np.float32)]
    j, t = _open(_ident, "bucket=4")
    for fw, mem in ((j, JMem), (t, lambda a: TMem(torch.from_numpy(a)))):
        with pytest.raises(ValueError, match="same-shape"):
            fw.invoke([mem(a) for a in arrays])


def _regions(rng, dtype, sizes, channels=(3,)):
    if dtype == np.uint8:
        return [rng.integers(0, 256, (h, w) + channels).astype(np.uint8)
                for h, w in sizes]
    return [rng.standard_normal((h, w) + channels).astype(np.float32)
            for h, w in sizes]


RESIZE_CASES = [
    ("bucket=4,resize=6:9", np.uint8, [(5, 7), (13, 4), (1, 1), (30, 17)], (3,)),
    ("bucket=2,resize=11:5", np.float32, [(5, 7), (13, 4), (100, 3), (9, 9)], ()),
    ("bucket=2,bucket_max=2,resize=4:4", np.float32, [(4, 4), (2, 9), (8, 8)], (2,)),
]


@pytest.mark.parametrize("custom,dtype,sizes,channels", RESIZE_CASES)
def test_resize_matches_jax_op_by_op(custom, dtype, sizes, channels):
    regions = _regions(np.random.default_rng(len(sizes)), dtype, sizes, channels)
    with jax.disable_jit():
        j, t = _open(_ident, custom)
        oj, ot = _invoke(j, t, regions)
    assert ot[0].dtype == np.float32
    _same(oj, ot)


@pytest.mark.parametrize("custom,dtype,sizes,channels", RESIZE_CASES)
def test_resize_matches_jitted_jax_within_rounding(custom, dtype, sizes, channels):
    regions = _regions(np.random.default_rng(len(sizes)), dtype, sizes, channels)
    j, t = _open(_ident, custom)
    oj, ot = _invoke(j, t, regions)
    span = max(float(np.abs(r.astype(np.float32)).max()) for r in regions)
    for a, b in zip(oj, ot):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5 * span)


def test_jax_jit_rewrites_the_resize_coordinates():
    # a divergence inside the JAX package, pinned: the jitted resize
    # differs from its op-by-op run; the port follows the op-by-op one
    regions = _regions(np.random.default_rng(3), np.uint8, [(5, 7), (13, 4)])
    j, _ = _open(_ident, "bucket=2,resize=6:9")
    jitted = np.asarray(j.invoke([JMem(a) for a in regions])[0].host())
    with jax.disable_jit():
        j, _ = _open(_ident, "bucket=2,resize=6:9")
        eager = np.asarray(j.invoke([JMem(a) for a in regions])[0].host())
    assert int((jitted != eager).sum()) > 0
    assert float(np.abs(jitted - eager).max()) < 1e-3


def test_resize_of_an_identity_size_is_the_region():
    img = np.arange(4 * 4 * 2, dtype=np.float32).reshape(4, 4, 2)
    _, t = _open(_ident, "bucket=4,resize=4:4")
    out = t.invoke([TMem(torch.from_numpy(img))])[0].host()
    np.testing.assert_array_equal(out[0], img)


@pytest.mark.parametrize("value", ["4", "1:2:3", "a:b", ":"])
def test_malformed_resize_raises_like_jax(value):
    custom = f"bucket=2,resize={value}"
    with pytest.raises(ValueError):
        XLAFilter().open(JProps(model=_ident, custom=custom))
    with pytest.raises(ValueError):
        TorchCudaFilter().open(TProps(model=_ident, custom=custom, device=CPU))


@pytest.mark.parametrize("custom", ["sync=true", "donate=true",
                                    "sync=1,donate=yes", "sync=false"])
def test_sync_and_donate_leave_outputs_unchanged(custom):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 8)).astype(np.float32)
    spec = "zoo://scaler?dims=8:1&types=float32&scale=5"
    j, t = _open(spec, custom)
    _, base = _open(spec, "")
    oj, ot = _invoke(j, t, [x])
    _same(oj, ot)
    _same([base.invoke([TMem(torch.from_numpy(x))])[0].host()], ot)
    assert not t.flexible_output


@pytest.mark.parametrize("custom", [
    "sync=true", "donate=true", "bucket=4", "bucket=4,bucket_max=8",
    "resize=4:4", "arch=zoo://scaler,arch_scale=2", "precision=bf16"])
def test_filter_options_share_one_bundle(custom):
    # none of the filter's own keys reaches the zoo factory or its memo key
    spec = "zoo://scaler?dims=8:1&types=float32&scale=3"
    base = resolve_model(spec, {}, CPU)
    t = TorchCudaFilter()
    t.open(TProps(model=spec, custom=custom, device=CPU))
    assert t._bundle is base


def _flex_caps(ns):
    return ns.Caps.tensors(ns.TensorsConfig(
        ns.TensorsInfo((), ns.TensorFormat.FLEXIBLE), 30))


class _J:
    Caps, TensorsConfig, TensorsInfo, TensorFormat = JCaps, JConfig, JInfo, JFormat


class _T:
    Caps, TensorsConfig, TensorsInfo, TensorFormat = \
        Caps, TensorsConfig, TensorsInfo, TensorFormat


def test_bucketed_pipeline_emits_flexible_frames_like_jax():
    # frames of 3, 1 and 6 regions through appsrc ! tensor_filter ! sink
    rng = np.random.default_rng(11)
    frames = [tuple(rng.standard_normal((5, 5, 2)).astype(np.float32)
                    for _ in range(n)) for n in (3, 1, 6)]
    outs, fmts = {}, {}
    for name, pipe_cls, ns, kw in (("jax", JPipeline, _J, {}),
                                   ("torch", Pipeline, _T, {"device": "cpu"})):
        p = pipe_cls(**kw)
        src = p.add_new("appsrc", caps=_flex_caps(ns), data=list(frames))
        filt = p.add_new("tensor_filter", framework="xla-tpu",
                         model=_region_max, custom="bucket=4,bucket_max=4")
        sink = p.add_new("tensor_sink", store=True)
        pipe_cls.link(src, filt, sink)
        p.run(timeout=60)
        outs[name] = [np.asarray(b.memories[0].host()) for b in sink.buffers]
        fmts[name] = filt.src_pads[0].caps.to_config().info.format.value
    assert fmts["torch"] == fmts["jax"] == "flexible"
    assert [o.shape for o in outs["torch"]] == [(3, 2), (1, 2), (6, 2)]
    _same(outs["jax"], outs["torch"])


# --------------------------------------------------------------------------- #
# on the card: the same options on CUDA tensors
# --------------------------------------------------------------------------- #

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the filter's CUDA path)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("custom,dtype,sizes,channels", RESIZE_CASES + [
    ("bucket=4,sync=true", np.float32, [(6, 6)] * 5, (2,))])
def test_options_on_the_card_match_the_cpu(cuda_device, custom, dtype, sizes,
                                           channels):
    regions = _regions(np.random.default_rng(5), dtype, sizes, channels)
    outs = {}
    for dev in (CPU, cuda_device):
        t = TorchCudaFilter()
        t.open(TProps(model=_region_max, custom=custom, device=dev))
        res = t.invoke([TMem(torch.from_numpy(r)) for r in regions])
        assert all(m.device().device.type == dev.type for m in res)
        outs[dev.type] = [m.host() for m in res]
    _same(outs["cpu"], outs["cuda"])
