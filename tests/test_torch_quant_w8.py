"""``custom="quant=w8"`` of module bundles (models/quantize.py) against the
JAX package, on the CPU.

The JAX package quantizes every float leaf of rank >= 2 of a bundle's flax
variables tree with last-axis absmax scales. The port quantizes the same
tree of its module (``convert.flax_tree``, convolutions HWIO, denses (in,
out)): with the JAX bundle's variables loaded, the int8 codes and the
float32 scales equal JAX's ``quantize_params`` leaf for leaf, bit for bit,
and ``params_nbytes``/``params_nbytes_f32`` equal JAX's, for LeNet,
MobileNet-v1 and MobileNet-v2. The quantized logits agree with JAX's
``quantize_bundle`` within the tolerances of the families' float32 tests
(LeNet rtol 1e-5 / atol 1e-6; the MobileNets rtol 1e-4 / atol 1e-9, their
logits ~1e-7 at flax's initial weights), labels exact.

Chosen divergence: a ``dtype=bfloat16`` zoo module holds bf16 kernels where
the JAX bundle holds float32 ones, so its codes are JAX's
``quantize_params`` of the tree rounded to bf16 (pinned below).

Also the cases of ``tests/test_quantize.py`` that hold without tflite, and
``tests/test_model_pipelines.py::TestMobileNetV1::test_quantized_label_pipeline``.
"""

from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from nnstreamer_tpu.models.quantize import quantize_bundle as jquantize  # noqa: E402
from nnstreamer_tpu.models.quantize import quantize_params as jquantize_params  # noqa: E402
from nnstreamer_tpu.models.zoo import get_model as jget  # noqa: E402
from nnstreamer_tpu_torch.core.types import TensorsInfo  # noqa: E402
from nnstreamer_tpu_torch.filters.base import FilterProps  # noqa: E402
from nnstreamer_tpu_torch.filters.torch_cuda import TorchCudaFilter  # noqa: E402
from nnstreamer_tpu_torch.models.convert import flax_tree, load_flax  # noqa: E402
from nnstreamer_tpu_torch.models.quantize import (  # noqa: E402
    dequantize_params, params_nbytes, quantize_bundle, quantize_params)
from nnstreamer_tpu_torch.models.zoo import ModelBundle, get_model  # noqa: E402

SPEC = "zoo://mobilenet_v2?width=0.25&size=32&num_classes=16&dtype=float32"
V1 = "zoo://mobilenet_v1?width=0.25&size=32&num_classes=16&dtype=float32"
CASES = {
    "lenet": ("zoo://lenet", (2, 28, 28, 1), dict(rtol=1e-5, atol=1e-6)),
    "mobilenet_v1": (V1, (2, 32, 32, 3), dict(rtol=1e-4, atol=1e-9)),
    "mobilenet_v2": (SPEC, (2, 32, 32, 3), dict(rtol=1e-4, atol=1e-9)),
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(spec, jb):
    return load_flax(get_model(spec, device="cpu", fresh=True), _np(jb.params))


def _flat(tree, prefix=()):
    """(path, leaf) pairs of a nested dict, keys sorted (jax's order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _bits(x):
    """A leaf as numpy (bfloat16 through its bits)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x)


def _same_leaves(port_tree, jax_tree):
    got = dict(_flat(port_tree))
    want = dict(_flat(_np(jax_tree)))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = _bits(got[path])
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg="/".join(path))
    return len(want)


@pytest.mark.parametrize("family", sorted(CASES))
def test_codes_and_scales_equal_jax_bit_for_bit(family):
    spec, _, _ = CASES[family]
    jb = jget(spec)
    qb = quantize_bundle(_port(spec, jb))
    jq = jquantize(jb)
    n = _same_leaves(qb.params, jq.params)
    assert n > 3
    for key in ("params_nbytes", "params_nbytes_f32"):
        assert qb.metadata[key] == jq.metadata[key], key
    assert qb.metadata["quantized"] == "w8"
    # the codes are static tensors in the module's layout; the tree's leaves
    # are views of them
    conv = [leaf for path, leaf in _flat(qb.params) if path[-1] == "__w8__"
            and leaf.dim() == 4][0]
    assert conv.permute(3, 2, 0, 1).is_contiguous()


@pytest.mark.parametrize("family", sorted(CASES))
def test_quantized_logits_equal_jax(family):
    spec, shape, tol = CASES[family]
    jb = jget(spec)
    qb = quantize_bundle(_port(spec, jb))
    x = np.random.default_rng(4).integers(0, 256, shape, dtype=np.uint8)
    want = np.asarray(jax.jit(jquantize(jb).fn())(x))
    with torch.inference_mode():
        got = qb.apply(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **tol)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_bf16_module_codes_are_those_of_its_bf16_kernels():
    """The chosen divergence: the port's bf16 MobileNet holds bf16 kernels
    (JAX's bf16 modules keep float32 ones and cast at the call), so its
    codes and scales are JAX's quantize_params of the float32 tree rounded
    to bf16; ``orig`` records bf16, and each call dequantizes in float32
    and casts to bf16, as the JAX module casts its float32 dequant."""
    spec = SPEC.replace("float32", "bfloat16")
    jb = jget(spec)
    qb = quantize_bundle(_port(spec, jb))
    rounded = jax.tree_util.tree_map(
        lambda a: np.asarray(a).astype(jax.numpy.bfloat16).astype(np.float32),
        _np(jb.params))
    want = dict(_flat(_np(jquantize_params(rounded))))
    got = dict(_flat(qb.params))
    quantized = [p[:-1] for p in want if p[-1] == "__w8__"]
    assert len(quantized) > 3
    for path in quantized:
        for part in ("__w8__", "scale"):
            np.testing.assert_array_equal(_bits(got[path + (part,)]),
                                          want[path + (part,)])
        assert got[path + ("orig",)].dtype == torch.bfloat16


def test_quantize_bundle_leaves_the_float_bundle_alone():
    """The quantized bundle runs on a parameterless shell of the module:
    the memoized float bundle keeps its tensors and outputs."""
    b = get_model(SPEC, device="cpu")
    before = {k: v.clone() for k, v in b.module.state_dict().items()}
    x = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (1, 32, 32, 3), dtype=np.uint8))
    with torch.inference_mode():
        want = b.apply(x)
        qb = quantize_bundle(b)
        qb.apply(x)
        got = b.apply(x)
    assert torch.equal(want, got)
    for k, v in b.module.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert qb.module is None and qb.forward is None


@pytest.mark.parametrize("spec", [
    "zoo://ssd_mobilenet_v2?width=0.35&size=64&num_classes=4&dtype=float32",
    "zoo://deeplab_v3?width=0.25&size=33&num_classes=5&dtype=float32",
    "zoo://posenet?width=0.25&size=33&dtype=float32",
    "zoo://lstm_cell?features=4&input_size=3"])
def test_every_zoo_module_quantizes_as_jax(spec):
    """Every module family of the zoo quantizes: codes bit-equal to JAX's,
    outputs within the float32 tolerance of the SSD slice."""
    jb = jget(spec)
    qb = quantize_bundle(_port(spec, jb))
    jq = jquantize(jb)
    _same_leaves(qb.params, jq.params)
    xs = [np.random.default_rng(6).normal(size=i.shape).astype(np.float32)
          if str(i.dtype) == "float32" else
          np.random.default_rng(6).integers(0, 256, i.shape, dtype=np.uint8)
          for i in jb.in_info]
    want = jax.jit(jq.fn())(*xs)
    want = want if isinstance(want, (tuple, list)) else (want,)
    with torch.inference_mode():
        got = qb.apply(*[torch.from_numpy(x) for x in xs])
    got = got if isinstance(got, (tuple, list)) else (got,)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


# --------------------------------------------------------------------------- #
# tests/test_quantize.py on the port
# --------------------------------------------------------------------------- #

def test_roundtrip_accuracy_and_size():
    b = get_model(SPEC, device="cpu")
    tree = flax_tree(b.module, b.module.state_dict())
    q = quantize_params(tree)
    deq = dequantize_params(q, torch.float32)
    # ~4x smaller on the matrix leaves; overall must shrink substantially
    assert params_nbytes(q) < 0.45 * params_nbytes(tree)
    for (_, o), (_, d) in zip(_flat(tree), _flat(deq)):
        if o.dim() >= 2:
            assert float((o - d).abs().max()) <= float(o.abs().max()) / 127.0 + 1e-7
        else:
            assert torch.equal(o, d)


def test_quantized_model_output_close():
    b = get_model(SPEC, device="cpu")
    qb = quantize_bundle(b, compute_dtype=torch.float32)
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, (1, 32, 32, 3)).astype(np.uint8))
    with torch.inference_mode():
        ref, got = b.apply(x).numpy(), qb.apply(x).numpy()
    assert got.shape == ref.shape
    denom = max(np.abs(ref).max(), 1e-6)
    assert np.abs(got - ref).max() / denom < 0.25
    assert qb.metadata["quantized"] == "w8"
    assert qb.metadata["params_nbytes"] < 0.45 * qb.metadata["params_nbytes_f32"]


def test_filter_quant_option_pipeline():
    from nnstreamer_tpu_torch.core import Caps
    from nnstreamer_tpu_torch.graph import Pipeline

    p = Pipeline(device="cpu")
    rng = np.random.default_rng(1)
    frames = [rng.integers(0, 255, (32, 32, 3)).astype(np.uint8) for _ in range(3)]
    src = p.add_new("appsrc", caps=Caps("video/x-raw", {
        "format": "RGB", "width": 32, "height": 32,
        "framerate": Fraction(0, 1)}), data=frames)
    conv = p.add_new("tensor_converter")
    filt = p.add_new("tensor_filter", framework="xla-tpu", model=SPEC,
                     custom="quant=w8")
    sink = p.add_new("tensor_sink", store=True)
    seen = {}
    sink.new_data = lambda b: seen.setdefault(
        "quantized", filt.fw._bundle.metadata.get("quantized"))
    Pipeline.link(src, conv, filt, sink)
    p.run(timeout=120)
    assert sink.num_buffers == 3
    assert seen["quantized"] == "w8"
    out = sink.buffers[0].memories[0].host()
    assert out.shape == (1, 16) and np.isfinite(out).all()


def test_unknown_quant_mode_rejected():
    f = TorchCudaFilter()
    with pytest.raises(ValueError, match="quant"):
        f.open(FilterProps(model=SPEC, custom="quant=int4", device="cpu"))


def test_callable_bundle_rejected():
    with pytest.raises(ValueError, match="params"):
        quantize_bundle(ModelBundle("f", lambda x: x))


def test_reload_preserves_quantization():
    f = TorchCudaFilter()
    f.open(FilterProps(model=SPEC, custom="quant=w8", device="cpu",
                       input_info=TensorsInfo.from_strings("3:32:32:1", "uint8")))
    assert f._bundle.metadata["quantized"] == "w8"
    f.reload_model(SPEC)  # hot swap must NOT revert to float weights
    assert f._bundle.metadata.get("quantized") == "w8"


def test_shared_spec_quantizes_once():
    f1, f2 = TorchCudaFilter(), TorchCudaFilter()
    f1.open(FilterProps(model=SPEC, custom="quant=w8", device="cpu"))
    f2.open(FilterProps(model=SPEC, custom="quant=w8", device="cpu"))
    assert f1._bundle is f2._bundle, \
        "filters over one memoized spec must share one quantized bundle"


# --------------------------------------------------------------------------- #
# tests/test_model_pipelines.py::TestMobileNetV1 on the port
# --------------------------------------------------------------------------- #

def _labels(pkg, model, labels, frames, **kw):
    core = __import__(f"{pkg}.core", fromlist=["Caps"])
    graph = __import__(f"{pkg}.graph", fromlist=["Pipeline"])
    p = graph.Pipeline(**kw)
    src = p.add_new("appsrc", caps=core.Caps("video/x-raw", {
        "format": "RGB", "width": 32, "height": 32,
        "framerate": Fraction(0, 1)}), data=list(frames))
    conv = p.add_new("tensor_converter")
    filt = p.add_new("tensor_filter", framework="xla-tpu", model=model,
                     custom="quant=w8")
    dec = p.add_new("tensor_decoder", mode="image_labeling", option1=str(labels))
    sink = p.add_new("tensor_sink", store=True)
    graph.Pipeline.link(src, conv, filt, dec, sink)
    p.run(timeout=180)
    return [b.meta["label"] for b in sink.buffers]


def test_quantized_label_pipeline(tmp_path):
    """MobileNet-v1 behind quant=w8 labels each frame as the JAX pipeline
    does (the port's module carrying the JAX bundle's variables), and the
    zoo spec string serves the quantized pipeline on the port."""
    labels = tmp_path / "l.txt"
    labels.write_text("\n".join(f"c{i}" for i in range(16)))
    frames = [np.random.default_rng(10 + i).integers(0, 256, (32, 32, 3), dtype=np.uint8)
              for i in range(3)]
    want = _labels("nnstreamer_tpu", V1, labels, frames)
    got = _labels("nnstreamer_tpu_torch", _port(V1, jget(V1)), labels, frames,
                  device="cpu")
    assert len(got) == 3 and got == want
    seeded = _labels("nnstreamer_tpu_torch", V1, labels, frames, device="cpu")
    assert len(seeded) == 3 and all(lab.startswith("c") for lab in seeded)
