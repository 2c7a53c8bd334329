"""The port's LeNet-5 and MobileNet-v1 (models/lenet.py, mobilenet_v1.py) and
the zoo's aliases against the JAX package.

Both forwards equal the JAX bundles' on the same seeded uint8 frames with
the JAX bundles' flax variables loaded (``models.convert.load_flax``): rtol
1e-5 / atol 1e-6 for LeNet (float32 throughout); MobileNet-v1's float32
logits at rtol 1e-4 / atol 1e-9 (they are ~1e-7 at width 0.25 with flax's
initial weights, so the tolerance is relative), and its bf16 zoo default
within bf16 tolerance of itself run in float32. The MNIST label pipeline
(GRAY8 → ``tensor_converter`` → ``tensor_filter`` → ``image_labeling``)
labels each frame as the JAX pipeline does. ``zoo://mnist`` is an alias of
``lenet`` sharing its memo entry; a user factory under an aliased name
beats the alias; MobileNet-v1 and v2 at the same width have their JAX
counterparts' parameter counts, which differ.

Waiting (ROADMAP §A11): ``tests/test_model_pipelines.py:428``, LeNet's
``.jaxexport`` round trip, needs the port of ``models/deploy.py``;
``tests/test_model_pipelines.py:486``, MobileNet-v1's quantized label
pipeline, needs ``custom=quant=w8`` on convolutional bundles, which the
port's ``models/quantize.py`` refuses (it quantizes function-of-tree
bundles only): the test below holds that refusal.
"""

from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from nnstreamer_tpu.models.zoo import get_model as jget  # noqa: E402
from nnstreamer_tpu_torch.models.convert import load_flax  # noqa: E402
from nnstreamer_tpu_torch.models.zoo import get_model  # noqa: E402

V1 = ("zoo://mobilenet_v1?width=0.25&size=32&num_classes=16"
      "&dtype=float32")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(spec, jb):
    return load_flax(get_model(spec, device="cpu", fresh=True), _np(jb.params))


def _forward(bundle, x):
    with torch.no_grad():
        return bundle.apply(torch.from_numpy(x)).float().numpy()


@pytest.mark.parametrize("batch", [1, 3])
def test_lenet_forward_equals_jax(batch):
    spec = f"zoo://lenet?batch={batch}"
    jb = jget(spec)
    x = np.random.default_rng(batch).integers(
        0, 255, (batch, 28, 28, 1)).astype(np.uint8)
    got = _forward(_port(spec, jb), x)
    assert got.shape == (batch, 10)
    np.testing.assert_allclose(got, np.asarray(jax.jit(jb.fn())(x)),
                               rtol=1e-5, atol=1e-6)
    # a single (H, W, C) frame takes a batch of one, as in JAX
    np.testing.assert_allclose(_forward(_port(spec, jb), x[0]), got[:1],
                               rtol=1e-6, atol=1e-7)


def test_mobilenet_v1_forward_equals_jax():
    jb = jget(V1)
    x = np.random.default_rng(0).integers(0, 255, (2, 32, 32, 3)).astype(np.uint8)
    port = _port(V1, jb)
    got = _forward(port, x)
    assert got.shape == (2, 16) and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(jax.jit(jb.fn())(x)),
                               rtol=1e-4, atol=1e-9)


def test_mobilenet_v1_zoo_default_bf16():
    """The bf16 zoo default runs (convolutions in bf16) within bf16
    tolerance of the same seeded weights in float32."""
    b16 = get_model("zoo://mobilenet_v1?width=0.25&size=32&num_classes=16",
                    device="cpu")
    b32 = get_model(V1, device="cpu")
    x = np.random.default_rng(1).integers(0, 255, (1, 32, 32, 3)).astype(np.uint8)
    y16, y32 = _forward(b16, x), _forward(b32, x)
    scale = np.abs(y32).max()
    assert np.abs(y16 - y32).max() <= 5e-2 * scale


def test_forward_shapes_and_param_count():
    """v1 at width 0.25 is a different, smaller network than v2 at 0.25,
    and each has its JAX counterpart's parameter count."""
    spec2 = "zoo://mobilenet_v2?width=0.25&size=32&num_classes=16&dtype=float32"
    counts = {}
    for spec in (V1, spec2):
        port = get_model(spec, device="cpu")
        counts[spec] = sum(t.numel() for t in port.module.state_dict().values())
        want = sum(np.asarray(p).size
                   for p in jax.tree_util.tree_leaves(jget(spec).params))
        assert counts[spec] == want, spec
    assert counts[V1] != counts[spec2]


def _mnist_labels(pkg, model, labels, frames, **kw):
    core = __import__(f"{pkg}.core", fromlist=["Caps"])
    graph = __import__(f"{pkg}.graph", fromlist=["Pipeline"])
    p = graph.Pipeline(**kw)
    src = p.add_new("appsrc", caps=core.Caps("video/x-raw", {
        "format": "GRAY8", "width": 28, "height": 28,
        "framerate": Fraction(0, 1)}), data=list(frames))
    conv = p.add_new("tensor_converter")
    filt = p.add_new("tensor_filter", framework="xla-tpu", model=model)
    dec = p.add_new("tensor_decoder", mode="image_labeling",
                    option1=str(labels))
    sink = p.add_new("tensor_sink", store=True)
    graph.Pipeline.link(src, conv, filt, dec, sink)
    p.run(timeout=120)
    return [b.meta["label"] for b in sink.buffers]


def test_lenet_mnist_pipeline(tmp_path):
    """GRAY8 stream → LeNet → image_labeling (the reference's mnist.pb
    classification pipeline), labels equal to the JAX pipeline's."""
    labels = tmp_path / "digits.txt"
    labels.write_text("\n".join(str(i) for i in range(10)))
    frames = [np.random.default_rng(i).integers(0, 255, (28, 28, 1))
              .astype(np.uint8) for i in range(3)]
    jb = jget("zoo://lenet")
    want = _mnist_labels("nnstreamer_tpu", "zoo://lenet", labels, frames)
    got = _mnist_labels("nnstreamer_tpu_torch", _port("zoo://lenet", jb),
                        labels, frames, device="cpu")
    assert len(got) == 3 and got == want
    # the zoo spec (seeded weights) serves the same pipeline on the port
    seeded = _mnist_labels("nnstreamer_tpu_torch", "zoo://mnist", labels,
                           frames, device="cpu")
    assert all(lab in [str(i) for i in range(10)] for lab in seeded)


def test_mnist_alias_shares_the_memo_entry():
    assert get_model("zoo://mnist", device="cpu") \
        is get_model("zoo://lenet", device="cpu")


def test_user_factory_beats_builtin_alias():
    """register_model under an aliased name wins over the alias (a user
    extension point: silent shadowing would swap in the wrong model)."""
    from nnstreamer_tpu_torch.models.zoo import (ModelBundle, _factories,
                                                 model_names, register_alias,
                                                 register_model)

    assert "mnist" in model_names()
    marker = ModelBundle("user_mnist", lambda x: x)
    register_model("mnist", lambda **_: marker)
    try:
        assert get_model("zoo://mnist", device="cpu") is marker
        with pytest.raises(ValueError, match="unknown canonical"):
            register_alias("foo", "no_such_model")
    finally:
        _factories.pop("mnist", None)
        register_alias("mnist", "lenet")
    assert get_model("zoo://mnist", device="cpu").name == "lenet"


def test_zoo_catalog_has_the_jax_families():
    from nnstreamer_tpu.models.zoo import model_names as jnames
    from nnstreamer_tpu_torch.models.zoo import model_names

    port = set(model_names())
    for name in ("lenet", "mnist", "mobilenet_v1", "mobilenet_v2",
                 "stream_transformer", "moe_transformer"):
        assert name in port and name in jnames()


def test_quant_w8_on_convnets_is_refused(tmp_path):
    """Waiting: MobileNet-v1's quantized label pipeline (JAX
    tests/test_model_pipelines.py:486) needs quant=w8 on a convolutional
    bundle; the port refuses it rather than serve it unquantized."""
    from nnstreamer_tpu_torch.filters.base import FilterProps
    from nnstreamer_tpu_torch.filters.torch_cuda import TorchCudaFilter

    f = TorchCudaFilter()
    with pytest.raises(ValueError):
        f.open(FilterProps(model=V1, custom="quant=w8", device="cpu"))
