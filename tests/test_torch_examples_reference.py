"""``serve_reference_models``: the port's script against the JAX script's,
on the CPU.

The reference's model files are not in the repository, so both scripts'
``MODELS``, ``DATA`` and ``LABELS`` are pointed at a temporary directory
holding the three files under the reference's names, built as the
existing tests build them: the seeded quantized MobileNet-v2 ``.tflite``
(``write_mobilenet_v2_quant_tflite``, tests/test_torch_tflite_writer.py's
size), tests/test_torch_tf_backend.py's ``mnist`` GraphDef and its
``9.raw``, and the legacy TorchScript LeNet zip (``write_legacy_lenet``),
with a seeded ``orange.png`` and ``9.png``. The label and the two digits
the port prints must equal the JAX script's, line for line.
"""

import contextlib
import io
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
tf = pytest.importorskip("tensorflow")
Image = pytest.importorskip("PIL.Image")

import chip_smoke as C  # noqa: E402

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples")
sys.path.insert(0, EXAMPLES)

import serve_reference_models as j_ref  # noqa: E402
import serve_reference_models_torch as t_ref  # noqa: E402


@pytest.fixture(scope="module")
def reference_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("reference")
    models, data, labels = root / "models", root / "data", root / "labels"
    for d in (models, data, labels):
        d.mkdir()
    rng = np.random.default_rng(25)
    C.write_mobilenet_v2_quant_tflite(
        str(models / "mobilenet_v2_1.0_224_quant.tflite"), size=96, width=0.35)
    Image.fromarray(rng.integers(0, 256, (96, 96, 3), dtype=np.uint8),
                    "RGB").save(data / "orange.png")
    (labels / "labels.txt").write_text("\n".join(f"label{i}" for i in range(1001)))
    # tests/test_torch_tf_backend.py's mnist fixture
    mrng = np.random.default_rng(3)
    g = tf.Graph()
    with g.as_default():
        x = tf.compat.v1.placeholder(tf.float32, [None, 784], name="input")
        w = tf.constant(mrng.standard_normal((784, 10)).astype(np.float32) * 0.05)
        b = tf.constant(mrng.standard_normal(10).astype(np.float32))
        tf.nn.softmax(tf.matmul(x, w) + b, name="softmax")
    (data / "9.raw").write_bytes(mrng.integers(0, 256, 784, dtype=np.uint8).tobytes())
    (models / "mnist.pb").write_bytes(g.as_graph_def().SerializeToString())
    C.write_legacy_lenet(str(models / "pytorch_lenet5.pt"), seed=0)
    Image.fromarray(rng.integers(0, 256, (28, 28), dtype=np.uint8),
                    "L").save(data / "9.png")
    return str(models), str(data), str(labels / "labels.txt")


def _patched_run(monkeypatch, module, run, paths):
    for name, value in zip(("MODELS", "DATA", "LABELS"), paths):
        monkeypatch.setattr(module, name, value)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = run()
    return out.getvalue().splitlines(), result


def test_reference_models_equal_jax(monkeypatch, reference_tree):
    want, rc = _patched_run(monkeypatch, j_ref, j_ref.main, reference_tree)
    assert rc == 0 and len(want) == 3
    got, found = _patched_run(
        monkeypatch, t_ref, lambda: t_ref.serve_reference(device="cpu"),
        reference_tree)
    assert got == want
    assert set(found) == {"tflite", "tensorflow", "pytorch"}
    assert found["tflite"].startswith("label")


def test_blocks_run_alone(monkeypatch, reference_tree):
    """The blocks run one by one (the card's machine has no TensorFlow,
    so its run leaves the ``.pb`` block out) and print what the whole
    run prints for them."""
    got, found = _patched_run(
        monkeypatch, t_ref,
        lambda: t_ref.serve_reference(blocks=("pytorch",), device="cpu"),
        reference_tree)
    assert list(found) == ["pytorch"] and len(got) == 1
    assert got[0].startswith("pytorch  pytorch_lenet5.pt (legacy format): digit ")


def test_absent_reference_prints_the_jax_line(monkeypatch, tmp_path):
    missing = (str(tmp_path / "nope"), str(tmp_path), str(tmp_path / "l.txt"))
    want, rc = _patched_run(monkeypatch, j_ref, j_ref.main, missing)
    got, found = _patched_run(monkeypatch, t_ref, lambda: t_ref.main([]),
                              missing)
    assert rc == found == 0
    assert got == want == ["reference test models not mounted; nothing to demo"]
