"""The nine ``examples/*_torch.py`` scripts on the card against their own
``device="cpu"`` runs (marked ``cuda``; they skip without one). No JAX
here: the CPU run is the reference.

TF32 is off, so the float32 models' labels and tokens must be equal;
logits and losses are compared within rtol 1e-4 (the card's and the CPU's
reductions sum in other orders).
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "examples"))

import adaptive_batch_serving_torch as t_abs  # noqa: E402
import classify_stream_torch as t_cls  # noqa: E402
import deploy_serve_torch as t_dep  # noqa: E402
import mqtt_fanout_torch as t_mqtt  # noqa: E402
import online_finetune_torch as t_ft  # noqa: E402
import remote_offload_torch as t_ro  # noqa: E402
import serve_lm_torch as t_lm  # noqa: E402
import serve_reference_models_torch as t_ref  # noqa: E402
import streaming_generate_torch as t_gen  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


def test_classify_stream(card):
    model = "zoo://mobilenet_v2?width=0.5&size=64&dtype=float32"
    got = t_cls.classify(model=model, frames=8, size=64, device=card)
    assert got == t_cls.classify(model=model, frames=8, size=64, device="cpu")


def test_adaptive_batch_serving(card):
    model = "zoo://mobilenet_v2?size=64&batch=4&dtype=float32"
    got = t_abs.serve(model=model, frames=12, size=64, batch=4, device=card)
    want = t_abs.serve(model=model, frames=12, size=64, batch=4, device="cpu")
    assert len(got) == 12 and got == want


def test_deploy_serve(card):
    assert t_dep.deploy(device=card) == t_dep.deploy(device="cpu")


def test_remote_offload(card):
    got, want = t_ro.offload(device=card), t_ro.offload(device="cpu")
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max())


def test_mqtt_fanout(card):
    assert t_mqtt.fanout(device=card) == (10, 10)


def test_online_finetune(card):
    got, want = t_ft.finetune(device=card), t_ft.finetune(device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_serve_lm(card):
    got, want = t_lm.serve(device=card), t_lm.serve(device="cpu")
    for name in ("greedy", "plain", "speculative", "w8a8"):
        assert got[name] == want[name], name


def test_streaming_generate(card):
    assert t_gen.generate(tokens=12, device=card) == \
        t_gen.generate(tokens=12, device="cpu")


def test_serve_reference_models(card, tmp_path):
    import chip_smoke as C
    from PIL import Image

    models, data = tmp_path / "models", tmp_path / "data"
    models.mkdir()
    data.mkdir()
    rng = np.random.default_rng(25)
    C.write_mobilenet_v2_quant_tflite(
        str(models / "mobilenet_v2_1.0_224_quant.tflite"), size=96, width=0.35)
    Image.fromarray(rng.integers(0, 256, (96, 96, 3), dtype=np.uint8),
                    "RGB").save(data / "orange.png")
    C.write_legacy_lenet(str(models / "pytorch_lenet5.pt"), seed=0)
    Image.fromarray(rng.integers(0, 256, (28, 28), dtype=np.uint8),
                    "L").save(data / "9.png")
    labels = tmp_path / "labels.txt"
    labels.write_text("\n".join(f"label{i}" for i in range(1001)))
    kw = {"blocks": ("tflite", "pytorch"), "models": str(models),
          "data": str(data), "labels": str(labels)}
    got = t_ref.serve_reference(device=card, **kw)
    assert got == t_ref.serve_reference(device="cpu", **kw)
    assert set(got) == {"tflite", "pytorch"}
