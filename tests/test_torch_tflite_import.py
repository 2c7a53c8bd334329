"""The port's TFLite importer: the cases of ``tests/test_tflite_import.py``.

The reference's ``.tflite`` files are not in the repository: the golden
cases on them keep the JAX file's ``needs_ref`` mark (each written here to
run on the port when the files are mounted). The rest run on the CPU
against the JAX package: the parse and load errors through the JAX case's
own body with its loader helpers pointed at the port's, and the
``add.tflite`` structure, the ``tensorflow-lite`` names with
``framework=auto`` and SingleShot on an ``add`` model the test builds
(``2.0`` added, as the reference's ``add.tflite``) and on the detection
post-process, each against JAX (``torch_tflite_parity``'s tolerances).
"""

import os

import numpy as np
import pytest
import torch

import test_tflite_import as J  # noqa: E402 — the JAX cases
import torch_tflite_parity as P  # noqa: E402
from test_tflite_ops import F32, build_tflite  # noqa: E402
from nnstreamer_tpu.filters.base import detect_framework as jdetect
from nnstreamer_tpu_torch.filters.base import detect_framework, find_filter
from nnstreamer_tpu_torch.graph import Pipeline
from nnstreamer_tpu_torch.models import tflite_import as T
from nnstreamer_tpu_torch.single import SingleShot

MODELS, DATA, LABELS, needs_ref = J.MODELS, J.DATA, J.LABELS, J.needs_ref

_WRITTEN_OUT = ("test_parse_add_tflite_structure", "test_add_tflite_adds_two",
                "test_mobilenet_quant_io_contract_matches_reference_caps",
                "test_mobilenet_quant_classifies_orange_e2e",
                "test_mobilenet_quant_orange_margin",
                "test_deeplab_tflite_runs_full_resolution",
                "test_tflite_extension_autodetects_xla",
                "test_singleshot_serves_tflite")


@pytest.mark.parametrize("case,kwargs", P.jax_cases(J, skip=_WRITTEN_OUT))
def test_jax_import_case_on_the_port(case, kwargs, tmp_path, monkeypatch):
    monkeypatch.setattr(J, "load_tflite", P.port_load)
    monkeypatch.setattr(J, "parse_tflite", T.parse_tflite)
    P.call_case(J, case, kwargs, tmp_path)


def _add_two(tmp_path):
    """``add.tflite``'s graph: one ADD of a (1,) float input and 2.0."""
    return P.write(build_tflite(
        tensors=[
            {"shape": (1,), "type": F32, "data": None, "name": "x"},
            {"shape": (1,), "type": F32,
             "data": np.array([2.0], np.float32)},
            {"shape": (1,), "type": F32, "data": None, "name": "y"},
        ],
        operators=[{"code": 0, "inputs": [0, 1], "outputs": [2],
                    "options": None}],
        inputs=[0], outputs=[2]), tmp_path, "add.tflite")


def _orange():
    return np.fromfile(os.path.join(DATA, "orange.raw"),
                       np.uint8).reshape(1, 224, 224, 3)


def _run(path, *xs):
    return P.run_port(T.load_tflite(path, device="cpu"), *xs)


@pytest.mark.parametrize("where", [
    "built", pytest.param("reference", marks=needs_ref)])
def test_parse_add_tflite_structure(tmp_path, where):
    path = _add_two(tmp_path) if where == "built" \
        else os.path.join(MODELS, "add.tflite")
    m = T.parse_tflite(path)
    assert [op.op for op in m.operators] == ["ADD"]
    assert len(m.inputs) == 1 and len(m.outputs) == 1
    assert m.tensors[m.inputs[0]].np_dtype == np.float32


@pytest.mark.parametrize("where", [
    "built", pytest.param("reference", marks=needs_ref)])
def test_add_tflite_adds_two(tmp_path, where):
    path = _add_two(tmp_path) if where == "built" \
        else os.path.join(MODELS, "add.tflite")
    (out,) = P.run_both(path, tmp_path, np.array([1.5], np.float32))
    assert np.allclose(out, [3.5])


@needs_ref
def test_mobilenet_quant_io_contract_matches_reference_caps():
    bundle = T.load_tflite(
        os.path.join(MODELS, "mobilenet_v2_1.0_224_quant.tflite"),
        device="cpu")
    assert bundle.in_info[0].dim_string == "3:224:224:1"
    assert str(bundle.in_info[0].dtype) == "uint8"
    assert bundle.out_info[0].dim_string == "1001:1"
    assert str(bundle.out_info[0].dtype) == "uint8"


@needs_ref
def test_mobilenet_quant_classifies_orange_e2e():
    p = Pipeline(device="cpu")
    src = p.add_new("imagefilesrc", location=os.path.join(DATA, "orange.png"))
    conv = p.add_new("tensor_converter")
    filt = p.add_new(
        "tensor_filter", framework="tensorflow-lite",
        model=os.path.join(MODELS, "mobilenet_v2_1.0_224_quant.tflite"))
    dec = p.add_new("tensor_decoder", mode="image_labeling", option1=LABELS)
    sink = p.add_new("tensor_sink", store=True)
    Pipeline.link(src, conv, filt, dec, sink)
    p.run(timeout=300)
    assert sink.num_buffers == 1
    label = bytes(sink.buffers[0].memories[0].host()).decode().strip("\x00")
    assert label == "orange"


@needs_ref
def test_mobilenet_quant_orange_margin(tmp_path):
    path = os.path.join(MODELS, "mobilenet_v2_1.0_224_quant.tflite")
    (out,) = P.run_both(path, tmp_path, _orange())
    scores = out.reshape(-1)
    labels = open(LABELS).read().splitlines()
    top = int(scores.argmax())
    assert labels[top] == "orange"
    second = int(np.argsort(scores)[-2])
    assert int(scores[top]) - int(scores[second]) >= 20


@needs_ref
def test_deeplab_tflite_runs_full_resolution():
    path = os.path.join(MODELS, "deeplabv3_257_mv_gpu.tflite")
    assert T.load_tflite(path, device="cpu").in_info[0].shape == \
        (1, 257, 257, 3)
    (out,) = _run(path, np.zeros((1, 257, 257, 3), np.float32))
    assert out.shape == (1, 257, 257, 21) and out.dtype == np.float32


@pytest.mark.parametrize("where", [
    "built", pytest.param("reference", marks=needs_ref)])
def test_tflite_extension_autodetects_xla(tmp_path, where):
    """``framework=auto`` on a ``.tflite`` file resolves to ``xla-tpu`` as
    in JAX, which is the port's ``torch-cuda``; the reference's names are
    its aliases."""
    path = _add_two(tmp_path) if where == "built" \
        else os.path.join(MODELS, "add.tflite")
    assert detect_framework(path) == jdetect(path) == "xla-tpu"
    assert find_filter(detect_framework(path)).NAME == "torch-cuda"
    for alias in ("tensorflow-lite", "tensorflow2-lite", "tensorflow1-lite",
                  "tflite"):
        assert find_filter(alias).NAME == "torch-cuda"


@pytest.mark.parametrize("framework", ["tensorflow-lite", "auto"])
def test_tflite_pipeline_auto_and_named(tmp_path, framework):
    """``tensor_filter framework=tensorflow-lite|auto model=x.tflite`` loads
    through the port on the pipeline's device and adds 2.0."""
    from nnstreamer_tpu_torch.core.types import Caps, TensorsConfig, TensorsInfo

    path = _add_two(tmp_path)
    p = Pipeline(device="cpu")
    info = TensorsInfo.from_strings("1", "float32")
    xs = [np.array([v], np.float32) for v in (1.5, -3.0)]
    src = p.add_new("appsrc", caps=Caps.tensors(TensorsConfig(info, 0)),
                    data=xs)
    filt = p.add_new("tensor_filter", framework=framework, model=path)
    sink = p.add_new("tensor_sink", store=True)
    Pipeline.link(src, filt, sink)
    p.run(timeout=60)
    got = [float(b.memories[0].host().reshape(-1)[0]) for b in sink.buffers]
    assert got == [3.5, -1.0]
    assert find_filter(filt.resolved_framework).NAME == "torch-cuda"


@pytest.mark.parametrize("where", [
    "built", pytest.param("reference", marks=needs_ref)])
def test_singleshot_serves_tflite(tmp_path, where):
    """SingleShot invoke on a ``.tflite`` file (tensor_filter_single
    semantics, no pipeline): the built ``add`` model on the CPU, or the
    reference's classifier."""
    if where == "built":
        s = SingleShot(framework="tensorflow-lite", model=_add_two(tmp_path),
                       device="cpu")
        (out,) = s.invoke(np.array([0.25], np.float32))
        assert torch.equal(torch.as_tensor(out).reshape(-1),
                           torch.tensor([2.25]))
        return
    s = SingleShot(framework="tensorflow-lite",
                   model=os.path.join(MODELS,
                                      "mobilenet_v2_1.0_224_quant.tflite"),
                   device="cpu")
    (out,) = s.invoke(_orange())
    labels = open(LABELS).read().splitlines()
    assert labels[int(np.asarray(torch.as_tensor(out)).reshape(-1).argmax())] \
        == "orange"
