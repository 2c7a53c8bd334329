"""``chip_smoke.py``'s ``.tflite`` writer, at reduced width, on the CPU.

The card's phase writes its two models with the port's own FlatBuffers and
FlexBuffers builders (the card's machine has no ``flatbuffers``): the
ssd_mobilenet_v2_coco export (float32, ``TFLite_Detection_PostProcess``)
and the layout of ``mobilenet_v2_1.0_224_quant.tflite`` (uint8 in and out,
per-tensor grids). Here each is written at a reduced size (SSD 96×96 at
width 0.25, 204 anchors; the classifier 96×96 at width 0.35) and read by
the JAX package's ``parse_tflite`` and by ``tf.lite.Interpreter``:

  * the custom options' bytes equal the stock FlexBuffers builder's, and
    both parsers read the same ops, tensors and grids;
  * through the JAX loader and the port's: params bit-equal, outputs
    within ``torch_tflite_parity``'s tolerances (float32 rtol 1e-5 / atol
    1e-6, the post-process's count and classes equal; uint8 codes at most
    one step apart on at most 2%, top-1 equal), and against the
    interpreter (boxes and scores within 1e-5, count and classes equal;
    uint8 codes within the JAX mobilenet case's four steps, top-1 equal).

On seeded weights a wider quantized network is chaotic: one code moved by
a float32 ulp spreads to most later codes, so JAX (float32) and the port
(snapped ops in float64, models/tflite_import.py) part at full width; the
card's phase holds the full-width classifier against the port on the CPU.
"""

import os
import sys

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

import torch_tflite_parity as P  # noqa: E402
from nnstreamer_tpu.models.tflite_import import parse_tflite as jparse  # noqa: E402
from nnstreamer_tpu_torch.models.tflite_import import parse_tflite  # noqa: E402

sys.path.insert(0, os.path.dirname(P.here()))
import chip_smoke as C  # noqa: E402


def _interp(path, x):
    it = tf.lite.Interpreter(model_path=str(path))
    it.allocate_tensors()
    it.set_tensor(it.get_input_details()[0]["index"], x)
    it.invoke()
    return [it.get_tensor(d["index"]) for d in it.get_output_details()]


@pytest.fixture(scope="module")
def ssd(tmp_path_factory):
    path = tmp_path_factory.mktemp("w") / "ssd.tflite"
    meta = C.write_ssd_mobilenet_v2_tflite(str(path), size=96, width=0.25)
    return str(path), meta


@pytest.fixture(scope="module")
def cls(tmp_path_factory):
    path = tmp_path_factory.mktemp("w") / "cls.tflite"
    C.write_mobilenet_v2_quant_tflite(str(path), size=96, width=0.35)
    return str(path)


def test_custom_options_bytes_equal_the_stock_builder():
    from flatbuffers import flexbuffers

    fbb = flexbuffers.Builder()
    with fbb.Map():
        for k, v in C.SSD_POSTPROCESS.items():
            if isinstance(v, bool):
                fbb.Bool(k, v)
            elif isinstance(v, float):
                fbb.Float(k, v)
            else:
                fbb.Int(k, v)
    assert C.tflite_flexbuffer_map(C.SSD_POSTPROCESS) == bytes(fbb.Finish())


@pytest.mark.parametrize("which", ["ssd", "cls"])
def test_both_parsers_read_the_same_model(which, ssd, cls):
    path = ssd[0] if which == "ssd" else cls
    got, want = parse_tflite(path), jparse(path)
    assert [(o.op, o.inputs, o.outputs, o.options) for o in got.operators] \
        == [(o.op, o.inputs, o.outputs, o.options) for o in want.operators]
    for a, b in zip(got.tensors, want.tensors):
        assert (a.name, a.shape, a.np_dtype, a.buffer_index) == \
            (b.name, b.shape, b.np_dtype, b.buffer_index)
        assert (a.quant is None) == (b.quant is None)
        if a.quant is not None:
            assert a.quant.scale.tobytes() == b.quant.scale.tobytes()
            assert a.quant.zero_point.tobytes() == b.quant.zero_point.tobytes()


def test_ssd_layout(ssd):
    path, meta = ssd
    m = parse_tflite(path)
    assert meta["anchors"] == 6 * 6 * 3 + (9 + 4 + 1 + 1 + 1) * 6 == 204
    assert meta["grids"] == [6, 3, 2, 1, 1, 1]
    assert sorted({o.op for o in m.operators}) == [
        "ADD", "CONCATENATION", "CONV_2D", "CUSTOM:TFLite_Detection_PostProcess",
        "DEPTHWISE_CONV_2D", "LOGISTIC", "RESHAPE"]
    post = m.operators[-1].options
    assert {k: post[k] for k in C.SSD_POSTPROCESS} == C.SSD_POSTPROCESS
    assert m.tensors[m.inputs[0]].shape == (1, 96, 96, 3)
    assert [m.tensors[i].shape for i in m.outputs] == [
        (1, 10, 4), (1, 10), (1, 10), (1,)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ssd_through_both_loaders_and_the_interpreter(ssd, tmp_path, seed):
    path, _ = ssd
    x = np.random.default_rng(seed).uniform(-1, 1, (1, 96, 96, 3)) \
        .astype(np.float32)
    boxes, classes, scores, num = P.run_both(path, tmp_path, x)
    r_boxes, r_classes, r_scores, r_num = _interp(path, x)
    assert int(num[0]) == int(r_num[0]) == 10
    np.testing.assert_array_equal(classes, r_classes)
    np.testing.assert_allclose(scores, r_scores, rtol=0, atol=1e-5)
    np.testing.assert_allclose(boxes, r_boxes, rtol=0, atol=1e-5)
    assert len(set(classes.reshape(-1).tolist())) > 1  # the heads are centred


def test_classifier_layout(cls):
    m = parse_tflite(cls)
    x, y = m.tensors[m.inputs[0]], m.tensors[m.outputs[0]]
    assert (x.shape, x.np_dtype, y.shape, y.np_dtype) == \
        ((1, 96, 96, 3), np.uint8, (1, 1001), np.uint8)
    assert (float(x.quant.scale), int(x.quant.zero_point)) == (1 / 128, 128)
    assert (float(y.quant.scale), int(y.quant.zero_point)) == (1 / 256, 0)
    assert {o.op for o in m.operators} == {
        "ADD", "AVERAGE_POOL_2D", "CONV_2D", "DEPTHWISE_CONV_2D", "RESHAPE",
        "SOFTMAX"}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_classifier_through_both_loaders_and_the_interpreter(cls, tmp_path,
                                                             seed):
    x = np.random.default_rng(seed).integers(0, 256, (1, 96, 96, 3),
                                             dtype=np.uint8)
    (ours,) = P.run_both(cls, tmp_path, x)
    (ref,) = _interp(cls, x)
    diff = np.abs(ours.astype(np.int32) - ref.astype(np.int32))
    assert int(diff.max()) <= 4
    assert int(ours.argmax()) == int(ref.argmax())


def test_w8_on_tflite_imported_bundle(cls):
    """``test_quantize.py::test_w8_on_tflite_imported_bundle`` on the
    writer's classifier: ``custom="quant=w8"`` on a tflite bundle
    quantizes its float32 constants (rank >= 2) as JAX's does, codes and
    scales bit-equal; the dequantized weights stay float32; the w8 outputs
    equal JAX's w8 outputs within the parity tolerance, top-1 the
    unquantized model's."""
    import torch

    from nnstreamer_tpu.core.buffer import TensorMemory as JMem
    from nnstreamer_tpu.filters.base import FilterProps as JProps
    from nnstreamer_tpu.filters.xla import XLAFilter
    from nnstreamer_tpu_torch.core.buffer import TensorMemory
    from nnstreamer_tpu_torch.filters.base import FilterProps
    from nnstreamer_tpu_torch.filters.torch_cuda import TorchCudaFilter

    x = np.random.default_rng(9).integers(0, 256, (1, 96, 96, 3), dtype=np.uint8)
    outs = {}
    for custom in ("", "quant=w8"):
        f = TorchCudaFilter()
        f.open(FilterProps(model=cls, custom=custom, device="cpu"))
        jf = XLAFilter()
        jf.open(JProps(model=cls, custom=custom))
        got = f.invoke([TensorMemory(x)])[0].host()
        want = jf.invoke([JMem(x)])[0].host()
        P.assert_outputs_match([got], [want])
        outs[custom] = got
        if custom:
            for key, leaf in f._bundle.params.items():
                jleaf = jf._bundle.params[key]
                assert isinstance(leaf, dict) == isinstance(jleaf, dict), key
                if isinstance(leaf, dict):
                    assert leaf["__w8__"].dtype == torch.int8
                    assert leaf["__w8__"].numpy().tobytes() == \
                        np.asarray(jleaf["__w8__"]).tobytes()
                    assert leaf["scale"].numpy().tobytes() == \
                        np.asarray(jleaf["scale"]).tobytes()
                    assert leaf["orig"].dtype == torch.float32
        f.close()
        jf.close()
    assert int(outs[""].argmax()) == int(outs["quant=w8"].argmax())
