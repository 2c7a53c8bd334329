"""The port's TFLite lowering, op by op, against the JAX package's.

Every case of ``tests/test_tflite_ops.py`` runs here with that module's
``_run`` pointed at ``torch_tflite_parity.run_both`` (and its
``load_tflite``/``parse_tflite`` at the port's): the same in-memory
single-op flatbuffer goes through the JAX importer under ``jax.jit`` and
the port's on the CPU, params bit-equal, outputs within the tolerances of
``torch_tflite_parity`` (float32 rtol 1e-5 / atol 1e-6; integer outputs
equal; uint8 at most one code apart on at most 2% of the codes, top-1
equal), and the JAX case's own numpy oracle then holds the port's outputs.
"""

import numpy as np
import pytest

import test_tflite_ops as J  # noqa: E402 — the JAX cases and their builder
import torch_tflite_parity as P  # noqa: E402
from nnstreamer_tpu_torch.converters import flexbuf_codec
from nnstreamer_tpu_torch.models import tflite_import as T


def _point_at_port(monkeypatch, module):
    monkeypatch.setattr(module, "_run", P.run_both, raising=False)
    monkeypatch.setattr(module, "load_tflite", P.port_load)
    monkeypatch.setattr(module, "parse_tflite", T.parse_tflite)


@pytest.mark.parametrize("case,kwargs", P.jax_cases(J))
def test_jax_op_case_on_the_port(case, kwargs, tmp_path, monkeypatch):
    _point_at_port(monkeypatch, J)
    P.call_case(J, case, kwargs, tmp_path)


def _shape_blob():
    """A graph output that is the SHAPE of the input, beside the input
    squared."""
    return J.build_tflite(
        tensors=[
            dict(shape=(2, 3, 4), type=J.F32),
            dict(shape=(3,), type=J.INT32),
            dict(shape=(2, 3, 4), type=J.F32),
        ],
        operators=[
            dict(code=77, inputs=[0], outputs=[1]),
            dict(code=18, inputs=[0, 0], outputs=[2]),
        ],
        inputs=[0], outputs=[2, 1])


def test_shape_output_equals_jax(tmp_path):
    """SHAPE comes out as an int32 tensor on the input's device, equal to
    JAX's (made once from the host shape and kept, so a capture replays
    it)."""
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    sq, shape = P.run_both(_shape_blob(), tmp_path, x)
    np.testing.assert_array_equal(sq, x * x)
    np.testing.assert_array_equal(shape, [2, 3, 4])
    assert shape.dtype == np.int32


def _detection_options(**over):
    b = flexbuf_codec.Builder()
    start = b.start()
    values = {"max_detections": 4, "max_classes_per_detection": 1,
              "detections_per_class": 100, "use_regular_nms": False,
              "nms_score_threshold": 0.3, "nms_iou_threshold": 0.5,
              "num_classes": 2, "y_scale": 10.0, "x_scale": 10.0,
              "h_scale": 5.0, "w_scale": 5.0, **over}
    for k, v in values.items():
        b.key(k)
        if isinstance(v, bool):
            b.bool(v)
        elif isinstance(v, float):
            b.float(v)
        else:
            b.sint(v)
    b.end_map(start)
    return bytes(b.finish())


def _detection_blob(custom_options):
    n = 6
    anchors = np.tile(np.array([0.5, 0.5, 0.2, 0.2], np.float32), (n, 1))
    return J.build_tflite(
        tensors=[
            dict(shape=(1, n, 4), type=J.F32),
            dict(shape=(1, n, 3), type=J.F32),
            dict(shape=(n, 4), type=J.F32, data=anchors),
            dict(shape=(1, 4, 4), type=J.F32),
            dict(shape=(1, 4), type=J.F32),
            dict(shape=(1, 4), type=J.F32),
            dict(shape=(1,), type=J.F32),
        ],
        operators=[dict(code=32, custom_code="TFLite_Detection_PostProcess",
                        custom_options=custom_options,
                        inputs=[0, 1, 2], outputs=[3, 4, 5, 6])],
        inputs=[0, 1], outputs=[3, 4, 5, 6])


def test_custom_options_decode_without_the_flatbuffers_package(
        tmp_path, monkeypatch):
    """The detection op's FlexBuffers options are read by the port's own
    codec: with ``flatbuffers`` unimportable the options still decode (the
    card's machine has no such package), equal to JAX's decode."""
    import sys

    blob = _detection_blob(_detection_options(use_regular_nms=True))
    path = P.write(blob, tmp_path)
    want = J.parse_tflite(path).operators[0].options
    monkeypatch.setitem(sys.modules, "flatbuffers", None)
    got = T.parse_tflite(path).operators[0].options
    assert got == want
    assert got["use_regular_nms"] is True and got["num_classes"] == 2
    assert isinstance(got["nms_score_threshold"], float)


def test_malformed_custom_options_name_the_missing_key(tmp_path):
    """A malformed map gives no options in either package; the lowering
    then names the key it misses."""
    path = P.write(_detection_blob(b"\x07\x01\x02"), tmp_path)
    assert T.parse_tflite(path).operators[0].options == \
        J.parse_tflite(path).operators[0].options == {}
    bundle = P.port_load(path)
    x = np.zeros((1, 6, 4), np.float32), np.zeros((1, 6, 3), np.float32)
    with pytest.raises(KeyError, match="num_classes"):
        P.run_port(bundle, *x)
