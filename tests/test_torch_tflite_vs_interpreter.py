"""The port's TFLite importer against tf.lite.Interpreter and the JAX one.

Every case of ``tests/test_tflite_vs_interpreter.py`` runs here with that
module's ``_ours_run`` pointed at ``torch_tflite_parity.run_both``: the
same bytes (single-op fixtures, the detection post-process on its fast and
regular paths and without a background column, a quantized conv, a
full-integer int8 model from the real converter, IF and WHILE models,
batched GATHER, STRIDED_SLICE with new axes and an ellipsis) go through
the JAX importer under ``jax.jit`` and the port's on the CPU, params
bit-equal and outputs within ``torch_tflite_parity``'s tolerances (float32
rtol 1e-5 / atol 1e-6; integer outputs, the post-process's count and
classes among them, equal; 8-bit codes at most one step apart on at most 2%
of them, top-1 equal); the JAX case's own comparison then holds the port's
outputs against the interpreter. Its ``needs_ref`` cases keep the mark.

``test_detection_postprocess_feeds_ssd_decoder`` runs a JAX pipeline, so
its counterpart is written out: the port's pipeline gives the JAX
pipeline's detections, also behind ``custom="quant=w8"``.
"""

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

import test_tflite_vs_interpreter as J  # noqa: E402 — the JAX cases
import torch_tflite_parity as P  # noqa: E402
from nnstreamer_tpu_torch.filters import find_filter  # noqa: E402
from nnstreamer_tpu_torch.models.tflite_import import load_tflite  # noqa: E402

_WRITTEN_OUT = ("test_detection_postprocess_feeds_ssd_decoder",)


@pytest.mark.parametrize("case,kwargs", P.jax_cases(J, skip=_WRITTEN_OUT))
def test_jax_interpreter_case_on_the_port(case, kwargs, tmp_path,
                                          monkeypatch):
    monkeypatch.setattr(J, "_ours_run", P.run_both)
    monkeypatch.setattr(J, "load_tflite", P.port_load)
    P.call_case(J, case, kwargs, tmp_path)


def _ssd_pipeline(package, model, labels, locs, scores, custom=""):
    if package == "jax":
        from nnstreamer_tpu.core.types import Caps, TensorsConfig, TensorsInfo
        from nnstreamer_tpu.graph import Pipeline
        p = Pipeline()
    else:
        from nnstreamer_tpu_torch.core.types import (Caps, TensorsConfig,
                                                     TensorsInfo)
        from nnstreamer_tpu_torch.graph import Pipeline
        p = Pipeline(device="cpu")
    info = TensorsInfo.from_strings("4:32:1,4:32:1", "float32")
    src = p.add_new("appsrc", caps=Caps.tensors(TensorsConfig(info, 0)),
                    data=[(locs, scores)])
    filt = p.add_new("tensor_filter", framework="tensorflow2-lite",
                     model=str(model), custom=custom)
    dec = p.add_new("tensor_decoder", mode="bounding_box",
                    option1="mobilenet-ssd-postprocess",
                    option2=str(labels), option4="160:120", option5="320:320")
    sink = p.add_new("tensor_sink", store=True)
    Pipeline.link(src, filt, dec, sink)
    p.run(timeout=120)
    assert sink.num_buffers == 1
    b = sink.buffers[0]
    return b.memories[0].host(), b.meta["detections"], filt


@pytest.mark.parametrize("custom", ["", "quant=w8"])
def test_detection_postprocess_feeds_ssd_decoder(tmp_path, custom):
    """The imported post-process model serves through the port's pipeline
    (``framework=tensorflow2-lite``) into ``mode=bounding_box
    option1=mobilenet-ssd-postprocess``: the JAX pipeline's detections
    and canvas; without quantization, the interpreter's scores."""
    blob, (locs, scores) = J._build_detection_postprocess(
        np.random.default_rng(5))
    model = tmp_path / "ssd_pp.tflite"
    model.write_bytes(blob)
    labels = tmp_path / "labels.txt"
    labels.write_text("a\nb\nc\n")
    canvas, dets, filt = _ssd_pipeline("port", model, labels, locs, scores,
                                       custom)
    want_canvas, want, _ = _ssd_pipeline("jax", model, labels, locs, scores,
                                         custom)
    assert find_filter(filt.resolved_framework).NAME == "torch-cuda"
    assert canvas.shape == (120, 160, 4)
    np.testing.assert_array_equal(canvas, want_canvas)
    assert len(dets) == len(want) > 0
    for d, w in zip(dets, want):
        assert d.keys() == w.keys()
        for k in ("score", "box"):
            assert d[k] == pytest.approx(w[k], rel=P.FLOAT_RTOL,
                                         abs=P.FLOAT_ATOL)
        assert {k: v for k, v in d.items() if k not in ("score", "box")} \
            == {k: v for k, v in w.items() if k not in ("score", "box")}
    if not custom:
        (_, _, ref_scr, ref_num) = J._interp_run(blob, locs, scores)
        got = sorted(round(d["score"], 5) for d in dets)
        assert got == sorted(round(float(s), 5)
                             for s in ref_scr[0, :int(ref_num[0])])


def test_control_flow_models_load_eager_only(tmp_path):
    """A model holding IF or WHILE reads its predicate on the host, so it
    loads with ``metadata["jit"] = False`` (the filter runs it eagerly,
    never captured); a model without keeps the default."""

    def f(x):
        return tf.cond(tf.reduce_sum(x) > 0, lambda: x * 2.0, lambda: x - 1.0)

    path = P.write(J._convert_fn(f, [tf.TensorSpec([4], tf.float32)]),
                   tmp_path)
    b = load_tflite(path, device="cpu")
    assert "IF" in b.metadata["tflite_ops"] and b.metadata["jit"] is False
    blob, _ = J._fixture_softmax(np.random.default_rng(0))
    assert "jit" not in load_tflite(P.write(blob, tmp_path, "s.tflite"),
                                    device="cpu").metadata


def test_while_body_changing_its_carry_raises(tmp_path):
    """A WHILE body whose carry changes shape raises NotImplementedError in
    both packages (JAX at trace; the port before it loops on)."""

    def g(x):
        def cond(i, x):
            return i < 2

        def body(i, x):
            return i + 1, tf.concat([x, x], 0)

        _, out = tf.while_loop(
            cond, body, [tf.constant(0), x],
            shape_invariants=[tf.TensorShape([]), tf.TensorShape([None])])
        return out

    try:
        blob = J._convert_fn(g, [tf.TensorSpec([2], tf.float32)])
    except Exception as e:  # noqa: BLE001 — a converter that refuses it
        pytest.skip(f"converter refuses a shape-changing loop: {e}")
    path = P.write(blob, tmp_path)
    x = np.array([1.0, 2.0], np.float32)
    with pytest.raises(NotImplementedError, match="WHILE"):
        P.run_port(load_tflite(path, device="cpu"), x)
