"""The port's TFLite import and TensorFlow filter on the card (marked
``cuda``; they skip without one). This file imports no JAX: the models come
from ``chip_smoke.py``'s writer, which needs no ``flatbuffers`` package.

* The detection post-process model (the writer's ssd_mobilenet_v2 at 96×96,
  width 0.25, 204 anchors) served by the filter through a CUDA graph:
  replays bit-equal to the eager call, ``class_reduce`` once and
  ``nms_sweep`` once an invoke, counted on replay; its count and classes
  equal to the same file on the CPU, boxes and scores within rtol 1e-4 /
  atol 1e-5.
* The uint8 classifier (96×96, width 0.35): codes on the card equal the
  CPU's (its snapped ops compute in float64).
* A SHAPE output made in the eager call and replayed by the capture.
* ``framework=tensorflow`` (when TensorFlow is installed): outputs on the
  card, TensorFlow given no GPU.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nnstreamer_tpu_torch.core.buffer import TensorMemory  # noqa: E402
from nnstreamer_tpu_torch.filters.base import FilterProps  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as C  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _filter(path, device):
    from nnstreamer_tpu_torch.filters.torch_cuda import TorchCudaFilter

    f = TorchCudaFilter()
    f.open(FilterProps(model=str(path), device=device))
    return f


def test_detection_postprocess_in_a_graph_on_the_card(tmp_path, card):
    from nnstreamer_tpu_torch.core import graphs
    from nnstreamer_tpu_torch.ops.kernels import epilogue as ep

    path = tmp_path / "ssd.tflite"
    C.write_ssd_mobilenet_v2_tflite(str(path), size=96, width=0.25)
    f, cpu = _filter(path, card), _filter(path, "cpu")
    xs = [np.random.default_rng(s).uniform(-1, 1, (1, 96, 96, 3)).astype(np.float32)
          for s in range(3)]
    graphs.reset_stats()
    ep.class_reduce.launches = ep.nms_sweep.launches = 0
    outs = [[m.device() for m in f.invoke([TensorMemory(x)])] for x in xs]
    assert (ep.class_reduce.launches, ep.nms_sweep.launches) == (3, 3)
    st = graphs.stats()
    assert st["captures"] == 1 and st["replays"] == 2
    with graphs.disabled():
        eager = [[m.device() for m in f.invoke([TensorMemory(x)])] for x in xs]
    for got, want, x in zip(outs, eager, xs):
        for g, w in zip(got, want):
            assert g.device == card and torch.equal(g, w)
        ref = [m.device() for m in cpu.invoke([TensorMemory(x)])]
        assert torch.equal(got[3].cpu(), ref[3]) and torch.equal(got[1].cpu(), ref[1])
        for i in (0, 2):
            torch.testing.assert_close(got[i].cpu(), ref[i], rtol=1e-4, atol=1e-5)
    f.close()
    cpu.close()


def test_quantized_codes_equal_on_the_card_and_the_cpu(tmp_path, card):
    path = tmp_path / "cls.tflite"
    C.write_mobilenet_v2_quant_tflite(str(path), size=96, width=0.35)
    f, cpu = _filter(path, card), _filter(path, "cpu")
    for seed in range(4):
        x = np.random.default_rng(seed).integers(0, 256, (1, 96, 96, 3), dtype=np.uint8)
        got = f.invoke([TensorMemory(x)])[0].device()
        want = cpu.invoke([TensorMemory(x)])[0].device()
        assert got.dtype == torch.uint8 and torch.equal(got.cpu(), want)
    f.close()
    cpu.close()


def test_shape_output_replays_in_a_graph(tmp_path, card):
    from nnstreamer_tpu_torch.core import graphs

    path = tmp_path / "shape.tflite"
    path.write_bytes(C.tflite_bytes(
        [dict(shape=(2, 3, 4), type=C.TFL_F32), dict(shape=(3,), type=C.TFL_I32),
         dict(shape=(2, 3, 4), type=C.TFL_F32)],
        [dict(code=77, inputs=[0], outputs=[1]),      # SHAPE
         dict(code=18, inputs=[0, 0], outputs=[2])],  # MUL
        [0], [2, 1]))
    f = _filter(path, card)
    graphs.reset_stats()
    for seed in range(3):
        x = np.random.default_rng(seed).standard_normal((2, 3, 4)).astype(np.float32)
        sq, shape = (m.device() for m in f.invoke([TensorMemory(x)]))
        assert shape.device == card and shape.tolist() == [2, 3, 4]
        assert torch.equal(sq.cpu(), torch.from_numpy(x * x))
    assert graphs.stats()["replays"] == 2
    f.close()


def test_tensorflow_outputs_on_the_card(tmp_path, card):
    tf = pytest.importorskip("tensorflow")
    from nnstreamer_tpu_torch.core.types import TensorsInfo
    from nnstreamer_tpu_torch.filters.tf_backend import TensorFlowFilter

    g = tf.Graph()
    with g.as_default():
        x = tf.compat.v1.placeholder(tf.float32, [None, 4], name="input")
        tf.nn.softmax(x * 2.0, name="softmax")
    path = tmp_path / "m.pb"
    path.write_bytes(g.as_graph_def().SerializeToString())
    free = torch.cuda.mem_get_info()[0]
    f = TensorFlowFilter()
    f.open(FilterProps(model=str(path), device=card,
                       input_info=TensorsInfo.from_strings("4:1", "float32", "input"),
                       output_info=TensorsInfo.from_strings("4:1", "float32", "softmax")))
    v = np.arange(4, dtype=np.float32)[None]
    (out,) = f.invoke([TensorMemory(v)])
    got = out.device()
    assert got.device == card
    torch.testing.assert_close(got.cpu(), torch.softmax(torch.from_numpy(v) * 2, -1))
    assert (free - torch.cuda.mem_get_info()[0]) < 256 * 2 ** 20
    assert tf.config.get_visible_devices("GPU") == []
    f.close()
