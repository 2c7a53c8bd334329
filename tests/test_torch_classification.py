"""The torch port's classification path against the JAX package, on the CPU.

``appsrc ! tensor_converter ! tensor_filter model=zoo://mobilenet_v2 !
tensor_decoder mode=image_labeling ! tensor_sink`` shares every element
with the detection slice except its decoder, and runs no hand-written
kernel. The MobileNet-v2 model (weights converted from the JAX bundle) and
the whole pipeline are held against the JAX package on seeded inputs; TF32
is off for the comparisons (no effect on the CPU, stated for a card).
"""

import dataclasses
import functools
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from nnstreamer_tpu.core.types import Caps as JaxCaps  # noqa: E402
from nnstreamer_tpu.graph import Pipeline as JaxPipeline  # noqa: E402
from nnstreamer_tpu.models.zoo import get_model as jax_get_model  # noqa: E402
from nnstreamer_tpu_torch.core.buffer import TensorMemory  # noqa: E402
from nnstreamer_tpu_torch.core.types import Caps, TensorsConfig, TensorsInfo  # noqa: E402
from nnstreamer_tpu_torch.graph import Pipeline  # noqa: E402
from nnstreamer_tpu_torch.models.convert import (from_flax_variables,  # noqa: E402
                                                 flax_shapes)
from nnstreamer_tpu_torch.models.mobilenet_v2 import make_mobilenet_v2  # noqa: E402

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

CPU = torch.device("cpu")
SIZE = 64


@functools.lru_cache(maxsize=None)
def _jax_mobilenet(dtype: str):
    return jax_get_model(f"zoo://mobilenet_v2?width=0.35&size={SIZE}&dtype={dtype}")


def _port_mobilenet(dtype: str, variables):
    pb = make_mobilenet_v2(device=CPU, width="0.35", size=str(SIZE), dtype=dtype)
    from_flax_variables(variables, pb.module)
    return pb


def _numpy_vars(bundle):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                  bundle.params)


def _frames(n: int):
    rng = np.random.default_rng(4)
    return [rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
            for _ in range(n)]


@pytest.mark.parametrize("dtype,rtol,atol_of_scale", [
    # float32: the two frameworks' convolutions sum in other orders
    ("float32", 1e-4, 1e-4),
    # bfloat16: one ulp is 2^-8 ≈ 3.9e-3 relative, and XLA and torch round
    # convolution, BatchNorm and Dense results at different places
    ("bfloat16", 1e-2, 1e-2),
])
def test_mobilenet_matches_jax(dtype, rtol, atol_of_scale):
    jb = _jax_mobilenet(dtype)
    pb = _port_mobilenet(dtype, _numpy_vars(jb))
    x = np.stack(_frames(2))
    want = np.asarray(jb.fn()(x))
    with torch.inference_mode():
        got = pb.fn()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 1001) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_of_scale * np.abs(want).max())


def test_flax_shapes_match_the_jax_tree():
    jb = _jax_mobilenet("float32")
    pb = make_mobilenet_v2(device=CPU, width="0.35", size=str(SIZE),
                           dtype="float32")
    want = jax.tree_util.tree_map(lambda a: tuple(a.shape), jb.params)
    assert flax_shapes(pb.module) == want


def _label_run(pipeline_cls, caps, model, labels, frames, **pkw):
    p = pipeline_cls(**pkw)
    src = p.add_new("appsrc", caps=caps, data=list(frames))
    conv = p.add_new("tensor_converter")
    filt = p.add_new("tensor_filter", framework="xla-tpu", model=model)
    dec = p.add_new("tensor_decoder", mode="image_labeling",
                    option1=str(labels))
    sink = p.add_new("tensor_sink", store=True)
    pipeline_cls.link(src, conv, filt, dec, sink)
    p.run(timeout=300)
    assert sink.num_buffers == len(frames)
    return [(b.meta["label_index"], b.meta["label_score"]) for b in sink.buffers]


def test_labeling_pipeline_matches_jax(tmp_path):
    labels = tmp_path / "labels.txt"
    labels.write_text("\n".join(f"l{i}" for i in range(1001)))
    jb = _jax_mobilenet("float32")
    variables = _numpy_vars(jb)
    pb = _port_mobilenet("float32", variables)
    frames = _frames(3)
    fields = {"format": "RGB", "width": SIZE, "height": SIZE,
              "framerate": Fraction(30)}
    want = _label_run(JaxPipeline, JaxCaps("video/x-raw", fields),
                      dataclasses.replace(jb, metadata={}), labels, frames)
    got = _label_run(Pipeline, Caps("video/x-raw", fields), pb, labels,
                     frames, device="cpu")
    # precondition of the exact label comparison: each frame's top logit
    # leads the runner-up by far more than the packages' difference (~1e-8)
    logits = np.asarray(jb.fn()(np.stack(frames)))
    top2 = np.sort(logits, axis=1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0] > 1e-6).all()
    assert [i for i, _ in got] == [i for i, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=1e-4)


def test_filter_nchw_layout_matches_jax():
    x = np.random.default_rng(6).normal(size=(1, 3, 4, 5)).astype(np.float32)
    dims, types = "5:4:3:1", "float32"

    def run(pipeline_cls, caps, **pkw):
        p = pipeline_cls(**pkw)
        src = p.add_new("appsrc", caps=caps, data=[x])
        filt = p.add_new("tensor_filter", framework="xla-tpu",
                         model=lambda t: t[..., :2] * 2 + 1,
                         inputlayout="NCHW", outputlayout="NCHW")
        sink = p.add_new("tensor_sink", store=True)
        pipeline_cls.link(src, filt, sink)
        p.run(timeout=60)
        return sink.buffers[0].memories[0].host()

    from nnstreamer_tpu.core.types import TensorsConfig as JaxConfig
    from nnstreamer_tpu.core.types import TensorsInfo as JaxInfo

    want = run(JaxPipeline, JaxCaps.tensors(JaxConfig(JaxInfo.from_strings(dims, types))))
    got = run(Pipeline, Caps.tensors(TensorsConfig(TensorsInfo.from_strings(dims, types))),
              device="cpu")
    assert got.shape == want.shape == (1, 2, 4, 5)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("auto_fuse", [True, False], ids=["fused", "unfused"])
def test_filter_converter_tail_fuses(auto_fuse):
    # filter ! tensor_converter: the static tensors→tensors converter is an
    # identity the epilogue pass enrolls as a passthrough
    x = np.random.default_rng(7).normal(size=(1, 4)).astype(np.float32)
    p = Pipeline(device="cpu")
    p.auto_fuse = auto_fuse
    src = p.add_new("appsrc", caps=Caps.tensors(TensorsConfig(
        TensorsInfo.from_strings("4:1", "float32"))), data=[x])
    filt = p.add_new("tensor_filter", model=lambda t: t * 2 + 1)
    conv = p.add_new("tensor_converter")
    sink = p.add_new("tensor_sink", store=True)
    Pipeline.link(src, filt, conv, sink)
    p.run(timeout=60)
    assert p._epilogue_count == int(auto_fuse)
    np.testing.assert_array_equal(sink.buffers[0].memories[0].host(), x * 2 + 1)


def test_filter_bf16_precision_matches_jax():
    x = np.random.default_rng(8).normal(size=(2, 5)).astype(np.float32)
    dims, types = "5:2", "float32"

    def run(pipeline_cls, caps, **pkw):
        p = pipeline_cls(**pkw)
        src = p.add_new("appsrc", caps=caps, data=[x])
        filt = p.add_new("tensor_filter", framework="xla-tpu",
                         model=lambda t: t * 3, custom="precision=bf16")
        sink = p.add_new("tensor_sink", store=True)
        pipeline_cls.link(src, filt, sink)
        p.run(timeout=60)
        return sink.buffers[0].memories[0]

    from nnstreamer_tpu.core.types import TensorsConfig as JaxConfig
    from nnstreamer_tpu.core.types import TensorsInfo as JaxInfo

    want = run(JaxPipeline, JaxCaps.tensors(JaxConfig(JaxInfo.from_strings(dims, types))))
    got = run(Pipeline, Caps.tensors(TensorsConfig(TensorsInfo.from_strings(dims, types))),
              device="cpu")
    assert str(got.info.dtype) == str(want.info.dtype) == "bfloat16"
    np.testing.assert_array_equal(got.host().astype(np.float32),
                                  np.asarray(want.host()).astype(np.float32))


def test_tensor_memory_round_trips():
    host = np.arange(12, dtype=np.float32).reshape(3, 4)
    m = TensorMemory(host)
    t = m.device(CPU)
    assert m.is_device and torch.equal(t, torch.from_numpy(host))
    bf = TensorMemory(torch.arange(6, dtype=torch.bfloat16).reshape(2, 3))
    assert str(bf.info.dtype) == "bfloat16" and bf.shape == (2, 3)
    np.testing.assert_array_equal(bf.host().astype(np.float32),
                                  np.arange(6, dtype=np.float32).reshape(2, 3))
    assert bf.is_ready() and not bf.prefetched
    bf.prefetch()  # a CPU tensor needs no copy: nothing is issued
    assert not bf.prefetched
