"""framework=tensorflow on the port: the cases of ``tests/test_tf_backend.py``.

The JAX file's cases need the reference's ``mnist.pb`` and
``conv_actions_frozen.pb``, which are not in the repository, so each runs
here on a frozen GraphDef the test builds with the same interface
(``input`` float32 784 → ``softmax`` 10; a DT_STRING ``wav_data`` fed the
raw int16 buffer → ``labels_softmax`` 12), through the reference's strings
in the JAX package and in the port (``Pipeline(device="cpu")``): the bytes
written by ``filesink`` equal (both packages run the same TensorFlow
session on the host), and every error the JAX filter raises (names
required, an operation missing, a dtype, an element count, a file that is
not a GraphDef) raised by the port with the same message. The DT_STRING
string's scores are byte-equal; the mnist string's within rtol 1e-5 /
atol 1e-6, since its ``tensor_transform`` divides by 127.5 where XLA's jit
multiplies by the reciprocal (ROADMAP §C). With the
reference's files mounted, the JAX cases' own strings run on the port too
(``needs_ref``).
"""

import os
import re

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

import test_tf_backend as J  # noqa: E402 — the JAX cases' strings
from nnstreamer_tpu.graph.parse import parse_pipeline as jparse  # noqa: E402
from nnstreamer_tpu_torch.graph import Pipeline  # noqa: E402
from nnstreamer_tpu_torch.graph.parse import parse_pipeline  # noqa: E402

MNIST, SPEECH, needs_ref = J.MNIST, J.SPEECH, J.needs_ref


def _port(desc: str):
    return parse_pipeline(desc, Pipeline(device="cpu"))


def _freeze(graph, path):
    path.write_bytes(graph.as_graph_def().SerializeToString())
    return str(path)


@pytest.fixture
def mnist(tmp_path):
    """(model, data): a frozen 784 → 10 softmax graph and one digit."""
    rng = np.random.default_rng(3)
    g = tf.Graph()
    with g.as_default():
        x = tf.compat.v1.placeholder(tf.float32, [None, 784], name="input")
        w = tf.constant(rng.standard_normal((784, 10)).astype(np.float32)
                        * 0.05)
        b = tf.constant(rng.standard_normal(10).astype(np.float32))
        tf.nn.softmax(tf.matmul(x, w) + b, name="softmax")
    data = tmp_path / "9.raw"
    data.write_bytes(rng.integers(0, 256, 784, dtype=np.uint8).tobytes())
    return _freeze(g, tmp_path / "mnist.pb"), str(data)


@pytest.fixture
def speech(tmp_path):
    """(model, data): a DT_STRING ``wav_data`` input decoded as int16 into
    12 ``labels_softmax`` scores, and 16022 samples."""
    rng = np.random.default_rng(4)
    g = tf.Graph()
    with g.as_default():
        wav = tf.compat.v1.placeholder(tf.string, [], name="wav_data")
        pcm = tf.cast(tf.io.decode_raw(wav, tf.int16), tf.float32) / 32768.0
        feats = tf.reduce_mean(tf.abs(tf.reshape(pcm[:16020], [12, 1335])),
                               axis=1)
        w = tf.constant(rng.standard_normal((12, 12)).astype(np.float32))
        tf.nn.softmax(tf.matmul(feats[None], w) * 8.0, name="labels_softmax")
    data = tmp_path / "yes.wav"
    data.write_bytes(rng.integers(-3000, 3000, 16022, dtype=np.int16)
                     .tobytes())
    return _freeze(g, tmp_path / "speech.pb"), str(data)


def _close(port: bytes, want: bytes) -> np.ndarray:
    got = np.frombuffer(port, np.float32)
    np.testing.assert_allclose(got, np.frombuffer(want, np.float32),
                               rtol=1e-5, atol=1e-6)
    return got


def _both(template: str, tmp_path, **fmt):
    """Run ``template`` in each package; the bytes each filesink wrote."""
    outs = {}
    for name, parse in (("jax", jparse), ("port", _port)):
        out = tmp_path / f"{name}.out.log"
        parse(template.format(out=out, **fmt)).run(timeout=120)
        outs[name] = out.read_bytes()
    return outs["port"], outs["jax"]


def _tf_message(err: BaseException) -> str:
    """The filter's own message inside whatever the pipeline wrapped it
    in."""
    seen = err
    while seen is not None:
        m = re.search(r"tensorflow: .*", str(seen))
        if m:
            return m.group(0)
        seen = seen.__cause__ or seen.__context__
    return str(err)


def _same_error(template: str, tmp_path, **fmt) -> str:
    errs = {}
    for name, parse in (("jax", jparse), ("port", _port)):
        with pytest.raises(Exception) as info:
            parse(template.format(out=tmp_path / f"{name}.log", **fmt)) \
                .run(timeout=60)
        errs[name] = _tf_message(info.value)
    assert errs["port"] == errs["jax"]
    return errs["port"]


def test_reference_mnist_pb_golden(tmp_path, mnist):
    model, data = mnist
    port, want = _both(MNIST, tmp_path, data=data, model=model)
    scores = _close(port, want)
    assert scores.size == 10 and abs(float(scores.sum()) - 1.0) < 1e-5


def test_reference_speech_pb_string_input_golden(tmp_path, speech):
    """A DT_STRING input is fed the raw int16 buffer as one scalar
    string."""
    model, data = speech
    port, want = _both(SPEECH, tmp_path, data=data, model=model)
    assert port == want and np.frombuffer(port, np.float32).size == 12


def test_reference_combination_string(tmp_path, mnist):
    """runTest.sh:83's string: input-combination picks the mnist tensor
    out of the mux, output-combination re-emits the video tensor beside
    the result; demux splits them back."""
    model, data = mnist
    outs = {}
    for name, parse in (("jax", jparse), ("port", _port)):
        d = tmp_path / name
        d.mkdir()
        golden, combi_in, out = (d / "golden", d / "combi.in", d / "out")
        s = (
            "videotestsrc pattern=13 num-buffers=1 ! videoconvert ! "
            "video/x-raw,width=640,height=480,framerate=30/1 ! "
            "tensor_converter ! tee name=t "
            f"t. ! queue ! filesink location={golden} buffer-mode=unbuffered sync=false async=false "
            "t. ! queue ! mux.sink_0 "
            f"filesrc location={data} ! application/octet-stream ! "
            "tensor_converter input-dim=784:1 input-type=uint8 ! "
            "tensor_transform mode=arithmetic option=typecast:float32,add:-127.5,div:127.5 ! "
            "mux.sink_1 tensor_mux name=mux ! "
            f"tensor_filter framework=tensorflow model={model} "
            "input=784:1 inputtype=float32 inputname=input "
            "output=10:1 outputtype=float32 outputname=softmax "
            "input-combination=1 output-combination=i0,o0 ! "
            "tensor_demux name=demux "
            f"demux.src_0 ! queue ! filesink location={combi_in} buffer-mode=unbuffered sync=false async=false "
            f"demux.src_1 ! queue ! filesink location={out} buffer-mode=unbuffered sync=false async=false")
        parse(s).run(timeout=120)
        assert golden.read_bytes() == combi_in.read_bytes()
        assert len(golden.read_bytes()) == 640 * 480 * 3
        outs[name] = out.read_bytes()
    assert _close(outs["port"], outs["jax"]).size == 10


def test_pb_extension_auto_detect(tmp_path, mnist):
    """framework=auto resolves .pb → tensorflow via the priority table."""
    model, data = mnist
    s = MNIST.replace("framework=tensorflow ", "")
    port, want = _both(s, tmp_path, data=data, model=model)
    assert _close(port, want).size == 10


def test_missing_names_clear_error(tmp_path, mnist):
    model, data = mnist
    msg = _same_error(MNIST.replace("inputname=input ", ""), tmp_path,
                      data=data, model=model)
    assert "name" in msg


def test_wrong_op_name_clear_error(tmp_path, mnist):
    model, data = mnist
    msg = _same_error(MNIST.replace("inputname=input ", "inputname=nonesuch "),
                      tmp_path, data=data, model=model)
    assert "nonesuch" in msg


def test_wrong_dtype_clear_error(tmp_path, mnist):
    model, data = mnist
    msg = _same_error(MNIST.replace("inputtype=float32", "inputtype=int32")
                      .replace("typecast:float32", "typecast:int32"),
                      tmp_path, data=data, model=model)
    assert re.search("int32|float32", msg)


def test_wrong_output_dims_clear_error(tmp_path, mnist):
    """runTest 3F_n analog: output=5:1 against a 10-element graph output."""
    model, data = mnist
    msg = _same_error(MNIST.replace("output=10:1 ", "output=5:1 "), tmp_path,
                      data=data, model=model)
    assert "output" in msg


def test_not_a_graphdef_clear_error(tmp_path, mnist):
    _, data = mnist
    bad = tmp_path / "model.pb"
    bad.write_bytes(b"\xff\xfe not a protobuf")
    msg = _same_error(MNIST, tmp_path, data=data, model=bad)
    assert "GraphDef" in msg


def test_outputs_on_the_filter_device_and_tensorflow_off_the_card(mnist):
    """The session runs on the host; under ``device=cpu`` each output is
    the host array itself. TensorFlow sees no GPU once the filter opened
    (a CUDA build would otherwise map the card's memory)."""
    from nnstreamer_tpu_torch.core.buffer import TensorMemory
    from nnstreamer_tpu_torch.core.types import TensorsInfo
    from nnstreamer_tpu_torch.filters.base import FilterProps
    from nnstreamer_tpu_torch.filters.tf_backend import TensorFlowFilter

    model, _ = mnist
    f = TensorFlowFilter()
    f.open(FilterProps(
        model=model, device="cpu",
        input_info=TensorsInfo.from_strings("784:1", "float32", "input"),
        output_info=TensorsInfo.from_strings("10:1", "float32", "softmax")))
    try:
        (out,) = f.invoke([TensorMemory(np.zeros((1, 784), np.float32))])
        assert not out.is_device and out.host().shape == (1, 10)
        assert tf.config.get_visible_devices("GPU") == []
    finally:
        f.close()


@needs_ref
@pytest.mark.parametrize("string,data,model,size,label", [
    (MNIST, "9.raw", "mnist.pb", 10, 9),
    (SPEECH, "yes.wav", "conv_actions_frozen.pb", 12, 2)])
def test_reference_models_on_the_port(tmp_path, string, data, model, size,
                                      label):
    out = tmp_path / "o.log"
    _port(string.format(data=os.path.join(J.DATA, data),
                        model=os.path.join(J.MODELS, model), out=out)) \
        .run(timeout=120)
    scores = np.frombuffer(out.read_bytes(), np.float32)
    assert scores.size == size and int(scores.argmax()) == label
