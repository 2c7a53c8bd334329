"""The port's wire codecs and converter/decoder modes against the JAX package.

``nnstreamer_tpu_torch/converters`` carries its own FlexBuffers,
FlatBuffers and proto3 codecs (``flexbuf_codec``, ``flatbuf_codec``,
``proto_codec``); ``fb_io`` and ``protobuf_io`` build the tensor frames on
them. Every case makes a frame from seeded numpy arrays and holds:

  * the port's blob byte-identical to the JAX package's (which uses the
    stock ``flatbuffers`` and ``google.protobuf`` runtimes) for FlexBuffers,
    FlatBuffers and protobuf;
  * each JAX blob parsed by the port equal to the JAX package's own parse:
    arrays (shape, dtype, bytes), names, rate, timestamps;
  * the port's blob read back by the stock runtimes;
  * the JAX errors (message for message) for more than 16 tensors, rank
    above 4, a payload of the wrong length, bf16/f16 and an unknown type
    enum.

The frames cover all ten reference dtypes, ranks 1-4, 1-16 tensors (so
``tensor_10`` sorts before ``tensor_2``), empty and set names, rates 0/1,
30/1 and 30000/1001, static and flexible format, payloads on either side
of FlexBuffers' width steps (255/256 and 65535/65536 bytes), a 300x300x3
frame, and timestamps of None, 0 (which comes back as None, as in the JAX
package), 2**62 and -5. Pipelines through ``tensor_decoder mode=<fmt> !
tensor_converter``, ``mode=flex`` and ``mode=custom-script`` are compared
sink for sink with the JAX package's.
"""

from fractions import Fraction

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("flatbuffers")
pytest.importorskip("google.protobuf")

from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import nnstreamer_tpu.converters.fb_io as jfb  # noqa: E402
import nnstreamer_tpu.converters.protobuf_io as jpb  # noqa: E402
import nnstreamer_tpu.core as jcore  # noqa: E402
import nnstreamer_tpu.graph as jgraph  # noqa: E402
import nnstreamer_tpu_torch.converters.fb_io as tfb  # noqa: E402
import nnstreamer_tpu_torch.converters.protobuf_io as tpb  # noqa: E402
import nnstreamer_tpu_torch.core as tcore  # noqa: E402
import nnstreamer_tpu_torch.graph as tgraph  # noqa: E402
from nnstreamer_tpu_torch.converters import (  # noqa: E402
    flatbuf_codec,
    flexbuf_codec,
    proto_codec,
)

TIMEOUT = 60

DTYPES = ["int32", "uint32", "int16", "uint16", "int8", "uint8", "float64",
          "float32", "int64", "uint64"]


def _array(rng, shape, dtype):
    dt = np.dtype(dtype)
    if dt.kind == "f":
        return rng.standard_normal(shape).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, shape, dtype=dt, endpoint=True)


def _case(seed, shapes, dtypes=None, names=None, rate=Fraction(0, 1),
          flexible=False, pts=None):
    rng = np.random.default_rng(seed)
    dtypes = dtypes or ["uint8"] * len(shapes)
    names = names or [None] * len(shapes)
    arrays = [_array(rng, s, d) for s, d in zip(shapes, dtypes)]
    return dict(arrays=arrays, names=names, rate=rate, flexible=flexible, pts=pts)


CASES = {
    **{f"dtype-{d}": _case(i, [(3, 5)], [d]) for i, d in enumerate(DTYPES)},
    **{f"rank-{r}": _case(20 + r, [tuple(range(2, 2 + r))], ["float32"])
       for r in range(1, 5)},
    **{f"tensors-{n}": _case(30 + n, [(n + 1,)] * n, DTYPES[:1] * n)
       for n in (1, 2, 11, 12, 16)},
    "mixed-dtypes-16": _case(50, [(2, k + 1) for k in range(16)],
                             [DTYPES[k % 10] for k in range(16)]),
    "names": _case(51, [(4,), (2, 2)], ["int16", "float32"], ["", "scores"]),
    "names-utf8": _case(52, [(3,)], ["uint8"], ["logits_é"]),
    "rate-30": _case(53, [(8,)], rate=Fraction(30, 1)),
    "rate-ntsc": _case(54, [(8,)], rate=Fraction(30000, 1001)),
    "flexible": _case(55, [(4, 3)], ["float32"], flexible=True,
                      rate=Fraction(30, 1)),
    **{f"payload-{n}": _case(60 + i, [(n,)]) for i, n in
       enumerate((255, 256, 65535, 65536))},
    "payload-16bit-f32": _case(64, [(16384,)], ["float32"]),
    "ssd-300": _case(65, [(300, 300, 3)], rate=Fraction(30, 1)),
    "ssd-outputs": _case(66, [(1, 1917, 4), (1, 1917, 91)], ["float32"] * 2),
    "pts-0": _case(70, [(5,)], pts=0),
    "pts-large": _case(71, [(5,)], pts=2 ** 62),
    "pts-negative": _case(72, [(5,)], pts=-5),
}


def frame(core, case, info_override=None):
    """(Buffer, TensorsConfig) of ``case`` in one package's types."""
    mems, infos = [], []
    for i, (a, name) in enumerate(zip(case["arrays"], case["names"])):
        base = core.TensorInfo.from_shape(a.shape, a.dtype)
        info = core.TensorInfo(base.dims, base.dtype, name)
        if info_override is not None:
            info = info_override(core, i, info)
        mems.append(core.TensorMemory(a, info))
        infos.append(info)
    fmt = core.TensorFormat.FLEXIBLE if case["flexible"] else core.TensorFormat.STATIC
    cfg = core.TensorsConfig(core.TensorsInfo(tuple(infos), fmt), case["rate"])
    return core.Buffer(mems, pts=case["pts"], duration=None), cfg


def both(case, **kw):
    return frame(jcore, case, **kw), frame(tcore, case, **kw)


def assert_frames_equal(jbuf, tbuf):
    assert len(jbuf.memories) == len(tbuf.memories)
    for jm, tm in zip(jbuf.memories, tbuf.memories):
        assert tm.info.dims == jm.info.dims
        assert str(tm.info.dtype) == str(jm.info.dtype)
        assert tm.info.name == jm.info.name
        a, b = jm.host(), tm.host()
        assert a.shape == b.shape and a.dtype == b.dtype
        assert a.tobytes() == b.tobytes()


def assert_payloads(case, buf):
    for a, m in zip(case["arrays"], buf.memories):
        assert m.host().tobytes() == a.tobytes()
        assert m.host().dtype == a.dtype


# ---------------------------------------------------------------------------- #
# byte identity and parse parity, every case
# ---------------------------------------------------------------------------- #

@pytest.mark.parametrize("name", sorted(CASES))
def test_flexbuf_blob_is_byte_identical_and_parses_as_jax(name):
    (jbuf, jcfg), (tbuf, tcfg) = both(CASES[name])
    blob = jfb.frame_to_flexbuf(jbuf, jcfg)
    assert tfb.frame_to_flexbuf(tbuf, tcfg) == blob
    jout, jrate = jfb.flexbuf_to_frame(blob)
    tout, trate = tfb.flexbuf_to_frame(blob)
    assert trate == jrate == CASES[name]["rate"]
    assert_frames_equal(jout, tout)
    assert_payloads(CASES[name], tout)


@pytest.mark.parametrize("name", sorted(CASES))
def test_flatbuf_blob_is_byte_identical_and_parses_as_jax(name):
    (jbuf, jcfg), (tbuf, tcfg) = both(CASES[name])
    blob = jfb.frame_to_flatbuf(jbuf, jcfg)
    assert tfb.frame_to_flatbuf(tbuf, tcfg) == blob
    jout, jrate = jfb.flatbuf_to_frame(blob)
    tout, trate = tfb.flatbuf_to_frame(blob)
    assert trate == jrate == CASES[name]["rate"]
    assert_frames_equal(jout, tout)
    assert_payloads(CASES[name], tout)


@pytest.mark.parametrize("name", sorted(CASES))
def test_proto_blob_is_byte_identical_and_parses_as_jax(name):
    (jbuf, _), (tbuf, _) = both(CASES[name])
    blob = jpb.frame_to_proto(jbuf)
    assert tpb.frame_to_proto(tbuf) == blob
    jout, tout = jpb.proto_to_frame(blob), tpb.proto_to_frame(blob)
    assert (tout.pts, tout.duration, tout.offset) == \
        (jout.pts, jout.duration, jout.offset)
    assert_frames_equal(jout, tout)
    assert_payloads(CASES[name], tout)


def test_ssd_frame_sizes():
    """A 300x300x3 uint8 frame on the wire: FlatBuffers 270,108 bytes (the
    JAX package's own size), FlexBuffers ending in a 32-bit map and a root
    width of 1."""
    (_, _), (tbuf, tcfg) = both(CASES["ssd-300"])
    assert len(tfb.frame_to_flatbuf(tbuf, tcfg)) == 270108
    flex = tfb.frame_to_flexbuf(tbuf, tcfg)
    assert flex[-3:] == bytes([0x19, 0x26, 0x01])


def test_pts_zero_comes_back_as_none():
    """proto3 leaves a 0 field out, so ``pts=0`` reads back as None: the
    JAX package's behaviour (``msg.pts_ns or None``), kept."""
    (jbuf, _), (tbuf, _) = both(CASES["pts-0"])
    blob = tpb.frame_to_proto(tbuf)
    assert tpb.proto_to_frame(blob).pts is None
    assert jpb.proto_to_frame(blob).pts is None
    assert tpb.proto_to_frame(tpb.frame_to_proto(
        both(CASES["pts-negative"])[1][0])).pts == -5


# ---------------------------------------------------------------------------- #
# the stock runtimes read the port's blobs
# ---------------------------------------------------------------------------- #

@pytest.mark.parametrize("name", ["names", "tensors-12", "rate-ntsc", "flexible",
                                  "payload-65536", "ssd-outputs"])
def test_stock_runtimes_read_port_blobs(name):
    from flatbuffers import flexbuffers

    from nnstreamer_tpu.converters.proto import tensors_pb2

    case = CASES[name]
    tbuf, tcfg = frame(tcore, case)
    root = flexbuffers.GetRoot(bytearray(tfb.frame_to_flexbuf(tbuf, tcfg))).AsMap
    assert root["num_tensors"].AsInt == len(case["arrays"])
    assert root["rate_n"].AsInt == case["rate"].numerator
    assert root["format"].AsInt == (1 if case["flexible"] else 0)
    for i, a in enumerate(case["arrays"]):
        t = root[f"tensor_{i}"].AsVector
        assert t[0].AsString == (case["names"][i] or "")
        assert bytes(t[3].AsBlob) == a.tobytes()
        assert [e.AsInt for e in t[2].AsTypedVector][:a.ndim] == list(a.shape[::-1])
    out, rate = jfb.flatbuf_to_frame(tfb.frame_to_flatbuf(tbuf, tcfg))
    assert rate == case["rate"]
    assert_payloads(case, out)
    msg = tensors_pb2.TensorFrame()
    msg.ParseFromString(tpb.frame_to_proto(tbuf))
    for t, a in zip(msg.tensors, case["arrays"]):
        assert t.data == a.tobytes() and list(t.dims) == list(a.shape[::-1])
        assert t.dtype == str(a.dtype)


def test_proto_reader_takes_unpacked_dims_and_unknown_fields():
    """A message google.protobuf would accept: dims unpacked, unknown
    fields of every wire type, a repeated scalar (the last one wins)."""
    from nnstreamer_tpu.converters.proto import tensors_pb2

    v = proto_codec.varint
    data = np.arange(6, dtype=np.int16).tobytes()
    tensor = (b"\x12\x05int16" + b"\x18" + v(3) + b"\x18" + v(2)
              + b"\x22" + v(len(data)) + data
              + b"\x29" + bytes(8) + b"\x35" + bytes(4) + b"\x38" + v(7))
    blob = (b"\x08" + v(11) + b"\x08" + v(-3) + b"\x22" + v(len(tensor)) + tensor
            + b"\x9a\x01\x03abc")
    msg = tensors_pb2.TensorFrame()
    msg.ParseFromString(blob)
    out = tpb.proto_to_frame(blob)
    assert out.pts == msg.pts_ns == -3
    assert out.memories[0].info.dims == tuple(msg.tensors[0].dims) == (3, 2)
    assert out.memories[0].host().tobytes() == data
    assert_frames_equal(jpb.proto_to_frame(blob), out)


def test_codecs_low_level_against_stock():
    """Each hand builder against the stock one on a value outside the frame
    layout: a map whose keys come in unsorted, a signed int at a forced
    width, and a FlatBuffers table sharing its vtable."""
    import flatbuffers
    from flatbuffers import flexbuffers

    stock = flexbuffers.Builder()
    with stock.Map():
        stock.Key("zeta"); stock.Int(-300)
        stock.Key("alpha"); stock.UInt(7, 8)
        stock.Key("mid"); stock.String("x" * 300)
    ours = flexbuf_codec.Builder()
    top = ours.start()
    ours.key("zeta"); ours.sint(-300)
    ours.key("alpha"); ours.uint(7, 8)
    ours.key("mid"); ours.string("x" * 300)
    ours.end_map(top)
    blob = bytes(ours.finish())
    assert blob == bytes(stock.Finish())
    root = flexbuf_codec.get_root(blob).as_map
    assert root["zeta"].as_int == -300 and root["mid"].as_string == "x" * 300

    sb, ob = flatbuffers.Builder(16), flatbuf_codec.Builder(16)
    offs = []
    for value in (3, 3, 9):
        sb.StartObject(2); sb.PrependInt32Slot(1, value, 0); offs.append(sb.EndObject())
        ob.start_object(2); ob.add_int32(1, value, 0); ob.end_object()
    sb.Finish(offs[-1])
    assert bytes(ob.finish(offs[-1])) == bytes(sb.Output())


# ---------------------------------------------------------------------------- #
# errors, message for message
# ---------------------------------------------------------------------------- #

def _both_raise(jfn, tfn):
    with pytest.raises(ValueError) as je:
        jfn()
    with pytest.raises(ValueError) as te:
        tfn()
    assert str(te.value) == str(je.value)
    return str(te.value)


@pytest.mark.parametrize("fmt", ["flexbuf", "flatbuf"])
def test_rank_above_four_raises_as_jax(fmt):
    case = _case(80, [(2, 1, 2, 1, 2)])
    (jbuf, jcfg), (tbuf, tcfg) = both(case)
    msg = _both_raise(lambda: getattr(jfb, f"frame_to_{fmt}")(jbuf, jcfg),
                      lambda: getattr(tfb, f"frame_to_{fmt}")(tbuf, tcfg))
    assert "NNS_TENSOR_RANK_LIMIT=4" in msg


@pytest.mark.parametrize("fmt", ["flexbuf", "flatbuf"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_half_types_are_refused_as_jax(fmt, dtype):
    def to_half(core, i, info):
        return core.TensorInfo(info.dims, core.TensorDType.parse(dtype), info.name)

    case = _case(81, [(4,)], ["int16"])
    (jbuf, jcfg), (tbuf, tcfg) = both(case, info_override=to_half)
    msg = _both_raise(lambda: getattr(jfb, f"frame_to_{fmt}")(jbuf, jcfg),
                      lambda: getattr(tfb, f"frame_to_{fmt}")(tbuf, tcfg))
    assert "typecast before serializing" in msg


def test_more_than_sixteen_tensors_raise_as_jax():
    jbuf = jcore.Buffer.from_arrays(_case(82, [(2,)] * 17)["arrays"])
    blob = jfb.frame_to_flexbuf(jbuf)
    msg = _both_raise(lambda: jfb.flexbuf_to_frame(blob),
                      lambda: tfb.flexbuf_to_frame(blob))
    assert "num_tensors 17 out of range" in msg


@pytest.mark.parametrize("fmt", ["flexbuf", "flatbuf"])
def test_payload_length_mismatch_raises_as_jax(fmt):
    def one_more(core, i, info):
        return core.TensorInfo((info.dims[0] + 1,), info.dtype, info.name)

    (jbuf, jcfg), (tbuf, tcfg) = both(_case(83, [(4,)]), info_override=one_more)
    blob = getattr(jfb, f"frame_to_{fmt}")(jbuf, jcfg)
    assert getattr(tfb, f"frame_to_{fmt}")(tbuf, tcfg) == blob
    msg = _both_raise(lambda: getattr(jfb, f"{fmt}_to_frame")(blob),
                      lambda: getattr(tfb, f"{fmt}_to_frame")(blob))
    assert "4 payload bytes for 5:uint8 (5 expected)" in msg


@pytest.mark.parametrize("fmt", ["flexbuf", "flatbuf"])
def test_unknown_type_enum_raises_as_jax(fmt, monkeypatch):
    (jbuf, jcfg), _ = both(_case(84, [(4,)]))
    monkeypatch.setattr(jfb, "_dtype_enum", lambda info: 11)
    blob = getattr(jfb, f"frame_to_{fmt}")(jbuf, jcfg)
    msg = _both_raise(lambda: getattr(jfb, f"{fmt}_to_frame")(blob),
                      lambda: getattr(tfb, f"{fmt}_to_frame")(blob))
    assert msg == "unknown tensor_type enum 11"


# ---------------------------------------------------------------------------- #
# random frames
# ---------------------------------------------------------------------------- #

@st.composite
def _frames(draw):
    n = draw(st.integers(1, 5))
    shapes = [tuple(draw(st.lists(st.integers(1, 6), min_size=1, max_size=4)))
              for _ in range(n)]
    dtypes = [draw(st.sampled_from(DTYPES)) for _ in range(n)]
    names = [draw(st.sampled_from([None, "", "t", "logits"])) for _ in range(n)]
    rate = draw(st.sampled_from([Fraction(0, 1), Fraction(30, 1),
                                 Fraction(30000, 1001)]))
    pts = draw(st.one_of(st.none(), st.integers(-2 ** 63, 2 ** 63 - 1)))
    return _case(draw(st.integers(0, 2 ** 16)), shapes, dtypes, names, rate,
                 draw(st.booleans()), pts)


@settings(max_examples=40, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(_frames())
def test_random_frames_are_byte_identical_and_round_trip(case):
    (jbuf, jcfg), (tbuf, tcfg) = both(case)
    for fmt in ("flexbuf", "flatbuf"):
        blob = getattr(tfb, f"frame_to_{fmt}")(tbuf, tcfg)
        assert blob == getattr(jfb, f"frame_to_{fmt}")(jbuf, jcfg)
        out, rate = getattr(tfb, f"{fmt}_to_frame")(blob)
        assert rate == case["rate"]
        assert_payloads(case, out)
    blob = tpb.frame_to_proto(tbuf)
    assert blob == jpb.frame_to_proto(jbuf)
    out = tpb.proto_to_frame(blob)
    assert out.pts == (case["pts"] or None)
    assert_payloads(case, out)


# ---------------------------------------------------------------------------- #
# pipelines: decoder → converter, flex, custom-script
# ---------------------------------------------------------------------------- #

def _run(core, graph, kw, caps, data, *elements):
    p = graph.Pipeline(**kw)
    src = p.add_new("appsrc", caps=caps, data=data)
    els = [p.add_new(name, **props) for name, props in elements]
    sink = p.add_new("tensor_sink", store=True)
    graph.Pipeline.link(src, *els, sink)
    p.run(timeout=TIMEOUT)
    return sink


def _both_sinks(case, *elements, caps=None, data=None):
    out = []
    for core, graph, kw in ((jcore, jgraph, {}), (tcore, tgraph, {"device": "cpu"})):
        buf, cfg = frame(core, case)
        out.append(_run(core, graph, kw, caps(core) if caps else core.Caps.tensors(cfg),
                        data if data is not None else [[m.host() for m in buf.memories]],
                        *elements))
    return out


def _sinks_equal(js, ts):
    assert ts.num_buffers == js.num_buffers > 0
    for jb, tb in zip(js.buffers, ts.buffers):
        assert_frames_equal(jb, tb)
    jc, tc = js.sink_pad.caps, ts.sink_pad.caps
    assert tc.media_type == jc.media_type
    if jc.media_type == "other/tensors":
        assert tc.to_config().rate == jc.to_config().rate


@pytest.mark.parametrize("fmt", ["flexbuf", "flatbuf", "protobuf"])
@pytest.mark.parametrize("name", ["names", "rate-ntsc", "tensors-12", "ssd-300"])
def test_decoder_then_converter_pipeline_matches_jax(fmt, name):
    js, ts = _both_sinks(CASES[name], ("tensor_decoder", {"mode": fmt}),
                         ("tensor_converter", {}))
    _sinks_equal(js, ts)
    assert_payloads(CASES[name], ts.buffers[0])


@pytest.mark.parametrize("fmt", ["flexbuf", "flatbuf", "protobuf"])
def test_decoder_blob_matches_jax(fmt):
    js, ts = _both_sinks(CASES["rate-30"], ("tensor_decoder", {"mode": fmt}))
    assert ts.sink_pad.caps.media_type == js.sink_pad.caps.media_type == f"other/{fmt}"
    assert ts.buffers[0].memories[0].host().tobytes() == \
        js.buffers[0].memories[0].host().tobytes()


def test_flex_mode_matches_jax():
    js, ts = _both_sinks(CASES["names"], ("tensor_decoder", {"mode": "flex"}))
    assert ts.sink_pad.caps.media_type == "application/octet-stream"
    assert [m.host().tobytes() for m in ts.buffers[0].memories] == \
        [m.host().tobytes() for m in js.buffers[0].memories]
    from nnstreamer_tpu_torch.core.meta import unwrap_flex

    meta, payload = unwrap_flex(ts.buffers[0].memories[1].host().tobytes())
    assert payload == CASES["names"]["arrays"][1].tobytes()


_CONVERTER_SCRIPT = '''
import numpy as np
import nnstreamer_python as nns


class CustomConverter:
    def convert(self, input_array):
        data = np.asarray(input_array[0]).view(np.float32)
        shape = nns.TensorShape([2, data.size // 2, 1, 1], np.float32)
        return [shape], [data], 30, 1
'''

_DECODER_SCRIPT = '''
import numpy as np


class CustomDecoder:
    def getOutCaps(self):
        return b"application/octet-stream"

    def decode(self, raw_data, in_info, rate_n, rate_d):
        head = np.asarray([d for s in in_info for d in s.getDims()]
                          + [rate_n, rate_d], np.uint32).tobytes()
        return head + b"".join(np.asarray(r).tobytes() for r in raw_data)
'''


def test_custom_script_converter_matches_jax(tmp_path):
    script = tmp_path / "conv.py"
    script.write_text(_CONVERTER_SCRIPT)
    raw = np.arange(8, dtype=np.float32).view(np.uint8)
    js, ts = _both_sinks(
        CASES["rate-30"], ("tensor_converter", {"mode": f"custom-script:{script}"}),
        caps=lambda core: core.Caps("application/octet-stream"), data=[raw])
    _sinks_equal(js, ts)
    assert ts.buffers[0].memories[0].host().tolist() == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert ts.sink_pad.caps.to_config().rate == Fraction(30, 1)


def test_custom_script_decoder_matches_jax(tmp_path):
    script = tmp_path / "dec.py"
    script.write_text(_DECODER_SCRIPT)
    js, ts = _both_sinks(CASES["names"],
                         ("tensor_decoder", {"mode": f"custom-script:{script}"}))
    assert ts.sink_pad.caps.media_type == "application/octet-stream"
    assert ts.buffers[0].memories[0].host().tobytes() == \
        js.buffers[0].memories[0].host().tobytes()


def test_custom_script_decoder_needs_a_path():
    p = tgraph.Pipeline(device="cpu")
    dec = p.add_new("tensor_decoder", mode="custom-script")
    with pytest.raises(ValueError, match="needs a script path"):
        dec.start()


# ---------------------------------------------------------------------------- #
# an interop hop into a detector
# ---------------------------------------------------------------------------- #

SSD_SPEC = "zoo://ssd_mobilenet_v2?size=64&num_classes=4&width=0.35"


def _ssd_string(hop, labels, priors, frames=3):
    h = f"tensor_decoder mode={hop} ! other/{hop} ! tensor_converter ! " if hop else ""
    return (f"videotestsrc pattern=random width=64 height=64 num-buffers={frames} ! "
            f"video/x-raw,format=RGB ! tensor_converter ! {h}"
            f'tensor_filter framework=xla-tpu model="{SSD_SPEC}" ! '
            f"tensor_decoder mode=bounding_box option1=mobilenet-ssd option2={labels} "
            f"option3={priors} option4=64:64 option5=64:64 ! tensor_sink store=true")


@pytest.fixture(scope="module")
def ssd_files(tmp_path_factory):
    from nnstreamer_tpu_torch.models.ssd_mobilenet import write_box_priors

    d = tmp_path_factory.mktemp("ssd")
    priors, labels = d / "priors.txt", d / "labels.txt"
    write_box_priors(str(priors), size=64)
    labels.write_text("\n".join(f"c{i}" for i in range(4)))
    return str(labels), str(priors)


def _ssd_run(kw, desc):
    from nnstreamer_tpu_torch.graph.parse import parse_pipeline

    p = parse_pipeline(desc, tgraph.Pipeline(**kw))
    p.run(timeout=TIMEOUT)
    sink = next(e for e in p.elements.values() if e.ELEMENT_NAME == "tensor_sink")
    return [(b.meta["detections"], b.memories[0].host().tobytes()) for b in sink.buffers]


@pytest.mark.parametrize("fmt", ["flexbuf", "flatbuf", "protobuf"])
def test_hop_into_ssd_equals_the_path_without_it(ssd_files, fmt):
    """A frame serialised and parsed back feeds the detector as before:
    boxes, labels and canvases equal to the same frames without the hop.
    FlexBuffers and FlatBuffers trim the frame's trailing 1 (3:64:64:1 →
    3:64:64); the filter views it in the model's declared shape."""
    want = _ssd_run({"device": "cpu"}, _ssd_string(None, *ssd_files))
    got = _ssd_run({"device": "cpu"}, _ssd_string(fmt, *ssd_files))
    assert len(got) == 3 and got == want


def test_jax_filter_fails_on_the_trimmed_frame(ssd_files):
    """The JAX package negotiates the trimmed stream and then hands the
    model the (64, 64, 3) array, which fails inside it: the divergence the
    port's filter repairs (see the test above)."""
    from nnstreamer_tpu.graph.parse import parse_pipeline as jparse

    p = jparse(_ssd_string("flexbuf", *ssd_files, frames=1), jgraph.Pipeline())
    with pytest.raises(jgraph.PipelineError, match="chain error"):
        p.run(timeout=TIMEOUT)
