"""The port's media elements against the JAX package, on the CPU.

``nnstreamer_tpu_torch/elements/media.py`` ports imagefilesrc,
multifilesrc, imagedec/pngdec/jpegdec, imagefreeze, videoscale,
videoconvert and audioconvert. Every pipeline here runs the same seeded
inputs through the JAX package and the port's ``Pipeline(device="cpu")``
and compares what reaches the sinks (tensor bytes, shapes, dtypes and
timestamps) or the files written, byte for byte; a failing configuration
must fail in both. The cases are tests/test_media_iio.py's image path and
the strings of tests/test_reference_pipelines.py that use these elements
and need no reference model files.

``videoscale`` is Pillow's BILINEAR resize in the JAX package (on the
host), and ops/resample.py's integer torch passes in the port. The resample
is held byte for byte against Pillow itself over a seeded sweep of sizes 1
to 97 (up, down, one side alone) in modes L, LA, RGB and RGBA, and at
1920x1080 to 300x300, 224x224 and 257x257. A GRAY8 frame of shape (H, W, 1)
makes Pillow raise, and so the JAX element; the port raises the same way.
The ``cuda`` cases hold the card against the CPU.
"""

import io
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

import nnstreamer_tpu.core as jcore  # noqa: E402
import nnstreamer_tpu.graph as jgraph  # noqa: E402
import nnstreamer_tpu.graph.parse as jparse  # noqa: E402
from nnstreamer_tpu.elements.media import AudioConvert as JaxAudioConvert  # noqa: E402
from nnstreamer_tpu.elements.media import _convert_pixels as jax_convert  # noqa: E402
import nnstreamer_tpu_torch.core as tcore  # noqa: E402
import nnstreamer_tpu_torch.graph as tgraph  # noqa: E402
import nnstreamer_tpu_torch.graph.parse as tparse  # noqa: E402
from nnstreamer_tpu_torch.elements.media import AudioConvert, convert_pixels  # noqa: E402
from nnstreamer_tpu_torch.ops import resample  # noqa: E402

TIMEOUT = 60

JAX = SimpleNamespace(name="jax", core=jcore, graph=jgraph, parse=jparse, kw={})
PORT = SimpleNamespace(name="torch", core=tcore, graph=tgraph, parse=tparse,
                       kw={"device": "cpu"})


def pipeline(ns):
    return ns.graph.Pipeline(**ns.kw)


def parse(ns, desc):
    return ns.parse.parse_pipeline(desc, pipeline(ns))


def record(sink):
    """Per buffer: timestamps, offset and each tensor's shape, dtype, bytes."""
    out = []
    for b in sink.buffers:
        mems = []
        for m in b.memories:
            a = np.asarray(m.host())
            mems.append((a.shape, a.dtype.str, np.ascontiguousarray(a).tobytes()))
        out.append((b.pts, b.duration, b.offset, mems))
    return out


def sinks_of(p):
    return [e for e in p.elements.values() if e.ELEMENT_NAME == "tensor_sink"]


def run_both(case, tmp_path):
    """``case(ns, dir) -> result`` on both packages, each in its own
    directory; the results must be equal. Returns the port's."""
    got = {}
    for ns in (JAX, PORT):
        d = tmp_path / ns.name
        d.mkdir()
        got[ns.name] = case(ns, d)
    assert got["torch"] == got["jax"]
    return got["torch"]


def run_string(desc_of, tmp_path, files=()):
    """A launch string in both packages: the sinks' records and the bytes
    of ``files`` (names in the run's directory)."""
    def case(ns, d):
        p = parse(ns, desc_of(d))
        p.run(timeout=TIMEOUT)
        return ([record(s) for s in sinks_of(p)],
                [(d / f).read_bytes() for f in files])
    return run_both(case, tmp_path)


def fails_in_both(desc_of, tmp_path, match=None):
    for ns in (JAX, PORT):
        d = tmp_path / ns.name
        d.mkdir(exist_ok=True)
        with pytest.raises(Exception, match=match):
            parse(ns, desc_of(d)).run(timeout=TIMEOUT)


def _pil():
    """Pillow, the reference of the CPU cases (imported by them alone: the
    ``cuda`` cases need none)."""
    return pytest.importorskip("PIL.Image")


def _png(arr, path):
    _pil().fromarray(arr).save(path)


# --------------------------------------------------------------------------- #
# tests/test_media_iio.py's image path
# --------------------------------------------------------------------------- #

def test_imagefilesrc_pipeline(tmp_path):
    def case(ns, d):
        for i in range(3):
            _png(np.full((10, 12, 3), i * 40, np.uint8), d / f"img_{i}.png")
        p = pipeline(ns)
        src = p.add_new("imagefilesrc", location=str(d / "*.png"))
        sink = p.add_new("tensor_sink", store=True)
        ns.graph.Pipeline.link(src, p.add_new("tensor_converter"), sink)
        p.run(timeout=TIMEOUT)
        return record(sink)
    rec = run_both(case, tmp_path)
    assert len(rec) == 3 and rec[1][3][0][0] == (1, 10, 12, 3)


def _encoded(fmt, arr, **kw):
    bio = io.BytesIO()
    _pil().fromarray(arr).save(bio, format=fmt, **kw)
    return bio.getvalue()


def _decode_case(data, blocksize, dec="imagedec"):
    def case(ns, d):
        (d / "img").write_bytes(data)
        p = pipeline(ns)
        src = p.add_new("filesrc", location=str(d / "img"), blocksize=blocksize)
        sink = p.add_new("tensor_sink", store=True)
        ns.graph.Pipeline.link(src, p.add_new(dec), p.add_new("tensor_converter"), sink)
        p.run(timeout=TIMEOUT)
        return record(sink)
    return case


def test_imagedec(tmp_path):
    arr = np.full((6, 8, 3), 99, np.uint8)
    rec = run_both(_decode_case(_encoded("PNG", arr), 1 << 20), tmp_path)
    assert rec[0][3][0][2] == arr.tobytes()


def test_imagedec_early_embedded_eoi_chunked(tmp_path):
    """A JPEG with an EOI inside an APP1 segment, in 16-byte chunks: the
    early marker must not end the frame (test_media_iio.py's case)."""
    data = _encoded("JPEG", np.full((24, 32, 3), 128, np.uint8), quality=95)
    payload = b"Exif\x00\x00" + b"\x00" * 10 + b"\xff\xd9" + b"\x00" * 10
    app1 = b"\xff\xe1" + (len(payload) + 2).to_bytes(2, "big") + payload
    rec = run_both(_decode_case(data[:2] + app1 + data[2:], 16, "jpegdec"), tmp_path)
    assert len(rec) == 1 and rec[0][3][0][0] == (1, 24, 32, 3)


def test_imagedec_trailing_padding_after_end_marker(tmp_path):
    arr = np.full((6, 8, 3), 50, np.uint8)
    rec = run_both(_decode_case(_encoded("PNG", arr) + b"\x00" * 300, 1 << 20),
                   tmp_path)
    assert rec[0][3][0][2] == arr.tobytes()


@pytest.mark.parametrize("fmt", ["RGB", "RGBA", "GRAY8"])
def test_imagedec_formats_of_a_random_png_in_chunks(tmp_path, fmt):
    rng = np.random.default_rng(21)
    data = _encoded("PNG", rng.integers(0, 256, (13, 17, 4), dtype=np.uint8))

    def case(ns, d):
        (d / "img.png").write_bytes(data)
        p = pipeline(ns)
        src = p.add_new("filesrc", location=str(d / "img.png"), blocksize=64)
        sink = p.add_new("tensor_sink", store=True)
        ns.graph.Pipeline.link(src, p.add_new("pngdec", format=fmt), sink)
        p.run(timeout=TIMEOUT)
        return record(sink)
    assert len(run_both(case, tmp_path)) == 1


def test_videoscale_and_convert(tmp_path):
    def case(ns, d):
        p = pipeline(ns)
        src = p.add_new("videotestsrc", width=20, height=10, num_buffers=1)
        sink = p.add_new("tensor_sink", store=True)
        ns.graph.Pipeline.link(src, p.add_new("videoscale", width=10, height=5),
                               p.add_new("videoconvert", format="GRAY8"),
                               p.add_new("tensor_converter"), sink)
        p.run(timeout=TIMEOUT)
        return record(sink)
    assert run_both(case, tmp_path)[0][3][0][0] == (1, 5, 10, 1)


# --------------------------------------------------------------------------- #
# tests/test_reference_pipelines.py's strings
# --------------------------------------------------------------------------- #

def test_imagefreeze_repeats_frames(tmp_path):
    def desc(d):
        _png(np.full((8, 8, 3), 7, np.uint8), d / "t.png")
        return (f"filesrc location={d}/t.png ! pngdec ! imagefreeze num_buffers=5 ! "
                "tensor_converter ! tensor_sink store=true")
    (rec,), _ = run_string(desc, tmp_path)
    assert len(rec) == 5 and rec[4][2] == 4


def test_caps_configures_intermediate_videoscale(tmp_path):
    _, (log,) = run_string(
        lambda d: ("videotestsrc num-buffers=1 width=64 height=64 ! videoscale ! "
                   "video/x-raw,width=16,height=16 ! tensor_converter ! "
                   f'filesink location="{d}/scaled.log"'), tmp_path, ["scaled.log"])
    assert len(log) == 16 * 16 * 3


def test_corrupt_png_fails_at_bad_frame(tmp_path):
    def desc(d):
        good = d / "seq_0.png"
        _png(np.zeros((4, 4, 3), np.uint8), good)
        bad = good.read_bytes()
        idx = bad.index(b"IDAT") + 8
        (d / "seq_1.png").write_bytes(
            bad[:idx] + bytes([b ^ 0xFF for b in bad[idx:idx + 8]]) + bad[idx + 8:])
        return (f'multifilesrc location="{d}/seq_%1d.png" index=0 ! '
                "pngdec ! tensor_converter ! fakesink")
    fails_in_both(desc, tmp_path)


def _sequence(d, n=4, size=(16, 12)):
    rng = np.random.default_rng(5)
    for i in range(n):
        _png(rng.integers(0, 255, (size[1], size[0], 3)).astype(np.uint8),
             d / f"testsequence_{i}.png")


def test_reference_typecast_tee_string(tmp_path):
    def desc(d):
        _sequence(d)
        return (f'multifilesrc location="{d}/testsequence_%1d.png" index=0 '
                'caps="image/png,framerate=(fraction)30/1" ! pngdec ! '
                'videoconvert ! video/x-raw, format=RGB ! tensor_converter ! '
                'tee name=t ! queue ! tensor_transform mode=typecast '
                f'option=uint32 ! filesink location="{d}/tc.log" sync=true '
                f't. ! queue ! filesink location="{d}/di.log" sync=true')
    _, (tc, di) = run_string(desc, tmp_path, ["tc.log", "di.log"])
    np.testing.assert_array_equal(np.frombuffer(tc, np.uint32),
                                  np.frombuffer(di, np.uint8).astype(np.uint32))


def _demux_merge_split_images(d, n, hw, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.integers(0, 255, (hw, hw, 3)).astype(np.uint8) for _ in range(n)]
    for i, a in enumerate(arrs):
        _png(a, d / f"img{i}.png")
    return arrs


def _media_head(d, i, hw):
    return (f"filesrc location={d}/img{i}.png ! pngdec ! videoscale ! imagefreeze ! "
            f"videoconvert ! video/x-raw,format=RGB,width={hw},height={hw},"
            "framerate=0/1 ! tensor_converter")


def test_reference_demux_string_two_streams(tmp_path):
    def desc(d):
        _demux_merge_split_images(d, 2, 8, 10)
        return ("tensor_mux name=mux ! tensor_demux name=demux "
                f"{_media_head(d, 0, 8)} ! mux.sink_0 {_media_head(d, 1, 8)} ! mux.sink_1 "
                f"demux.src_0 ! queue ! filesink location={d}/d0.log "
                f"demux.src_1 ! queue ! filesink location={d}/d1.log")
    run_string(desc, tmp_path, ["d0.log", "d1.log"])


def test_reference_merge_string_two_streams(tmp_path):
    def desc(d):
        _demux_merge_split_images(d, 2, 8, 12)
        return ("tensor_merge name=merge mode=linear option=2 sync-mode=nosync ! "
                f"filesink location={d}/merge.log "
                f"{_media_head(d, 0, 8)} ! merge.sink_0 {_media_head(d, 1, 8)} ! merge.sink_1")
    _, (log,) = run_string(desc, tmp_path, ["merge.log"])
    assert len(log) == 16 * 8 * 3


def test_reference_split_two_segs_string(tmp_path):
    def desc(d):
        _demux_merge_split_images(d, 1, 16, 14)
        return (f"{_media_head(d, 0, 16)} ! tensor_split name=split "
                "tensorseg=1:16:16,2:16:16 "
                f"split. ! queue ! filesink location={d}/s0.log "
                f"split. ! queue ! filesink location={d}/s1.log")
    run_string(desc, tmp_path, ["s0.log", "s1.log"])


def test_reference_audio_s16le_string(tmp_path):
    _, (conv, direct) = run_string(
        lambda d: ("audiotestsrc num-buffers=1 samplesperbuffer=8000 ! audioconvert "
                   "! audio/x-raw,format=S16LE,rate=8000 ! tee name=t ! queue ! "
                   "audioconvert ! tensor_converter frames-per-tensor=8000 ! "
                   f'filesink location="{d}/conv.log" sync=true '
                   f't. ! queue ! filesink location="{d}/direct.log" sync=true'),
        tmp_path, ["conv.log", "direct.log"])
    assert conv == direct and len(conv) == 8000 * 2


def test_audioconvert_s16_to_f32(tmp_path):
    _, (log,) = run_string(
        lambda d: ("audiotestsrc num-buffers=1 samplesperbuffer=100 ! "
                   "audioconvert ! audio/x-raw,format=F32LE,rate=16000 ! "
                   "tensor_converter frames-per-tensor=100 ! "
                   f'filesink location="{d}/f32.log"'), tmp_path, ["f32.log"])
    f = np.frombuffer(log, np.float32)
    assert f.size == 100 and np.abs(f).max() <= 1.0


def test_tensor_caps_filter_does_not_clobber_video_format(tmp_path):
    (rec,), _ = run_string(
        lambda d: ("videotestsrc num-buffers=2 width=4 height=4 ! videoconvert ! "
                   "video/x-raw,format=RGB,width=4,height=4 ! tensor_converter ! "
                   "other/tensors,num_tensors=1,dimensions=3:4:4:1,types=uint8,"
                   "format=static ! tensor_sink store=true"), tmp_path)
    assert len(rec) == 2


# --------------------------------------------------------------------------- #
# the elements one by one
# --------------------------------------------------------------------------- #

_AUDIO = ("S8", "U8", "S16LE", "U16LE", "S32LE", "U32LE", "F32LE", "F64LE")


def _samples(fmt, n=513):
    rng = np.random.default_rng(sum(map(ord, fmt)))
    dt = np.dtype(tcore.AUDIO_FORMATS[fmt])
    if dt.kind == "f":
        # past ±1 too: the conversions clip there
        x = rng.uniform(-1.25, 1.25, n).astype(dt)
        x[:6] = [0.0, -0.0, 1.0, -1.0, 0.5 / 32768, -1.5 / 32768]
        return x
    info = np.iinfo(dt)
    x = rng.integers(info.min, info.max, n, endpoint=True).astype(dt)
    x[:2] = [info.min, info.max]
    return x


def _convert_with(el_cls, samples, in_fmt, out_fmt, buffer_cls, memory_cls):
    el = el_cls(format=out_fmt)
    el._in_fmt = in_fmt
    got = {}
    el.push = lambda b: got.setdefault("m", b.memories[0])
    el.chain(None, buffer_cls([memory_cls(samples)]))
    return got["m"]


@pytest.mark.parametrize("src", _AUDIO)
def test_audioconvert_every_format_pair_equals_jax(src):
    """Every (in, out) pair on host arrays and on tensors: the JAX element's
    bytes (test_audio_s16_f32_roundtrip_exact's harness)."""
    x = _samples(src)
    for dst in _AUDIO:
        want = _convert_with(JaxAudioConvert, x, src, dst, jcore.Buffer,
                             jcore.TensorMemory).host()
        host = _convert_with(AudioConvert, x, src, dst, tcore.Buffer,
                             tcore.TensorMemory).host()
        tensor = _convert_with(AudioConvert, torch.from_numpy(x.copy()), src, dst,
                               tcore.Buffer, tcore.TensorMemory)
        assert tensor.is_device
        for got in (host, tensor.host()):
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), (src, dst)


def test_audio_s16_f32_roundtrip_exact():
    data = np.array([1, 2, 100, -1, 32767, -32768], np.int16)
    for x in (data, torch.from_numpy(data.copy())):
        f = _convert_with(AudioConvert, x, "S16LE", "F32LE", tcore.Buffer,
                          tcore.TensorMemory)
        back = _convert_with(AudioConvert, f.device() if f.is_device else f.host(),
                             "F32LE", "S16LE", tcore.Buffer, tcore.TensorMemory)
        np.testing.assert_array_equal(back.host(), data)


_VIDEO = ("RGB", "BGR", "RGBA", "RGBx", "BGRA", "BGRx", "GRAY8")


@pytest.mark.parametrize("src", _VIDEO)
def test_videoconvert_every_format_pair_equals_jax(src):
    ch = tcore.VIDEO_FORMATS[src][0]
    rng = np.random.default_rng(ch)
    frame = rng.integers(0, 256, (9, 11, ch), dtype=np.uint8)
    frame[0, :4, :min(ch, 3)] = [[255] * min(ch, 3), [0] * min(ch, 3),
                                 [254] * min(ch, 3), [1] * min(ch, 3)]
    for dst in _VIDEO:
        try:
            want = jax_convert(frame, src, dst)
        except ValueError:
            for x in (frame, torch.from_numpy(frame)):
                with pytest.raises(ValueError, match="unsupported conversion"):
                    convert_pixels(x, src, dst)
            continue
        host = convert_pixels(frame, src, dst)
        tensor = convert_pixels(torch.from_numpy(frame), src, dst)
        assert isinstance(host, np.ndarray) and isinstance(tensor, torch.Tensor)
        for got in (host, tensor.numpy()):
            assert got.shape == want.shape and got.dtype == want.dtype
            assert got.tobytes() == np.ascontiguousarray(want).tobytes(), (src, dst)


@pytest.mark.parametrize("fmt,size", [("RGB", (37, 23)), ("RGBA", (64, 48)),
                                      ("BGRx", (29, 31)), ("RGB", (160, 90))])
def test_videoscale_element_equals_jax(tmp_path, fmt, size):
    def case(ns, d):
        p = pipeline(ns)
        src = p.add_new("videotestsrc", width=71, height=53, format=fmt,
                        pattern="random", num_buffers=3)
        sink = p.add_new("tensor_sink", store=True)
        ns.graph.Pipeline.link(src, p.add_new("videoscale", width=size[0],
                                              height=size[1]),
                               p.add_new("tensor_converter"), sink)
        p.run(timeout=TIMEOUT)
        return record(sink)
    rec = run_both(case, tmp_path)
    assert rec[0][3][0][0][1:3] == (size[1], size[0])


def test_videoscale_gray8_frame_raises_as_pillow_does(tmp_path):
    """An (H, W, 1) GRAY8 frame: Pillow's fromarray refuses it, so the JAX
    element fails, and the port's fails the same way."""
    fails_in_both(lambda d: ("videotestsrc num-buffers=1 width=8 height=8 format=GRAY8 ! "
                             "videoscale width=4 height=4 ! fakesink"), tmp_path,
                  match="Cannot handle this data type")
    with pytest.raises(TypeError, match=r"\(1, 1, 1\), \|u1"):
        resample.resize(torch.zeros((8, 8, 1), dtype=torch.uint8), 4, 4)


# --------------------------------------------------------------------------- #
# the resample against Pillow
# --------------------------------------------------------------------------- #

_MODES = {"L": None, "LA": 2, "RGB": 3, "RGBA": 4}


def _frame(rng, h, w, ch):
    shape = (h, w) if ch is None else (h, w, ch)
    a = rng.integers(0, 256, shape, dtype=np.uint8)
    if ch in (2, 4):
        # alpha at its special values (0, 255) and at 1 and 128 too
        mask = rng.random((h, w)) < 0.5
        a[..., -1][mask] = rng.choice([0, 255, 1, 128], size=int(mask.sum()))
    return a


def _pairs(chunk, n=25):
    """Seeded (in, out) sizes from 1 to 97: up, down, and one side kept."""
    rng = np.random.default_rng(1000 + chunk)
    out = []
    for i in range(n):
        h, w, oh, ow = (int(v) for v in rng.integers(1, 98, 4))
        if i % 5 == 0:
            oh = h
        if i % 7 == 3:
            ow = w
        out.append((h, w, oh, ow))
    return out


@pytest.mark.parametrize("chunk", range(8))
@pytest.mark.parametrize("mode", list(_MODES))
def test_resample_equals_pillow_sweep(mode, chunk):
    """25 seeded size pairs a chunk, 200 a mode."""
    Image = _pil()
    rng = np.random.default_rng(chunk)
    for h, w, oh, ow in _pairs(chunk):
        a = _frame(rng, h, w, _MODES[mode])
        want = np.asarray(Image.fromarray(a).resize((ow, oh), Image.BILINEAR))
        got = resample.resize(torch.from_numpy(a), ow, oh).numpy()
        assert Image.fromarray(a).mode == mode
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), \
            (mode, (h, w), (oh, ow))


@pytest.mark.parametrize("out", [(300, 300), (224, 224), (257, 257)])
@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_resample_1080p_equals_pillow(mode, out):
    Image = _pil()
    a = _frame(np.random.default_rng(out[0]), 1080, 1920, _MODES[mode])
    want = np.asarray(Image.fromarray(a).resize(out, Image.BILINEAR))
    got = resample.resize(torch.from_numpy(a), *out).numpy()
    assert got.tobytes() == want.tobytes()


def test_resample_coefficients_antialias_a_downscale():
    """1920 → 300: each output pixel reads 12 or 13 taps (fewer at the two
    edges, where the filter is clipped) whose 22-bit weights sum to 2**22
    within rounding; an upscale reads 2 real taps."""
    first, w = resample.coefficients(1920, 300)
    taps = (w != 0).sum(1)
    assert w.shape == (300, 15) and set(taps[1:-1]) == {12, 13} and taps.min() >= 10
    assert np.abs(w.astype(np.int64).sum(1) - (1 << 22)).max() <= 8
    assert first[0] == 0 and first[-1] + taps[-1] <= 1920
    _, up = resample.coefficients(300, 1920)
    assert (up != 0).sum(1).max() <= 2


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(_MODES))
def test_resample_on_the_card_equals_the_cpu(cuda_device, mode):
    rng = np.random.default_rng(7)
    for h, w, oh, ow in _pairs(99) + [(1080, 1920, 300, 300), (1080, 1920, 257, 257)]:
        a = torch.from_numpy(_frame(rng, h, w, _MODES[mode]))
        got = resample.resize(a.to(cuda_device), ow, oh)
        assert got.device.type == "cuda"
        assert got.cpu().numpy().tobytes() == resample.resize(a, ow, oh).numpy().tobytes()


@pytest.mark.cuda
def test_videoscale_on_a_card_pipeline_stays_on_the_card(cuda_device):
    frames = {}
    for dev in ("cuda", "cpu"):
        p = tgraph.Pipeline(device=dev)
        src = p.add_new("videotestsrc", width=1920, height=1080, pattern="random",
                        num_buffers=4)
        scale = p.add_new("videoscale", width=300, height=300)
        sink = p.add_new("tensor_sink", store=True)
        tgraph.Pipeline.link(src, scale, p.add_new("tensor_converter"), sink)
        p.run(timeout=TIMEOUT)
        frames[dev] = [b.memories[0] for b in sink.buffers]
        if dev == "cuda":
            assert scale.bytes_up == 4 * 1080 * 1920 * 3
            assert all(m.device().device.type == "cuda" for m in frames[dev])
    assert [m.tobytes() for m in frames["cuda"]] == [m.tobytes() for m in frames["cpu"]]
