"""The port's tensor_src_iio against the JAX package, on the CPU.

``nnstreamer_tpu_torch/elements/iio.py`` ports the Linux IIO sensor source:
sysfs polling, triggered-buffer capture from the character device with the
scan-element type specs and layout, offset/scale, ``mode=auto``, and the
``base_dir``/``dev_path`` overrides. Each case builds the same fake sysfs
tree (tests/test_media_iio.py's, as the reference's unittest_src_iio fakes
one in tmpfs) for each package and compares what reaches the sink byte for
byte, and the sysfs writes the element leaves behind.
"""

import struct
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

import nnstreamer_tpu.graph as jgraph  # noqa: E402
from nnstreamer_tpu.elements import iio as jiio  # noqa: E402
import nnstreamer_tpu_torch.graph as tgraph  # noqa: E402
from nnstreamer_tpu_torch.elements import iio as tiio  # noqa: E402

TIMEOUT = 30

JAX = SimpleNamespace(name="jax", graph=jgraph, iio=jiio, kw={})
PORT = SimpleNamespace(name="torch", graph=tgraph, iio=tiio, kw={"device": "cpu"})


def _fake_device(root, name="accel3d"):
    dev = root / "iio:device0"
    dev.mkdir(parents=True)
    (dev / "name").write_text(name + "\n")
    (dev / "in_accel_x_raw").write_text("100\n")
    (dev / "in_accel_y_raw").write_text("-50\n")
    (dev / "in_accel_x_scale").write_text("0.5\n")
    (dev / "in_accel_x_offset").write_text("10\n")
    return root


def _fake_buffered_device(root, n_scans=4, chans=None):
    """accel_x le:s12/16>>4 (index 0), accel_y le:u8/8 (1), timestamp
    le:s64/64 (2, 8-byte aligned): 16-byte scans."""
    base = _fake_device(root)
    dev = base / "iio:device0"
    scan = dev / "scan_elements"
    scan.mkdir()
    for ch, typ, idx in chans or [("accel_x", "le:s12/16>>4", 0),
                                  ("accel_y", "le:u8/8>>0", 1),
                                  ("timestamp", "le:s64/64>>0", 2)]:
        (scan / f"in_{ch}_type").write_text(typ + "\n")
        (scan / f"in_{ch}_index").write_text(f"{idx}\n")
        (scan / f"in_{ch}_en").write_text("1\n")
    (dev / "buffer").mkdir()
    (dev / "buffer" / "enable").write_text("0\n")
    (dev / "buffer" / "length").write_text("0\n")
    raw = b""
    for i in range(n_scans):
        x12 = (-5 - i) & 0xFFF
        raw += struct.pack("<H", x12 << 4) + struct.pack("B", 200 + i)
        raw += b"\x00" * 5
        raw += struct.pack("<q", 1000 + i)
    devnode = root / "devnode.bin"
    devnode.write_bytes(raw)
    return base, devnode


def _record(sink):
    return [(b.pts, b.duration, b.offset,
             [(m.host().shape, m.host().dtype.str, m.host().tobytes())
              for m in b.memories]) for b in sink.buffers]


def _tree(root):
    """Every file under ``root`` with its contents (the sysfs writes)."""
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def run_both(tmp_path, make_tree, **props):
    got = {}
    for ns in (JAX, PORT):
        root = tmp_path / ns.name
        base, devnode = make_tree(root)
        if devnode is not None:
            props["dev_path"] = str(devnode)
        p = ns.graph.Pipeline(**ns.kw)
        src = p.add_new("tensor_src_iio", base_dir=str(base), **props)
        sink = p.add_new("tensor_sink", store=True)
        ns.graph.Pipeline.link(src, sink)
        p.run(timeout=TIMEOUT)
        got[ns.name] = (_record(sink), _tree(root))
    assert got["torch"] == got["jax"]
    return got["torch"][0]


def test_scan_and_convert(tmp_path):
    rec = run_both(tmp_path, lambda r: (_fake_device(r), None), device="accel3d",
                   frequency=100, num_buffers=3)
    vals = np.frombuffer(rec[0][3][0][2], np.float32)
    assert len(rec) == 3 and rec[0][3][0][0] == (1, 2)
    assert vals[0] == pytest.approx((100 + 10) * 0.5) and vals[1] == -50.0


@pytest.mark.parametrize("channels", [None, "accel_y", "accel_x,accel_y"])
def test_poll_mode_channel_selection(tmp_path, channels):
    rec = run_both(tmp_path, lambda r: (_fake_device(r), None), device="iio:device0",
                   mode="poll", channels=channels, num_buffers=2)
    assert len(rec) == 2


@pytest.mark.parametrize("fpb", [1, 2, 4])
def test_buffered_capture(tmp_path, fpb):
    rec = run_both(tmp_path, lambda r: _fake_buffered_device(r), device="accel3d",
                   mode="buffer", frames_per_buffer=fpb, frequency=100)
    assert len(rec) == 4 // fpb
    vals = np.frombuffer(rec[0][3][0][2], np.float32).reshape(fpb, 3)
    assert vals[0, 0] == pytest.approx((-5 + 10) * 0.5)
    assert vals[0, 1] == 200.0 and vals[0, 2] == 1000.0


def test_auto_mode_takes_the_buffer_and_deselects_channels(tmp_path):
    """mode=auto with a dev node captures scans; a channel left out of
    ``channels`` is disabled in sysfs (the trees after the runs agree)."""
    rec = run_both(tmp_path, lambda r: _fake_buffered_device(r), device="accel3d",
                   channels="accel_x,timestamp", frames_per_buffer=2)
    assert rec[0][3][0][0] == (2, 2)


def test_auto_mode_falls_back_to_poll_on_a_bad_type_spec(tmp_path):
    """A requested channel whose scan type cannot be parsed makes buffered
    capture unusable: mode=auto polls sysfs instead."""
    chans = [("accel_x", "le:s12/16>>4", 0), ("accel_y", "garbage", 1)]
    rec = run_both(tmp_path, lambda r: _fake_buffered_device(r, chans=chans),
                   device="accel3d", channels="accel_x,accel_y", num_buffers=2)
    assert rec[0][3][0][0] == (1, 2)


def test_scan_type_parse_and_layout():
    for ns in (JAX, PORT):
        m = ns.iio
        assert m.parse_scan_type("le:s12/16>>4") == (False, True, 12, 16, 4)
        assert m.parse_scan_type("be:u10/16>>6") == (True, False, 10, 16, 6)
        with pytest.raises(ValueError):
            m.parse_scan_type("nonsense")
        chans = [m.ScanChannel("ts", 2, False, True, 64, 64, 0),
                 m.ScanChannel("x", 0, False, True, 12, 16, 4),
                 m.ScanChannel("y", 1, False, False, 8, 8, 0)]
        assert m.scan_layout(chans) == 16
        assert [c.byte_offset for c in chans] == [8, 0, 2]
        ch = m.ScanChannel("v", 0, True, True, 12, 16, 4, scale=0.25, offset=3)
        assert ch.extract((0xFFB0).to_bytes(2, "big")) == pytest.approx((-5 + 3) * 0.25)


def test_missing_device_fails(tmp_path):
    for ns in (JAX, PORT):
        p = ns.graph.Pipeline(**ns.kw)
        src = p.add_new("tensor_src_iio", base_dir=str(tmp_path), device="nope",
                        num_buffers=1)
        sink = p.add_new("tensor_sink")
        ns.graph.Pipeline.link(src, sink)
        with pytest.raises((ns.graph.PipelineError, TimeoutError)):
            p.run(timeout=5)


def test_buffer_mode_without_dev_node_fails(tmp_path):
    for ns in (JAX, PORT):
        base = _fake_device(tmp_path / ns.name)
        p = ns.graph.Pipeline(**ns.kw)
        src = p.add_new("tensor_src_iio", base_dir=str(base), mode="buffer",
                        num_buffers=1)
        ns.graph.Pipeline.link(src, p.add_new("tensor_sink"))
        with pytest.raises((ns.graph.PipelineError, ValueError), match="buffer"):
            p.run(timeout=5)
