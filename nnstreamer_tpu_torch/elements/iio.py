"""tensor_src_iio — Linux Industrial-I/O sensor capture.

Port of nnstreamer_tpu/elements/iio.py (reference:
gst/nnstreamer/elements/gsttensor_srciio.c). Scans the sysfs IIO tree for a
device, reads its enabled channels at ``frequency`` and emits one float32
tensor a period, read on the host as the port's other sources are.

Two capture modes (``mode`` property):
  * ``poll`` — read sysfs ``in_*_raw`` channel files once per sample period;
  * ``buffer`` — triggered-buffer capture: parse ``scan_elements`` channel
    type specs (``[be|le]:[su]BITS/STORAGE>>SHIFT``, the reference's scan
    conversion tensor_src_iio.c:104-136), enable the buffer, and read
    whole scans from the ``/dev/iio:deviceN`` character device.

``auto`` (default) uses ``buffer`` when the device exposes scan_elements and
a readable dev node, else ``poll``. Offset/scale sysfs attributes are
applied when present; output is one [channels] (poll) or
[channels, frames-per-buffer] (buffer) float32 tensor per period.
``base_dir`` / ``dev_path`` override the sysfs root and char device so
tests can fake a device tree (the reference's unittest_src_iio does exactly
this in tmpfs).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from fractions import Fraction
from typing import Any, List, Optional

import numpy as np

from ..core.buffer import Buffer, NS_PER_SEC
from ..core.log import logger
from ..core.types import Caps, TensorsConfig, TensorsInfo
from ..graph.element import register_element
from ..graph.pipeline import SourceElement

log = logger("iio")

_DEFAULT_SYSFS = "/sys/bus/iio/devices"


@dataclass
class ScanChannel:
    """One enabled scan_elements channel (gsttensor_srciio.c scan spec)."""

    name: str
    index: int
    big_endian: bool
    signed: bool
    bits: int
    storage_bits: int
    shift: int
    scale: float = 1.0
    offset: float = 0.0
    byte_offset: int = 0  # filled in by layout pass

    @property
    def storage_bytes(self) -> int:
        return self.storage_bits // 8

    def extract(self, scan: bytes) -> float:
        raw = scan[self.byte_offset:self.byte_offset + self.storage_bytes]
        val = int.from_bytes(raw, "big" if self.big_endian else "little")
        val >>= self.shift
        val &= (1 << self.bits) - 1
        if self.signed and val & (1 << (self.bits - 1)):
            val -= 1 << self.bits
        return (val + self.offset) * self.scale


_TYPE_RE = re.compile(r"(be|le):([su])(\d+)/(\d+)(?:>>(\d+))?")


def parse_scan_type(spec: str) -> tuple:
    """Parse an IIO scan_elements ``_type`` spec like ``le:s12/16>>4``."""
    m = _TYPE_RE.fullmatch(spec.strip())
    if not m:
        raise ValueError(f"bad IIO channel type spec {spec!r}")
    endian, sign, bits, storage, shift = m.groups()
    return (endian == "be", sign == "s", int(bits), int(storage),
            int(shift or 0))


def scan_layout(channels: List[ScanChannel]) -> int:
    """Assign byte offsets (each channel naturally aligned to its storage
    size, kernel IIO buffer layout) and return total scan size."""
    pos = 0
    for ch in sorted(channels, key=lambda c: c.index):
        sb = ch.storage_bytes
        pos = (pos + sb - 1) // sb * sb
        ch.byte_offset = pos
        pos += sb
    align = max((c.storage_bytes for c in channels), default=1)
    return (pos + align - 1) // align * align


@register_element
class TensorSrcIIO(SourceElement):
    ELEMENT_NAME = "tensor_src_iio"

    def __init__(self, name: Optional[str] = None, **props: Any):
        self.device: Optional[str] = None       # device name (e.g. "iio:device0" or its `name` file contents)
        self.frequency = 10                     # Hz polling
        self.channels: Optional[str] = None     # "auto" or comma list, e.g. "voltage0,voltage1"
        self.base_dir = _DEFAULT_SYSFS
        self.mode = "auto"                      # auto | poll | buffer
        self.frames_per_buffer = 1              # scans per emitted tensor (buffer mode)
        self.dev_path: Optional[str] = None     # char-device override (tests)
        super().__init__(name, **props)
        self._dev_dir: Optional[str] = None
        self._chan_files: List[str] = []
        self._scales: List[float] = []
        self._offsets: List[float] = []
        self._scan_channels: List[ScanChannel] = []
        self._scan_size = 0
        self._dev_fd: Optional[int] = None
        self._buffered = False
        self._n = 0

    def _find_device(self) -> str:
        if not os.path.isdir(self.base_dir):
            raise FileNotFoundError(f"IIO sysfs root missing: {self.base_dir}")
        for entry in sorted(os.listdir(self.base_dir)):
            d = os.path.join(self.base_dir, entry)
            name_file = os.path.join(d, "name")
            if not os.path.isdir(d):
                continue
            if self.device in (None, "", entry):
                return d
            if os.path.isfile(name_file):
                with open(name_file) as f:
                    if f.read().strip() == self.device:
                        return d
        raise FileNotFoundError(f"IIO device {self.device!r} not found under "
                                f"{self.base_dir}")

    # -- buffered-mode setup ------------------------------------------------- #
    def _resolve_dev_path(self) -> Optional[str]:
        if self.dev_path:
            return self.dev_path
        entry = os.path.basename(self._dev_dir)  # "iio:device0"
        path = os.path.join("/dev", entry)
        return path if os.path.exists(path) else None

    def _setup_buffered(self, want) -> bool:
        self._buffered_fail = "no scan_elements or dev node"
        scan_dir = os.path.join(self._dev_dir, "scan_elements")
        if not os.path.isdir(scan_dir):
            return False
        dev = self._resolve_dev_path()
        if dev is None:
            return False
        chans: List[ScanChannel] = []
        for fn in sorted(os.listdir(scan_dir)):
            m = re.fullmatch(r"in_([a-z0-9_]+)_type", fn)
            if not m:
                continue
            ch_name = m.group(1)
            base = os.path.join(scan_dir, f"in_{ch_name}")
            if want is not None and ch_name not in want:
                # deselected channels must be disabled or the kernel's scan
                # layout diverges from ours (reference does the same)
                self._write_sysfs(base + "_en", "0")
                continue
            try:
                with open(base + "_type") as f:
                    be, sg, bits, storage, shift = parse_scan_type(f.read())
                with open(base + "_index") as f:
                    index = int(f.read().strip())
            except (OSError, ValueError) as e:
                # unparseable channel MUST be disabled, or the kernel's scan
                # layout includes it while ours doesn't and every
                # higher-index channel decodes from the wrong bytes
                self._write_sysfs(base + "_en", "0")
                if want is not None and ch_name in want:
                    # explicitly requested: don't silently shrink the tensor;
                    # fail buffered setup (mode=auto falls back to sysfs
                    # polling, which serves the channel without scan decode)
                    self._buffered_fail = (f"requested channel {ch_name!r} "
                                           f"unusable for scan decode ({e})")
                    log.warning("iio: %s", self._buffered_fail)
                    return False
                continue
            en_path = base + "_en"
            if want is None and os.path.isfile(en_path):
                with open(en_path) as f:
                    if f.read().strip() == "0":
                        continue  # honour pre-set enables on channels=auto
            self._write_sysfs(en_path, "1")
            chans.append(ScanChannel(
                ch_name, index, be, sg, bits, storage, shift,
                scale=self._read_float(f"in_{ch_name}_scale", 1.0),
                offset=self._read_float(f"in_{ch_name}_offset", 0.0)))
        if not chans:
            self._buffered_fail = "no usable scan channels"
            return False
        chans.sort(key=lambda c: c.index)
        self._scan_channels = chans
        self._scan_size = scan_layout(chans)
        buf_dir = os.path.join(self._dev_dir, "buffer")
        self._write_sysfs(os.path.join(buf_dir, "length"),
                          str(max(2 * self.frames_per_buffer, 8)))
        self._write_sysfs(os.path.join(buf_dir, "enable"), "1")
        try:
            # non-blocking + select in the read loop so stop() can always
            # interrupt a reader waiting on a slow sensor
            self._dev_fd = os.open(dev, os.O_RDONLY | os.O_NONBLOCK)
        except OSError as e:  # dev node exists but unreadable (e.g. EACCES)
            self._write_sysfs(os.path.join(buf_dir, "enable"), "0")
            self._scan_channels = []
            self._buffered_fail = f"cannot open {dev}: {e}"
            return False
        return True

    @staticmethod
    def _write_sysfs(path: str, value: str) -> None:
        try:
            with open(path, "w") as f:
                f.write(value)
        except OSError:
            pass  # attribute absent on fake trees / RO after enable

    def negotiate(self) -> Caps:
        self._dev_dir = self._find_device()
        want = None
        if self.channels and self.channels != "auto":
            want = {c.strip() for c in str(self.channels).split(",")}
        self._buffered = False
        if self.mode in ("auto", "buffer"):
            self._buffered = self._setup_buffered(want)
            if not self._buffered and self.mode == "buffer":
                raise ValueError(
                    f"IIO buffer capture unavailable for {self._dev_dir} "
                    f"({self._buffered_fail})")
        if not self._buffered:
            self._setup_poll(want)
        self._n = 0
        self.live = not self._buffered  # dev-node reads block at the HW rate
        n_ch = len(self._scan_channels) if self._buffered else len(self._chan_files)
        dim = f"{n_ch}:{self.frames_per_buffer}" if self._buffered else f"{n_ch}:1"
        cfg = TensorsConfig(TensorsInfo.from_strings(dim, "float32"),
                            Fraction(self.frequency))
        return Caps.tensors(cfg)

    def _setup_poll(self, want) -> None:
        self._chan_files, self._scales, self._offsets = [], [], []
        for fn in sorted(os.listdir(self._dev_dir)):
            m = re.fullmatch(r"in_([a-z0-9_]+)_raw", fn)
            if not m:
                continue
            if want is not None and m.group(1) not in want:
                continue
            self._chan_files.append(os.path.join(self._dev_dir, fn))
            base = fn[:-4]  # strip "_raw"
            self._scales.append(self._read_float(f"{base}_scale", 1.0))
            self._offsets.append(self._read_float(f"{base}_offset", 0.0))
        if not self._chan_files:
            raise ValueError(f"no IIO channels found in {self._dev_dir}")

    def _read_float(self, fn: str, default: float) -> float:
        path = os.path.join(self._dev_dir, fn)
        try:
            with open(path) as f:
                return float(f.read().strip())
        except (OSError, ValueError):
            return default

    def stop(self) -> None:
        super().stop()  # reader is non-blocking + checks the stop flag
        if self._dev_fd is not None:
            fd, self._dev_fd = self._dev_fd, None
            try:
                os.close(fd)
            except OSError:
                pass
        if self._buffered and self._dev_dir:
            self._write_sysfs(
                os.path.join(self._dev_dir, "buffer", "enable"), "0")

    # -- capture -------------------------------------------------------------- #
    def _read_scans(self) -> Optional[np.ndarray]:
        import select

        need = self._scan_size * self.frames_per_buffer
        data = b""
        while len(data) < need:
            if self._stop_flag.is_set() or self._dev_fd is None:
                return None
            try:
                r, _, _ = select.select([self._dev_fd], [], [], 0.1)
                if not r:
                    continue  # no data yet; re-check stop flag
                chunk = os.read(self._dev_fd, need - len(data))
            except BlockingIOError:
                continue  # spurious select wakeup (EAGAIN): not EOS
            except (OSError, ValueError):
                if self._stop_flag.is_set() or self._dev_fd is None:
                    return None  # fd closed under us during teardown
                self.post_error(f"iio read failed on {self.device!r}")
                return None
            if not chunk:
                return None  # device EOF (fake files in tests)
            data += chunk
        frames = np.empty((self.frames_per_buffer, len(self._scan_channels)),
                          np.float32)
        for fi in range(self.frames_per_buffer):
            scan = data[fi * self._scan_size:(fi + 1) * self._scan_size]
            for ci, ch in enumerate(self._scan_channels):
                frames[fi, ci] = ch.extract(scan)
        return frames

    def create(self) -> Optional[Buffer]:
        dur = int(NS_PER_SEC / Fraction(self.frequency))
        if self._buffered:
            dur *= self.frames_per_buffer  # one buffer = N scan periods
            frames = self._read_scans()
            if frames is None:
                return None
            arr = frames  # [frames, channels] — innermost dim = channels
        else:
            vals = []
            for path, scale, offset in zip(self._chan_files, self._scales,
                                           self._offsets):
                try:
                    with open(path) as f:
                        raw = float(f.read().strip() or 0)
                except (OSError, ValueError):
                    raw = 0.0
                vals.append((raw + offset) * scale)
            arr = np.asarray([vals], np.float32)
        buf = Buffer.of(arr.reshape(arr.shape[0], -1).astype(np.float32),
                        pts=self._n * dur, duration=dur)
        buf.offset = self._n
        self._n += 1
        return buf
