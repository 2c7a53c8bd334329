"""Source elements: appsrc, videotestsrc, audiotestsrc, filesrc.

These replace the GStreamer base sources the reference pipelines use
(videotestsrc/appsrc in tests/*/runTest.sh).
"""

from __future__ import annotations

import os
import queue
from fractions import Fraction
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np

from ..core.buffer import Buffer, TensorMemory, NS_PER_SEC
from ..core.types import AUDIO_FORMATS, Caps, TensorsConfig, VIDEO_FORMATS
from ..graph.element import register_element
from ..graph.pipeline import SourceElement


@register_element
class AppSrc(SourceElement):
    """Application-driven source. Three feeding modes:
      * ``data=`` an iterable of numpy arrays or torch tensors (or tuples of them, or
        ready Buffers);
      * ``callback=`` a zero-arg callable returning the next item or None;
      * ``push_buffer()`` from app threads (internal queue).
    ``caps`` must be set (a Caps or a TensorsConfig)."""

    ELEMENT_NAME = "appsrc"

    def __init__(self, name: Optional[str] = None, **props: Any):
        self.caps: Optional[Caps] = None
        self.data: Optional[Iterable[Any]] = None
        self.callback: Optional[Callable[[], Any]] = None
        self.framerate: Any = 0
        super().__init__(name, **props)
        self._iter: Optional[Iterator[Any]] = None
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=64)
        self._count = 0

    def _set_prop_caps(self, v: Any) -> None:
        if isinstance(v, TensorsConfig):
            self.caps = Caps.tensors(v)
        else:
            self.caps = v

    def push_buffer(self, item: Any) -> None:
        """Thread-safe app feed; pass None to signal EOS."""
        self._q.put(item)

    def end_of_stream(self) -> None:
        self._q.put(None)

    def negotiate(self) -> Caps:
        if self.caps is None:
            raise ValueError("appsrc requires caps")
        if self.data is not None:
            self._iter = iter(self.data)
        self._count = 0
        return self.caps

    def _next_item(self) -> Any:
        if self._iter is not None:
            return next(self._iter, None)
        if self.callback is not None:
            return self.callback()
        while True:
            try:
                return self._q.get(timeout=0.1)
            except queue.Empty:
                if self._stop_flag.is_set():
                    return None

    def create(self) -> Optional[Buffer]:
        item = self._next_item()
        if item is None:
            return None
        rate = Fraction(self.framerate) if self.framerate else Fraction(0, 1)
        dur = int(NS_PER_SEC / rate) if rate > 0 else None
        if isinstance(item, Buffer):
            buf = item
        else:
            arrays = item if isinstance(item, (tuple, list)) else (item,)
            buf = Buffer.from_arrays(arrays)
        if buf.pts is None:
            buf.pts = self._count * dur if dur else self._count
        if buf.duration is None:
            buf.duration = dur
        buf.offset = self._count
        self._count += 1
        return buf


@register_element
class VideoTestSrc(SourceElement):
    """Synthesizes video/x-raw frames. Patterns: ``smpte`` (color bars),
    ``gradient``, ``solid`` (color=0xRRGGBB), ``random`` (seeded)."""

    ELEMENT_NAME = "videotestsrc"

    def __init__(self, name: Optional[str] = None, **props: Any):
        self.width = 320
        self.height = 240
        self.format = "RGB"
        self.framerate: Any = 30
        self.pattern = "smpte"
        self.color = 0x000000
        self.seed = 0
        super().__init__(name, **props)
        self._n = 0
        self._rng = None

    #: gst videotestsrc numeric pattern ids (gstvideotestsrc.h enum) for the
    #: ids reference pipelines actually use; unknown ids fall back to smpte
    _NUMERIC_PATTERNS = {
        0: "smpte", 1: "random", 2: ("solid", 0x000000), 3: ("solid", 0xFFFFFF),
        4: ("solid", 0xFF0000), 5: ("solid", 0x00FF00), 6: ("solid", 0x0000FF),
        13: "smpte75",
    }

    def negotiate(self) -> Caps:
        if self.format not in VIDEO_FORMATS:
            raise ValueError(f"unsupported video format {self.format!r}")
        pat = self.pattern
        if isinstance(pat, int) or (isinstance(pat, str) and pat.isdigit()):
            mapped = self._NUMERIC_PATTERNS.get(int(pat), "smpte")
            if isinstance(mapped, tuple):
                self.pattern, self.color = mapped
            else:
                self.pattern = mapped
        self._n = 0
        self._rng = np.random.default_rng(self.seed)
        return Caps("video/x-raw", {
            "format": self.format, "width": self.width, "height": self.height,
            "framerate": Fraction(self.framerate)})

    def _frame(self) -> np.ndarray:
        ch, dt = VIDEO_FORMATS[self.format]
        h, w = self.height, self.width
        if self.pattern == "solid":
            rgb = [(self.color >> 16) & 0xFF, (self.color >> 8) & 0xFF, self.color & 0xFF]
            frame = np.zeros((h, w, ch), dt)
            frame[..., :min(3, ch)] = rgb[:min(3, ch)]
        elif self.pattern == "gradient":
            x = np.linspace(0, 255, w, dtype=np.float32)
            y = np.linspace(0, 255, h, dtype=np.float32)
            frame = np.zeros((h, w, ch), np.float32)
            frame[..., 0 % ch] = x[None, :]
            if ch > 1:
                frame[..., 1] = y[:, None]
            if ch > 2:
                frame[..., 2] = (self._n * 16) % 256
            frame = frame.astype(dt)
        elif self.pattern == "random":
            if dt == np.uint8:
                # raw byte stream → frame: ~20× faster than integers(); a
                # Python test source must not bottleneck pipeline FPS
                frame = np.frombuffer(self._rng.bytes(h * w * ch),
                                      np.uint8).reshape(h, w, ch).copy()
            else:
                frame = self._rng.integers(0, 256, (h, w, ch)).astype(dt)
        else:  # smpte bars (smpte75 = same bars at 75% amplitude)
            bars = np.array([[255, 255, 255], [255, 255, 0], [0, 255, 255],
                             [0, 255, 0], [255, 0, 255], [255, 0, 0],
                             [0, 0, 255]], np.float32)
            if self.pattern == "smpte75":
                bars = bars * 0.75
            idx = (np.arange(w) * len(bars)) // max(w, 1)
            frame = np.zeros((h, w, ch), np.float32)
            frame[..., :min(3, ch)] = bars[idx][None, :, :min(3, ch)]
            frame = frame.astype(dt)
        return frame

    def create(self) -> Optional[Buffer]:
        rate = Fraction(self.framerate)
        dur = int(NS_PER_SEC / rate) if rate > 0 else None
        buf = Buffer.of(self._frame(), pts=(self._n * dur if dur else self._n),
                        duration=dur)
        buf.offset = self._n
        self._n += 1
        return buf


@register_element
class AudioTestSrc(SourceElement):
    """Synthesizes audio/x-raw (sine) in S16LE/F32LE etc."""

    ELEMENT_NAME = "audiotestsrc"

    def __init__(self, name: Optional[str] = None, **props: Any):
        self.rate = 16000
        self.channels = 1
        self.format = "S16LE"
        self.freq = 440.0
        self.samplesperbuffer = 1024
        super().__init__(name, **props)
        self._pos = 0

    def negotiate(self) -> Caps:
        self._pos = 0
        return Caps("audio/x-raw", {"format": self.format, "rate": self.rate,
                                    "channels": self.channels})

    def create(self) -> Optional[Buffer]:
        n = self.samplesperbuffer
        t = (np.arange(n) + self._pos) / self.rate
        wave = np.sin(2 * np.pi * self.freq * t)
        dt = np.dtype(AUDIO_FORMATS[self.format])
        if dt.kind == "u":  # unsigned: offset sine around the midpoint
            mx = np.iinfo(dt).max
            samples = ((wave * 0.5 + 0.5) * mx).astype(dt)
        elif dt.kind == "i":
            samples = (wave * np.iinfo(dt).max).astype(dt)
        else:
            samples = wave.astype(dt)
        frame = np.repeat(samples[:, None], self.channels, axis=1)
        pts = self._pos * NS_PER_SEC // self.rate
        dur = n * NS_PER_SEC // self.rate
        self._pos += n
        return Buffer.of(frame, pts=pts, duration=dur)


@register_element
class FileSrc(SourceElement):
    """Reads a file as application/octet-stream in ``blocksize`` chunks
    (GStreamer filesrc semantics; pairs with tensor_converter octet mode)."""

    ELEMENT_NAME = "filesrc"

    def __init__(self, name: Optional[str] = None, **props: Any):
        self.location: Optional[str] = None
        self.blocksize = 4096
        super().__init__(name, **props)
        self._fh = None

    def negotiate(self) -> Caps:
        if not self.location or not os.path.isfile(self.location):
            raise FileNotFoundError(f"filesrc location {self.location!r}")
        self._fh = open(self.location, "rb")
        return Caps("application/octet-stream")

    def create(self) -> Optional[Buffer]:
        data = self._fh.read(self.blocksize)
        if not data:
            return None
        return Buffer.of(np.frombuffer(data, dtype=np.uint8))

    def stop(self) -> None:
        super().stop()
        if self._fh is not None:
            self._fh.close()
            self._fh = None
