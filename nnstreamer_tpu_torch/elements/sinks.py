"""Sink elements: tensor_sink (signal-emitting), appsink (pull), fakesink,
filesink, multifilesink.

``tensor_sink`` mirrors the reference's app-facing sink
(gst/nnstreamer/elements/gsttensorsink.c: GObject signals ``new-data``/
``stream-start``/``eos`` with a ``signal-rate`` limiter,
tensor_sink.c:60-62,178-209). Signals are plain Python callables here.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, List, Optional

from ..core.buffer import Buffer
from ..core.types import Caps
from ..graph.element import Element, FlowReturn, Pad, register_element


@register_element
class TensorSink(Element):
    """Terminal sink emitting ``new-data`` callbacks; optionally records
    buffers (``store=True``) for test inspection."""

    ELEMENT_NAME = "tensor_sink"

    def __init__(self, name: Optional[str] = None, **props: Any):
        self.signal_rate = 0  # max signals/sec; 0 = every buffer
        self.emit_signals = True
        self.store = False
        self.sync = False  # reserved: render-time sync (no renderer here)
        self.new_data: Optional[Callable[[Buffer], None]] = None
        self.eos_callback: Optional[Callable[[], None]] = None
        super().__init__(name, **props)
        self.add_sink_pad()
        self.buffers: List[Buffer] = []
        self.last_buffer: Optional[Buffer] = None
        self.num_buffers = 0
        self._last_signal_t = 0.0

    def _set_prop_new_data(self, cb: Callable[[Buffer], None]) -> None:
        self.new_data = cb

    def chain(self, pad: Pad, buf: Buffer) -> Optional[FlowReturn]:
        with self._lock:
            self.num_buffers += 1
            self.last_buffer = buf
            if self.store:
                self.buffers.append(buf)
        if self.emit_signals and self.new_data is not None:
            now = time.monotonic()
            if self.signal_rate <= 0 or (now - self._last_signal_t) >= 1.0 / self.signal_rate:
                self._last_signal_t = now
                self.new_data(buf)
        return FlowReturn.OK

    def on_eos(self) -> None:
        if self.eos_callback is not None:
            self.eos_callback()


@register_element
class AppSink(Element):
    """Pull-mode sink: app calls ``pull(timeout)`` → Buffer or None at EOS."""

    ELEMENT_NAME = "appsink"

    def __init__(self, name: Optional[str] = None, **props: Any):
        self.max_buffers = 64
        self.drop = False
        super().__init__(name, **props)
        self.add_sink_pad()
        self._q: "queue.Queue[Any]" = queue.Queue()
        self._eos = threading.Event()

    def chain(self, pad: Pad, buf: Buffer) -> Optional[FlowReturn]:
        if self._q.qsize() >= self.max_buffers:
            if self.drop:
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    pass
            else:
                while self._q.qsize() >= self.max_buffers and not self._eos.is_set():
                    time.sleep(0.001)
        self._q.put(buf)
        return FlowReturn.OK

    def on_eos(self) -> None:
        self._eos.set()

    def pull(self, timeout: Optional[float] = 5.0) -> Optional[Buffer]:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            try:
                return self._q.get(timeout=0.05)
            except queue.Empty:
                if self._eos.is_set() and self._q.empty():
                    return None
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError("appsink pull timed out")


@register_element
class FakeSink(Element):
    """Discards everything (gst fakesink)."""

    ELEMENT_NAME = "fakesink"

    def __init__(self, name: Optional[str] = None, **props: Any):
        super().__init__(name, **props)
        self.add_sink_pad()
        self.num_buffers = 0

    def chain(self, pad: Pad, buf: Buffer) -> Optional[FlowReturn]:
        with self._lock:
            self.num_buffers += 1
        return FlowReturn.OK


@register_element
class MultiFileSink(Element):
    """gst multifilesink: writes each buffer to ``location`` expanded as a
    printf pattern (``out_%1d.log``) with a running index — the dump-side
    pair of multifilesrc in the reference's converter SSAT strings."""

    ELEMENT_NAME = "multifilesink"

    def __init__(self, name: Optional[str] = None, **props: Any):
        self.location: Optional[str] = None
        self.index = 0
        super().__init__(name, **props)
        self.add_sink_pad()
        self._idx = 0

    def start(self) -> None:
        if not self.location or "%" not in self.location:
            raise ValueError(
                "multifilesink needs a printf-style location pattern")
        self._idx = int(self.index)

    def chain(self, pad: Pad, buf: Buffer) -> Optional[FlowReturn]:
        with open(self.location % self._idx, "wb") as f:
            for m in buf.memories:
                f.write(m.tobytes())
        self._idx += 1
        return FlowReturn.OK


@register_element
class FileSink(Element):
    """Appends raw tensor bytes to ``location`` (gst filesink; SSAT golden
    compares read these dumps)."""

    ELEMENT_NAME = "filesink"

    def __init__(self, name: Optional[str] = None, **props: Any):
        self.location: Optional[str] = None
        super().__init__(name, **props)
        self.add_sink_pad()
        self._fh = None

    def start(self) -> None:
        if not self.location:
            raise ValueError("filesink requires location")
        self._fh = open(self.location, "wb")

    def chain(self, pad: Pad, buf: Buffer) -> Optional[FlowReturn]:
        for m in buf.memories:
            self._fh.write(m.tobytes())
        return FlowReturn.OK

    def stop(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
