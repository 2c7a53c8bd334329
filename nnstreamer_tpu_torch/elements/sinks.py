"""Sink element: tensor_sink (signal-emitting).

``tensor_sink`` mirrors the reference's app-facing sink
(gst/nnstreamer/elements/gsttensorsink.c: GObject signals ``new-data``/
``stream-start``/``eos`` with a ``signal-rate`` limiter,
tensor_sink.c:60-62,178-209). Signals are plain Python callables here.
"""

from __future__ import annotations

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
