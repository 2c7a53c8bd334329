"""tensor_rate — framerate conformance + QoS throttle generator.

Reference: gst/nnstreamer/elements/gsttensorrate.c (props framerate,
throttle, in/out/duplicate/drop counters :957-993; sends throttling QoS
upstream to tensor_filter).

Two jobs:
  1. conform the stream to ``framerate=N/D`` by dropping early buffers and
     duplicating the previous buffer into gaps (enabled via drop/duplicate);
  2. when ``throttle=true``, send a QoS event upstream asking producers
     (tensor_filter) to emit at most one buffer per target interval — saving
     device invokes instead of discarding their results.

Port of nnstreamer_tpu/elements/rate.py: timing from PTS alone, no clock.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Any, Optional

from ..core.buffer import Buffer, NS_PER_SEC
from ..core.types import Caps, TensorsConfig
from ..graph.element import Element, FlowReturn, Pad, register_element
from ..graph.events import Event


@register_element
class TensorRate(Element):
    ELEMENT_NAME = "tensor_rate"

    def __init__(self, name: Optional[str] = None, **props: Any):
        self.framerate: Any = "30/1"
        self.throttle = True
        self.drop = True
        self.duplicate = True
        self.silent = True
        super().__init__(name, **props)
        self.add_sink_pad(template=Caps.any_tensors())
        self.add_src_pad(template=Caps.any_tensors())
        # reference counters (props `in`, `out`, `duplicate`, `drop`)
        self.n_in = 0
        self.n_out = 0
        self.n_dup = 0
        self.n_drop = 0
        self._next_ts: Optional[int] = None
        self._prev: Optional[Buffer] = None

    @property
    def _rate(self) -> Fraction:
        r = self.framerate
        try:
            if isinstance(r, str) and "/" in r:
                n, d = r.split("/")
                return Fraction(int(n), int(d))
            return Fraction(r)
        except (ValueError, ZeroDivisionError, TypeError) as e:
            raise ValueError(
                f"tensor_rate: bad framerate {r!r} (want N/D or number): {e}")

    @property
    def _interval_ns(self) -> int:
        rate = self._rate
        if rate <= 0:
            raise ValueError("tensor_rate: framerate must be positive")
        return int(NS_PER_SEC / rate)

    def start(self) -> None:
        self._interval_ns  # validate framerate eagerly (prop errors at start)
        self.n_in = self.n_out = self.n_dup = self.n_drop = 0
        self._next_ts = None
        self._prev = None

    def on_caps(self, pad: Pad, caps: Caps) -> None:
        pad.caps = caps
        if caps.media_type == "other/tensors":
            cfg = caps.to_config()
            out_cfg = TensorsConfig(cfg.info, self._rate)
            out_caps = Caps.tensors(out_cfg)
        else:
            out_caps = caps.with_fields(framerate=self._rate)
        if self.throttle:
            pad.push_event(Event.qos(interval_ns=self._interval_ns))
        self.send_caps_all(out_caps)

    def chain(self, pad: Pad, buf: Buffer) -> Optional[FlowReturn]:
        self.n_in += 1
        interval = self._interval_ns
        pts = buf.pts if buf.pts is not None else self.n_in * interval
        if self._next_ts is None:
            self._next_ts = pts
        ret = FlowReturn.OK
        if pts + interval < self._next_ts:
            if self.drop:
                self.n_drop += 1
                self._prev = buf
                return FlowReturn.OK
        # fill gaps by duplicating the previous buffer
        while self.duplicate and self._prev is not None \
                and pts >= self._next_ts + interval:
            dup = self._prev.with_memories(self._prev.memories,
                                           config=self._prev.config)
            dup.pts = self._next_ts
            dup.duration = interval
            self.n_dup += 1
            self.n_out += 1
            ret = self.push(dup)
            self._next_ts += interval
        if pts >= self._next_ts or not self.drop:
            out = buf.with_memories(buf.memories, config=buf.config)
            out.pts = self._next_ts
            out.duration = interval
            self.n_out += 1
            ret = self.push(out)
            self._next_ts += interval
        else:
            self.n_drop += 1
        self._prev = buf
        return ret
