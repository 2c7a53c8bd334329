"""tensor_batch / tensor_unbatch — adaptive cross-frame micro-batching.

Port of nnstreamer_tpu/elements/batch.py. A serving capability with no
reference equivalent: the reference's only batching is ``tensor_converter
frames-per-tensor``, which waits unconditionally for N frames and leaves the
rest of the pipeline batched. Serving wants *dynamic batching*: group
whatever frames are queued — up to ``max_batch`` — within a ``budget_ms``
latency window, run ONE host→device copy + ONE invoke for the group, then
restore the per-frame stream, so one card serves many frames per launch
sequence.

  * ``tensor_batch max_batch=8 budget_ms=5`` — collects buffers on a worker
    thread. A group is emitted when ``max_batch`` frames are queued or
    ``budget_ms`` has elapsed since the group's first frame (so a lone
    frame on an idle stream is delayed at most the budget). Partial groups
    are padded by repeating the last frame: downstream sees exactly one
    static shape, and the pad rows are dropped at unbatch.
  * ``budget_ms=0`` — AUTO budget: the deadline adapts to the observed
    inter-arrival rate (EMA), targeting ``~1.3 × max_batch × interval`` so
    groups normally FILL before flushing, clamped to [2 ms, 500 ms].
  * ``tensor_unbatch`` — splits a batched buffer back into per-frame
    buffers (device-resident slices — views of the batched tensor, no D2H),
    restoring each frame's PTS/offset from the batch metadata.
  * under a multi-tenant ``DeviceEngine`` (sched/, ``sched_enroll``) the
    budget shrinks while the engine has work queued: holding frames to fill
    a group buys nothing while the device is backed up.

Metadata contract (on the batched buffer):
  ``batch_frames`` — structural group size (= max_batch, incl. padding);
  ``batch_n``      — number of VALID leading frames;
  ``batch_pts`` / ``batch_offsets`` / ``batch_durations`` — per valid frame.
Elements between batch and unbatch must preserve ``Buffer.meta``
(``Buffer.with_memories`` does).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ..core.buffer import Buffer, TensorMemory
from ..core.log import logger
from ..core.types import Caps, TensorInfo, TensorsConfig, TensorsInfo
from ..graph.element import (Element, FlowReturn, Pad, join_or_warn,
                             register_element)
from ..graph.events import Event, EventType

log = logger("tensor_batch")

#: sentinel the worker interprets as "budget expired: flush the group"
_FLUSH = object()


@register_element
class TensorBatch(Element):
    ELEMENT_NAME = "tensor_batch"

    def __init__(self, name: Optional[str] = None, **props: Any):
        self.max_batch = 8
        self.budget_ms = 5.0  # 0 = auto (adapt to the arrival rate)
        #: producer-side bound (frames) before backpressure blocks upstream
        self.max_pending = 0  # 0 = 4 * max_batch
        super().__init__(name, **props)
        #: observability: groups emitted and valid frames grouped (the
        #: ratio exposes pad waste — frames_grouped / (groups * max_batch))
        self.groups_emitted = 0
        self.frames_grouped = 0
        self._ema_interval: Optional[float] = None
        self._last_arrival: Optional[float] = None
        #: injectable time source so the budget/deadline arithmetic is
        #: testable without real sleeps (tests swap in a fake clock)
        self._clock = time.monotonic
        #: the DeviceEngine this element's pipeline is enrolled on
        #: (sched_enroll) — its queue depth shrinks the flush budget
        self._sched_engine: Optional[Any] = None
        if self.max_batch < 1:
            raise ValueError(f"tensor_batch: max_batch must be >= 1, "
                             f"got {self.max_batch}")
        if self.budget_ms < 0:
            raise ValueError(f"tensor_batch: budget_ms must be >= 0 "
                             f"(0 = auto), got {self.budget_ms}")
        self.add_sink_pad(template=Caps.any_tensors())
        self.add_src_pad(template=Caps.any_tensors())
        self._dq: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._worker: Optional[threading.Thread] = None
        self._flushing = False
        self._out_config: Optional[TensorsConfig] = None

    # -- lifecycle ----------------------------------------------------------- #
    def start(self) -> None:
        self._flushing = False
        self._worker = threading.Thread(
            target=self._drain, name=f"batch:{self.name}", daemon=True)
        self._worker.start()

    def stop(self) -> None:
        # Teardown semantics (deliberate): an abrupt stop() WITHOUT a
        # prior EOS discards the partially accumulated group — same as a
        # GStreamer queue dropping in-flight buffers on the NULL
        # transition. Draining streams end with EOS, which the worker
        # flushes in-order before the boundary (see _drain); pushing from
        # stop() instead would race downstream elements already stopping.
        with self._cv:
            self._flushing = True
            self._cv.notify_all()
        w = self._worker
        if w is not None and w is not threading.current_thread():
            join_or_warn(w, self.name)
        self._worker = None
        self._dq.clear()

    # -- negotiation ---------------------------------------------------------- #
    def on_caps(self, pad: Pad, caps: Caps) -> None:
        # compute the batched caps here but adopt them ONLY on the worker
        # thread (in-order with buffers): a mid-stream renegotiation must
        # first flush the pending old-shape group under the old config
        config = caps.to_config()
        pad.caps = caps
        infos = tuple(
            TensorInfo.from_shape(
                (info.shape[0] * self.max_batch,) + tuple(info.shape[1:]),
                info.dtype.np_dtype)
            for info in config.info)
        out = TensorsConfig(TensorsInfo(infos), config.rate)
        self._enqueue(Event.caps(Caps.tensors(out)))

    # -- dataflow -------------------------------------------------------------- #
    def chain(self, pad: Pad, buf: Buffer) -> Optional[FlowReturn]:
        self._enqueue(buf)
        return FlowReturn.OK

    def health_probe(self) -> Dict[str, int]:
        """Pending-buffer occupancy against the backpressure bound for
        the health watchdog's queue-dwell rule (obs/health.py) — an
        unlocked monitoring sample like the queue element's."""
        return {"depth": len(self._dq),
                "bound": int(self.max_pending or 4 * self.max_batch)}

    def handle_event(self, pad: Pad, event: Event) -> None:
        self._enqueue(event)

    def _event_entry(self, pad: Pad, event: Event) -> None:
        # EOS must flush the pending partial group in-order, not bypass it
        if event.type is EventType.EOS:
            self._enqueue(event)
            return
        super()._event_entry(pad, event)

    def _enqueue(self, item: Any) -> None:
        bound = self.max_pending or 4 * self.max_batch
        with self._cv:
            if isinstance(item, Buffer):
                now = self._clock()
                if self._last_arrival is not None:
                    gap = now - self._last_arrival
                    # EMA of inter-arrival for the auto budget; ignore
                    # idle gaps (>1 s) — they are stream pauses, not rate
                    if gap < 1.0:
                        self._ema_interval = gap if self._ema_interval \
                            is None else 0.8 * self._ema_interval + 0.2 * gap
                self._last_arrival = now
                while not self._flushing and \
                        sum(1 for it in self._dq
                            if isinstance(it, Buffer)) >= bound:
                    self._cv.wait(0.1)  # backpressure
            if self._flushing:
                return
            self._dq.append(item)
            self._cv.notify_all()

    def _budget_s(self) -> float:
        """Flush window for a new group. Fixed budget unless budget_ms=0
        (auto): ~1.3 × the time the stream needs to FILL max_batch at its
        observed rate, so groups normally reach full size and padding
        stays exceptional (see module doc). When the pipeline is enrolled
        on a DeviceEngine (sched_enroll) and that engine already has
        pending work queued, the window shrinks proportionally — holding
        frames to fill a group buys nothing while the device is backed
        up; it only stacks batching latency on top of queueing latency."""
        if self.budget_ms > 0:
            base = self.budget_ms / 1000.0
        else:
            interval = self._ema_interval if self._ema_interval is not None \
                else 0.005
            base = min(max(1.3 * self.max_batch * interval, 0.002), 0.5)
        eng = self._sched_engine
        if eng is not None:
            try:
                depth = eng.pending()
            except Exception:  # noqa: BLE001 — engine mid-teardown
                depth = 0
            if depth > 0:
                base = base / (1.0 + depth / float(self.max_batch))
        return base

    # -- scheduler opt-in ----------------------------------------------------- #
    def sched_enroll(self, engine: Any, tenant: Any) -> None:
        """Tenant-aware budget: remember the engine so _budget_s can read
        its queue depth. Idempotent; no dispatch rerouting — batching still
        happens on this element's own worker."""
        self._sched_engine = engine

    def sched_detach(self) -> None:
        self._sched_engine = None
        super().sched_detach()

    def _quit_worker(self) -> None:
        """Mark the element flushing before the worker exits early, so
        producers blocked in _enqueue's backpressure wait are released
        (they would otherwise wedge until pipeline teardown)."""
        with self._cv:
            self._flushing = True
            self._cv.notify_all()

    # -- worker ----------------------------------------------------------------- #
    def _drain(self) -> None:
        group: List[Buffer] = []
        deadline: Optional[float] = None
        while True:
            with self._cv:
                item = None
                while item is None:
                    if self._flushing:
                        return
                    if self._dq:
                        item = self._dq.popleft()
                        self._cv.notify_all()
                        break
                    if group and deadline is not None:
                        remaining = deadline - self._clock()
                        if remaining <= 0:
                            item = _FLUSH
                            break
                        self._cv.wait(min(remaining, 0.05))
                    else:
                        self._cv.wait(0.1)
            try:
                if item is _FLUSH:
                    if self._emit(group) is not FlowReturn.OK:
                        self._quit_worker()  # downstream EOS: stop consuming
                        return
                    group, deadline = [], None
                elif isinstance(item, Buffer):
                    group.append(item)
                    if len(group) == 1:
                        deadline = self._clock() + self._budget_s()
                    if len(group) >= self.max_batch:
                        if self._emit(group) is not FlowReturn.OK:
                            self._quit_worker()
                            return
                        group, deadline = [], None
                elif isinstance(item, Event):
                    if item.type in (EventType.EOS, EventType.STREAM_START,
                                     EventType.CAPS) and group:
                        # flush under the OLD config before the boundary
                        # (push result deliberately not terminal here: the
                        # EOS event below must still propagate)
                        self._emit(group)
                        group, deadline = [], None
                    if item.type is EventType.EOS:
                        super()._event_entry(self.sink_pad, item)
                    elif item.type is EventType.CAPS:
                        self._out_config = item.data["caps"].to_config()
                        self.send_caps_all(item.data["caps"])
                    else:
                        self.push_event_all(item)
            except Exception as e:  # noqa: BLE001
                self.post_error(f"batching failed: {e}", exc=e)
                self._quit_worker()
                return

    def _emit(self, group: List[Buffer]) -> FlowReturn:
        n = len(group)
        self.groups_emitted += 1
        self.frames_grouped += n
        # pad by repeating the last frame: ONE static shape downstream
        frames = group + [group[-1]] * (self.max_batch - n)
        mems: List[TensorMemory] = []
        for ti in range(len(group[0].memories)):
            arrs = [b.memories[ti].host() for b in frames]
            mems.append(TensorMemory(
                np.concatenate(arrs, axis=0) if len(arrs) > 1
                else arrs[0]))
        first = group[0]
        out = Buffer(
            mems, pts=first.pts, dts=first.dts, offset=first.offset,
            duration=(None if any(b.duration is None for b in group)
                      else sum(b.duration for b in group)),
            config=self._out_config,
            meta={**first.meta,
                  "batch_frames": self.max_batch,
                  "batch_n": n,
                  "batch_pts": [b.pts for b in group],
                  "batch_offsets": [b.offset for b in group],
                  "batch_durations": [b.duration for b in group]})
        ret = self.push(out)
        if ret is FlowReturn.ERROR:
            # unlinked/failed downstream: surface instead of consuming
            # forever (a chain exception already posted its own error)
            raise RuntimeError("downstream returned ERROR")
        return FlowReturn.OK if ret is None else ret


@register_element
class TensorUnbatch(Element):
    """Splits ``tensor_batch`` groups back into per-frame buffers.

    Slices are taken on whatever side the memory lives — a device-resident
    batched model output yields device-resident per-frame slices (views of
    the batched tensor, no D2H), so decoder device-reduce paths keep working
    per frame. Per-frame caps are sent at the first buffer (the split factor
    travels in buffer metadata, not caps).
    """

    ELEMENT_NAME = "tensor_unbatch"

    def __init__(self, name: Optional[str] = None, **props: Any):
        super().__init__(name, **props)
        self.add_sink_pad(template=Caps.any_tensors())
        self.add_src_pad(template=Caps.any_tensors())
        self._out_config: Optional[TensorsConfig] = None
        self._rate = None
        self._in_caps: Optional[Caps] = None
        self._passthrough_caps_sent = False

    def on_caps(self, pad: Pad, caps: Caps) -> None:
        config = caps.to_config()
        pad.caps = caps
        self._rate = config.rate  # per-frame caps deferred to first buffer
        self._in_caps = caps
        # renegotiation: recompute the per-frame config from the new stream
        self._out_config = None
        self._passthrough_caps_sent = False

    def chain(self, pad: Pad, buf: Buffer) -> Optional[FlowReturn]:
        frames = int(buf.meta.get("batch_frames", 0))
        if frames <= 0:
            # not batched: passthrough, forwarding the upstream caps
            if not self._passthrough_caps_sent and self._in_caps is not None:
                self.send_caps_all(self._in_caps)
                self._passthrough_caps_sent = True
            return self.push(buf)
        n = int(buf.meta.get("batch_n", frames))
        pts_list = buf.meta.get("batch_pts") or [None] * n
        off_list = buf.meta.get("batch_offsets") or [None] * n
        dur_list = buf.meta.get("batch_durations") or [None] * n
        slices: List[List[Any]] = []
        for mem in buf.memories:
            arr = mem.device() if mem.is_device else mem.host()
            if arr.shape[0] % frames:
                raise ValueError(
                    f"tensor_unbatch: leading dim {arr.shape[0]} not "
                    f"divisible by batch_frames={frames}")
            k = arr.shape[0] // frames
            slices.append([arr[i * k:(i + 1) * k] for i in range(n)])
        if self._out_config is None:
            # the port's own dtype mapping (torch or numpy) via TensorMemory
            infos = tuple(TensorMemory(s[0]).info for s in slices)
            self._out_config = TensorsConfig(TensorsInfo(infos), self._rate)
            self.send_caps_all(Caps.tensors(self._out_config))
        meta = {k: v for k, v in buf.meta.items()
                if not k.startswith("batch_")}
        for i in range(n):
            out = Buffer([TensorMemory(s[i]) for s in slices],
                         pts=pts_list[i], offset=off_list[i],
                         duration=dur_list[i], config=self._out_config,
                         meta=dict(meta))
            ret = self.push(out)
            if ret is not FlowReturn.OK:
                return ret
        return FlowReturn.OK
