"""Pipeline container + scheduler and the structural elements (queue/tee/join).

Scheduling model (GStreamer-equivalent, reduced):
  * each **source** element owns a pacing thread that pushes buffers
    downstream through chain calls (one streaming thread per branch);
  * a **queue** introduces a thread boundary: bounded ring + worker thread,
    producer blocks when full (backpressure) unless leaky;
  * **tee** fans out a branch; **join** merges first-come (reference
    gst/join/gstjoin.c semantics);
  * the **bus** carries errors/EOS out-of-band; ``run()`` drives a pipeline
    to EOS.

Python threads are fine here: per-buffer Python work is bookkeeping; the
compute is CUDA work that PyTorch enqueues asynchronously, and queues
between threads pass ``torch.Tensor`` handles (device-resident) without
copies.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Union

from ..core.buffer import Buffer, now_ns
from ..core.types import Caps
from ..core.log import logger
from ..obs import events as _events
from .element import (Element, FlowReturn, Pad, join_or_warn,
                      register_element, make_element)
from .events import Bus, Event, EventType, Message, MessageType

log = logger("pipeline")

#: process-default scheduler hook (nnstreamer_tpu_torch.sched.install sets /
#: clears this): called as ``hook(pipeline) -> Optional[DeviceEngine]``
#: when a pipeline WITHOUT an explicit ``scheduler=`` starts, so
#: ``nns-launch --sched`` reaches pipelines constructed anywhere. Disabled
#: cost: one global load + None check per Pipeline.start.
SCHED_PIPELINE_HOOK = None


class SourceElement(Element):
    """Base for sources: owns a thread calling ``create()`` until EOS/stop.

    Subclasses implement ``negotiate() -> Caps`` and
    ``create() -> Optional[Buffer]`` (None = EOS). ``live=True`` paces
    pushes to the buffer duration (camera-like); otherwise pushes as fast
    as downstream accepts (backpressure via queue/chain).
    """

    ELEMENT_NAME = "basesrc"

    def __init__(self, name: Optional[str] = None, **props: Any):
        self.live = False
        self.num_buffers = -1  # -1 = unlimited (gst num-buffers prop)
        super().__init__(name, **props)
        if not self.src_pads:
            self.add_src_pad()
        self._thread: Optional[threading.Thread] = None
        self._stop_flag = threading.Event()

    # vmethods ---------------------------------------------------------------
    def negotiate(self) -> Caps:
        raise NotImplementedError

    def create(self) -> Optional[Buffer]:
        raise NotImplementedError

    # lifecycle --------------------------------------------------------------
    def start(self) -> None:
        self._stop_flag.clear()
        self._thread = threading.Thread(target=self._loop, name=f"src:{self.name}",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop_flag.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            join_or_warn(t, self.name)
        self._thread = None

    def _loop(self) -> None:
        try:
            caps = self.negotiate()
            self.push_event_all(Event(EventType.STREAM_START))
            self.send_caps_all(caps)
        except Exception as e:  # noqa: BLE001
            self.post_error(f"negotiation failed: {e}", exc=e)
            return
        count = 0
        t0 = time.monotonic()
        while not self._stop_flag.is_set():
            if self.num_buffers >= 0 and count >= self.num_buffers:
                break
            try:
                buf = self.create()
            except Exception as e:  # noqa: BLE001
                self.post_error(f"create failed: {e}", exc=e)
                return
            if buf is None:
                break
            if self.live and buf.pts is not None:
                target = t0 + buf.pts / 1e9
                delay = target - time.monotonic()
                if delay > 0:
                    if self._stop_flag.wait(delay):
                        break
            ret = self.push(buf)
            count += 1
            if ret is FlowReturn.ERROR:
                return  # error already on bus
            if ret is FlowReturn.EOS:
                break
        self.push_event_all(Event.eos())


@register_element
class Queue(Element):
    """Thread-decoupling bounded queue with backpressure.

    ``max_size_buffers`` bounds occupancy; producer blocks when full unless
    ``leaky`` ("upstream" drops newest, "downstream" drops oldest) — GStreamer
    queue semantics, which tensor pipelines use for parallel branches.
    """

    ELEMENT_NAME = "queue"

    def __init__(self, name: Optional[str] = None, **props: Any):
        self.max_size_buffers = 16
        self.leaky: Optional[str] = None  # None | "upstream" | "downstream"
        super().__init__(name, **props)
        self.add_sink_pad()
        self.add_src_pad()
        self._dq: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._worker: Optional[threading.Thread] = None
        self._flushing = False

    def start(self) -> None:
        self._flushing = False
        self._worker = threading.Thread(target=self._drain, name=f"q:{self.name}",
                                        daemon=True)
        self._worker.start()

    def stop(self) -> None:
        with self._cv:
            self._flushing = True
            self._cv.notify_all()
        w = self._worker
        if w is not None and w is not threading.current_thread():
            join_or_warn(w, self.name)
        self._worker = None
        self._dq.clear()

    def _enqueue(self, item: Any) -> None:
        # leaky policies apply to buffers only; in-band events (CAPS/EOS)
        # must never be dropped or downstream never negotiates/terminates
        is_event = isinstance(item, Event)
        with self._cv:
            if not is_event:
                def occupancy() -> int:
                    return sum(1 for it in self._dq if isinstance(it, Buffer))

                if self.leaky == "upstream" and occupancy() >= self.max_size_buffers:
                    return  # drop newest
                while occupancy() >= self.max_size_buffers and not self._flushing:
                    if self.leaky == "downstream":
                        self._drop_oldest_buffer()
                        break
                    self._cv.wait(0.1)
            if self._flushing:
                return
            self._dq.append(item)
            self._cv.notify_all()

    def _drop_oldest_buffer(self) -> None:
        for i, it in enumerate(self._dq):
            if isinstance(it, Buffer):
                del self._dq[i]
                return

    def chain(self, pad: Pad, buf: Buffer) -> Optional[FlowReturn]:
        self._enqueue(buf)
        return FlowReturn.OK

    def health_probe(self) -> Dict[str, int]:
        """Occupancy/bound for the health watchdog's queue-dwell rule
        (obs/health.py) — a monitoring sample, unlocked like the qdepth
        gauge."""
        return {"depth": len(self._dq), "bound": int(self.max_size_buffers)}

    def on_caps(self, pad: Pad, caps: Caps) -> None:
        pad.caps = caps
        self._enqueue(Event.caps(caps))

    def handle_event(self, pad: Pad, event: Event) -> None:
        self._enqueue(event)

    def _event_entry(self, pad: Pad, event: Event) -> None:
        # EOS must flow through the queue in-order, not bypass it
        if event.type is EventType.EOS:
            self._enqueue(event)
            return
        super()._event_entry(pad, event)

    def _drain(self) -> None:
        while True:
            with self._cv:
                while not self._dq and not self._flushing:
                    self._cv.wait(0.1)
                if self._flushing:
                    return
                item = self._dq.popleft()
                self._cv.notify_all()
            if isinstance(item, Buffer):
                self.push(item)
            elif isinstance(item, Event):
                if item.type is EventType.EOS:
                    super()._event_entry(self.sink_pad, item)
                elif item.type is EventType.CAPS:
                    self.send_caps_all(item.data["caps"])
                else:
                    self.push_event_all(item)


@register_element
class Tee(Element):
    """1→N fan-out. Buffers are immutable so no copy is made."""

    ELEMENT_NAME = "tee"

    def __init__(self, name: Optional[str] = None, **props: Any):
        super().__init__(name, **props)
        self.add_sink_pad()

    def chain(self, pad: Pad, buf: Buffer) -> Optional[FlowReturn]:
        worst = FlowReturn.OK
        for i in range(len(self.src_pads)):
            ret = self.push(buf, i)
            if ret is FlowReturn.ERROR:
                worst = ret
        return worst


@register_element
class Join(Element):
    """N→1 first-come-wins fan-in (reference gst/join/gstjoin.c): forwards
    buffers from whichever sink pad delivers; caps taken from the first pad
    to negotiate, others must match."""

    ELEMENT_NAME = "join"

    def __init__(self, name: Optional[str] = None, **props: Any):
        super().__init__(name, **props)
        self.add_src_pad()
        self._caps_sent = False

    def on_caps(self, pad: Pad, caps: Caps) -> None:
        pad.caps = caps
        with self._lock:
            if not self._caps_sent:
                self._caps_sent = True
                self.send_caps_all(caps)

    def chain(self, pad: Pad, buf: Buffer) -> Optional[FlowReturn]:
        with self._lock:
            return self.push(buf)


class Pipeline:
    """Container + lifecycle manager for an element graph."""

    def __init__(self, name: str = "pipeline", scheduler: Any = None,
                 *, sched_weight: float = 1.0, sched_priority: int = 0,
                 sched_deadline_ms: Optional[float] = None,
                 device: Any = None):
        self.name = name
        self.elements: Dict[str, Element] = {}
        self.bus = Bus()
        self._sinks_eos: set = set()  # guarded-by: _lock
        self._lock = threading.Lock()
        self.running = False
        #: device handed to every element whose own device is unset
        #: (tensor_filter); None leaves each filter on its default, cuda
        self.device = device
        #: fuse transform→filter prologues (ops.fusion) and filter→decoder
        #: tails (ops.epilogue) into the filter's invoke at start
        self.auto_fuse = True
        self._fused_count = 0
        self._epilogue_count = 0
        #: opt-in multi-tenant dispatch (sched.DeviceEngine): when set,
        #: start() enrolls this pipeline as a tenant — its filters'
        #: invokes coalesce with other tenants' on one dispatch loop.
        #: None (default) keeps the direct per-filter dispatch path. The
        #: sched_* knobs are this tenant's fairness parameters
        #: (DeviceEngine.attach_pipeline reads them).
        self.scheduler = scheduler
        self.sched_weight = sched_weight
        self.sched_priority = sched_priority
        self.sched_deadline_ms = sched_deadline_ms
        self._sched_engine: Any = None

    # -- construction -------------------------------------------------------- #
    def add(self, *elements: Element) -> Union[Element, Sequence[Element]]:
        for el in elements:
            if el.name in self.elements:
                raise ValueError(f"duplicate element name {el.name!r}")
            self.elements[el.name] = el
            el.bus = self.bus
            el.pipeline = self
        return elements[0] if len(elements) == 1 else elements

    def get_by_name(self, name: str) -> Optional["Element"]:
        """Look up an element by its name (gst_bin_get_by_name analog)."""
        return self.elements.get(name)

    def add_new(self, kind: str, name: Optional[str] = None, **props: Any) -> Element:
        el = make_element(kind, element_name=name, **props)
        self.add(el)
        return el

    @staticmethod
    def link(*elements: Element) -> None:
        """Chain-link: a ! b ! c. Picks the first unlinked src/sink pad,
        requesting pads from tee/mux-style elements as needed."""
        for a, b in zip(elements, elements[1:]):
            a.free_src_pad().link(b.free_sink_pad())

    def add_linked(self, *elements: Element) -> Sequence[Element]:
        self.add(*elements)
        self.link(*elements)
        return elements

    # -- lifecycle ------------------------------------------------------------ #
    def start(self) -> None:
        if self.running:
            return
        with self._lock:
            # start() racing a late _sink_eos from the previous run must
            # not lose the wipe (set.clear vs add interleave)
            self._sinks_eos.clear()
        self.bus.clear()
        for el in self.elements.values():
            self._validate_links(el)
            el._quitting = False
            el.prepare()
            el._eos_pads.clear()
            for p in el.sink_pads + el.src_pads:
                p.eos = False
        if self.device is not None:
            for el in self.elements.values():
                el.set_default_device(self.device)
        if self.auto_fuse:
            from ..ops.fusion import fuse_chains

            self._fused_count = fuse_chains(self)
        # live telemetry (obs subsystem): wraps element chains into the
        # process-global registry ONLY when metrics, tracing or health are
        # enabled — when none is, chains stay the plain class methods and
        # the hot path pays exactly nothing (the no-op fast path tests pin)
        from ..obs.instrument import maybe_instrument_pipeline

        maybe_instrument_pipeline(self)
        # start non-sources first so threads/queues are ready, then sources
        try:
            for el in self.elements.values():
                if not el.is_source:
                    el.start()
                    el.started = True
            # epilogue fusion runs AFTER non-sources started (decoder
            # instances exist, filter backends are open) and BEFORE sched
            # enrollment (coalesce tokens must be final when the engine
            # starts keying batches)
            if self.auto_fuse:
                from ..ops.epilogue import fuse_epilogues

                self._epilogue_count = fuse_epilogues(self)
            # multi-tenant dispatch opt-in: enroll AFTER non-sources
            # started (filter backends are open) and BEFORE any source
            # thread pushes, so the first buffer already coalesces.
            # Explicit scheduler= wins; otherwise the process-default hook
            # (sched.install / nns-launch --sched) decides.
            sched = self.scheduler
            if sched is None and SCHED_PIPELINE_HOOK is not None:
                sched = SCHED_PIPELINE_HOOK(self)
            if sched is not None:
                sched.attach_pipeline(self)
                self._sched_engine = sched
            for el in self.elements.values():
                if el.is_source:
                    el.start()
                    el.started = True
        except Exception:
            # roll back: elements already started must not leak threads.
            # Sources first (mirroring stop()) and best-effort per element
            # so one failing stop cannot strand the rest.
            for el in sorted(self.elements.values(),
                             key=lambda e: not e.is_source):
                if el.started:
                    try:
                        el.stop()
                    except Exception:  # noqa: BLE001
                        log.exception("rollback stop failed for %s", el.name)
                    el.started = False
            if self._sched_engine is not None:
                self._sched_engine.detach_pipeline(self)
                self._sched_engine = None
            raise
        self.running = True
        # flight recorder (one flag check while off): state transitions
        # bracket the journal a post-mortem dump reads
        _events.record("pipeline.state", f"{self.name} PLAYING",
                       pipeline=self.name)

    def _validate_links(self, el: Element) -> None:
        for p in el.sink_pads + el.src_pads:
            if p.peer is None:
                raise ValueError(f"unlinked pad {p.full_name}")

    def stop(self) -> None:
        if not self.running:
            return
        for el in self.elements.values():
            el.request_stop()  # unblock cross-element waits before joins
        for el in self.elements.values():
            if el.is_source:
                el.stop()
                el.started = False
        for el in self.elements.values():
            if el.started:
                el.stop()
                el.started = False
        if self._sched_engine is not None:
            # after the element joins: chain threads are gone, so the
            # tenant's queue is quiescent — deregistration sheds any
            # stragglers rather than stranding their futures
            self._sched_engine.detach_pipeline(self)
            self._sched_engine = None
        self.running = False
        _events.record("pipeline.state", f"{self.name} stopped",
                       pipeline=self.name)

    def _sink_eos(self, el: Element) -> None:
        with self._lock:
            self._sinks_eos.add(el.name)
            n_sinks = sum(1 for e in self.elements.values() if e.is_sink)
            done = len(self._sinks_eos) >= n_sinks
        if done:
            self.bus.post(Message(MessageType.EOS, self.name))

    def wait_eos(self, timeout: Optional[float] = None) -> bool:
        return self.bus.wait_eos(timeout)

    def run(self, timeout: Optional[float] = None) -> None:
        """Start, wait for EOS (or error), stop. Raises on bus error."""
        self.start()
        try:
            if not self.wait_eos(timeout):
                raise TimeoutError(f"pipeline {self.name!r} did not reach EOS")
            err = self.bus.error
            if err is not None:
                exc = err.data.get("exception")
                raise PipelineError(f"{err.source}: {err.data.get('text')}") from exc
        finally:
            self.stop()

    def __getitem__(self, name: str) -> Element:
        return self.elements[name]

    def __enter__(self) -> "Pipeline":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.stop()


class PipelineError(RuntimeError):
    pass
