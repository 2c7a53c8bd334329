"""Element/Pad model — the pipeline's structural core.

This re-implements what the reference gets from
GStreamer (GstElement/GstPad/GstBaseTransform): typed pads, caps negotiation
via in-band CAPS events, push-mode dataflow, EOS propagation, and upstream
QoS events. Elements are single-responsibility nodes; heavy math lives in
the torch modules and CUDA kernels the elements dispatch to, so Python-side
work per buffer is bookkeeping only.

Flow model (simplified from GStreamer, same semantics for our graphs):
  * src pad ``push(buffer)`` → peer sink pad → owner ``chain(pad, buffer)``.
  * events travel in-band downstream (STREAM_START, CAPS, EOS, FLUSH) or
    upstream (QOS, RELOAD_MODEL) via ``push_event``.
  * a chain error posts an ERROR bus message and returns FlowReturn.ERROR
    upstream, stopping sources (GST_FLOW_ERROR; tensor_filter.c:494-520).
  * invoke soft-failure: an element may *drop* a buffer by returning
    normally without pushing (reference ret>0 drop, tensor_filter.c:702-705).
"""

from __future__ import annotations

import enum
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..core.buffer import Buffer
from ..core.types import Caps
from ..core.log import logger
from ..obs import events as _events
from .events import Bus, Event, EventType, Message, MessageType

log = logger("element")

def join_or_warn(t: threading.Thread, owner: str,
                 timeout: float = 5.0) -> bool:
    """Join a worker thread with a bounded wait; a timeout logs a
    WARNING and records a ``pipeline.thread_leak`` event instead of
    abandoning the thread invisibly (a leaked daemon worker keeps its
    element state alive and can wake on a reused port/queue later).
    Returns True when the thread actually exited."""
    t.join(timeout=timeout)
    if not t.is_alive():
        return True
    log.warning("%s: thread %r did not exit within %.1fs — leaked",
                owner, t.name, timeout)
    _events.record("pipeline.thread_leak",
                   f"{owner}: thread {t.name!r} did not exit within "
                   f"{timeout:.1f}s", severity="warning",
                   element=owner, thread=t.name)
    return False


#: profiler timing point (obs/profile.py installs/clears this): called
#: as ``hook(peer_pad, buf)`` IN PLACE of ``peer.element._chain_entry``
#: — it runs the chain itself, timed, and returns the chain's
#: FlowReturn. Disabled cost: one global load + None check.
PROFILE_CHAIN_HOOK = None


class FlowReturn(enum.Enum):
    OK = "ok"
    EOS = "eos"
    ERROR = "error"
    FLUSHING = "flushing"


class PadDirection(enum.Enum):
    SRC = "src"
    SINK = "sink"


class Pad:
    def __init__(self, element: "Element", name: str, direction: PadDirection,
                 template: Optional[Caps] = None):
        self.element = element
        self.name = name
        self.direction = direction
        self.template = template
        self.peer: Optional["Pad"] = None
        self.caps: Optional[Caps] = None  # negotiated
        self.eos = False

    @property
    def full_name(self) -> str:
        return f"{self.element.name}.{self.name}"

    # -- linking ------------------------------------------------------------ #
    def link(self, sink: "Pad") -> None:
        if self.direction is not PadDirection.SRC or sink.direction is not PadDirection.SINK:
            raise ValueError(f"link must be src→sink: {self.full_name}→{sink.full_name}")
        if self.peer is not None or sink.peer is not None:
            raise ValueError(f"pad already linked: {self.full_name} or {sink.full_name}")
        if self.template is not None and sink.template is not None \
                and self.template.intersect(sink.template) is None:
            raise ValueError(
                f"incompatible pad templates: {self.full_name}({self.template}) vs "
                f"{sink.full_name}({sink.template})")
        self.peer = sink
        sink.peer = self

    # -- dataflow ----------------------------------------------------------- #
    def push(self, buf: Buffer) -> FlowReturn:
        """Push a buffer from this SRC pad to the linked sink pad."""
        peer = self.peer
        if peer is None:
            return FlowReturn.ERROR
        if peer.eos:
            return FlowReturn.EOS
        try:
            if PROFILE_CHAIN_HOOK is not None:
                ret = PROFILE_CHAIN_HOOK(peer, buf)
            else:
                ret = peer.element._chain_entry(peer, buf)
            return ret if ret is not None else FlowReturn.OK
        except Exception as e:  # noqa: BLE001 — element errors become bus messages
            peer.element.post_error(f"chain error: {type(e).__name__}: {e}", exc=e)
            return FlowReturn.ERROR

    def push_event(self, event: Event) -> None:
        """Send an in-band event downstream (SRC pad) or upstream (SINK pad)."""
        peer = self.peer
        if peer is None:
            return
        if self.direction is PadDirection.SRC:
            peer.element._event_entry(peer, event)
        else:
            peer.element._upstream_event_entry(peer, event)


class Element:
    """Base element. Subclasses declare pads in __init__ and override
    ``chain`` / ``on_caps`` / ``handle_event`` / ``start`` / ``stop``."""

    ELEMENT_NAME = "element"
    _instance_counter: Dict[str, int] = {}
    _counter_lock = threading.Lock()

    def __init__(self, name: Optional[str] = None, **props: Any):
        if name is None:
            with Element._counter_lock:
                n = Element._instance_counter.get(self.ELEMENT_NAME, 0)
                Element._instance_counter[self.ELEMENT_NAME] = n + 1
            name = f"{self.ELEMENT_NAME}{n}"
        self.name = name
        self.sink_pads: List[Pad] = []
        self.src_pads: List[Pad] = []
        self.bus: Optional[Bus] = None  # set by Pipeline.add
        self.pipeline: Optional[Any] = None
        self.started = False
        self._quitting = False  # set by Pipeline.stop's pre-pass
        #: scheduler executor (sched.DeviceEngine attach): None on the
        #: un-scheduled path — consumers gate on it, so the default hot
        #: path pays one attribute None check
        self._sched_exec = None
        self._lock = threading.RLock()
        self._eos_pads: set = set()
        self._unknown_props = {}
        self.set_properties(**props)

    # -- properties --------------------------------------------------------- #
    #: universally-accepted gst no-op props: every GstElement/BaseSink has
    #: these and the reference's SSAT strings set them freely (silent=TRUE,
    #: filesink sync=true …); they carry no behavior here but must not
    #: fail verbatim pipeline strings. Elements with real semantics for
    #: one (e.g. tensor_rate silent) simply shadow it with an attribute.
    # gst scheduling/buffering knobs with no analog in this runtime
    # (every sink here is already unbuffered and clock-free)
    _GST_NOOP_PROPS = frozenset({"silent", "sync", "async", "qos", "buffer_mode"})

    def set_properties(self, **props: Any) -> None:
        """GObject-property equivalent: kwargs map to attributes. Unknown
        properties raise (reference: malformed props must fail; SSAT negative
        tests rely on this)."""
        for k, v in props.items():
            attr = k.replace("-", "_")
            setter = getattr(self, f"_set_prop_{attr}", None)
            if setter is not None:
                setter(v)
            elif hasattr(self, attr) and not attr.startswith("_"):
                setattr(self, attr, v)
            elif attr in self._GST_NOOP_PROPS:
                setattr(self, attr, v)
            else:
                raise ValueError(f"{self.ELEMENT_NAME}: unknown property {k!r}")

    # -- pad management ----------------------------------------------------- #
    def add_sink_pad(self, name: str = "sink", template: Optional[Caps] = None) -> Pad:
        pad = Pad(self, name, PadDirection.SINK, template)
        self.sink_pads.append(pad)
        return pad

    def add_src_pad(self, name: str = "src", template: Optional[Caps] = None) -> Pad:
        pad = Pad(self, name, PadDirection.SRC, template)
        self.src_pads.append(pad)
        return pad

    def free_sink_pad(self) -> Pad:
        """First unlinked sink pad, requesting a new one if none (the
        link-time pad selection shared by Pipeline.link and the textual
        parser)."""
        pad = next((q for q in self.sink_pads if q.peer is None), None)
        return pad if pad is not None else self.request_sink_pad()

    def free_src_pad(self) -> Pad:
        """First unlinked src pad, requesting a new one if none."""
        pad = next((q for q in self.src_pads if q.peer is None), None)
        return pad if pad is not None else self.request_src_pad()

    def request_sink_pad(self) -> Pad:
        """For N-input elements (mux/merge/join): new sink pad on demand."""
        return self.add_sink_pad(f"sink_{len(self.sink_pads)}")

    def request_src_pad(self) -> Pad:
        """For N-output elements (tee/demux/split): new src pad on demand."""
        return self.add_src_pad(f"src_{len(self.src_pads)}")

    @property
    def sink_pad(self) -> Pad:
        return self.sink_pads[0]

    @property
    def src_pad(self) -> Pad:
        return self.src_pads[0]

    @property
    def is_source(self) -> bool:
        return not self.sink_pads

    @property
    def is_sink(self) -> bool:
        return not self.src_pads

    # -- lifecycle ---------------------------------------------------------- #
    def prepare(self) -> None:
        """Pre-start phase: Pipeline.start calls this on EVERY element
        before ANY element's start() runs (so before any source thread
        exists). Reset process-global state here (e.g. repo slots) —
        doing it in start()/negotiate() would race already-running
        producers."""

    def start(self) -> None:  # override for resource acquisition
        pass

    def stop(self) -> None:  # override for teardown
        pass

    def request_stop(self) -> None:
        """Pre-stop broadcast: Pipeline.stop calls this on EVERY element
        BEFORE joining any thread, so chain()s blocked inside another
        element (rendezvous slots, backpressure waits) can bail out
        promptly instead of stalling the source joins. Overrides should
        call super() and wake their condition variables."""
        self._quitting = True

    def set_default_device(self, device: Any) -> None:
        """Offered to every element by a Pipeline constructed with
        ``device=``. Elements without device work ignore it;
        tensor_filter adopts it when its own ``device`` is unset."""

    # -- scheduler opt-in (sched/engine.py DeviceEngine.attach_pipeline) ---- #
    def sched_enroll(self, engine: Any, tenant: Any) -> None:
        """Offered to every element when its pipeline attaches to a
        DeviceEngine. Base elements have no device work to route —
        tensor_filter overrides to install ``self._sched_exec`` so its
        invokes coalesce across tenants. Must be idempotent."""

    def sched_detach(self) -> None:
        """Inverse of ``sched_enroll``: back to direct dispatch."""
        self._sched_exec = None

    # -- entry points (locking + dispatch) ----------------------------------- #
    def _chain_entry(self, pad: Pad, buf: Buffer) -> Optional[FlowReturn]:
        return self.chain(pad, buf)

    def _event_entry(self, pad: Pad, event: Event) -> None:
        if event.type is EventType.CAPS:
            self.on_caps(pad, event.data["caps"])
            return
        if event.type is EventType.EOS:
            with self._lock:
                pad.eos = True
                self._eos_pads.add(pad.name)
                all_eos = len(self._eos_pads) >= len(self.sink_pads)
            if all_eos:
                try:
                    self.on_eos()
                except Exception as e:  # noqa: BLE001 — any flush failure
                    # must surface on the bus, and EOS must still propagate,
                    # or downstream never terminates and run() hits timeout
                    self.post_error(f"eos flush error: {type(e).__name__}: {e}",
                                    exc=e)
                if self.is_sink:
                    self.post_message(MessageType.ELEMENT, {"event": "eos"})
                    if self.pipeline is not None:
                        self.pipeline._sink_eos(self)
                else:
                    self.push_event_all(Event.eos())
            return
        self.handle_event(pad, event)

    def _upstream_event_entry(self, pad: Pad, event: Event) -> None:
        self.handle_upstream_event(pad, event)

    # -- vmethods ------------------------------------------------------------ #
    def chain(self, pad: Pad, buf: Buffer) -> Optional[FlowReturn]:
        """Process one buffer arriving on ``pad``. Default: passthrough."""
        return self.push(buf)

    def on_caps(self, pad: Pad, caps: Caps) -> None:
        """Handle CAPS on a sink pad. Default: passthrough caps downstream."""
        pad.caps = caps
        self.send_caps_all(caps)

    def on_eos(self) -> None:
        """Called once when all sink pads reached EOS (before forwarding)."""

    def handle_event(self, pad: Pad, event: Event) -> None:
        """Non-CAPS/EOS downstream events. Default: forward."""
        self.push_event_all(event)

    def handle_upstream_event(self, pad: Pad, event: Event) -> None:
        """Upstream events (QOS, RELOAD_MODEL). Default: forward further up."""
        for sp in self.sink_pads:
            sp.push_event(event)

    # -- helpers ------------------------------------------------------------- #
    def push(self, buf: Buffer, pad_index: int = 0) -> FlowReturn:
        if not self.src_pads:
            return FlowReturn.OK
        return self.src_pads[pad_index].push(buf)

    def push_event_all(self, event: Event) -> None:
        for sp in self.src_pads:
            sp.push_event(event)

    def send_caps(self, caps: Caps, pad_index: int = 0) -> None:
        if self.src_pads:
            pad = self.src_pads[pad_index]
            pad.caps = caps
            pad.push_event(Event.caps(caps))

    def send_caps_all(self, caps: Caps) -> None:
        for i in range(len(self.src_pads)):
            self.send_caps(caps, i)

    def post_message(self, mtype: MessageType, data: Optional[dict] = None) -> None:
        if self.bus is not None:
            self.bus.post(Message(mtype, self.name, data or {}))

    def post_error(self, text: str, exc: Optional[BaseException] = None) -> None:
        log.error("[%s] %s", self.name, text, exc_info=exc)
        # flight recorder (obs/events.py, one flag check while off):
        # recorded from an instrumented chain this carries the failing
        # buffer's trace id via the current-context stamp
        _events.record("pipeline.error", f"{self.name}: {text}",
                       severity="error", element=self.name)
        if self.bus is not None:
            self.bus.post(Message(MessageType.ERROR, self.name,
                                  {"text": text, "exception": exc}))

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r}>"


# --------------------------------------------------------------------------- #
# Element class registry (for the textual pipeline parser / gst-launch CLI)
# --------------------------------------------------------------------------- #

_element_classes: Dict[str, type] = {}


def register_element(cls: type) -> type:
    """Class decorator: register under cls.ELEMENT_NAME (the reference's
    element registration in registerer/nnstreamer.c:88-114)."""
    _element_classes[cls.ELEMENT_NAME] = cls
    return cls


def element_class(name: str) -> Optional[type]:
    if name not in _element_classes:
        # lazily pull in built-ins on first miss
        from .. import _register_builtins

        _register_builtins()
    return _element_classes.get(name)


def make_element(name: str, element_name: Optional[str] = None, **props: Any) -> Element:
    cls = element_class(name)
    if cls is None:
        raise ValueError(f"unknown element type {name!r}")
    return cls(name=element_name, **props)


def all_element_names() -> List[str]:
    from .. import _register_builtins

    _register_builtins()
    return sorted(_element_classes)
