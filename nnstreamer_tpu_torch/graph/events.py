"""In-band events and bus messages for the pipeline runtime.

GStreamer equivalent: GstEvent (serialized in-band with buffers: CAPS before
first data, EOS at end, FLUSH) and GstMessage (out-of-band bus to the app).
QoS events travel *upstream* (sink→src) — tensor_rate uses them to throttle
tensor_filter (reference: gsttensorrate.c QoS + tensor_filter.c:425-480).
"""

from __future__ import annotations

import enum
import queue
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


class EventType(enum.Enum):
    STREAM_START = "stream-start"
    CAPS = "caps"
    SEGMENT = "segment"
    EOS = "eos"
    FLUSH = "flush"
    QOS = "qos"                    # upstream: throttling request
    RELOAD_MODEL = "reload-model"  # custom: tensor_filter hot swap (nnstreamer_plugin_api_filter.h:377-383)
    CUSTOM = "custom"


@dataclass
class Event:
    type: EventType
    data: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def caps(cls, caps: Any) -> "Event":
        return cls(EventType.CAPS, {"caps": caps})

    @classmethod
    def eos(cls) -> "Event":
        return cls(EventType.EOS)

    @classmethod
    def qos(cls, *, interval_ns: int) -> "Event":
        """Throttle request: upstream should emit at most one buffer per
        interval_ns (tensor_rate → tensor_filter contract)."""
        return cls(EventType.QOS, {"interval_ns": interval_ns})

    @classmethod
    def reload_model(cls, model: Any) -> "Event":
        return cls(EventType.RELOAD_MODEL, {"model": model})


class MessageType(enum.Enum):
    ERROR = "error"
    WARNING = "warning"
    EOS = "eos"
    STATE_CHANGED = "state-changed"
    ELEMENT = "element"  # element-specific (e.g. tensor_sink stats)


@dataclass
class Message:
    type: MessageType
    source: str
    data: Dict[str, Any] = field(default_factory=dict)


class Bus:
    """Out-of-band message channel from elements to the app/pipeline."""

    def __init__(self) -> None:
        self._q: "queue.Queue[Message]" = queue.Queue()
        self._eos = threading.Event()
        self._error: Optional[Message] = None
        self._lock = threading.Lock()

    def post(self, msg: Message) -> None:
        if msg.type is MessageType.EOS:
            self._eos.set()
        elif msg.type is MessageType.ERROR:
            with self._lock:
                if self._error is None:
                    self._error = msg
            self._eos.set()  # error terminates waits too
        self._q.put(msg)

    def pop(self, timeout: Optional[float] = 0) -> Optional[Message]:
        try:
            return self._q.get(timeout=timeout) if timeout else self._q.get_nowait()
        except queue.Empty:
            return None

    @property
    def error(self) -> Optional[Message]:
        with self._lock:
            return self._error

    def wait_eos(self, timeout: Optional[float] = None) -> bool:
        return self._eos.wait(timeout)

    def clear(self) -> None:
        self._eos.clear()
        with self._lock:
            self._error = None
        while self.pop():
            pass
