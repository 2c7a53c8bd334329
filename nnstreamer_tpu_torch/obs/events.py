"""Flight recorder: a bounded ring of structured runtime events.

Port of nnstreamer_tpu/obs/events.py (stdlib only); its log bridge taps
the port's ``nns_tpu_torch`` logger tree. The third observability pillar
(after metrics and tracing): when a long-running pipeline wedges or dies,
the metrics say *how fast* it was and the traces say *where one request
went* — this ring says *what happened last*: element errors, pipeline
state changes, query reconnects, admission rejections, watchdog verdicts
(obs/health.py), and warning/error log records bridged from core/log.py.

Each event is a plain dict::

    {"seq": 17, "ts": 1722900000.123, "type": "pipeline.stall",
     "severity": "warning", "message": "sink stopped consuming",
     "trace_id": "ab12..." | None, "span_id": "cd34..." | None,
     "attrs": {...}}

``trace_id``/``span_id`` come from obs/tracing.py's current-context
contextvar at record time, so an event emitted inside an instrumented
element chain or a traced request correlates with its /debug/traces
entry for free. Event *types* are literal lowercase ``<layer>.<event>``
names (linted by the checks of scripts/check_metric_names.py next to
metric and span names).

Same contract as metrics/tracing: **off by default, one flag check
while off** — ``record()`` is a boolean test and a return. ``enable()``
(or ``NNSTPU_EVENTS=1``) additionally installs two passive taps:

  * a logging.Handler on the ``nns_tpu_torch`` logger bridging WARNING+
    records into the ring (``core.log`` events);
  * a ``threading.excepthook`` wrapper that dumps the ring to stderr
    when a pipeline-owned thread (source loop, queue worker, query
    reader/server, serving drain) dies on an unhandled exception —
    the crash context a daemon thread would otherwise take with it.

Exposition: ``GET /debug/events`` on the obs exporter (``?n=`` limits
to the newest N); ``nns-launch --events-dump PATH`` writes the ring as
JSON lines at exit (``-`` for the stderr text dump).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from . import tracing as _tracing

__all__ = [
    "EventRing", "disable", "dump", "dump_jsonl", "enable", "enabled",
    "record", "ring",
]

#: the port's logger tree (core/log.py); the bridge listens on its root
_LOGGER = "nns_tpu_torch"

#: default ring capacity — bounded memory however long the run
DEFAULT_CAPACITY = 512

#: thread-name prefixes owned by pipeline machinery: an unhandled
#: exception on one of these is a pipeline crash worth a ring dump
#: (src loops, queue/batch workers, query reader/server threads,
#: serversink drain, the health watchdog itself)
_PIPELINE_THREAD_PREFIXES = (
    "src:", "q:", "batch:", "qsink:", "qclient-reader:", "qsrv-",
    "obs-health-watchdog", "obs-fleet-push",
)


class EventRing:
    """Lock-protected bounded event journal. ``record`` is the only
    hot-path entry and costs one flag check when disabled."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 enabled: bool = False):
        self._lock = threading.Lock()
        self._dq: "deque[Dict[str, Any]]" = deque(maxlen=int(capacity))  # guarded-by: _lock
        self._enabled = bool(enabled)
        self._seq = 0  # guarded-by: _lock
        self._dropped = 0  # guarded-by: _lock

    # -- enable/disable ------------------------------------------------ #
    @property
    def is_enabled(self) -> bool:
        return self._enabled

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    @property
    def capacity(self) -> int:
        return self._dq.maxlen or 0

    @property
    def dropped(self) -> int:
        return self._dropped

    def reset(self) -> None:
        with self._lock:
            self._dq.clear()
            self._seq = 0
            self._dropped = 0

    # -- recording ----------------------------------------------------- #
    def record(self, etype: str, message: str, severity: str = "info",
               trace_id: Optional[str] = None, **attrs: Any) -> None:
        """Append one event; the flag check is the whole disabled cost.

        ``trace_id`` overrides the contextvar lookup — watchdog verdicts
        pass the stalled component's *last seen* trace id because the
        watchdog thread itself never runs inside a traced chain."""
        if not self._enabled:
            return
        ctx = _tracing.current_context()
        ev = {
            "seq": 0,  # assigned under the lock
            # both clock domains: wall ("ts") correlates events across
            # hosts in a fleet bundle, monotonic ("mono_ns") orders and
            # measures them locally without clock-step ambiguity
            "ts": time.time(),
            "mono_ns": time.monotonic_ns(),
            "type": etype,
            "severity": severity,
            "message": message,
            "trace_id": trace_id if trace_id is not None
            else (ctx.trace_id if ctx is not None else None),
            "span_id": ctx.span_id if ctx is not None else None,
            "attrs": attrs,
        }
        with self._lock:
            if len(self._dq) == self._dq.maxlen:
                self._dropped += 1
            ev["seq"] = self._seq
            self._seq += 1
            self._dq.append(ev)

    # -- queries ------------------------------------------------------- #
    def snapshot(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """Newest-last copy; ``limit`` keeps only the newest N."""
        with self._lock:
            out = list(self._dq)
        if limit is not None and limit >= 0:
            out = out[-limit:]
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._dq)


# --------------------------------------------------------------------------- #
# Process-global ring + taps
# --------------------------------------------------------------------------- #

_RING = EventRing(enabled=os.environ.get("NNSTPU_EVENTS", "") == "1")


def ring() -> EventRing:
    return _RING


def enabled() -> bool:
    return _RING._enabled


def record(etype: str, message: str, severity: str = "info",
           trace_id: Optional[str] = None, **attrs: Any) -> None:
    """Module-level recorder — THE call every emit site uses. The
    naming lint greps these call sites: keep the event type a literal
    lowercase ``<layer>.<event>`` string."""
    _RING.record(etype, message, severity, trace_id=trace_id, **attrs)


class _LogBridge(logging.Handler):
    """WARNING+ records from the ``nns_tpu_torch`` logger tree become
    ``core.log`` events — the "what was the code complaining about"
    half of a post-mortem dump."""

    def emit(self, rec: logging.LogRecord) -> None:
        try:
            record("core.log", rec.getMessage(),
                   severity=rec.levelname.lower(), logger=rec.name)
        except Exception:  # noqa: BLE001 — logging must never raise
            pass


_bridge: Optional[_LogBridge] = None
_prev_excepthook = None


def _excepthook(args) -> None:
    """threading.excepthook wrapper: a pipeline-owned thread dying on
    an unhandled exception records a ``pipeline.crash`` event and dumps
    the ring to stderr (daemon threads otherwise vanish silently)."""
    t = args.thread
    name = t.name if t is not None else ""
    if any(name.startswith(p) for p in _PIPELINE_THREAD_PREFIXES):
        record("pipeline.crash",
               f"unhandled {args.exc_type.__name__} in thread {name}: "
               f"{args.exc_value}", severity="error", thread=name)
        dump(sys.stderr)
    if _prev_excepthook is not None:
        _prev_excepthook(args)


def enable(capacity: Optional[int] = None) -> None:
    """Turn the flight recorder on and install the log bridge + thread
    excepthook taps. Idempotent. ``capacity`` resizes (and clears) the
    ring."""
    global _bridge, _prev_excepthook
    if capacity is not None and capacity != _RING.capacity:
        with _RING._lock:
            _RING._dq = deque(_RING._dq, maxlen=int(capacity))
    _RING.enable()
    if _bridge is None:
        _bridge = _LogBridge()
        _bridge.setLevel(logging.WARNING)
        logging.getLogger(_LOGGER).addHandler(_bridge)
    if _prev_excepthook is None:
        _prev_excepthook = threading.excepthook
        threading.excepthook = _excepthook


def disable() -> None:
    """Turn recording off and remove the taps (restores the previous
    threading.excepthook)."""
    global _bridge, _prev_excepthook
    _RING.disable()
    if _bridge is not None:
        logging.getLogger(_LOGGER).removeHandler(_bridge)
        _bridge = None
    if _prev_excepthook is not None:
        threading.excepthook = _prev_excepthook
        _prev_excepthook = None


# -- dumps ------------------------------------------------------------------ #

def dump(fp=None) -> None:
    """Human-readable dump, newest last (default: stderr)."""
    fp = fp or sys.stderr
    events = _RING.snapshot()
    print(f"-- flight recorder: {len(events)} event(s), "
          f"{_RING.dropped} dropped --", file=fp)
    for ev in events:
        ts = time.strftime("%H:%M:%S", time.localtime(ev["ts"]))
        extra = " ".join(f"{k}={v!r}" for k, v in ev["attrs"].items())
        tid = f" trace={ev['trace_id']}" if ev["trace_id"] else ""
        print(f"[{ts}] {ev['severity'].upper():<7} {ev['type']:<24} "
              f"{ev['message']}{(' ' + extra) if extra else ''}{tid}",
              file=fp)


def dump_jsonl(path: str) -> None:
    """Write the ring as JSON lines (one event per line)."""
    with open(path, "w", encoding="utf-8") as fh:
        for ev in _RING.snapshot():
            fh.write(json.dumps(ev, default=str) + "\n")
