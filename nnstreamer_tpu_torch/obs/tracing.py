"""Span-based request tracing with cross-wire context propagation.

Port of nnstreamer_tpu/obs/tracing.py (stdlib only). The query layer
reads the wire helpers; obs/fleet.py drains the export queue (a pusher
requeues a batch it failed to send) and ingests a peer's spans into this
store (``ingest_remote``). The metrics answer "how slow is this element
on average"; they
cannot answer "where did *this* slow request spend its time" across
client → query wire → server pipeline → serving engine. This module is
the per-request complement: explicit span contexts (``trace_id`` /
``span_id`` / ``parent_id``), a lock-protected bounded span store with
**tail-based retention** (the slowest-N completed traces are always
kept alongside a ring of recent ones — tail-latency forensics wants
exactly the traces a uniform sample would evict), and the same
zero-overhead-when-disabled flag discipline as the metrics registry.

Context travels three ways:

  * **in-process** on ``Buffer.meta[CTX_META_KEY]`` — the source stamps
    a root span, every instrumented element chain opens a child
    (obs/instrument.py), sinks close the root;
  * **cross-thread** via a ``contextvars`` current-span slot set while
    an instrumented chain or a ``with start_span(...)`` body runs, so
    engine ``submit()`` calls made inside a traced chain join the
    trace without plumbing;
  * **cross-wire** as a ``trace`` field in query message meta
    (query/protocol.py) — the server adopts the remote parent, so one
    trace id spans both processes.

Span names are literal ``<layer>.<operation>`` lowercase dotted
strings (layer in {pipeline, query, serving, device}), linted by the
checks of scripts/check_metric_names.py alongside the metric names.

Exposition: ``GET /debug/traces`` (summaries, ``?min_ms=`` filter),
``GET /debug/traces/<trace_id>`` (full span tree) and
``GET /debug/pipeline`` (live topology + per-element span stats, the
DOT-dump analog) on the obs exporter. ``nns-launch --trace`` and
``PipelineTracer`` consume the same store. Stdlib only.
"""

from __future__ import annotations

import contextvars
import os
import threading
import time
from collections import OrderedDict
from collections import deque as _deque
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "Span", "SpanContext", "SpanStore", "CTX_META_KEY", "ROOT_META_KEY",
    "TRACE_META_KEY", "ctx_from_wire", "current_context", "disable",
    "enable", "enabled", "element_stats", "element_stats_report",
    "live_pipelines", "pipeline_topology", "register_pipeline",
    "stamp_buffer", "start_span", "store",
]

#: Buffer.meta key carrying the in-process parent SpanContext
CTX_META_KEY = "trace_ctx"
#: Buffer.meta key carrying the root Span a sink must close
ROOT_META_KEY = "trace_root"
#: wire meta key carrying {"tid": trace_id, "sid": span_id}
TRACE_META_KEY = "trace"


def _new_id() -> str:
    return os.urandom(8).hex()


class SpanContext:
    """Immutable (trace_id, span_id, parent_id) triple. ``parent_id``
    is None for a locally-rooted span; a remote parent (adopted off the
    wire) is a plain SpanContext whose ids came from the peer."""

    __slots__ = ("trace_id", "span_id", "parent_id")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id

    def to_wire(self) -> Dict[str, str]:
        """The meta["trace"] payload: trace id + this span as the
        remote parent. parent_id is a local concern and stays home."""
        return {"tid": self.trace_id, "sid": self.span_id}

    def __repr__(self) -> str:
        return (f"SpanContext({self.trace_id}, {self.span_id}, "
                f"parent={self.parent_id})")


def ctx_from_wire(d: Any) -> Optional[SpanContext]:
    """Adopt a remote parent from a wire ``trace`` field; None for a
    missing or malformed field (a peer must never crash the receiver
    with a bad trace blob)."""
    if not isinstance(d, dict):
        return None
    tid, sid = d.get("tid"), d.get("sid")
    if not isinstance(tid, str) or not isinstance(sid, str):
        return None
    return SpanContext(tid, sid)


#: current span context for the running thread of control — set while
#: an instrumented element chain or a ``with start_span(...)`` body
#: runs, read by send_message (wire injection) and LMEngine.submit
_current: "contextvars.ContextVar[Optional[SpanContext]]" = \
    contextvars.ContextVar("nnstpu_current_span", default=None)


def current_context() -> Optional[SpanContext]:
    return _current.get()


def _set_current(ctx: Optional[SpanContext]):
    return _current.set(ctx)


def _reset_current(token) -> None:
    _current.reset(token)


class Span:
    """One timed operation. Created by ``SpanStore.start_span``; calling
    ``end()`` (idempotent) records it into the store. Usable as a
    context manager: exceptions set ``error=True`` before ending."""

    __slots__ = ("name", "context", "start_ns", "end_ns", "wall",
                 "attrs", "tid", "_store", "_token")
    recording = True

    def __init__(self, store: "SpanStore", name: str, context: SpanContext,
                 attrs: Optional[Dict[str, Any]] = None):
        self._store = store
        self.name = name
        self.context = context
        self.attrs = dict(attrs) if attrs else {}
        self.start_ns = time.monotonic_ns()
        self.wall = time.time()
        self.end_ns: Optional[int] = None
        # creating thread: the Perfetto exporter lays host spans out in
        # one lane per pipeline thread
        self.tid = threading.get_ident()
        self._token = None

    def set_attribute(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def end(self) -> None:
        if self.end_ns is not None:
            return  # idempotent: tee'd buffers may reach two sinks
        self.end_ns = time.monotonic_ns()
        self._store._record(self)

    @property
    def duration_ns(self) -> int:
        return (self.end_ns or time.monotonic_ns()) - self.start_ns

    def __enter__(self) -> "Span":
        self._token = _set_current(self.context)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._token is not None:
            _reset_current(self._token)
            self._token = None
        if exc_type is not None:
            self.attrs["error"] = True
        self.end()


class _NoopSpan:
    """Returned when tracing is disabled: every operation is a no-op
    and ``context`` is None, so callers never stamp wire meta or buffer
    meta from it. One shared instance — zero allocation when off."""

    __slots__ = ()
    recording = False
    context = None
    name = ""
    attrs: Dict[str, Any] = {}
    duration_ns = 0

    def set_attribute(self, key: str, value: Any) -> None:
        pass

    def end(self) -> None:
        pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: Any) -> None:
        pass


NOOP_SPAN = _NoopSpan()


class _Trace:
    """Span accumulator for one trace id (store-internal; guarded by
    the store lock)."""

    __slots__ = ("spans", "start_ns", "end_ns", "root_name",
                 "duration_ns", "completed", "wall")

    def __init__(self) -> None:
        self.spans: List[Span] = []
        self.start_ns: Optional[int] = None
        self.end_ns: Optional[int] = None
        self.root_name: Optional[str] = None
        self.duration_ns: int = 0
        self.completed = False
        self.wall: Optional[float] = None


class SpanStore:
    """Thread-safe bounded trace store with tail-based retention.

    Capacity is ``max_traces`` recent traces PLUS up to ``keep_slowest``
    protected slots: when the ring wraps, the oldest trace NOT in the
    slowest-N set is evicted, so the worst tail survives arbitrarily
    long runs. A trace is *completed* when a locally-rooted span
    (parent_id None) ends; its duration ranks it. Remote-parented
    server-side traces complete on the client side in two-process
    deployments — in-proc tests see both halves in one store.
    """

    def __init__(self, max_traces: int = 256, keep_slowest: int = 16,
                 max_spans_per_trace: int = 512, enabled: bool = False,
                 sample_every: int = 1):
        self._lock = threading.Lock()
        self._traces: "OrderedDict[str, _Trace]" = OrderedDict()  # guarded-by: _lock
        self._slow: Dict[str, int] = {}  # trace_id->duration_ns # guarded-by: _lock
        self.max_traces = int(max_traces)
        self.keep_slowest = int(keep_slowest)
        self.max_spans_per_trace = int(max_spans_per_trace)
        self.sample_every = max(int(sample_every), 1)
        self._sample_n = 0
        self._enabled = bool(enabled)
        self._dropped_spans = 0
        # -- fleet span export (obs/fleet.py) --------------------------- #
        # Off until a fleet pusher flips it on: zero cost for plain
        # single-process tracing (one attribute read in _record against
        # an empty set). Traces are *marked* exportable when their id
        # crosses the query wire (or an engine opts a request in);
        # spans of marked traces queue — bounded, drop-oldest — for the
        # pusher to drain into the aggregator.
        self._export_on = False
        self._export_tids: "OrderedDict[str, None]" = OrderedDict()
        self._export_max_tids = 4096
        self._export_pending: "deque" = _deque(maxlen=2048)
        self._export_dropped = 0

    # -- enable/disable ------------------------------------------------ #
    @property
    def is_enabled(self) -> bool:
        return self._enabled

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def reset(self) -> None:
        with self._lock:
            self._traces.clear()
            self._slow.clear()
            self._sample_n = 0
            self._dropped_spans = 0
            self._export_tids.clear()
            self._export_pending.clear()
            self._export_dropped = 0

    # -- recording ----------------------------------------------------- #
    def start_span(self, name: str,
                   parent: Optional[SpanContext] = None,
                   attrs: Optional[Dict[str, Any]] = None):
        """Open a span; the single flag check is the whole disabled
        cost. ``parent=None`` roots a new trace."""
        if not self._enabled:
            return NOOP_SPAN
        if parent is not None:
            ctx = SpanContext(parent.trace_id, _new_id(), parent.span_id)
        else:
            ctx = SpanContext(_new_id(), _new_id(), None)
        return Span(self, name, ctx, attrs)

    def should_sample(self) -> bool:
        """Head sampling for buffer-rate roots: admit 1 of every
        ``sample_every`` new traces (tail retention still keeps the
        slowest of the admitted ones)."""
        if not self._enabled:
            return False
        if self.sample_every <= 1:
            return True
        with self._lock:
            self._sample_n += 1
            return self._sample_n % self.sample_every == 1

    def _record(self, span: Span) -> None:
        tid = span.context.trace_id
        with self._lock:
            tr = self._traces.get(tid)
            if tr is None:
                tr = _Trace()
                self._traces[tid] = tr
            if len(tr.spans) >= self.max_spans_per_trace:
                self._dropped_spans += 1
            else:
                tr.spans.append(span)
                if self._export_on and tid in self._export_tids:
                    if len(self._export_pending) == \
                            self._export_pending.maxlen:
                        self._export_dropped += 1
                    self._export_pending.append(_span_to_wire(span))
            if tr.start_ns is None or span.start_ns < tr.start_ns:
                tr.start_ns = span.start_ns
                tr.wall = span.wall
            if tr.end_ns is None or span.end_ns > tr.end_ns:
                tr.end_ns = span.end_ns
            if span.context.parent_id is None:
                tr.completed = True
                tr.root_name = span.name
                tr.duration_ns = span.end_ns - span.start_ns
                self._rank_slow(tid, tr.duration_ns)
            self._evict_locked()

    def _rank_slow(self, tid: str, duration_ns: int) -> None:  # guarded-by: _lock
        # maintain the protected slowest-N set (store lock held)
        prev = self._slow.get(tid)
        if prev is not None:
            if duration_ns > prev:
                self._slow[tid] = duration_ns
            return
        if len(self._slow) < self.keep_slowest:
            self._slow[tid] = duration_ns
            return
        fastest = min(self._slow, key=self._slow.get)
        if duration_ns > self._slow[fastest]:
            del self._slow[fastest]
            self._slow[tid] = duration_ns

    def _evict_locked(self) -> None:
        budget = self.max_traces + len(self._slow)
        while len(self._traces) > budget:
            victim = None
            for tid in self._traces:  # oldest-first insertion order
                if tid not in self._slow:
                    victim = tid
                    break
            if victim is None:
                return  # everything is protected; nothing to drop
            del self._traces[victim]

    # -- queries -------------------------------------------------------- #
    def summaries(self, min_ms: float = 0.0) -> List[Dict[str, Any]]:
        """Trace list, slowest first; ``min_ms`` filters on duration
        (completed traces only when a threshold is set — an open trace
        has no defensible duration yet)."""
        out = []
        with self._lock:
            items = list(self._traces.items())
        for tid, tr in items:
            dur_ms = tr.duration_ns / 1e6 if tr.completed else None
            if min_ms > 0.0 and (dur_ms is None or dur_ms < min_ms):
                continue
            out.append({
                "trace_id": tid,
                "root": tr.root_name,
                "completed": tr.completed,
                "duration_ms": dur_ms,
                "spans": len(tr.spans),
                "slowest_retained": tid in self._slow,
                "wall": tr.wall,
            })
        out.sort(key=lambda s: s["duration_ms"] or 0.0, reverse=True)
        return out

    def spans_of(self, trace_id: str) -> Optional[List[Span]]:
        with self._lock:
            tr = self._traces.get(trace_id)
            return list(tr.spans) if tr is not None else None

    def tree(self, trace_id: str) -> Optional[Dict[str, Any]]:
        """Full span tree for one trace: spans nest under their local
        parents; spans whose parent is remote (or unrecorded) surface
        as roots — exactly the view a cross-process half contributes."""
        spans = self.spans_of(trace_id)
        if spans is None:
            return None
        t0 = min(s.start_ns for s in spans) if spans else 0

        def node(s: Span) -> Dict[str, Any]:
            return {
                "span_id": s.context.span_id,
                "parent_id": s.context.parent_id,
                "name": s.name,
                "start_us": (s.start_ns - t0) / 1e3,
                "duration_us": (s.end_ns - s.start_ns) / 1e3,
                "attrs": s.attrs,
                "children": [],
            }

        by_id = {s.context.span_id: node(s) for s in spans}
        roots: List[Dict[str, Any]] = []
        for n in by_id.values():
            parent = by_id.get(n["parent_id"])
            if parent is not None:
                parent["children"].append(n)
            else:
                roots.append(n)
        for n in by_id.values():
            n["children"].sort(key=lambda c: c["start_us"])
        roots.sort(key=lambda c: c["start_us"])
        return {"trace_id": trace_id, "spans": len(spans), "tree": roots}

    def element_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-element stats over recorded ``pipeline.element`` spans:
        {element: {n, mean_us, max_us}} — the span-store view the
        /debug/pipeline endpoint and ``nns-launch --trace`` render."""
        agg: Dict[str, List[float]] = {}
        with self._lock:
            traces = list(self._traces.values())
        for tr in traces:
            for s in tr.spans:
                if s.name != "pipeline.element":
                    continue
                el = str(s.attrs.get("element", "?"))
                agg.setdefault(el, []).append(
                    (s.end_ns - s.start_ns) / 1e3)
        return {
            el: {"n": len(v), "mean_us": sum(v) / len(v), "max_us": max(v)}
            for el, v in agg.items()
        }

    def snapshot_spans(self, max_spans: int = 20000) -> List[Span]:
        """Flat snapshot of recorded spans across all retained traces
        (completed spans only), for timeline exporters (obs/profile.py's
        Perfetto view). Bounded: retention already caps traces, this
        caps the flattened view."""
        out: List[Span] = []
        with self._lock:
            for tr in self._traces.values():
                for s in tr.spans:
                    if s.end_ns is not None:
                        out.append(s)
                        if len(out) >= max_spans:
                            return out
        return out

    def add_span(self, name: str, trace_id: str, parent_id: Optional[str],
                 start_ns: int, end_ns: int,
                 attrs: Optional[Dict[str, Any]] = None,
                 wall: Optional[float] = None) -> Optional[SpanContext]:
        """Insert one already-timed span into an existing trace — the
        diag layer's entry for synthetic attribution spans (sched queue
        wait / batch run) whose endpoints were measured outside a
        ``with start_span(...)`` body. Timestamps are local monotonic
        ns; the span records immediately (bypassing ``end()``, which
        would re-stamp ``end_ns``). Returns the new span's context, or
        None when the store is disabled."""
        if not self._enabled:
            return None
        ctx = SpanContext(str(trace_id), _new_id(), parent_id or None)
        span = Span.__new__(Span)
        span._store = self
        span.name = str(name)
        span.context = ctx
        span.attrs = dict(attrs) if attrs else {}
        span.start_ns = int(start_ns)
        span.end_ns = max(int(end_ns), int(start_ns))
        span.wall = float(wall) if wall is not None else (
            time.time() - (time.monotonic_ns() - span.start_ns) / 1e9)
        span.tid = threading.get_ident()
        span._token = None
        self._record(span)
        return ctx

    # -- fleet span export/ingest (obs/fleet.py) ------------------------ #
    def set_export(self, on: bool) -> None:
        """Flip fleet span export. Off (the default) keeps _record's
        extra cost at one attribute read; turning off also drops any
        queued exports and marks."""
        with self._lock:
            self._export_on = bool(on)
            if not on:
                self._export_tids.clear()
                self._export_pending.clear()

    def mark_export(self, trace_id: Optional[str]) -> None:
        """Mark one trace's spans for fleet export — called where a
        trace id crosses the query wire (send injection / remote-parent
        adoption) and by a serving engine opting a request in. LRU-
        bounded; a no-op unless a fleet pusher enabled export."""
        if not self._export_on or not trace_id:
            return
        with self._lock:
            self._export_tids[trace_id] = None
            self._export_tids.move_to_end(trace_id)
            while len(self._export_tids) > self._export_max_tids:
                self._export_tids.popitem(last=False)

    def drain_export(self, max_n: int = 512) -> List[Dict[str, Any]]:
        """Pop up to ``max_n`` queued wire-format span dicts (oldest
        first) — the fleet pusher's per-push batch."""
        out: List[Dict[str, Any]] = []
        with self._lock:
            while self._export_pending and len(out) < int(max_n):
                out.append(self._export_pending.popleft())
        return out

    def requeue_export(self, spans: List[Dict[str, Any]]) -> None:
        """Put a drained batch back at the FRONT of the export queue —
        the pusher's failure path, so a briefly unreachable aggregator
        doesn't silently lose the spans it drained. Overflow evicts the
        newest queued entries (the requeued batch is older) and counts
        them as export drops."""
        if not spans:
            return
        with self._lock:
            if not self._export_on:
                return
            free = self._export_pending.maxlen - len(self._export_pending)
            overflow = len(spans) - free
            if overflow > 0:
                self._export_dropped += overflow
            for s in reversed(spans):
                self._export_pending.appendleft(s)

    def ingest_remote(self, spans: List[Dict[str, Any]],
                      instance: str) -> int:
        """Insert pushed wire-format spans from ``instance`` into this
        store so /debug/traces/<id> renders the cross-host tree.
        Remote timestamps arrive wall-clock-derived (monotonic clocks
        do not travel between hosts) and are rebased here into the
        local monotonic domain — local spans carry ``monotonic_ns``
        starts, and a trace holding both halves (aggregator tracing its
        own side of the same request) must not mix clock domains in
        tree() offsets or trace start/end rollups. Malformed entries
        are skipped, never raised — a peer must not 500 the aggregator.
        Returns the count actually ingested. Works on a disabled store:
        the aggregator exposes fleet traces without recording its own."""
        # one anchor per batch: local monotonic "now" minus wall "now";
        # remote wall ns + offset lands in the local monotonic domain
        # (to the accuracy of inter-host clock sync, the best we have)
        offset_ns = time.monotonic_ns() - int(time.time() * 1e9)
        n = 0
        for d in spans:
            try:
                ctx = SpanContext(str(d["tid"]), str(d["sid"]),
                                  d.get("par") or None)
                span = Span.__new__(Span)
                span._store = self
                span.name = str(d["name"])
                span.context = ctx
                span.attrs = dict(d.get("attrs") or {})
                span.attrs.setdefault("instance", instance)
                span.wall = float(d["wall"])
                span.start_ns = int(span.wall * 1e9) + offset_ns
                span.end_ns = span.start_ns + max(int(d["dur_ns"]), 0)
                span.tid = 0  # remote thread idents are meaningless here
                span._token = None
            except Exception:
                # the docstring's "never raised" is load-bearing: any
                # malformed field shape (not just the anticipated
                # KeyError/TypeError/ValueError) must skip the entry,
                # not 500 the aggregator
                continue
            # bypass Span.end(): end_ns is already set, record directly
            tid = span.context.trace_id
            with self._lock:
                tr = self._traces.get(tid)
                if tr is None:
                    tr = _Trace()
                    self._traces[tid] = tr
                if len(tr.spans) >= self.max_spans_per_trace:
                    self._dropped_spans += 1
                else:
                    tr.spans.append(span)
                if tr.start_ns is None or span.start_ns < tr.start_ns:
                    tr.start_ns = span.start_ns
                    tr.wall = span.wall
                if tr.end_ns is None or span.end_ns > tr.end_ns:
                    tr.end_ns = span.end_ns
                if span.context.parent_id is None:
                    tr.completed = True
                    tr.root_name = span.name
                    tr.duration_ns = span.end_ns - span.start_ns
                    self._rank_slow(tid, tr.duration_ns)
                self._evict_locked()
            n += 1
        return n


def _span_to_wire(span: Span) -> Dict[str, Any]:
    """Wire-format dict for one completed span: wall-clock start +
    duration (monotonic ns never leave the host), ids, name, attrs."""
    return {
        "tid": span.context.trace_id,
        "sid": span.context.span_id,
        "par": span.context.parent_id,
        "name": span.name,
        "wall": span.wall,
        "dur_ns": (span.end_ns or span.start_ns) - span.start_ns,
        "attrs": span.attrs,
    }


# --------------------------------------------------------------------------- #
# Process-global store + helpers
# --------------------------------------------------------------------------- #

#: disabled by default — mirror of the metrics registry: tracing costs
#: one flag check until NNSTPU_TRACE=1 or enable() turns it on
_STORE = SpanStore(enabled=os.environ.get("NNSTPU_TRACE", "") == "1")


def store() -> SpanStore:
    return _STORE


def enabled() -> bool:
    return _STORE._enabled


def enable(sample_every: Optional[int] = None) -> None:
    """Turn span recording on. Like metrics, call BEFORE building
    pipelines/starting them: element chains decide at Pipeline.start
    whether to open spans at all."""
    if sample_every is not None:
        _STORE.sample_every = max(int(sample_every), 1)
    _STORE.enable()


def disable() -> None:
    _STORE.disable()


def start_span(name: str, parent: Optional[SpanContext] = None,
               attrs: Optional[Dict[str, Any]] = None):
    return _STORE.start_span(name, parent=parent, attrs=attrs)


def stamp_buffer(buf: Any, span_store: SpanStore, source: str):
    """Root a new trace on a source-created buffer (obs/instrument.py
    source wrapper). A buffer that already carries a context — e.g. a
    serversrc inbox frame adopted off the wire — is left alone: the
    existing trace owns it."""
    if CTX_META_KEY in buf.meta:
        return None
    if not span_store.should_sample():
        return None
    root = span_store.start_span("pipeline.buffer", attrs={
        "source": source, "pts": buf.pts, "offset": buf.offset})
    if root.recording:
        buf.meta[CTX_META_KEY] = root.context
        buf.meta[ROOT_META_KEY] = root
    return root


# -- live pipeline topology (the DOT-dump analog) --------------------------- #

import weakref  # noqa: E402 — grouped with its single consumer

_live_pipelines: "weakref.WeakSet" = weakref.WeakSet()


def register_pipeline(pipeline: Any) -> None:
    """Called from the Pipeline.start instrumentation hook — a WeakSet
    add, so a collected pipeline never lingers in /debug/pipeline."""
    _live_pipelines.add(pipeline)


def live_pipelines() -> List[Any]:
    return list(_live_pipelines)


def pipeline_topology(pipeline: Any) -> Dict[str, Any]:
    """Elements + directed links of one pipeline, duck-typed off the
    graph model (element name/kind, src pad → peer element)."""
    elements = []
    for el in pipeline.elements.values():
        links = []
        for pad in el.src_pads:
            if pad.peer is not None:
                links.append(pad.peer.element.name)
        elements.append({
            "name": el.name,
            "kind": getattr(el, "ELEMENT_NAME", type(el).__name__),
            "is_source": el.is_source,
            "is_sink": el.is_sink,
            "links": links,
        })
    return {"name": pipeline.name, "running": pipeline.running,
            "elements": elements}


def element_stats(span_store: Optional[SpanStore] = None
                  ) -> Dict[str, Dict[str, float]]:
    return (span_store or _STORE).element_stats()


def element_stats_report(span_store: Optional[SpanStore] = None) -> str:
    """Text table of per-element span stats, slowest mean first — the
    shared renderer behind ``nns-launch --trace`` and
    ``PipelineTracer.span_report``."""
    stats = element_stats(span_store)
    lines = [f"{'element':<24}{'spans':>8}{'mean(us)':>12}{'max(us)':>12}"]
    for el, t in sorted(stats.items(),
                        key=lambda kv: kv[1]["mean_us"], reverse=True):
        lines.append(f"{el:<24}{t['n']:>8}{t['mean_us']:>12.1f}"
                     f"{t['max_us']:>12.1f}")
    return "\n".join(lines)
