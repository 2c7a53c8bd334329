"""Element-chain instrumentation: wraps a pipeline's elements so every
buffer feeds the metrics registry — and, when tracing is on, the span
store.

Port of nnstreamer_tpu/obs/instrument.py, unchanged in behaviour.

One mechanism serves three consumers: ``Pipeline.start`` attaches it to
the process-global registry when metrics are enabled (always-on
telemetry for the exporter), ``PipelineTracer`` attaches it to a
private registry for a per-run report, and the tracing subsystem rides
the same wrap to open a ``pipeline.element`` span per chain call. All
metric consumers see the same series:

  * ``nnstpu_pipeline_buffers_total{element}`` — buffers entering chain
  * ``nnstpu_pipeline_proctime_seconds{element}`` — chain latency
    histogram (GstShark ``proctime`` analog)
  * ``nnstpu_pipeline_interlatency_seconds{element}`` — source-stamp to
    chain-entry latency (GstShark ``interlatency`` analog)
  * ``nnstpu_pipeline_errors_total{element}`` — chain errors/exceptions
  * ``nnstpu_pipeline_queue_depth{element}`` — queue occupancy, read at
    collection time (zero hot-path cost)

Span flow (obs/tracing.py): sources stamp a ``pipeline.buffer`` root
context onto ``Buffer.meta`` (unless the buffer already carries one —
a serversrc frame adopted off the wire keeps its remote trace), each
element chain opens a ``pipeline.element`` child and re-points the
buffer context at itself (so a linear chain renders as a linear tree),
and sink elements close the root. While a chain runs, its span is the
thread's *current* context, so nested work (an engine ``submit``, a
query send) joins the trace automatically.

When the health model (obs/health.py) is on, the same wrap stamps a
per-element heartbeat (``Component.beat()``) plus the buffer's trace
id per chain call, feeding the stall watchdog — and each element gets
a health component whose probe reports pipeline run/EOS state and any
element-specific ``health_probe()`` data (queue depth/bound).

The disabled fast path is structural: when neither metrics, tracing,
nor health are on at start time nothing here runs, element
``_chain_entry`` stays the plain class method, and the hot path pays
nothing (tests/test_obs.py pins this for the JAX package,
tests/test_torch_obs.py for the port).

The profiler (obs/profile.py) deliberately does NOT ride this wrap: it
times chains through ``graph.element.PROFILE_CHAIN_HOOK`` (the chaos-
hook pattern — installed on ``profile.enable()``, None when off), so a
profile-only capture needs no pipeline restart and adds nothing to the
wrap above. Its host-lane element records are the tracing-off fallback
for ``/debug/profile``; with tracing on, the richer
``pipeline.element`` spans opened here are the host lanes.
"""

from __future__ import annotations

import time
from typing import Any, Optional

from . import health as _health
from . import tracing as _tracing
from .metrics import MetricsRegistry, registry as _global_registry

__all__ = ["instrument_pipeline", "maybe_instrument_pipeline"]


def _families(reg: MetricsRegistry):
    return {
        "bufs": reg.counter(
            "nnstpu_pipeline_buffers_total",
            "Buffers entering each element's chain", ("element",)),
        "proc": reg.histogram(
            "nnstpu_pipeline_proctime_seconds",
            "Per-element chain processing time", ("element",)),
        "inter": reg.histogram(
            "nnstpu_pipeline_interlatency_seconds",
            "Latency from source stamp to element chain entry",
            ("element",)),
        "errs": reg.counter(
            "nnstpu_pipeline_errors_total",
            "Chain errors (exceptions or FlowReturn.ERROR) per element",
            ("element",)),
        "qdepth": reg.gauge(
            "nnstpu_pipeline_queue_depth",
            "Queue element occupancy (buffers)", ("element",)),
    }


def _wrapped_registries(el: Any) -> list:
    regs = el.__dict__.get("_obs_registries")
    if regs is None:
        regs = []
        el._obs_registries = regs
    return regs


def instrument_pipeline(pipeline: Any,
                        reg: Optional[MetricsRegistry] = None,
                        span_store: Optional["_tracing.SpanStore"] = None,
                        health: Optional["_health.HealthRegistry"] = None
                        ) -> None:
    """Wrap every element of ``pipeline`` to record into ``reg`` (the
    process-global registry by default); when ``span_store`` is given,
    open per-element spans into it; when ``health`` is given, register
    a component per element and heartbeat it per buffer. Idempotent
    per (element, registry): safe across restarts and combined tracer
    + exporter use (each consumer's wrap records to its own
    registry)."""
    from ..core.buffer import Buffer
    from ..graph.element import FlowReturn
    from ..graph.pipeline import Queue

    if reg is None:
        reg = _global_registry()
    fams = _families(reg)
    for el in pipeline.elements.values():
        regs = _wrapped_registries(el)
        if any(r is reg for r in regs):
            continue
        regs.append(reg)
        comp = None
        if health is not None:
            comp = health.component(
                f"element:{pipeline.name}:{el.name}", kind="element",
                probe=_health.element_probe(pipeline, el),
                attrs={"element": el.name, "pipeline": pipeline.name})
        if isinstance(el, Queue):
            # collection-time callback — queues' own locking protects
            # len() reads well enough for a monitoring sample
            fams["qdepth"].labels(el.name).set_function(
                lambda _el=el: len(_el._dq))
        if el.is_source:
            orig_create = getattr(el, "create", None)
            if orig_create is not None:
                def create_stamped(_orig=orig_create, _el=el,
                                   _spans=span_store, _comp=comp):
                    buf = _orig()
                    if buf is not None:
                        buf.meta.setdefault("trace_t0_ns",
                                            time.monotonic_ns())
                        if _spans is not None:
                            _tracing.stamp_buffer(buf, _spans, _el.name)
                        if _comp is not None:
                            _comp.beat()
                            ctx = buf.meta.get(_tracing.CTX_META_KEY)
                            if ctx is not None:
                                _comp.last_trace_id = ctx.trace_id
                    return buf

                el.create = create_stamped
            continue
        bufs = fams["bufs"].labels(el.name)
        proc = fams["proc"].labels(el.name)
        inter = fams["inter"].labels(el.name)
        errs = fams["errs"].labels(el.name)
        orig = el._chain_entry

        def timed_chain(pad, buf, _orig=orig, _bufs=bufs, _proc=proc,
                        _inter=inter, _errs=errs, _spans=span_store,
                        _comp=comp, _name=el.name, _sink=el.is_sink):
            is_buf = isinstance(buf, Buffer)
            t0 = buf.meta.get("trace_t0_ns") if is_buf else None
            start = time.monotonic_ns()
            if t0 is not None:
                _inter.observe((start - t0) / 1e9)
            _bufs.inc()
            if _comp is not None:
                # heartbeat + last-seen trace id: the watchdog's stall
                # rule reads the beat age; its verdict event carries
                # the trace that stopped moving
                _comp.beat()
                if is_buf:
                    hctx = buf.meta.get(_tracing.CTX_META_KEY)
                    if hctx is not None:
                        _comp.last_trace_id = hctx.trace_id
            span = None
            token = None
            if _spans is not None and is_buf:
                parent = buf.meta.get(_tracing.CTX_META_KEY)
                if parent is not None:
                    span = _spans.start_span(
                        "pipeline.element", parent=parent,
                        attrs={"element": _name})
                    if span.recording:
                        # linear chains render as linear trees: the
                        # next element parents onto THIS span
                        buf.meta[_tracing.CTX_META_KEY] = span.context
                        token = _tracing._set_current(span.context)
                    else:
                        span = None
            try:
                ret = _orig(pad, buf)
            except Exception:
                _errs.inc()
                if span is not None:
                    span.set_attribute("error", True)
                raise
            finally:
                if token is not None:
                    _tracing._reset_current(token)
                if span is not None:
                    span.end()
                if _sink and is_buf:
                    # the buffer reached a sink: close its root span
                    # (idempotent — tee'd buffers hit several sinks)
                    root = buf.meta.get(_tracing.ROOT_META_KEY)
                    if root is not None:
                        root.end()
            _proc.observe((time.monotonic_ns() - start) / 1e9)
            if ret is FlowReturn.ERROR:
                _errs.inc()
            return ret

        el._chain_entry = timed_chain


def maybe_instrument_pipeline(pipeline: Any) -> None:
    """Pipeline.start hook: attach to the global registry iff metrics,
    tracing, OR health are enabled — the structural no-op fast path
    when none are. (Metrics recording into a disabled registry is
    itself a flag-check no-op, so a tracing- or health-only run costs
    no metric state.) Also registers the pipeline for /debug/pipeline
    topology — a WeakSet add, unconditionally cheap."""
    _tracing.register_pipeline(pipeline)
    spans = _tracing.store() if _tracing.enabled() else None
    health = _health.registry() if _health.enabled() else None
    if health is not None:
        # readiness: "pipeline PLAYING" flips true at the end of start
        _health.track_pipeline(pipeline)
    if _global_registry().is_enabled or spans is not None \
            or health is not None:
        instrument_pipeline(pipeline, span_store=spans, health=health)
