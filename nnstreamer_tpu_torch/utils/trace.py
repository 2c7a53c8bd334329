"""Pipeline tracing & profiling.

Port of nnstreamer_tpu/utils/trace.py. Reference (SURVEY §5): no in-tree
tracer; users attach GstShark tracers (``interlatency``, ``proctime``)
plus per-filter invoke stats. Here the mechanism is the obs subsystem: ``PipelineTracer`` is a thin consumer
of a ``MetricsRegistry`` — it attaches the same element-chain
instrumentation the live ``/metrics`` exporter uses
(obs/instrument.py), records into a private registry, and renders a
per-run report from its snapshot. One wrapping mechanism, two
consumers; no parallel bookkeeping.

    tracer = PipelineTracer.attach(pipeline)
    pipeline.run()
    print(tracer.report())

``attach(pipeline, spans=True)`` additionally records per-element
spans into a private ``SpanStore`` (obs/tracing.py) — the same store
machinery behind ``/debug/traces`` — and ``span_report()`` renders the
per-element span table. Private means private: neither the global
metrics registry nor the global trace store sees a tracer's data.

``device_trace`` brackets a run with ``torch.profiler`` (CUDA activity on
the card, CPU activity always) and writes a Chrome trace into the logdir,
where the JAX package runs ``jax.profiler`` for xprof. When global tracing
is enabled it also opens the same ``device.xprof`` span carrying the
logdir, so a device timeline can be joined to the wire-level trace that
was active when profiling started (``trace_id`` attribute on the context
manager after ``__enter__``).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

from ..obs import tracing as _tracing
from ..obs.instrument import instrument_pipeline
from ..obs.metrics import MetricsRegistry


class PipelineTracer:
    """Per-run proctime/interlatency report over a private registry."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 span_store: Optional[_tracing.SpanStore] = None) -> None:
        #: private + always-enabled: a tracer must record even when the
        #: process-global telemetry is off, and must not pollute it
        self.registry = registry or MetricsRegistry(enabled=True)
        #: optional private span store (attach(spans=True))
        self.span_store = span_store

    @classmethod
    def attach(cls, pipeline: Any, spans: bool = False) -> "PipelineTracer":
        store = _tracing.SpanStore(enabled=True) if spans else None
        tracer = cls(span_store=store)
        instrument_pipeline(pipeline, tracer.registry, span_store=store)
        return tracer

    def _stats(self) -> Dict[str, Dict[str, float]]:
        snap = self.registry.snapshot()

        def per_element(name):
            out: Dict[str, Dict[str, float]] = {}
            for s in snap.get(name, {}).get("series", []):
                out[s["labels"]["element"]] = s
            return out

        proc = per_element("nnstpu_pipeline_proctime_seconds")
        inter = per_element("nnstpu_pipeline_interlatency_seconds")
        stats: Dict[str, Dict[str, float]] = {}
        for el in set(proc) | set(inter):
            p = proc.get(el, {"count": 0, "sum": 0.0, "max": 0.0})
            i = inter.get(el, {"count": 0, "sum": 0.0})
            n = int(p["count"])
            stats[el] = {
                "n": n,
                "proctime_us": p["sum"] / max(n, 1) * 1e6,
                "max_us": p["max"] * 1e6,
                "interlatency_us":
                    i["sum"] / max(int(i["count"]), 1) * 1e6,
            }
        return stats

    def report(self) -> str:
        lines = [f"{'element':<24}{'bufs':>7}{'proctime(us)':>14}"
                 f"{'max(us)':>10}{'interlat(us)':>14}"]
        # sorted slowest-mean first: the _stats() source iterates a set
        # union, and a report whose row order changes run to run cannot
        # be diffed (tests/test_tracing.py pins the ordering)
        rows = sorted(self._stats().items(),
                      key=lambda kv: kv[1]["proctime_us"], reverse=True)
        for name, t in rows:
            lines.append(f"{name:<24}{t['n']:>7}{t['proctime_us']:>14.1f}"
                         f"{t['max_us']:>10.1f}{t['interlatency_us']:>14.1f}")
        return "\n".join(lines)

    def span_report(self) -> str:
        """Per-element span table from the private store; requires
        ``attach(pipeline, spans=True)``."""
        if self.span_store is None:
            raise RuntimeError(
                "span_report needs PipelineTracer.attach(pipeline, "
                "spans=True)")
        return _tracing.element_stats_report(self.span_store)

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return self._stats()


class device_trace:
    """Context manager: ``torch.profiler`` trace around a pipeline run,
    written as a Chrome trace (``trace.json``, open it in Perfetto) into
    ``logdir``; ``profile`` holds the finished ``torch.profiler.profile``
    (its ``key_averages()`` too). Records CUDA activity when a card is
    present, CPU activity always.

    With global tracing enabled, the bracket is also a ``device.xprof``
    span (the JAX package's name, parented on the caller's current span
    when inside one), so ``trace_id`` joins the logdir to a wire-level
    trace."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        self.trace_id: Optional[str] = None
        self.path = os.path.join(logdir, "trace.json")
        self.profile: Any = None
        self._span = _tracing.NOOP_SPAN

    def __enter__(self):
        import torch

        self._span = _tracing.start_span(
            "device.xprof", parent=_tracing.current_context(),
            attrs={"logdir": self.logdir})
        if self._span.recording:
            self.trace_id = self._span.context.trace_id
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.profile = torch.profiler.profile(activities=acts)
        self.profile.__enter__()
        return self

    def __exit__(self, *exc: Any) -> None:
        try:
            self.profile.__exit__(*exc)
            os.makedirs(self.logdir, exist_ok=True)
            self.profile.export_chrome_trace(self.path)
        finally:
            self._span.end()
