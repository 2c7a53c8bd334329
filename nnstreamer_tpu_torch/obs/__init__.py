"""nnstreamer_tpu_torch.obs — metrics, tracing, health, events, profiling
and their exposition.

Port of nnstreamer_tpu/obs (stdlib only but the profiler's CUDA events):
always-on counters/gauges/histograms fed by the pipeline graph, the
scheduler and the serving engines, with a stdlib HTTP ``/metrics`` +
``/healthz`` + ``/readyz`` endpoint — plus span-based request tracing with
tail-based retention (``/debug/traces``, ``/debug/pipeline``), a component
health model with a stall watchdog driving the ``/healthz``/``/readyz``
verdicts, a flight-recorder event ring (``/debug/events``), and the
device-time profiler (per-dispatch host and CUDA-event device timing, kernel
labels, MFU/roofline gauges, a Perfetto timeline at ``/debug/profile``).
Metric families, span names and event types are the JAX package's.

Metrics, tracing, health, events and profiling are independently switchable
(``enable()`` / ``tracing.enable()`` / ``health.enable()`` /
``events.enable()`` / ``profile.enable()``); each is a flag-check no-op when
off. The JAX package's ``fleet``, ``slo``, ``diag`` and ``quality`` layers
wait for their ports (ROADMAP §A7, §A9).
"""

from .metrics import (DEFAULT_LATENCY_BUCKETS, MetricsRegistry, disable,
                      enable, enabled, registry)
from .exporter import MetricsExporter, start_exporter
from .instrument import instrument_pipeline
from . import events
from . import health
from . import profile
from . import tracing
from .events import EventRing
from .health import Component, HealthRegistry, Status
from .profile import Profiler, perfetto_trace
from .tracing import Span, SpanContext, SpanStore, start_span

__all__ = [
    "Component", "DEFAULT_LATENCY_BUCKETS", "EventRing", "HealthRegistry",
    "MetricsRegistry", "MetricsExporter", "Profiler", "Span",
    "SpanContext", "SpanStore", "Status", "disable", "enable",
    "enabled", "events", "health", "instrument_pipeline",
    "perfetto_trace", "profile", "registry", "start_exporter",
    "start_span", "tracing",
]
