"""nnstreamer_tpu_torch.obs — metrics, tracing, health, events, profiling,
SLO accounting, diagnostics, data-plane quality and their exposition.

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

On the base sit the per-tenant SLO accounting (``slo``: goodput and
burn-rate objectives, ``/debug/slo``), incident diagnostics (``diag``:
critical-path attribution and debug bundles, ``/debug/diag/critpath``,
``/debug/bundles``) and data-plane quality (``quality``: tensor stats,
drift and LM confidence, ``/debug/quality``).

Every layer is independently switchable (``enable()`` /
``tracing.enable()`` / ``health.enable()`` / ``events.enable()`` /
``profile.enable()`` / ``slo.enable()`` / ``diag.enable()`` /
``quality.enable()``); each is a flag-check or None-check no-op when off.
The fleet layer (``fleet``) federates metrics, health and spans across
processes: workers push snapshots over the query wire or plain HTTP, and
one aggregator re-exposes the merged fleet on its exporter.
"""

from .metrics import (DEFAULT_LATENCY_BUCKETS, MetricsRegistry, disable,
                      enable, enabled, registry)
from .exporter import MetricsExporter, start_exporter
from .instrument import instrument_pipeline
from . import events
from . import fleet
from . import health
from . import profile
from . import slo
from . import tracing
from .events import EventRing
from .fleet import FleetAggregator, FleetPusher
from .health import Component, HealthRegistry, Status
from .profile import Profiler, perfetto_trace
from .tracing import Span, SpanContext, SpanStore, start_span

__all__ = [
    "Component", "DEFAULT_LATENCY_BUCKETS", "EventRing",
    "FleetAggregator", "FleetPusher", "HealthRegistry",
    "MetricsRegistry", "MetricsExporter", "Profiler", "Span",
    "SpanContext", "SpanStore", "Status", "disable", "enable",
    "enabled", "events", "fleet", "health", "instrument_pipeline",
    "perfetto_trace", "profile", "registry", "slo", "start_exporter",
    "start_span", "tracing",
]
