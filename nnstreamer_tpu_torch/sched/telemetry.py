"""Scheduler telemetry — the ``nnstpu_sched_*`` metric families and
``sched.*`` flight-recorder events.

Port of nnstreamer_tpu/sched/telemetry.py, unchanged.

Every sched-layer metric registration and event literal lives HERE (or
in sibling sched/ modules): scripts/nnslint's ``check_sched`` ownership
rule enforces it, mirroring how resilience/router/profile telemetry is
placed. Other layers that need to account scheduler facts — e.g. the
bucketed-invoke path in filters/torch_cuda.py recording bucket hits and
ladder misses — call the helpers below instead of minting ``sched.*``
names of their own.

Families (naming per docs/observability.md):
  * ``nnstpu_sched_queue_depth{tenant}`` — ready buffers queued per
    tenant (collection-time gauge through a weakref; holding the
    series never pins a deregistered tenant).
  * ``nnstpu_sched_inflight_depth{engine}`` — device batches dispatched
    but not yet synced (the double-buffer window occupancy).
  * ``nnstpu_sched_batches_total{engine}`` /
    ``nnstpu_sched_coalesced_total{engine}`` — device batches vs items
    carried; their ratio is the mean coalesce width.
  * ``nnstpu_sched_wait_seconds{tenant}`` — submit→dispatch wait.
  * ``nnstpu_sched_busy_seconds{engine}`` — per-batch device-busy wall
    (dispatch + the bounded-window sync); ``rate(sum)`` over wall time
    is the engine occupancy.
  * ``nnstpu_sched_bucket_total{event}`` (hit/miss) and
    ``nnstpu_sched_pad_rows_total{site}`` — bucket-ladder selection
    stats from the bucketed/coalesced invoke paths.

Recording through these handles is the registry's cheap no-op while
metrics are off (obs/metrics.py contract), so the scheduler never
checks ``obs.enabled()`` itself.
"""

from __future__ import annotations

from typing import Any, Callable

from ..obs import events as _events
from ..obs import metrics as _metrics

_reg = _metrics.registry()

QUEUE_DEPTH = _reg.gauge(
    "nnstpu_sched_queue_depth",
    "Ready work items queued per scheduler tenant",
    ("tenant",))
INFLIGHT_DEPTH = _reg.gauge(
    "nnstpu_sched_inflight_depth",
    "Device batches dispatched but not yet synced (double-buffer "
    "window occupancy)",
    ("engine",))
BATCHES_TOTAL = _reg.counter(
    "nnstpu_sched_batches_total",
    "Coalesced device batches dispatched by the engine",
    ("engine",))
COALESCED_TOTAL = _reg.counter(
    "nnstpu_sched_coalesced_total",
    "Work items carried inside coalesced batches (ratio to "
    "batches_total = mean coalesce width)",
    ("engine",))
WAIT_SECONDS = _reg.histogram(
    "nnstpu_sched_wait_seconds",
    "Tenant wait from submit to device dispatch",
    ("tenant",))
BUSY_SECONDS = _reg.histogram(
    "nnstpu_sched_busy_seconds",
    "Per-batch device-busy wall (dispatch + bounded-window sync)",
    ("engine",))
BUCKET_TOTAL = _reg.counter(
    "nnstpu_sched_bucket_total",
    "Bucket-ladder selections by outcome (hit = padded to a ladder "
    "size, miss = above the ladder cap, chunked)",
    ("event",))
PAD_ROWS_TOTAL = _reg.counter(
    "nnstpu_sched_pad_rows_total",
    "Zero rows padded onto device batches (bucket/coalesce waste)",
    ("site",))


def watch_queue_depth(tenant_name: str, fn: Callable[[], float]) -> None:
    """Bind a tenant's queue-depth gauge to a collection-time callable
    (the engine passes a weakref-reading closure)."""
    QUEUE_DEPTH.labels(tenant_name).set_function(fn)


def record_batch(engine_name: str, width: int, busy_s: float) -> None:
    """One coalesced device batch: ``width`` items in one dispatch."""
    BATCHES_TOTAL.labels(engine_name).inc()
    COALESCED_TOTAL.labels(engine_name).inc(width)
    BUSY_SECONDS.labels(engine_name).observe(busy_s)


def record_wait(tenant_name: str, wait_s: float) -> None:
    WAIT_SECONDS.labels(tenant_name).observe(wait_s)


def record_bucket_hit(pad_rows: int, site: str = "bucketed") -> None:
    """A batch fit the bucket ladder; ``pad_rows`` zero rows of waste."""
    BUCKET_TOTAL.labels("hit").inc()
    if pad_rows:
        PAD_ROWS_TOTAL.labels(site).inc(pad_rows)


def record_bucket_miss(n: int, cap: int, label: str = "") -> None:
    """A batch of ``n`` rows fell outside every bucket (> ``cap``): the
    invoke chunks it into ladder-sized pieces instead of silently
    compiling an unbounded new shape. Counted AND journaled — an
    unexpected miss usually means the bucket cap is mis-sized for the
    workload."""
    BUCKET_TOTAL.labels("miss").inc()
    _events.record(
        "sched.bucket_miss",
        f"batch of {n} rows exceeds bucket ladder cap {cap} — chunked"
        + (f" ({label})" if label else ""),
        severity="warning", rows=n, cap=cap, label=label)


def event_starvation_relief(tenant_name: str, wait_s: float,
                            bound_s: float) -> None:
    """The fairness bound fired: a tenant whose head-of-line wait
    exceeded the starvation bound was force-served ahead of DRR order."""
    _events.record(
        "sched.starvation_relief",
        f"tenant {tenant_name!r} head waited {wait_s * 1e3:.1f}ms "
        f"(bound {bound_s * 1e3:.0f}ms) — force-served",
        severity="warning", tenant=tenant_name,
        wait_ms=wait_s * 1e3, bound_ms=bound_s * 1e3)


def event_starvation_storm(component: str, reliefs: int, window_s: float,
                           **attrs: Any) -> None:
    """The health watchdog saw repeated starvation reliefs inside one
    window: fairness is being rescued too often, which means the DRR
    weights/priorities are mis-sized for the offered load. Called
    lazily from obs/health's sched rule so the ``sched.*`` literal
    stays in this layer."""
    _events.record(
        "sched.starvation_storm",
        f"{component}: {reliefs} starvation reliefs within "
        f"{window_s:.0f}s — fairness degraded",
        severity="warning", component=component, reliefs=reliefs,
        window_s=window_s, **attrs)


def event_starvation_recover(component: str, **attrs: Any) -> None:
    """The starvation storm subsided; the sched component returns OK."""
    _events.record(
        "sched.recover",
        f"{component}: starvation storm subsided",
        component=component, **attrs)


def event_tenant_register(tenant_name: str, **attrs: Any) -> None:
    _events.record("sched.tenant_register",
                   f"tenant {tenant_name!r} registered",
                   tenant=tenant_name, **attrs)


def event_tenant_deregister(tenant_name: str, **attrs: Any) -> None:
    _events.record("sched.tenant_deregister",
                   f"tenant {tenant_name!r} deregistered",
                   tenant=tenant_name, **attrs)


def event_engine_start(engine_name: str, **attrs: Any) -> None:
    _events.record("sched.engine_start",
                   f"engine {engine_name!r} dispatch loop started",
                   engine=engine_name, **attrs)


def event_engine_stop(engine_name: str, **attrs: Any) -> None:
    _events.record("sched.engine_stop",
                   f"engine {engine_name!r} dispatch loop stopped",
                   engine=engine_name, **attrs)


def event_coalesce_fallback(label: str, width: int, why: str) -> None:
    """A coalesced dispatch failed and was re-run serially per item —
    correctness is preserved, the batching win for that batch is lost."""
    _events.record(
        "sched.coalesce_fallback",
        f"coalesced dispatch of {width} items fell back to serial "
        f"({label}): {why}",
        severity="warning", label=label, width=width, why=why)
