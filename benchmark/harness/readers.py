"""What the metric readers share: each reader in ``benchmark/metrics/`` is
one call into here with its own parameters."""

from __future__ import annotations

from typing import Any, Dict, Optional

from . import peaks
from .stats import percentile


def frames_per_s(ctx: Dict[str, Any]) -> Optional[float]:
    rec = ctx["records"]
    return rec["done"] / rec["seconds"] if rec["done"] else None


def latency_ms(ctx: Dict[str, Any], q: float) -> Optional[float]:
    lat = ctx["records"]["latency_s"]
    return percentile(lat, q) * 1e3 if lat else None


def lag_ms(ctx: Dict[str, Any], q: float) -> Optional[float]:
    lag = ctx["records"]["lag_s"]
    return percentile(lag, q) * 1e3 if lag else None


def coalesce_width(ctx: Dict[str, Any]) -> Optional[float]:
    c = ctx.get("coalesce")
    return float(c["mean"]) if c and c.get("n") else None


def host_ms(ctx: Dict[str, Any], element: str) -> Optional[float]:
    return ctx["spans"].ms_per_call(element) if ctx["traced"] else None


def mfu_pct(ctx: Dict[str, Any]) -> Optional[float]:
    """The configuration's FLOPs at the rate of the traced window's first
    part, before any instrument is on, over the peak."""
    rec = ctx["records"]
    if not ctx["traced"] or not rec["plain_done"] or rec["plain_seconds"] <= 0:
        return None
    fps = rec["plain_done"] / rec["plain_seconds"]
    return 100.0 * ctx["flops_per_frame"] * fps / ctx["peak_flops"]


def idle_pct(ctx: Dict[str, Any]) -> Optional[float]:
    s = ctx["summary"]
    if not s or s["busy_s"] <= 0 or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def roofline_pct(ctx: Dict[str, Any], kernel: str) -> Optional[float]:
    """The least time of one call from the frozen counts of its shapes over
    the profiler's mean device time a call."""
    s, work = ctx["summary"], ctx.get("work") or {}
    if not s:
        return None
    tracer = ctx["cell"].tracer
    if kernel == "class_reduce":
        calls, secs = tracer.kernel("class_reduce_kernel")
        if not calls or "class_reduce_rows" not in work:
            return None
        bound = peaks.class_reduce_s(work["class_reduce_rows"], work["class_reduce_cols"])
    elif kernel == "nms_sweep_k1917":
        calls, _ = tracer.kernel("relation_sweep_kernel")
        _, secs = tracer.kernel("relation_sweep_kernel", "relation_build_kernel")
        if not calls or "nms_pairs" not in work:
            return None
        bound = peaks.nms_sweep_s(work["nms_k"], work["nms_pairs"])
    elif kernel == "segment_colorize":
        calls, secs = tracer.kernel("argmax_colorize_kernel")
        if not calls or "colorize_pixels" not in work:
            return None
        bound = peaks.segment_colorize_s(work["colorize_pixels"], work["colorize_classes"])
    else:
        raise KeyError(kernel)
    return 100.0 * bound / (secs / calls)
