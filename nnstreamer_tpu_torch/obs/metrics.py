"""Process-wide metrics registry: counters, gauges, histograms.

Port of nnstreamer_tpu/obs/metrics.py (stdlib only, the same families,
exposition bytes and switches). The reference exposes per-filter invoke
stats only as GObject runtime props (tensor_filter.c:366-400) and leans on out-of-tree GstShark
tracers for anything per-element; there is no always-on telemetry a
serving fleet could scrape. This module is the in-tree answer: one
thread-safe ``MetricsRegistry`` every layer (graph, query, serving)
feeds, with snapshot-to-dict for programmatic consumers (the
``PipelineTracer`` report is one) and Prometheus text exposition for
the ``/metrics`` endpoint (obs/exporter.py). Stdlib only.

Design points:
  * **Families and children.** ``registry.counter(name, help, labels)``
    registers (or returns the existing) family; ``family.labels(*vals)``
    returns the mutable child series. Label-less families proxy
    ``inc``/``set``/``observe`` straight through to their single child.
  * **Cheap no-op when disabled.** Every mutation checks one registry
    flag and returns; nothing allocates. The pipeline hot path is even
    cheaper: element chains are only wrapped at all when metrics are
    enabled at ``Pipeline.start`` time (obs/instrument.py), so the
    disabled cost there is exactly zero.
  * **Fixed log-spaced latency buckets.** Histograms default to a
    1-2.5-5 decade ladder from 10 us to 50 s — per-phase latency
    *distributions*, not averages, are the signal worth capturing
    (arXiv:2008.01040's learned performance models feed on exactly
    these); the max is tracked besides the buckets so tail reporting
    (tracer ``max_us``) needs no +Inf quantile math.

Naming convention (the checks of scripts/check_metric_names.py, run over
this package by tests/test_torch_metric_names.py):
``nnstpu_<layer>_<name>_<unit>``; counters end in ``_total``, histograms
in ``_seconds``, gauges in ``_depth``/``_slots``/``_bytes`` and the
layer-reserved units. The names are the JAX package's, so a dashboard
built on one package reads the other.
"""

from __future__ import annotations

import os
import threading
from bisect import bisect_left
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "DEFAULT_LATENCY_BUCKETS", "registry", "enabled", "enable", "disable",
]

#: 1-2.5-5 per decade, 10 us .. 50 s (21 buckets + implicit +Inf)
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = tuple(
    round(10.0 ** e * m, 12) for e in range(-5, 2) for m in (1.0, 2.5, 5.0))


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\"", "\\\"").replace("\n", "\\n")


def _escape_help(v: str) -> str:
    """HELP-line escaping (text format 0.0.4): backslash and newline
    only — quotes are legal in help text."""
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return f"{v:.10g}"


class _Child:
    """One labeled series. Mutations are guarded by the owning family's
    lock and no-op when the registry is disabled."""

    def __init__(self, family: "_Family", labelvalues: Tuple[str, ...]):
        self._family = family
        self._labels = labelvalues


class Counter(_Child):
    def __init__(self, family, labelvalues):
        super().__init__(family, labelvalues)
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if not self._family._registry._enabled:
            return
        if n < 0:
            raise ValueError("counters only go up")
        with self._family._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge(_Child):
    def __init__(self, family, labelvalues):
        super().__init__(family, labelvalues)
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def set(self, v: float) -> None:
        if not self._family._registry._enabled:
            return
        with self._family._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        if not self._family._registry._enabled:
            return
        with self._family._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    def set_function(self, fn: Callable[[], float]) -> None:
        """Evaluate ``fn`` at collection time instead of storing writes —
        zero hot-path cost for depth-style gauges (queue occupancy,
        in-flight windows) whose state already lives elsewhere."""
        self._fn = fn

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:  # noqa: BLE001 — a dead callback reads 0
                return 0.0
        return self._value


class Histogram(_Child):
    def __init__(self, family, labelvalues):
        super().__init__(family, labelvalues)
        self._bucket_counts = [0] * len(family._buckets)
        self._sum = 0.0
        self._count = 0
        self._max = 0.0

    def observe(self, v: float) -> None:
        if not self._family._registry._enabled:
            return
        v = float(v)
        i = bisect_left(self._family._buckets, v)
        with self._family._lock:
            if i < len(self._bucket_counts):
                self._bucket_counts[i] += 1
            self._sum += v
            self._count += 1
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def max(self) -> float:
        return self._max


_CHILD_CLASSES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """A named metric with a fixed label schema; children per label
    combination are created on demand and cached forever (bounded by
    label cardinality, which the call sites keep small)."""

    def __init__(self, registry: "MetricsRegistry", name: str, help: str,
                 mtype: str, labelnames: Tuple[str, ...],
                 buckets: Tuple[float, ...] = ()):
        self._registry = registry
        self.name = name
        self.help = help
        self.type = mtype
        self.labelnames = labelnames
        self._buckets = buckets
        self._children: Dict[Tuple[str, ...], _Child] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def labels(self, *values: Any, **kv: Any) -> Any:
        if kv:
            if values:
                raise ValueError("pass labels positionally or by name, not both")
            values = tuple(kv[n] for n in self.labelnames)
        vals = tuple(str(v) for v in values)
        if len(vals) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got {vals}")
        child = self._children.get(vals)
        if child is None:
            with self._lock:
                child = self._children.get(vals)
                if child is None:
                    child = _CHILD_CLASSES[self.type](self, vals)
                    self._children[vals] = child
        return child

    # -- label-less convenience: the family IS its single child -------- #
    def inc(self, n: float = 1.0) -> None:
        self.labels().inc(n)

    def set(self, v: float) -> None:
        self.labels().set(v)

    def observe(self, v: float) -> None:
        self.labels().observe(v)

    def samples(self) -> List[Tuple[Tuple[str, ...], _Child]]:
        with self._lock:
            return list(self._children.items())


class MetricsRegistry:
    """Thread-safe registry of metric families.

    Re-registering a name is idempotent when type/labels/buckets agree
    (every call site just declares what it needs) and raises otherwise —
    silent schema drift is how dashboards rot.
    """

    def __init__(self, enabled: bool = True):
        self._families: Dict[str, _Family] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        self._enabled = bool(enabled)

    # -- enable/disable ------------------------------------------------ #
    @property
    def is_enabled(self) -> bool:
        return self._enabled

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    # -- registration -------------------------------------------------- #
    def _register(self, name: str, help: str, mtype: str,
                  labelnames: Sequence[str],
                  buckets: Tuple[float, ...] = ()) -> _Family:
        labelnames = tuple(labelnames)
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.type != mtype or fam.labelnames != labelnames or \
                        (mtype == "histogram" and fam._buckets != buckets):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.type}{fam.labelnames}, conflicting "
                        f"re-registration as {mtype}{labelnames}")
                return fam
            fam = _Family(self, name, help, mtype, labelnames, buckets)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> _Family:
        return self._register(name, help, "counter", labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> _Family:
        return self._register(name, help, "gauge", labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS
                  ) -> _Family:
        b = tuple(sorted(float(x) for x in buckets))
        if not b:
            raise ValueError("histogram needs at least one bucket bound")
        return self._register(name, help, "histogram", labelnames, b)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._families)

    def reset(self) -> None:
        """Drop every family (tests over private registries). Cached
        family/child handles held by call sites keep working but detach
        from future snapshots — never reset the process-global registry
        mid-flight."""
        with self._lock:
            self._families.clear()

    # -- collection ---------------------------------------------------- #
    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """{name: {type, help, series: [{labels, ...values}]}} — the
        programmatic view (tracer reports, tests, JSON dumps)."""
        out: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            families = list(self._families.values())
        for fam in families:
            series = []
            for vals, child in fam.samples():
                labels = dict(zip(fam.labelnames, vals))
                if fam.type == "histogram":
                    with fam._lock:
                        counts = list(child._bucket_counts)
                        s, c, mx = child._sum, child._count, child._max
                    cum = 0
                    buckets = {}
                    for bound, n in zip(fam._buckets, counts):
                        cum += n
                        buckets[bound] = cum
                    series.append({"labels": labels, "count": c, "sum": s,
                                   "max": mx, "buckets": buckets})
                else:
                    series.append({"labels": labels, "value": child.value})
            out[fam.name] = {"type": fam.type, "help": fam.help,
                             "series": series}
        return out

    def exposition(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: List[str] = []
        with self._lock:
            families = sorted(self._families.values(), key=lambda f: f.name)
        for fam in families:
            samples = fam.samples()
            if not samples:
                continue
            if fam.help:
                lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
            lines.append(f"# TYPE {fam.name} {fam.type}")
            for vals, child in samples:
                base = ",".join(
                    f'{n}="{_escape_label(v)}"'
                    for n, v in zip(fam.labelnames, vals))
                if fam.type == "histogram":
                    with fam._lock:
                        counts = list(child._bucket_counts)
                        s, c = child._sum, child._count
                    cum = 0
                    for bound, n in zip(fam._buckets, counts):
                        cum += n
                        le = f'le="{_fmt(bound)}"'
                        lbl = f"{base},{le}" if base else le
                        lines.append(f"{fam.name}_bucket{{{lbl}}} {cum}")
                    le = 'le="+Inf"'
                    lbl = f"{base},{le}" if base else le
                    lines.append(f"{fam.name}_bucket{{{lbl}}} {c}")
                    suffix = f"{{{base}}}" if base else ""
                    lines.append(f"{fam.name}_sum{suffix} {_fmt(s)}")
                    lines.append(f"{fam.name}_count{suffix} {c}")
                else:
                    suffix = f"{{{base}}}" if base else ""
                    lines.append(f"{fam.name}{suffix} {_fmt(child.value)}")
        return "\n".join(lines) + "\n" if lines else ""


# --------------------------------------------------------------------------- #
# Process-global registry
# --------------------------------------------------------------------------- #

#: disabled by default: instrumentation costs nothing until something
#: (the exporter, the CLI flag, NNSTPU_METRICS=1, or an explicit
#: enable()) turns collection on
_REGISTRY = MetricsRegistry(
    enabled=os.environ.get("NNSTPU_METRICS", "") == "1")


def registry() -> MetricsRegistry:
    return _REGISTRY


def enabled() -> bool:
    return _REGISTRY._enabled


def enable() -> None:
    """Turn collection on. Call BEFORE building pipelines/engines: the
    element-chain fast path decides at Pipeline.start whether to wrap
    at all."""
    _REGISTRY.enable()


def disable() -> None:
    _REGISTRY.disable()
