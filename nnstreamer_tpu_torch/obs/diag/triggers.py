"""Incident trigger engine: decide *when* a debug bundle is worth the
disk, without letting a flapping alert turn the bundle directory into
a second event ring.

Five cause kinds feed :meth:`TriggerEngine.offer`:

- ``slo_burn``          — obs/slo.py burn alert (key: component)
- ``watchdog_degraded`` — obs/health.py DEGRADED verdict (key: component)
- ``fleet_action``      — fleet/controller.py scale/migrate (key: action)
- ``cost_anomaly``      — measured sched dispatch time vs the tune/
  cost-model expectation (or the label's own running mean when the
  model doesn't cover it), z-score above threshold (key: label)
- ``quality_anomaly``   — obs/quality data-plane verdict (NaN storm,
  dead output, drift breach) at the watchdog (key: component)

Two independent brakes, both on an injectable clock so the
determinism test drives them by hand:

- **rate limit**: at most one capture per ``min_interval_s``, globally
  — bundles are heavyweight, causes are not.
- **dedup by cause**: the same (kind, key) within ``dedup_window_s``
  is the same incident; one bundle carries it.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

#: causes offer() understands — anything else is rejected loudly in
#: tests and silently dropped in production paths
CAUSE_KINDS = ("slo_burn", "watchdog_degraded", "fleet_action",
               "cost_anomaly", "quality_anomaly")


class _Welford:
    """Running mean/variance for one dispatch label."""

    __slots__ = ("n", "mean", "m2")

    def __init__(self) -> None:
        self.n = 0
        self.mean = 0.0
        self.m2 = 0.0

    def add(self, x: float) -> None:
        self.n += 1
        d = x - self.mean
        self.mean += d / self.n
        self.m2 += d * (x - self.mean)

    def std(self) -> float:
        if self.n < 2:
            return 0.0
        return (self.m2 / (self.n - 1)) ** 0.5


class TriggerEngine:
    """Rate-limited, deduplicating trigger front-end for bundle capture.

    ``capture`` is called as ``capture(cause: dict)`` and returns a
    bundle id (or None when capture itself declined); the engine never
    raises out of ``offer`` — a sick diag layer must not take serving
    down with it.
    """

    def __init__(self, capture: Callable[[Dict[str, Any]], Optional[str]],
                 *, min_interval_s: float = 30.0,
                 dedup_window_s: float = 300.0,
                 z_threshold: float = 4.0, min_samples: int = 16,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self._capture = capture
        self.min_interval_s = float(min_interval_s)
        self.dedup_window_s = float(dedup_window_s)
        self.z_threshold = float(z_threshold)
        self.min_samples = int(min_samples)
        self._clock = clock
        self._lock = threading.Lock()
        self._last_fire: Optional[float] = None
        self._seen: Dict[Tuple[str, str], float] = {}  # (kind, key) -> t
        self._cost: Dict[str, _Welford] = {}
        self.stats: Dict[str, int] = {
            "offered": 0, "fired": 0, "rate_limited": 0, "deduped": 0,
            "capture_declined": 0}

    # -- the decision ------------------------------------------------- #
    def offer(self, kind: str, key: str,
              detail: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """One observed cause. Returns the bundle id when a capture
        fired, None when braked (or the cause kind is unknown)."""
        if kind not in CAUSE_KINDS:
            return None
        now = self._clock()
        with self._lock:
            self.stats["offered"] += 1
            seen_t = self._seen.get((kind, key))
            if seen_t is not None and now - seen_t < self.dedup_window_s:
                self.stats["deduped"] += 1
                return None
            if self._last_fire is not None \
                    and now - self._last_fire < self.min_interval_s:
                self.stats["rate_limited"] += 1
                return None
            # claim the slot before the (slow) capture runs so a
            # concurrent cause can't double-fire
            self._last_fire = now
            self._seen[(kind, key)] = now
            if len(self._seen) > 1024:
                cutoff = now - self.dedup_window_s
                self._seen = {k: t for k, t in self._seen.items()
                              if t >= cutoff}
        cause = {"kind": kind, "key": key, "t": now,
                 "detail": dict(detail or {})}
        try:
            bundle_id = self._capture(cause)
        except Exception:
            bundle_id = None
        with self._lock:
            if bundle_id is None:
                self.stats["capture_declined"] += 1
            else:
                self.stats["fired"] += 1
        return bundle_id

    # -- cost-model anomaly detection --------------------------------- #
    def observe_cost(self, label: str, measured_us: float,
                     expected_us: Optional[float] = None
                     ) -> Optional[str]:
        """One measured dispatch. With a tune/ prediction, the residual
        (measured - expected) feeds the label's running distribution;
        without one, the raw measurement does. A sample more than
        ``z_threshold`` standard deviations above the mean — after
        ``min_samples`` sightings — is a cost anomaly."""
        x = float(measured_us) - float(expected_us or 0.0)
        with self._lock:
            w = self._cost.get(label)
            if w is None:
                w = self._cost[label] = _Welford()
                if len(self._cost) > 512:  # label-cardinality bound
                    self._cost.pop(next(iter(self._cost)))
            n, mean, std = w.n, w.mean, w.std()
            w.add(x)
        if n < self.min_samples or std <= 0.0:
            return None
        z = (x - mean) / std
        if z < self.z_threshold:
            return None
        return self.offer("cost_anomaly", label, {
            "measured_us": float(measured_us),
            "expected_us": float(expected_us) if expected_us else None,
            "z": round(z, 2), "mean_us": round(mean, 2),
            "std_us": round(std, 2), "samples": n})

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "stats": dict(self.stats),
                "min_interval_s": self.min_interval_s,
                "dedup_window_s": self.dedup_window_s,
                "z_threshold": self.z_threshold,
                "tracked_labels": len(self._cost),
                "recent_causes": sorted(
                    (f"{k[0]}:{k[1]}" for k in self._seen), )[:32],
            }
