"""obs.diag — critical-path latency attribution + automatic incident
debug bundles.

Port of nnstreamer_tpu/obs/diag (stdlib only).

Three pieces behind one None-gated hook:

- :mod:`.critpath` attributes a request's wall-clock latency exactly
  to segments (admission wait, sched queue wait, device compute, wire,
  KV transfer, migration, re-prefill) over its cross-host span tree,
  with a conservation contract: segments sum to the request's measured
  latency to the nanosecond. ``GET /debug/diag/critpath`` serves the
  per-tenant rollup.
- :mod:`.triggers` + :mod:`.bundle` capture a bounded evidence bundle
  to disk when an SLO burn alert, watchdog DEGRADED, fleet
  scale/migrate action, or cost-model anomaly fires — rate-limited
  and deduped by cause. ``GET /debug/bundles[/<id>]`` serves them and
  fleet push docs reference them.
- :mod:`.cli` (``nns-diag-torch``) loads a bundle offline, prints the
  critical-path waterfall, and emits a Perfetto trace of just the
  implicated requests.

Hook contract (the repo-wide pattern): :data:`DIAG_HOOK` is a module
global, None until :func:`enable` installs a :class:`DiagEngine`.
Every hot-path tap is one attribute load + one None check when off —
pinned by the zero-overhead test. ONLY this package assigns it
(``naming/diag`` lint). ``NNSTPU_DIAG=1`` (or ``=<bundle dir>``)
enables at import; ``nns-launch-torch --diag[=dir]`` from the CLI.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from .. import tracing as _tracing
from .bundle import BundleStore, load_bundle
from .critpath import SEGMENTS, analyze, rollup, segment_of, waterfall
from .triggers import TriggerEngine

__all__ = ["DIAG_HOOK", "DiagEngine", "BundleStore", "TriggerEngine",
           "SEGMENTS", "analyze", "rollup", "segment_of", "waterfall",
           "load_bundle", "enable", "disable", "enabled", "engine",
           "snapshot", "DEFAULT_BUNDLE_DIR"]

DEFAULT_BUNDLE_DIR = ".nnstpu-diag"

#: THE diag hook: None (off, hot paths pay one attribute load + None
#: check) or the enabled DiagEngine. Assigned only here.
DIAG_HOOK: Optional["DiagEngine"] = None


class DiagEngine:
    """The :data:`DIAG_HOOK` target: hot-path taps feed the span store
    and the cost-anomaly detector; cold-path taps (burn alert,
    degrade, fleet action) feed the trigger engine, which captures
    bundles through the store."""

    def __init__(self, bundles: BundleStore, *,
                 min_interval_s: float = 30.0,
                 dedup_window_s: float = 300.0,
                 z_threshold: float = 4.0, min_samples: int = 16,
                 cost_model: Any = None, device_kind: str = "",
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.bundles = bundles
        self.triggers = TriggerEngine(
            bundles.capture, min_interval_s=min_interval_s,
            dedup_window_s=dedup_window_s, z_threshold=z_threshold,
            min_samples=min_samples, clock=clock)
        self.cost_model = cost_model
        self.device_kind = str(device_kind)
        self._lock = threading.Lock()
        #: bounded recent request observations (lm_engine retire tap):
        #: the critpath endpoint's "which requests" evidence
        self._requests: "collections.deque" = collections.deque(maxlen=512)

    # -- hot-path taps (called behind the None gate) -------------------- #
    def tap_submit(self) -> Optional[Any]:
        """sched _submit: capture the submitting thread's trace context
        + a monotonic enqueue stamp so the batch tap can write exact
        diag.sched_wait / diag.sched_run spans into the request's
        trace. None when the submit isn't running under a trace."""
        ctx = _tracing.current_context()
        if ctx is None:
            return None
        return (ctx, time.monotonic_ns())

    def observe_sched_batch(self, engine: str, batch: List[Any],
                            t0_ns: int, t1_ns: int) -> None:
        """sched _execute: synthesize attribution spans for every work
        item that carried a trace context, and feed the batch's
        measured dispatch time to the cost-anomaly detector."""
        store = _tracing.store()
        width = len(batch)
        for w in batch:
            tap = getattr(w, "diag", None)
            if tap is None:
                continue
            ctx, enq_ns = tap
            if enq_ns < t0_ns:
                store.add_span(
                    "diag.sched_wait", ctx.trace_id, ctx.span_id,
                    enq_ns, t0_ns,
                    attrs={"engine": engine, "tenant": w.tenant.name,
                           "label": w.label})
            store.add_span(
                "diag.sched_run", ctx.trace_id, ctx.span_id,
                t0_ns, t1_ns,
                attrs={"engine": engine, "tenant": w.tenant.name,
                       "label": w.label, "width": width})
        head = batch[0]
        label = f"{engine}.{head.label or 'batch'}"
        measured_us = (t1_ns - t0_ns) / 1e3
        expected_us = None
        model = self.cost_model
        if model is not None:
            flops = getattr(head.filt, "flops", None)
            nbytes = getattr(head.filt, "nbytes", None)
            if flops is not None and nbytes is not None:
                expected_us = model.predict(
                    self.device_kind, label, float(flops), float(nbytes))
        self.triggers.observe_cost(label, measured_us, expected_us)

    def observe_request(self, engine: str, rid: int,
                        tenant: Optional[str], trace_id: Optional[str],
                        latency_s: float, shed: bool = False) -> None:
        """serving retire: one finished request's identity + measured
        latency — the join between 'tenant X is slow' and the trace the
        critpath sweep explains."""
        with self._lock:
            self._requests.append({
                "engine": engine, "rid": rid, "tenant": tenant or "-",
                "trace_id": trace_id, "latency_ms": latency_s * 1e3,
                "shed": bool(shed), "wall": time.time()})

    # -- cold-path triggers --------------------------------------------- #
    def on_burn_alert(self, component: str,
                      data: Optional[Dict[str, Any]] = None
                      ) -> Optional[str]:
        return self.triggers.offer("slo_burn", component, data)

    def on_degraded(self, component: str,
                    detail: Optional[str] = None) -> Optional[str]:
        return self.triggers.offer("watchdog_degraded", component,
                                   {"detail": detail} if detail else None)

    def on_quality_anomaly(self, component: str,
                           data: Optional[Dict[str, Any]] = None
                           ) -> Optional[str]:
        """obs/quality anomaly verdict (NaN storm, dead output, drift
        breach) — fired by the watchdog *before* the generic DEGRADED
        transition so this richer cause wins the rate limit."""
        return self.triggers.offer("quality_anomaly", component, data)

    def on_fleet_action(self, action: str,
                        entry: Optional[Dict[str, Any]] = None
                        ) -> Optional[str]:
        """fleet journal tap; skips/holds are bookkeeping, not
        incidents — only real scale/migrate actions capture."""
        if action not in ("scale_up", "scale_in", "migrate"):
            return None
        return self.triggers.offer("fleet_action", action, entry)

    # -- views ---------------------------------------------------------- #
    def recent_requests(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._requests)

    def critpath(self, min_ms: float = 0.0) -> Dict[str, Any]:
        """The ``GET /debug/diag/critpath`` payload."""
        out = rollup(_tracing.store(), min_ms=min_ms)
        out["requests"] = self.recent_requests()[-64:]
        return out

    def push_doc(self) -> Dict[str, Any]:
        """The fleet push-doc ``diag`` field (obs/fleet.py
        DIAG_PUSH_HOOK): bundle references + trigger accounting, small
        enough to ride every push."""
        return {"bundles": self.bundles.refs(),
                "triggers": dict(self.triggers.stats)}

    def snapshot(self) -> Dict[str, Any]:
        return {
            "bundle_dir": self.bundles.directory,
            "bundles": self.bundles.list(),
            "bundle_stats": dict(self.bundles.stats),
            "triggers": self.triggers.snapshot(),
            "requests": len(self._requests),
            "cost_model": self.cost_model is not None,
        }


# --------------------------------------------------------------------------- #
# enable/disable — the only DIAG_HOOK assignments in the tree
# --------------------------------------------------------------------------- #

def enable(directory: Optional[str] = None, *,
           min_interval_s: float = 30.0, dedup_window_s: float = 300.0,
           z_threshold: float = 4.0, min_samples: int = 16,
           max_bundles: int = 16,
           clock: Callable[[], float] = time.monotonic) -> DiagEngine:
    """Install the diag engine (idempotent). Also flips the obs/fleet
    ``DIAG_PUSH_HOOK`` so push docs start referencing local bundles,
    and anchors the cost-anomaly detector on the tune/ cost model when
    the autotuner is enabled."""
    global DIAG_HOOK
    if DIAG_HOOK is not None:
        return DIAG_HOOK
    from ... import tune as _tune

    tuner = _tune.tuner() if _tune.enabled() else None
    eng = DiagEngine(
        BundleStore(directory or DEFAULT_BUNDLE_DIR,
                    max_bundles=max_bundles),
        min_interval_s=min_interval_s, dedup_window_s=dedup_window_s,
        z_threshold=z_threshold, min_samples=min_samples,
        cost_model=getattr(tuner, "model", None),
        device_kind=_tune.device_kind() if tuner is not None else "",
        clock=clock)
    from .. import fleet as _obsfleet

    _obsfleet.DIAG_PUSH_HOOK = eng.push_doc
    DIAG_HOOK = eng
    return eng


def disable() -> None:
    global DIAG_HOOK
    DIAG_HOOK = None
    from .. import fleet as _obsfleet

    _obsfleet.DIAG_PUSH_HOOK = None


def enabled() -> bool:
    return DIAG_HOOK is not None


def engine() -> Optional[DiagEngine]:
    return DIAG_HOOK


def snapshot() -> Optional[Dict[str, Any]]:
    eng = DIAG_HOOK
    return eng.snapshot() if eng is not None else None


# env enable at import, mirroring NNSTPU_TRACE/PROFILE/...: "1" uses
# the default bundle dir, any other non-empty value IS the dir
_env = os.environ.get("NNSTPU_DIAG", "")
if _env:
    enable(None if _env == "1" else _env)
