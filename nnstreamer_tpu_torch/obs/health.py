"""Health model: component liveness registry + stall watchdog.

Port of nnstreamer_tpu/obs/health.py (stdlib only). The JAX module's
rules for the SLO layer (``kind="slo"``, burn-rate breaches), the
data-plane quality layer (``kind="quality"``) and the fleet's push
heartbeat (``kind="fleet"``, with ``status_from_string`` for its rollup),
and the diag layer's capture on escalation (``DIAG_HOOK.on_degraded``),
wait for the port of ``obs/slo.py``, ``obs/quality``, ``obs/diag``
(ROADMAP §A7) and ``obs/fleet.py`` (§A9): a component of those kinds is
tracked and never judged.

The dangerous failure mode of a long-running streaming graph is not a
crash but a silent stall — an element stops pulling, a query peer
half-disconnects, a serving request sits in admission forever. Metrics
and traces say how fast the system is; this module says whether it is
*alive*.

**Components** are named liveness reporters registered by the pipeline
instrumentation (one per element), the query client/server elements,
and the serving engines. Each carries a :class:`Status` — OK <
DEGRADED < STALLED < FAILED, ordered so the aggregate is a ``max()`` —
a free-form detail string, a last-heartbeat stamp (``beat()``, written
by the obs/instrument.py chain wrappers per buffer), monotonically
increasing event counts (``count()``), and an optional ``probe``
callable returning a point-in-time dict (queue depth, engine wait...).
A probe returning None retires its component (weakref-backed probes:
the registry never pins a dead pipeline or engine).

**The watchdog** is one daemon thread (started lazily on first
registration while enabled — never when off) applying these rules each
tick and recording its verdicts as flight-recorder events
(obs/events.py):

  * *element stall*: a running, non-EOS pipeline's element that has
    processed at least one buffer but none for ``stall_after_s`` →
    STALLED (``pipeline.stall`` event with the element name, stall age,
    and the element's last-seen trace id);
  * *queue dwell*: a queue-ish element probe reporting
    ``depth >= bound`` continuously for ``queue_dwell_s`` → DEGRADED
    (``pipeline.queue_full``);
  * *reconnect storm*: a query component whose ``reconnect`` count
    rises by ``reconnect_storm`` within ``reconnect_window_s`` →
    DEGRADED (``query.reconnect_storm``);
  * *admission stall*: a serving engine probe reporting a queued
    request waiting past ``admission_deadline_s`` → STALLED
    (``serving.admission_stall``);
  * *starvation storm*: a sched engine whose starvation-relief count
    rises by ``starvation_storm`` within ``starvation_window_s`` →
    DEGRADED (``sched.starvation_storm``).

Recovery flips the verdict back to OK and records the matching
``<layer>.recover`` event, so flapping is visible.

**Readiness** is a separate axis: named boolean conditions
(pipeline PLAYING, engine warmed = first bucket compiled, query
connected) registered by the same integration points, aggregated by
``readiness()`` and served at ``/readyz`` on the exporter — 503 until
every condition holds (and while none are registered: a server that
has nothing ready yet is not ready). ``/healthz`` stays liveness:
200 while the aggregate is OK/DEGRADED, 503 on STALLED/FAILED.

Same contract as metrics/tracing/events: off by default
(``NNSTPU_HEALTH=1`` or ``enable()`` — BEFORE building pipelines and
engines, like the others), and structurally free while off: no
components, no conditions, no thread, one flag check.
"""

from __future__ import annotations

import enum
import os
import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import events as _events

__all__ = [
    "Component", "HealthRegistry", "Status", "add_readiness",
    "component", "check_now", "disable", "enable", "enabled",
    "readiness", "registry", "snapshot",
    "status_string", "track_pipeline",
]


class Status(enum.IntEnum):
    """Severity-ordered so an aggregate is ``max()`` over components."""

    OK = 0
    DEGRADED = 1
    STALLED = 2
    FAILED = 3


#: /healthz "status" strings; FAILED renders as "failing" (an ongoing
#: condition, not a past event)
_STATUS_STRINGS = {
    Status.OK: "ok",
    Status.DEGRADED: "degraded",
    Status.STALLED: "stalled",
    Status.FAILED: "failing",
}


def status_string(s: Status) -> str:
    return _STATUS_STRINGS[s]


class Component:
    """One liveness reporter. All mutators are lock-free single-field
    writes (GIL-atomic) — they run on buffer hot paths."""

    __slots__ = ("name", "kind", "probe", "attrs", "status", "detail",
                 "since", "last_beat_ns", "last_trace_id", "counts")

    def __init__(self, name: str, kind: str = "generic",
                 probe: Optional[Callable[[], Optional[Dict[str, Any]]]]
                 = None, attrs: Optional[Dict[str, Any]] = None):
        self.name = name
        self.kind = kind
        self.probe = probe
        self.attrs = dict(attrs) if attrs else {}
        self.status = Status.OK
        self.detail = ""
        self.since = time.time()
        self.last_beat_ns: Optional[int] = None
        #: trace id of the last buffer seen (stamped by the chain
        #: wrapper when tracing is on) — watchdog verdicts carry it so
        #: a stall correlates with the trace that stopped moving
        self.last_trace_id: Optional[str] = None
        self.counts: Dict[str, int] = {}

    def beat(self) -> None:
        """Heartbeat: "I just processed work"."""
        self.last_beat_ns = time.monotonic_ns()

    def set_status(self, status: Status, detail: str = "") -> None:
        if status != self.status:
            self.since = time.time()
        self.status = status
        self.detail = detail

    def count(self, key: str, n: int = 1) -> None:
        self.counts[key] = self.counts.get(key, 0) + n

    def snapshot(self, now_ns: Optional[int] = None) -> Dict[str, Any]:
        now_ns = now_ns if now_ns is not None else time.monotonic_ns()
        d: Dict[str, Any] = {
            "name": self.name,
            "kind": self.kind,
            "status": status_string(self.status),
            "detail": self.detail,
            "since": self.since,
            "last_beat_age_s": ((now_ns - self.last_beat_ns) / 1e9
                                if self.last_beat_ns else None),
        }
        if self.counts:
            d["counts"] = dict(self.counts)
        if self.probe is not None:
            try:
                data = self.probe()
            except Exception:  # noqa: BLE001 — a probe must not 500 /healthz
                data = None
            if data is not None:
                d["probe"] = data
        return d


class _NoopComponent:
    """Returned by ``component()`` while health is off: every reporter
    call is a no-op on one shared instance — zero per-site state."""

    __slots__ = ()
    name = ""
    kind = "noop"
    status = Status.OK
    last_trace_id = None

    def beat(self) -> None:
        pass

    def set_status(self, status: Status, detail: str = "") -> None:
        pass

    def count(self, key: str, n: int = 1) -> None:
        pass


NOOP_COMPONENT = _NoopComponent()


class HealthRegistry:
    """Component + readiness-condition registry with the watchdog."""

    def __init__(self, enabled: bool = False):
        self._lock = threading.Lock()
        self._enabled = bool(enabled)
        self._components: "OrderedDict[str, Component]" = OrderedDict()  # guarded-by: _lock
        #: readiness conditions: name -> fn() -> True/False, or None to
        #: self-retire (weakref-backed: owner collected)
        self._conditions: "OrderedDict[str, Callable]" = OrderedDict()
        #: per-component watchdog bookkeeping (verdict flags, windows)
        self._wd_state: Dict[str, Dict[str, Any]] = {}
        self._wd_thread: Optional[threading.Thread] = None
        self._wd_stop = threading.Event()
        # thresholds (configure()/enable() override)
        self.stall_after_s = 5.0
        self.queue_dwell_s = 5.0
        self.reconnect_storm = 5
        self.reconnect_window_s = 10.0
        self.admission_deadline_s = 30.0
        self.starvation_storm = 3
        self.starvation_window_s = 10.0
        self.interval_s: Optional[float] = None  # None = stall_after/4

    # -- enable/disable ------------------------------------------------ #
    @property
    def is_enabled(self) -> bool:
        return self._enabled

    def configure(self, **thresholds: Any) -> None:
        for k, v in thresholds.items():
            if v is None:
                continue
            if not hasattr(self, k):
                raise TypeError(f"unknown health threshold {k!r}")
            setattr(self, k, v)

    def enable(self, **thresholds: Any) -> None:
        self.configure(**thresholds)
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False
        self._stop_watchdog()

    def reset(self) -> None:
        """Drop all components/conditions and stop the watchdog
        (tests)."""
        self._stop_watchdog()
        with self._lock:
            self._components.clear()
            self._conditions.clear()
            self._wd_state.clear()

    # -- registration -------------------------------------------------- #
    def component(self, name: str, kind: str = "generic",
                  probe: Optional[Callable] = None,
                  attrs: Optional[Dict[str, Any]] = None):
        """Get-or-create a component; the shared no-op while disabled
        (the structural fast path: nothing is ever registered)."""
        if not self._enabled:
            return NOOP_COMPONENT
        with self._lock:
            c = self._components.get(name)
            if c is None:
                c = Component(name, kind, probe, attrs)
                self._components[name] = c
            else:
                if probe is not None:
                    c.probe = probe
                if attrs:
                    c.attrs.update(attrs)
        self._ensure_watchdog()
        return c

    def add_readiness(self, name: str, fn: Callable) -> None:
        """Register a readiness condition; no-op while disabled."""
        if not self._enabled:
            return
        with self._lock:
            self._conditions[name] = fn
        self._ensure_watchdog()

    # -- aggregation ---------------------------------------------------- #
    def aggregate(self) -> Status:
        with self._lock:
            comps = list(self._components.values())
        worst = Status.OK
        for c in comps:
            if c.status > worst:
                worst = c.status
        return worst

    def snapshot(self) -> Dict[str, Any]:
        """The /healthz body core: aggregate status string, liveness
        verdict, and per-component detail."""
        if not self._enabled:
            return {"status": "ok", "ok": True, "components": []}
        now_ns = time.monotonic_ns()
        with self._lock:
            comps = list(self._components.values())
        agg = Status.OK
        for c in comps:
            if c.status > agg:
                agg = c.status
        return {
            "status": status_string(agg),
            # liveness: DEGRADED still serves; STALLED/FAILED does not
            "ok": agg <= Status.DEGRADED,
            "components": [c.snapshot(now_ns) for c in comps],
        }

    def readiness(self) -> Tuple[bool, Dict[str, bool]]:
        """(ready, {condition: holds}). Disabled health → vacuously
        ready (the endpoint must not fail deployments that never opted
        in); enabled with zero conditions → NOT ready (nothing has
        declared itself ready yet)."""
        if not self._enabled:
            return True, {}
        with self._lock:
            conds = list(self._conditions.items())
        out: Dict[str, bool] = {}
        dead: List[str] = []
        for name, fn in conds:
            try:
                v = fn()
            except Exception:  # noqa: BLE001
                v = False
            if v is None:
                dead.append(name)
                continue
            out[name] = bool(v)
        if dead:
            with self._lock:
                for name in dead:
                    self._conditions.pop(name, None)
        return bool(out) and all(out.values()), out

    # -- watchdog ------------------------------------------------------- #
    def _interval(self) -> float:
        if self.interval_s is not None:
            return max(float(self.interval_s), 0.01)
        return min(max(float(self.stall_after_s) / 4.0, 0.05), 1.0)

    def _ensure_watchdog(self) -> None:
        if self._wd_thread is not None and self._wd_thread.is_alive():
            return
        self._wd_stop.clear()
        self._wd_thread = threading.Thread(
            target=self._wd_loop, daemon=True, name="obs-health-watchdog")
        self._wd_thread.start()

    def _stop_watchdog(self) -> None:
        self._wd_stop.set()
        t = self._wd_thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5)
        self._wd_thread = None

    def _wd_loop(self) -> None:
        while not self._wd_stop.wait(self._interval()):
            try:
                self.check_now()
            except Exception:  # noqa: BLE001 — the watchdog never dies
                pass

    def check_now(self) -> None:
        """One synchronous watchdog pass (the thread's tick; callable
        directly for deterministic tests)."""
        now_ns = time.monotonic_ns()
        with self._lock:
            comps = list(self._components.items())
        for name, c in comps:
            data: Optional[Dict[str, Any]] = None
            if c.probe is not None:
                try:
                    data = c.probe()
                except Exception:  # noqa: BLE001 — skip this tick
                    continue
                if data is None:
                    # probe says its owner is gone: retire the component
                    with self._lock:
                        self._components.pop(name, None)
                        self._wd_state.pop(name, None)
                    continue
            st = self._wd_state.setdefault(name, {})
            if c.kind == "element":
                self._check_element(c, st, data or {}, now_ns)
            elif c.kind == "query":
                self._check_query(c, st, now_ns)
            elif c.kind == "serving":
                self._check_serving(c, st, data or {})
            elif c.kind == "sched":
                self._check_sched(c, st, data or {}, now_ns)

    # rule: per-element last-buffer heartbeat → STALLED
    def _check_element(self, c: Component, st: Dict[str, Any],
                       data: Dict[str, Any], now_ns: int) -> None:
        running = bool(data.get("running", True))
        eos = bool(data.get("eos", False))
        active = running and not eos and c.last_beat_ns is not None
        if active:
            age_s = (now_ns - c.last_beat_ns) / 1e9
            if age_s > float(self.stall_after_s):
                if not st.get("stall"):
                    st["stall"] = True
                    c.set_status(Status.STALLED,
                                 f"no buffer for {age_s:.2f}s")
                    _events.record(
                        "pipeline.stall",
                        f"{c.name}: no buffer for {age_s:.2f}s",
                        severity="warning", trace_id=c.last_trace_id,
                        stall_s=round(age_s, 3), **c.attrs)
                return  # stalled: skip the queue rule this tick
            if st.pop("stall", None):
                c.set_status(Status.OK, "buffers flowing again")
                _events.record("pipeline.recover",
                               f"{c.name}: buffers flowing again",
                               **c.attrs)
        elif st.pop("stall", None):
            # pipeline stopped or reached EOS: the verdict expires
            c.set_status(Status.OK, "stopped" if not running else "eos")
        # rule: queue high-watermark dwell → DEGRADED
        depth, bound = data.get("depth"), data.get("bound")
        if depth is None or not bound:
            return
        if active and depth >= bound:
            full_since = st.setdefault("full_since", now_ns)
            dwell_s = (now_ns - full_since) / 1e9
            if dwell_s > float(self.queue_dwell_s) and not st.get("full"):
                st["full"] = True
                c.set_status(Status.DEGRADED,
                             f"queue full ({depth}/{bound}) for "
                             f"{dwell_s:.2f}s")
                _events.record(
                    "pipeline.queue_full",
                    f"{c.name}: full ({depth}/{bound}) for {dwell_s:.2f}s",
                    severity="warning", trace_id=c.last_trace_id,
                    depth=depth, bound=bound, **c.attrs)
        else:
            st.pop("full_since", None)
            if st.pop("full", None):
                c.set_status(Status.OK, "queue draining")
                _events.record("pipeline.recover",
                               f"{c.name}: queue draining", **c.attrs)

    # rule: query reconnect storm → DEGRADED
    def _check_query(self, c: Component, st: Dict[str, Any],
                     now_ns: int) -> None:
        rc = c.counts.get("reconnect", 0)
        if "win_start" not in st:
            st["win_start"], st["win_rc"] = now_ns, rc
            return
        if (now_ns - st["win_start"]) / 1e9 < float(self.reconnect_window_s):
            return
        delta = rc - st["win_rc"]
        if delta >= int(self.reconnect_storm):
            if not st.get("storm"):
                st["storm"] = True
                # never mask an owner-set FAILED with the softer verdict
                if c.status < Status.DEGRADED:
                    c.set_status(
                        Status.DEGRADED,
                        f"{delta} reconnects in "
                        f"{self.reconnect_window_s:.0f}s")
                _events.record(
                    "query.reconnect_storm",
                    f"{c.name}: {delta} reconnects in "
                    f"{self.reconnect_window_s:.0f}s",
                    severity="warning", reconnects=delta, **c.attrs)
        elif st.pop("storm", None):
            if c.status == Status.DEGRADED:
                c.set_status(Status.OK, "reconnects settled")
            _events.record("query.recover",
                           f"{c.name}: reconnects settled", **c.attrs)
        st["win_start"], st["win_rc"] = now_ns, rc

    # rule: scheduler starvation storm → DEGRADED
    # (sched/engine.py registers one kind="sched" component per engine;
    # the probe reports its monotonically increasing relief count —
    # same windowed-delta shape as the reconnect-storm rule)
    def _check_sched(self, c: Component, st: Dict[str, Any],
                     data: Dict[str, Any], now_ns: int) -> None:
        reliefs = int(data.get("starvation_reliefs") or 0)
        if "win_start" not in st:
            st["win_start"], st["win_reliefs"] = now_ns, reliefs
            return
        if (now_ns - st["win_start"]) / 1e9 \
                < float(self.starvation_window_s):
            return
        delta = reliefs - st["win_reliefs"]
        # sched.* event literals live in the sched layer; import lazily
        # (no cycle: sched imports obs at module load, not vice versa)
        from ..sched import telemetry as _sched_tel
        if delta >= int(self.starvation_storm):
            if not st.get("storm"):
                st["storm"] = True
                if c.status < Status.DEGRADED:
                    c.set_status(
                        Status.DEGRADED,
                        f"{delta} starvation reliefs in "
                        f"{self.starvation_window_s:.0f}s")
                _sched_tel.event_starvation_storm(
                    c.name, delta, float(self.starvation_window_s),
                    **c.attrs)
        elif st.pop("storm", None):
            if c.status == Status.DEGRADED:
                c.set_status(Status.OK, "starvation reliefs settled")
            _sched_tel.event_starvation_recover(c.name, **c.attrs)
        st["win_start"], st["win_reliefs"] = now_ns, reliefs

    # rule: serving request stuck in admission → STALLED
    def _check_serving(self, c: Component, st: Dict[str, Any],
                       data: Dict[str, Any]) -> None:
        wait = float(data.get("oldest_wait_s") or 0.0)
        if wait > float(self.admission_deadline_s):
            if not st.get("admission"):
                st["admission"] = True
                c.set_status(Status.STALLED,
                             f"request waiting {wait:.1f}s for a slot")
                _events.record(
                    "serving.admission_stall",
                    f"{c.name}: request waiting {wait:.1f}s for a slot",
                    severity="warning", oldest_wait_s=round(wait, 3),
                    **c.attrs)
        elif st.pop("admission", None):
            c.set_status(Status.OK, "admission moving")
            _events.record("serving.recover",
                           f"{c.name}: admission moving", **c.attrs)


# --------------------------------------------------------------------------- #
# Process-global registry + integration helpers
# --------------------------------------------------------------------------- #

#: off by default — the watchdog thread only ever starts after the
#: first registration while enabled (import starts nothing)
_REGISTRY = HealthRegistry(
    enabled=os.environ.get("NNSTPU_HEALTH", "") == "1")


def registry() -> HealthRegistry:
    return _REGISTRY


def enabled() -> bool:
    return _REGISTRY._enabled


def enable(**thresholds: Any) -> None:
    """Turn the health model on (``stall_after_s=``, ``queue_dwell_s=``,
    ``reconnect_storm=``, ``reconnect_window_s=``,
    ``admission_deadline_s=``, ``starvation_storm=``,
    ``starvation_window_s=``, ``interval_s=`` thresholds accepted).
    Like metrics/tracing: call BEFORE building pipelines/engines — the
    integration points register components at construction/start
    time."""
    _REGISTRY.enable(**thresholds)


def disable() -> None:
    _REGISTRY.disable()


def component(name: str, kind: str = "generic",
              probe: Optional[Callable] = None,
              attrs: Optional[Dict[str, Any]] = None):
    return _REGISTRY.component(name, kind, probe=probe, attrs=attrs)


def add_readiness(name: str, fn: Callable) -> None:
    _REGISTRY.add_readiness(name, fn)


def snapshot() -> Dict[str, Any]:
    return _REGISTRY.snapshot()


def readiness() -> Tuple[bool, Dict[str, bool]]:
    return _REGISTRY.readiness()


def check_now() -> None:
    _REGISTRY.check_now()


def element_probe(pipeline: Any, el: Any) -> Callable:
    """Weakref probe for one pipeline element: pipeline run/EOS state
    (the watchdog must not call a stopped pipeline stalled) merged with
    the element's own ``health_probe()`` dict (queue depth/bound) when
    it defines one. Returns None once either owner is collected."""
    wp, we = weakref.ref(pipeline), weakref.ref(el)

    def probe() -> Optional[Dict[str, Any]]:
        p, e = wp(), we()
        if p is None or e is None:
            return None
        d: Dict[str, Any] = {"running": p.running,
                             "eos": p.bus.wait_eos(0)}
        hp = getattr(e, "health_probe", None)
        if hp is not None:
            d.update(hp())
        return d

    return probe


def track_pipeline(pipeline: Any) -> None:
    """Pipeline.start hook (via obs/instrument.py): registers the
    readiness condition "pipeline PLAYING" for this pipeline. Weakref:
    a collected pipeline retires its condition instead of pinning it
    not-ready forever."""
    if not _REGISTRY._enabled:
        return
    wp = weakref.ref(pipeline)

    def cond() -> Optional[bool]:
        p = wp()
        return None if p is None else bool(p.running)

    _REGISTRY.add_readiness(f"pipeline:{pipeline.name}", cond)
