"""Per-tenant cost attribution, goodput accounting, and SLO burn-rate tracking.

Port of nnstreamer_tpu/obs/slo.py (stdlib only). The sched layer made the
card multi-tenant; this module makes the *bill* multi-tenant.  It answers three questions the system-level metrics
cannot:

1. **Cost attribution** — which tenant burned the device-seconds?  Each
   coalesced batch's busy time is split across member tenants proportional
   to row count; each item's queue wait is charged to its own tenant; LM
   engine phase intervals (prefill/decode/verify) and router dispatch bytes
   are attributed per session.  Per-tenant ``device_seconds`` /
   ``wait_seconds`` sum to the engine totals — conservation is testable.

2. **Goodput** — deadline-met work per device-second.  Every completed unit
   of work lands in ``nnstpu_slo_goodput_total{tenant,outcome}`` with
   outcome ``met`` / ``missed`` / ``shed`` plus a latency histogram split
   by outcome.

3. **SLO objectives + burn rate** — declare per-tenant objectives
   (``p99_ms``, ``goodput_ratio``) via ``nns-launch-torch --slo
   TENANT:p99=50:goodput=0.99`` or :func:`set_objective`.  Burn rates are
   evaluated over a fast (5m) and slow (1h) window from a bounded
   ring-buffered event log with an injectable clock; a breach requires
   burn >= threshold on *both* windows (multi-window alerting), surfaces as
   a DEGRADED ``slo:<tenant>`` component in the health registry, emits
   ``slo.burn_alert``, shows in ``/debug/slo`` and the fleet rollup, and
   draws a per-tenant goodput counter lane in the Perfetto export.

The router's dispatch tap (``ROUTER_SLO_HOOK``, ``record_dispatch``) is
read by ``query.router.QueryRouter`` per successful dispatch; the fleet
push doc carries ``push_data()`` and an aggregator rolls it up.

Zero-overhead-when-off: the three hooks below are module globals that stay
``None`` until :func:`enable` is called.  Instrumented call sites pay one
module-attribute load plus a ``None`` check — the same contract as
``obs.profile``.  Set ``NNSTPU_SLO=1`` to enable at
import.

Tenant-label cardinality is bounded: at most ``max_tenants`` accounts are
kept (overflow folds into ``_overflow``), and router sessions only map to
a tenant label when that tenant is already registered (unknown sessions
fold into ``_other``).
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import events as _events
from . import health as _health
from . import metrics as _metrics

__all__ = [
    "SloRegistry",
    "enable",
    "disable",
    "enabled",
    "slo_registry",
    "set_objective",
    "snapshot",
    "push_data",
    "trace_points",
    "report",
    "parse_slo_spec",
    "event_burn_alert",
    "event_burn_recover",
]

# Defaults -----------------------------------------------------------------

DEFAULT_FAST_WINDOW_S = 300.0     # 5 minutes
DEFAULT_SLOW_WINDOW_S = 3600.0    # 1 hour
DEFAULT_BURN_THRESHOLD = 1.0
DEFAULT_MAX_TENANTS = 64
DEFAULT_WINDOW_EVENTS = 4096
P99_BUDGET = 0.01                 # a p99 objective budgets 1% of events
OTHER_TENANT = "_other"           # unregistered router sessions fold here
OVERFLOW_TENANT = "_overflow"     # accounts past max_tenants fold here
_OUTCOMES = ("met", "missed", "shed")
_TRACE_CAP = 4096

# Hooks --------------------------------------------------------------------
# None unless enable() was called; consumers load the module attribute and
# None-check before every use so a disabled run pays nothing.

#: Consumed by sched.engine.DeviceEngine at batch commit and shed.
SCHED_SLO_HOOK: Optional["SloRegistry"] = None
#: Consumed by serving LMEngine/TPLMEngine phase + retire + shed sites.
ENGINE_SLO_HOOK: Optional["SloRegistry"] = None
#: Consumed by query.router.QueryRouter per dispatch.
ROUTER_SLO_HOOK: Optional["SloRegistry"] = None


class _TenantAccount:
    """Mutable per-tenant accumulator. Guarded by the registry lock."""

    __slots__ = ("name", "device_s", "wait_s", "bytes_tx", "bytes_rx",
                 "outcomes", "shed_total", "events")

    def __init__(self, name: str, window_events: int) -> None:
        self.name = name
        self.device_s = 0.0
        self.wait_s = 0.0
        self.bytes_tx = 0
        self.bytes_rx = 0
        self.outcomes = {o: 0 for o in _OUTCOMES}
        self.shed_total = 0
        # (t, outcome, latency_s) ring feeding the burn-rate windows.
        self.events: deque = deque(maxlen=window_events)


class SloRegistry:
    """Per-tenant accounting plus multi-window SLO burn-rate evaluation.

    One instance is installed into the three module hooks by :func:`enable`.
    All recording methods are thread-safe and cheap; metric emission happens
    outside the lock.
    """

    def __init__(self, *, fast_window_s: float = DEFAULT_FAST_WINDOW_S,
                 slow_window_s: float = DEFAULT_SLOW_WINDOW_S,
                 burn_threshold: float = DEFAULT_BURN_THRESHOLD,
                 max_tenants: int = DEFAULT_MAX_TENANTS,
                 window_events: int = DEFAULT_WINDOW_EVENTS,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if not (0 < fast_window_s <= slow_window_s):
            raise ValueError("need 0 < fast_window_s <= slow_window_s")
        if burn_threshold <= 0:
            raise ValueError("burn_threshold must be > 0")
        if max_tenants < 1:
            raise ValueError("max_tenants must be >= 1")
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.burn_threshold = float(burn_threshold)
        self.max_tenants = int(max_tenants)
        self.window_events = int(window_events)
        self.clock = clock
        self._lock = threading.Lock()
        # Guarded by _lock:
        self._accounts: Dict[str, _TenantAccount] = {}
        self._objectives: Dict[str, Dict[str, float]] = {}
        self._trace: deque = deque(maxlen=_TRACE_CAP)
        self._register_metrics()

    # -- metrics ----------------------------------------------------------

    def _register_metrics(self) -> None:
        reg = _metrics.registry()
        self._m_goodput = reg.counter(
            "nnstpu_slo_goodput_total",
            "Completed work units per tenant split by deadline outcome",
            labelnames=("tenant", "outcome"))
        self._m_latency = reg.histogram(
            "nnstpu_slo_latency_seconds",
            "Per-tenant end-to-end latency split by deadline outcome",
            labelnames=("tenant", "outcome"))
        self._m_device = reg.histogram(
            "nnstpu_slo_device_seconds",
            "Per-tenant attributed device busy time per batch share",
            labelnames=("tenant",))
        self._m_wait = reg.histogram(
            "nnstpu_slo_wait_seconds",
            "Per-tenant queue wait per work item",
            labelnames=("tenant",))
        self._m_shed = reg.counter(
            "nnstpu_slo_shed_total",
            "Work units shed per tenant by site",
            labelnames=("tenant", "site"))
        self._m_bytes = reg.counter(
            "nnstpu_slo_bytes_total",
            "Bytes moved per tenant over the query wire by direction",
            labelnames=("tenant", "direction"))
        self._m_burn = reg.gauge(
            "nnstpu_slo_burn_ratio",
            "SLO error-budget burn rate per tenant/objective/window",
            labelnames=("tenant", "objective", "window"))

    # -- accounts (lock held) ---------------------------------------------

    def _account(self, name: str) -> _TenantAccount:
        acct = self._accounts.get(name)
        if acct is None:
            if len(self._accounts) >= self.max_tenants:
                name = OVERFLOW_TENANT
                acct = self._accounts.get(name)
                if acct is None:
                    acct = _TenantAccount(name, self.window_events)
                    self._accounts[name] = acct
            else:
                acct = _TenantAccount(name, self.window_events)
                self._accounts[name] = acct
        return acct

    def _record_outcome(self, acct: _TenantAccount, outcome: str,
                        latency_s: float, t: float) -> None:
        acct.outcomes[outcome] += 1
        if outcome == "shed":
            acct.shed_total += 1
        acct.events.append((t, outcome, latency_s))
        self._trace.append({
            "t_ns": time.monotonic_ns(),
            "tenant": acct.name,
            "met": acct.outcomes["met"],
            "missed": acct.outcomes["missed"],
            "shed": acct.outcomes["shed"],
        })

    # -- recording hooks --------------------------------------------------

    def record_sched_batch(self, engine: str, busy_s: float,
                           members: Sequence[Tuple[str, float, int, Any]],
                           ) -> None:
        """Attribute one committed batch to its member tenants.

        ``members`` is ``[(tenant, wait_s, rows, deadline), ...]``.  Busy
        time splits proportional to rows so the per-tenant sum equals
        ``busy_s`` exactly; waits charge each tenant directly.
        """
        if not members:
            return
        total_rows = sum(max(int(r), 1) for (_, _, r, _) in members)
        t = self.clock()
        emit: List[Tuple[str, str, float, float, float]] = []
        with self._lock:
            for (tenant, wait_s, rows, deadline) in members:
                share = busy_s * (max(int(rows), 1) / total_rows)
                acct = self._account(tenant)
                acct.device_s += share
                acct.wait_s += wait_s
                outcome = "met"
                if deadline is not None:
                    try:
                        if deadline.expired():
                            outcome = "missed"
                    except Exception:
                        pass
                latency = wait_s + share
                self._record_outcome(acct, outcome, latency, t)
                emit.append((acct.name, outcome, share, wait_s, latency))
        for (name, outcome, share, wait_s, latency) in emit:
            self._m_device.labels(name).observe(share)
            self._m_wait.labels(name).observe(wait_s)
            self._m_goodput.labels(name, outcome).inc()
            self._m_latency.labels(name, outcome).observe(latency)

    def record_shed(self, tenant: str, site: str,
                    wait_s: float = 0.0) -> None:
        """One work unit dropped before execution (deadline or pressure).

        The shed's wait feeds the goodput/latency window but NOT the
        tenant's ``wait_s`` account — shed work never reached the device,
        so attribution conservation stays exact against engine totals.
        """
        t = self.clock()
        with self._lock:
            acct = self._account(tenant)
            self._record_outcome(acct, "shed", wait_s, t)
            name = acct.name
        self._m_shed.labels(name, site).inc()
        self._m_goodput.labels(name, "shed").inc()
        self._m_latency.labels(name, "shed").observe(wait_s)

    def record_outcome(self, tenant: str, outcome: str,
                       latency_s: float) -> None:
        """A completed request (serving retire path): met or missed."""
        if outcome not in _OUTCOMES:
            outcome = "met"
        t = self.clock()
        with self._lock:
            acct = self._account(tenant)
            self._record_outcome(acct, outcome, latency_s, t)
            name = acct.name
        self._m_goodput.labels(name, outcome).inc()
        self._m_latency.labels(name, outcome).observe(latency_s)

    def record_engine_phase(self, tenant: str, phase: str,
                            dur_s: float) -> None:
        """Attribute one LM engine phase interval (prefill/decode/verify)."""
        with self._lock:
            acct = self._account(tenant)
            acct.device_s += dur_s
            name = acct.name
        self._m_device.labels(name).observe(dur_s)

    def record_dispatch(self, session: Optional[str], bytes_tx: int,
                        bytes_rx: int) -> None:
        """Attribute one router dispatch's wire bytes to a session tenant.

        Sessions only map to a tenant label when that name is already a
        registered account or objective — everything else folds into
        ``_other`` so the label set stays bounded.
        """
        with self._lock:
            if session is not None and (session in self._accounts
                                        or session in self._objectives):
                acct = self._account(session)
            else:
                acct = self._account(OTHER_TENANT)
            acct.bytes_tx += int(bytes_tx)
            acct.bytes_rx += int(bytes_rx)
            name = acct.name
        self._m_bytes.labels(name, "tx").inc(int(bytes_tx))
        self._m_bytes.labels(name, "rx").inc(int(bytes_rx))

    # -- objectives + burn ------------------------------------------------

    def set_objective(self, tenant: str, *, p99_ms: Optional[float] = None,
                      goodput_ratio: Optional[float] = None) -> None:
        if p99_ms is None and goodput_ratio is None:
            raise ValueError("objective needs p99_ms and/or goodput_ratio")
        if p99_ms is not None and p99_ms <= 0:
            raise ValueError("p99_ms must be > 0")
        if goodput_ratio is not None and not (0.0 < goodput_ratio < 1.0):
            raise ValueError("goodput_ratio must be in (0, 1)")
        obj: Dict[str, float] = {}
        if p99_ms is not None:
            obj["p99_ms"] = float(p99_ms)
        if goodput_ratio is not None:
            obj["goodput_ratio"] = float(goodput_ratio)
        with self._lock:
            self._objectives[tenant] = obj
            self._account(tenant)
        self._ensure_component(tenant)

    def _ensure_component(self, tenant: str) -> None:
        ref = weakref.ref(self)

        def probe() -> Optional[Dict[str, Any]]:
            reg = ref()
            if reg is None or _SLO is not reg:
                return None  # retire the component
            with reg._lock:
                if tenant not in reg._objectives:
                    return None
            return reg.evaluate(tenant)

        _health.component(f"slo:{tenant}", kind="slo", probe=probe,
                          attrs={"tenant": tenant})

    def evaluate(self, tenant: str,
                 now: Optional[float] = None) -> Dict[str, Any]:
        """Compute burn rates for one tenant over both windows.

        Burn semantics: for a ``goodput_ratio`` objective the burn is the
        observed bad fraction (missed+shed)/n divided by the budgeted bad
        fraction (1 - ratio).  For a ``p99_ms`` objective the burn is the
        fraction of events that were shed or slower than the target,
        divided by the 1% budget a p99 implies.  Burn 1.0 means the budget
        is being consumed exactly at the sustainable rate; a breach
        requires burn >= threshold on BOTH windows.
        """
        t = self.clock() if now is None else now
        with self._lock:
            obj = dict(self._objectives.get(tenant, {}))
            acct = self._accounts.get(tenant)
            evs = list(acct.events) if acct is not None else []
        windows: Dict[str, Dict[str, Any]] = {}
        for (wname, wlen) in (("fast", self.fast_window_s),
                              ("slow", self.slow_window_s)):
            recent = [(ts, o, lat) for (ts, o, lat) in evs
                      if t - ts <= wlen]
            n = len(recent)
            met = sum(1 for (_, o, _) in recent if o == "met")
            missed = sum(1 for (_, o, _) in recent if o == "missed")
            shed = sum(1 for (_, o, _) in recent if o == "shed")
            burn: Dict[str, float] = {}
            if n:
                if "goodput_ratio" in obj:
                    budget = 1.0 - obj["goodput_ratio"]
                    burn["goodput"] = ((missed + shed) / n) / budget
                if "p99_ms" in obj:
                    p99_s = obj["p99_ms"] / 1e3
                    slow = sum(1 for (_, o, lat) in recent
                               if o == "shed" or lat > p99_s)
                    burn["p99"] = (slow / n) / P99_BUDGET
            else:
                if "goodput_ratio" in obj:
                    burn["goodput"] = 0.0
                if "p99_ms" in obj:
                    burn["p99"] = 0.0
            windows[wname] = {
                "n": n, "met": met, "missed": missed, "shed": shed,
                "goodput": (met / n) if n else 1.0,
                "burn": burn,
            }
        breached_objs: List[str] = []
        worst_obj: Optional[str] = None
        worst_burn = -1.0
        for oname in windows["fast"]["burn"]:
            fast_b = windows["fast"]["burn"][oname]
            slow_b = windows["slow"]["burn"][oname]
            if (fast_b >= self.burn_threshold
                    and slow_b >= self.burn_threshold):
                breached_objs.append(oname)
            eff = min(fast_b, slow_b)
            if eff > worst_burn:
                worst_burn = eff
                worst_obj = oname
            self._m_burn.labels(tenant, oname, "fast").set(fast_b)
            self._m_burn.labels(tenant, oname, "slow").set(slow_b)
        return {
            "tenant": tenant,
            "objective": obj,
            "windows": windows,
            "breached": bool(breached_objs),
            "breached_objectives": breached_objs,
            "worst_objective": worst_obj,
            "worst_burn": max(worst_burn, 0.0),
            "burn_threshold": self.burn_threshold,
        }

    # -- export -----------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            names = list(self._accounts)
            rows: Dict[str, Dict[str, Any]] = {}
            for name in names:
                acct = self._accounts[name]
                rows[name] = {
                    "device_seconds": acct.device_s,
                    "wait_seconds": acct.wait_s,
                    "bytes_tx": acct.bytes_tx,
                    "bytes_rx": acct.bytes_rx,
                    "outcomes": dict(acct.outcomes),
                    "shed_total": acct.shed_total,
                    "objective": dict(self._objectives.get(name, {})),
                }
            objective_names = list(self._objectives)
        for name in objective_names:
            # Health may have been enabled after the objective was set —
            # re-registering is a cheap get-or-create.
            self._ensure_component(name)
            row = rows.setdefault(name, {
                "device_seconds": 0.0, "wait_seconds": 0.0,
                "bytes_tx": 0, "bytes_rx": 0,
                "outcomes": {o: 0 for o in _OUTCOMES}, "shed_total": 0,
                "objective": {},
            })
            row["burn"] = self.evaluate(name)
        return {
            "enabled": True,
            "burn_threshold": self.burn_threshold,
            "windows": {"fast_s": self.fast_window_s,
                        "slow_s": self.slow_window_s},
            "tenants": rows,
        }

    def trace_points(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._trace)

    def report(self) -> str:
        snap = self.snapshot()
        lines = ["slo: per-tenant accounting"]
        for (name, row) in sorted(snap["tenants"].items()):
            out = row["outcomes"]
            lines.append(
                "  %-16s device=%.4fs wait=%.4fs met=%d missed=%d shed=%d"
                % (name, row["device_seconds"], row["wait_seconds"],
                   out["met"], out["missed"], out["shed"]))
            burn = row.get("burn")
            if burn and burn["objective"]:
                state = "BREACHED" if burn["breached"] else "ok"
                lines.append(
                    "  %-16s slo=%s worst_burn=%.2f (%s) %s"
                    % ("", burn["objective"], burn["worst_burn"],
                       burn["worst_objective"], state))
        return "\n".join(lines)


# Module API ---------------------------------------------------------------

_SLO: Optional[SloRegistry] = None


def slo_registry() -> Optional[SloRegistry]:
    return _SLO


def enabled() -> bool:
    return _SLO is not None


def enable(**kwargs: Any) -> SloRegistry:
    """Install a fresh :class:`SloRegistry` into the three hooks."""
    global _SLO, SCHED_SLO_HOOK, ENGINE_SLO_HOOK, ROUTER_SLO_HOOK
    reg = SloRegistry(**kwargs)
    _SLO = reg
    SCHED_SLO_HOOK = reg
    ENGINE_SLO_HOOK = reg
    ROUTER_SLO_HOOK = reg
    _events.record("slo.capture_start", "slo accounting enabled")
    return reg


def disable() -> None:
    global _SLO, SCHED_SLO_HOOK, ENGINE_SLO_HOOK, ROUTER_SLO_HOOK
    if _SLO is not None:
        _events.record("slo.capture_stop", "slo accounting disabled")
    _SLO = None
    SCHED_SLO_HOOK = None
    ENGINE_SLO_HOOK = None
    ROUTER_SLO_HOOK = None


def set_objective(tenant: str, *, p99_ms: Optional[float] = None,
                  goodput_ratio: Optional[float] = None) -> None:
    reg = _SLO
    if reg is None:
        raise RuntimeError("slo is not enabled; call slo.enable() first")
    reg.set_objective(tenant, p99_ms=p99_ms, goodput_ratio=goodput_ratio)


def snapshot() -> Dict[str, Any]:
    reg = _SLO
    if reg is None:
        return {"enabled": False, "tenants": {}}
    return reg.snapshot()


def push_data() -> Optional[Dict[str, Any]]:
    """Compact snapshot for the fleet push doc; None while disabled."""
    reg = _SLO
    if reg is None:
        return None
    return reg.snapshot()


def trace_points() -> List[Dict[str, Any]]:
    reg = _SLO
    if reg is None:
        return []
    return reg.trace_points()


def report() -> str:
    reg = _SLO
    if reg is None:
        return "slo: off"
    return reg.report()


def parse_slo_spec(text: str) -> Dict[str, Dict[str, float]]:
    """Parse ``TENANT:p99=50:goodput=0.99[,TENANT2:...]`` into objectives.

    Returns ``{tenant: {"p99_ms": ..., "goodput_ratio": ...}}`` with each
    tenant carrying at least one objective.  Raises ValueError on malformed
    specs, duplicate tenants, or out-of-range values.
    """
    out: Dict[str, Dict[str, float]] = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            raise ValueError("empty --slo entry")
        fields = part.split(":")
        tenant = fields[0].strip()
        if not tenant:
            raise ValueError("missing tenant name in --slo entry %r" % part)
        if tenant in out:
            raise ValueError("duplicate tenant %r in --slo" % tenant)
        if len(fields) < 2:
            raise ValueError("tenant %r declares no objectives" % tenant)
        obj: Dict[str, float] = {}
        for field in fields[1:]:
            if "=" not in field:
                raise ValueError("bad objective %r (want key=value)" % field)
            key, _, val = field.partition("=")
            key = key.strip()
            try:
                num = float(val)
            except ValueError:
                raise ValueError("bad value in objective %r" % field)
            if key == "p99":
                if num <= 0:
                    raise ValueError("p99 must be > 0 in %r" % part)
                obj["p99_ms"] = num
            elif key == "goodput":
                if not (0.0 < num < 1.0):
                    raise ValueError("goodput must be in (0, 1) in %r" % part)
                obj["goodput_ratio"] = num
            else:
                raise ValueError("unknown objective key %r" % key)
        out[tenant] = obj
    return out


# Event helpers — this module owns the slo.* event-type literals so the
# nnslint event-layer-placement rule holds (health calls these lazily).

def event_burn_alert(component: str, data: Dict[str, Any]) -> None:
    _events.record(
        "slo.burn_alert",
        "SLO burn threshold breached for %s" % component,
        severity="warning",
        component=component,
        tenant=data.get("tenant"),
        worst_objective=data.get("worst_objective"),
        worst_burn=data.get("worst_burn"),
        breached_objectives=data.get("breached_objectives"),
    )
    # burn alerts are THE diag capture trigger — cold path, lazy
    # import keeps the obs package import graph acyclic
    from . import diag as _diag
    dhook = _diag.DIAG_HOOK
    if dhook is not None:
        dhook.on_burn_alert(component, data)


def event_burn_recover(component: str, data: Dict[str, Any]) -> None:
    _events.record(
        "slo.recover",
        "SLO burn recovered for %s" % component,
        component=component,
        tenant=data.get("tenant"),
    )


if os.environ.get("NNSTPU_SLO", "") == "1":
    enable()
