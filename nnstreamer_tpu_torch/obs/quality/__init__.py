"""Data-plane observability: tensor stats, drift, and model confidence.

Port of nnstreamer_tpu/obs/quality (stdlib and numpy, on host memory). A
tap reads only a buffer memory's host copy (``TensorMemory._host``) and
never calls ``.host()``: a frame resident on the card counts as
``skipped_device``, so on a card pipeline the filter and decoder taps
mostly skip, and ``seen == frames + skipped_device`` per tap says how many.
The fleet push doc's ``quality`` field reads ``push_data()``.

Every other observability pillar (metrics, tracing, health, profile,
slo, diag, fleet) watches the *machinery* — queues, latencies, device
seconds.  This one watches the *data*: the tensors flowing through the
pipeline and the logits coming out of the model.  Three layers:

1. **Streaming tensor statistics** — per-tap Welford mean/variance,
   min/max, NaN/Inf/zero counts, a log-bucket magnitude sketch, and
   the inter-frame delta magnitude, computed on host from buffers that
   are ALREADY host-resident (a device-resident tensor is never pulled
   back just to be looked at).  Taps: element chain (``chain:<name>``,
   the buffer entering each sink pad), filter output
   (``filter:<name>``), decoder output (``decoder:<name>``), plus
   model-confidence telemetry (logit entropy, top-1 probability,
   top-2 margin) recorded per tenant/session at the LM retire path
   (``lm:<engine>``).

2. **Drift detection** — ``nns-launch-torch --quality-record`` freezes each
   tap's sketch to a JSON :class:`~.drift.Baseline`; a later run with
   ``baseline=<path>`` scores every observed frame's sketch against it
   (PSI) through :class:`~.drift.DriftWindows` — fast/slow windows,
   breach requires both, injectable clock (the obs/slo burn pattern).

3. **Reaction wiring** — NaN-storm (NaN/Inf in >= ``nan_storm``
   consecutive frames) and dead-output (constant/all-zero for
   >= ``dead_frames`` frames) rules, plus a drift breach, surface as a
   ``kind="quality"`` health component per tap; the watchdog flips it
   DEGRADED, :func:`event_anomaly_alert` fires ``quality.anomaly`` and
   obs/diag's ``quality_anomaly`` trigger auto-captures a debug bundle
   with the offending tap's stats frozen in a ``quality`` stanza.
   ``nnstpu_quality_*`` metrics, ``GET /debug/quality``, the fleet
   push-doc ``quality`` field, and a Perfetto quality lane (pid 7)
   make it all visible.

Zero-overhead-when-off: :data:`QUALITY_HOOK` is a module global that
stays ``None`` until :func:`enable` — every tap site pays one module
attribute load plus a ``None`` check (the chaos/profile/slo contract,
pinned by an inspect test).  Set ``NNSTPU_QUALITY=1`` (or a SPEC
string, e.g. ``NNSTPU_QUALITY=taps=chain+filter,nan_storm=2``) to
enable at import; ``nns-launch-torch --quality[=SPEC]`` does the same.

Tap-label cardinality is bounded: at most ``max_taps`` taps are kept
(overflow folds into ``_overflow``), confidence sessions are LRU-capped.
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .. import events as _events
from .. import health as _health
from .. import metrics as _metrics
from .drift import (Baseline, DriftWindows, DEFAULT_FAST_WINDOW_S,
                    DEFAULT_PSI_THRESHOLD, DEFAULT_SLOW_WINDOW_S)
from .stats import TapStats, psi as _psi

__all__ = [
    "QualityEngine",
    "QUALITY_HOOK",
    "enable",
    "disable",
    "enabled",
    "engine",
    "snapshot",
    "push_data",
    "trace_points",
    "bundle_data",
    "report",
    "save_baseline",
    "parse_quality_spec",
    "event_anomaly_alert",
    "event_anomaly_recover",
    "Baseline",
    "DriftWindows",
    "TapStats",
]

# Defaults -----------------------------------------------------------------

TAP_KINDS = ("chain", "filter", "decoder", "lm")
DEFAULT_NAN_STORM = 3
DEFAULT_DEAD_FRAMES = 8
DEFAULT_MAX_TAPS = 64
# 2k stride-samples bound every tap to thumbnail cost regardless of frame
# size; the anomaly signals (NaN storms poison whole tensors, dead output
# is all-constant) and the exponent sketch are insensitive to the cap,
# and the <=5% overhead gate (bench quality_overhead_ratio) rides on it
DEFAULT_SAMPLE_CAP = 2048
OVERFLOW_TAP = "_overflow"
ANOMALY_KINDS = ("nan_storm", "dead_output", "drift")
_TRACE_CAP = 4096
_SESSION_LIMIT = 256

# Hook ---------------------------------------------------------------------
# None unless enable() was called; tap sites load the module attribute and
# None-check before every use so a disabled run pays nothing.

#: Consumed by graph.element.Pad.push, elements/filter + decoder chains,
#: and the serving LMEngine admit/retire paths.
QUALITY_HOOK: Optional["QualityEngine"] = None


class _Tap:
    """Mutable per-tap state. Guarded by the engine lock."""

    __slots__ = ("name", "stats", "seen", "skipped_device", "consec_nan",
                 "consec_dead", "anomaly", "detail", "drift",
                 "drift_breached", "last_psi")

    def __init__(self, name: str, sample_cap: int,
                 drift: Optional[DriftWindows]) -> None:
        self.name = name
        self.stats = TapStats(sample_cap)
        self.seen = 0
        self.skipped_device = 0
        self.consec_nan = 0
        self.consec_dead = 0
        self.anomaly: Optional[str] = None
        self.detail = ""
        self.drift = drift
        self.drift_breached = False
        self.last_psi: Optional[float] = None


class _ConfAgg:
    """Welford moments over one tenant's/session's confidence stream."""

    __slots__ = ("entropy", "top1", "margin")

    def __init__(self) -> None:
        from .stats import Welford
        self.entropy = Welford()
        self.top1 = Welford()
        self.margin = Welford()

    def add(self, entropy: float, top1: float, margin: float) -> None:
        self.entropy.add(entropy)
        self.top1.add(top1)
        self.margin.add(margin)

    def as_dict(self) -> Dict[str, Any]:
        return {"n": self.entropy.n,
                "entropy": self.entropy.as_dict(),
                "top1": self.top1.as_dict(),
                "margin": self.margin.as_dict()}


class QualityEngine:
    """Per-tap tensor statistics, drift scoring, and anomaly rules.

    One instance is installed into :data:`QUALITY_HOOK` by
    :func:`enable`.  Observation methods are thread-safe; metric
    emission happens outside the lock; device-resident tensors are
    counted as skipped, never copied back.
    """

    def __init__(self, *, taps: Sequence[str] = TAP_KINDS,
                 every: int = 1,
                 baseline: Optional[Baseline] = None,
                 psi_threshold: float = DEFAULT_PSI_THRESHOLD,
                 fast_window_s: float = DEFAULT_FAST_WINDOW_S,
                 slow_window_s: float = DEFAULT_SLOW_WINDOW_S,
                 nan_storm: int = DEFAULT_NAN_STORM,
                 dead_frames: int = DEFAULT_DEAD_FRAMES,
                 max_taps: int = DEFAULT_MAX_TAPS,
                 sample_cap: int = DEFAULT_SAMPLE_CAP,
                 clock: Callable[[], float] = time.monotonic) -> None:
        bad = [t for t in taps if t not in TAP_KINDS]
        if bad:
            raise ValueError(f"unknown tap kinds {bad} (one of {TAP_KINDS})")
        if every < 1:
            raise ValueError("every must be >= 1")
        if nan_storm < 1 or dead_frames < 1:
            raise ValueError("nan_storm and dead_frames must be >= 1")
        if max_taps < 1:
            raise ValueError("max_taps must be >= 1")
        self.taps_enabled = frozenset(taps)
        self.every = int(every)
        self.baseline = baseline
        self.psi_threshold = float(psi_threshold)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.nan_storm = int(nan_storm)
        self.dead_frames = int(dead_frames)
        self.max_taps = int(max_taps)
        self.sample_cap = int(sample_cap)
        self.clock = clock
        self._lock = threading.Lock()
        # Guarded by _lock:
        self._taps: Dict[str, _Tap] = {}
        self._conf_tenants: Dict[str, _ConfAgg] = {}
        self._conf_sessions: "OrderedDict[str, _ConfAgg]" = OrderedDict()
        self._trace: deque = deque(maxlen=_TRACE_CAP)
        self._register_metrics()

    # -- metrics ----------------------------------------------------------

    def _register_metrics(self) -> None:
        reg = _metrics.registry()
        self._m_frames = reg.counter(
            "nnstpu_quality_frames_total",
            "Frames observed by the data-plane quality layer per tap",
            labelnames=("tap",))
        self._m_anoms = reg.counter(
            "nnstpu_quality_anomalies_total",
            "Data-plane anomalies detected per tap by kind",
            labelnames=("tap", "kind"))
        self._m_psi = reg.gauge(
            "nnstpu_quality_drift_psi",
            "Mean population-stability-index vs baseline per tap/window",
            labelnames=("tap", "window"))

    # -- taps (lock held) -------------------------------------------------

    def _tap(self, name: str) -> Tuple[_Tap, bool]:
        t = self._taps.get(name)
        if t is not None:
            return t, False
        if len(self._taps) >= self.max_taps:
            name = OVERFLOW_TAP
            t = self._taps.get(name)
            if t is not None:
                return t, False
        drift = None
        if self.baseline is not None \
                and self.baseline.sketch_for(name) is not None:
            drift = DriftWindows(
                fast_window_s=self.fast_window_s,
                slow_window_s=self.slow_window_s,
                psi_threshold=self.psi_threshold, clock=self.clock)
        t = _Tap(name, self.sample_cap, drift)
        self._taps[name] = t
        return t, True

    # -- observation hooks --------------------------------------------------

    def observe_chain(self, element: str, buf: Any) -> None:
        """Buffer entering ``element``'s sink pad (graph.element.Pad)."""
        if "chain" in self.taps_enabled:
            self._observe(f"chain:{element}", buf)

    def observe_filter(self, element: str, buf: Any) -> None:
        """A tensor_filter's output buffer, pre-decoration."""
        if "filter" in self.taps_enabled:
            self._observe(f"filter:{element}", buf)

    def observe_decoder(self, element: str, buf: Any) -> None:
        """A tensor_decoder's decoded output buffer."""
        if "decoder" in self.taps_enabled:
            self._observe(f"decoder:{element}", buf)

    def _observe(self, tap: str, buf: Any) -> None:
        # primary host-resident memory only: peeking at _host (instead
        # of calling .host()) guarantees the tap never forces a D2H
        # copy — device-resident frames are counted as skipped
        mem = None
        for m in getattr(buf, "memories", ()):
            if m._host is not None:
                mem = m
                break
        emit_anom: Optional[str] = None
        with self._lock:
            t, created = self._tap(tap)
            name = t.name
            t.seen += 1
            if mem is None:
                t.skipped_device += 1
            elif self.every == 1 or (t.seen - 1) % self.every == 0:
                info = t.stats.observe(mem._host)
                if info["nan_frame"]:
                    t.consec_nan += 1
                    t.consec_dead = 0
                elif info["dead"]:
                    t.consec_dead += 1
                    t.consec_nan = 0
                else:
                    t.consec_nan = 0
                    t.consec_dead = 0
                anomaly = None
                if t.consec_nan >= self.nan_storm:
                    anomaly = "nan_storm"
                    detail = ("%d consecutive frames with NaN/Inf "
                              "(%d non-finite values total)"
                              % (t.consec_nan,
                                 t.stats.nan_count + t.stats.inf_count))
                elif t.consec_dead >= self.dead_frames:
                    anomaly = "dead_output"
                    detail = ("%d consecutive constant frames "
                              "(last mean %.6g)"
                              % (t.consec_dead, info["mean"]))
                if anomaly != t.anomaly:
                    if anomaly is not None:
                        emit_anom = anomaly
                        t.detail = detail
                    else:
                        t.detail = ""
                    t.anomaly = anomaly
                psi_score = None
                if t.drift is not None:
                    ref = self.baseline.sketch_for(name)
                    psi_score = _psi(ref, info["sketch"].as_dict())
                    t.drift.add(psi_score)
                    t.last_psi = psi_score
                self._trace.append({
                    "t_ns": time.monotonic_ns(), "tap": name,
                    "mean": info["mean"] if info["mean"] == info["mean"]
                    else 0.0,
                    "psi": psi_score if psi_score is not None else 0.0,
                    "nan": t.stats.nan_count + t.stats.inf_count,
                })
        if created:
            self._ensure_component(name)
        self._m_frames.labels(name).inc()
        if emit_anom is not None:
            self._m_anoms.labels(name, emit_anom).inc()

    def record_confidence(self, engine: str, tenant: str,
                          session: Optional[str], entropy: float,
                          top1: float, margin: float) -> None:
        """One retired LM request's first-token confidence signals."""
        if "lm" not in self.taps_enabled:
            return
        tap = f"lm:{engine}"
        with self._lock:
            agg = self._conf_tenants.get(tenant)
            if agg is None:
                if len(self._conf_tenants) >= self.max_taps:
                    tenant = OVERFLOW_TAP
                agg = self._conf_tenants.setdefault(tenant, _ConfAgg())
            agg.add(entropy, top1, margin)
            if session is not None:
                sagg = self._conf_sessions.get(session)
                if sagg is None:
                    sagg = self._conf_sessions[session] = _ConfAgg()
                sagg.add(entropy, top1, margin)
                self._conf_sessions.move_to_end(session)
                while len(self._conf_sessions) > _SESSION_LIMIT:
                    self._conf_sessions.popitem(last=False)
            self._trace.append({
                "t_ns": time.monotonic_ns(), "tap": tap,
                "mean": entropy, "psi": 0.0, "nan": 0,
            })
        self._m_frames.labels(tap).inc()

    # -- anomaly evaluation + health ----------------------------------------

    def _ensure_component(self, tap: str) -> None:
        ref = weakref.ref(self)

        def probe() -> Optional[Dict[str, Any]]:
            eng = ref()
            if eng is None or _ENGINE is not eng:
                return None  # retire the component
            return eng.evaluate(tap)

        _health.component(f"quality:{tap}", kind="quality", probe=probe,
                          attrs={"tap": tap})

    def evaluate(self, tap: str,
                 now: Optional[float] = None) -> Optional[Dict[str, Any]]:
        """One tap's anomaly verdict: the NaN-storm/dead-output state
        machine plus (when a baseline is loaded) the multi-window
        drift burn.  This is the health probe payload."""
        drift_edge = False
        with self._lock:
            t = self._taps.get(tap)
            if t is None:
                return None
            anomaly, detail = t.anomaly, t.detail
            drift_eval = t.drift.evaluate(now) if t.drift is not None \
                else None
            if drift_eval is not None:
                breached = drift_eval["breached"]
                if breached and anomaly is None:
                    anomaly = "drift"
                    w = drift_eval["windows"]
                    detail = ("PSI fast=%.3f slow=%.3f over "
                              "threshold %.2f"
                              % (w["fast"]["mean_psi"],
                                 w["slow"]["mean_psi"],
                                 drift_eval["psi_threshold"]))
                if breached and not t.drift_breached:
                    drift_edge = True
                t.drift_breached = breached
            data = {
                "tap": tap,
                "anomaly": anomaly,
                "detail": detail,
                "frames": t.stats.frames,
                "nan": t.stats.nan_count + t.stats.inf_count,
                "psi": t.last_psi,
                "drift": drift_eval,
            }
        if drift_eval is not None:
            w = drift_eval["windows"]
            self._m_psi.labels(tap, "fast").set(w["fast"]["mean_psi"])
            self._m_psi.labels(tap, "slow").set(w["slow"]["mean_psi"])
        if drift_edge:
            self._m_anoms.labels(tap, "drift").inc()
        return data

    # -- export -----------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            names = list(self._taps)
            rows: Dict[str, Dict[str, Any]] = {}
            for name in names:
                t = self._taps[name]
                rows[name] = {
                    **t.stats.snapshot(),
                    "seen": t.seen,
                    "skipped_device": t.skipped_device,
                    "anomaly": t.anomaly,
                    "detail": t.detail,
                    "psi": t.last_psi,
                }
            conf = {
                "tenants": {k: v.as_dict()
                            for (k, v) in self._conf_tenants.items()},
                "sessions": {k: v.as_dict()
                             for (k, v) in self._conf_sessions.items()},
            }
        for name in names:
            # Health may have been enabled after the tap appeared —
            # re-registering is a cheap get-or-create.
            self._ensure_component(name)
            ev = self.evaluate(name)
            if ev is not None:
                rows[name]["anomaly"] = ev["anomaly"]
                rows[name]["detail"] = ev["detail"]
                rows[name]["drift"] = ev["drift"]
        return {
            "enabled": True,
            "taps_enabled": sorted(self.taps_enabled),
            "every": self.every,
            "baseline": self.baseline is not None,
            "psi_threshold": self.psi_threshold,
            "windows": {"fast_s": self.fast_window_s,
                        "slow_s": self.slow_window_s},
            "rules": {"nan_storm": self.nan_storm,
                      "dead_frames": self.dead_frames},
            "taps": rows,
            "confidence": conf,
        }

    def anomalies(self) -> Dict[str, Dict[str, Any]]:
        """Currently anomalous taps: ``{tap: {kind, detail}}``."""
        out: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            names = list(self._taps)
        for name in names:
            ev = self.evaluate(name)
            if ev is not None and ev["anomaly"] is not None:
                out[name] = {"kind": ev["anomaly"],
                             "detail": ev["detail"]}
        return out

    def push_data(self) -> Dict[str, Any]:
        """Compact per-tap summary for the fleet push doc."""
        anomalies = self.anomalies()
        with self._lock:
            taps = {
                name: {
                    "frames": t.stats.frames,
                    "nan": t.stats.nan_count + t.stats.inf_count,
                    "psi": t.last_psi,
                }
                for (name, t) in self._taps.items()
            }
        return {"taps": taps, "anomalies": anomalies}

    def bundle_data(self) -> Dict[str, Any]:
        """Debug-bundle stanza: the full snapshot with the offending
        (anomalous) taps called out up front."""
        snap = self.snapshot()
        snap["anomalies"] = self.anomalies()
        return snap

    def trace_points(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._trace)

    def save_baseline(self, path: str) -> Baseline:
        """Freeze every tap's cumulative sketch as a drift baseline."""
        with self._lock:
            taps = {name: t.stats.sketch.as_dict()
                    for (name, t) in self._taps.items()
                    if t.stats.frames}
            meta = {"frames": sum(t.stats.frames
                                  for t in self._taps.values()),
                    "psi_threshold": self.psi_threshold}
        base = Baseline(taps, meta=meta)
        base.save(path)
        _events.record("quality.baseline_saved",
                       f"drift baseline frozen to {path} "
                       f"({len(taps)} taps)", path=path, taps=len(taps))
        return base

    def report(self) -> str:
        snap = self.snapshot()
        lines = ["quality: data-plane observation"]
        for (name, row) in sorted(snap["taps"].items()):
            mom = row["moments"]
            psi_txt = "" if row.get("psi") is None \
                else " psi=%.3f" % row["psi"]
            lines.append(
                "  %-24s frames=%d mean=%.6g std=%.3g nan=%d zero=%d%s"
                % (name, row["frames"], mom["mean"],
                   mom["var"] ** 0.5, row["nan"], row["zero"], psi_txt))
            if row.get("anomaly"):
                lines.append("  %-24s ANOMALY %s: %s"
                             % ("", row["anomaly"], row["detail"]))
        for (tenant, agg) in sorted(snap["confidence"]["tenants"].items()):
            lines.append(
                "  lm[%s]: n=%d entropy=%.3f top1=%.3f margin=%.3f"
                % (tenant, agg["n"], agg["entropy"]["mean"],
                   agg["top1"]["mean"], agg["margin"]["mean"]))
        return "\n".join(lines)


# Module API ---------------------------------------------------------------

_ENGINE: Optional[QualityEngine] = None


def engine() -> Optional[QualityEngine]:
    return _ENGINE


def enabled() -> bool:
    return _ENGINE is not None


def parse_quality_spec(text: str) -> Dict[str, Any]:
    """Parse a ``--quality`` SPEC string into engine kwargs.

    Grammar: comma-separated ``key=value`` pairs —
    ``taps=chain+filter+decoder+lm`` (plus-separated subset), ``every=N``
    (observe every Nth frame per tap), ``psi=F`` (drift threshold),
    ``fast=SEC`` / ``slow=SEC`` (drift windows), ``nan_storm=N``,
    ``dead_frames=N``, ``sample_cap=N``, ``baseline=PATH`` (load a
    recorded drift baseline).  An empty spec means all defaults.
    Raises ValueError on unknown keys or out-of-range values.
    """
    out: Dict[str, Any] = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                "bad --quality entry %r (want key=value)" % part)
        key, _, val = part.partition("=")
        key, val = key.strip(), val.strip()
        if key == "taps":
            taps = tuple(v.strip() for v in val.split("+") if v.strip())
            bad = [t for t in taps if t not in TAP_KINDS]
            if not taps or bad:
                raise ValueError("bad taps %r (plus-separated subset of %s)"
                                 % (val, "+".join(TAP_KINDS)))
            out["taps"] = taps
        elif key in ("every", "nan_storm", "dead_frames", "sample_cap"):
            try:
                num = int(val)
            except ValueError:
                raise ValueError("bad value in --quality entry %r" % part)
            if num < 1:
                raise ValueError("%s must be >= 1 in --quality" % key)
            out[key] = num
        elif key in ("psi", "fast", "slow"):
            try:
                fnum = float(val)
            except ValueError:
                raise ValueError("bad value in --quality entry %r" % part)
            if fnum <= 0:
                raise ValueError("%s must be > 0 in --quality" % key)
            out[{"psi": "psi_threshold", "fast": "fast_window_s",
                 "slow": "slow_window_s"}[key]] = fnum
        elif key == "baseline":
            if not val:
                raise ValueError("baseline needs a path in --quality")
            out["baseline"] = val
        else:
            raise ValueError("unknown --quality key %r" % key)
    return out


def enable(spec: Optional[str] = None, **kwargs: Any) -> QualityEngine:
    """Install a fresh :class:`QualityEngine` into :data:`QUALITY_HOOK`.

    ``spec`` is a ``--quality`` SPEC string (see
    :func:`parse_quality_spec`); explicit kwargs override it.  A string
    ``baseline`` is loaded from disk here so the engine always holds a
    parsed :class:`~.drift.Baseline`.
    """
    global _ENGINE, QUALITY_HOOK
    merged: Dict[str, Any] = parse_quality_spec(spec) if spec else {}
    merged.update(kwargs)
    baseline = merged.pop("baseline", None)
    if isinstance(baseline, str):
        baseline = Baseline.load(baseline)
    eng = QualityEngine(baseline=baseline, **merged)
    _ENGINE = eng
    QUALITY_HOOK = eng
    _events.record("quality.capture_start",
                   "data-plane quality observation enabled")
    return eng


def disable() -> None:
    global _ENGINE, QUALITY_HOOK
    if _ENGINE is not None:
        _events.record("quality.capture_stop",
                       "data-plane quality observation disabled")
    _ENGINE = None
    QUALITY_HOOK = None


def snapshot() -> Dict[str, Any]:
    eng = _ENGINE
    if eng is None:
        return {"enabled": False, "taps": {}}
    return eng.snapshot()


def push_data() -> Optional[Dict[str, Any]]:
    """Compact snapshot for the fleet push doc; None while disabled."""
    eng = _ENGINE
    if eng is None:
        return None
    return eng.push_data()


def bundle_data() -> Dict[str, Any]:
    """Debug-bundle collector payload; raises while disabled so the
    bundle writer degrades this stanza to an error entry."""
    eng = _ENGINE
    if eng is None:
        raise RuntimeError("quality is not enabled")
    return eng.bundle_data()


def trace_points() -> List[Dict[str, Any]]:
    eng = _ENGINE
    if eng is None:
        return []
    return eng.trace_points()


def save_baseline(path: str) -> Optional[Baseline]:
    eng = _ENGINE
    if eng is None:
        return None
    return eng.save_baseline(path)


def report() -> str:
    eng = _ENGINE
    if eng is None:
        return "quality: off"
    return eng.report()


# Event helpers — this module owns the quality.* event-type literals so
# the nnslint event-layer-placement rule holds (health calls these
# lazily from its quality check, exactly like the slo burn events).

def event_anomaly_alert(component: str, data: Dict[str, Any]) -> None:
    _events.record(
        "quality.anomaly",
        "data-plane anomaly on %s" % component,
        severity="warning",
        component=component,
        tap=data.get("tap"),
        kind=data.get("anomaly"),
        detail=data.get("detail"),
    )
    # quality anomalies are a diag capture trigger — cold path, lazy
    # import keeps the obs package import graph acyclic
    from .. import diag as _diag
    dhook = _diag.DIAG_HOOK
    if dhook is not None:
        dhook.on_quality_anomaly(component, data)


def event_anomaly_recover(component: str, data: Dict[str, Any]) -> None:
    _events.record(
        "quality.recover",
        "data-plane anomaly cleared on %s" % component,
        component=component,
        tap=data.get("tap"),
    )


_env = os.environ.get("NNSTPU_QUALITY", "")
if _env == "1":
    enable()
elif _env:
    enable(_env)
del _env
