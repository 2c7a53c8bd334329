"""Runtime :class:`Tuner`: the measure→act loop's act half.

Resolution order for every knob a hot path asks about, strictly
cheapest-first:

1. **Store hit** — the knob was tuned before (this process, a previous
   run via the on-disk store, or another fleet instance via adoption).
   Zero measurement; this is the steady state a warm fleet lives in.
2. **Cost-model pick** — the per-(device, label) regression fit over
   the profiler's persisted samples has coverage, and the caller
   supplied per-candidate features: rank candidates by predicted cost,
   persist the winner as ``source="model"``.
3. **Bounded measured sweep** — the caller supplied a ``measure``
   closure: time at most :attr:`Tuner.max_trials` candidates once,
   persist the winner as ``source="sweep"``. The bound is a hard cap,
   not a target — a fleet pays this once per (device, label, shape,
   knob), ever, because the result federates.
4. **The hand-set default** — exactly what the call site did before
   the tuner existed.

Call sites supply the ``measure`` closure themselves (the tuner never
imports ops/serving — no cycle, and only the site knows how to build a
representative dispatch). Every resolution is deterministic for a given
store + sample set: candidate order breaks cost ties.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, Optional, Sequence

from ..obs import events as _events
from ..obs import metrics as _obs
from .model import CostModel
from .store import TuneStore

_reg = _obs.registry()
_PICKS = _reg.counter(
    "nnstpu_tune_picks_total",
    "Knob resolutions by how they were decided (store/model/sweep/"
    "default/fleet)", ("source",))
_TRIALS = _reg.counter(
    "nnstpu_tune_sweep_trials_total",
    "Individual measured-sweep trials run (bounded per knob by "
    "max_trials)")
_ADOPTED = _reg.counter(
    "nnstpu_tune_adopted_total",
    "Tuned configs adopted from fleet push-acks")


def shape_sig(*dims: Any) -> str:
    """Canonical shape signature: ``shape_sig(('b', 8), ('l', 2048))``
    → ``"b8.l2048"``. Keys keep sigs self-describing across knobs."""
    return ".".join(f"{k}{v}" for k, v in dims)


class Tuner:
    """Owns the store, the model, and the sweep budget.

    Installed as the module-global ``tune.TUNE_HOOK`` — hot paths pay
    one attribute load + None check when tuning is off, and call
    :meth:`pick` when it is on.
    """

    def __init__(self, store: Optional[TuneStore] = None,
                 model: Optional[CostModel] = None,
                 max_trials: int = 8,
                 measure_repeats: int = 3) -> None:
        self.store = store if store is not None else TuneStore()
        self.model = model if model is not None else CostModel()
        self.max_trials = max(int(max_trials), 1)
        self.measure_repeats = max(int(measure_repeats), 1)
        #: auto-arm QueryRouter hedging from observed P95 when no
        #: manual --hedge-ms floor was given (query/router.py gate)
        self.auto_hedge = True
        self.stats: Dict[str, int] = {
            "picks": 0, "store_hits": 0, "model_picks": 0, "sweeps": 0,
            "trials": 0, "defaults": 0, "adopted": 0, "observed": 0}

    # -- model feeding --------------------------------------------------- #
    def fit(self, samples: Iterable[Dict[str, Any]]) -> int:
        """(Re)fit the cost model from profiler sample rows
        (``obs.profile.Profiler.samples()`` or a persisted
        ``dump_samples`` file's ``samples`` list)."""
        return self.model.fit(samples)

    # -- the resolution -------------------------------------------------- #
    def pick(self, knob: str, device: str, label: str, sig: str,
             candidates: Sequence[Any], default: Any,
             measure: Optional[Callable[[Any], float]] = None,
             features: Optional[Callable[[Any], tuple]] = None) -> Any:
        """Resolve one knob. ``measure(candidate) -> seconds`` times one
        representative dispatch; ``features(candidate) -> (flops,
        bytes)`` feeds the cost model. Either may be None — the
        corresponding stage is skipped."""
        self.stats["picks"] += 1
        rec = self.store.get(device, label, sig, knob)
        if rec is not None:
            self.stats["store_hits"] += 1
            _PICKS.labels(rec.get("source") or "store").inc()
            return rec["value"]

        if features is not None and self.model.covers(device, label):
            best, best_cost = None, None
            for cand in candidates:
                try:
                    flops, nbytes = features(cand)
                except Exception:
                    continue
                cost = self.model.predict(device, label, flops, nbytes)
                if cost is not None and (best_cost is None
                                         or cost < best_cost):
                    best, best_cost = cand, cost
            if best is not None:
                self.stats["model_picks"] += 1
                _PICKS.labels("model").inc()
                self.store.put(device, label, sig, knob, best, "model",
                               cost_us=best_cost)
                return best

        if measure is not None:
            value = self._sweep(knob, device, label, sig, candidates,
                                default, measure)
            if value is not None:
                return value

        self.stats["defaults"] += 1
        _PICKS.labels("default").inc()
        return default

    def _sweep(self, knob: str, device: str, label: str, sig: str,
               candidates: Sequence[Any], default: Any,
               measure: Callable[[Any], float]) -> Optional[Any]:
        """Time at most ``max_trials`` candidates; persist and return
        the winner, or None when every trial failed (the caller falls
        back to its default, and nothing is persisted — a later call
        may retry)."""
        self.stats["sweeps"] += 1
        best, best_s = None, None
        trials = 0
        t0 = time.monotonic()
        for cand in candidates[:self.max_trials]:
            trials += 1
            self.stats["trials"] += 1
            _TRIALS.inc()
            try:
                s = min(measure(cand) for _ in range(self.measure_repeats))
            except Exception:
                continue
            if best_s is None or s < best_s:
                best, best_s = cand, s
        if best is None:
            return None
        _PICKS.labels("sweep").inc()
        self.store.put(device, label, sig, knob, best, "sweep",
                       cost_us=best_s * 1e6)
        _events.record(
            "tune.sweep",
            f"swept {knob} for {label} [{sig}] on {device}: "
            f"{best!r} at {best_s * 1e6:.1f}us "
            f"({trials} trials, {time.monotonic() - t0:.2f}s)",
            knob=knob, label=label, device=device, trials=trials)
        return best

    def observe(self, knob: str, device: str, label: str, sig: str,
                value: Any, cost_us: Optional[float] = None) -> None:
        """Record a knob value derived from live observation (e.g. the
        spec-decode draft length computed from the observed accept
        rate) so it persists and federates like a swept one."""
        self.stats["observed"] += 1
        _PICKS.labels("observed").inc()
        self.store.put(device, label, sig, knob, value, "observed",
                       cost_us=cost_us)

    # -- federation ------------------------------------------------------ #
    def push_doc(self) -> Optional[Dict[str, Any]]:
        """The tune layer of an outgoing fleet push doc (None when the
        store is empty — the push stays byte-identical to pre-tune)."""
        if not len(self.store):
            return None
        return self.store.to_doc()

    def adopt(self, doc: Any) -> int:
        """Merge a fleet-shipped tune doc (the ``tune`` field of a
        push-ack). Runs on the pusher thread — before the instance's
        first dispatch when fleet push is enabled at startup, which is
        exactly what lets a fresh instance skip its sweeps."""
        n = self.store.merge_doc(doc)
        if n:
            self.stats["adopted"] += n
            _ADOPTED.inc(n)
            _events.record("tune.adopt",
                           f"adopted {n} fleet-tuned config(s)", n=n)
        return n

    # -- reporting ------------------------------------------------------- #
    def snapshot(self) -> Dict[str, Any]:
        return {"stats": dict(self.stats),
                "model_coverage": ["|".join(k)
                                   for k in self.model.coverage()],
                "store_path": self.store.path,
                "entries": self.store.entries()}

    def report(self) -> str:
        s = self.stats
        lines = [
            "autotuner:",
            f"  picks {s['picks']}  (store {s['store_hits']}, model "
            f"{s['model_picks']}, sweeps {s['sweeps']} / "
            f"{s['trials']} trials, defaults {s['defaults']})",
            f"  adopted from fleet: {s['adopted']}   observed: "
            f"{s['observed']}",
            f"  store: {len(self.store)} entr"
            f"{'y' if len(self.store) == 1 else 'ies'}"
            + (f" -> {self.store.path}" if self.store.path else ""),
        ]
        for k, rec in sorted(self.store.entries().items()):
            cost = rec.get("cost_us")
            lines.append(
                f"    {k} = {rec['value']!r} [{rec['source']}"
                + (f", {cost:.1f}us" if cost is not None else "") + "]")
        return "\n".join(lines)
