"""Drift detection — frozen baselines plus multi-window PSI burn.

A :class:`Baseline` freezes each tap's magnitude sketch (the
``--quality-record`` reference window) to JSON; live traffic scores
every observed frame's sketch against it with
:func:`~nnstreamer_tpu_torch.obs.quality.stats.psi` and feeds the score into
a :class:`DriftWindows` — the same multi-window burn shape obs/slo.py
uses for error budgets: a fast and a slow horizon over a bounded ring
of timestamped scores, an injectable clock, and a breach that requires
the mean PSI to clear the threshold on BOTH windows.  The fast window
makes detection quick; the slow window keeps a single weird frame from
paging anyone.
"""

from __future__ import annotations

import json
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

__all__ = ["Baseline", "DriftWindows", "BASELINE_VERSION",
           "DEFAULT_FAST_WINDOW_S", "DEFAULT_SLOW_WINDOW_S",
           "DEFAULT_PSI_THRESHOLD"]

BASELINE_VERSION = 1

#: drift windows are much shorter than SLO burn windows — distribution
#: shift is per-frame signal, not per-request accounting
DEFAULT_FAST_WINDOW_S = 60.0
DEFAULT_SLOW_WINDOW_S = 600.0
#: PSI >= 0.2 is the conventional "significant population shift" line
DEFAULT_PSI_THRESHOLD = 0.2
_WINDOW_SCORES = 4096


class Baseline:
    """Per-tap reference sketches, serializable to a JSON file."""

    def __init__(self, taps: Dict[str, Dict[str, int]],
                 meta: Optional[Dict[str, Any]] = None) -> None:
        self.taps = dict(taps)
        self.meta = dict(meta or {})

    def sketch_for(self, tap: str) -> Optional[Dict[str, int]]:
        return self.taps.get(tap)

    def save(self, path: str) -> None:
        doc = {"version": BASELINE_VERSION, "taps": self.taps,
               "meta": self.meta}
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, indent=2, sort_keys=True)
            fh.write("\n")

    @classmethod
    def load(cls, path: str) -> "Baseline":
        with open(path, "r", encoding="utf-8") as fh:
            doc = json.load(fh)
        version = doc.get("version")
        if version != BASELINE_VERSION:
            raise ValueError(
                f"unsupported quality baseline version {version!r} "
                f"(want {BASELINE_VERSION})")
        taps = doc.get("taps")
        if not isinstance(taps, dict):
            raise ValueError("quality baseline has no taps table")
        return cls({str(t): {str(k): int(c) for (k, c) in sk.items()}
                    for (t, sk) in taps.items()}, meta=doc.get("meta"))


class DriftWindows:
    """Fast/slow mean-PSI evaluation over a bounded score ring.

    One instance per tap.  ``add`` timestamps a score with the
    injectable clock; ``evaluate`` averages scores inside each horizon
    and breaches only when BOTH horizons hold data and both means are
    at or above the threshold — the obs/slo multi-window contract.
    """

    __slots__ = ("fast_window_s", "slow_window_s", "psi_threshold",
                 "clock", "scores")

    def __init__(self, *, fast_window_s: float = DEFAULT_FAST_WINDOW_S,
                 slow_window_s: float = DEFAULT_SLOW_WINDOW_S,
                 psi_threshold: float = DEFAULT_PSI_THRESHOLD,
                 window_scores: int = _WINDOW_SCORES,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if not (0 < fast_window_s <= slow_window_s):
            raise ValueError("need 0 < fast_window_s <= slow_window_s")
        if psi_threshold <= 0:
            raise ValueError("psi_threshold must be > 0")
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.psi_threshold = float(psi_threshold)
        self.clock = clock
        self.scores: deque = deque(maxlen=window_scores)

    def add(self, score: float, now: Optional[float] = None) -> None:
        t = self.clock() if now is None else now
        self.scores.append((t, float(score)))

    def evaluate(self, now: Optional[float] = None) -> Dict[str, Any]:
        t = self.clock() if now is None else now
        windows: Dict[str, Dict[str, Any]] = {}
        breached = True
        for (wname, wlen) in (("fast", self.fast_window_s),
                              ("slow", self.slow_window_s)):
            recent = [s for (ts, s) in self.scores if t - ts <= wlen]
            n = len(recent)
            mean = (sum(recent) / n) if n else 0.0
            windows[wname] = {"n": n, "mean_psi": mean}
            if not n or mean < self.psi_threshold:
                breached = False
        return {"windows": windows, "breached": breached,
                "psi_threshold": self.psi_threshold}
