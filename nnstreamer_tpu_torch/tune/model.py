"""Learned cost model over the profiler's persisted samples.

Per-``(device_kind, label)`` linear regression

    cost_us  ≈  a · flops  +  b · bytes  +  c

fit by closed-form least squares (3×3 normal equations via numpy —
no ML dependency, deterministic for a given sample set). The features
are exactly what ``obs/profile.py`` already records per dispatch:
XLA-reported FLOPs and traffic bytes, plus the measured device-or-host
microseconds. That makes the model a roofline with learned, per-device
coefficients: ``a`` ≈ 1/attainable-FLOPs, ``b`` ≈ 1/attainable-bytes,
``c`` the dispatch floor — the same decomposition "A Learned
Performance Model for TPUs" starts from before reaching for a GNN,
which sample counts here (tens per label, not millions) cannot feed.

Candidate ranking only needs *relative* cost under varying traffic, so
a label with too few or degenerate samples simply reports no coverage
and the tuner falls through to its measured sweep.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

#: minimum samples per (device, label) before a fit is attempted —
#: below this the normal equations are underdetermined noise
MIN_SAMPLES = 3


def _sample_rows(samples: Iterable[Dict[str, Any]]
                 ) -> Dict[Tuple[str, str], List[Tuple[float, float, float]]]:
    """Group profiler sample rows into (device, label) → [(flops,
    bytes, cost_us)]. Device timing is preferred; host timing is the
    fallback (CPU runs report no device counters)."""
    by_key: Dict[Tuple[str, str], List[Tuple[float, float, float]]] = {}
    for row in samples:
        label = row.get("label")
        device = row.get("device") or "unknown"
        if not label:
            continue
        cost = row.get("mean_device_us") or row.get("mean_host_us")
        if not cost or cost <= 0:
            continue
        flops = float(row.get("flops") or 0.0)
        nbytes = float(row.get("bytes") or 0.0)
        if flops <= 0 and nbytes <= 0:
            continue
        by_key.setdefault((str(device), str(label)), []).append(
            (flops, nbytes, float(cost)))
    return by_key


class CostModel:
    """Per-(device, label) linear fit with explicit coverage."""

    def __init__(self) -> None:
        #: (device, label) -> (a, b, c) with cost_us = a*flops+b*bytes+c
        self._coef: Dict[Tuple[str, str], Tuple[float, float, float]] = {}
        self.n_samples = 0

    def fit(self, samples: Iterable[Dict[str, Any]]) -> int:
        """Fit every (device, label) group with enough samples; returns
        the number of groups covered. Refitting replaces prior
        coefficients (the sample set is the source of truth)."""
        grouped = _sample_rows(samples)
        self._coef.clear()
        self.n_samples = sum(len(v) for v in grouped.values())
        for key, rows in grouped.items():
            if len(rows) < MIN_SAMPLES:
                continue
            arr = np.asarray(rows, dtype=np.float64)
            x = np.column_stack([arr[:, 0], arr[:, 1],
                                 np.ones(len(rows))])
            y = arr[:, 2]
            # lstsq handles rank deficiency (all-equal features) by the
            # min-norm solution — deterministic, and still usable for
            # ranking because the degenerate feature gets weight 0
            coef, *_ = np.linalg.lstsq(x, y, rcond=None)
            # a negative flops/bytes weight means the fit extrapolates
            # "more work is faster" — a sure sign the samples do not
            # span the feature; treat as no coverage rather than rank
            # candidates backwards
            if coef[0] < 0 or coef[1] < 0:
                continue
            self._coef[key] = (float(coef[0]), float(coef[1]),
                               float(coef[2]))
        return len(self._coef)

    def covers(self, device: str, label: str) -> bool:
        return (device, label) in self._coef

    def predict(self, device: str, label: str, flops: float,
                nbytes: float) -> Optional[float]:
        """Predicted cost in microseconds, or None without coverage."""
        coef = self._coef.get((device, label))
        if coef is None:
            return None
        a, b, c = coef
        return a * float(flops) + b * float(nbytes) + c

    def coverage(self) -> List[Tuple[str, str]]:
        return sorted(self._coef)
