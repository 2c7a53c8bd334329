"""Streaming tensor statistics — the numeric core of obs/quality.

Everything here is plain numpy over host-resident views; no torch, no
locks (the owning :class:`~nnstreamer_tpu_torch.obs.quality.QualityEngine`
serializes access).  Three pieces:

* :class:`Welford` — numerically stable streaming mean/variance with a
  Chan-style bulk merge so a whole frame folds in as ONE state update
  (the per-element loop happens inside vectorized numpy, not Python).
* :class:`LogBucketSketch` — a tiny magnitude histogram keyed by the
  base-2 exponent of ``|x|`` plus dedicated ``zero`` / ``nonfinite``
  buckets.  Exponent buckets make the sketch scale-free (a float32
  activation tensor and an int8 quantized one land in comparable
  shapes) and keep it JSON-serializable for drift baselines.
* :class:`TapStats` — one tap's accumulator: Welford moments, min/max,
  NaN/Inf/zero counts, the cumulative sketch, and the inter-frame
  delta magnitude stream (mean ``|x_t - x_{t-1}|`` — the bandwidth
  signal a delta codec would exploit).

:func:`psi` computes the Population Stability Index between two
serialized sketches — the drift score obs/quality/drift.py windows.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np

__all__ = ["Welford", "LogBucketSketch", "TapStats", "psi",
           "PSI_EPSILON", "EXP_MIN", "EXP_MAX"]

#: exponent buckets clamp here — 2^±64 covers every sane activation
EXP_MIN, EXP_MAX = -64, 64
#: probability floor so empty buckets don't blow PSI up to infinity
PSI_EPSILON = 1e-6


class Welford:
    """Streaming mean/variance (population), stable under cancellation.

    ``add_array`` merges a whole chunk via Chan's parallel update: the
    chunk's own moments come from vectorized numpy, then fold into the
    running state in O(1) — exactness against ``np.mean``/``np.var`` on
    the concatenated data is pinned by tests/test_quality.py.
    """

    __slots__ = ("n", "mean", "m2")

    def __init__(self) -> None:
        self.n = 0
        self.mean = 0.0
        self.m2 = 0.0

    def add(self, x: float) -> None:
        self.n += 1
        delta = x - self.mean
        self.mean += delta / self.n
        self.m2 += delta * (x - self.mean)

    def add_array(self, arr: np.ndarray,
                  mean: Optional[float] = None) -> None:
        nb = int(arr.size)
        if nb == 0:
            return
        mb = float(arr.mean()) if mean is None else mean
        d = (arr - mb).ravel()
        m2b = float(np.dot(d, d))
        tot = self.n + nb
        delta = mb - self.mean
        self.m2 += m2b + delta * delta * (self.n * nb / tot)
        self.mean += delta * (nb / tot)
        self.n = tot

    @property
    def variance(self) -> float:
        return self.m2 / self.n if self.n else 0.0

    @property
    def std(self) -> float:
        return math.sqrt(max(self.variance, 0.0))

    def as_dict(self) -> Dict[str, float]:
        return {"n": self.n, "mean": self.mean, "var": self.variance}


class LogBucketSketch:
    """Magnitude histogram over exponent buckets.

    Finite non-zero values land in bucket ``floor(log2(|x|))`` clamped
    to ``[EXP_MIN, EXP_MAX]``; zeros and non-finite values get their
    own buckets.  Serializes to ``{"e<k>": n, "zero": n,
    "nonfinite": n}`` — the JSON shape drift baselines freeze.
    """

    __slots__ = ("counts", "zeros", "nonfinite")

    def __init__(self) -> None:
        self.counts: Dict[int, int] = {}
        self.zeros = 0
        self.nonfinite = 0

    @classmethod
    def of(cls, x: np.ndarray) -> "LogBucketSketch":
        """Sketch one (flat) array of any numeric dtype."""
        x = np.asarray(x)
        if x.dtype.kind != "f":
            x = x.astype(np.float64)
        nonfinite = int(x.size) - int(np.count_nonzero(np.isfinite(x)))
        fin = x[np.isfinite(x)] if nonfinite else x
        return cls._of_finite(fin, nonfinite)

    @classmethod
    def _of_finite(cls, fin: np.ndarray, nonfinite: int,
                   zeros: Optional[int] = None) -> "LogBucketSketch":
        """Sketch a finite-only array plus the dropped nonfinite count
        (the hot path — ``TapStats.observe`` already holds both).

        The bucket exponent comes from ``np.frexp``: ``|x|`` in
        ``[2^(e-1), 2^e)`` means ``floor(log2(|x|)) == e - 1`` by
        integer arithmetic, exact even where a transcendental ``log2``
        rounds across a power of two.  Tallying is one ``np.bincount``
        over the clipped bucket offsets instead of ``np.unique``'s
        sort — the difference is ~4x on sketch cost per frame."""
        sk = cls()
        sk.nonfinite = int(nonfinite)
        n_nz = int(np.count_nonzero(fin)) if zeros is None \
            else int(fin.size) - int(zeros)
        sk.zeros = int(fin.size) - n_nz
        if n_nz:
            nz = fin[fin != 0.0] if sk.zeros else fin
            e = np.frexp(nz)[1]
            e -= 1 + EXP_MIN
            np.clip(e, 0, EXP_MAX - EXP_MIN, out=e)
            bc = np.bincount(e, minlength=EXP_MAX - EXP_MIN + 1)
            for i in np.nonzero(bc)[0]:
                sk.counts[int(i) + EXP_MIN] = int(bc[i])
        return sk

    def merge(self, other: "LogBucketSketch") -> None:
        self.zeros += other.zeros
        self.nonfinite += other.nonfinite
        for (k, c) in other.counts.items():
            self.counts[k] = self.counts.get(k, 0) + c

    @property
    def total(self) -> int:
        return self.zeros + self.nonfinite + sum(self.counts.values())

    def as_dict(self) -> Dict[str, int]:
        out = {f"e{k}": c for (k, c) in sorted(self.counts.items())}
        out["zero"] = self.zeros
        out["nonfinite"] = self.nonfinite
        return out

    @classmethod
    def from_dict(cls, d: Dict[str, int]) -> "LogBucketSketch":
        sk = cls()
        for (k, c) in d.items():
            if k == "zero":
                sk.zeros = int(c)
            elif k == "nonfinite":
                sk.nonfinite = int(c)
            elif k.startswith("e"):
                sk.counts[int(k[1:])] = int(c)
        return sk


def psi(ref: Dict[str, int], live: Dict[str, int],
        eps: float = PSI_EPSILON) -> float:
    """Population Stability Index between two serialized sketches.

    ``sum((p - q) * ln(p / q))`` over the union of bucket keys, with
    probabilities floored at ``eps`` so a bucket present on one side
    only contributes a large-but-finite term.  0 means identical;
    >= 0.2 is the conventional "significant shift" line the default
    drift threshold uses.
    """
    ref_total = max(sum(ref.values()), 1)
    live_total = max(sum(live.values()), 1)
    score = 0.0
    for key in set(ref) | set(live):
        p = max(live.get(key, 0) / live_total, eps)
        q = max(ref.get(key, 0) / ref_total, eps)
        score += (p - q) * math.log(p / q)
    return score


class TapStats:
    """Cumulative statistics for one tap, fed one frame at a time.

    ``observe`` returns a per-frame info dict the engine's anomaly
    rules consume: ``nan_frame`` (any NaN/Inf present), ``dead`` (all
    finite values identical — covers all-zero AND stuck-constant
    outputs), the frame mean, the frame's own sketch (the drift PSI
    sample), and the inter-frame delta magnitude when the previous
    frame had the same shape.

    Frames larger than ``sample_cap`` elements are stride-sampled so a
    4K video tensor costs the same as a thumbnail — the moments become
    estimates but the anomaly signals (NaN anywhere in the sample,
    constant output) stay representative.
    """

    __slots__ = ("sample_cap", "frames", "elements", "nan_count",
                 "inf_count", "zero_count", "min", "max", "welford",
                 "delta", "sketch", "_last", "_last_all_finite")

    def __init__(self, sample_cap: int = 2048) -> None:
        self.sample_cap = int(sample_cap)
        self.frames = 0
        self.elements = 0
        self.nan_count = 0
        self.inf_count = 0
        self.zero_count = 0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.welford = Welford()
        self.delta = Welford()     # stream of mean |x_t - x_{t-1}|
        self.sketch = LogBucketSketch()
        self._last: Optional[np.ndarray] = None
        self._last_all_finite = False

    def observe(self, arr: np.ndarray) -> Dict[str, Any]:
        x = np.asarray(arr).reshape(-1)
        if x.size > self.sample_cap:
            x = x[::-(-x.size // self.sample_cap)]
        x = x.astype(np.float64, copy=False)
        n = int(x.size)
        n_fin = int(np.count_nonzero(np.isfinite(x)))
        all_finite = n_fin == n
        if all_finite:
            nan_ct = inf_ct = 0
            fin = x
        else:
            nan_ct = int(np.count_nonzero(np.isnan(x)))
            inf_ct = n - n_fin - nan_ct
            fin = x[np.isfinite(x)]
        zero_ct = int(fin.size) - int(np.count_nonzero(fin))

        self.frames += 1
        self.elements += n
        self.nan_count += nan_ct
        self.inf_count += inf_ct
        self.zero_count += zero_ct
        frame_mean = float("nan")
        dead = False
        if fin.size:
            frame_mean = float(fin.mean())
            self.welford.add_array(fin, mean=frame_mean)
            fmin, fmax = float(fin.min()), float(fin.max())
            self.min = fmin if self.min is None else min(self.min, fmin)
            self.max = fmax if self.max is None else max(self.max, fmax)
            dead = all_finite and fmin == fmax

        frame_sketch = LogBucketSketch._of_finite(fin, n - n_fin,
                                                  zeros=zero_ct)
        self.sketch.merge(frame_sketch)

        delta_mag: Optional[float] = None
        last = self._last
        if last is not None and last.shape == x.shape:
            d = x - last
            np.abs(d, out=d)
            if not (all_finite and self._last_all_finite):
                d = d[np.isfinite(d)]
            if d.size:
                delta_mag = float(d.mean())
                self.delta.add(delta_mag)
        self._last = x
        self._last_all_finite = all_finite

        return {"nan_frame": (nan_ct + inf_ct) > 0, "dead": dead,
                "mean": frame_mean, "sketch": frame_sketch,
                "delta": delta_mag}

    def snapshot(self) -> Dict[str, Any]:
        return {
            "frames": self.frames,
            "elements": self.elements,
            "nan": self.nan_count,
            "inf": self.inf_count,
            "zero": self.zero_count,
            "min": self.min,
            "max": self.max,
            "moments": self.welford.as_dict(),
            "delta": self.delta.as_dict(),
            "sketch": self.sketch.as_dict(),
        }
