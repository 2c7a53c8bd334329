"""Quantiles over every sample."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile of all ``values`` (linear between ranks)."""
    return float(np.percentile(np.asarray(values, np.float64), q))
