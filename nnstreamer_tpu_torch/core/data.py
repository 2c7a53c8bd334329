"""Typed statistics helpers: the whole-tensor float64 average tensor_if
compares (gst_tensor_data_raw_average, gst/nnstreamer/tensor_data.h:30-108).

Port of nnstreamer_tpu/core/data.py's part that has a caller: its scalar
typecasts, standard deviations and per-channel statistics are used by no
module of either package and are not ported.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch


def tensor_average(arr: Union[np.ndarray, torch.Tensor]) -> float:
    """Whole-tensor mean in float64 (gst_tensor_data_raw_average).

    A numpy array takes numpy's float64 mean, the JAX package's arithmetic.
    A tensor is reduced where it lies, in float64, and only the scalar is
    read back (on the card: instead of copying the whole frame to the host).
    Its summation order differs from numpy's pairwise sum, so the mean may
    differ in its last bits (never for integer-valued data), and a
    comparison against a threshold that close to it may go the other way."""
    if isinstance(arr, torch.Tensor):
        return float(arr.to(torch.float64).mean())
    return float(np.mean(arr, dtype=np.float64))
