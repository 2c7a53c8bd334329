"""Typed scalar/statistics helpers: typecasts with C conversion semantics,
the whole-tensor float64 average tensor_if compares, standard deviations
and per-channel statistics (gst_tensor_data_typecast,
gst_tensor_data_raw_average/_std and their per-channel forms,
gst/nnstreamer/tensor_data.h:30-108).

Port of nnstreamer_tpu/core/data.py, every public name. A numpy input
takes the JAX package's numpy arithmetic and gives bit-equal results. A
``torch.Tensor`` is cast or reduced where it lies (statistics in float64)
and only the result is read back.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from .types import TensorDType

Number = Union[int, float]
Array = Union[np.ndarray, torch.Tensor]


def _torch_dtype(dtype: TensorDType) -> torch.dtype:
    return getattr(torch, dtype.value)  # every TensorDType name is torch's


def typecast_value(value: Union[Number, torch.Tensor],
                   dtype: TensorDType) -> Number:
    """Cast a scalar with C conversion semantics (modular wrap for ints,
    precision loss for floats) — mirrors gst_tensor_data_typecast. A
    one-element tensor is cast where it lies (``typecast_array``'s rules)
    and read back."""
    if isinstance(value, torch.Tensor):
        return typecast_array(value, dtype).item()
    arr = np.asarray(value).astype(dtype.np_dtype)
    return arr.item()


def typecast_array(arr: Array, dtype: TensorDType) -> Array:
    """``arr`` as ``dtype`` with C conversion semantics: integers narrow
    by a modular wrap, floats round to nearest even.

    A float that is out of range for an integer type (or NaN) has no
    defined C conversion, and the libraries do not agree on it. On the
    CPU torch's cast equals numpy's except that a float64 at or above
    2**32 cast to uint8 keeps its low byte in torch (2**32 + 5 → 5) where
    numpy gives 0 (tests/test_torch_data_helpers.py). On the card (torch
    2.11, CUDA 12.8) int32 and uint32 saturate to their range, int8 takes
    the low byte of the saturated int32 and uint8 the low byte of the
    int64 value, so 1e10 gives 2147483647, 4294967295, -1 and 0, and NaN
    int32's minimum and 2**31 for uint32
    (tests/test_torch_data_cuda.py)."""
    if isinstance(arr, torch.Tensor):
        return arr.to(_torch_dtype(dtype))
    return arr.astype(dtype.np_dtype)


def tensor_average(arr: Array) -> float:
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


def tensor_std(arr: Array) -> float:
    """Whole-tensor population std-dev (gst_tensor_data_raw_std); a
    tensor as ``tensor_average`` reduces it."""
    if isinstance(arr, torch.Tensor):
        return float(arr.to(torch.float64).std(correction=0))
    return float(np.std(np.asarray(arr, dtype=np.float64)))


def _other_axes(arr: Array, channel_axis: int) -> tuple:
    return tuple(i for i in range(arr.ndim) if i != channel_axis % arr.ndim)


def per_channel_average(arr: Array, channel_axis: int = -1) -> np.ndarray:
    """Per-channel mean (gst_tensor_data_raw_average_per_channel).

    The reference's channel axis is dim[0] (innermost) which is the *last*
    axis in our row-major layout. A tensor is reduced where it lies in
    float64; the per-channel result comes back as a float64 numpy array.
    """
    axes = _other_axes(arr, channel_axis)
    if isinstance(arr, torch.Tensor):
        x = arr.to(torch.float64)
        # torch reads dim=() as "every dim"; numpy as "none"
        return (x.mean(dim=axes) if axes else x).cpu().numpy()
    return np.mean(arr, axis=axes, dtype=np.float64)


def per_channel_std(arr: Array, channel_axis: int = -1) -> np.ndarray:
    """Per-channel population std-dev; a tensor as
    ``per_channel_average`` reduces it."""
    axes = _other_axes(arr, channel_axis)
    if isinstance(arr, torch.Tensor):
        x = arr.to(torch.float64)
        # numpy's std over no axis is |x - x|: 0, or NaN for NaN and inf
        return (x.std(dim=axes, correction=0) if axes
                else x - x).cpu().numpy()
    return np.std(np.asarray(arr, dtype=np.float64), axis=axes)
