"""tensor_transform operator library, as functions on torch tensors.

Port of nnstreamer_tpu/ops/transform_ops.py (reference:
gst/nnstreamer/elements/gsttensortransform.c, modes dimchg/typecast/
arithmetic/transpose/stand/clamp, tensor_transform.h:57-84). Every mode
builds a function over one tensor that runs where the tensor lives, and
gives the JAX package's result, bit for bit (``stand`` within summation
order):

  * typecast:   "float32"
  * arithmetic: "typecast:float32,add:-127.5,div:127.5" (chained ops; values
                may be per-channel lists "add:1;2;3")
  * transpose:  "1:0:2:3" — permutation in reference dim order (innermost
                first); output dim i takes input dim perm[i]
  * dimchg:     "0:2" — move dim position a to position b (reference dim idx)
  * stand:      "default" | "dc-average" [":per-channel"]
  * clamp:      "min:max"

What JAX does that a bare torch op does not, and each function here does:

  * a float→integer cast saturates: NaN to 0, values clipped to the type's
    range, the rest truncated toward zero (``.to(dtype)`` wraps or is
    undefined there);
  * 64-bit data is 32-bit: the JAX package runs with x64 off, so its
    float64/int64/uint64 tensors hold float32/int32/uint32 (their caps
    still name the 64-bit type);
  * a Python scalar is weakly typed: a float stream keeps its dtype (the
    scalar is rounded to it first), an integer stream becomes float32;
  * division is IEEE division: the divisor is a tensor on the stream's
    device, never a Python scalar (PyTorch's CUDA division by a scalar
    multiplies by its reciprocal).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.types import TensorDType, TensorInfo

#: the dtype of the JAX package's data for each 64-bit type (x64 off)
_X64_OFF = {torch.float64: torch.float32, torch.int64: torch.int32,
            torch.uint64: torch.uint32}

_TORCH_DTYPES = {
    TensorDType.INT32: torch.int32, TensorDType.UINT32: torch.uint32,
    TensorDType.INT16: torch.int16, TensorDType.UINT16: torch.uint16,
    TensorDType.INT8: torch.int8, TensorDType.UINT8: torch.uint8,
    TensorDType.FLOAT64: torch.float64, TensorDType.FLOAT32: torch.float32,
    TensorDType.INT64: torch.int64, TensorDType.UINT64: torch.uint64,
    TensorDType.FLOAT16: torch.float16, TensorDType.BFLOAT16: torch.bfloat16,
}

Value = Union[float, np.ndarray]


def _canon(x: torch.Tensor) -> torch.Tensor:
    """A 64-bit tensor as the JAX package holds it (32-bit; floats round,
    integers wrap)."""
    t = _X64_OFF.get(x.dtype)
    return x if t is None else x.to(t)


def astype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x.astype(dtype)`` as JAX computes it: float→integer saturates
    (NaN → 0, clipped to the range, truncated toward zero); every other
    pair is torch's cast (integer narrowing wraps, floats round to nearest
    even)."""
    x, dtype = _canon(x), _X64_OFF.get(dtype, dtype)
    if x.dtype == dtype:
        return x
    if x.is_floating_point() and not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        xd = x.to(torch.float64)  # holds every 32-bit integer exactly
        xd = torch.where(xd.isnan(), 0.0, xd).clamp(info.min, info.max).trunc()
        return xd.to(torch.int64).to(dtype)
    return x.to(dtype)


def weak_scalar(value: float, x: torch.Tensor) -> torch.Tensor:
    """A Python float as JAX's weakly typed scalar against ``x``: a 0-dim
    tensor on x's device in x's float dtype, or float32 for an integer x."""
    dtype = x.dtype if x.is_floating_point() else torch.float32
    return torch.full((), value, dtype=dtype, device=x.device)


def _operand(value: Value, x: torch.Tensor,
             on_device: Dict[torch.device, torch.Tensor]) -> torch.Tensor:
    """A scalar as a weak scalar; a per-channel vector as a tensor on x's
    device, copied there once (``on_device`` keeps it): a copy from host
    memory cannot be captured into a CUDA graph."""
    if isinstance(value, np.ndarray):
        t = on_device.get(x.device)
        if t is None:
            t = on_device[x.device] = torch.from_numpy(value).to(x.device)
        return t
    return weak_scalar(value, x)


def _np_axis(rank: int, nns_dim_index: int) -> int:
    """Reference dim index (0 = innermost) → row-major axis."""
    return rank - 1 - nns_dim_index


def _parse_value(s: str) -> Value:
    """Scalar or ';'-separated per-channel vector."""
    if ";" in s:
        return np.array([float(v) for v in s.split(";")], np.float32)
    return float(s)


class Transform:
    """One parsed transform stage: ``fn`` over a torch tensor + static
    out-info."""

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor],
                 out_info_fn: Callable[[TensorInfo], TensorInfo],
                 descr: str):
        self.fn = fn
        self.out_info = out_info_fn
        self.descr = descr

    def __repr__(self) -> str:
        return f"Transform({self.descr})"


def build(mode: str, option: str) -> Transform:
    mode = mode.strip().lower()
    if mode == "typecast":
        return _typecast(option)
    if mode == "arithmetic":
        return _arithmetic(option)
    if mode == "transpose":
        return _transpose(option)
    if mode == "dimchg":
        return _dimchg(option)
    if mode == "stand":
        return _stand(option)
    if mode == "clamp":
        return _clamp(option)
    raise ValueError(f"unknown transform mode {mode!r}")


# --------------------------------------------------------------------------- #

def _typecast(option: str) -> Transform:
    dtype = TensorDType.parse(option)
    target = _TORCH_DTYPES[dtype]
    return Transform(lambda x: astype(x, target),
                     lambda i: TensorInfo(i.dims, dtype, i.name),
                     f"typecast:{dtype}")


_ARITH_OPS = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
              "div": torch.div}


def _arithmetic(option: str) -> Transform:
    """Chained "typecast:T,add:V,mul:V,div:V" ops, evaluated in order
    (reference gst_tensor_transform arithmetic chain)."""
    steps: List[Tuple[str, Any]] = []
    out_dtype: Optional[TensorDType] = None
    for part in option.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" not in part:
            raise ValueError(f"arithmetic op needs value: {part!r}")
        op, val = part.split(":", 1)
        op = op.strip().lower()
        if op == "typecast":
            dt = TensorDType.parse(val)
            steps.append(("typecast", _TORCH_DTYPES[dt]))
            out_dtype = dt
        elif op in _ARITH_OPS:
            steps.append((op, _parse_value(val)))
        else:
            raise ValueError(f"unknown arithmetic op {op!r}")
    if not steps:
        raise ValueError("empty arithmetic option")

    on_device: List[Dict[torch.device, torch.Tensor]] = [{} for _ in steps]

    def fn(x):
        x = _canon(x)
        for (op, val), held in zip(steps, on_device):
            if op == "typecast":
                x = astype(x, val)
            else:
                x = _ARITH_OPS[op](x, _operand(val, x, held))
        return x

    def out_info(i: TensorInfo) -> TensorInfo:
        return TensorInfo(i.dims, out_dtype or i.dtype, i.name)

    return Transform(fn, out_info, f"arithmetic:{option}")


def _transpose(option: str) -> Transform:
    perm_nns = [int(x) for x in option.split(":")]
    rank = len(perm_nns)
    if sorted(perm_nns) != list(range(rank)):
        raise ValueError(f"transpose option must be a permutation: {option!r}")
    # output nns-dim i = input nns-dim perm[i]  →  row-major axes:
    # out axis (rank-1-i) takes input axis (rank-1-perm[i])
    np_perm = [0] * rank
    for i, p in enumerate(perm_nns):
        np_perm[rank - 1 - i] = rank - 1 - p

    def fn(x):
        if x.dim() != rank:
            raise ValueError(
                f"transpose rank mismatch: option rank {rank}, tensor rank {x.dim()}")
        return _canon(x).permute(np_perm)

    def out_info(i: TensorInfo) -> TensorInfo:
        if i.rank != rank:
            raise ValueError(
                f"transpose rank mismatch: option rank {rank} vs {i.rank}")
        dims = tuple(i.dims[p] for p in perm_nns)
        return TensorInfo(dims, i.dtype, i.name)

    return Transform(fn, out_info, f"transpose:{option}")


def _dimchg(option: str) -> Transform:
    a_str, b_str = option.split(":")
    a, b = int(a_str), int(b_str)

    def fn(x):
        rank = x.dim()
        return _canon(x).movedim(_np_axis(rank, a), _np_axis(rank, b))

    def out_info(i: TensorInfo) -> TensorInfo:
        dims = list(i.dims)
        dims.insert(b, dims.pop(a))
        return TensorInfo(tuple(dims), i.dtype, i.name)

    return Transform(fn, out_info, f"dimchg:{option}")


def _stand(option: str) -> Transform:
    parts = [p.strip().lower() for p in option.split(":")] if option else ["default"]
    scheme = parts[0] or "default"
    per_channel = len(parts) > 1 and parts[1] == "per-channel"
    if scheme not in ("default", "dc-average"):
        raise ValueError(f"unknown stand scheme {scheme!r}")

    def fn(x):
        xf = x.to(torch.float32)
        # channel axis = innermost (reference dim[0]) = last row-major axis
        axes = tuple(range(xf.dim() - 1)) if per_channel else None
        if axes == ():  # per channel of a rank-1 tensor: each value alone
            mean, std = xf, torch.zeros_like(xf)
        else:
            mean = torch.mean(xf, dim=axes, keepdim=per_channel)
            # jnp.std is the population deviation
            std = torch.std(xf, dim=axes, correction=0, keepdim=per_channel)
        if scheme == "dc-average":
            return xf - mean
        return (xf - mean) / (std + weak_scalar(1e-10, std))

    return Transform(fn,
                     lambda i: TensorInfo(i.dims, TensorDType.FLOAT32, i.name),
                     f"stand:{option}")


def _clamp(option: str) -> Transform:
    lo_s, hi_s = option.split(":")
    lo, hi = float(lo_s), float(hi_s)
    if lo > hi:
        raise ValueError(f"clamp min > max: {option!r}")

    def fn(x):
        # bounds cast to the INPUT dtype (the reference's clamp keeps the
        # tensor type). For integer streams the bounds are first clipped
        # into the dtype's range — a raw cast would WRAP (uint8 with
        # lo=-50 → 206 > hi) and flatten the whole tensor to a constant.
        x = _canon(x)
        if x.is_floating_point():
            return torch.clamp(x, *(torch.full((), v, dtype=x.dtype, device=x.device)
                                    for v in (lo, hi)))
        info = torch.iinfo(x.dtype)
        lo_i, hi_i = (int(np.clip(v, info.min, info.max)) for v in (lo, hi))
        if x.dtype in (torch.uint16, torch.uint32):  # torch has no clamp for these
            return torch.clamp(x.to(torch.int64), lo_i, hi_i).to(x.dtype)
        return torch.clamp(x, lo_i, hi_i)

    return Transform(fn, lambda i: i, f"clamp:{option}")


def compose(transforms: Sequence[Transform]) -> Transform:
    """Fuse a chain of transforms into one function."""
    if len(transforms) == 1:
        return transforms[0]

    def fn(x):
        for t in transforms:
            x = t.fn(x)
        return x

    def out_info(i: TensorInfo) -> TensorInfo:
        for t in transforms:
            i = t.out_info(i)
        return i

    return Transform(fn, out_info, "+".join(t.descr for t in transforms))
