"""CUDA kernels for the stream prologue, with their plain versions.

Counterparts of the Pallas kernels in ``nnstreamer_tpu/ops/pallas/preprocess.py``
(both in ``csrc/preprocess.cu``):

  * ``normalize_u8``    — ``out_dtype(float32(x) * scale + bias)``, uint8 (or
    float) frames to the model's float input;
  * ``quantize_affine`` — ``uint8(clip(round(x / scale) + zero_point, 0,
    255))``, float to affine-quantized uint8 (NaN to 0).

Each wrapper launches its kernel for a CUDA tensor, raising on a device or
dtype the kernel does not take, and adds one to its ``launches`` count for
every launch (``core.graphs.count``: once per replay of a CUDA graph that
captured it). A non-contiguous input is made contiguous first (one copy);
any shape and size is taken, the empty tensor included. For a tensor on the
CPU it runs the plain version. ``tiling`` reports the kernels' tiling on
the card (the tests and ``chip_smoke.py`` size their boundary cases by it). The plain versions follow the JAX package's
``normalize_u8_reference`` and ``quantize_affine_reference``: a multiply
then an add, each rounded, and an IEEE division (PyTorch's CUDA division by
a Python scalar multiplies by the reciprocal, so the divisor is a tensor
on the input's device).
"""

from __future__ import annotations

import ctypes

import torch

from ...core import graphs
from .epilogue import _P, _check_launch, _entry, _on, _require, _stream_ptr

#: type codes of csrc/preprocess.cu
_IN_TYPES = {torch.uint8: 0, torch.float32: 1, torch.bfloat16: 2}
_OUT_TYPES = (torch.float32, torch.bfloat16)


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-dim float32 tensor on ``like``'s device (filled
    there: no host copy, so CUDA graphs can capture it)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def normalize_u8_plain(x: torch.Tensor, scale: float = 1.0 / 127.5,
                       bias: float = -1.0,
                       out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``normalize_u8_reference``: float32(x) * scale + bias, two rounded
    float32 operations, then cast to ``out_dtype``."""
    return (x.to(torch.float32) * _f32(scale, x) + _f32(bias, x)).to(out_dtype)


def normalize_u8(x: torch.Tensor, scale: float = 1.0 / 127.5, bias: float = -1.0,
                 out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Normalize a uint8 (or float32/bfloat16) tensor of any shape to
    ``out_dtype`` (bfloat16 or float32): float32(x) * scale + bias."""
    if x.device.type == "cpu":
        return normalize_u8_plain(x, scale, bias, out_dtype)
    _require(x.device.type == "cuda", f"normalize_u8: unsupported device {x.device}")
    _require(x.dtype in _IN_TYPES,
             f"normalize_u8: uint8, float32 or bfloat16 input, got {x.dtype}")
    _require(out_dtype in _OUT_TYPES,
             f"normalize_u8: out_dtype float32 or bfloat16, got {out_dtype}")
    x = x.contiguous()
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if x.numel() > 0:
        _launch_normalize(x, y, scale, bias)
    return y


def _launch_normalize(x: torch.Tensor, y: torch.Tensor, scale: float, bias: float) -> None:
    """Launch ``normalize_u8``'s kernel from ``x`` into ``y``: contiguous
    CUDA tensors of the same size (at least one element), of the types the
    wrapper checks, on any alignment."""
    fn = _entry("preprocess", "nns_normalize_u8",
                (_P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                 ctypes.c_float, ctypes.c_float, _P))
    with _on(x.device):
        rc = fn(x.data_ptr(), y.data_ptr(), x.numel(), _IN_TYPES[x.dtype],
                int(y.dtype == torch.bfloat16), scale, bias, _stream_ptr(x))
    _check_launch("normalize_u8", rc)
    graphs.count(normalize_u8)


normalize_u8.launches = 0


def quantize_affine_plain(x: torch.Tensor, scale: float,
                          zero_point: int = 0) -> torch.Tensor:
    """``quantize_affine_reference``: round half to even of float32(x) /
    scale (IEEE division), plus zero_point, clipped to [0, 255]; NaN gives
    0, as JAX's saturating float→uint8 cast does."""
    q = torch.round(x.to(torch.float32) / _f32(scale, x)) + _f32(float(zero_point), x)
    q = torch.where(q.isnan(), 0.0, q)
    return torch.clamp(q, 0.0, 255.0).to(torch.uint8)


def quantize_affine(x: torch.Tensor, scale: float, zero_point: int = 0) -> torch.Tensor:
    """Affine-quantize a float32 or bfloat16 tensor of any shape to uint8."""
    if x.device.type == "cpu":
        return quantize_affine_plain(x, scale, zero_point)
    _require(x.device.type == "cuda", f"quantize_affine: unsupported device {x.device}")
    _require(x.dtype in (torch.float32, torch.bfloat16),
             f"quantize_affine: float32 or bfloat16 input, got {x.dtype}")
    x = x.contiguous()
    q = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    if x.numel() > 0:
        _launch_quantize(x, q, scale, zero_point)
    return q


def _launch_quantize(x: torch.Tensor, q: torch.Tensor, scale: float, zero_point: int) -> None:
    """Launch ``quantize_affine``'s kernel from ``x`` into ``q``, as
    ``_launch_normalize`` does."""
    fn = _entry("preprocess", "nns_quantize_affine",
                (_P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                 ctypes.c_float, _P))
    with _on(x.device):
        rc = fn(x.data_ptr(), q.data_ptr(), x.numel(), _IN_TYPES[x.dtype], scale,
                float(zero_point), _stream_ptr(x))
    _check_launch("quantize_affine", rc)
    graphs.count(quantize_affine)


quantize_affine.launches = 0


def tiling(in_dtype: torch.dtype, out_dtype: torch.dtype,
           device: torch.device) -> dict:
    """The aligned path's tiling of the kernel taking ``in_dtype`` to
    ``out_dtype`` (uint8: ``quantize_affine``; float32 or bfloat16:
    ``normalize_u8``) on CUDA ``device``: ``vector``, the elements a lane
    moves an access; ``tile``, the elements a block takes a step;
    ``blocks``, its persistent grid (SMs times the blocks an SM holds)."""
    _require(device.type == "cuda", f"tiling: a CUDA device, got {device}")
    fn = _entry("preprocess", "nns_preprocess_tiling",
                (ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)))
    out = (ctypes.c_longlong * 3)()
    with _on(device):
        rc = fn(_IN_TYPES[in_dtype], _IN_TYPES[out_dtype], out)
    _check_launch("tiling", rc)
    return dict(zip(("vector", "tile", "blocks"), out))
