"""Blockwise (flash) attention: the CUDA kernel, its wrapper and its plain
version.

Counterpart of the Pallas kernel in
``nnstreamer_tpu/ops/pallas/flash_attention.py`` (``flash_attention``:
``_flash_kernel`` and ``_flash_kernel_residual``), which the causal LM's
flash prefill runs once per layer (models/causal_lm.py). The kernels are
in ``csrc/flash_attention.cu``, with two routes that ``_route`` picks from
the dtype and the head width alone:

  * ``wgmma``: bfloat16 at D 64 or 128 (the zoo's head width and the wide
    one) — tensor-core products (wgmma) on tiles that TMA loads, 128 query
    rows a block;
  * ``tf32x3``: every other case (float32 at any D, bf16 at other D) —
    warp-level tf32 tensor-core products (mma.sync), a float32 operand
    split into two tf32 halves and multiplied as three products, which
    keeps float32's accuracy (a bf16 operand is a tf32 value and takes one
    product); 64 query rows a block, D > 128 in 128-column chunks.

Block sizes are fixed constants in the source: the JAX package's autotuner
hook is not ported. TMA needs a 16-byte aligned base and B, H and L strides
that are multiples of 16 bytes; the wrapper copies a tensor that breaks
them contiguous before a wgmma launch (``_tma_ready``; the causal LM's
split-head views meet them and take no copy) and counts the copies in
``flash_attention.tma_copies``.

The wrapper launches a kernel for CUDA tensors, raising on a device, dtype,
shape or layout it does not take, and adds one to ``launches`` and to
``launches_by_route[route]`` for every launch (``core.graphs.count``: once
per replay of a CUDA graph that captured it). For CPU tensors it runs
``flash_attention_plain``, the same online-softmax recurrence over 64-key
blocks in torch ops, which is what both kernels are held against on the
card.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple, Union

import torch

from ...core import graphs
from ...obs import profile as _profile
from .epilogue import _P, _check_launch, _entry, _on, _require, _stream_ptr

#: keys per block of the plain version's recurrence (the kernel's tile)
BLOCK_K = 64
#: head widths of the wgmma route (bfloat16 only)
WGMMA_HEAD_DIMS = (64, 128)
#: the mask value: finite, so m - m never makes a NaN
_NEG_INF = -1e30

Result = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def _scale(d: int) -> float:
    """1/sqrt(D) as float32, from the true head dim (the TPU kernel's
    ``np.float32(sm_scale)``)."""
    return float(torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True,
                          return_residuals: bool = False) -> Result:
    """Attention over (B, H, L, D) q, k, v by the flash recurrence, in
    torch ops: float32 scores scaled after the product, masked scores
    -1e30, m starting at -1e30, p rounded to v's dtype before PV while l
    sums it unrounded, output acc / max(l, 1e-30) in q's dtype. With
    ``return_residuals`` returns (acc (B, H, L, D) float32, m (B, H, L),
    l (B, H, L)) instead."""
    b, h, length, d = q.shape
    scale = _scale(d)
    qf = q.to(torch.float32)
    rows = torch.arange(length, device=q.device)[:, None]
    acc = torch.zeros((b, h, length, d), device=q.device, dtype=torch.float32)
    m = torch.full((b, h, length, 1), _NEG_INF, device=q.device,
                   dtype=torch.float32)
    l_sum = torch.zeros_like(m)
    for k0 in range(0, length, BLOCK_K):
        kb = k[:, :, k0:k0 + BLOCK_K].to(torch.float32)
        vb = v[:, :, k0:k0 + BLOCK_K]
        s = (qf @ kb.transpose(-1, -2)) * scale
        if causal:
            cols = torch.arange(k0, k0 + kb.shape[2], device=q.device)[None, :]
            s = torch.where(rows >= cols, s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l_sum = l_sum * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p.to(v.dtype).to(torch.float32) @ vb.to(torch.float32)
        m = m_new
    if return_residuals:
        return acc, m[..., 0], l_sum[..., 0]
    return (acc / torch.clamp(l_sum, min=1e-30)).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    _require(q.device.type == "cuda",
             f"flash_attention: unsupported device {q.device}")
    _require(q.dtype in (torch.float32, torch.bfloat16),
             f"flash_attention: float32 or bfloat16 required, got {q.dtype}")
    _require(q.dim() == 4 and min(q.shape) > 0,
             "flash_attention: non-empty (B, H, L, D) tensors required, got "
             f"{tuple(q.shape)}")
    for t in (k, v):
        _require(t.device == q.device and t.dtype == q.dtype
                 and t.shape == q.shape,
                 "flash_attention: q, k and v must share device, dtype and "
                 f"shape, got {[(tuple(x.shape), x.dtype, str(x.device)) for x in (q, k, v)]}")
    for t in (q, k, v):
        _require(t.stride(3) == 1 or t.shape[3] == 1,
                 f"flash_attention: the head axis must be contiguous, "
                 f"strides {t.stride()}")


def _route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel a launch takes (q, k and v share dtype and shape, as
    ``_check`` holds): "wgmma" for bfloat16 at D 64 or 128, else "tf32x3".
    The layout never changes the route: a tensor that TMA cannot read is
    copied first (``_tma_ready``)."""
    return "wgmma" if (q.dtype == torch.bfloat16
                       and q.shape[-1] in WGMMA_HEAD_DIMS) else "tf32x3"


def _tma_strides(t: torch.Tensor) -> Tuple[int, int, int]:
    """The (B, H, L) element strides a tensor map gets: torch leaves the
    stride of a size-1 axis free, TMA checks every stride, so such an axis
    takes the stride a contiguous tensor would have."""
    shape = t.shape
    return tuple(t.stride(i) if shape[i] > 1 else math.prod(shape[i + 1:])
                 for i in range(3))


def _tma_ready(t: torch.Tensor) -> bool:
    """TMA's rules for a bf16 (B, H, L, D) tensor: a 16-byte aligned base,
    a contiguous head axis, and B, H and L strides multiples of 16 bytes
    (8 elements)."""
    return t.data_ptr() % 16 == 0 and t.stride(3) == 1 \
        and all(s % 8 == 0 for s in _tma_strides(t))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    return_residuals: bool = False) -> Result:
    """Causal (or full) attention over (B, H, L, D) tensors, float32 or
    bfloat16, any D and L; the head axis contiguous, other strides
    free. Returns (B, H, L, D) in q's dtype, or with ``return_residuals``
    the unnormalised float32 accumulator and the per-row m and l
    (B, H, L), which merge partial attentions over disjoint key sets."""
    if _profile.KERNEL_HOOK is not None:  # kernel label (obs/profile.py)
        _profile.KERNEL_HOOK("cuda.flash_attention", q.shape, q.dtype)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, return_residuals)
    _check(q, k, v)
    b, h, length, d = q.shape
    route = _route(q, k, v)
    if route == "wgmma" and not all(_tma_ready(t) for t in (q, k, v)):
        q, k, v = (t if _tma_ready(t) else t.clone(
            memory_format=torch.contiguous_format) for t in (q, k, v))
        graphs.count(flash_attention, "tma_copies")
    strides = (ctypes.c_longlong * 9)(*(
        s for t in (q, k, v)
        for s in (_tma_strides(t) if route == "wgmma" else t.stride()[:3])))
    is_bf16 = int(q.dtype == torch.bfloat16)
    if return_residuals:
        acc = torch.empty((b, h, length, d), device=q.device,
                          dtype=torch.float32)
        m = torch.empty((b, h, length), device=q.device, dtype=torch.float32)
        l_sum = torch.empty_like(m)
        out: Result = (acc, m, l_sum)
        ptrs = (acc.data_ptr(), m.data_ptr(), l_sum.data_ptr())
    else:
        o = torch.empty((b, h, length, d), device=q.device, dtype=q.dtype)
        out = o
        ptrs = (o.data_ptr(), None, None)
    qkv = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    tail = (b, h, length, d, strides, int(causal), _scale(d))
    with _on(q.device):
        if route == "wgmma":
            fn = _entry("flash_attention", "nns_flash_attention_wgmma",
                        (_P,) * 6 + (ctypes.c_int,) * 4
                        + (_P, ctypes.c_int, ctypes.c_float, _P))
            rc = fn(*qkv, *ptrs, *tail, _stream_ptr(q))
        else:
            fn = _entry("flash_attention", "nns_flash_attention_tf32x3",
                        (_P,) * 6 + (ctypes.c_int,) * 4
                        + (_P, ctypes.c_int, ctypes.c_float, ctypes.c_int, _P))
            rc = fn(*qkv, *ptrs, *tail, is_bf16, _stream_ptr(q))
    _check_launch("flash_attention", rc)
    graphs.count(flash_attention)
    graphs.count(flash_attention, "launches_by_route", route)
    return out


flash_attention.launches = 0
flash_attention.launches_by_route = {"wgmma": 0, "tf32x3": 0}
flash_attention.tma_copies = 0
