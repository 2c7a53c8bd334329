"""Sequence (context) parallelism: ring attention and all-to-all (Ulysses)
attention over a mesh axis — port of nnstreamer_tpu/parallel/ring.py.

Where the JAX functions take the global q, k and v and return the output
sequence-sharded (the ``shard_map`` body sees a shard), a rank here passes
its own sequence shard (B, H, L/n, d) — the n ranks hold the sequence in
order — and gets its own output shard back.

  * ``ring_attention``: K/V blocks rotate around the ring (``ppermute``)
    while an online softmax accumulates exact attention; memory a rank is
    O(L/n · L/n).
  * ``ring_flash_attention``: each shard pair through the hand-written
    flash kernel's residual mode (ops/kernels/flash_attention.py,
    ``return_residuals=True``): full below the diagonal, causal on it, and
    no launch above it; the partials merge exactly through (m, l) with the
    kernel's −1e30 sentinel and ``acc / max(l, 1e-30)``.
  * ``a2a_attention``: ``all_to_all`` re-shards sequence → heads, each rank
    attends the full sequence for H/n heads (``flash=True``: the
    normalised float32 kernel), then re-shards back. ``causal=True`` masks
    the full-sequence attention (the JAX function has no causal mode; the
    port's sequence-parallel prefill runs a2a causally).
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch

from ..ops.kernels.flash_attention import _NEG_INF, flash_attention
from .mesh import all_to_all, axis_index, axis_size, ppermute

__all__ = ["ring_attention", "ring_flash_attention", "a2a_attention",
           "reference_attention", "sp_attention_fn"]

_F32_MIN = torch.finfo(torch.float32).min


def _online_block(q, k, v, m_prev, l_prev, o_prev, mask=None):
    """One online-softmax accumulation step against a K/V block."""
    d = q.shape[-1]
    s = (q @ k.transpose(-1, -2)) / torch.full((), math.sqrt(d),
                                               dtype=q.dtype, device=q.device)
    if mask is not None:
        s = torch.where(mask, s, _F32_MIN)
    m_new = torch.maximum(m_prev, s.amax(dim=-1))
    alpha = torch.exp(m_prev - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l_prev * alpha + p.sum(dim=-1)
    o_new = o_prev * alpha[..., None] + p @ v
    return m_new, l_new, o_new


def _rotate(t: torch.Tensor, mesh: Any, axis: str, n: int) -> torch.Tensor:
    """Send to the previous coordinate, receive from the next."""
    return ppermute(t, mesh, axis, [(j, (j - 1) % n) for j in range(n)])


def _positions(idx: int, length: int, dev) -> torch.Tensor:
    return idx * length + torch.arange(length, device=dev)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: Any, axis_name: str = "sp",
                   causal: bool = False) -> torch.Tensor:
    """Exact attention over the axis's sequence shards: q, k, v this rank's
    (B, H, L/n, d) shard; returns its output shard in q's dtype."""
    n = axis_size(mesh, axis_name)
    me = axis_index(mesh, axis_name)
    l_loc = q.shape[-2]
    dev = q.device
    m = torch.full(q.shape[:-1], _F32_MIN, dtype=torch.float32, device=dev)
    l_sum = torch.zeros(q.shape[:-1], dtype=torch.float32, device=dev)
    o = torch.zeros(q.shape, dtype=torch.float32, device=dev)
    qf = q.to(torch.float32)
    kk, vv = k, v
    for i in range(n):
        src = (me + i) % n  # the block held now came from this coordinate
        mask = None
        if causal:
            mask = _positions(me, l_loc, dev)[:, None] \
                >= _positions(src, l_loc, dev)[None, :]
        m, l_sum, o = _online_block(qf, kk.to(torch.float32),
                                    vv.to(torch.float32), m, l_sum, o, mask)
        if i + 1 < n:
            kk, vv = _rotate(kk, mesh, axis_name, n), _rotate(vv, mesh, axis_name, n)
    return (o / l_sum[..., None]).to(q.dtype)


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mesh: Any, axis_name: str = "sp",
                         causal: bool = False, block_q: int = 128,
                         block_k: int = 128) -> torch.Tensor:
    """Ring attention with the flash kernel on each shard pair: memory a
    rank is the kernel's tiles, not (L/n)². ``block_q``/``block_k`` are the
    Pallas kernel's block shapes, kept for the signature; the CUDA kernel's
    tiles are its own (``flash_attention.launch_configs``)."""
    n = axis_size(mesh, axis_name)
    me = axis_index(mesh, axis_name)
    dev = q.device
    # the sentinel is the kernel's, so a skipped pair would merge as zero
    m = torch.full(q.shape[:-1], _NEG_INF, dtype=torch.float32, device=dev)
    l_sum = torch.zeros(q.shape[:-1], dtype=torch.float32, device=dev)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=dev)  # o·l
    kk, vv = k, v
    for i in range(n):
        src = (me + i) % n
        if not causal or src <= me:
            # below the diagonal every key precedes every query (full); on
            # it, the aligned causal mask; above it nothing is attended and
            # the kernel is not launched (its partial would merge as zero)
            acc_i, m_i, l_i = flash_attention(
                q, kk, vv, causal=causal and src == me, return_residuals=True)
            m_new = torch.maximum(m, m_i)
            a_old = torch.exp(m - m_new)
            a_new = torch.exp(m_i - m_new)
            l_sum = l_sum * a_old + l_i * a_new
            acc = acc * a_old[..., None] + acc_i * a_new[..., None]
            m = m_new
        if i + 1 < n:
            kk, vv = _rotate(kk, mesh, axis_name, n), _rotate(vv, mesh, axis_name, n)
    return (acc / torch.clamp(l_sum, min=1e-30)[..., None]).to(q.dtype)


def _dense(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
           causal: bool) -> torch.Tensor:
    d = qh.shape[-1]
    s = (qh @ kh.transpose(-1, -2)) / torch.full(
        (), math.sqrt(d), dtype=torch.float32, device=qh.device)
    if causal:
        length = qh.shape[-2]
        mask = torch.ones((length, length), dtype=torch.bool,
                          device=qh.device).tril()
        s = torch.where(mask, s, _F32_MIN)
    return torch.softmax(s, dim=-1) @ vh


def a2a_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mesh: Any, axis_name: str = "sp", flash: bool = False,
                  causal: bool = False) -> torch.Tensor:
    """Ulysses attention: this rank's (B, H, L/n, d) shards → all_to_all to
    (B, H/n, L, d) → attention over the full sequence (``flash``: the
    normalised float32 kernel) → back to the rank's output shard."""
    n = axis_size(mesh, axis_name)
    if q.shape[1] % n:
        raise ValueError(f"heads {q.shape[1]} not divisible by "
                         f"{axis_name} axis size {n}")
    qh, kh, vh = (all_to_all(t, mesh, axis_name, 1, 2).to(torch.float32)
                  for t in (q, k, v))
    if flash:
        oh = flash_attention(qh, kh, vh, causal=causal)
    else:
        oh = _dense(qh, kh, vh, causal)
    return all_to_all(oh.to(q.dtype), mesh, axis_name, 2, 1)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False) -> torch.Tensor:
    """Single-device exact attention (the correctness oracle)."""
    return _dense(q.to(torch.float32), k.to(torch.float32),
                  v.to(torch.float32), causal).to(q.dtype)


def sp_attention_fn(mode: str, mesh: Any, axis_name: str = "sp",
                    causal: bool = False
                    ) -> Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                                  torch.Tensor]:
    """The ``(q, k, v) -> o`` callable of a sequence-parallel mode over this
    rank's shards: ``ring``, ``ring-flash``, ``a2a``/``ulysses`` or
    ``a2a-flash``/``ulysses-flash``."""
    if mode == "ring":
        return lambda q, k, v: ring_attention(q, k, v, mesh, axis_name,
                                              causal=causal)
    if mode == "ring-flash":
        return lambda q, k, v: ring_flash_attention(q, k, v, mesh, axis_name,
                                                    causal=causal)
    if mode in ("a2a", "ulysses", "a2a-flash", "ulysses-flash"):
        use_flash = mode.endswith("-flash")
        return lambda q, k, v: a2a_attention(q, k, v, mesh, axis_name,
                                             flash=use_flash, causal=causal)
    raise ValueError(f"unknown sp mode {mode!r}")
