"""Pillow's 8-bit bilinear resize (``Image.resize(size, Image.BILINEAR)``)
as torch integer ops, on any device.

The JAX package's ``videoscale`` resizes each frame with Pillow on the host
(nnstreamer_tpu/elements/media.py:348-356), so Pillow's output is the
contract. Pillow's BILINEAR is not 2-tap interpolation: it is its
separable ``ImagingResample`` with the triangle filter, which antialiases a
downscale by widening the filter with the ratio (1920 → 300 takes 12 or 13
taps an output pixel). This module computes the same bytes:

  * coefficients (``coefficients``, per (in, out) size, float64 on the host
    and cached): scale = in / out, support = max(scale, 1); output pixel x
    has centre (x + 0.5)·scale and taps int(centre − support + 0.5) to
    int(centre + support + 0.5) clipped to the input, each weighted by the
    triangle 1 − |(i − centre + 0.5) / max(scale, 1)| (0 beyond 1),
    normalized by their sum, then to 22-bit fixed point with Pillow's
    rounding (int(0.5 + w·2²²), or int(−0.5 + w·2²²) below zero);
  * two passes, horizontal first, each skipped when its size does not
    change: gather the taps, int32 products, start from 2²¹, shift right by
    22, clip to 0..255 and store uint8 between the passes;
  * a 2- or 4-channel frame is an ``LA``/``RGBA`` image: its colour channels
    are premultiplied by the last one first (t = c·a + 128, c' = ((t >> 8)
    + t) >> 8, Pillow's MULDIV255) and unpremultiplied after, c = min(255,
    255·c' // a) where 0 < a < 255 (kept where a is 0 or 255).

Everything after the coefficients is integer arithmetic, so the card and
the CPU give the same bytes by construction. A frame Pillow's
``Image.fromarray`` refuses (not uint8, or an (H, W, 1) frame) raises
``TypeError`` as Pillow does.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

PRECISION_BITS = 22
_ROUND = 1 << (PRECISION_BITS - 1)
_CACHE_SIZE = 64


@functools.lru_cache(maxsize=_CACHE_SIZE)
def coefficients(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(first tap of each output pixel, int32 weights (out, taps)) of
    Pillow's bilinear resample from ``in_size`` to ``out_size`` pixels;
    taps past an output pixel's last weigh 0."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ws = []
        total = 0.0
        for x in range(xmax):
            arg = abs((x + xmin - center + 0.5) * (1.0 / filterscale))
            w = 1.0 - arg if arg < 1.0 else 0.0
            ws.append(w)
            total += w
        for x, w in enumerate(ws):
            if total != 0.0:
                w = w / total
            weights[xx, x] = int(-0.5 + w * (1 << PRECISION_BITS)) if w < 0 \
                else int(0.5 + w * (1 << PRECISION_BITS))
        first[xx] = xmin
    return first, weights.astype(np.int32)


@functools.lru_cache(maxsize=_CACHE_SIZE)
def _taps(in_size: int, out_size: int, device: torch.device
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gather indices (out·taps,) and int32 weights (out, taps) of a
    pass on ``device``; out-of-range taps (weight 0) read the last pixel."""
    first, weights = coefficients(in_size, out_size)
    idx = np.minimum(first[:, None] + np.arange(weights.shape[1]), in_size - 1)
    return (torch.from_numpy(idx.reshape(-1)).to(device),
            torch.from_numpy(weights).to(device))


def _pass(x: torch.Tensor, dim: int, out_size: int) -> torch.Tensor:
    """Resample (H, W, C) uint8 ``x`` along ``dim`` (0 rows, 1 columns)."""
    idx, w = _taps(x.shape[dim], out_size, x.device)
    ksize = w.shape[1]
    taps = x.index_select(dim, idx).to(torch.int32)
    if dim == 0:
        taps = taps.view(out_size, ksize, x.shape[1], x.shape[2])
        acc = (taps * w[:, :, None, None]).sum(1, dtype=torch.int32)
    else:
        taps = taps.view(x.shape[0], out_size, ksize, x.shape[2])
        acc = (taps * w[None, :, :, None]).sum(2, dtype=torch.int32)
    return ((acc + _ROUND) >> PRECISION_BITS).clamp_(0, 255).to(torch.uint8)


def _premultiply(x: torch.Tensor) -> torch.Tensor:
    a = x[..., -1:].to(torch.int32)
    t = x[..., :-1].to(torch.int32) * a + 128
    return torch.cat([((t >> 8) + t) >> 8, a], dim=-1).to(torch.uint8)


def _unpremultiply(x: torch.Tensor) -> torch.Tensor:
    a = x[..., -1:].to(torch.int32)
    c = x[..., :-1].to(torch.int32)
    scaled = torch.clamp((255 * c) // a.clamp(min=1), max=255)
    keep = (a == 0) | (a == 255)
    return torch.cat([torch.where(keep, c, scaled), a], dim=-1).to(torch.uint8)


def check_frame(shape: Tuple[int, ...], dtype: str) -> None:
    """Raise as Pillow's ``Image.fromarray`` does for a frame it has no
    8-bit mode for."""
    ok = dtype == "uint8" and (len(shape) == 2 or (len(shape) == 3
                                                  and shape[2] in (2, 3, 4)))
    if not ok:
        typekey = (1, 1) + tuple(shape[2:])
        raise TypeError(f"Cannot handle this data type: {typekey}, |"
                        f"{'u1' if dtype == 'uint8' else dtype}")


def resize(frame: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """``frame`` ((H, W) or (H, W, C) uint8, C 2, 3 or 4) resized to
    ``height``×``width`` as Pillow's BILINEAR does, on ``frame``'s device."""
    check_frame(tuple(frame.shape), str(frame.dtype).removeprefix("torch."))
    if tuple(frame.shape[:2]) == (height, width):
        return frame.clone()  # Pillow copies a same-size image untouched
    flat = frame.dim() == 2
    x = frame[..., None] if flat else frame
    alpha = x.shape[2] in (2, 4)
    if alpha:
        x = _premultiply(x)
    if x.shape[1] != width:
        x = _pass(x, 1, width)
    if x.shape[0] != height:
        x = _pass(x, 0, height)
    if alpha:
        x = _unpremultiply(x)
    x = x.contiguous()
    return x[..., 0] if flat else x
