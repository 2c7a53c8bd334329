"""Plain NumPy version of Pillow's 8-bit BILINEAR resize of an RGB frame
(``Image.resize(size, Image.BILINEAR)``), which ``videoscale`` promises.

Pillow's resample (``libImaging/Resample.c``): per axis, scale = in/out,
filterscale = max(scale, 1), support = filterscale (the triangle's 1.0
times it); output pixel x has centre (x + 0.5)·scale and taps
int(centre − support + 0.5) .. int(centre + support + 0.5) clipped to the
input, weighted by the triangle at (tap − centre + 0.5)/filterscale and
normalised by their sum, then held as 22-bit fixed point (int(w·2²² ±
0.5)). The horizontal pass runs first and rounds to uint8, then the
vertical one; each adds 2²¹ and shifts right by 22, clipped to 0..255.
"""

from __future__ import annotations

import numpy as np

PRECISION_BITS = 22


def _coeffs(in_size: int, out_size: int):
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    idx = np.zeros((out_size, ksize), np.int64)
    wts = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ws = []
        for x in range(xmax):
            t = abs((x + xmin - center + 0.5) * (1.0 / filterscale))
            ws.append(1.0 - t if t < 1.0 else 0.0)
        total = sum(ws)
        for x, w in enumerate(ws):
            w = w / total if total != 0.0 else w
            wts[xx, x] = int(w * (1 << PRECISION_BITS) + (0.5 if w >= 0 else -0.5))
            idx[xx, x] = x + xmin
        idx[xx, xmax:] = xmin  # weight 0
    return idx, wts


def _pass(x: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    idx, wts = _coeffs(x.shape[axis], out_size)
    taps = np.take(x.astype(np.int64), idx, axis=axis)  # (..., out, k, ...)
    if axis == 0:
        acc = (taps * wts[:, :, None, None]).sum(axis=1)
    else:
        acc = (taps * wts[None, :, :, None]).sum(axis=2)
    acc = (acc + (1 << (PRECISION_BITS - 1))) >> PRECISION_BITS
    return np.clip(acc, 0, 255).astype(np.uint8)


def resize_rgb(frame: np.ndarray, width: int, height: int) -> np.ndarray:
    """(H, W, 3) uint8 → (height, width, 3) uint8."""
    x = frame
    if x.shape[1] != width:
        x = _pass(x, 1, width)
    if x.shape[0] != height:
        x = _pass(x, 0, height)
    return np.ascontiguousarray(x)
