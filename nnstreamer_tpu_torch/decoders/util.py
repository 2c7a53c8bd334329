"""Decoder helpers: label files, drawing primitives, NMS.

Reference: ext/nnstreamer/tensor_decoder/tensordecutil.c (label-file load,
sprite font) — drawing here is plain numpy rasterization onto RGBA canvases,
plus a 5x7 bitmap font for label text.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np


def load_labels(path: str) -> List[str]:
    """One label per line (tensordecutil.c _load_label_file)."""
    if not path or not os.path.isfile(path):
        raise FileNotFoundError(f"label file not found: {path}")
    with open(path, "r", encoding="utf-8") as f:
        return [ln.strip() for ln in f if ln.strip()]


# --------------------------------------------------------------------------- #
# RGBA drawing (tensordec-boundingbox.c draws boxes+label sprites on a
# transparent canvas; same contract here)
# --------------------------------------------------------------------------- #

def new_canvas(width: int, height: int) -> np.ndarray:
    return np.zeros((height, width, 4), np.uint8)


def draw_rect(canvas: np.ndarray, x0: int, y0: int, x1: int, y1: int,
              color: Sequence[int] = (0, 255, 0, 255), thickness: int = 1) -> None:
    h, w = canvas.shape[:2]
    x0, x1 = sorted((int(np.clip(x0, 0, w - 1)), int(np.clip(x1, 0, w - 1))))
    y0, y1 = sorted((int(np.clip(y0, 0, h - 1)), int(np.clip(y1, 0, h - 1))))
    c = np.asarray(color, np.uint8)
    for t in range(thickness):
        xa, ya, xb, yb = x0 + t, y0 + t, x1 - t, y1 - t
        if xa > xb or ya > yb:
            break
        canvas[ya, xa:xb + 1] = c
        canvas[yb, xa:xb + 1] = c
        canvas[ya:yb + 1, xa] = c
        canvas[ya:yb + 1, xb] = c


def draw_disc(canvas: np.ndarray, cx: int, cy: int, radius: int,
              color: Sequence[int] = (255, 0, 0, 255)) -> None:
    # rasterize only the disc's bounding square — a full-canvas mask is
    # O(H*W) per call and dominated the pose decoder's per-frame cost
    h, w = canvas.shape[:2]
    x0, x1 = max(cx - radius, 0), min(cx + radius + 1, w)
    y0, y1 = max(cy - radius, 0), min(cy + radius + 1, h)
    if x0 >= x1 or y0 >= y1:
        return
    y, x = np.ogrid[y0:y1, x0:x1]
    mask = (x - cx) ** 2 + (y - cy) ** 2 <= radius ** 2
    canvas[y0:y1, x0:x1][mask] = np.asarray(color, np.uint8)


def draw_line(canvas: np.ndarray, x0: int, y0: int, x1: int, y1: int,
              color: Sequence[int] = (255, 255, 0, 255)) -> None:
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1))
    xs = np.linspace(x0, x1, n + 1).round().astype(int)
    ys = np.linspace(y0, y1, n + 1).round().astype(int)
    h, w = canvas.shape[:2]
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    canvas[ys[ok], xs[ok]] = np.asarray(color, np.uint8)


# 5x7 font for label text (subset; tensordecutil sprite equivalent)
_FONT: Dict[str, Tuple[int, ...]] = {}


def _deffont(ch: str, rows: Sequence[str]) -> None:
    _FONT[ch] = tuple(int(r.replace(".", "0").replace("#", "1"), 2) for r in rows)


for ch, rows in {
    "0": ["01110", "10001", "10011", "10101", "11001", "10001", "01110"],
    "1": ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],
    "2": ["01110", "10001", "00001", "00110", "01000", "10000", "11111"],
    "3": ["01110", "10001", "00001", "00110", "00001", "10001", "01110"],
    "4": ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],
    "5": ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],
    "6": ["01110", "10000", "11110", "10001", "10001", "10001", "01110"],
    "7": ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],
    "8": ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],
    "9": ["01110", "10001", "10001", "01111", "00001", "00001", "01110"],
}.items():
    _deffont(ch, rows)

_ALPHA = {
    "a": ["01110", "00001", "01111", "10001", "01111"],
    "b": ["10000", "10000", "11110", "10001", "11110"],
    "c": ["01110", "10000", "10000", "10000", "01110"],
    "d": ["00001", "00001", "01111", "10001", "01111"],
    "e": ["01110", "10001", "11111", "10000", "01110"],
    "f": ["00110", "01000", "11100", "01000", "01000"],
    "g": ["01111", "10001", "01111", "00001", "01110"],
    "h": ["10000", "10000", "11110", "10001", "10001"],
    "i": ["00100", "00000", "00100", "00100", "00100"],
    "j": ["00010", "00000", "00010", "10010", "01100"],
    "k": ["10000", "10010", "11100", "10010", "10001"],
    "l": ["01100", "00100", "00100", "00100", "01110"],
    "m": ["00000", "11010", "10101", "10101", "10101"],
    "n": ["00000", "11110", "10001", "10001", "10001"],
    "o": ["01110", "10001", "10001", "10001", "01110"],
    "p": ["11110", "10001", "11110", "10000", "10000"],
    "q": ["01111", "10001", "01111", "00001", "00001"],
    "r": ["00000", "10110", "11000", "10000", "10000"],
    "s": ["01111", "10000", "01110", "00001", "11110"],
    "t": ["01000", "11100", "01000", "01000", "00110"],
    "u": ["00000", "10001", "10001", "10011", "01101"],
    "v": ["00000", "10001", "10001", "01010", "00100"],
    "w": ["00000", "10101", "10101", "10101", "01010"],
    "x": ["00000", "10001", "01110", "01110", "10001"],
    "y": ["10001", "10001", "01111", "00001", "01110"],
    "z": ["11111", "00010", "00100", "01000", "11111"],
}
for ch, rows in _ALPHA.items():
    _deffont(ch, ["00000", "00000"] + rows if len(rows) == 5 else rows)


#: rendered-text sprite cache: text → mask (7,W) bool (color-independent;
#: the color applies at blit time). Rendering glyph bitmaps per character
#: per frame is Python-loop-bound; labels repeat across frames, so each
#: unique string rasterizes once and then blits.
_SPRITES: Dict[str, np.ndarray] = {}


def _text_mask(text: str) -> np.ndarray:
    mask = np.zeros((7, 6 * len(text)), bool)
    for i, ch in enumerate(text.lower()):
        glyph = _FONT.get(ch)
        if glyph is None:
            continue
        for ry, rowbits in enumerate(glyph):
            for rx in range(5):
                if rowbits & (1 << (4 - rx)):
                    mask[ry, i * 6 + rx] = True
    return mask


def draw_text(canvas: np.ndarray, x: int, y: int, text: str,
              color: Sequence[int] = (255, 255, 255, 255)) -> None:
    if not text:
        return
    mask = _SPRITES.get(text)
    if mask is None:
        if len(_SPRITES) > 4096:  # unbounded label sets stay bounded
            _SPRITES.clear()
        mask = _SPRITES[text] = _text_mask(text)
    h, w = canvas.shape[:2]
    mh, mw = mask.shape
    x0, y0 = max(x, 0), max(y, 0)
    x1, y1 = min(x + mw, w), min(y + mh, h)
    if x0 >= x1 or y0 >= y1:
        return
    sub = mask[y0 - y:y1 - y, x0 - x:x1 - x]
    canvas[y0:y1, x0:x1][sub] = np.asarray(color, np.uint8)


# --------------------------------------------------------------------------- #
# Non-maximum suppression (tensordec-boundingbox.c nms, iou threshold 0.5)
# --------------------------------------------------------------------------- #

def iou(a: np.ndarray, b: np.ndarray) -> float:
    ax0, ay0, ax1, ay1 = a[:4]
    bx0, by0, bx1, by1 = b[:4]
    ix = max(0.0, min(ax1, bx1) - max(ax0, bx0))
    iy = max(0.0, min(ay1, by1) - max(ay0, by0))
    inter = ix * iy
    ua = (ax1 - ax0) * (ay1 - ay0) + (bx1 - bx0) * (by1 - by0) - inter
    return inter / ua if ua > 0 else 0.0


def nms(boxes: np.ndarray, iou_threshold: float = 0.5) -> np.ndarray:
    """boxes: (N, >=5) rows [x0,y0,x1,y1,score,...]; returns kept rows,
    score-descending (reference do_nms, greedy same-order semantics), with
    the pairwise IOU row vectorized — the reference's O(N²) scalar loop is
    seconds per frame at SSD anchor counts."""
    if len(boxes) == 0:
        return boxes
    order = np.argsort(-boxes[:, 4], kind="stable")
    boxes = boxes[order]
    x0, y0, x1, y1 = (boxes[:, i].astype(np.float64) for i in range(4))
    areas = (x1 - x0) * (y1 - y0)
    alive = np.ones(len(boxes), bool)
    keep: List[int] = []
    for i in range(len(boxes)):
        if not alive[i]:
            continue
        keep.append(i)
        rest = alive.copy()
        rest[: i + 1] = False
        if not rest.any():
            continue
        ix = np.minimum(x1[i], x1[rest]) - np.maximum(x0[i], x0[rest])
        iy = np.minimum(y1[i], y1[rest]) - np.maximum(y0[i], y0[rest])
        inter = np.clip(ix, 0, None) * np.clip(iy, 0, None)
        union = areas[i] + areas[rest] - inter
        over = np.where(union > 0, inter / union, 0.0) > iou_threshold
        alive[np.flatnonzero(rest)[over]] = False
    return boxes[keep]
