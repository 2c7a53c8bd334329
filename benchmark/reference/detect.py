"""Plain NumPy detection tail, the reference for the SSD cells:
``TFLite_Detection_PostProcess``'s fast path (center-size decode, each
anchor's best class, class-agnostic greedy NMS, the top ``max_detections``)
and the ``bounding_box`` decoder's ``mobilenet-ssd-postprocess`` mode
(score threshold 0.5, greedy NMS at IoU 0.5, boxes and label text drawn on
a transparent RGBA canvas).

The drawing follows the decoder's contract: a 1-pixel green (0, 255, 0,
255) rectangle from int(x0·W), int(y0·H) to int(x1·W), int(y1·H), clipped
to the canvas, and the label in white at (x + 2, y + 2) in the 5×7 font
below (a frozen copy of nnstreamer_tpu_torch/decoders/util.py's glyphs).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

_DIGITS = {
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
}
_LOWER = {
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
FONT: Dict[str, np.ndarray] = {}
for _ch, _rows in {**_DIGITS, **{k: ["00000", "00000"] + v for k, v in _LOWER.items()}}.items():
    FONT[_ch] = np.array([[c == "1" for c in r] for r in _rows], bool)


def text_mask(text: str) -> np.ndarray:
    mask = np.zeros((7, 6 * len(text)), bool)
    for i, ch in enumerate(text.lower()):
        g = FONT.get(ch)
        if g is not None:
            mask[:, i * 6:i * 6 + 5] = g
    return mask


def render(dets: Sequence[dict], labels: List[str], width: int, height: int) -> np.ndarray:
    """The decoder's canvas for ``dets`` (dicts of ``box`` (x0, y0, x1,
    y1) float32 values and ``class``)."""
    canvas = np.zeros((height, width, 4), np.uint8)
    green, white = np.array([0, 255, 0, 255], np.uint8), np.array([255] * 4, np.uint8)
    for d in dets:
        x0, y0, x1, y1 = (np.float32(v) for v in d["box"])
        px0, py0 = int(x0 * np.float32(width)), int(y0 * np.float32(height))
        px1, py1 = int(x1 * np.float32(width)), int(y1 * np.float32(height))
        a, b = sorted((min(max(px0, 0), width - 1), min(max(px1, 0), width - 1)))
        c, e = sorted((min(max(py0, 0), height - 1), min(max(py1, 0), height - 1)))
        canvas[c, a:b + 1] = green
        canvas[e, a:b + 1] = green
        canvas[c:e + 1, a] = green
        canvas[c:e + 1, b] = green
        cls = int(d["class"])
        label = labels[cls] if cls < len(labels) else str(cls)
        if not label:
            continue
        m = text_mask(label)
        tx, ty = px0 + 2, py0 + 2
        xa, ya = max(tx, 0), max(ty, 0)
        xb, yb = min(tx + m.shape[1], width), min(ty + m.shape[0], height)
        if xa < xb and ya < yb:
            canvas[ya:yb, xa:xb][m[ya - ty:yb - ty, xa - tx:xb - tx]] = white
    return canvas


def iou_row(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """IoU of ``box`` (x0, y0, x1, y1) with each row of ``boxes``, in
    float64; 0 where either area or the union is not positive."""
    ix = np.clip(np.minimum(box[2], boxes[:, 2]) - np.maximum(box[0], boxes[:, 0]), 0, None)
    iy = np.clip(np.minimum(box[3], boxes[:, 3]) - np.maximum(box[1], boxes[:, 1]), 0, None)
    inter = ix * iy
    a = (box[2] - box[0]) * (box[3] - box[1])
    b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    union = a + b - inter
    ok = (a > 0) & (b > 0) & (union > 0)
    return np.where(ok, inter / np.where(union > 0, union, 1.0), 0.0)


def greedy_nms(boxes: np.ndarray, scores: np.ndarray, iou: float, limit: int) -> List[int]:
    """Indices kept by greedy NMS over ``scores`` in descending order (ties
    by index), a box suppressed where its IoU with a kept one is above
    ``iou``; at most ``limit``."""
    order = np.argsort(-scores, kind="stable")
    most = np.zeros(len(scores))
    keep: List[int] = []
    for i in order:
        if most[i] > iou:
            continue
        keep.append(int(i))
        if len(keep) == limit:
            break
        most = np.maximum(most, iou_row(boxes[i], boxes))
    return keep


def decode_boxes(box_enc: np.ndarray, anchors: np.ndarray, post: dict) -> np.ndarray:
    """Center-size decode: (N, 4) (x0, y0, x1, y1) in float64."""
    e, a = box_enc.astype(np.float64), anchors.astype(np.float64)
    yc = e[:, 0] / post["y_scale"] * a[:, 2] + a[:, 0]
    xc = e[:, 1] / post["x_scale"] * a[:, 3] + a[:, 1]
    h = np.exp(e[:, 2] / post["h_scale"]) * a[:, 2]
    w = np.exp(e[:, 3] / post["w_scale"]) * a[:, 3]
    return np.stack([xc - w / 2, yc - h / 2, xc + w / 2, yc + h / 2], axis=1)


def detect(box_enc: np.ndarray, logits: np.ndarray, anchors: np.ndarray, post: dict,
           threshold: float, iou: float) -> dict:
    """One frame's reference: ``box_enc`` (N, 4), ``logits`` (N, C + 1)
    with the background column first. Returns every anchor's decoded box,
    its class logits (without the background column) and the final
    detections (anchor, class, score) after both stages."""
    boxes = decode_boxes(box_enc, anchors, post)
    cls_logits = logits[:, logits.shape[1] - int(post["num_classes"]):].astype(np.float64)
    best = np.argmax(cls_logits, axis=1)
    score = 1.0 / (1.0 + np.exp(-cls_logits[np.arange(len(best)), best]))
    idx = np.flatnonzero(score >= post["nms_score_threshold"])
    kept = idx[greedy_nms(boxes[idx], score[idx], post["nms_iou_threshold"],
                          int(post["max_detections"]))]
    stage2 = kept[score[kept] >= threshold]
    final = stage2[greedy_nms(boxes[stage2], score[stage2], iou, len(stage2))] \
        if len(stage2) else stage2
    return {"boxes": boxes, "cls_logits": cls_logits,
            "final": [(int(a), int(best[a]), float(score[a])) for a in final]}


def iou_bounds(box: np.ndarray, boxes: np.ndarray, ex: float, ey: float):
    """The least and the greatest IoU of ``box`` with each row of ``boxes``
    when every x coordinate may be off by up to ``ex`` and every y by up to
    ``ey``; each term is bounded on its own, so the bounds are loose but
    hold."""
    iw = np.minimum(box[2], boxes[:, 2]) - np.maximum(box[0], boxes[:, 0])
    ih = np.minimum(box[3], boxes[:, 3]) - np.maximum(box[1], boxes[:, 1])
    inter_lo = np.clip(iw - 2 * ex, 0, None) * np.clip(ih - 2 * ey, 0, None)
    inter_hi = np.clip(iw + 2 * ex, 0, None) * np.clip(ih + 2 * ey, 0, None)
    wa, ha = box[2] - box[0], box[3] - box[1]
    wb, hb = boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1]
    a_lo = max(wa - 2 * ex, 0.0) * max(ha - 2 * ey, 0.0)
    b_lo = np.clip(wb - 2 * ex, 0, None) * np.clip(hb - 2 * ey, 0, None)
    a_hi, b_hi = (wa + 2 * ex) * (ha + 2 * ey), (wb + 2 * ex) * (hb + 2 * ey)
    inter_hi = np.minimum(inter_hi, np.minimum(a_hi, b_hi))
    lo = inter_lo / (a_hi + b_hi - inter_lo)
    union_lo = np.maximum(np.maximum(a_lo + b_lo - inter_hi, b_lo), a_lo)
    hi = np.where(union_lo > 0, np.minimum(inter_hi / np.where(union_lo > 0, union_lo, 1.0),
                                           1.0), 1.0)
    return lo, hi


def _bounded_greedy(cand, s_lo, s_hi, sure_in, boxes, iou, limit, ex, ey):
    """Greedy NMS (a box suppressed where its IoU with a kept one above it
    is over ``iou``; the first ``limit`` kept) over the anchors ``cand``
    whose scores are known only to lie in [s_lo, s_hi] and whose boxes only
    to within (ex, ey); ``sure_in`` marks the candidates certainly in the
    input. Returns the anchors certainly kept and those possibly kept."""
    order = cand[np.lexsort((cand, -s_hi[cand]))]
    status = {}  # 2 certainly kept so far, 1 possibly, 0 certainly suppressed
    done = []
    for pos, i in enumerate(order):
        if limit is not None and sum(
                1 for j in done if status[j] == 2 and sure_in[j] and s_lo[j] > s_hi[i]) >= limit:
            break
        prev = np.array(done, np.int64)
        sure_sup = False
        if len(prev):
            lo, hi = iou_bounds(boxes[i], boxes[prev], ex, ey)
            kept = np.array([status[j] for j in done])
            above = s_lo[prev] > s_hi[i]
            sure_sup = bool(np.any((kept == 2) & sure_in[prev] & above & (lo > iou)))
        if sure_sup:
            status[i] = 0
        else:
            rest = order[pos + 1:]
            rest = rest[s_hi[rest] >= s_lo[i]]
            maybe = False
            if len(prev):
                maybe = bool(np.any((kept > 0) & (s_hi[prev] >= s_lo[i]) & (hi > iou)))
            if not maybe and len(rest):
                maybe = bool(np.any(iou_bounds(boxes[i], boxes[rest], ex, ey)[1] > iou))
            status[i] = 1 if maybe else 2
        done.append(int(i))
    sure, may = set(), set()
    for i in done:
        if status[i] == 0:
            continue
        if limit is not None:
            n_sure = sum(1 for j in done if status[j] == 2 and sure_in[j] and s_lo[j] > s_hi[i])
            n_may = sum(1 for j in cand if j != i and status.get(j, 1) > 0
                        and s_hi[j] >= s_lo[i])
        else:
            n_sure = n_may = 0
        if limit is None or n_sure < limit:
            may.add(int(i))
            if status[i] == 2 and sure_in[i] and (limit is None or n_may < limit):
                sure.add(int(i))
    return sure, may


def bounded_final(ref: dict, post: dict, threshold: float, iou: float, eps: float,
                  ex: float, ey: float):
    """The anchors certainly among a frame's final detections, and those
    possibly among them, when the program's logits may be off by up to
    ``eps`` and its box coordinates by up to ``ex`` and ``ey``: both stages
    of ``detect`` with every comparison that such errors could flip left
    open (a score near a threshold, two scores that could swap, an IoU near
    a threshold, the ``max_detections`` cut), and what follows from it."""
    boxes = ref["boxes"]
    best = ref["cls_logits"].max(axis=1)
    sig = lambda x: (1.0 / (1.0 + np.exp(-x))).astype(np.float32)  # noqa: E731
    s_lo, s_hi = sig(best - eps), sig(best + eps)
    thr1 = np.float32(post["nms_score_threshold"])
    cand = np.flatnonzero(s_hi >= thr1)
    sure1, may1 = _bounded_greedy(cand, s_lo, s_hi, s_lo >= thr1, boxes,
                                  post["nms_iou_threshold"], int(post["max_detections"]), ex, ey)
    thr2 = np.float32(threshold)
    cand2 = np.array(sorted(a for a in may1 if s_hi[a] >= thr2), np.int64)
    sure_in = np.zeros(len(best), bool)
    sure_in[[a for a in sure1 if s_lo[a] >= thr2]] = True
    return _bounded_greedy(cand2, s_lo, s_hi, sure_in, boxes, iou, None, ex, ey)


def _logit(p: float) -> float:
    p = min(max(p, 1e-30), 1 - 1e-16)
    return float(np.log(p) - np.log1p(-p))


def judge_frame(dets: Sequence[dict], canvas: np.ndarray, ref: dict,
                labels: List[str], width: int, height: int, final=None,
                box_tol: float = 0.0) -> dict:
    """The numbers of one frame: the widest logit gap of a served
    detection's score or class against the reference's at its anchor, the
    widest box error in output pixels, and the canvas pixels that differ
    from the served detections drawn by ``render``. With ``final``, the
    (certain, possible) anchors of ``bounded_final``, also the detections
    one side has and the other lacks: each certain anchor no served box
    matches, and each served box that matches no possible anchor within
    ``box_tol`` pixels or repeats one already matched."""
    boxes = ref["boxes"]
    scale = np.array([width, height, width, height], np.float64)
    logit_gap, box_px = 0.0, 0.0
    sure, may = final if final is not None else (set(), set())
    may_ids = np.array(sorted(may), np.int64)
    matched, unmatched = set(), 0
    for d in dets:
        b = np.asarray(d["box"], np.float64)
        err = np.abs(boxes - b[None, :]) * scale[None, :]
        a = int(np.argmin(err.max(axis=1)))
        box_px = max(box_px, float(err[a].max()))
        if final is not None:
            m = err[may_ids].max(axis=1) if len(may_ids) else np.zeros(0)
            k = int(np.argmin(m)) if len(m) else -1
            if k < 0 or m[k] > box_tol or int(may_ids[k]) in matched:
                unmatched += 1
            else:
                matched.add(int(may_ids[k]))
        row, c = ref["cls_logits"][a], int(d["class"])
        if not 0 <= c < len(row):
            logit_gap = float("inf")
            continue
        logit_gap = max(logit_gap, abs(_logit(float(d["score"])) - row[c]),
                        float(row.max() - row[c]))
        want = labels[c] if c < len(labels) else str(c)
        if d.get("label", want) != want:
            logit_gap = float("inf")
    drawn = render(dets, labels, width, height)
    canvas_px = int((canvas.reshape(height, width, 4) != drawn).any(axis=2).sum()) \
        if canvas.size == drawn.size else width * height
    out = {"logit_gap": logit_gap, "box_px": box_px, "canvas_px": canvas_px}
    if final is not None:
        out["det_mismatch"] = len(sure - matched) + unmatched
    return out
