"""bounding_box decoder — SSD-style detection → RGBA overlay video.

Reference: ext/nnstreamer/tensor_decoder/tensordec-boundingbox.c (modes
:121-133; scales/thresholds :40-58). Supported modes (option1):

  * ``mobilenet-ssd``            — raw SSD head: locations [4:N:1] + class
    logits [L:N:1]; needs a box-priors file (option3), sigmoid scoring,
    center-size decode with scales (Y,X,H,W)=(10,10,5,5), NMS@0.5.
  * ``mobilenet-ssd-postprocess``— model already decoded: boxes [4:M],
    class ids [M], scores [M], count [1] (tflite detection postprocess).
  * ``ov-person-detection`` / ``ov-face-detection`` — OpenVINO layout
    rows [image_id, label, conf, x0, y0, x1, y1].
  * ``tflite-ssd`` / ``tf-ssd`` — backward-compat OLDNAME aliases for the
    first two modes (tensordec-boundingbox.c:129-131, 151-159).

Options: option2=label file, option3=priors file[:threshold[:iou]],
option4="W:H" output video size, option5="W:H" model input size.
Output: transparent RGBA canvas with green boxes + white label text
(compose over the source video downstream), identical contract to the
reference decoder.

Port of nnstreamer_tpu/decoders/bounding_box.py. Every mode's device reduce
(mobilenet-ssd: box decode → class_reduce; then threshold → top-K →
nms_sweep) runs in torch with the hand-written CUDA kernels of ops/kernels.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.buffer import Buffer, TensorMemory
from ..core.types import Caps, TensorsConfig
from ..ops.kernels import epilogue as _ep
from .base import Decoder, register_decoder
from .util import draw_rect, draw_text, load_labels, new_canvas, nms

# center-size decode scales (tensordec-boundingbox.c:40-47)
Y_SCALE, X_SCALE, H_SCALE, W_SCALE = 10.0, 10.0, 5.0, 5.0
DEFAULT_THRESHOLD = 0.5
DEFAULT_IOU = 0.5


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def _f32(xp, a):
    return a.astype(np.float32) if xp is np else a.to(torch.float32)


def ssd_box_math(xp, locs, raw_scores, priors):
    """Center-size decode + sigmoid class scores, array-namespace-agnostic
    (xp = numpy for the host path, torch for the device reduce — ONE
    implementation so the two paths cannot diverge).
    Returns (x0, y0, x1, y1, cls_scores) with cls_scores (N, L-1),
    background class 0 already dropped (a column view of the scores)."""
    locs = _f32(xp, locs.reshape(-1, 4))
    scores = 1.0 / (1.0 + xp.exp(
        -_f32(xp, raw_scores.reshape(locs.shape[0], -1))))
    # torch divides by tensors: its CUDA division by a Python scalar
    # multiplies by the reciprocal (the halvings below are exact either way)
    y_s, x_s, h_s, w_s = (Y_SCALE, X_SCALE, H_SCALE, W_SCALE) if xp is np else (
        torch.full((), v, device=locs.device) for v in (Y_SCALE, X_SCALE, H_SCALE, W_SCALE))
    ycenter = locs[:, 0] / y_s * priors[2] + priors[0]
    xcenter = locs[:, 1] / x_s * priors[3] + priors[1]
    hh = xp.exp(locs[:, 2] / h_s) * priors[2]
    ww = xp.exp(locs[:, 3] / w_s) * priors[3]
    return (xcenter - ww / 2, ycenter - hh / 2,
            xcenter + ww / 2, ycenter + hh / 2, scores[:, 1:])


def load_box_priors(path: str) -> np.ndarray:
    """Priors file: 4 whitespace-separated float rows [ycenter,xcenter,h,w]
    (reference box_priors.txt layout)."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"box priors file not found: {path}")
    rows: List[List[float]] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            vals = [float(v) for v in line.split()]
            if vals:
                rows.append(vals)
    if len(rows) < 4:
        raise ValueError(f"box priors file needs 4 rows, got {len(rows)}")
    return np.asarray(rows[:4], np.float32)  # (4, N)


@register_decoder
class BoundingBox(Decoder):
    MODE = "bounding_box"
    ALIASES = ("boundingbox",)

    def init(self, options) -> None:
        super().init(options)
        self.box_mode = self.option(1, "mobilenet-ssd").lower()
        label_path = self.option(2)
        self.labels = load_labels(label_path) if label_path else []
        self.threshold = DEFAULT_THRESHOLD
        self.iou_threshold = DEFAULT_IOU
        self.priors: Optional[np.ndarray] = None
        opt3 = self.option(3)
        if opt3:
            parts = opt3.split(":")
            if self.box_mode in ("mobilenet-ssd", "tflite-ssd"):
                self.priors = load_box_priors(parts[0])
                extra = parts[1:]
            else:
                extra = parts
            if len(extra) >= 1 and extra[0]:
                self.threshold = float(extra[0])
            if len(extra) >= 2 and extra[1]:
                self.iou_threshold = float(extra[1])
        self.out_w, self.out_h = _parse_wh(self.option(4, "640:480"))
        self.in_w, self.in_h = _parse_wh(self.option(5, "300:300"))

    def out_caps(self, config: TensorsConfig) -> Caps:
        return Caps("video/x-raw", {"format": "RGBA", "width": self.out_w,
                                    "height": self.out_h,
                                    "framerate": config.rate})

    # -- decode modes -------------------------------------------------------- #
    def _objects_mobilenet_ssd(self, buf: Buffer) -> np.ndarray:
        if self.priors is None:
            raise ValueError("mobilenet-ssd mode requires option3 box-priors file")
        x0, y0, x1, y1, cls = ssd_box_math(
            np, buf.memories[0].host(), buf.memories[1].host(), self.priors)
        best = np.argmax(cls, axis=1)
        best_score = cls[np.arange(len(best)), best]
        sel = np.nonzero(best_score >= self.threshold)[0]
        if len(sel) > self.PRE_NMS_TOPK:
            order = np.argsort(-best_score[sel], kind="stable")[:self.PRE_NMS_TOPK]
            sel = np.sort(sel[order])
        return np.stack(
            [x0[sel], y0[sel], x1[sel], y1[sel], best_score[sel],
             (best[sel] + 1).astype(np.float32)], axis=1) if len(sel) else \
            np.zeros((0, 6), np.float32)

    def _objects_postprocess(self, buf: Buffer) -> np.ndarray:
        boxes = buf.memories[0].host().reshape(-1, 4).astype(np.float32)
        classes = buf.memories[1].host().reshape(-1).astype(np.float32)
        scores = buf.memories[2].host().reshape(-1).astype(np.float32)
        n = int(buf.memories[3].host().reshape(-1)[0]) if buf.num_tensors > 3 \
            else len(scores)
        out = []
        for i in range(min(n, len(scores))):
            if scores[i] < self.threshold:
                continue
            ymin, xmin, ymax, xmax = boxes[i]
            out.append([xmin, ymin, xmax, ymax, scores[i], classes[i]])
        return np.asarray(out, np.float32).reshape(-1, 6)

    def _objects_ov(self, buf: Buffer) -> np.ndarray:
        rows = buf.memories[0].host().reshape(-1, 7).astype(np.float32)
        out = []
        for r in rows:
            if r[0] < 0 or r[2] < self.threshold:
                continue
            out.append([r[3], r[4], r[5], r[6], r[2], r[1]])
        return np.asarray(out, np.float32).reshape(-1, 6)

    #: pre-NMS candidate cap, applied identically on the host and device
    #: paths: the top-K anchors by best-class score enter NMS (the tflite
    #: detection-postprocess convention the reference consumes via its
    #: mobilenet-ssd-postprocess mode). A static K keeps the device reduce
    #: fixed-shape: D2H ships K rows of 6 floats instead of
    #: N_anchors×(4+num_classes) logits.
    PRE_NMS_TOPK = 256

    def _make_reduce(self):
        """``(torch reduce fn, arity)`` for this mode's device reduction
        (arity = leading memories consumed; None = all), or None.

        Every mode funnels into one shape: rank candidates (threshold mask
        → top-K by a stable descending sort, score -1 ⇒ unused slot), then
        the greedy ``nms_sweep`` (kernel; reference nms(),
        tensordec-boundingbox.c:962-976: strict > suppresses), emitting
        fixed (K, 6) rows [x0, y0, x1, y1, score, class]. mobilenet-ssd
        first decodes the boxes and takes each anchor's best class with
        ``class_reduce`` (kernel). The same function serves the async
        submit path and ``epilogue_reduce``."""
        threshold = float(self.threshold)
        iou_thr = float(self.iou_threshold)
        topk = self.PRE_NMS_TOPK

        def top(masked, k):
            # jax.lax.top_k puts tied scores in index order; a stable
            # descending sort keeps that order (torch.topk does not
            # promise it on CUDA), and the order decides which box NMS keeps
            top_score, idx = torch.sort(masked, descending=True, stable=True)
            return top_score[:k].contiguous(), idx[:k]

        def nms_rows(bx0, by0, bx1, by1, top_score, cls_sel):
            bx0, by0, bx1, by1 = (c.contiguous() for c in (bx0, by0, bx1, by1))
            out_score = _ep.nms_sweep(bx0, by0, bx1, by1, top_score,
                                      iou_threshold=iou_thr,
                                      threshold=threshold)
            return torch.stack([bx0, by0, bx1, by1, out_score, cls_sel], dim=1)

        if self.box_mode in ("mobilenet-ssd", "tflite-ssd"):
            if self.priors is None:
                return None
            priors_np = self.priors
            priors_on: dict = {}

            def reduce_ssd(locs, raw):
                pr = priors_on.get(locs.device)
                if pr is None:
                    pr = priors_on[locs.device] = torch.as_tensor(
                        priors_np, dtype=torch.float32, device=locs.device)
                x0, y0, x1, y1, cls = ssd_box_math(torch, locs, raw, pr)
                best_score, best = _ep.class_reduce(cls)
                # mask below-threshold anchors out before ranking so the K
                # slots hold only real candidates (score -1 ⇒ unused)
                masked = torch.where(best_score >= threshold, best_score, -1.0)
                top_score, idx = top(masked, min(topk, int(masked.shape[0])))
                return nms_rows(x0[idx], y0[idx], x1[idx], y1[idx], top_score,
                                (best[idx] + 1).to(torch.float32))

            return reduce_ssd, 2
        if self.box_mode in ("mobilenet-ssd-postprocess", "tf-ssd",
                             "tflite-ssd-postprocess"):
            def reduce_post(boxes, classes, scores, *rest):
                boxes = boxes.reshape(-1, 4).to(torch.float32)
                classes = classes.reshape(-1).to(torch.float32)
                scores = scores.reshape(-1).to(torch.float32)
                m = int(scores.shape[0])
                order = torch.arange(m, device=scores.device)
                if rest:  # count tensor caps valid rows (input order)
                    valid = order < rest[0].reshape(-1)[0].to(
                        torch.int32).clamp(max=m)
                else:
                    valid = torch.ones(m, dtype=torch.bool,
                                       device=scores.device)
                masked = torch.where(valid & (scores >= threshold), scores,
                                     -1.0)
                top_score, idx = top(masked, min(topk, m))
                b = boxes[idx]  # rows are [ymin, xmin, ymax, xmax]
                return nms_rows(b[:, 1], b[:, 0], b[:, 3], b[:, 2], top_score,
                                classes[idx])

            return reduce_post, None
        if self.box_mode.startswith("ov-"):
            def reduce_ov(rows):
                r = rows.reshape(-1, 7).to(torch.float32)
                masked = torch.where((r[:, 0] >= 0) & (r[:, 2] >= threshold),
                                     r[:, 2], -1.0)
                top_score, idx = top(masked, min(topk, int(r.shape[0])))
                rr = r[idx]
                return nms_rows(rr[:, 3], rr[:, 4], rr[:, 5], rr[:, 6],
                                top_score, rr[:, 1])

            return reduce_ov, 1
        return None

    def epilogue_reduce(self):
        made = self._make_reduce()
        if made is None:
            return None
        reduce, arity = made

        def fn(outs):
            return reduce(*(outs if arity is None else outs[:arity]))

        return fn

    def _device_reduce_for(self, buf: Buffer):
        """(reduce, memories) when every consumed memory is already
        device-resident — host tensors decode on host for free instead."""
        if not hasattr(self, "_device_reduce"):
            self._device_reduce = self._make_reduce()
        dr = self._device_reduce
        if dr is None:
            return None
        fn, arity = dr
        if arity is not None and buf.num_tensors < arity:
            return None
        mems = buf.memories if arity is None else buf.memories[:arity]
        if not mems or not all(m.is_device for m in mems):
            return None
        return fn, mems

    def submit(self, buf: Buffer, config: TensorsConfig):
        if self._fused_epilogue:
            # the upstream filter's invoke already ran the fused reduce:
            # memories[0] holds the (K, 6) rows — keep the D2H in flight
            mem = buf.memories[0]
            mem.prefetch()
            return (buf, mem)
        red = self._device_reduce_for(buf)
        if red is not None:
            # box decode + class max + threshold + top-K + greedy NMS, all
            # on device — complete() only filters kept rows
            fn, mems = red
            with torch.inference_mode():
                rows = TensorMemory(fn(*(m.device() for m in mems)))
            rows.prefetch()
            return (buf, rows)
        return super().submit(buf, config)

    def complete(self, token, config: TensorsConfig) -> Buffer:
        if isinstance(token, tuple):
            buf, rows_mem = token
            rows = rows_mem.host()
            # device reduce already thresholded + NMS'd (suppressed slots
            # carry score -1); don't pay the O(K²) host NMS again
            objs = rows[rows[:, 4] >= self.threshold]
            return self._finish(objs, buf, suppressed=True)
        return self.decode(token, config)

    def decode(self, buf: Buffer, config: TensorsConfig) -> Buffer:
        if self._fused_epilogue:
            rows = np.asarray(buf.memories[0].host())
            objs = rows[rows[:, 4] >= self.threshold]
            return self._finish(objs, buf, suppressed=True)
        if self.box_mode in ("mobilenet-ssd", "tflite-ssd"):
            objs = self._objects_mobilenet_ssd(buf)
        elif self.box_mode in ("mobilenet-ssd-postprocess", "tf-ssd",
                               "tflite-ssd-postprocess"):
            objs = self._objects_postprocess(buf)
        elif self.box_mode.startswith("ov-"):
            objs = self._objects_ov(buf)
        else:
            raise ValueError(f"bounding_box: unknown mode {self.box_mode!r}")
        return self._finish(objs, buf)

    def _finish(self, objs: np.ndarray, buf: Buffer,
                suppressed: bool = False) -> Buffer:
        if not suppressed:
            objs = nms(objs, self.iou_threshold)
        canvas = new_canvas(self.out_w, self.out_h)
        detections = []
        for x0, y0, x1, y1, score, cls in objs:
            px0, py0 = int(x0 * self.out_w), int(y0 * self.out_h)
            px1, py1 = int(x1 * self.out_w), int(y1 * self.out_h)
            draw_rect(canvas, px0, py0, px1, py1)
            cls_i = int(cls)
            label = self.labels[cls_i] if cls_i < len(self.labels) else str(cls_i)
            draw_text(canvas, px0 + 2, py0 + 2, label)
            detections.append({"box": (float(x0), float(y0), float(x1), float(y1)),
                               "score": float(score), "class": cls_i,
                               "label": label})
        out = buf.with_memories([TensorMemory(canvas)])
        out.meta["detections"] = detections
        return out


def _parse_wh(s: str) -> Tuple[int, int]:
    w, h = s.split(":")
    return int(w), int(h)
