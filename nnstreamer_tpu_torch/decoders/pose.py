"""pose_estimation decoder — keypoint heatmaps → skeleton overlay.

Reference: ext/nnstreamer/tensor_decoder/tensordec-pose.c (:93-149).
option1 = "W:H" output size; option2 = "W:H" model input size;
option3 = keypoint label file (optional); option4 = "heatmap-offset" mode
(posenet displacement decode) or default plain-argmax heatmaps.

Input (default mode): heatmaps dims [K:W:H:1] → shape (1,H,W,K); per
keypoint the argmax cell is the joint location, value (sigmoided) the score.
heatmap-offset mode additionally reads offsets [2K:W:H:1] refining each
location (posenet convention).

Port of nnstreamer_tpu/decoders/pose.py. The device reduce on ``submit``
(per-keypoint first-max argmax over H·W, then a gather into (K, 5) rows) is
plain torch: the JAX package has no kernel for it either.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.buffer import Buffer, TensorMemory
from ..core.types import Caps, TensorsConfig
from .base import Decoder, register_decoder
from .util import draw_disc, draw_line, load_labels, new_canvas

# COCO-ish default skeleton over 17 keypoints (pairs of keypoint indices)
_DEFAULT_EDGES: Tuple[Tuple[int, int], ...] = (
    (0, 1), (0, 2), (1, 3), (2, 4), (5, 6), (5, 7), (7, 9), (6, 8), (8, 10),
    (5, 11), (6, 12), (11, 12), (11, 13), (13, 15), (12, 14), (14, 16))


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def keypoint_rows(hm: torch.Tensor, off: Optional[torch.Tensor]) -> torch.Tensor:
    """(…, H, W, K) heatmaps (+ (…, H, W, 2K) offsets) → (K, 5) float32 rows
    [x, y, heat, offset_y, offset_x] at each keypoint's first-max cell
    (torch.argmax returns the first maximal index, as jnp.argmax does)."""
    hm = hm.reshape(hm.shape[-3:])
    h, w, k = hm.shape
    flat = hm.reshape(h * w, k)
    idx = flat.argmax(dim=0)
    ks = torch.arange(k, device=hm.device)
    heat = flat[idx, ks].to(torch.float32)
    x = (idx % w).to(torch.float32)
    y = torch.div(idx, w, rounding_mode="floor").to(torch.float32)
    if off is None:
        oy = ox = torch.zeros(k, device=hm.device, dtype=torch.float32)
    else:
        off_flat = off.reshape(h * w, 2 * k)
        oy = off_flat[idx, ks].to(torch.float32)
        ox = off_flat[idx, ks + k].to(torch.float32)
    return torch.stack([x, y, heat, oy, ox], dim=1)


@register_decoder
class PoseEstimation(Decoder):
    MODE = "pose_estimation"
    ALIASES = ("pose",)

    def init(self, options) -> None:
        super().init(options)
        ow, oh = (self.option(1, "640:480")).split(":")
        self.out_w, self.out_h = int(ow), int(oh)
        iw, ih = (self.option(2, "257:257")).split(":")
        self.in_w, self.in_h = int(iw), int(ih)
        label_path = self.option(3)
        self.labels = load_labels(label_path) if label_path else []
        self.offset_mode = self.option(4, "").lower() == "heatmap-offset"
        self.score_threshold = 0.3

    def out_caps(self, config: TensorsConfig) -> Caps:
        return Caps("video/x-raw", {"format": "RGBA", "width": self.out_w,
                                    "height": self.out_h,
                                    "framerate": config.rate})

    def _point(self, x: int, y: int, heat, oy: float, ox: float, h: int,
               w: int, use_off: bool) -> Tuple[float, float, float]:
        """One keypoint from its grid cell, raw heat and offsets; the same
        arithmetic for the host and device paths, so both agree bit for
        bit."""
        score = float(_sigmoid(heat))
        if use_off:
            # posenet: position = cell/(res-1)*stride + offset
            px = (x / max(w - 1, 1)) * self.in_w + ox
            py = (y / max(h - 1, 1)) * self.in_h + oy
        else:
            px = (x + 0.5) / w * self.in_w
            py = (y + 0.5) / h * self.in_h
        return (px / self.in_w, py / self.in_h, score)

    def keypoints(self, buf: Buffer) -> List[Tuple[float, float, float]]:
        hm = buf.memories[0].host()
        if hm.ndim == 4:
            hm = hm[0]  # (H,W,K)
        H, W, K = hm.shape
        offsets = None
        if self.offset_mode and buf.num_tensors > 1:
            offsets = buf.memories[1].host()
            if offsets.ndim == 4:
                offsets = offsets[0]  # (H,W,2K)
        pts: List[Tuple[float, float, float]] = []
        for k in range(K):
            flat = int(np.argmax(hm[:, :, k]))
            y, x = divmod(flat, W)
            oy = ox = 0.0
            if offsets is not None:
                oy = float(offsets[y, x, k])
                ox = float(offsets[y, x, k + K])
            pts.append(self._point(x, y, hm[y, x, k], oy, ox, H, W,
                                   offsets is not None))
        return pts

    def submit(self, buf: Buffer, config: TensorsConfig):
        m = buf.memories[0]
        use_off = self.offset_mode and buf.num_tensors > 1
        if m.is_device and (not use_off or buf.memories[1].is_device):
            # per-keypoint argmax + gather on device: D2H ships K rows of 5
            # floats instead of the H*W*K heatmaps (+offsets)
            off = buf.memories[1].device() if use_off else None
            with torch.inference_mode():
                rows = TensorMemory(keypoint_rows(m.device(), off))
            rows.prefetch()
            return (buf, rows, m.shape[-3:])
        return super().submit(buf, config)

    def complete(self, token, config: TensorsConfig) -> Buffer:
        if isinstance(token, tuple):
            buf, rows_mem, (H, W, K) = token
            use_off = self.offset_mode and buf.num_tensors > 1
            pts = [self._point(int(x), int(y), heat, float(oy), float(ox),
                               H, W, use_off)
                   for x, y, heat, oy, ox in rows_mem.host()]
            return self._finish(pts, buf)
        return self.decode(token, config)

    def decode(self, buf: Buffer, config: TensorsConfig) -> Buffer:
        return self._finish(self.keypoints(buf), buf)

    def _finish(self, pts, buf: Buffer) -> Buffer:
        canvas = new_canvas(self.out_w, self.out_h)
        coords = []
        for nx, ny, score in pts:
            x, y = int(nx * self.out_w), int(ny * self.out_h)
            coords.append((x, y, score))
            if score >= self.score_threshold:
                draw_disc(canvas, x, y, 3)
        for a, b in _DEFAULT_EDGES:
            if a < len(coords) and b < len(coords) \
                    and coords[a][2] >= self.score_threshold \
                    and coords[b][2] >= self.score_threshold:
                draw_line(canvas, coords[a][0], coords[a][1],
                          coords[b][0], coords[b][1])
        out = buf.with_memories([TensorMemory(canvas)])
        out.meta["keypoints"] = pts
        return out
