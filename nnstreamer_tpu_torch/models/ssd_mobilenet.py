"""SSD-MobileNet object detection in torch — port of
nnstreamer_tpu/models/ssd_mobilenet.py.

MobileNet-v2 backbone + lightweight SSD heads emitting ``locations [N,
anchors, 4]`` and ``class logits [N, anchors, classes]`` — the tensor pair
the bounding_box decoder's mobilenet-ssd mode decodes with a box-priors
file. The heads' NCHW outputs are permuted to NHWC before the reshape to
(b, H*W*k, ...), so anchor order is row, column, anchor — the order of the
JAX model and of ``generate_anchors``' priors.

``generate_anchors``/``write_box_priors`` produce the matching priors
(ycenter, xcenter, h, w rows) so the whole detection path is
self-contained.
"""

from __future__ import annotations

import functools
import itertools
import math
from typing import Any, List, Tuple

import numpy as np
import torch
from torch import nn

from ..core.types import TensorsInfo
from .layers import conv2d_same
from .mobilenet_v2 import (DTYPES, ConvBNReLU, _make_divisible, build_seeded,
                           inverted_residual_stack, preprocess_uint8)
from .zoo import ModelBundle, register_model


class SSDMobileNetV2(nn.Module):
    """Backbone truncated at two strides + extra layers; one head per scale."""

    def __init__(self, num_classes: int = 91, width: float = 1.0,
                 anchors_per_cell: int = 6, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.num_classes = num_classes
        self.anchors_per_cell = k = anchors_per_cell
        w = width
        ch = _make_divisible(32 * w)
        self.stem = ConvBNReLU(3, ch, stride=2, dtype=dtype)
        head_blocks, c16 = inverted_residual_stack(
            ch, [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
                 (6, 96, 3, 1)], w, dtype)
        tail_blocks, c32 = inverted_residual_stack(
            c16, [(6, 160, 3, 2), (6, 320, 1, 1)], w, dtype)
        self.n_stride16 = len(head_blocks)
        self.blocks = nn.ModuleList(head_blocks + tail_blocks)
        c_extra = _make_divisible(256 * w)
        c64 = _make_divisible(512 * w)
        self.extra1 = ConvBNReLU(c32, c_extra, kernel=1, dtype=dtype)
        self.extra2 = ConvBNReLU(c_extra, c64, stride=2, dtype=dtype)
        feat_ch = (c16, c32, c64)
        self.loc_heads = nn.ModuleList(
            nn.Conv2d(c, k * 4, 3, padding=0, dtype=dtype) for c in feat_ch)
        self.cls_heads = nn.ModuleList(
            nn.Conv2d(c, k * num_classes, 3, padding=0, dtype=dtype)
            for c in feat_ch)

    def flax_children(self) -> List[Tuple[str, nn.Module]]:
        return ([("ConvBNReLU_0", self.stem)]
                + [(f"InvertedResidual_{i}", b)
                   for i, b in enumerate(self.blocks)]
                + [("ConvBNReLU_1", self.extra1), ("ConvBNReLU_2", self.extra2)]
                + [(f"loc_head_{i}", m) for i, m in enumerate(self.loc_heads)]
                + [(f"cls_head_{i}", m) for i, m in enumerate(self.cls_heads)])

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(b, H, W, 3) float NHWC → (locations (b, A, 4), logits (b, A,
        classes)), both float32."""
        x = self.stem(x.to(self.dtype).permute(0, 3, 1, 2))
        feats = []
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i + 1 == self.n_stride16:
                feats.append(x)  # stride 16
        feats.append(x)  # stride 32
        x = self.extra2(self.extra1(x))
        feats.append(x)  # stride 64

        locs, logits = [], []
        for f, loc_head, cls_head in zip(feats, self.loc_heads, self.cls_heads):
            b = f.shape[0]
            # NCHW head output → NHWC before the reshape: anchors are
            # ordered row, column, anchor as the priors are
            loc = conv2d_same(loc_head, f).permute(0, 2, 3, 1)
            cls = conv2d_same(cls_head, f).permute(0, 2, 3, 1)
            locs.append(loc.reshape(b, -1, 4))
            logits.append(cls.reshape(b, -1, self.num_classes))
        return (torch.cat(locs, dim=1).float(),
                torch.cat(logits, dim=1).float())


def feature_grid_sizes(size: int) -> List[int]:
    return [math.ceil(size / 16), math.ceil(size / 32), math.ceil(size / 64)]


def generate_anchors(size: int, anchors_per_cell: int = 6,
                     min_scale: float = 0.2, max_scale: float = 0.95) -> np.ndarray:
    """Anchor grid matching the model's head layout → rows
    [ycenter, xcenter, h, w] (normalized), shape (4, total_anchors)."""
    grids = feature_grid_sizes(size)
    n_layers = len(grids)
    scales = [min_scale + (max_scale - min_scale) * i / max(n_layers - 1, 1)
              for i in range(n_layers)] + [1.0]
    ratios = [1.0, 2.0, 0.5, 3.0, 1.0 / 3.0]
    out = []
    for li, g in enumerate(grids):
        s = scales[li]
        s_next = math.sqrt(s * scales[li + 1])
        cell_anchors: List[Tuple[float, float]] = []
        for r in ratios[:anchors_per_cell - 1]:
            cell_anchors.append((s / math.sqrt(r), s * math.sqrt(r)))
        cell_anchors.append((s_next, s_next))
        for y, x in itertools.product(range(g), repeat=2):
            cy, cx = (y + 0.5) / g, (x + 0.5) / g
            for h, w in cell_anchors[:anchors_per_cell]:
                out.append((cy, cx, h, w))
    return np.asarray(out, np.float32).T  # (4, N)


def write_box_priors(path: str, size: int = 300,
                     anchors_per_cell: int = 6) -> int:
    """Write a tensordec-boundingbox-compatible priors file; returns anchor
    count."""
    pri = generate_anchors(size, anchors_per_cell)
    with open(path, "w", encoding="utf-8") as f:
        for row in pri:
            f.write(" ".join(f"{v:.6f}" for v in row) + "\n")
    return pri.shape[1]


def _forward(module: nn.Module, x: torch.Tensor) -> Any:
    if x.dtype == torch.uint8:
        x = preprocess_uint8(x)
    return module(x)


def make_ssd_mobilenet_v2(device: torch.device, width: str = "1.0",
                          size: str = "300", num_classes: str = "91",
                          seed: str = "0", batch: str = "1",
                          dtype: str = "bfloat16", **_: Any) -> ModelBundle:
    w, hw, nc, b = float(width), int(size), int(num_classes), int(batch)
    model = build_seeded(SSDMobileNetV2, device, int(seed), num_classes=nc,
                         width=w, dtype=DTYPES[dtype])
    n_anchors = sum(g * g * 6 for g in feature_grid_sizes(hw))


    return ModelBundle(
        "ssd_mobilenet_v2", functools.partial(_forward, model), module=model,
        device=device, forward=_forward,
        in_info=TensorsInfo.from_strings(f"3:{hw}:{hw}:{b}", "uint8"),
        out_info=TensorsInfo.from_strings(
            f"4:{n_anchors}:{b},{nc}:{n_anchors}:{b}", "float32,float32"),
        preprocess=preprocess_uint8,
        metadata={"anchors": n_anchors, "size": hw, "classes": nc})


register_model("ssd_mobilenet_v2", make_ssd_mobilenet_v2)
