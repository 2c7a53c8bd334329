"""PoseNet keypoint estimation in torch — port of nnstreamer_tpu/models/posenet.py.

Stand-in for the reference's posenet tflite pipeline (tensordec-pose.c
heatmap-offset mode): MobileNet-v2 backbone up to the 96-channel stage
(stride 16) → heatmaps [K:W':H':1] + offsets [2K:W':H':1], the tensor pair
the pose decoder consumes; both float32, NHWC, on the 17×17 grid for 257
input.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import torch
from torch import nn

from ..core.types import TensorsInfo
from .mobilenet_v2 import (DTYPES, ConvBNReLU, _make_divisible, build_seeded,
                           inverted_residual_stack, preprocess_uint8)
from .zoo import ModelBundle, register_model

_STRIDE16_SETTINGS = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2),
                      (6, 64, 4, 2), (6, 96, 3, 1))


class PoseNet(nn.Module):
    def __init__(self, num_keypoints: int = 17, width: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        ch = _make_divisible(32 * width)
        self.stem = ConvBNReLU(3, ch, stride=2, dtype=dtype)
        blocks, ch = inverted_residual_stack(ch, _STRIDE16_SETTINGS, width,
                                             dtype)
        self.blocks = nn.ModuleList(blocks)
        self.heatmap_head = nn.Conv2d(ch, num_keypoints, 1, dtype=dtype)
        self.offset_head = nn.Conv2d(ch, 2 * num_keypoints, 1, dtype=dtype)

    def flax_children(self) -> List[Tuple[str, nn.Module]]:
        return ([("ConvBNReLU_0", self.stem)]
                + [(f"InvertedResidual_{i}", b)
                   for i, b in enumerate(self.blocks)]
                + [("heatmap_head", self.heatmap_head),
                   ("offset_head", self.offset_head)])

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(b, H, W, 3) float NHWC → (heatmaps (b, H', W', K), offsets (b,
        H', W', 2K)), float32, contiguous NHWC."""
        x = self.stem(x.to(self.dtype).permute(0, 3, 1, 2))
        for block in self.blocks:
            x = block(x)
        return tuple(head(x).float().permute(0, 2, 3, 1).contiguous()
                     for head in (self.heatmap_head, self.offset_head))


def make_posenet(device: torch.device, width: str = "1.0", size: str = "257",
                 num_keypoints: str = "17", seed: str = "0", batch: str = "1",
                 dtype: str = "bfloat16", **_: Any) -> ModelBundle:
    w, hw, k, b = float(width), int(size), int(num_keypoints), int(batch)
    model = build_seeded(PoseNet, device, int(seed), num_keypoints=k, width=w,
                         dtype=DTYPES[dtype])
    out_hw = -(-hw // 16)  # stride-16 feature grid

    def apply(x):
        if x.dtype == torch.uint8:
            x = preprocess_uint8(x)
        return model(x)

    return ModelBundle(
        "posenet", apply, module=model, device=device,
        in_info=TensorsInfo.from_strings(f"3:{hw}:{hw}:{b}", "uint8"),
        out_info=TensorsInfo.from_strings(
            f"{k}:{out_hw}:{out_hw}:{b},{2 * k}:{out_hw}:{out_hw}:{b}",
            "float32,float32"),
        preprocess=preprocess_uint8,
        metadata={"keypoints": k, "size": hw, "grid": out_hw})


register_model("posenet", make_posenet)
