"""MobileNet-v1 in torch — port of nnstreamer_tpu/models/mobilenet_v1.py.

The reference's flagship test model (mobilenet_v1_1.0_224_quant.tflite):
a stem convolution then 13 depthwise-separable blocks (Howard et al. 2017,
table 1), NHWC in and NCHW inside as MobileNet-v2, 1001-way float32 logits.
Reuses MobileNet-v2's ConvBNReLU, uint8 preprocessing and bundle factory.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import torch
from torch import nn

from .mobilenet_v2 import ConvBNReLU, _make_divisible, make_mobilenet_bundle
from .zoo import ModelBundle, register_model

#: (out channels, stride) per depthwise-separable block — v1 paper table 1
_BLOCKS: Sequence[Tuple[int, int]] = (
    (64, 1),
    (128, 2), (128, 1),
    (256, 2), (256, 1),
    (512, 2), (512, 1), (512, 1), (512, 1), (512, 1), (512, 1),
    (1024, 2), (1024, 1),
)


class DepthwiseSeparable(nn.Module):
    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.depthwise = ConvBNReLU(in_ch, in_ch, kernel=3, stride=stride,
                                    groups=in_ch, dtype=dtype)
        self.pointwise = ConvBNReLU(in_ch, features, kernel=1, dtype=dtype)

    def flax_children(self) -> List[Tuple[str, nn.Module]]:
        return [("ConvBNReLU_0", self.depthwise),
                ("ConvBNReLU_1", self.pointwise)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.depthwise(x))


class MobileNetV1(nn.Module):
    def __init__(self, num_classes: int = 1001, width: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        ch = _make_divisible(32 * width)
        self.stem = ConvBNReLU(3, ch, stride=2, dtype=dtype)
        blocks = []
        for c, s in _BLOCKS:
            out = _make_divisible(c * width)
            blocks.append(DepthwiseSeparable(ch, out, stride=s, dtype=dtype))
            ch = out
        self.blocks = nn.ModuleList(blocks)
        self.classifier = nn.Linear(ch, num_classes, dtype=dtype)

    def flax_children(self) -> List[Tuple[str, nn.Module]]:
        return ([("ConvBNReLU_0", self.stem)]
                + [(f"DepthwiseSeparable_{i}", b)
                   for i, b in enumerate(self.blocks)]
                + [("Dense_0", self.classifier)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(b, H, W, 3) float NHWC → (b, num_classes) float32 logits."""
        x = self.stem(x.to(self.dtype).permute(0, 3, 1, 2))
        for block in self.blocks:
            x = block(x)
        return self.classifier(x.mean(dim=(2, 3))).float()


def make_mobilenet_v1(device: torch.device, **options: Any) -> ModelBundle:
    return make_mobilenet_bundle("mobilenet_v1", MobileNetV1, device, **options)


register_model("mobilenet_v1", make_mobilenet_v1)
