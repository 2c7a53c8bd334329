"""DeepLab-v3 semantic segmentation in torch — port of
nnstreamer_tpu/models/deeplab.py.

Stand-in for the reference's deeplabv3_257 tflite (image_segment decoder
scheme tflite-deeplab): MobileNet-v2 backbone at output stride 16 + ASPP
(atrous pyramid) + a 1×1 class head + a float32 bilinear upsample to the
input size → per-pixel class logits, NHWC (b, H, W, classes) = dims
[classes:W:H:b], exactly what tensordec-imagesegment.c argmaxes.

Names follow flax's auto-names (``flax_children``) so a JAX bundle's
variables load unchanged. The ASPP's own BatchNorms are flax's default
``nn.BatchNorm`` (ε = 1e-5, not the backbone's 1e-3).
"""

from __future__ import annotations

from typing import Any, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.types import TensorsInfo
from .layers import BatchNorm, conv2d_same
from .mobilenet_v2 import (DTYPES, ConvBNReLU, _make_divisible, build_seeded,
                           inverted_residual_stack, preprocess_uint8)
from .zoo import ModelBundle, register_model

#: MobileNet-v2 rows at output stride 16: the 160-channel stage keeps
#: stride 1 instead of 2
_OS16_SETTINGS = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
                  (6, 96, 3, 1), (6, 160, 3, 1), (6, 320, 1, 1))


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling: a 1×1 branch, one dilated 3×3 branch
    per rate (its own BatchNorm, plain ReLU), an image-pooling branch, a
    channel concat in that order and a 1×1 projection."""

    def __init__(self, in_ch: int, features: int = 256,
                 rates: Tuple[int, ...] = (6, 12, 18),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.branch = ConvBNReLU(in_ch, features, kernel=1, dtype=dtype)
        self.atrous = nn.ModuleList(
            nn.Conv2d(in_ch, features, 3, padding=0, dilation=r, bias=False,
                      dtype=dtype) for r in rates)
        self.atrous_bn = nn.ModuleList(BatchNorm(features, eps=1e-5)
                                       for _ in rates)
        self.pool = ConvBNReLU(in_ch, features, kernel=1, dtype=dtype)
        self.project = ConvBNReLU(features * (len(rates) + 2), features,
                                  kernel=1, dtype=dtype)

    def flax_children(self) -> List[Tuple[str, nn.Module]]:
        return ([("ConvBNReLU_0", self.branch)]
                + [(f"Conv_{i}", m) for i, m in enumerate(self.atrous)]
                + [(f"BatchNorm_{i}", m) for i, m in enumerate(self.atrous_bn)]
                + [("ConvBNReLU_1", self.pool), ("ConvBNReLU_2", self.project)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [self.branch(x)]
        for conv, bn in zip(self.atrous, self.atrous_bn):
            branches.append(torch.relu(bn(conv2d_same(conv, x))))
        # image-level pooling: the mean accumulates in float32, as jnp.mean
        # does for bf16, then returns to the activation dtype
        g = x.float().mean(dim=(2, 3), keepdim=True).to(x.dtype)
        branches.append(self.pool(g).expand_as(branches[0]))
        return self.project(torch.cat(branches, dim=1))


class DeepLabV3(nn.Module):
    def __init__(self, num_classes: int = 21, width: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        ch = _make_divisible(32 * width)
        self.stem = ConvBNReLU(3, ch, stride=2, dtype=dtype)
        blocks, ch = inverted_residual_stack(ch, _OS16_SETTINGS, width, dtype)
        self.blocks = nn.ModuleList(blocks)
        self.aspp = ASPP(ch, dtype=dtype)
        self.head = nn.Conv2d(256, num_classes, 1, dtype=dtype)

    def flax_children(self) -> List[Tuple[str, nn.Module]]:
        return ([("ConvBNReLU_0", self.stem)]
                + [(f"InvertedResidual_{i}", b)
                   for i, b in enumerate(self.blocks)]
                + [("ASPP_0", self.aspp), ("Conv_0", self.head)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(b, H, W, 3) float NHWC → (b, H, W, classes) float32 logits,
        contiguous."""
        size = tuple(x.shape[1:3])
        x = self.stem(x.to(self.dtype).permute(0, 3, 1, 2))
        for block in self.blocks:
            x = block(x)
        x = self.head(self.aspp(x))
        # jax.image.resize(..., "bilinear") upsampling: half-pixel centers,
        # no antialiasing, in float32 after the cast. Channels-last memory
        # makes the NHWC view below contiguous without a copy.
        x = x.float().contiguous(memory_format=torch.channels_last)
        x = F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                          antialias=False)
        return x.permute(0, 2, 3, 1)


def make_deeplab_v3(device: torch.device, width: str = "1.0",
                    size: str = "257", num_classes: str = "21",
                    seed: str = "0", batch: str = "1",
                    dtype: str = "bfloat16", **_: Any) -> ModelBundle:
    w, hw, nc, b = float(width), int(size), int(num_classes), int(batch)
    model = build_seeded(DeepLabV3, device, int(seed), num_classes=nc,
                         width=w, dtype=DTYPES[dtype])

    def apply(x):
        if x.dtype == torch.uint8:
            x = preprocess_uint8(x)
        return model(x)

    return ModelBundle(
        "deeplab_v3", apply, module=model, device=device,
        in_info=TensorsInfo.from_strings(f"3:{hw}:{hw}:{b}", "uint8"),
        out_info=TensorsInfo.from_strings(f"{nc}:{hw}:{hw}:{b}", "float32"),
        preprocess=preprocess_uint8,
        metadata={"size": hw, "classes": nc})


register_model("deeplab_v3", make_deeplab_v3)
