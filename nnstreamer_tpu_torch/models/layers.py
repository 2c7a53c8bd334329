"""Layers shared by the zoo models, written to compute what flax computes.

* ``same_padding``/``conv2d_same`` — flax ``padding="SAME"``: the total pad
  ``max((out - 1) * stride + k_eff - size, 0)`` with ``out = ceil(size /
  stride)`` and the dilated kernel's extent ``k_eff = (kernel - 1) *
  dilation + 1`` splits as low = total // 2, high = total - low. With
  stride 2 it is asymmetric whenever the size is even (300 → 150 pads (0,
  1)), which torch's symmetric ``padding=`` cannot express: that case goes
  through ``F.pad``. A rate-18 3×3 convolution (DeepLab's ASPP) pads 18 on
  each side of a 17×17 map.
* ``BatchNorm`` — inference-mode batch norm in flax's order and precision:
  ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32 with float32
  statistics, cast back to the activation dtype; eps is the model's 1e-3.
* ``LayerNorm`` — flax ``nn.LayerNorm`` over the last axis: float32
  statistics with its fast variance ``max(E[x²] − E[x]², 0)``, then
  ``(x − μ) · (rsqrt(var + ε) · scale) + bias`` in float32, cast to the
  module's dtype; ε 1e-6.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


def same_padding(size: int, kernel: int, stride: int,
                 dilation: int = 1) -> Tuple[int, int]:
    out = -(-size // stride)
    extent = (kernel - 1) * dilation + 1
    total = max((out - 1) * stride + extent - size, 0)
    return total // 2, total - total // 2


def conv2d_same(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` (built with padding=0, any dilation) applied with flax SAME
    padding to NCHW ``x``."""
    (kh, kw), (sh, sw), (dh, dw) = conv.kernel_size, conv.stride, conv.dilation
    ph = same_padding(x.shape[2], kh, sh, dh)
    pw = same_padding(x.shape[3], kw, sw, dw)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, conv.weight, conv.bias, conv.stride,
                        (ph[0], pw[0]), conv.dilation, conv.groups)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, conv.weight, conv.bias, conv.stride, 0, conv.dilation,
                    conv.groups)


class BatchNorm(nn.Module):
    """Inference batch norm over the channel axis of NCHW input (flax
    ``BatchNorm(use_running_average=True)``)."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - self.running_mean.view(shape)) * mul.view(shape)
        return (y + self.bias.view(shape)).to(x.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=dtype)`` over the last axis (float32
    ``weight``/``bias``, flax's ``scale``/``bias``)."""

    def __init__(self, features: int, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * mul + self.bias).to(self.dtype)
