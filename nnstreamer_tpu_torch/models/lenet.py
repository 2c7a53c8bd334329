"""LeNet-5 style MNIST CNN — port of nnstreamer_tpu/models/lenet.py.

The reference's test-model-set entry (tests/test_models/models/mnist.pb):
a tiny classic CNN registered as ``zoo://lenet``, with ``zoo://mnist`` as
an alias resolving to the same memoized bundle.

Input: GRAY8 or float [1:W:H:1] (NHWC, default 28×28; uint8 is scaled to
[0, 1]); output: [num_classes:1] float32 logits. The convolutions run NCHW;
the flatten before the first dense takes NHWC order, as flax's does, so the
converted dense kernel applies unchanged.
"""

from __future__ import annotations

import functools
from typing import Any, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.types import TensorsInfo
from .layers import conv2d_same
from .mobilenet_v2 import DTYPES, build_seeded
from .zoo import ModelBundle, register_alias, register_model


class LeNet5(nn.Module):
    def __init__(self, num_classes: int = 10, size: int = 28,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv0 = nn.Conv2d(1, 6, 5, dtype=dtype)          # SAME
        self.conv1 = nn.Conv2d(6, 16, 5, dtype=dtype)         # VALID
        side = (size // 2 - 4) // 2
        self.fc0 = nn.Linear(16 * side * side, 120, dtype=dtype)
        self.fc1 = nn.Linear(120, 84, dtype=dtype)
        self.fc2 = nn.Linear(84, num_classes)                 # float32

    def flax_children(self) -> List[Tuple[str, nn.Module]]:
        return [("Conv_0", self.conv0), ("Conv_1", self.conv1),
                ("Dense_0", self.fc0), ("Dense_1", self.fc1),
                ("Dense_2", self.fc2)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(b, H, W, 1) float NHWC → (b, num_classes) float32 logits."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = F.avg_pool2d(torch.tanh(conv2d_same(self.conv0, x)), 2, 2)
        x = F.avg_pool2d(torch.tanh(self.conv1(x)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)    # flax's order
        x = torch.tanh(self.fc0(x))
        x = torch.tanh(self.fc1(x))
        return self.fc2(x.float())


def _scale_u8(x: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] → float32 [0, 1]; the divisor a tensor on x's device
    (the card turns a division by a Python scalar into a reciprocal
    multiply)."""
    return x.to(torch.float32) / torch.full((), 255.0, device=x.device)


def _forward(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.uint8:
        x = _scale_u8(x)
    if x.dim() == 3:  # (H, W, C) single frame
        x = x[None]
    return module(x)


def make_lenet(device: torch.device, size: str = "28", num_classes: str = "10",
               batch: str = "1", seed: str = "0", dtype: str = "float32",
               checkpoint: Optional[str] = None, **_: Any) -> ModelBundle:
    if checkpoint:
        raise ValueError("checkpoint restore is not ported to the torch "
                         "zoo yet (load weights with models.convert)")
    hw, nc, b = int(size), int(num_classes), int(batch)
    model = build_seeded(LeNet5, device, int(seed), num_classes=nc, size=hw,
                         dtype=DTYPES[dtype])
    return ModelBundle(
        "lenet", functools.partial(_forward, model), module=model,
        device=device,
        in_info=TensorsInfo.from_strings(f"1:{hw}:{hw}:{b}", "uint8"),
        out_info=TensorsInfo.from_strings(f"{nc}:{b}", "float32"),
        preprocess=_scale_u8, forward=_forward)


register_model("lenet", make_lenet)
# the reference test-model name; resolves to the same canonical bundle
# (one memo entry, one set of weights)
register_alias("mnist", "lenet")
