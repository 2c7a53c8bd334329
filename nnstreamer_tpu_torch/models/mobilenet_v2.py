"""MobileNet-v2 in torch — the streaming-classification model.

Port of nnstreamer_tpu/models/mobilenet_v2.py. The public functions keep
the JAX package's layout: input is NHWC (uint8 frames or float in
[-1, 1]); inside, the convolutions run NCHW on cuDNN in the model's dtype
(bf16 by default). Output is 1001-way float32 logits (background class +
1000 ImageNet classes), the tflite convention the image_labeling decoder
expects.
"""

from __future__ import annotations

import functools
from typing import Any, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..core.types import TensorsInfo
from .convert import flax_shapes, from_flax_variables, restore_flax
from .layers import BatchNorm, conv2d_same
from .zoo import ModelBundle, register_model, synthesize_variables

# (expansion t, out channels c, repeats n, stride s) — MobileNet-v2 paper table 2
_INVERTED_RESIDUAL_SETTINGS: Sequence[Tuple[int, int, int, int]] = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def relu6(x: torch.Tensor) -> torch.Tensor:
    """min(max(x, 0), 6), the JAX model's ``jnp.minimum(jnp.maximum(x, 0.0),
    6.0)``. Under autograd it takes torch.maximum/minimum, whose gradient
    at a tie is half the incoming one on each side, as JAX's is (a clamp
    passes all of it, and activations sit exactly on 0 wherever a layer's
    input is all zeros); otherwise one clamp, the same values, which serves
    a MobileNet-v2, SSD-300 or DeepLab-257 frame 0.21–0.31 ms sooner of
    1.1–1.7 ms (scripts/relu6_ab.py; NVIDIA H100 80GB HBM3, 700.00 W)."""
    if not torch.is_grad_enabled():
        return x.clamp(0.0, 6.0)
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_full((), 6.0))


class ConvBNReLU(nn.Module):
    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride: int = 1, groups: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, features, kernel, stride, padding=0,
                              groups=groups, bias=False, dtype=dtype)
        self.bn = BatchNorm(features)

    def flax_children(self) -> List[Tuple[str, nn.Module]]:
        return [("Conv_0", self.conv), ("BatchNorm_0", self.bn)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return relu6(self.bn(conv2d_same(self.conv, x)))


class InvertedResidual(nn.Module):
    def __init__(self, in_ch: int, features: int, stride: int,
                 expand_ratio: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        hidden = in_ch * expand_ratio
        self.use_res = stride == 1 and in_ch == features
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNReLU(in_ch, hidden, kernel=1, dtype=dtype))
        # depthwise
        layers.append(ConvBNReLU(hidden, hidden, kernel=3, stride=stride,
                                 groups=hidden, dtype=dtype))
        self.layers = nn.ModuleList(layers)
        # linear projection
        self.project = nn.Conv2d(hidden, features, 1, bias=False, dtype=dtype)
        self.bn = BatchNorm(features)

    def flax_children(self) -> List[Tuple[str, nn.Module]]:
        return ([(f"ConvBNReLU_{i}", m) for i, m in enumerate(self.layers)]
                + [("Conv_0", self.project), ("BatchNorm_0", self.bn)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for layer in self.layers:
            y = layer(y)
        y = self.bn(self.project(y))
        return x + y if self.use_res else y


def inverted_residual_stack(in_ch: int, settings, width: float,
                            dtype: torch.dtype) -> Tuple[List[nn.Module], int]:
    """The blocks of ``settings`` rows (t, c, n, s); returns them and the
    output channel count."""
    blocks: List[nn.Module] = []
    for t, c, n, s in settings:
        out_ch = _make_divisible(c * width)
        for i in range(n):
            blocks.append(InvertedResidual(in_ch, out_ch, s if i == 0 else 1,
                                           t, dtype=dtype))
            in_ch = out_ch
    return blocks, in_ch


class MobileNetV2(nn.Module):
    def __init__(self, num_classes: int = 1001, width: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        ch = _make_divisible(32 * width)
        self.stem = ConvBNReLU(3, ch, stride=2, dtype=dtype)
        blocks, ch = inverted_residual_stack(
            ch, _INVERTED_RESIDUAL_SETTINGS, width, dtype)
        self.blocks = nn.ModuleList(blocks)
        last = _make_divisible(1280 * max(1.0, width))
        self.last = ConvBNReLU(ch, last, kernel=1, dtype=dtype)
        self.classifier = nn.Linear(last, num_classes, dtype=dtype)

    def flax_children(self) -> List[Tuple[str, nn.Module]]:
        return ([("ConvBNReLU_0", self.stem)]
                + [(f"InvertedResidual_{i}", b)
                   for i, b in enumerate(self.blocks)]
                + [("ConvBNReLU_1", self.last), ("Dense_0", self.classifier)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(b, H, W, 3) float NHWC → (b, num_classes) float32 logits."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = self.stem(x)
        for block in self.blocks:
            x = block(x)
        x = self.last(x)
        x = x.mean(dim=(2, 3))  # global average pool
        return self.classifier(x).float()


def preprocess_uint8(x: torch.Tensor) -> torch.Tensor:
    """uint8 RGB [0,255] → float [-1,1] (tflite mobilenet convention):
    x / 127.5 - 1 in float32. The divisor is a tensor on x's device:
    PyTorch's CUDA division by a Python scalar multiplies by its float32
    reciprocal, which differs from the division on 126 of the 256 values."""
    xf = x.to(torch.float32)
    return xf / torch.full((), 127.5, device=x.device) - 1.0


def build_seeded(model_cls: Any, device: torch.device, seed: int,
                 checkpoint: Optional[str] = None, **kwargs: Any) -> nn.Module:
    """``model_cls(**kwargs)`` on ``device`` with the weights of the flax
    ``.msgpack`` ``checkpoint`` (convert.restore_flax), or without one with
    placeholder weights synthesized from ``seed`` in the flax layout
    (zoo.synthesize_variables), both loaded through the converter."""
    with torch.device("meta"):
        model = model_cls(**kwargs)
    model = model.to_empty(device=device)
    if checkpoint:
        restore_flax(model, checkpoint)
    else:
        from_flax_variables(synthesize_variables(flax_shapes(model), seed),
                            model)
    return model.eval()


def make_mobilenet_bundle(name: str, model_cls: Any, device: torch.device,
                          width: str = "1.0", size: str = "224",
                          num_classes: str = "1001",
                          checkpoint: Optional[str] = None,
                          dtype: str = "bfloat16", seed: str = "0",
                          batch: str = "1", **_: Any) -> ModelBundle:
    """Classifier-bundle factory: uint8 preprocessing dispatch, seeded or
    checkpointed weights and I/O metadata."""
    w, hw, nc, b = float(width), int(size), int(num_classes), int(batch)
    model = build_seeded(model_cls, device, int(seed), checkpoint,
                         num_classes=nc, width=w, dtype=DTYPES[dtype])

    def forward(module, x):
        if x.dtype == torch.uint8:
            x = preprocess_uint8(x)
        return module(x)

    in_info = TensorsInfo.from_strings(f"3:{hw}:{hw}:{b}", "uint8")
    out_info = TensorsInfo.from_strings(f"{nc}:{b}", "float32")
    return ModelBundle(name, functools.partial(forward, model), module=model,
                       device=device, in_info=in_info, out_info=out_info,
                       preprocess=preprocess_uint8,
                       metadata={"width": w, "size": hw, "classes": nc},
                       forward=forward)


def make_mobilenet_v2(device: torch.device, **options: Any) -> ModelBundle:
    return make_mobilenet_bundle("mobilenet_v2", MobileNetV2, device, **options)


register_model("mobilenet_v2", make_mobilenet_v2)
