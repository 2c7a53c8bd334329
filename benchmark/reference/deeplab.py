"""Plain PyTorch DeepLab-v3 with a MobileNet-v2 body at output stride 16,
the reference for the DeepLab cells, built from the flax-layout variables
the benchmark draws (``{"params": ..., "batch_stats": ...}``, HWIO
kernels). It imports nothing of the program.

Architecture (the model zoo's ``deeplab_v3``): a stride-2 3×3 stem of 32,
MobileNet-v2's inverted residuals with the 160-channel stage at stride 1
(so the last map is 1/16 of the input, 17×17 at 257) and no dilation in
the body; ASPP of a 1×1 branch, 3×3 branches at rates 6, 12 and 18 (plain
ReLU, BatchNorm ε 1e-5), image pooling, a 1×1 projection of the five;
a 1×1 head with bias; a bilinear upsample with half-pixel centres to the
input size. Every convolution pads SAME (the lower pad total // 2), every
other BatchNorm has ε 1e-3 and ReLU6. Input: uint8 RGB, x / 127.5 − 1.
Departure from the published DeepLab-v3 (which dilates the last stages by
2): none here, as the served model has none.

``quant="fp8"`` is the control: each convolution's input and weight are
rounded to float8 e4m3 with a per-tensor scale, and the arithmetic is
bfloat16.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

#: (expansion, channels, repeats, stride) at output stride 16
SETTINGS = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 1), (6, 320, 1, 1))
RATES = (6, 12, 18)
FEATURES = 256


def _divisible(v: float, d: int = 8) -> int:
    n = max(d, int(v + d / 2) // d * d)
    return n + d if n < 0.9 * v else n


def layout(num_classes: int, width: float = 1.0) -> Tuple[Dict[str, Any], List[tuple]]:
    """The flax variables' shapes of the model, as nested dicts, and the
    list of (path, shape, kind) leaves in the order they are drawn; kind
    is "relu" or "linear" for a kernel, "head" for the head's kernel, or
    the BatchNorm/bias leaf name."""
    leaves: List[tuple] = []

    def conv(path, k, cin, cout, kind, groups=1):
        leaves.append((("params",) + path + ("kernel",), (k, k, cin // groups, cout), kind))

    def bn(path, c):
        for name in ("scale", "bias"):
            leaves.append((("params",) + path + (name,), (c,), name))
        for name in ("mean", "var"):
            leaves.append((("batch_stats",) + path + (name,), (c,), name))

    def cbr(path, k, cin, cout, groups=1):
        conv(path + ("Conv_0",), k, cin, cout, "relu", groups)
        bn(path + ("BatchNorm_0",), cout)

    ch = _divisible(32 * width)
    cbr(("ConvBNReLU_0",), 3, 3, ch)
    b = 0
    for t, c, n, s in SETTINGS:
        out = _divisible(c * width)
        for _ in range(n):
            p = (f"InvertedResidual_{b}",)
            hidden, j = ch * t, 0
            if t != 1:
                cbr(p + ("ConvBNReLU_0",), 1, ch, hidden)
                j = 1
            cbr(p + (f"ConvBNReLU_{j}",), 3, hidden, hidden, groups=hidden)
            conv(p + ("Conv_0",), 1, hidden, out, "linear")
            bn(p + ("BatchNorm_0",), out)
            ch, b = out, b + 1
    a = ("ASPP_0",)
    cbr(a + ("ConvBNReLU_0",), 1, ch, FEATURES)
    for i in range(len(RATES)):
        conv(a + (f"Conv_{i}",), 3, ch, FEATURES, "relu")
    for i in range(len(RATES)):
        bn(a + (f"BatchNorm_{i}",), FEATURES)
    cbr(a + ("ConvBNReLU_1",), 1, ch, FEATURES)
    cbr(a + ("ConvBNReLU_2",), 1, FEATURES * (len(RATES) + 2), FEATURES)
    conv(("Conv_0",), 1, FEATURES, num_classes, "head")
    leaves.append((("params", "Conv_0", "bias"), (num_classes,), "bias"))
    tree: Dict[str, Any] = {}
    for path, shape, _ in leaves:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = shape
    return tree, leaves


def draw(leaves: List[tuple], seed: int, device) -> Dict[str, Any]:
    """The variables from one normal draw of a ``torch.Generator`` seeded
    with ``seed`` on ``device``: He-normal kernels before a ReLU, LeCun
    after none, BatchNorm scale 1 + 0.1·z, bias and mean 0.05·z, variance
    exp(0.2·z), biases 0.05·z. Nested dicts of float32 numpy arrays."""
    total = sum(int(np.prod(s)) for _, s, _ in leaves)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32).cpu().numpy()
    tree: Dict[str, Any] = {}
    at = 0
    for path, shape, kind in leaves:
        n = int(np.prod(shape))
        z = flat[at:at + n].reshape(shape).astype(np.float64)
        at += n
        if kind in ("relu", "linear", "head"):
            fan_in = int(np.prod(shape[:-1]))
            v = z * np.sqrt((2.0 if kind == "relu" else 1.0) / fan_in)
        elif kind == "scale":
            v = 1.0 + 0.1 * z
        elif kind == "var":
            v = np.exp(0.2 * z)
        else:
            v = 0.05 * z
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v.astype(np.float32)
    return tree


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().float().clamp(min=1e-12) / 448.0
    return ((t.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(t.dtype)


class DeepLabForward:
    """The model on ``device``: ``dtype`` float32 for the reference (with
    TF32 off, set by the caller), or ``quant="fp8"`` for the control."""

    def __init__(self, variables: Dict[str, Any], device, dtype=torch.float32,
                 quant: str = "") -> None:
        self.dtype = dtype if not quant else torch.bfloat16
        self.quant = quant
        self.p = self._tensors(variables["params"], device)
        self.s = self._tensors(variables["batch_stats"], device)

    def _tensors(self, node, device):
        if isinstance(node, dict):
            return {k: self._tensors(v, device) for k, v in node.items()}
        return torch.from_numpy(np.asarray(node, np.float32)).to(device)

    def _conv(self, x, kernel, stride=1, dilation=1, groups=1, bias=None):
        w = kernel.permute(3, 2, 0, 1).to(self.dtype)  # HWIO → OIHW
        if self.quant:
            x, w = _fp8(x), _fp8(w)
        k = w.shape[-1]
        pads = []
        for size in (x.shape[3], x.shape[2]):
            out = -(-size // stride)
            total = max((out - 1) * stride + (k - 1) * dilation + 1 - size, 0)
            pads += [total // 2, total - total // 2]
        x = F.pad(x, pads)
        b = None if bias is None else bias.to(self.dtype)
        return F.conv2d(x, w, b, stride, 0, dilation, groups)

    def _bn(self, x, p, s, eps, act):
        y = (x.float() - s["mean"].view(1, -1, 1, 1)) * torch.rsqrt(
            s["var"].view(1, -1, 1, 1) + eps) * p["scale"].view(1, -1, 1, 1) \
            + p["bias"].view(1, -1, 1, 1)
        y = y.clamp(0.0, 6.0) if act == "relu6" else torch.relu(y) if act == "relu" else y
        return y.to(self.dtype)

    def _cbr(self, x, p, s, stride=1, groups=1):
        y = self._conv(x, p["Conv_0"]["kernel"], stride, groups=groups)
        return self._bn(y, p["BatchNorm_0"], s["BatchNorm_0"], 1e-3, "relu6")

    @torch.inference_mode()
    def features(self, frames: torch.Tensor) -> torch.Tensor:
        """(b, H, W, 3) uint8 → the head's input (b, 256, h, w)."""
        x = (frames.float() / 127.5 - 1.0).permute(0, 3, 1, 2).to(self.dtype)
        p, s = self.p, self.s
        x = self._cbr(x, p["ConvBNReLU_0"], s["ConvBNReLU_0"], 2)
        b = 0
        for t, _, n, stride in SETTINGS:
            for i in range(n):
                bp, bs = p[f"InvertedResidual_{b}"], s[f"InvertedResidual_{b}"]
                y, j = x, 0
                if t != 1:
                    y = self._cbr(y, bp["ConvBNReLU_0"], bs["ConvBNReLU_0"])
                    j = 1
                y = self._cbr(y, bp[f"ConvBNReLU_{j}"], bs[f"ConvBNReLU_{j}"],
                              stride if i == 0 else 1, groups=y.shape[1])
                y = self._conv(y, bp["Conv_0"]["kernel"])
                y = self._bn(y, bp["BatchNorm_0"], bs["BatchNorm_0"], 1e-3, "")
                x = x + y if (i > 0 and y.shape == x.shape) else y
                b += 1
        ap, aps = p["ASPP_0"], s["ASPP_0"]
        branches = [self._cbr(x, ap["ConvBNReLU_0"], aps["ConvBNReLU_0"])]
        for i, r in enumerate(RATES):
            y = self._conv(x, ap[f"Conv_{i}"]["kernel"], dilation=r)
            branches.append(self._bn(y, ap[f"BatchNorm_{i}"], aps[f"BatchNorm_{i}"], 1e-5, "relu"))
        g = x.float().mean(dim=(2, 3), keepdim=True).to(self.dtype)
        g = self._cbr(g, ap["ConvBNReLU_1"], aps["ConvBNReLU_1"])
        branches.append(g.expand_as(branches[0]))
        return self._cbr(torch.cat(branches, dim=1), ap["ConvBNReLU_2"], aps["ConvBNReLU_2"])

    @torch.inference_mode()
    def __call__(self, frames: torch.Tensor) -> torch.Tensor:
        """(b, H, W, 3) uint8 → (b, H, W, classes) float32 logits."""
        size = tuple(frames.shape[1:3])
        h = self.p["Conv_0"]
        y = self._conv(self.features(frames), h["kernel"], bias=h["bias"]).float()
        y = F.interpolate(y, size=size, mode="bilinear", align_corners=False)
        return y.permute(0, 2, 3, 1)


def center_head(variables: Dict[str, Any], frames: torch.Tensor, device) -> None:
    """Give each class logit mean 0 and all of them standard deviation 1
    over the calibration ``frames`` (float32 reference), as the SSD heads
    are centred: otherwise the positive mean of ReLU features makes one
    class win every pixel."""
    fwd = DeepLabForward(variables, device)
    feats = fwd.features(frames)
    head = variables["params"]["Conv_0"]
    k = torch.from_numpy(head["kernel"]).to(device)
    y = torch.einsum("bchw,co->bohw", feats, k[0, 0]).double()
    mean = y.mean(dim=(0, 2, 3)).cpu().numpy()
    std = float((y - y.mean(dim=(0, 2, 3), keepdim=True)).std())
    head["bias"] = ((-mean) / std).astype(np.float32)
    head["kernel"] = (head["kernel"] / std).astype(np.float32)


def palette() -> np.ndarray:
    """The image_segment decoder's RGBA colours (256, 4): the PASCAL VOC
    colour map, alpha 160, class 0 transparent black."""
    pal = np.zeros((256, 4), np.uint8)
    for i in range(1, 256):
        r = g = b = 0
        cid = i
        for shift in range(7, -1, -1):
            r |= ((cid >> 0) & 1) << shift
            g |= ((cid >> 1) & 1) << shift
            b |= ((cid >> 2) & 1) << shift
            cid >>= 3
            if not cid:
                break
        pal[i] = (r, g, b, 160)
    return pal


def judge_frame(canvas: np.ndarray, logits: np.ndarray, pal_index: Dict[int, int]) -> dict:
    """The widest gap by which the logit of a served pixel's class lies
    below the reference's best there, and the pixels whose colour is no
    class's."""
    h, w = logits.shape[:2]
    packed = np.ascontiguousarray(canvas.reshape(h, w, 4)).view(np.uint32).reshape(-1)
    lut = np.full(packed.shape, -1, np.int64)
    for code, cls in pal_index.items():
        lut[packed == code] = cls
    bad = int((lut < 0).sum()) + int((lut >= logits.shape[2]).sum())
    flat = logits.reshape(-1, logits.shape[2]).astype(np.float64)
    cls = np.clip(lut, 0, logits.shape[2] - 1)
    gap = flat.max(axis=1) - flat[np.arange(len(cls)), cls]
    return {"logit_gap": float(gap.max()), "bad_px": bad}


def palette_index(num_classes: int) -> Dict[int, int]:
    pal = palette()[:num_classes]
    return {int(np.ascontiguousarray(pal[c]).view(np.uint32)[0]): c for c in range(num_classes)}
