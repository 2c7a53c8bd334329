"""Plain PyTorch forward of the benchmark's own TFLite op list (the graph
``harness/tflite_writer.py`` builds and writes): NHWC tensors, SAME
padding with the extra row and column at the end as TFLite pads,
convolutions and depthwise convolutions with their fused ReLU6, ADD,
RESHAPE, CONCAT and LOGISTIC. No kernel, cache or batching of the program;
it imports nothing of the program. ``dtype`` is the arithmetic: float32
(with TF32 off, set by the caller) for the reference, bfloat16 for the
control.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

CONV, DWCONV, ADD, CONCAT, LOGISTIC, RESHAPE = 3, 4, 0, 2, 14, 22
RELU6 = 3


def same_pads(size: int, k: int, stride: int) -> tuple:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class TFLiteForward:
    """The op list of ``net`` on ``device`` in ``dtype``; ``outputs`` are
    the tensor indices to return (NHWC, float32)."""

    def __init__(self, net, device, dtype: torch.dtype) -> None:
        self.ops = net.operators
        self.shapes = [t["shape"] for t in net.tensors]
        self.input = net.inputs[0]
        self.dtype = dtype
        self.w: Dict[int, torch.Tensor] = {}
        for op in self.ops:
            if op["code"] == CONV:
                wt, b = op["inputs"][1], op["inputs"][2]
                self.w[wt] = torch.from_numpy(net.tensors[wt]["data"]).to(
                    device, dtype).permute(0, 3, 1, 2).contiguous()
                self.w[b] = torch.from_numpy(net.tensors[b]["data"]).to(device, dtype)
            elif op["code"] == DWCONV:
                wt, b = op["inputs"][1], op["inputs"][2]
                self.w[wt] = torch.from_numpy(net.tensors[wt]["data"]).to(
                    device, dtype).permute(3, 0, 1, 2).contiguous()
                self.w[b] = torch.from_numpy(net.tensors[b]["data"]).to(device, dtype)

    def _conv(self, op, x: torch.Tensor, groups: bool) -> torch.Tensor:
        # x NCHW
        w, b = self.w[op["inputs"][1]], self.w[op["inputs"][2]]
        k, s = w.shape[-1], op["stride"]
        ph = same_pads(x.shape[2], k, s)
        pw = same_pads(x.shape[3], k, s)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        y = F.conv2d(x, w, b, s, 0, 1, x.shape[1] if groups else 1)
        return y.clamp(0.0, 6.0) if op["act"] == RELU6 else y

    @torch.inference_mode()
    def __call__(self, x_nhwc: torch.Tensor, outputs: List[int]) -> List[torch.Tensor]:
        """``x_nhwc`` (b, H, W, 3) float32; returns ``outputs`` as float32,
        NHWC where 4-d."""
        env: Dict[int, torch.Tensor] = {self.input: x_nhwc.to(self.dtype).permute(0, 3, 1, 2)}
        nchw = {self.input}
        want = set(outputs)
        for op in self.ops:
            code, ins, out = op["code"], op["inputs"], op["outputs"][0]
            if code in (CONV, DWCONV):
                env[out] = self._conv(op, env[ins[0]], code == DWCONV)
                nchw.add(out)
            elif code == ADD:
                env[out] = env[ins[0]] + env[ins[1]]
                nchw.add(out)
            elif code == RESHAPE:
                src = env[ins[0]]
                if ins[0] in nchw:
                    src = src.permute(0, 2, 3, 1)
                shape = self.shapes[out]
                env[out] = src.reshape((src.shape[0],) + tuple(shape[1:]))
            elif code == CONCAT:
                env[out] = torch.cat([env[i] for i in ins], dim=1)
            elif code == LOGISTIC:
                env[out] = torch.sigmoid(env[ins[0]])
            else:
                break  # the detection post-process: reference/ssd_post.py
            if want <= env.keys():
                break
        res = []
        for i in outputs:
            y = env[i]
            if i in nchw:
                y = y.permute(0, 2, 3, 1)
            res.append(y.float())
        return res


def center_heads(net, class_convs: list, frames: np.ndarray, device,
                 std: float = 1.0) -> None:
    """Seeded ReLU6 features have a positive mean, which gives each output
    channel of a linear head an offset of its own, so one class would win
    everywhere. Over the calibration ``frames`` (b, H, W, 3) float32, each
    head conv's bias loses its channel's mean, then weights and bias are
    scaled so the centred outputs have standard deviation ``std``. Runs
    the float32 reference (TF32 off)."""
    fwd = TFLiteForward(net, device, torch.float32)
    outs = fwd(torch.from_numpy(frames).to(device), [op["outputs"][0] for op in class_convs])
    centred = []
    for op, y in zip(class_convs, outs):
        y = y.reshape(-1, y.shape[-1]).double().cpu()
        mean = y.mean(dim=0)
        bias = net.tensors[op["inputs"][2]]
        bias["data"] = (bias["data"] - mean.numpy()).astype(np.float32)
        centred.append((y - mean).reshape(-1))
    gain = np.float32(std / float(torch.cat(centred).std()))
    for op in class_convs:
        for t in op["inputs"][1:]:
            net.tensors[t]["data"] = net.tensors[t]["data"] * gain
