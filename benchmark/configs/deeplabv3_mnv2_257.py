"""deeplabv3_mnv2_257: the segmentation example's DeepLab-v3, its weights
written from the seed as a flax checkpoint the program restores, its plain
reference and the comparison of the colour overlay the sink receives."""

from __future__ import annotations

import os
from typing import Any, Dict, List

import numpy as np
import torch

from benchmark.harness import msgpack, peaks
from benchmark.reference import deeplab

#: frames the head is centred on
CALIBRATION_FRAMES = 4


def build(cfg: dict, seed: int, workdir: str, device) -> Dict[str, Any]:
    """Write the checkpoint; returns the state the reference, the judge and
    the launch string need."""
    _, leaves = deeplab.layout(cfg["num_classes"], cfg["width"])
    variables = deeplab.draw(leaves, seed, device)
    size = cfg["input_size"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    calib = torch.randint(0, 256, (CALIBRATION_FRAMES, size, size, 3), generator=gen,
                          device=device, dtype=torch.uint8)
    deeplab.center_head(variables, calib, device)
    model = os.path.join(workdir, "deeplabv3_mnv2_257.msgpack")
    nbytes = msgpack.write(model, variables)
    return {"cfg": cfg, "variables": variables, "vars": {"model": model},
            "model_bytes": nbytes, "pal_index": deeplab.palette_index(cfg["num_classes"]),
            "leaves": leaves}


def reference(state: dict, frames: np.ndarray, device, control: bool = False) -> List[dict]:
    """Each frame's float32 logits ((b, H, W, 3) uint8 at the model's input
    size); ``control`` computes them in float8 e4m3 and bfloat16."""
    key = "control_fwd" if control else "ref_fwd"
    if key not in state:
        state[key] = deeplab.DeepLabForward(state["variables"], device,
                                            quant="fp8" if control else "")
    out = []
    for i in range(0, len(frames), 8):
        logits = state[key](torch.from_numpy(frames[i:i + 8]).to(device)).cpu().numpy()
        out.extend({"logits": lg} for lg in logits)
    return out


def as_output(state: dict, ref: dict) -> dict:
    """A reference frame as the sink would receive it: its argmax in the
    decoder's colours."""
    cls = np.argmax(ref["logits"], axis=-1)
    return {"canvas": deeplab.palette()[cls]}


def capture(buf) -> dict:
    return {"canvas": np.array(buf.memories[0].host(), copy=True)}


def judge(state: dict, pairs) -> Dict[str, float]:
    gap, bad = 0.0, 0
    for out, ref in pairs:
        j = deeplab.judge_frame(out["canvas"], ref["logits"], state["pal_index"])
        gap, bad = max(gap, j["logit_gap"]), bad + j["bad_px"]
    return {"logit_gap": gap, "bad_px": float(bad)}


def work(state: dict, refs: List[dict]) -> Dict[str, float]:
    size = state["cfg"]["input_size"]
    return {"colorize_pixels": float(size * size), "colorize_classes": float(state["cfg"]["num_classes"])}


def flops_per_frame(state: dict) -> float:
    """Multiply-adds × 2 of every convolution, from the kernels' shapes and
    each layer's output size (SAME padding: ceil(size / stride))."""
    size = state["cfg"]["input_size"]
    total, hw, b = 0.0, -(-size // 2), 0
    params = state["variables"]["params"]

    def conv(kernel, out_hw, groups=1):
        kh, kw, cin, cout = kernel.shape
        return 2.0 * out_hw * out_hw * kh * kw * cin * cout

    total += conv(params["ConvBNReLU_0"]["Conv_0"]["kernel"], hw)
    for t, _, n, s in deeplab.SETTINGS:
        for i in range(n):
            p = params[f"InvertedResidual_{b}"]
            j = 0
            if t != 1:
                total += conv(p["ConvBNReLU_0"]["Conv_0"]["kernel"], hw)
                j = 1
            if i == 0 and s == 2:
                hw = -(-hw // 2)
            total += conv(p[f"ConvBNReLU_{j}"]["Conv_0"]["kernel"], hw)
            total += conv(p["Conv_0"]["kernel"], hw)
            b += 1
    a = params["ASPP_0"]
    total += conv(a["ConvBNReLU_0"]["Conv_0"]["kernel"], hw)
    total += sum(conv(a[f"Conv_{i}"]["kernel"], hw) for i in range(len(deeplab.RATES)))
    total += conv(a["ConvBNReLU_1"]["Conv_0"]["kernel"], 1)
    total += conv(a["ConvBNReLU_2"]["Conv_0"]["kernel"], hw)
    total += conv(params["Conv_0"]["kernel"], hw)
    return total


def peak_flops(state: dict) -> float:
    return peaks.FLOPS[state["cfg"]["peak"]["precision"]]
