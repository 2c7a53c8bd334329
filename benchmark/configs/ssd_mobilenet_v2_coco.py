"""ssd_mobilenet_v2_coco: the .tflite the object-detection example serves,
written from the seed, its plain reference and the comparison of what the
sink receives (detections and the overlay canvas)."""

from __future__ import annotations

import os
from typing import Any, Dict, List

import numpy as np
import torch

from benchmark.harness import peaks
from benchmark.harness import tflite_writer as tw
from benchmark.reference import detect
from benchmark.reference.tflite_net import TFLiteForward, center_heads

#: frames the class heads are centred on
CALIBRATION_FRAMES = 4


def build(cfg: dict, seed: int, workdir: str, device) -> Dict[str, Any]:
    """Write the model and label files; returns the state the reference,
    the judge and the launch string need."""
    built = tw.build_ssd_mobilenet_v2(cfg["input_size"], cfg["depth_multiplier"],
                                      cfg["num_classes"], cfg["extra_depths"])
    net = built["net"]
    net.draw(seed, device)
    size = cfg["input_size"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    calib = (torch.rand((CALIBRATION_FRAMES, size, size, 3), generator=gen, device=device)
             * 2 - 1).cpu().numpy()
    center_heads(net, built["class_convs"], calib, device)
    tw.finish_ssd(built, cfg["postprocess"])
    model = os.path.join(workdir, "ssd_mobilenet_v2_coco.tflite")
    nbytes = net.write(model)
    labels = os.path.join(workdir, "coco_labels_list.txt")
    with open(labels, "w") as f:
        f.write("\n".join(cfg["labels"]) + "\n")
    if len(built["anchors"]) != cfg["anchors"]:
        raise ValueError(f"{len(built['anchors'])} anchors, the config says {cfg['anchors']}")
    return {"cfg": cfg, "built": built, "vars": {"model": model, "labels": labels},
            "model_bytes": nbytes}


def _transform(frames: np.ndarray) -> torch.Tensor:
    x = torch.from_numpy(frames).to(torch.float32)
    return (x + -127.5) / 127.5


def reference(state: dict, frames: np.ndarray, device, control: bool = False) -> List[dict]:
    """The reference's view of each frame ((b, H, W, 3) uint8 at the model's
    input size): per-anchor boxes, class logits and the final detections.
    ``control`` computes the network in bfloat16."""
    built, cfg = state["built"], state["cfg"]
    key = "control_fwd" if control else "ref_fwd"
    if key not in state:
        state[key] = TFLiteForward(built["net"], device,
                                   torch.bfloat16 if control else torch.float32)
    fwd = state[key]
    out = []
    for i in range(0, len(frames), 16):
        x = _transform(frames[i:i + 16]).to(device)
        enc, logits = fwd(x, [built["box_enc"], built["logits"]])
        enc, logits = enc.cpu().numpy(), logits.cpu().numpy()
        dec = cfg["decoder"]
        for e, lg in zip(enc, logits):
            out.append(detect.detect(e, lg, built["anchors"], cfg["postprocess"],
                                     dec["threshold"], dec["iou"]))
    return out


def as_output(state: dict, ref: dict) -> dict:
    """A reference frame as the sink would receive it (the control's
    output): its detections and their canvas."""
    dec = state["cfg"]["decoder"]
    dets = []
    for a, c, s in ref["final"]:
        x0, y0, x1, y1 = (float(np.float32(v)) for v in ref["boxes"][a])
        dets.append({"box": (x0, y0, x1, y1), "score": float(np.float32(s)), "class": c})
    return {"detections": dets,
            "canvas": detect.render(dets, state["cfg"]["labels"], dec["width"], dec["height"])}


def capture(buf) -> dict:
    """What the judge keeps of a sink buffer."""
    return {"detections": list(buf.meta.get("detections", [])),
            "canvas": np.array(buf.memories[0].host(), copy=True)}


def judge(state: dict, pairs) -> Dict[str, float]:
    """The compared numbers over (output, reference) pairs."""
    cfg = state["cfg"]
    dec, labels, lim = cfg["decoder"], cfg["labels"], cfg["limits"]
    # the program's errors the other limits allow leave a detection open
    eps, tol = lim["logit_gap"], lim["box_px"]
    logit_gap = box_px = 0.0
    canvas_px = mismatch = 0
    for out, ref in pairs:
        final = detect.bounded_final(ref, cfg["postprocess"], dec["threshold"], dec["iou"], eps,
                                     tol / dec["width"], tol / dec["height"])
        j = detect.judge_frame(out["detections"], out["canvas"], ref, labels,
                               dec["width"], dec["height"], final=final, box_tol=tol)
        logit_gap, box_px = max(logit_gap, j["logit_gap"]), max(box_px, j["box_px"])
        canvas_px += j["canvas_px"]
        mismatch += j["det_mismatch"]
    return {"logit_gap": logit_gap, "box_px": box_px, "canvas_px": float(canvas_px),
            "det_mismatch": float(mismatch)}


def work(state: dict, refs: List[dict]) -> Dict[str, float]:
    """What these inputs need of the kernels, for the roofline readers: the
    class reduce's shape, and the IoU pairs the greedy sweep over all
    anchors needs (each kept box against the candidates after it)."""
    n = len(state["built"]["anchors"])
    pairs = []
    for r in refs:
        boxes = r["boxes"]
        score = 1.0 / (1.0 + np.exp(-r["cls_logits"].max(axis=1)))
        order = np.argsort(-score, kind="stable")
        pos = np.empty(n, np.int64)
        pos[order] = np.arange(n)
        kept = detect.greedy_nms(boxes, score, state["cfg"]["postprocess"]["nms_iou_threshold"], n)
        pairs.append(float(sum(n - 1 - pos[k] for k in kept)))
    return {"class_reduce_rows": float(n), "class_reduce_cols": float(state["cfg"]["num_classes"]),
            "nms_k": float(n), "nms_pairs": float(np.mean(pairs)) if pairs else 0.0}


def flops_per_frame(state: dict) -> float:
    """Multiply-adds × 2 of every convolution of the network, from its
    shapes (the post-process is not counted)."""
    net = state["built"]["net"]
    total = 0.0
    for op in net.operators:
        if op["code"] not in (tw.TFL_CONV, tw.TFL_DWCONV):
            continue
        _, h, w, cout = net.shape(op["outputs"][0])
        wshape = net.shape(op["inputs"][1])
        if op["code"] == tw.TFL_CONV:
            macs = h * w * cout * wshape[1] * wshape[2] * wshape[3]
        else:
            macs = h * w * cout * wshape[1] * wshape[2]
        total += 2.0 * macs
    return total


def peak_flops(state: dict) -> float:
    peak = state["cfg"]["peak"]
    return peaks.FLOPS[peak["allow_tf32"] if torch.backends.cudnn.allow_tf32 else peak["no_tf32"]]
