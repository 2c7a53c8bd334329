"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit), and the per-kernel bytes and operations of PERF.md's
kernel table as functions of a call's shapes (frozen copies of
chip_smoke.py's ``_bound_ms`` arithmetic and its NMS_OPS_PER_PAIR)."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12, "fp8": 1979e12}
#: IoU arithmetic per candidate pair in nms_sweep: 2 min, 2 max, 2 sub,
#: 2 clamp, 1 mul, 1 add, 1 sub, 1 div, 1 compare
NMS_OPS_PER_PAIR = 13


def bound_s(nbytes: float, ops: float, dtype: str = "float32") -> float:
    """The least time for the work: bytes over the memory rate or
    operations over the peak, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FLOPS[dtype])


def class_reduce_s(rows: float, cols: float) -> float:
    """Each anchor's max and argmax over its class scores: the scores read
    once, a float and an int32 written a row."""
    return bound_s(rows * cols * 4 + rows * 8, rows * cols)


def nms_sweep_s(k: float, pairs: float) -> float:
    """The greedy sweep: four coordinates and a score read, a score
    written a row; the IoU of every pair these inputs need."""
    return bound_s(6 * k * 4, NMS_OPS_PER_PAIR * pairs)


def segment_colorize_s(pixels: float, classes: float) -> float:
    """Argmax over the class logits and the palette lookup: the logits and
    the 1 KiB palette read once, a 4-byte pixel written."""
    return bound_s(pixels * classes * 4 + pixels * 4 + 1024, pixels * classes)
