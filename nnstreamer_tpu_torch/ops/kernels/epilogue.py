"""CUDA kernels for the post-filter epilogue, with their plain versions.

Counterparts of the Pallas kernels in ``nnstreamer_tpu/ops/pallas/epilogue.py``
that the SSD bounding-box reduce (decoders/bounding_box.py), the
segmentation decoder (decoders/image_segment.py) and the w8a8 MLP
(ops/int8.py) run:

  * ``class_reduce``     — per-anchor best class score + first index
    attaining it (csrc/class_reduce.cu);
  * ``nms_sweep``        — greedy NMS alive-sweep over the top-K
    score-sorted candidates (csrc/nms_sweep.cu);
  * ``segment_colorize`` — per-pixel class argmax (or pre-argmaxed class
    ids) → RGBA palette lookup (csrc/segment_colorize.cu);
  * ``dequant_gelu_requant`` — int32 GEMM accumulator → dequant → tanh
    gelu → per-row int8 requant (csrc/dequant_gelu_requant.cu).

Each wrapper launches its hand-written kernel for a CUDA tensor, raising on
a device, dtype, shape or layout the kernel does not take, and adds one to
its ``launches`` count for every launch (``segment_colorize`` also to
``launches_by_route``: "bulk", "row" or "ids"), through
``core.graphs.count``: a launch captured into a CUDA graph counts once per
replay, not for the capture. It runs the plain PyTorch
version beside it only for a tensor on the CPU. The plain versions follow
the JAX package's ``*_reference`` functions step by step and are bit-exact
with them (``dequant_gelu_requant_plain`` up to torch's tanh against
XLA's); they are what the kernels are held against on the card.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import Tuple

import torch

from ...core import graphs
from ...obs import profile as _profile
from . import build as _build

_P = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _entry(lib: str, symbol: str, argtypes: tuple):
    """The C entry point ``symbol`` of kernel library ``lib`` (built on
    first use), with its argument types declared once."""
    fn = getattr(_build.library(lib), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def _on(device: torch.device):
    """Make ``device`` current for a launch (a no-op when it already is)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _stream_ptr(t: torch.Tensor) -> _P:
    return _P(torch.cuda.current_stream(t.device).cuda_stream)


def _check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


# --------------------------------------------------------------------------- #
# class_reduce: best class score + index per anchor
# --------------------------------------------------------------------------- #

def class_reduce_plain(cls: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, L) → (max (N,), first index attaining it (N,) int32): the
    reference's ``jnp.max`` / ``jnp.argmax`` pair, written as the Pallas
    kernel's first-max formula (a NaN row yields its first NaN, as
    jnp.argmax does)."""
    best = cls.amax(dim=-1)
    hit = (cls == best[..., None]) | (cls.isnan() & best.isnan()[..., None])
    iota = torch.arange(cls.shape[-1], device=cls.device, dtype=torch.int32)
    idx = torch.where(hit, iota, cls.shape[-1]).amin(dim=-1)
    return best, idx.to(torch.int32)


def class_reduce(cls: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, L) float32 class scores → (best_score (N,), best_index (N,)
    int32). Rows may be strided (a column slice of a wider tensor); the
    last axis must be contiguous. The score is the winning element itself
    (its sign of zero, its NaN payload)."""
    if _profile.KERNEL_HOOK is not None:  # kernel label (obs/profile.py)
        _profile.KERNEL_HOOK("cuda.class_reduce", cls.shape, cls.dtype)
    if cls.device.type == "cpu":
        return class_reduce_plain(cls)
    _require(cls.device.type == "cuda",
             f"class_reduce: unsupported device {cls.device}")
    _require(cls.dtype == torch.float32,
             f"class_reduce: float32 scores required, got {cls.dtype}")
    _require(cls.dim() == 2 and cls.shape[0] > 0 and cls.shape[1] > 0,
             f"class_reduce: non-empty (N, L) scores required, got "
             f"{tuple(cls.shape)}")
    _require(cls.stride(1) == 1 and cls.stride(0) >= cls.shape[1],
             f"class_reduce: rows must be contiguous, strides {cls.stride()}")
    n, l = cls.shape
    best = torch.empty(n, device=cls.device, dtype=torch.float32)
    idx = torch.empty(n, device=cls.device, dtype=torch.int32)
    fn = _entry("class_reduce", "nns_class_reduce",
                (_P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, _P))
    with _on(cls.device):
        rc = fn(cls.data_ptr(), best.data_ptr(), idx.data_ptr(), n, l,
                cls.stride(0), _stream_ptr(cls))
    _check_launch("class_reduce", rc)
    graphs.count(class_reduce)
    return best, idx


class_reduce.launches = 0


# --------------------------------------------------------------------------- #
# nms_sweep: greedy suppression sweep over score-descending candidates
# --------------------------------------------------------------------------- #

#: the largest K whose IoU relation the kernel keeps in shared memory;
#: above it the wrapper hands it global scratch (see the source)
NMS_SMEM_MAX_K = 1024


def nms_sweep_plain(x0: torch.Tensor, y0: torch.Tensor, x1: torch.Tensor,
                    y1: torch.Tensor, scores: torch.Tensor, *,
                    iou_threshold: float, threshold: float) -> torch.Tensor:
    """Scores after greedy NMS: suppressed/below-threshold rows become -1
    (``nms_sweep_reference``, step by step)."""
    k = scores.shape[0]
    area = (x1 - x0) * (y1 - y0)
    ix = (torch.minimum(x1[:, None], x1[None, :])
          - torch.maximum(x0[:, None], x0[None, :]))
    iy = (torch.minimum(y1[:, None], y1[None, :])
          - torch.maximum(y0[:, None], y0[None, :]))
    inter = ix.clamp(min=0) * iy.clamp(min=0)
    union = area[:, None] + area[None, :] - inter
    iou = torch.where(union > 0, inter / union, 0.0)
    ar = torch.arange(k, device=scores.device)
    later = ar[None, :] > ar[:, None]
    suppresses = (iou > iou_threshold) & later
    alive = scores >= threshold
    for i in range(k):
        alive = alive & ~(alive[i] & suppresses[i])
    return torch.where(alive, scores, -1.0)


def nms_sweep(x0: torch.Tensor, y0: torch.Tensor, x1: torch.Tensor,
              y1: torch.Tensor, scores: torch.Tensor, *,
              iou_threshold: float, threshold: float) -> torch.Tensor:
    """Greedy-NMS sweep over K ≥ 1 score-descending candidates (five
    contiguous (K,) float32 columns on one device)."""
    cols = (x0, y0, x1, y1, scores)
    if _profile.KERNEL_HOOK is not None:  # kernel label (obs/profile.py)
        _profile.KERNEL_HOOK("cuda.nms_sweep", scores.shape, scores.dtype)
    if scores.device.type == "cpu":
        return nms_sweep_plain(*cols, iou_threshold=iou_threshold,
                               threshold=threshold)
    _require(scores.device.type == "cuda",
             f"nms_sweep: unsupported device {scores.device}")
    k = scores.shape[0] if scores.dim() == 1 else -1
    for c in cols:
        _require(c.device == scores.device,
                 "nms_sweep: columns on different devices")
        _require(c.dtype == torch.float32,
                 f"nms_sweep: float32 columns required, got {c.dtype}")
        _require(c.dim() == 1 and c.shape[0] == k,
                 f"nms_sweep: five (K,) columns required, got "
                 f"{[tuple(t.shape) for t in cols]}")
        _require(c.is_contiguous(), "nms_sweep: contiguous columns required")
    _require(k > 0, f"nms_sweep: K >= 1 candidates required, got {k}")
    out = torch.empty(k, device=scores.device, dtype=torch.float32)
    scratch = None
    if k > NMS_SMEM_MAX_K:  # the relation: ceil(K / 32) words of K | 1 rows
        scratch = torch.empty(-(-k // 32) * (k | 1), device=scores.device,
                              dtype=torch.int32)
    fn = _entry("nms_sweep", "nns_nms_sweep",
                (_P,) * 7 + (ctypes.c_int, ctypes.c_float, ctypes.c_float, _P))
    with _on(scores.device):
        rc = fn(*(c.data_ptr() for c in cols), out.data_ptr(),
                None if scratch is None else scratch.data_ptr(), k,
                float(iou_threshold), float(threshold), _stream_ptr(scores))
    _check_launch("nms_sweep", rc)
    graphs.count(nms_sweep)
    return out


nms_sweep.launches = 0


# --------------------------------------------------------------------------- #
# segment_colorize: per-pixel argmax + RGBA palette lookup
# --------------------------------------------------------------------------- #

#: palette rows one launch takes (the kernel stages them in shared memory)
PALETTE_MAX_ROWS = 256
#: the logits routes, by the code the C entry point reports: "bulk" stages
#: contiguous rows in shared memory by TMA, "row" reads strided rows (and
#: pixels too wide to stage) in place; the entry point chooses from C and
#: the row stride alone
_COLORIZE_ROUTES = ("bulk", "row")


def segment_colorize_plain(x: torch.Tensor, palette: torch.Tensor,
                           pre_argmaxed: bool = False) -> torch.Tensor:
    """(..., C) logits, or (...) class ids when ``pre_argmaxed``, → (..., 4)
    uint8 through an (n, 4) palette: ``segment_colorize_reference``, i.e.
    ``jnp.take(palette, jnp.argmax(x, -1))``, step by step. First max wins
    ties and a pixel with a NaN takes its first NaN's class; ids truncate
    toward zero (``astype(int32)``); a class in [-n, -1] indexes from the
    end, and any other class outside [0, n) gives jnp.take's uint8 fill,
    (255, 255, 255, 255)."""
    pal = torch.as_tensor(palette, dtype=torch.uint8, device=x.device)
    n = pal.shape[0]
    if pre_argmaxed:
        cls = x.to(torch.int32)
    else:
        best = x.amax(dim=-1, keepdim=True)
        hit = (x == best) | (x.isnan() & best.isnan())
        iota = torch.arange(x.shape[-1], device=x.device, dtype=torch.int32)
        cls = torch.where(hit, iota, x.shape[-1]).amin(dim=-1)
    cls = torch.where(cls < 0, cls + n, cls)
    inside = (cls >= 0) & (cls < n)
    rgba = pal[cls.clamp(0, n - 1).to(torch.int64)]
    return torch.where(inside[..., None], rgba, 255).to(torch.uint8)


def _check_palette(palette: torch.Tensor, device: torch.device) -> None:
    _require(isinstance(palette, torch.Tensor) and palette.device == device,
             f"segment_colorize: palette must be a tensor on {device}")
    _require(palette.dtype == torch.uint8 and palette.dim() == 2
             and palette.shape[1] == 4
             and 1 <= palette.shape[0] <= PALETTE_MAX_ROWS
             and palette.is_contiguous(),
             f"segment_colorize: contiguous (n <= {PALETTE_MAX_ROWS}, 4) uint8 "
             f"palette required, got {tuple(palette.shape)} {palette.dtype}")


def segment_colorize(x: torch.Tensor, palette: torch.Tensor,
                     pre_argmaxed: bool = False) -> torch.Tensor:
    """(..., C) float32 logits, or (...) class ids when ``pre_argmaxed``
    (any integer or float dtype, truncated to int32), → (..., 4) RGBA uint8
    through an (n, 4) uint8 palette on the same device. The logits' rows
    may be strided; the class axis must be contiguous."""
    if _profile.KERNEL_HOOK is not None:  # kernel label (obs/profile.py)
        _profile.KERNEL_HOOK("cuda.segment_colorize", x.shape, x.dtype)
    if x.device.type == "cpu":
        return segment_colorize_plain(x, palette, pre_argmaxed)
    _require(x.device.type == "cuda",
             f"segment_colorize: unsupported device {x.device}")
    _check_palette(palette, x.device)
    if palette.data_ptr() % 4:  # the kernels read a palette row as one word
        palette = palette.clone()
    if pre_argmaxed:
        _require(x.dtype != torch.bool and not x.is_complex(),
                 f"segment_colorize: real class ids required, got {x.dtype}")
        lead = tuple(x.shape)
        ids = x.to(torch.int32).reshape(-1).contiguous()
        p = ids.shape[0]
        route = "ids"
    else:
        _require(x.dtype == torch.float32,
                 f"segment_colorize: float32 logits required, got {x.dtype}")
        _require(x.dim() >= 1 and x.shape[-1] > 0,
                 f"segment_colorize: (..., C >= 1) logits required, got "
                 f"{tuple(x.shape)}")
        lead = tuple(x.shape[:-1])
        c = x.shape[-1]
        flat = x.reshape(-1, c)  # a view where strides allow
        _require(flat.stride(1) == 1 or c == 1,
                 f"segment_colorize: the class axis must be contiguous, "
                 f"strides {x.stride()}")
        p = flat.shape[0]
    out = torch.empty(lead + (4,), device=x.device, dtype=torch.uint8)
    if p == 0:
        return out
    with _on(x.device):
        if pre_argmaxed:
            fn = _entry("segment_colorize", "nns_colorize_ids",
                        (_P, _P, ctypes.c_int, _P, ctypes.c_longlong, _P))
            rc = fn(ids.data_ptr(), palette.data_ptr(), palette.shape[0],
                    out.data_ptr(), p, _stream_ptr(x))
        else:
            fn = _entry("segment_colorize", "nns_argmax_colorize",
                        (_P, _P, ctypes.c_int, _P, ctypes.c_longlong,
                         ctypes.c_int, ctypes.c_longlong,
                         ctypes.POINTER(ctypes.c_int), _P))
            code = ctypes.c_int(-1)
            rc = fn(flat.data_ptr(), palette.data_ptr(), palette.shape[0],
                    out.data_ptr(), p, c, flat.stride(0), ctypes.byref(code),
                    _stream_ptr(x))
    _check_launch("segment_colorize", rc)
    if not pre_argmaxed:
        route = _COLORIZE_ROUTES[code.value]
    graphs.count(segment_colorize)
    graphs.count(segment_colorize, "launches_by_route", route)
    return out


segment_colorize.launches = 0
segment_colorize.launches_by_route = {"bulk": 0, "row": 0, "ids": 0}


# --------------------------------------------------------------------------- #
# dequant_gelu_requant: the w8a8 MLP's inner epilogue, int8 end to end
# --------------------------------------------------------------------------- #

#: jax.nn.gelu's constants as each working dtype holds them (JAX casts
#: sqrt(2/pi) and 0.044715 to the input's dtype)
_GELU_C0 = math.sqrt(2.0 / math.pi)
_GELU_C1 = 0.044715


def gelu_constants(dtype: torch.dtype) -> Tuple[float, float]:
    """(sqrt(2/pi), 0.044715) rounded to ``dtype``, as Python floats."""
    return tuple(float(torch.tensor(c, dtype=torch.float64).to(dtype))
                 for c in (_GELU_C0, _GELU_C1))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x)`` (approximate=True, JAX's default) in JAX's op
    order, every op in x's dtype: x * (0.5 * (1 + tanh(c0 * (x + c1 *
    x**3)))), with x**3 = x * (x * x) as lax.integer_pow computes it.
    ``F.gelu(approximate="tanh")`` orders these ops differently."""
    c0, c1 = gelu_constants(x.dtype)
    cube = x * (x * x)
    return x * (0.5 * (1.0 + torch.tanh(c0 * (x + c1 * cube))))


def absmax_scale(absmax: torch.Tensor) -> torch.Tensor:
    """The int8 grid of an absmax: absmax / 127, and 1 where it is 0. The
    divisor is a tensor, never a Python scalar: PyTorch's CUDA division by
    a scalar multiplies by its reciprocal, which is not IEEE division."""
    return torch.where(absmax == 0.0, 1.0,
                       absmax / torch.full_like(absmax, 127.0))


def dequant_gelu_requant_plain(y: torch.Tensor, xs: torch.Tensor,
                               ws: torch.Tensor,
                               out_dtype: torch.dtype = torch.bfloat16
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int32 accumulator (..., F) → dequant by (xs (..., 1) · ws (F,)) →
    gelu in ``out_dtype`` → per-row int8 requant: returns (q (..., F)
    int8, s (..., 1) float32). ``dequant_gelu_requant_reference`` step by
    step: the dequant rounds ((f32(y) · xs) · ws) to out_dtype, the
    requant is ``quant_act``'s (absmax / 127, 1 for an all-zero row,
    round half to even, clip to ±127)."""
    h = ((y.to(torch.float32) * xs) * ws).to(out_dtype)
    xf = gelu_tanh(h).to(torch.float32)
    s = absmax_scale(xf.abs().amax(dim=-1, keepdim=True))
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return q, s


#: the card's SMs (H100 SXM): the blocks a launch aims to fill
_SMS = 132
#: the widest cluster the kernel takes: the portable maximum (16 blocks,
#: the non-portable one, ran R 1 and R 8 slower on the H100)
MAX_CLUSTER = 8
#: fewest columns worth a block of their own
_MIN_CLUSTER_COLS = 256


def dgr_cluster_size(rows: int, f: int) -> int:
    """Blocks that share one row of ``dequant_gelu_requant``: at most
    ``_SMS`` blocks in all (8 at a decode step's R = 8, 4 at R = 33, 1
    from R = 132), at most ``MAX_CLUSTER``, and no more than F / 256 (a
    row of up to 256 columns stays in one block)."""
    return max(1, min(MAX_CLUSTER, _SMS // max(rows, 1),
                      -(-f // _MIN_CLUSTER_COLS)))


def dequant_gelu_requant(y: torch.Tensor, xs: torch.Tensor, ws: torch.Tensor,
                         out_dtype: torch.dtype = torch.bfloat16
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused w8a8 MLP inner epilogue: ``y`` the (..., F) int32 GEMM
    accumulator, ``xs`` the (..., 1) float32 activation scales, ``ws`` the
    (F,) float32 weight scales, all contiguous on one device; out_dtype
    float32 or bfloat16. Returns the (..., F) int8 codes and their (..., 1)
    float32 scales for the second GEMM. The kernel runs each row on a
    thread-block cluster of ``dgr_cluster_size(R, F)`` blocks."""
    if _profile.KERNEL_HOOK is not None:  # kernel label (obs/profile.py)
        _profile.KERNEL_HOOK("cuda.dequant_gelu_requant", y.shape, y.dtype)
    if y.device.type == "cpu":
        return dequant_gelu_requant_plain(y, xs, ws, out_dtype)
    _require(y.device.type == "cuda",
             f"dequant_gelu_requant: unsupported device {y.device}")
    _require(out_dtype in (torch.float32, torch.bfloat16),
             f"dequant_gelu_requant: out_dtype float32 or bfloat16, got "
             f"{out_dtype}")
    _require(y.dtype == torch.int32 and y.dim() >= 1 and y.shape[-1] > 0,
             f"dequant_gelu_requant: (..., F >= 1) int32 accumulator "
             f"required, got {tuple(y.shape)} {y.dtype}")
    lead, f = tuple(y.shape[:-1]), y.shape[-1]
    rows = math.prod(lead)
    _require(tuple(xs.shape) == lead + (1,) and xs.dtype == torch.float32,
             f"dequant_gelu_requant: xs must be {lead + (1,)} float32, got "
             f"{tuple(xs.shape)} {xs.dtype}")
    _require(tuple(ws.shape) == (f,) and ws.dtype == torch.float32,
             f"dequant_gelu_requant: ws must be ({f},) float32, got "
             f"{tuple(ws.shape)} {ws.dtype}")
    for t in (y, xs, ws):
        _require(t.device == y.device,
                 "dequant_gelu_requant: tensors on different devices")
        _require(t.is_contiguous(),
                 "dequant_gelu_requant: contiguous tensors required")
    q = torch.empty(y.shape, device=y.device, dtype=torch.int8)
    s = torch.empty(lead + (1,), device=y.device, dtype=torch.float32)
    if rows == 0:
        return q, s
    c0, c1 = gelu_constants(out_dtype)
    fn = _entry("dequant_gelu_requant", "nns_dequant_gelu_requant",
                (_P,) * 5 + (ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int, ctypes.c_float, ctypes.c_float, _P))
    with _on(y.device):
        rc = fn(y.data_ptr(), xs.data_ptr(), ws.data_ptr(), q.data_ptr(),
                s.data_ptr(), rows, f, dgr_cluster_size(rows, f),
                int(out_dtype == torch.bfloat16), c0, c1, _stream_ptr(y))
    _check_launch("dequant_gelu_requant", rc)
    graphs.count(dequant_gelu_requant)
    return q, s


dequant_gelu_requant.launches = 0
