"""TFLite model importer — port of nnstreamer_tpu/models/tflite_import.py.

``tensor_filter framework=tensorflow-lite model=foo.tflite`` is the string
most NNStreamer users have (the reference serves it through the TFLite
Interpreter, ``tensor_filter_tensorflow_lite.cc:154``). There is no TFLite
runtime here either. This module:

1. parses the flatbuffer directly (the JAX package's generic reader over
   the wire format, numpy only, with the public schema's field ids
   documented inline); a CUSTOM operator's FlexBuffers options are decoded
   by the port's own ``converters/flexbuf_codec.py`` (no ``flatbuffers``
   package, which the card's machine lacks);
2. lowers the op graph to one function of a parameter dict over torch
   tensors, ``apply_params(params, *inputs)``, with the JAX package's keys
   (``t{idx}``, ``sg{i}/t{idx}``) and the same dequantized constants. On
   the card the filter captures the whole function as one CUDA graph, as it
   does any bundle.

Tensors keep TFLite's NHWC meaning: a convolution runs on the
``permute(0, 3, 1, 2)`` view of the NHWC memory (channels-last, which cuDNN
takes without a copy) with the OHWI weights' ``permute(0, 3, 1, 2)`` view,
and its result is permuted back, a view again. SAME padding pads more at
the end, as TFLite does; SAME average pooling divides by the count of
in-bounds elements.

Quantized (uint8/int8) models run in dequantized float as in JAX: weights
are dequantized at load, the input inside the function, every quantized
intermediate is snapped onto its grid (``_fake_quant``) and the outputs are
requantized to the model's contract. An op whose result is snapped computes
in float64 and rounds once to float32 before the snap, so its codes do not
hang on a float32 sum's order: cuDNN's and the CPU's orders differ, one ulp
at a rounding edge moves a code, and a deep quantized network spreads one
moved code to most of its later ones (JAX computes these ops in float32). A division by a constant (a scale, a
box coder's scale, a window's count) is a product with the float32
reciprocal, as XLA compiles JAX's division: one IEEE multiply, so the
card, the CPU and JAX give the same bits (one ulp moves a uint8 code).

``CUSTOM:TFLite_Detection_PostProcess`` runs its class reduction through
the port's ``class_reduce`` kernel (the fast path's ``max``/``argmax`` over
the class columns) and its greedy sweep through ``nms_sweep`` (once for the
fast path, once a class on the regular path), ranking with a stable
descending sort where JAX takes ``lax.top_k`` (tied scores in index order).

``IF`` and ``WHILE`` branch on a device value, which needs a host read; a
read cannot happen inside a CUDA-graph capture, so a model holding either
loads with ``metadata["jit"] = False`` (the filter's "pre-built, never
captured" mark) and runs eagerly.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..converters import flexbuf_codec
from ..core import graphs
from ..core.log import logger
from ..core.types import TensorInfo, TensorsInfo
from ..ops.kernels import epilogue as _ep
from .layers import same_padding
from .zoo import ModelBundle

log = logger("tflite")

# --------------------------------------------------------------------------- #
# Generic flatbuffer reader (little-endian wire format, flatbuffers.md spec)
# --------------------------------------------------------------------------- #


class _FB:
    """Minimal flatbuffer accessor: tables, vtables, scalars, vectors,
    strings. Positions are absolute byte offsets into ``buf``."""

    __slots__ = ("buf",)

    def __init__(self, buf: bytes) -> None:
        self.buf = buf

    # scalar readers
    def u8(self, p): return self.buf[p]
    def i8(self, p): return struct.unpack_from("<b", self.buf, p)[0]
    def u16(self, p): return struct.unpack_from("<H", self.buf, p)[0]
    def i32(self, p): return struct.unpack_from("<i", self.buf, p)[0]
    def u32(self, p): return struct.unpack_from("<I", self.buf, p)[0]
    def i64(self, p): return struct.unpack_from("<q", self.buf, p)[0]
    def f32(self, p): return struct.unpack_from("<f", self.buf, p)[0]

    def root(self) -> int:
        """Root table position (file identifier, if any, is skipped)."""
        return self.u32(0)

    def indirect(self, p: int) -> int:
        return p + self.u32(p)

    def field(self, table: int, fid: int) -> int:
        """Byte offset of field ``fid`` within ``table``, or 0 if absent
        (vtable lookup: soffset at table start points BACK to the vtable;
        slot for field id N sits at vtable + 4 + 2N)."""
        vtable = table - self.i32(table)
        vsize = self.u16(vtable)
        slot = 4 + 2 * fid
        if slot >= vsize:
            return 0
        off = self.u16(vtable + slot)
        return table + off if off else 0

    def scalar(self, table: int, fid: int, reader: Callable[[int], Any],
               default: Any) -> Any:
        p = self.field(table, fid)
        return reader(p) if p else default

    def offset(self, table: int, fid: int) -> Optional[int]:
        """Position of an offset-typed field's target (string/vector/table)."""
        p = self.field(table, fid)
        return self.indirect(p) if p else None

    def string(self, table: int, fid: int) -> Optional[str]:
        p = self.offset(table, fid)
        if p is None:
            return None
        n = self.u32(p)
        return self.buf[p + 4:p + 4 + n].decode("utf-8", "replace")

    def vector(self, table: int, fid: int) -> Optional[Tuple[int, int]]:
        """(element count, position of first element) or None."""
        p = self.offset(table, fid)
        if p is None:
            return None
        return self.u32(p), p + 4

    def vec_np(self, table: int, fid: int, dtype: str) -> Optional[np.ndarray]:
        v = self.vector(table, fid)
        if v is None:
            return None
        n, p = v
        return np.frombuffer(self.buf, dtype=dtype, count=n, offset=p).copy()

    def vec_tables(self, table: int, fid: int) -> List[int]:
        """Positions of tables in a vector-of-tables field."""
        v = self.vector(table, fid)
        if v is None:
            return []
        n, p = v
        return [self.indirect(p + 4 * i) for i in range(n)]


# --------------------------------------------------------------------------- #
# TFLite schema walk (field ids per the public tensorflow/lite schema.fbs)
# --------------------------------------------------------------------------- #

#: schema TensorType enum → numpy dtype
_TENSORTYPE_NP = {
    0: np.float32, 1: np.float16, 2: np.int32, 3: np.uint8, 4: np.int64,
    6: np.bool_, 7: np.int16, 9: np.int8, 10: np.float64,
    16: np.uint32, 17: np.uint16,
}

#: deprecated_builtin_code → op name (subset; stable public enum)
_BUILTIN_OPS = {
    0: "ADD", 1: "AVERAGE_POOL_2D", 2: "CONCATENATION", 3: "CONV_2D",
    4: "DEPTHWISE_CONV_2D", 5: "DEPTH_TO_SPACE", 6: "DEQUANTIZE",
    9: "FULLY_CONNECTED", 14: "LOGISTIC", 17: "MAX_POOL_2D", 18: "MUL",
    19: "RELU", 21: "RELU6", 22: "RESHAPE", 23: "RESIZE_BILINEAR",
    25: "SOFTMAX", 26: "SPACE_TO_DEPTH", 28: "TANH", 32: "CUSTOM",
    34: "PAD", 36: "GATHER", 39: "TRANSPOSE", 40: "MEAN", 41: "SUB",
    42: "DIV", 43: "SQUEEZE", 45: "STRIDED_SLICE", 47: "EXP",
    49: "SPLIT", 53: "CAST", 54: "PRELU", 55: "MAXIMUM", 56: "ARG_MAX",
    57: "MINIMUM", 58: "LESS", 60: "PAD_V2", 61: "GREATER",
    62: "GREATER_EQUAL", 63: "LESS_EQUAL", 65: "SLICE",
    67: "TRANSPOSE_CONV", 70: "EXPAND_DIMS", 71: "EQUAL", 72: "NOT_EQUAL",
    73: "LOG", 74: "SUM", 75: "SQRT", 76: "RSQRT", 77: "SHAPE",
    78: "POW", 79: "ARG_MIN", 82: "REDUCE_MAX", 83: "PACK",
    84: "LOGICAL_OR", 86: "LOGICAL_AND", 87: "LOGICAL_NOT",
    88: "UNPACK", 89: "REDUCE_MIN", 97: "RESIZE_NEAREST",
    98: "LEAKY_RELU", 101: "ABS", 114: "QUANTIZE", 117: "HARD_SWISH",
    118: "IF", 119: "WHILE",
}

_ACT_NONE, _ACT_RELU, _ACT_RELU_N1, _ACT_RELU6, _ACT_TANH = 0, 1, 2, 3, 4

#: CUSTOM ops the lowerer handles (others fail at load)
_SUPPORTED_CUSTOM = frozenset({"CUSTOM:TFLite_Detection_PostProcess"})

#: ops whose branch or trip count is a device value read on the host
_HOST_CONTROL_FLOW = frozenset({"IF", "WHILE"})


@dataclass
class QuantParams:
    """Per-tensor (or per-channel along ``axis``) affine quantization:
    real = scale * (q - zero_point)."""

    scale: np.ndarray          # shape () or (C,)
    zero_point: np.ndarray     # same shape, int64
    axis: int = 0              # quantized_dimension for per-channel

    @property
    def per_channel(self) -> bool:
        return self.scale.ndim > 0 and self.scale.size > 1


@dataclass
class TFLTensor:
    index: int
    name: str
    shape: Tuple[int, ...]
    np_dtype: Any
    buffer_index: int
    quant: Optional[QuantParams]
    data: Optional[np.ndarray] = None   # constant payload (typed, undequantized)


@dataclass
class TFLOperator:
    op: str                              # name from _BUILTIN_OPS / custom code
    inputs: List[int]                    # tensor indices (-1 = absent optional)
    outputs: List[int]
    options: Dict[str, Any] = field(default_factory=dict)


@dataclass
class TFLSubgraph:
    tensors: List[TFLTensor]
    operators: List[TFLOperator]
    inputs: List[int]
    outputs: List[int]
    name: str = ""


@dataclass
class TFLModel:
    path: str
    version: int
    description: str
    #: main subgraph contents, aliased for the common single-graph case
    tensors: List[TFLTensor]
    operators: List[TFLOperator]
    inputs: List[int]
    outputs: List[int]
    #: ALL subgraphs (index 0 is the main one above); >1 for control-flow
    #: models (IF/WHILE bodies live in their own subgraphs)
    subgraphs: List[TFLSubgraph] = field(default_factory=list)


def _parse_quant(fb: _FB, qpos: Optional[int]) -> Optional[QuantParams]:
    # QuantizationParameters: 0 min, 1 max, 2 scale[f32], 3 zero_point[i64],
    # 4 details(union: ids 4+5), 6 quantized_dimension
    if qpos is None:
        return None
    scale = fb.vec_np(qpos, 2, "<f4")
    if scale is None or scale.size == 0:
        return None
    zp = fb.vec_np(qpos, 3, "<i8")
    if zp is None or zp.size == 0:
        zp = np.zeros_like(scale, dtype=np.int64)
    axis = fb.scalar(qpos, 6, fb.i32, 0)
    if scale.size == 1:
        scale, zp = scale.reshape(()), zp.reshape(())
    return QuantParams(scale, zp, axis)


def _parse_options(fb: _FB, op: str, opos: Optional[int]) -> Dict[str, Any]:
    """Builtin options table → dict, dispatched on the op (the union type
    field is redundant with the opcode for the supported subset)."""
    o: Dict[str, Any] = {}
    if opos is None:
        # no builtin_options table at all: every field is schema-default,
        # which for conv/pool means stride 0 — the prepare-time guard in
        # _validate_options reports it
        return _validate_options(op, o)
    if op == "CONV_2D":
        # Conv2DOptions: 0 padding, 1 stride_w, 2 stride_h, 3 activation,
        # 4 dilation_w, 5 dilation_h
        o["padding"] = fb.scalar(opos, 0, fb.i8, 0)
        o["stride_w"] = fb.scalar(opos, 1, fb.i32, 0)
        o["stride_h"] = fb.scalar(opos, 2, fb.i32, 0)
        o["activation"] = fb.scalar(opos, 3, fb.i8, 0)
        o["dilation_w"] = fb.scalar(opos, 4, fb.i32, 1)
        o["dilation_h"] = fb.scalar(opos, 5, fb.i32, 1)
    elif op == "DEPTHWISE_CONV_2D":
        # DepthwiseConv2DOptions: 0 padding, 1 stride_w, 2 stride_h,
        # 3 depth_multiplier, 4 activation, 5 dilation_w, 6 dilation_h
        o["padding"] = fb.scalar(opos, 0, fb.i8, 0)
        o["stride_w"] = fb.scalar(opos, 1, fb.i32, 0)
        o["stride_h"] = fb.scalar(opos, 2, fb.i32, 0)
        o["depth_multiplier"] = fb.scalar(opos, 3, fb.i32, 0)
        o["activation"] = fb.scalar(opos, 4, fb.i8, 0)
        o["dilation_w"] = fb.scalar(opos, 5, fb.i32, 1)
        o["dilation_h"] = fb.scalar(opos, 6, fb.i32, 1)
    elif op in ("AVERAGE_POOL_2D", "MAX_POOL_2D"):
        # Pool2DOptions: 0 padding, 1 stride_w, 2 stride_h, 3 filter_width,
        # 4 filter_height, 5 activation
        o["padding"] = fb.scalar(opos, 0, fb.i8, 0)
        o["stride_w"] = fb.scalar(opos, 1, fb.i32, 0)
        o["stride_h"] = fb.scalar(opos, 2, fb.i32, 0)
        o["filter_w"] = fb.scalar(opos, 3, fb.i32, 0)
        o["filter_h"] = fb.scalar(opos, 4, fb.i32, 0)
        o["activation"] = fb.scalar(opos, 5, fb.i8, 0)
    elif op == "SOFTMAX":
        o["beta"] = fb.scalar(opos, 0, fb.f32, 1.0)
    elif op == "CONCATENATION":
        o["axis"] = fb.scalar(opos, 0, fb.i32, 0)
        o["activation"] = fb.scalar(opos, 1, fb.i8, 0)
    elif op in ("ADD", "MUL", "SUB", "DIV"):
        o["activation"] = fb.scalar(opos, 0, fb.i8, 0)
    elif op == "RESHAPE":
        ns = fb.vec_np(opos, 0, "<i4")
        if ns is not None:
            o["new_shape"] = [int(x) for x in ns]
    elif op == "RESIZE_BILINEAR":
        # ResizeBilinearOptions: 0/1 deprecated new_h/new_w,
        # 2 align_corners, 3 half_pixel_centers
        o["align_corners"] = bool(fb.scalar(opos, 2, fb.u8, 0))
        o["half_pixel_centers"] = bool(fb.scalar(opos, 3, fb.u8, 0))
    elif op == "RESIZE_NEAREST":
        # ResizeNearestNeighborOptions: 0 align_corners, 1 half_pixel_centers
        o["align_corners"] = bool(fb.scalar(opos, 0, fb.u8, 0))
        o["half_pixel_centers"] = bool(fb.scalar(opos, 1, fb.u8, 0))
    elif op == "FULLY_CONNECTED":
        o["activation"] = fb.scalar(opos, 0, fb.i8, 0)
        o["keep_num_dims"] = bool(fb.scalar(opos, 2, fb.u8, 0))
    elif op in ("MEAN", "SUM", "REDUCE_MAX", "REDUCE_MIN"):
        o["keep_dims"] = bool(fb.scalar(opos, 0, fb.u8, 0))
    elif op in ("ARG_MAX", "ARG_MIN"):
        o["output_type"] = fb.scalar(opos, 0, fb.i8, 2)  # TensorType enum
    elif op == "SQUEEZE":
        sq = fb.vec_np(opos, 0, "<i4")
        o["squeeze_dims"] = [] if sq is None else [int(x) for x in sq]
    elif op == "STRIDED_SLICE":
        for i, k in enumerate(("begin_mask", "end_mask", "ellipsis_mask",
                               "new_axis_mask", "shrink_axis_mask")):
            o[k] = fb.scalar(opos, i, fb.i32, 0)
    elif op == "TRANSPOSE_CONV":
        # TransposeConvOptions: 0 padding, 1 stride_w, 2 stride_h
        # (later schema adds fused_activation at 3; default NONE)
        o["padding"] = fb.scalar(opos, 0, fb.i8, 0)
        o["stride_w"] = fb.scalar(opos, 1, fb.i32, 0)
        o["stride_h"] = fb.scalar(opos, 2, fb.i32, 0)
        o["activation"] = fb.scalar(opos, 3, fb.i8, 0)
    elif op == "GATHER":
        # GatherOptions: 0 axis, 1 batch_dims
        o["axis"] = fb.scalar(opos, 0, fb.i32, 0)
        o["batch_dims"] = fb.scalar(opos, 1, fb.i32, 0)
    elif op == "UNPACK":
        # UnpackOptions: 0 num (validated against the output count in the
        # lowerer), 1 axis
        o["num"] = fb.scalar(opos, 0, fb.i32, 0)
        o["axis"] = fb.scalar(opos, 1, fb.i32, 0)
    elif op == "LEAKY_RELU":
        o["alpha"] = fb.scalar(opos, 0, fb.f32, 0.0)
    elif op in ("DEPTH_TO_SPACE", "SPACE_TO_DEPTH"):
        o["block_size"] = fb.scalar(opos, 0, fb.i32, 1)
    elif op == "CAST":
        # CastOptions: 0 in_data_type, 1 out_data_type; the table is
        # commonly omitted (dtype inferable from the output tensor) —
        # keep None in that case so the evaluator falls back correctly
        p = fb.field(opos, 1)
        if p:
            o["out_type"] = fb.i8(p)
    elif op == "PACK":
        # PackOptions: 0 values_count, 1 axis
        o["axis"] = fb.scalar(opos, 1, fb.i32, 0)
    elif op == "IF":
        # IfOptions: 0 then_subgraph_index, 1 else_subgraph_index
        o["then_subgraph"] = fb.scalar(opos, 0, fb.i32, 0)
        o["else_subgraph"] = fb.scalar(opos, 1, fb.i32, 0)
    elif op == "WHILE":
        # WhileOptions: 0 cond_subgraph_index, 1 body_subgraph_index
        o["cond_subgraph"] = fb.scalar(opos, 0, fb.i32, 0)
        o["body_subgraph"] = fb.scalar(opos, 1, fb.i32, 0)
    return _validate_options(op, o)


def _validate_options(op: str, o: Dict[str, Any]) -> Dict[str, Any]:
    """Prepare-time checks the TFLite runtime also makes
    (tflite/kernels/conv.cc:378): the schema stride/filter default is 0,
    so a writer must set them explicitly."""
    if op in ("CONV_2D", "DEPTHWISE_CONV_2D", "AVERAGE_POOL_2D",
              "MAX_POOL_2D", "TRANSPOSE_CONV"):
        if o.get("stride_w", 0) < 1 or o.get("stride_h", 0) < 1:
            raise ValueError(
                f"tflite: {op} stride_w/stride_h must be >= 1 "
                f"(got {o.get('stride_w')}x{o.get('stride_h')})")
    if op in ("AVERAGE_POOL_2D", "MAX_POOL_2D"):
        if o.get("filter_w", 0) < 1 or o.get("filter_h", 0) < 1:
            raise ValueError(
                f"tflite: {op} filter_width/filter_height must be >= 1 "
                f"(got {o.get('filter_w')}x{o.get('filter_h')})")
    if op == "IF" and (o.get("then_subgraph", 0) < 1
                       or o.get("else_subgraph", 0) < 1):
        # a missing/defaulted options table would point the branch at
        # subgraph 0 — the MAIN graph, i.e. unbounded self-recursion —
        # reject malformed control flow at parse
        raise ValueError(
            "tflite: IF operator missing/invalid then/else subgraph indices")
    if op == "WHILE" and (o.get("cond_subgraph", 0) < 1
                          or o.get("body_subgraph", 0) < 1):
        raise ValueError(
            "tflite: WHILE operator missing/invalid cond/body subgraph "
            "indices")
    return o


#: what a malformed FlexBuffers map raises inside the reader
_FLEX_ERRORS = (ValueError, TypeError, IndexError, KeyError, struct.error,
                UnicodeDecodeError, RecursionError)


def _custom_options(blob: bytes) -> Dict[str, Any]:
    """A CUSTOM operator's options (a FlexBuffers map) → dict, read by the
    port's own codec. A malformed map gives no options, so the op's
    lowering names the key it misses, as in JAX."""
    try:
        decoded = flexbuf_codec.loads(blob)
    except _FLEX_ERRORS:
        return {}
    return decoded if isinstance(decoded, dict) else {}


def parse_tflite(path: str) -> TFLModel:
    """Parse a .tflite flatbuffer into a TFLModel."""
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < 8:
        raise ValueError(f"{path}: not a tflite flatbuffer (too small)")
    ident = buf[4:8]
    if ident not in (b"TFL3", b"TFL2", b"TFL1"):
        raise ValueError(f"{path}: missing TFL3 file identifier "
                         f"(got {ident!r})")
    fb = _FB(buf)
    # Model: 0 version, 1 operator_codes, 2 subgraphs, 3 description,
    # 4 buffers, 5 metadata_buffer, 6 metadata, 7 signature_defs
    model = fb.root()
    version = fb.scalar(model, 0, fb.u32, 0)
    desc = fb.string(model, 3) or ""

    # operator codes → names
    op_names: List[str] = []
    for oc in fb.vec_tables(model, 1):
        # OperatorCode: 0 deprecated_builtin_code(i8), 1 custom_code,
        # 2 version, 3 builtin_code(i32, post-2020 codes >127)
        code = fb.scalar(oc, 3, fb.i32, 0) or fb.scalar(oc, 0, fb.i8, 0)
        if code == 32:  # CUSTOM
            op_names.append("CUSTOM:" + (fb.string(oc, 1) or "?"))
        else:
            op_names.append(_BUILTIN_OPS.get(code, f"UNKNOWN_{code}"))

    # buffers (0 data:[ubyte])
    buffers: List[Optional[Tuple[int, int]]] = []
    for b in fb.vec_tables(model, 4):
        buffers.append(fb.vector(b, 0))  # (nbytes, pos) or None

    def parse_subgraph(sg) -> TFLSubgraph:
        # SubGraph: 0 tensors, 1 inputs, 2 outputs, 3 operators, 4 name
        tensors: List[TFLTensor] = []
        for i, t in enumerate(fb.vec_tables(sg, 0)):
            # Tensor: 0 shape[i32], 1 type(i8), 2 buffer(u32), 3 name,
            # 4 quantization, 5 is_variable, 6 sparsity, 7 shape_signature
            shape_v = fb.vec_np(t, 0, "<i4")
            shape = tuple(int(d) for d in shape_v) \
                if shape_v is not None else ()
            ttype = fb.scalar(t, 1, fb.i8, 0)
            np_dtype = _TENSORTYPE_NP.get(ttype)
            if np_dtype is None:
                raise ValueError(f"{path}: tensor {i} has unsupported "
                                 f"TensorType {ttype}")
            bufidx = fb.scalar(t, 2, fb.u32, 0)
            quant = _parse_quant(fb, fb.offset(t, 4))
            data = None
            if 0 < bufidx < len(buffers) and buffers[bufidx] is not None:
                nbytes, pos = buffers[bufidx]
                if nbytes:
                    flat = np.frombuffer(
                        buf, dtype=np.dtype(np_dtype),
                        count=nbytes // np.dtype(np_dtype).itemsize,
                        offset=pos)
                    data = flat.reshape(shape if shape else (-1,)).copy()
            tensors.append(TFLTensor(i, fb.string(t, 3) or f"t{i}", shape,
                                     np_dtype, bufidx, quant, data))

        operators: List[TFLOperator] = []
        for opr in fb.vec_tables(sg, 3):
            # Operator: 0 opcode_index, 1 inputs[i32], 2 outputs[i32],
            # 3 builtin_options_type(u8), 4 builtin_options(table),
            # 5 custom_options[ubyte]
            idx = fb.scalar(opr, 0, fb.u32, 0)
            name = op_names[idx] if idx < len(op_names) else f"BADCODE_{idx}"
            ins = fb.vec_np(opr, 1, "<i4")
            outs = fb.vec_np(opr, 2, "<i4")
            options = _parse_options(fb, name, fb.offset(opr, 4))
            if name.startswith("CUSTOM:"):
                # Operator slot 5: custom_options[ubyte], a FlexBuffers map
                # for the ops supported
                co = fb.vector(opr, 5)
                if co is not None and co[0]:
                    nbytes, pos = co
                    options.update(_custom_options(bytes(buf[pos:pos + nbytes])))
            operators.append(TFLOperator(
                name, [int(x) for x in (ins if ins is not None else [])],
                [int(x) for x in (outs if outs is not None else [])],
                options))

        inputs_v = fb.vec_np(sg, 1, "<i4")
        outputs_v = fb.vec_np(sg, 2, "<i4")
        return TFLSubgraph(
            tensors, operators,
            [int(x) for x in (inputs_v if inputs_v is not None else [])],
            [int(x) for x in (outputs_v if outputs_v is not None else [])],
            fb.string(sg, 4) or "")

    sg_tables = fb.vec_tables(model, 2)
    if not sg_tables:
        raise ValueError(f"{path}: model has no subgraphs")
    parsed = [parse_subgraph(sg) for sg in sg_tables]
    main = parsed[0]
    return TFLModel(path, version, desc, main.tensors, main.operators,
                    main.inputs, main.outputs, parsed)


# --------------------------------------------------------------------------- #
# Lowering helpers
# --------------------------------------------------------------------------- #


def _require_per_tensor_io(m: "TFLModel", t: TFLTensor, role: str) -> None:
    """Graph I/O (de/re)quantization supports per-tensor quant only —
    per-channel scales on an I/O tensor would need a layout contract the
    uint8 wire caps cannot express."""
    if t.quant is not None and t.quant.per_channel:
        raise NotImplementedError(
            f"{os.path.basename(m.path)}: graph {role} tensor {t.name!r} is "
            "per-channel quantized; only per-tensor-quantized model I/O is "
            "supported")


def _dequant_const(t: TFLTensor) -> np.ndarray:
    """Constant tensor → float32 (weights/bias of quantized models are
    dequantized once at load; float constants pass through)."""
    a = t.data
    assert a is not None
    if np.issubdtype(a.dtype, np.floating):
        return a.astype(np.float32)
    if t.quant is None:
        return a  # integer constant used as shape/axes — keep typed
    q = t.quant
    if q.per_channel:
        # broadcast scale along quantized_dimension
        bshape = [1] * a.ndim
        bshape[q.axis] = q.scale.size
        scale = q.scale.reshape(bshape)
        zp = q.zero_point.reshape(bshape)
    else:
        scale, zp = q.scale, q.zero_point
    return ((a.astype(np.float32) - zp.astype(np.float32))
            * scale.astype(np.float32))


def _div(x: torch.Tensor, v: Any) -> torch.Tensor:
    """``x / v`` for a constant ``v`` as JAX's compiled program computes it:
    XLA rewrites a division by a constant into a product with its float32
    reciprocal. The reciprocal is taken on the host and the product is one
    IEEE float32 multiply on every device, so the card, the CPU and JAX
    give the same bits (one ulp of a quotient moves a uint8 code)."""
    return x * float(np.float32(1.0) / np.float32(v))


def _narrow(y: torch.Tensor) -> torch.Tensor:
    """A float64 result back to float32 (one rounding)."""
    return y.to(torch.float32) if y.dtype == torch.float64 else y


def _fused_act(x: torch.Tensor, code: int) -> torch.Tensor:
    if code == _ACT_NONE:
        return x
    if code == _ACT_RELU:
        return torch.clamp(x, min=0.0)
    if code == _ACT_RELU_N1:
        return torch.clamp(x, -1.0, 1.0)
    if code == _ACT_RELU6:
        return torch.clamp(x, 0.0, 6.0)
    if code == _ACT_TANH:
        return torch.tanh(x)
    raise ValueError(f"unsupported fused activation {code}")


_PAD_MODES = {0: "SAME", 1: "VALID"}


def _to_nchw(x: torch.Tensor) -> torch.Tensor:
    """The NCHW view of NHWC memory (channels-last strides, no copy)."""
    return x.permute(0, 3, 1, 2)


def _to_nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1)


def _same_pads(x: torch.Tensor, kh: int, kw: int, sh: int, sw: int,
               dh: int = 1, dw: int = 1) -> Tuple[Tuple[int, int], ...]:
    """TFLite SAME padding of an NHWC ``x``: (top, bottom), (left, right),
    the larger half at the end."""
    return (same_padding(x.shape[1], kh, sh, dh),
            same_padding(x.shape[2], kw, sw, dw))


def _pad_nchw(xc: torch.Tensor, pads, value: float = 0.0) -> torch.Tensor:
    (pt, pb), (pl, pr) = pads
    return F.pad(xc, (pl, pr, pt, pb), value=value)


def _conv2d_nhwc(x: torch.Tensor, w_oihw: torch.Tensor, o: Dict[str, Any],
                 groups: int = 1) -> torch.Tensor:
    """NHWC convolution with TFLite's padding; no bias (added after, in
    JAX's op order)."""
    xc = _to_nchw(x)
    stride = (o["stride_h"], o["stride_w"])
    dil = (o["dilation_h"], o["dilation_w"])
    if _PAD_MODES[o["padding"]] == "SAME":
        pads = _same_pads(x, w_oihw.shape[2], w_oihw.shape[3], *stride, *dil)
        if pads[0][0] == pads[0][1] and pads[1][0] == pads[1][1]:
            y = F.conv2d(xc, w_oihw, None, stride, (pads[0][0], pads[1][0]),
                         dil, groups)
        else:
            y = F.conv2d(_pad_nchw(xc, pads), w_oihw, None, stride, 0, dil,
                         groups)
    else:
        y = F.conv2d(xc, w_oihw, None, stride, 0, dil, groups)
    return _to_nhwc(y)


def _window_sum(xc: torch.Tensor, fh: int, fw: int, sh: int,
                sw: int) -> torch.Tensor:
    """Sum over each (fh, fw) window of NCHW ``xc`` (no padding)."""
    return F.avg_pool2d(xc, (fh, fw), (sh, sw), divisor_override=1)


def _resize_bilinear(x: torch.Tensor, out_h: int, out_w: int,
                     align_corners: bool, half_pixel: bool) -> torch.Tensor:
    """Gather-based bilinear resize matching TFLite's coordinate
    conventions (align_corners / half_pixel_centers / neither), NHWC. The
    legacy mode (neither) samples at ``i * in / out``, which no
    ``F.interpolate`` mode does; the formula follows JAX's step by step."""
    n, h, w, c = x.shape
    dev = x.device

    def coords(out: int, size: int) -> torch.Tensor:
        a = torch.arange(out, dtype=torch.float32, device=dev)
        if align_corners and out > 1:
            return a * ((size - 1) / (out - 1))
        if half_pixel:
            return (a + 0.5) * (size / out) - 0.5
        return a * (size / out)

    ys = torch.clamp(coords(out_h, h), 0.0, h - 1)
    xs = torch.clamp(coords(out_w, w), 0.0, w - 1)
    y0 = torch.floor(ys).to(torch.int64)
    x0 = torch.floor(xs).to(torch.int64)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    wy = (ys - y0)[None, :, None, None]
    wx = (xs - x0)[None, None, :, None]
    rows0 = x.index_select(1, y0)
    rows1 = x.index_select(1, y1)
    a = rows0.index_select(2, x0)
    b = rows0.index_select(2, x1)
    cc = rows1.index_select(2, x0)
    d = rows1.index_select(2, x1)
    return (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
            + cc * wy * (1 - wx) + d * wy * wx)


def _avg_pool_same_countvalid(x: torch.Tensor, fh: int, fw: int, sh: int,
                              sw: int) -> torch.Tensor:
    """AVERAGE_POOL_2D with SAME padding counts only in-bounds elements
    (TFLite semantics; the padding may be asymmetric): sum-pool over the
    zero-padded input / sum-pool over ones."""
    pads = _same_pads(x, fh, fw, sh, sw)
    xc = _pad_nchw(_to_nchw(x), pads)
    ones = _pad_nchw(torch.ones((x.shape[0], 1) + tuple(x.shape[1:3]),
                                dtype=x.dtype, device=x.device), pads)
    s = _window_sum(xc, fh, fw, sh, sw)
    cnt = _window_sum(ones, fh, fw, sh, sw)
    # the counts are constants to XLA, so it multiplies by their reciprocal
    return _to_nhwc(s * torch.reciprocal(cnt))


def _host_slice(dim: int, b: int, e: Optional[int], s: int
                ) -> Tuple[bool, slice]:
    """Python's ``range(dim)[b:e:s]`` as (flip, slice) torch can take:
    torch slices step forward only, so a negative stride reads the
    flipped axis forward."""
    r = range(dim)[slice(b, e, s)]
    if len(r) == 0:
        return False, slice(0, 0, 1)
    if r.step > 0:
        return False, slice(r.start, r.start + (len(r) - 1) * r.step + 1,
                            r.step)
    j0 = dim - 1 - r.start
    return True, slice(j0, j0 + (len(r) - 1) * -r.step + 1, -r.step)


def _torch_dtype(np_dtype: Any) -> torch.dtype:
    return getattr(torch, np.dtype(np_dtype).name)


def _gather(x: torch.Tensor, indices: torch.Tensor, axis: int,
            batch_dims: int) -> torch.Tensor:
    """``jnp.take(x, indices, axis)``, over ``batch_dims`` leading batch
    dims shared by ``x`` and ``indices`` when it is not 0."""
    ax = axis if axis >= 0 else axis + x.dim()
    bd = batch_dims + indices.dim() if batch_dims < 0 else batch_dims
    if not bd:
        flat = x.index_select(ax, indices.reshape(-1))
        return flat.reshape(tuple(x.shape[:ax]) + tuple(indices.shape)
                            + tuple(x.shape[ax + 1:]))
    lead = tuple(x.shape[:bd])
    xb = x.reshape((-1,) + tuple(x.shape[bd:]))
    ib = indices.reshape((-1,) + tuple(indices.shape[bd:]))
    parts = [_gather(xb[i], ib[i], ax - bd, 0) for i in range(xb.shape[0])]
    y = torch.stack(parts)
    return y.reshape(lead + tuple(y.shape[1:]))


def _stable_top(scores: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the ``k`` largest, tied scores in index order
    (a stable descending sort; ``torch.topk`` promises no tie order)."""
    top, idx = torch.sort(scores, descending=True, stable=True)
    return top[:k], idx[:k]


class _Lowerer:
    """Per-subgraph lowering state.

    The root lowerer (subgraph 0) owns the shared params dict and eagerly
    creates child lowerers for every other subgraph, so all constants are
    registered at load (IF/WHILE bodies live in their own subgraphs).
    Integer constants (shapes, axes, sizes, paddings) are also kept on the
    host (``static``): the lowering reads them while it builds each op, as
    JAX reads its concrete constants while it traces."""

    def __init__(self, m: TFLModel, sg_index: int = 0,
                 root: Optional["_Lowerer"] = None):
        self.m = m
        self.sg = m.subgraphs[sg_index] if m.subgraphs else m
        self.sg_index = sg_index
        self._prefix = "" if sg_index == 0 else f"sg{sg_index}/"
        self.root = root or self
        self.params: Dict[str, np.ndarray] = \
            {} if root is None else root.params
        self.const_idx: set = set()
        self.static: Dict[int, np.ndarray] = {}
        for t in self.sg.tensors:
            if t.data is not None:
                a = _dequant_const(t)
                self.params[f"{self._prefix}t{t.index}"] = a
                self.const_idx.add(t.index)
                if not np.issubdtype(a.dtype, np.floating):
                    self.static[t.index] = a
                t.data = None  # the params copy is the one that outlives
                # the load
        if root is None:
            #: device copies of SHAPE results, made in a signature's eager
            #: call and replayed by its capture
            self._host_made: Dict[Tuple, torch.Tensor] = {}
            self._children: Dict[int, "_Lowerer"] = {0: self}
            for si in range(1, len(m.subgraphs or [])):
                self._children[si] = _Lowerer(m, si, root=self)

    def _subgraph_apply(self, si: int) -> Callable:
        try:
            child = self.root._children[si]
        except KeyError:
            raise ValueError(
                f"{os.path.basename(self.m.path)}: control-flow op "
                f"references unknown subgraph {si}") from None
        return child.build_apply()

    def _on_device(self, idx: int, value: np.ndarray,
                   device: torch.device) -> torch.Tensor:
        """A host value (a SHAPE result) as a device tensor: made in the
        eager call of a signature, reused by its capture (nothing is copied
        up inside a capture)."""
        key = (self.sg_index, idx, str(device), value.dtype.str, value.shape,
               value.tobytes())
        made = self.root._host_made.get(key)
        if made is None:
            if graphs.capturing():
                raise RuntimeError(
                    f"tflite: tensor {idx} is first needed on the card "
                    "inside a capture")
            made = self.root._host_made[key] = torch.as_tensor(
                value, device=device)
        return made

    # -- graph evaluation --------------------------------------------------- #
    def build_apply(self) -> Callable:
        m = self.m
        sg = self.sg
        const_idx = self.const_idx
        prefix = self._prefix
        is_root = self.root is self

        def apply(params, *inputs):
            env: Dict[Any, Any] = {}
            # live params ride in the env so IF/WHILE evals can pass them
            # to child subgraph applies explicitly
            env["__params__"] = params
            for idx in const_idx:
                env[idx] = params[f"{prefix}t{idx}"]
            if len(inputs) != len(sg.inputs):
                raise ValueError(
                    f"{os.path.basename(m.path)}: expected "
                    f"{len(sg.inputs)} inputs, got {len(inputs)}")
            for idx, x in zip(sg.inputs, inputs):
                t = sg.tensors[idx]
                x = torch.as_tensor(x)
                if tuple(x.shape) != t.shape and x.numel() == int(
                        np.prod(t.shape)):
                    x = x.reshape(t.shape)
                if is_root and t.quant is not None and not np.issubdtype(
                        np.dtype(t.np_dtype), np.floating):
                    # model-BOUNDARY dequantization only: inner subgraphs
                    # (IF/WHILE bodies) receive already-dequantized floats
                    _require_per_tensor_io(m, t, "input")
                    x = (x.to(torch.float32)
                         - float(np.float32(t.quant.zero_point))) \
                        * float(np.float32(t.quant.scale))
                env[idx] = x
            for op in sg.operators:
                self._eval_op(op, env)
            outs = []
            for idx in sg.outputs:
                t = sg.tensors[idx]
                y = env[idx]
                if is_root and t.quant is not None and not np.issubdtype(
                        np.dtype(t.np_dtype), np.floating):
                    _require_per_tensor_io(m, t, "output")
                    q = torch.round(_div(y, t.quant.scale)
                                    + float(np.float32(t.quant.zero_point)))
                    info = np.iinfo(t.np_dtype)
                    y = torch.clamp(q, info.min, info.max).to(
                        _torch_dtype(t.np_dtype))
                outs.append(y)
            return tuple(outs)

        return apply

    def _snapped(self, op: TFLOperator) -> bool:
        """Whether the op's results land on a quantization grid."""
        for i in op.outputs:
            t = self.sg.tensors[i]
            if t.quant is not None and not t.quant.per_channel \
                    and not np.issubdtype(np.dtype(t.np_dtype), np.floating):
                return True
        return False

    def _eval_op(self, op: TFLOperator, env: Dict[Any, Any]) -> None:
        o = op.options
        # an op whose result is snapped onto a grid computes in float64 and
        # rounds to float32 before the snap (_wide)
        wide = self._snapped(op)

        def get(i: int) -> Optional[torch.Tensor]:
            if i >= len(op.inputs) or op.inputs[i] < 0:
                return None
            v = env[op.inputs[i]]
            return v.to(torch.float64) if wide and v.is_floating_point() else v

        def hv(i: int) -> np.ndarray:
            """Input ``i``'s value on the host: a static operand must be an
            integer constant, as under JAX's trace."""
            idx = op.inputs[i]
            if idx not in self.static:
                raise NotImplementedError(
                    f"{os.path.basename(self.m.path)}: {op.op} reads tensor "
                    f"{idx} as a static value, but it is computed by the "
                    "graph")
            return self.static[idx]

        name = op.op
        if name == "CONV_2D":
            x, w, b = get(0), get(1), get(2)
            # tflite kernel is OHWI; its OIHW view is channels-last
            y = _conv2d_nhwc(x, w.permute(0, 3, 1, 2), o)
            if b is not None:
                y = y + b
            y = _fused_act(y, o["activation"])
        elif name == "DEPTHWISE_CONV_2D":
            x, w, b = get(0), get(1), get(2)
            # tflite dw kernel is (1, H, W, in*mult) → (in*mult, 1, H, W):
            # output channel ic*mult + m reads input channel ic
            y = _conv2d_nhwc(x, w.permute(3, 0, 1, 2), o,
                             groups=x.shape[-1])
            if b is not None:
                y = y + b
            y = _fused_act(y, o["activation"])
        elif name == "AVERAGE_POOL_2D":
            x = get(0)
            fh, fw, sh, sw = (o["filter_h"], o["filter_w"], o["stride_h"],
                              o["stride_w"])
            if _PAD_MODES[o["padding"]] == "SAME":
                y = _avg_pool_same_countvalid(x, fh, fw, sh, sw)
            else:
                y = _div(_to_nhwc(_window_sum(_to_nchw(x), fh, fw, sh, sw)),
                         fh * fw)
            y = _fused_act(y, o["activation"])
        elif name == "MAX_POOL_2D":
            x = get(0)
            fh, fw, sh, sw = (o["filter_h"], o["filter_w"], o["stride_h"],
                              o["stride_w"])
            xc = _to_nchw(x)
            if _PAD_MODES[o["padding"]] == "SAME":
                xc = _pad_nchw(xc, _same_pads(x, fh, fw, sh, sw),
                               value=-float("inf"))
            y = _to_nhwc(F.max_pool2d(xc, (fh, fw), (sh, sw)))
            y = _fused_act(y, o["activation"])
        elif name in ("ADD", "MUL", "SUB", "DIV"):
            a, b = get(0), get(1)
            fn = {"ADD": torch.add, "MUL": torch.mul,
                  "SUB": torch.sub, "DIV": torch.div}[name]
            y = _fused_act(fn(a, b), o.get("activation", 0))
        elif name in ("MAXIMUM", "MINIMUM"):
            y = (torch.maximum if name == "MAXIMUM" else torch.minimum)(
                get(0), get(1))
        elif name == "CONCATENATION":
            parts = [get(j) for j, i in enumerate(op.inputs) if i >= 0]
            y = _fused_act(torch.cat(parts, dim=o["axis"]),
                           o.get("activation", 0))
        elif name == "RESHAPE":
            x = get(0)
            if get(1) is not None:
                new_shape = [int(v) for v in hv(1).reshape(-1)]
            else:
                new_shape = o.get("new_shape") or list(
                    self.sg.tensors[op.outputs[0]].shape)
            y = x.reshape(new_shape)
        elif name == "SQUEEZE":
            x = get(0)
            dims = o.get("squeeze_dims") or [
                i for i, d in enumerate(x.shape) if d == 1]
            y = x.reshape([d for i, d in enumerate(x.shape) if i not in
                           {d % x.dim() for d in dims}])
        elif name == "EXPAND_DIMS":
            y = torch.unsqueeze(get(0), int(hv(1).reshape(())))
        elif name == "SOFTMAX":
            # jax.nn.softmax's op order: exp(x - max) / its sum
            x = get(0) * float(np.float32(o.get("beta", 1.0)))
            e = torch.exp(x - torch.amax(x, dim=-1, keepdim=True))
            y = e / torch.sum(e, dim=-1, keepdim=True)
        elif name == "LOGISTIC":
            y = torch.sigmoid(get(0))
        elif name == "TANH":
            y = torch.tanh(get(0))
        elif name == "RELU":
            y = torch.clamp(get(0), min=0.0)
        elif name == "RELU6":
            y = torch.clamp(get(0), 0.0, 6.0)
        elif name == "PRELU":
            x, alpha = get(0), get(1)
            y = torch.where(x >= 0, x, x * alpha)
        elif name == "LEAKY_RELU":
            x = get(0)
            y = torch.where(x >= 0, x,
                            x * float(np.float32(o.get("alpha", 0.0))))
        elif name == "HARD_SWISH":
            x = get(0)
            y = _div(x * torch.clamp(x + 3.0, 0.0, 6.0), 6.0)
        elif name == "RESIZE_BILINEAR":
            size = hv(1).reshape(-1)
            y = _resize_bilinear(get(0), int(size[0]), int(size[1]),
                                 o.get("align_corners", False),
                                 o.get("half_pixel_centers", False))
        elif name == "RESIZE_NEAREST":
            x = get(0)
            size = hv(1).reshape(-1)
            oh, ow = int(size[0]), int(size[1])
            h, w = x.shape[1], x.shape[2]
            dev = x.device
            if o.get("half_pixel_centers"):
                iy = torch.floor((torch.arange(oh, device=dev) + 0.5)
                                 * (h / oh))
                ix = torch.floor((torch.arange(ow, device=dev) + 0.5)
                                 * (w / ow))
            elif o.get("align_corners") and oh > 1 and ow > 1:
                iy = torch.round(torch.arange(oh, device=dev)
                                 * ((h - 1) / (oh - 1)))
                ix = torch.round(torch.arange(ow, device=dev)
                                 * ((w - 1) / (ow - 1)))
            else:
                iy = (torch.arange(oh, device=dev) * h) // oh
                ix = (torch.arange(ow, device=dev) * w) // ow
            iy = torch.clamp(iy.to(torch.int64), 0, h - 1)
            ix = torch.clamp(ix.to(torch.int64), 0, w - 1)
            y = x.index_select(1, iy).index_select(2, ix)
        elif name in ("MEAN", "SUM", "REDUCE_MAX", "REDUCE_MIN"):
            x = get(0)
            axes = tuple(int(a) for a in hv(1).reshape(-1))
            keep = o.get("keep_dims", False)
            if not axes:
                y = x.to(torch.float32) if name == "MEAN" \
                    and not x.is_floating_point() else x
            elif name == "MEAN":
                # jnp.mean: the sum, divided by the (constant) count
                xf = x if x.is_floating_point() else x.to(torch.float32)
                count = int(np.prod([x.shape[a] for a in axes]))
                y = _div(torch.sum(xf, dim=axes, keepdim=keep), count)
            elif name == "SUM":
                y = torch.sum(x, dim=axes, keepdim=keep).to(x.dtype)
            else:
                y = (torch.amax if name == "REDUCE_MAX" else torch.amin)(
                    x, dim=axes, keepdim=keep)
        elif name in ("ARG_MAX", "ARG_MIN"):
            x = get(0)
            ax = int(hv(1).reshape(()))
            fn = torch.argmax if name == "ARG_MAX" else torch.argmin
            out_np = _TENSORTYPE_NP.get(o.get("output_type", 2), np.int32)
            y = fn(x, dim=ax).to(_torch_dtype(out_np))
        elif name in ("PAD", "PAD_V2"):
            x, p = get(0), hv(1).reshape(-1, 2)
            cval = 0.0
            if name == "PAD_V2" and get(2) is not None:
                cval = float(hv(2).reshape(()))
            flat = []
            for a, b in reversed(p.tolist()):
                flat += [int(a), int(b)]
            y = F.pad(x, flat, value=cval)
        elif name == "TRANSPOSE":
            y = get(0).permute(*(int(v) for v in hv(1).reshape(-1)))
        elif name == "FULLY_CONNECTED":
            x, w, b = get(0), get(1), get(2)
            x2 = x.reshape((-1, w.shape[-1])) if not o.get("keep_num_dims") \
                else x
            y = x2 @ w.T
            if b is not None:
                y = y + b
            y = _fused_act(y, o["activation"])
        elif name == "CAST":
            x = get(0)
            out_t = o.get("out_type")
            out_np = self.sg.tensors[op.outputs[0]].np_dtype \
                if out_t is None else _TENSORTYPE_NP.get(out_t, np.float32)
            y = x.to(_torch_dtype(out_np))
        elif name in ("DEQUANTIZE", "QUANTIZE"):
            # whole graph already runs dequantized float; both are identity
            # up to the grid snap of their output
            y = get(0)
        elif name == "SPACE_TO_DEPTH":
            x = get(0)
            bs = o["block_size"]
            n, h, w, c = x.shape
            y = x.reshape(n, h // bs, bs, w // bs, bs, c) \
                 .permute(0, 1, 3, 2, 4, 5) \
                 .reshape(n, h // bs, w // bs, c * bs * bs)
        elif name == "DEPTH_TO_SPACE":
            x = get(0)
            bs = o["block_size"]
            n, h, w, c = x.shape
            y = x.reshape(n, h, w, bs, bs, c // (bs * bs)) \
                 .permute(0, 1, 3, 2, 4, 5) \
                 .reshape(n, h * bs, w * bs, c // (bs * bs))
        elif name == "SHAPE":
            x = env[op.inputs[0]]
            y = self._on_device(op.outputs[0],
                                np.asarray(tuple(x.shape), np.int32),
                                x.device)
        elif name in ("LESS", "LESS_EQUAL", "GREATER", "GREATER_EQUAL",
                      "EQUAL", "NOT_EQUAL"):
            y = {"LESS": torch.lt, "LESS_EQUAL": torch.le,
                 "GREATER": torch.gt, "GREATER_EQUAL": torch.ge,
                 "EQUAL": torch.eq, "NOT_EQUAL": torch.ne}[name](
                get(0), get(1))
        elif name in ("LOGICAL_AND", "LOGICAL_OR"):
            y = (torch.logical_and if name == "LOGICAL_AND"
                 else torch.logical_or)(get(0), get(1))
        elif name == "IF":
            # the predicate is read on the host (the model runs eagerly,
            # metadata["jit"] is False): one branch runs
            pred = bool(get(0).reshape(()).to(torch.bool))
            branch = self.root._subgraph_apply(
                o["then_subgraph"] if pred else o["else_subgraph"])
            res = branch(env["__params__"], *(env[i] for i in op.inputs[1:]))
            for out_idx, val in zip(op.outputs, res):
                env[out_idx] = val
            return
        elif name == "WHILE":
            cond_fn = self.root._subgraph_apply(o["cond_subgraph"])
            body_fn = self.root._subgraph_apply(o["body_subgraph"])
            carry = tuple(env[i] for i in op.inputs)
            live = env["__params__"]
            sig = [(tuple(c.shape), c.dtype) for c in carry]

            def step(c):
                nxt = tuple(body_fn(live, *c))
                got = [(tuple(v.shape), v.dtype) for v in nxt]
                if got != sig:
                    raise NotImplementedError(
                        f"{os.path.basename(self.m.path)}: WHILE body "
                        f"changes carry shapes/dtypes ({sig} -> {got})")
                return nxt

            if not bool(cond_fn(live, *carry)[0].reshape(()).to(torch.bool)):
                step(carry)  # the body's signature is checked all the same
            else:
                while bool(cond_fn(live, *carry)[0].reshape(())
                           .to(torch.bool)):
                    carry = step(carry)
            for out_idx, val in zip(op.outputs, carry):
                env[out_idx] = val
            return
        elif name == "LOGICAL_NOT":
            y = torch.logical_not(get(0))
        elif name == "LOG":
            y = torch.log(get(0))
        elif name in ("SQRT", "RSQRT", "EXP", "ABS", "POW"):
            x = get(0)
            fn = {"SQRT": torch.sqrt,
                  "RSQRT": lambda v: torch.reciprocal(torch.sqrt(v)),
                  "EXP": torch.exp, "ABS": torch.abs}.get(name)
            y = fn(x) if fn is not None else torch.pow(x, get(1))
        elif name == "SLICE":
            x = get(0)
            begin = hv(1).reshape(-1)
            size = hv(2).reshape(-1)
            idx = tuple(slice(int(b), x.shape[i] if int(s) == -1
                              else int(b) + int(s))
                        for i, (b, s) in enumerate(zip(begin, size)))
            y = x[idx]
        elif name == "GATHER":
            x, indices = get(0), get(1)
            y = _gather(x, indices.to(torch.int64), int(o.get("axis", 0)),
                        int(o.get("batch_dims", 0) or 0))
        elif name == "PACK":
            y = torch.stack([get(j) for j in range(len(op.inputs))],
                            dim=o.get("axis", 0))
        elif name == "STRIDED_SLICE":
            y = self._strided_slice(get(0), hv, o, get(3) is not None)
        elif name == "TRANSPOSE_CONV":
            # inputs: 0 output_shape, 1 weights (OHWI, O = output channels),
            # 2 activations, 3 optional bias. Scatter semantics:
            # out[y*s + fy - P] += x[y] * w[fy], P the low SAME padding
            # (0 for VALID): a transposed convolution with padding P whose
            # result is cut (or zero-padded) at the end to output_shape
            out_shape = hv(0).reshape(-1)
            w, x = get(1), get(2)
            b = get(3)
            oh, ow = int(out_shape[1]), int(out_shape[2])
            sh, sw = o["stride_h"], o["stride_w"]
            kh, kw = w.shape[1], w.shape[2]
            same = _PAD_MODES[o["padding"]] == "SAME"

            def low(in_sz, out_sz, k, s):
                return max((in_sz - 1) * s + k - out_sz, 0) // 2 if same \
                    else 0

            ph, pw = low(x.shape[1], oh, kh, sh), low(x.shape[2], ow, kw, sw)
            # (out_ch, kh, kw, in_ch) → (in_ch, out_ch, kh, kw)
            y = F.conv_transpose2d(_to_nchw(x), w.permute(3, 0, 1, 2),
                                   None, (sh, sw), (ph, pw))
            y = y[:, :, :oh, :ow]
            if y.shape[2] < oh or y.shape[3] < ow:
                y = F.pad(y, (0, ow - y.shape[3], 0, oh - y.shape[2]))
            y = _to_nhwc(y)
            if b is not None:
                y = y + b
            y = _fused_act(y, o.get("activation", 0))
        elif name == "SPLIT":
            # inputs: 0 axis (scalar tensor), 1 x; N equal outputs (the
            # output count is what the graph wires)
            ax = int(hv(0).reshape(()))
            x = get(1)
            n = len(op.outputs)
            if x.shape[ax] % n:
                raise ValueError(
                    f"SPLIT: axis of {x.shape[ax]} does not divide into {n}")
            parts = torch.split(x, x.shape[ax] // n, dim=ax)
            for out_idx, part in zip(op.outputs, parts):
                env[out_idx] = self._fake_quant(out_idx, _narrow(part))
            return
        elif name == "UNPACK":
            x = get(0)
            ax = o.get("axis", 0)
            if o.get("num") and o["num"] != len(op.outputs):
                raise ValueError(
                    f"UNPACK num={o['num']} disagrees with "
                    f"{len(op.outputs)} wired outputs")
            for j, out_idx in enumerate(op.outputs):
                env[out_idx] = self._fake_quant(out_idx, _narrow(x.select(ax, j)))
            return
        elif name == "CUSTOM:TFLite_Detection_PostProcess":
            outs = self._detection_postprocess(get(0), get(1), get(2), o)
            for out_idx, val in zip(op.outputs, outs):
                env[out_idx] = val
            return
        else:
            raise NotImplementedError(
                f"{os.path.basename(self.m.path)}: TFLite op {name!r} is "
                "not in the supported lowering subset")
        outs = op.outputs
        env[outs[0]] = self._fake_quant(outs[0], _narrow(y))
        if len(outs) > 1:
            raise NotImplementedError(f"multi-output op {name}")

    @staticmethod
    def _strided_slice(x: torch.Tensor, hv: Callable, o: Dict[str, Any],
                       has_strides: bool) -> torch.Tensor:
        begin = hv(1).reshape(-1)
        end = hv(2).reshape(-1)
        strides = hv(3).reshape(-1) if has_strides else np.ones_like(begin)
        nspec = len(begin)
        new_mask = o.get("new_axis_mask", 0)
        ell_mask = o.get("ellipsis_mask", 0)
        if bin(ell_mask).count("1") > 1:
            raise ValueError("STRIDED_SLICE: multiple ellipsis bits")
        n_new = bin(new_mask & ((1 << nspec) - 1)).count("1")
        dims_covered = nspec - n_new - (1 if ell_mask else 0)
        ell_fill = x.dim() - dims_covered  # full slices the … expands to
        idx: List[Any] = []
        flips: List[int] = []
        d = 0  # input dimension cursor (spec position i may diverge from it
        #        through new-axis and ellipsis entries)
        for i in range(nspec):
            if ell_mask & (1 << i):
                for _ in range(max(ell_fill, 0)):
                    idx.append(slice(None))
                    d += 1
                continue
            if new_mask & (1 << i):
                idx.append(None)  # a new axis
                continue
            dim = x.shape[d]
            b = int(begin[i])
            e = int(end[i])
            s = int(strides[i]) if i < len(strides) else 1
            # Start/StopForAxis semantics (strided_slice_logic.h): masks
            # and clamping resolve BEFORE shrink; the clamp range is
            # [0, dim] for positive stride and [-1, dim-1] for negative
            # (dim / -1 = "exhausted" → empty slice)
            if o.get("begin_mask", 0) & (1 << i):
                b = 0 if s > 0 else dim - 1
            else:
                if b < 0:
                    b += dim
                if o.get("shrink_axis_mask", 0) & (1 << i):
                    b = int(np.clip(b, 0, dim - 1))
                else:
                    b = int(np.clip(b, 0, dim)) if s > 0 \
                        else int(np.clip(b, -1, dim - 1))
            if o.get("shrink_axis_mask", 0) & (1 << i):
                idx.append(b)
                d += 1
                continue
            if o.get("end_mask", 0) & (1 << i):
                e = None
            else:
                if e < 0:
                    e += dim
                e = int(np.clip(e, 0, dim)) if s > 0 \
                    else int(np.clip(e, -1, dim - 1))
            if s < 0 and b == -1:
                flip, sl = False, slice(0, 0, 1)       # empty
            elif s < 0 and e == -1:
                flip, sl = _host_slice(dim, b, None, s)  # through index 0
            else:
                flip, sl = _host_slice(dim, b, e, s)
            if flip:
                flips.append(d)
            idx.append(sl)
            d += 1
        while d < x.dim():  # dims beyond the spec: full slices
            idx.append(slice(None))
            d += 1
        if flips:
            x = torch.flip(x, flips)
        return x[tuple(idx)]

    def _detection_postprocess(self, locs_in: torch.Tensor,
                               cls_in_all: torch.Tensor,
                               anchors: torch.Tensor, o: Dict[str, Any]
                               ) -> Tuple[torch.Tensor, ...]:
        """CUSTOM:TFLite_Detection_PostProcess: SSD center-size box decode,
        then greedy NMS, fast (class-agnostic over each anchor's best
        class: ``class_reduce`` and one ``nms_sweep``) or regular (one
        ``nms_sweep`` a class). JAX's lowering step by step; its ``-inf``
        dead sentinel stays out of the kernel: the sweep is handed the
        indicator of ``top_score >= thr`` with threshold 0.5, so it returns
        1 where a row is alive and -1 where it is dead, whatever the
        threshold."""
        if int(o.get("max_classes_per_detection", 1)) != 1:
            raise NotImplementedError(
                "TFLite_Detection_PostProcess: "
                f"max_classes_per_detection="
                f"{o.get('max_classes_per_detection')} is not supported "
                "(only top-1 class per box)")
        locs = locs_in[0]           # [N, 4] (y, x, h, w) encodings
        cls_in = cls_in_all[0]      # [N, C] scores (the graph already
        #                             applied sigmoid/softmax)
        num_classes = int(o["num_classes"])
        max_d = int(o["max_detections"])
        label_offset = cls_in.shape[-1] - num_classes  # background columns
        cls_scores = cls_in[:, label_offset:]
        ya, xa, ha, wa = (anchors[:, 0], anchors[:, 1], anchors[:, 2],
                          anchors[:, 3])
        yc = _div(locs[:, 0], o["y_scale"]) * ha + ya
        xc = _div(locs[:, 1], o["x_scale"]) * wa + xa
        hh = torch.exp(_div(locs[:, 2], o["h_scale"])) * ha
        ww = torch.exp(_div(locs[:, 3], o["w_scale"])) * wa
        ymin, xmin = yc - hh / 2, xc - ww / 2
        ymax, xmax = yc + hh / 2, xc + ww / 2
        thr = float(np.float32(o.get("nms_score_threshold", 0.0)))
        iou_thr = float(np.float32(o.get("nms_iou_threshold", 0.6)))
        n = int(cls_scores.shape[0])
        # static pre-NMS candidate cap: the interpreter considers every
        # above-threshold anchor; 2048 covers the common SSD exports
        # (mobilenet-ssd = 1917 anchors)
        k = min(n, 2048)
        if n > k:
            log.warning(
                "TFLite_Detection_PostProcess: %d anchors exceed the %d "
                "pre-NMS candidate cap; detections may diverge from the "
                "TFLite runtime when >%d candidates pass the score "
                "threshold", n, k, k)
        neg_inf = -float("inf")  # sentinel safe for logit-scale thresholds

        def greedy_nms(scores_1d: torch.Tensor, cap: int):
            """Threshold → top-``cap`` → greedy same-order NMS (B3).
            Returns (kept_scores[cap] with -inf for dead slots,
            anchor_idx[cap])."""
            masked = torch.where(scores_1d >= thr, scores_1d, neg_inf)
            top_score, idx = _stable_top(masked, cap)
            alive = _ep.nms_sweep(
                xmin[idx], ymin[idx], xmax[idx], ymax[idx],
                (top_score >= thr).to(torch.float32),
                iou_threshold=iou_thr, threshold=0.5) > 0
            return torch.where(alive, top_score, neg_inf), idx

        if o.get("use_regular_nms"):
            # regular path: NMS per class, each class keeps its top
            # detections_per_class, then a global top-max_detections ranks
            # across classes
            dpc = int(o.get("detections_per_class", 100) or 100)
            kc = min(k, max(2 * dpc, max_d, 128))
            if n > kc:
                log.warning(
                    "TFLite_Detection_PostProcess(regular): per-class "
                    "candidate pool capped at %d of %d anchors; heavy "
                    "same-class suppression may backfill differently from "
                    "the TFLite runtime", kc, n)
            per_class = [greedy_nms(cls_scores[:, c].contiguous(), kc)
                         for c in range(num_classes)]
            kept_c = torch.stack([p[0] for p in per_class])    # [C, kc]
            idx_c = torch.stack([p[1] for p in per_class])
            if dpc < kc:
                # ranks beyond detections_per_class die, per class
                rank = torch.argsort(
                    torch.argsort(-kept_c, dim=1, stable=True), dim=1,
                    stable=True)
                kept_c = torch.where(rank < dpc, kept_c, neg_inf)
            flat_scores = kept_c.reshape(-1)          # [C*kc]
            flat_anchor = idx_c.reshape(-1)
            flat_cls = torch.arange(
                num_classes, dtype=torch.float32,
                device=flat_scores.device).repeat_interleave(kc)
            final_score, fsel = _stable_top(
                flat_scores, min(max_d, int(flat_scores.shape[0])))
            sel = flat_anchor[fsel]
            sel_cls = flat_cls[fsel]
        else:
            # fast path: class-agnostic NMS over each anchor's best class
            best_score, best_cls = _ep.class_reduce(
                cls_scores.to(torch.float32).contiguous())
            kept, idx = greedy_nms(best_score, k)
            final_score, fsel = _stable_top(kept, min(max_d, k))
            sel = idx[fsel]
            sel_cls = best_cls[sel].to(torch.float32)
        pad = max_d - int(final_score.shape[0])
        valid = final_score >= thr
        out_boxes = torch.where(
            valid[:, None],
            torch.stack([ymin[sel], xmin[sel], ymax[sel], xmax[sel]], 1),
            0.0)
        out_cls = torch.where(valid, sel_cls, 0.0)
        out_scr = torch.where(valid, final_score, 0.0)
        if pad:
            out_boxes = F.pad(out_boxes, (0, 0, 0, pad))
            out_cls = F.pad(out_cls, (0, pad))
            out_scr = F.pad(out_scr, (0, pad))
        num = torch.sum(valid.to(torch.float32))[None]
        return out_boxes[None], out_cls[None], out_scr[None], num

    def _fake_quant(self, tensor_idx: int, y: torch.Tensor) -> torch.Tensor:
        """Snap an op result onto its output tensor's quantization grid.

        In a quantized graph the activation clamp is encoded in the quant
        range (e.g. relu6 = range [0, 6] with zero_point 0), not in the
        fused_activation_function field — float execution must therefore
        round-and-clamp every intermediate to its tensor's representable
        grid, in JAX's compiled op order (``_div``)."""
        t = self.sg.tensors[tensor_idx]
        if t.quant is None or np.issubdtype(np.dtype(t.np_dtype),
                                            np.floating):
            return y
        if t.quant.per_channel or not y.is_floating_point():
            return y  # per-channel activations don't occur in practice
        info = np.iinfo(t.np_dtype)
        zp = float(np.float32(t.quant.zero_point))
        q = torch.clamp(torch.round(_div(y, t.quant.scale) + zp),
                        info.min, info.max)
        return (q - zp) * float(np.float32(t.quant.scale))


# --------------------------------------------------------------------------- #
# Public entry: .tflite path → ModelBundle
# --------------------------------------------------------------------------- #


def _tensor_info(t: TFLTensor) -> TensorInfo:
    shape = t.shape if t.shape else (1,)
    return TensorInfo.from_shape(shape, np.dtype(t.np_dtype), t.name)


def _device_params(params: Dict[str, np.ndarray],
                   device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in params.items()}


def load_tflite(path: str, device: Any = None) -> ModelBundle:
    """``model=foo.tflite`` → ModelBundle on ``device`` (cuda unless asked
    otherwise): ``params`` the dequantized constants as device tensors,
    ``apply_params(params, *inputs)`` and ``apply``.

    The bundle's I/O contract mirrors the flatbuffer exactly (dims, dtype —
    uint8 for quantized models), so caps negotiation produces the same
    ``other/tensor`` caps the reference's tflite subplugin reports via
    ``getModelInfo`` (tensor_filter_tensorflow_lite.cc). Unsupported ops and
    per-channel quantized I/O fail here, at load."""
    device = torch.device("cuda" if device is None else device)
    m = parse_tflite(path)
    for role, idxs in (("input", m.inputs), ("output", m.outputs)):
        for i in idxs:
            t = m.tensors[i]
            if not np.issubdtype(np.dtype(t.np_dtype), np.floating):
                _require_per_tensor_io(m, t, role)
    # op inventory spans EVERY subgraph (IF/WHILE bodies included), and
    # unknown opcodes fail at load, not at first inference
    all_ops: set = set()
    for sgi in (m.subgraphs or [m]):
        all_ops.update(op.op for op in sgi.operators)
    bad = sorted(n for n in all_ops
                 if n.startswith(("UNKNOWN_", "BADCODE_"))
                 or (n.startswith("CUSTOM:") and n not in _SUPPORTED_CUSTOM))
    if bad:
        raise NotImplementedError(
            f"{os.path.basename(path)}: unsupported op(s) {', '.join(bad)}")
    ops_used = sorted(all_ops)
    low = _Lowerer(m)
    apply_params = low.build_apply()
    params = _device_params(low.params, device)
    in_info = TensorsInfo(tuple(_tensor_info(m.tensors[i]) for i in m.inputs))
    out_info = TensorsInfo(tuple(_tensor_info(m.tensors[i])
                                 for i in m.outputs))
    metadata: Dict[str, Any] = {"deployed_from": path, "format": "tflite",
                                "tflite_ops": ops_used,
                                "tflite_version": m.version}
    if all_ops & _HOST_CONTROL_FLOW:
        # a branch or trip count read on the host: never captured
        metadata["jit"] = False
    log.info("tflite import %s: %d ops (%s), %d params on %s",
             os.path.basename(path), len(m.operators), ",".join(ops_used),
             len(params), device)
    return ModelBundle(
        os.path.basename(path), lambda *xs: apply_params(params, *xs),
        device=device, in_info=in_info, out_info=out_info, metadata=metadata,
        params=params, apply_params=apply_params)
