"""FlexBuffers / FlatBuffers tensor serialization (decoder + converter pairs).

Port of nnstreamer_tpu/converters/fb_io.py on the port's own codecs
(``flexbuf_codec``, ``flatbuf_codec``): no ``flatbuffers`` package is
needed, so both formats register unconditionally. A blob is byte-identical
to the JAX package's for the same frame.

Reference-exact wire layouts, interoperable with upstream peers:

* FlexBuffers (tensordec-flexbuf.cc:26-33, tensor_converter_flexbuf.cc:107-146):
  ``Map { "num_tensors": UInt, "rate_n": Int, "rate_d": Int, "format": Int,
  "tensor_#i": Vector[ String name, Int type_enum, TypedVector dims(rank 4),
  Blob data ] }`` — dims zero-rank-padded with 1 to NNS_TENSOR_RANK_LIMIT=4
  (tensor_typedef.h:34), dtype as the reference ``tensor_type`` enum
  (tensor_typedef.h:155-166).

* FlatBuffers (ext/nnstreamer/include/nnstreamer.fbs:12-53):
  ``table Tensors { num_tensor:int; fr:frame_rate(struct rate_n,rate_d);
  tensor:[Tensor]; format:Tensor_format }``,
  ``table Tensor { name:string; type:Tensor_type; dimension:[uint32];
  data:[ubyte] }`` — field slots matching flatc's vtable layout for that
  schema.

Payloads go in and out as one slice each; only the headers are built field
by field.
"""

from __future__ import annotations

import struct
from fractions import Fraction
from typing import List, Tuple

import numpy as np

from ..core.buffer import Buffer, TensorMemory
from ..core.types import (
    Caps,
    TensorDType,
    TensorFormat,
    TensorInfo,
    TensorsConfig,
    TensorsInfo,
)
from ..decoders.base import Decoder, register_decoder
from . import (
    flatbuf_codec,
    flexbuf_codec,
    payload_view,
    register_converter,
    wire_bytes,
)

#: NNS_TENSOR_RANK_LIMIT (tensor_typedef.h:34)
RANK_LIMIT = 4
#: NNS_TENSOR_SIZE_LIMIT
SIZE_LIMIT = 16

#: reference ``tensor_type`` enum (tensor_typedef.h:155-166; identical to
#: nnstreamer.fbs Tensor_type)
_DTYPE_TO_ENUM = {
    TensorDType.INT32: 0, TensorDType.UINT32: 1,
    TensorDType.INT16: 2, TensorDType.UINT16: 3,
    TensorDType.INT8: 4, TensorDType.UINT8: 5,
    TensorDType.FLOAT64: 6, TensorDType.FLOAT32: 7,
    TensorDType.INT64: 8, TensorDType.UINT64: 9,
}
_ENUM_TO_DTYPE = {v: k for k, v in _DTYPE_TO_ENUM.items()}
_FORMAT_TO_ENUM = {TensorFormat.STATIC: 0, TensorFormat.FLEXIBLE: 1,
                   TensorFormat.SPARSE: 2}
#: nnstreamer.fbs Tensor.type's default (NNS_END): the builder leaves a
#: field equal to it out
_TYPE_DEFAULT = 10


def _dtype_enum(info: TensorInfo) -> int:
    e = _DTYPE_TO_ENUM.get(info.dtype)
    if e is None:
        raise ValueError(
            f"dtype {info.dtype} has no reference tensor_type enum value "
            "(bf16/f16 are TPU-local; typecast before serializing)")
    return e


def _padded_dims(info: TensorInfo) -> List[int]:
    dims = [int(d) for d in info.dims[:RANK_LIMIT]]
    if len(info.dims) > RANK_LIMIT:
        raise ValueError(
            f"rank {len(info.dims)} exceeds the wire format's "
            f"NNS_TENSOR_RANK_LIMIT={RANK_LIMIT}")
    return dims + [1] * (RANK_LIMIT - len(dims))


def _trimmed_info(dims: Tuple[int, ...], type_enum: int,
                  name: str) -> TensorInfo:
    dt = _ENUM_TO_DTYPE.get(type_enum)
    if dt is None:
        raise ValueError(f"unknown tensor_type enum {type_enum}")
    trimmed = list(dims)
    while len(trimmed) > 1 and trimmed[-1] in (1, 0):
        trimmed.pop()
    if any(d <= 0 for d in trimmed):
        raise ValueError(f"invalid dimension {dims}")
    return TensorInfo(tuple(trimmed), dt, name or None)


def _frame_memory(payload, info: TensorInfo, fmt: str, i: int) -> TensorMemory:
    n = memoryview(payload).nbytes
    if n != info.size_bytes:
        raise ValueError(
            f"{fmt} tensor {i}: {n} payload bytes for "
            f"{info.dim_string}:{info.dtype} ({info.size_bytes} expected)")
    return TensorMemory.from_bytes(payload, info)


def _rate_and_format(config: TensorsConfig) -> Tuple[Fraction, TensorFormat]:
    rate = config.rate if config is not None and config.rate else Fraction(0, 1)
    fmt = config.info.format if config is not None else TensorFormat.STATIC
    return rate, fmt


# ---------------------------------------------------------------------------- #
# FlexBuffers (schema-less)
# ---------------------------------------------------------------------------- #

def flexbuf_blob(buf: Buffer, config: TensorsConfig = None) -> bytearray:
    """``frame_to_flexbuf`` into a fresh ``bytearray`` (no final copy)."""
    rate, fmt = _rate_and_format(config)
    b = flexbuf_codec.Builder()
    top = b.start()
    b.key("num_tensors"); b.uint(len(buf.memories), 4)
    b.key("rate_n"); b.sint(rate.numerator)
    b.key("rate_d"); b.sint(rate.denominator)
    b.key("format"); b.sint(_FORMAT_TO_ENUM.get(fmt, 0))
    for i, m in enumerate(buf.memories):
        b.key(f"tensor_{i}")
        vec = b.start()
        b.string(m.info.name or "")
        b.sint(_dtype_enum(m.info))
        b.typed_vector_ints(_padded_dims(m.info))
        b.blob(payload_view(m))
        b.end_vector(vec)
    b.end_map(top)
    return b.finish()


def frame_to_flexbuf(buf: Buffer, config: TensorsConfig = None) -> bytes:
    return bytes(flexbuf_blob(buf, config))


def flexbuf_to_frame(data: bytes) -> Tuple[Buffer, Fraction]:
    if not isinstance(data, (bytes, bytearray)):
        data = bytes(data)
    root = flexbuf_codec.get_root(data).as_map
    num = root["num_tensors"].as_int
    if num < 0 or num > SIZE_LIMIT:
        raise ValueError(f"flexbuf: num_tensors {num} out of range")
    rate = Fraction(root["rate_n"].as_int, max(root["rate_d"].as_int, 1))
    mems: List[TensorMemory] = []
    for i in range(num):
        t = root[f"tensor_{i}"].as_vector
        dims = tuple(e.as_int for e in t[2].as_typed_vector)
        info = _trimmed_info(dims, t[1].as_int, t[0].as_string)
        mems.append(_frame_memory(t[3].as_blob, info, "flexbuf", i))
    return Buffer(mems), rate


# ---------------------------------------------------------------------------- #
# FlatBuffers (nnstreamer.fbs layout)
# ---------------------------------------------------------------------------- #

def flatbuf_blob(buf: Buffer, config: TensorsConfig = None) -> bytearray:
    """``frame_to_flatbuf`` into a fresh ``bytearray``."""
    rate, fmt = _rate_and_format(config)
    payloads = [payload_view(m) for m in buf.memories]
    b = flatbuf_codec.Builder(sum(p.nbytes for p in payloads) + 1024)
    tensor_offs = []
    for m, payload in zip(buf.memories, payloads):
        name = b.create_string(m.info.name or "")
        data = b.create_byte_vector(payload)
        dims = _padded_dims(m.info)
        b.start_vector(4, len(dims), 4)
        for d in reversed(dims):
            b.prepend_uint32(d)
        dims_off = b.end_vector()
        # table Tensor { name:0, type:1 (default NNS_END=10),
        #               dimension:2, data:3 }
        b.start_object(4)
        b.add_uoffset(0, name)
        b.add_int32(1, _dtype_enum(m.info), _TYPE_DEFAULT)
        b.add_uoffset(2, dims_off)
        b.add_uoffset(3, data)
        tensor_offs.append(b.end_object())
    b.start_vector(4, len(tensor_offs), 4)
    for off in reversed(tensor_offs):
        b.prepend_uoffset(off)
    tvec = b.end_vector()
    # table Tensors { num_tensor:0, fr:1 (inline struct), tensor:2, format:3 }
    b.start_object(4)
    b.add_int32(0, len(tensor_offs), 0)
    b.prep(4, 8)  # struct frame_rate { rate_n:int; rate_d:int }
    b.prepend_int32(rate.denominator)
    b.prepend_int32(rate.numerator)
    b.add_struct(1, b.offset())
    b.add_uoffset(2, tvec)
    b.add_int32(3, _FORMAT_TO_ENUM.get(fmt, 0), 0)
    return b.finish(b.end_object())


def frame_to_flatbuf(buf: Buffer, config: TensorsConfig = None) -> bytes:
    return bytes(flatbuf_blob(buf, config))


def flatbuf_to_frame(data: bytes) -> Tuple[Buffer, Fraction]:
    if not isinstance(data, (bytes, bytearray)):
        data = bytes(data)
    root = flatbuf_codec.Table.root(data)
    # fr: inline frame_rate struct at slot 1
    fo = root.field(1)
    rate_n, rate_d = struct.unpack_from("<ii", data, root.pos + fo) if fo else (0, 0)
    rate = Fraction(rate_n, max(rate_d, 1))
    num = root.int32(0)
    start, n = root.vector(2)
    if num and num != n:
        raise ValueError(f"flatbuf: num_tensor {num} != vector length {n}")
    mems: List[TensorMemory] = []
    for i in range(n):
        t = root.table_at(start + 4 * i)
        name = t.string(0)
        type_enum = t.int32(1, _TYPE_DEFAULT)
        ds, dn = t.vector(2)
        dims = struct.unpack_from(f"<{dn}I", data, ds)
        ps, pn = t.vector(3)
        info = _trimmed_info(dims, type_enum, name)
        mems.append(_frame_memory(memoryview(data)[ps:ps + pn], info, "flatbuf", i))
    return Buffer(mems), rate


# ---------------------------------------------------------------------------- #
# element plumbing: decoder modes + converter subplugins
# ---------------------------------------------------------------------------- #

class _SerializeDecoder(Decoder):
    ENCODE = None  # staticmethod set by subclass

    def out_caps(self, config: TensorsConfig) -> Caps:
        # reference media names (``other/flexbuf`` etc.): tensor_converter
        # auto-dispatches the matching converter subplugin from these, so
        # ``tensor_decoder mode=flexbuf ! other/flexbuf !
        # tensor_converter`` chains run verbatim
        return Caps(f"other/{self.MODE}")

    def decode(self, buf: Buffer, config: TensorsConfig) -> Buffer:
        blob = type(self).ENCODE(buf, config)
        arr = np.frombuffer(blob, np.uint8)
        return buf.with_memories([TensorMemory(arr if arr.flags.writeable
                                               else arr.copy())])


@register_decoder
class FlexBufDecoder(_SerializeDecoder):
    """tensors → FlexBuffers blobs (tensordec-flexbuf.cc layout)."""

    MODE = "flexbuf"
    ENCODE = staticmethod(flexbuf_blob)


@register_decoder
class FlatBufDecoder(_SerializeDecoder):
    """tensors → FlatBuffers frames (nnstreamer.fbs layout)."""

    MODE = "flatbuf"
    ENCODE = staticmethod(flatbuf_blob)


def _make_converter(parse):
    def convert(buf: Buffer, props) -> tuple:
        frame, rate = parse(wire_bytes(buf))
        cfg = TensorsConfig(TensorsInfo(tuple(m.info for m in frame.memories)),
                            rate)
        return frame.memories, cfg
    return convert


register_converter("flexbuf", _make_converter(flexbuf_to_frame))
register_converter("flatbuf", _make_converter(flatbuf_to_frame))
