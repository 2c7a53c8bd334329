"""proto3 wire codec of ``converters/proto/tensors.proto``.

The port depends on no ``google.protobuf``, so it encodes and decodes the
two messages of the schema itself:

    message Tensor      { string name = 1; string dtype = 2;
                          repeated uint32 dims = 3; bytes data = 4; }
    message TensorFrame { int64 pts_ns = 1; int64 duration_ns = 2;
                          int64 offset = 3; repeated Tensor tensors = 4; }

Encoding is what ``SerializeToString()`` gives: fields in number order, a
field at its default (0, "", empty) left out, ``dims`` packed, an int64 as
the varint of its 64-bit two's complement (10 bytes when negative). A
payload is joined in as one slice. Decoding also takes unpacked ``dims``,
repeated scalar fields (the last one wins) and skips unknown fields; a
``data`` field comes back as a ``memoryview`` into the message.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Tuple

VARINT, I64, LEN, I32 = 0, 1, 2, 5
_MASK64 = (1 << 64) - 1


def varint(value: int) -> bytes:
    """The varint of ``value``, negative values as their 64-bit two's
    complement."""
    value &= _MASK64
    out = bytearray()
    while value > 0x7F:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def _tag(number: int, wire_type: int) -> bytes:
    return varint((number << 3) | wire_type)


def _len_field(number: int, data: Any, n: int) -> List[Any]:
    return [_tag(number, LEN), varint(n), data]


@dataclass
class TensorMsg:
    name: str = ""
    dtype: str = ""
    dims: List[int] = field(default_factory=list)
    data: Any = b""      # any contiguous buffer


@dataclass
class FrameMsg:
    pts_ns: int = 0
    duration_ns: int = 0
    offset: int = 0
    tensors: List[TensorMsg] = field(default_factory=list)


def _tensor_parts(t: TensorMsg) -> Tuple[List[Any], int]:
    parts: List[Any] = []
    for number, text in ((1, t.name), (2, t.dtype)):
        if text:
            raw = text.encode("utf-8")
            parts += _len_field(number, raw, len(raw))
    if t.dims:
        packed = b"".join(varint(int(d) & 0xFFFFFFFF) for d in t.dims)
        parts += _len_field(3, packed, len(packed))
    n = memoryview(t.data).nbytes
    if n:
        parts += _len_field(4, t.data, n)
    return parts, sum(memoryview(p).nbytes for p in parts)


def encode_frame(msg: FrameMsg) -> bytearray:
    parts: List[Any] = []
    for number, value in ((1, msg.pts_ns), (2, msg.duration_ns), (3, msg.offset)):
        if value:
            parts += [_tag(number, VARINT), varint(value)]
    for t in msg.tensors:
        tparts, n = _tensor_parts(t)
        parts += [_tag(4, LEN), varint(n)] + tparts
    return bytearray().join(parts)


# ---------------------------------------------------------------------------- #
# decoding
# ---------------------------------------------------------------------------- #

def _read_varint(buf, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("protobuf: truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result & _MASK64, pos
        shift += 7
        if shift >= 70:
            raise ValueError("protobuf: varint too long")


def _int64(value: int) -> int:
    return value - (1 << 64) if value >> 63 else value


def _fields(buf, start: int, end: int):
    """Yield (number, wire type, value) over ``buf[start:end]``: a varint's
    integer, or a LEN field's (start, end)."""
    pos = start
    while pos < end:
        key, pos = _read_varint(buf, pos)
        number, wire_type = key >> 3, key & 7
        if number == 0:
            raise ValueError("protobuf: field number 0")
        if wire_type == VARINT:
            value, pos = _read_varint(buf, pos)
        elif wire_type == LEN:
            n, pos = _read_varint(buf, pos)
            value = (pos, pos + n)
            pos += n
        elif wire_type == I64:
            value, pos = None, pos + 8
        elif wire_type == I32:
            value, pos = None, pos + 4
        else:
            raise ValueError(f"protobuf: unsupported wire type {wire_type}")
        if pos > end:
            raise ValueError("protobuf: truncated message")
        yield number, wire_type, value


def _decode_tensor(buf, start: int, end: int) -> TensorMsg:
    t = TensorMsg()
    for number, wire_type, value in _fields(buf, start, end):
        if number in (1, 2) and wire_type == LEN:
            text = bytes(buf[value[0]:value[1]]).decode("utf-8")
            if number == 1:
                t.name = text
            else:
                t.dtype = text
        elif number == 3 and wire_type == LEN:  # packed
            pos, stop = value
            while pos < stop:
                d, pos = _read_varint(buf, pos)
                t.dims.append(d & 0xFFFFFFFF)
        elif number == 3 and wire_type == VARINT:  # unpacked
            t.dims.append(value & 0xFFFFFFFF)
        elif number == 4 and wire_type == LEN:
            t.data = memoryview(buf)[value[0]:value[1]]
    return t


def decode_frame(buf) -> FrameMsg:
    """Parse a serialized ``TensorFrame`` (``bytes`` or ``bytearray``)."""
    msg = FrameMsg()
    for number, wire_type, value in _fields(buf, 0, len(buf)):
        if number in (1, 2, 3) and wire_type == VARINT:
            setattr(msg, ("pts_ns", "duration_ns", "offset")[number - 1], _int64(value))
        elif number == 4 and wire_type == LEN:
            msg.tensors.append(_decode_tensor(buf, *value))
    return msg
