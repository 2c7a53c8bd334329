"""Frozen copy of the Builder classes of nnstreamer_tpu_torch/converters/flatbuf_codec.py and flexbuf_codec.py (the .tflite writer's).

The benchmark writes its model files with these copies, so a later change
to the program's codecs cannot change the file the benchmark serves.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

_I32 = struct.Struct("<i")
_U32 = struct.Struct("<I")
_U16 = struct.Struct("<H")
I8 = struct.Struct("<b")
U8 = struct.Struct("<B")
U32 = _U32
I32 = _I32
I64 = struct.Struct("<q")
F32 = struct.Struct("<f")


class Builder:
    """A back-to-front buffer. Offsets returned by the ``create_*``,
    ``end_*`` and ``offset`` methods count bytes from the buffer's end."""

    def __init__(self, capacity: int = 1024):
        self._buf = bytearray(max(capacity, 16))
        self._head = len(self._buf)
        self._minalign = 1
        self._vtable: Optional[List[int]] = None
        self._object_end = 0
        self._vtables: Dict[Tuple[int, ...], int] = {}
        self._vector_len = 0

    # -- space and alignment ----------------------------------------------- #
    def offset(self) -> int:
        return len(self._buf) - self._head

    def _grow(self, needed: int) -> None:
        size = len(self._buf)
        new = max(size * 2, size + needed)
        grown = bytearray(new)
        grown[new - size:] = self._buf
        self._head += new - size
        self._buf = grown

    def prep(self, size: int, additional: int) -> None:
        """Align so that a ``size``-byte scalar can be written after
        ``additional`` more bytes, growing the buffer as needed."""
        self._minalign = max(self._minalign, size)
        align = -(self.offset() + additional) & (size - 1)
        needed = align + size + additional
        if self._head < needed:
            self._grow(needed)
        self._head -= align
        self._buf[self._head:self._head + align] = bytes(align)

    def _place(self, packer: struct.Struct, value: int) -> None:
        self._head -= packer.size
        packer.pack_into(self._buf, self._head, value)

    def prepend_int32(self, value: int) -> None:
        self.prep(4, 0)
        self._place(_I32, value)

    def prepend_uint32(self, value: int) -> None:
        self.prep(4, 0)
        self._place(_U32, value)

    def prepend(self, packer: struct.Struct, value: Any) -> None:
        """One scalar of ``packer``'s format (``I8``, ``U8``, ``U32``,
        ``I64``, ``F32``, ...), aligned to its size."""
        self.prep(packer.size, 0)
        self._place(packer, value)

    def prepend_uoffset(self, off: int) -> None:
        """A uoffset to ``off``, relative to where it is written."""
        self.prep(4, 0)
        if off > self.offset():
            raise ValueError("flatbuffers: offset arithmetic error")
        self._place(_U32, self.offset() - off + 4)

    # -- vectors and strings ------------------------------------------------ #
    def start_vector(self, elem_size: int, count: int, alignment: int) -> None:
        self._vector_len = count
        self.prep(4, elem_size * count)
        self.prep(alignment, elem_size * count)

    def end_vector(self) -> int:
        self._place(_U32, self._vector_len)
        return self.offset()

    def _create_bytes(self, data: Any, n: int, terminate: bool) -> int:
        self.prep(4, n + terminate)
        if terminate:
            self._head -= 1
            self._buf[self._head] = 0
        self._head -= n
        self._buf[self._head:self._head + n] = memoryview(data).cast("B")
        self._vector_len = n
        return self.end_vector()

    def create_vector(self, packer: struct.Struct, values: Any) -> int:
        """A vector of scalars of ``packer``'s format."""
        values = list(values)
        self.start_vector(packer.size, len(values), packer.size)
        for v in reversed(values):
            self._place(packer, v)
        return self.end_vector()

    def create_offset_vector(self, offsets: Any) -> int:
        """A vector of uoffsets (tables or strings written earlier)."""
        offsets = list(offsets)
        self.start_vector(4, len(offsets), 4)
        for off in reversed(offsets):
            self.prepend_uoffset(off)
        return self.end_vector()

    def create_string(self, s: str) -> int:
        data = s.encode("utf-8")
        return self._create_bytes(data, len(data), True)

    def create_byte_vector(self, data: Any) -> int:
        """``data``: any contiguous buffer; copied in as one slice."""
        return self._create_bytes(data, memoryview(data).nbytes, False)

    # -- tables ------------------------------------------------------------- #
    def start_object(self, num_fields: int) -> None:
        self._vtable = [0] * num_fields
        self._object_end = self.offset()

    def _slot(self, slot: int) -> None:
        self._vtable[slot] = self.offset()

    def add_int32(self, slot: int, value: int, default: int) -> None:
        if value != default:
            self.prepend_int32(value)
            self._slot(slot)

    def add_scalar(self, slot: int, packer: struct.Struct, value: Any,
                   default: Any) -> None:
        if value != default:
            self.prepend(packer, value)
            self._slot(slot)

    def add_uoffset(self, slot: int, off: int, default: int = 0) -> None:
        if off != default:
            self.prepend_uoffset(off)
            self._slot(slot)

    def add_struct(self, slot: int, off: int, default: int = 0) -> None:
        """A struct written inline just before this call (at ``off``)."""
        if off != default:
            if off != self.offset():
                raise ValueError("flatbuffers: a struct must be written inline")
            self._slot(slot)

    def end_object(self) -> int:
        self.prepend_int32(0)  # the soffset to the vtable, patched below
        obj = self.offset()
        fields = self._vtable
        while fields and fields[-1] == 0:
            fields = fields[:-1]
        rel = [obj - f if f else 0 for f in fields]
        size = obj - self._object_end
        key = tuple(reversed(rel)) + (size,)
        shared = self._vtables.get(key)
        if shared is None:
            for r in reversed(rel):
                self.prep(2, 0)
                self._place(_U16, r)
            self.prep(2, 0)
            self._place(_U16, size)
            self.prep(2, 0)
            self._place(_U16, (len(rel) + 2) * 2)
            _I32.pack_into(self._buf, len(self._buf) - obj, self.offset() - obj)
            self._vtables[key] = self.offset()
        else:
            _I32.pack_into(self._buf, len(self._buf) - obj, shared - obj)
        self._vtable = None
        return obj

    def finish(self, root: int, file_identifier: Optional[bytes] = None
               ) -> bytearray:
        """Prepend the root offset, after a 4-byte ``file_identifier`` when
        one is given (``b"TFL3"``)."""
        if file_identifier is None:
            self.prep(self._minalign, 4)
        else:
            if len(file_identifier) != 4:
                raise ValueError("flatbuffers: a file identifier is 4 bytes")
            self.prep(self._minalign, 8)
            self.prep(4, 4)
            self._head -= 4
            self._buf[self._head:self._head + 4] = file_identifier
        self.prepend_uoffset(root)
        return self._buf[self._head:]


# bit widths (the low 2 bits of a packed type)
W8, W16, W32, W64 = 0, 1, 2, 3

# value types (the high 6 bits of a packed type)
NULL, INT, UINT, FLOAT, KEY, STRING = 0, 1, 2, 3, 4, 5
INDIRECT_INT, INDIRECT_UINT, INDIRECT_FLOAT, MAP, VECTOR = 6, 7, 8, 9, 10
VECTOR_INT, VECTOR_UINT, VECTOR_FLOAT, VECTOR_KEY = 11, 12, 13, 14
VECTOR_STRING_DEPRECATED = 15
VECTOR_INT2, VECTOR_FLOAT4 = 16, 24
BLOB, BOOL, VECTOR_BOOL = 25, 26, 36


def _width_u(value: int) -> int:
    """The narrowest bit width of an unsigned value."""
    if value < 0:
        raise ValueError(f"negative unsigned value {value}")
    if value < 1 << 8:
        return W8
    if value < 1 << 16:
        return W16
    if value < 1 << 32:
        return W32
    if value < 1 << 64:
        return W64
    raise ValueError(f"value is too big to encode: {value}")


def _width_i(value: int) -> int:
    """The narrowest bit width of a signed value."""
    value *= 2
    return _width_u(value if value >= 0 else ~value)


_BYTES_TO_WIDTH = {1: W8, 2: W16, 4: W32, 8: W64}


def _width_f(value: float) -> int:
    """float32 when the value survives it, else float64 (stock ``F``)."""
    return W32 if struct.unpack("<f", struct.pack("<f", value))[0] == value \
        else W64


_FLOAT_FMT = {4: "<f", 8: "<d"}


def _padding(size: int, scalar_size: int) -> int:
    return -size & (scalar_size - 1)


def _is_inline(type_: int) -> bool:
    return type_ <= FLOAT or type_ == BOOL


class _Value:
    """A value on the builder's stack: an inline scalar, or the absolute
    offset of what was written (string, blob, vector, map, key)."""

    __slots__ = ("value", "type", "min_width")

    def __init__(self, value: Any, type_: int, min_width: int):
        self.value, self.type, self.min_width = value, type_, min_width

    def elem_width(self, buf_size: int, elem_index: int = 0) -> int:
        if _is_inline(self.type):
            return self.min_width
        for byte_width in (1, 2, 4, 8):
            loc = buf_size + _padding(buf_size, byte_width) + elem_index * byte_width
            width = _width_u(loc - self.value)
            if byte_width == 1 << width:
                return width
        raise ValueError("relative offset is too big")

    def stored_width(self, parent_width: int = W8) -> int:
        if _is_inline(self.type):
            return max(self.min_width, parent_width)
        return self.min_width

    def packed_type(self, parent_width: int = W8) -> int:
        return (self.type << 2) | self.stored_width(parent_width)


class FlexBuilder:
    """Encode one root value. Scalars, strings, blobs and keys push a value;
    ``start()`` marks a nesting level, which ``end_vector``/``end_map`` turn
    into one vector or map value; ``finish()`` writes the root."""

    def __init__(self) -> None:
        self._buf = bytearray()
        self._stack: List[_Value] = []
        self._keys: Dict[bytes, int] = {}

    # -- low level --------------------------------------------------------- #
    def _align(self, width: int) -> int:
        byte_width = 1 << width
        self._buf.extend(bytes(_padding(len(self._buf), byte_width)))
        return byte_width

    def _write_uint(self, value: int, byte_width: int) -> None:
        self._buf.extend(value.to_bytes(byte_width, "little"))

    def _write_any(self, v: _Value, byte_width: int) -> None:
        if v.type == INT:
            self._buf.extend(v.value.to_bytes(byte_width, "little", signed=True))
        elif v.type in (UINT, BOOL, NULL):
            self._write_uint(v.value, byte_width)
        elif v.type == FLOAT:
            self._buf.extend(struct.pack(_FLOAT_FMT[byte_width], v.value))
        else:
            self._write_uint(len(self._buf) - v.value, byte_width)

    def _write_blob(self, data: Any, append_zero: bool, type_: int) -> None:
        n = memoryview(data).nbytes
        width = _width_u(n)
        byte_width = self._align(width)
        self._write_uint(n, byte_width)
        loc = len(self._buf)
        self._buf.extend(data)
        if append_zero:
            self._buf.append(0)
        self._stack.append(_Value(loc, type_, width))

    def _create_vector(self, elems: List[_Value], typed: bool,
                       keys: Optional[_Value] = None) -> _Value:
        length = len(elems)
        width = _width_u(length)
        prefix = 1
        if keys is not None:
            width = max(width, keys.elem_width(len(self._buf)))
            prefix += 2
        vector_type = KEY
        for i, e in enumerate(elems):
            width = max(width, e.elem_width(len(self._buf), prefix + i))
            if typed:
                if i == 0:
                    vector_type = e.type
                elif e.type != vector_type:
                    raise RuntimeError("typed vector elements must be of the same type")
        byte_width = self._align(width)
        if keys is not None:
            self._write_uint(len(self._buf) - keys.value, byte_width)
            self._write_uint(1 << keys.min_width, byte_width)
        self._write_uint(length, byte_width)
        loc = len(self._buf)
        for e in elems:
            self._write_any(e, byte_width)
        if not typed:
            self._buf.extend(bytes(e.packed_type(width) for e in elems))
        if keys is not None:
            type_ = MAP
        elif typed:
            type_ = vector_type - INT + VECTOR_INT
        else:
            type_ = VECTOR
        return _Value(loc, type_, width)

    # -- values ------------------------------------------------------------ #
    def key(self, name: str) -> None:
        encoded = name.encode("ascii")
        if 0 in encoded:
            raise ValueError("key contains zero byte")
        loc = self._keys.get(encoded)
        if loc is None:
            loc = len(self._buf)
            self._buf.extend(encoded)
            self._buf.append(0)
            self._keys[encoded] = loc
        self._stack.append(_Value(loc, KEY, W8))

    def sint(self, value: int, byte_width: int = 0) -> None:
        width = _width_i(value) if byte_width == 0 else _BYTES_TO_WIDTH[byte_width]
        self._stack.append(_Value(int(value), INT, width))

    def uint(self, value: int, byte_width: int = 0) -> None:
        width = _width_u(value) if byte_width == 0 else _BYTES_TO_WIDTH[byte_width]
        self._stack.append(_Value(int(value), UINT, width))

    def float(self, value: float) -> None:
        """A float, 4 bytes wide when float32 holds it exactly, else 8."""
        self._stack.append(_Value(value, FLOAT, _width_f(value)))

    def bool(self, value: bool) -> None:
        self._stack.append(_Value(int(bool(value)), BOOL, W8))

    def string(self, value: str) -> None:
        self._write_blob(value.encode("utf-8"), True, STRING)

    def blob(self, data: Any) -> None:
        """``data``: any contiguous buffer (bytes, memoryview, a numpy
        array's ``memoryview(...).cast("B")``); appended as one slice."""
        self._write_blob(data, False, BLOB)

    def typed_vector_ints(self, values) -> None:
        """``TypedVectorFromElements`` of Python ints: each element takes its
        own signed width, the vector the widest."""
        start = self.start()
        for v in values:
            self.sint(int(v))
        self._end(start, typed=True)

    # -- nesting ----------------------------------------------------------- #
    def start(self) -> int:
        return len(self._stack)

    def _end(self, start: int, typed: bool) -> None:
        vec = self._create_vector(self._stack[start:], typed)
        del self._stack[start:]
        self._stack.append(vec)

    def end_vector(self, start: int) -> None:
        self._end(start, typed=False)

    def end_map(self, start: int) -> None:
        stack = self._stack[start:]
        if len(stack) % 2:
            raise RuntimeError("must be even number of keys and values")
        pairs = sorted(zip(stack[::2], stack[1::2]),
                       key=lambda kv: self._read_key(kv[0].value))
        del self._stack[start:]
        keys = self._create_vector([k for k, _ in pairs], typed=True)
        self._stack.append(
            self._create_vector([v for _, v in pairs], typed=False, keys=keys))

    def _read_key(self, loc: int) -> bytes:
        return bytes(self._buf[loc:self._buf.index(0, loc)])

    def finish(self) -> bytearray:
        if len(self._stack) != 1:
            raise RuntimeError("internal stack size must be one")
        root = self._stack[0]
        byte_width = self._align(root.elem_width(len(self._buf)))
        self._write_any(root, byte_width)
        self._buf.append(root.packed_type())
        self._buf.append(byte_width)
        return self._buf

