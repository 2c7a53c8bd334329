"""FlexBuffers encoder and reader of the subset the tensor wire format uses.

The port depends on no ``flatbuffers`` package, so it carries its own codec
of what ``converters/fb_io.py`` writes and reads: a map with string keys, an
unsigned int with a minimum width, signed ints, strings, an untyped vector
of mixed elements, a typed vector of ints, and blobs; and of what a TFLite
custom operator's options hold (models/tflite_import.py): floats and bools.

``Builder`` reproduces ``flatbuffers.flexbuffers.Builder()`` with its
defaults byte for byte: a map's keys are sorted bytewise, repeated keys are
shared, every vector takes the narrowest byte width that holds its length
and each element (an offset's width is tried at 1, 2, 4 and 8 bytes from
where it would be written), scalars and offsets are aligned to their width,
strings get a NUL after them and blobs do not. A blob is appended as one
slice, so a payload costs one copy.

The reader follows the stock one (``GetRoot``, ``AsMap``, ``AsInt``,
``AsFloat``, ``AsString``, ``AsBlob``, ``AsVector``, ``AsTypedVector``):
``get_root`` returns a ``Ref``, whose ``as_*`` accessors read the same
values. A blob comes back as a ``memoryview`` into the buffer, without a
copy. ``loads`` is the stock ``Loads``: the root as Python values (a map a
dict, a vector a list, a bool a bool, a blob bytes).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional

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


class Builder:
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


# ---------------------------------------------------------------------------- #
# reader
# ---------------------------------------------------------------------------- #

def _uint(buf, off: int, width: int) -> int:
    return int.from_bytes(buf[off:off + width], "little")


def _sint(buf, off: int, width: int) -> int:
    return int.from_bytes(buf[off:off + width], "little", signed=True)


class Ref:
    """A value in a FlexBuffers buffer: where it sits (``off``), the width
    of its parent's slots, its own byte width and its type."""

    __slots__ = ("buf", "off", "parent_width", "byte_width", "type")

    def __init__(self, buf, off: int, parent_width: int, packed_type: int):
        self.buf, self.off, self.parent_width = buf, off, parent_width
        self.byte_width = 1 << (packed_type & 3)
        self.type = packed_type >> 2

    def _indirect(self) -> int:
        return self.off - _uint(self.buf, self.off, self.parent_width)

    def _type_error(self, target: str) -> TypeError:
        return TypeError(f"cannot convert type {self.type} to {target}")

    def _size_of(self, at: int) -> int:
        return _uint(self.buf, at - self.byte_width, self.byte_width)

    @property
    def as_int(self) -> int:
        t = self.type
        if t == NULL:
            return 0
        if t == BOOL:
            return int(_uint(self.buf, self.off, self.parent_width) != 0)
        if t == UINT:
            return _uint(self.buf, self.off, self.parent_width)
        if t == INT:
            return _sint(self.buf, self.off, self.parent_width)
        if t == INDIRECT_INT:
            return _sint(self.buf, self._indirect(), self.byte_width)
        if t == INDIRECT_UINT:
            return _uint(self.buf, self._indirect(), self.byte_width)
        if t in (STRING, KEY):
            return len(self.as_string)
        if t in (BLOB, VECTOR, MAP) or VECTOR_INT <= t <= VECTOR_STRING_DEPRECATED \
                or t == VECTOR_BOOL:
            return self._size_of(self._indirect())
        if VECTOR_INT2 <= t <= VECTOR_FLOAT4:
            return (t - VECTOR_INT2) // 3 + 2
        raise self._type_error("int")

    @property
    def as_float(self) -> float:
        t = self.type
        if t == FLOAT:
            return struct.unpack_from(_FLOAT_FMT[self.parent_width], self.buf,
                                      self.off)[0]
        if t == INDIRECT_FLOAT:
            return struct.unpack_from(_FLOAT_FMT[self.byte_width], self.buf,
                                      self._indirect())[0]
        if t in (NULL, BOOL, INT, UINT, INDIRECT_INT, INDIRECT_UINT):
            return float(self.as_int)
        raise self._type_error("float")

    @property
    def value(self) -> Any:
        """The value as Python objects, as the stock ``Loads`` gives it."""
        t = self.type
        if t == NULL:
            return None
        if t == BOOL:
            return self.as_int != 0
        if t in (INT, UINT, INDIRECT_INT, INDIRECT_UINT):
            return self.as_int
        if t in (FLOAT, INDIRECT_FLOAT):
            return self.as_float
        if t in (STRING, KEY):
            return self.as_string
        if t == BLOB:
            return bytes(self.as_blob)
        if t == MAP:
            m = self.as_map
            keys = m.keys()
            return {keys[i].as_string: Vector.__getitem__(m, i).value
                    for i in range(len(m))}
        if t == VECTOR:
            v = self.as_vector
            return [v[i].value for i in range(len(v))]
        if VECTOR_INT <= t <= VECTOR_STRING_DEPRECATED or t == VECTOR_BOOL:
            v = self.as_typed_vector
            return [v[i].value for i in range(len(v))]
        raise self._type_error("a Python value")

    @property
    def as_key_bytes(self) -> bytes:
        if self.type != KEY:
            raise self._type_error("key")
        start = self._indirect()
        return bytes(self.buf[start:self.buf.index(0, start)])

    @property
    def as_string(self) -> str:
        if self.type == KEY:
            return self.as_key_bytes.decode("ascii")
        if self.type != STRING:
            raise self._type_error("string")
        start = self._indirect()
        return bytes(self.buf[start:start + self._size_of(start)]).decode("utf-8")

    @property
    def as_blob(self) -> memoryview:
        if self.type != BLOB:
            raise self._type_error("blob")
        start = self._indirect()
        return memoryview(self.buf)[start:start + self._size_of(start)]

    @property
    def as_vector(self) -> "Vector":
        if self.type not in (VECTOR, MAP):
            raise self._type_error("vector")
        return Vector(self.buf, self._indirect(), self.byte_width)

    @property
    def as_typed_vector(self) -> "TypedVector":
        t = self.type
        if not (VECTOR_INT <= t <= VECTOR_STRING_DEPRECATED or t == VECTOR_BOOL):
            raise self._type_error("typed vector")
        elem = t - VECTOR_INT + INT
        return TypedVector(self.buf, self._indirect(), self.byte_width,
                           KEY if elem == STRING else elem)

    @property
    def as_map(self) -> "Map":
        if self.type != MAP:
            raise self._type_error("map")
        return Map(self.buf, self._indirect(), self.byte_width)


class Vector:
    """An untyped vector: slots of ``byte_width`` bytes, then a packed type
    byte for each element."""

    __slots__ = ("buf", "off", "byte_width", "size")

    def __init__(self, buf, off: int, byte_width: int):
        self.buf, self.off, self.byte_width = buf, off, byte_width
        self.size = _uint(buf, off - byte_width, byte_width)

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, index: int) -> Ref:
        if not 0 <= index < self.size:
            raise IndexError(f"vector index {index} is out of [0, {self.size}) range")
        packed = self.buf[self.off + self.size * self.byte_width + index]
        return Ref(self.buf, self.off + index * self.byte_width, self.byte_width, packed)


class TypedVector:
    """A vector whose elements share one type and width."""

    __slots__ = ("buf", "off", "byte_width", "size", "elem")

    def __init__(self, buf, off: int, byte_width: int, elem: int):
        self.buf, self.off, self.byte_width, self.elem = buf, off, byte_width, elem
        self.size = _uint(buf, off - byte_width, byte_width)

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, index: int) -> Ref:
        if not 0 <= index < self.size:
            raise IndexError(f"vector index {index} is out of [0, {self.size}) range")
        return Ref(self.buf, self.off + index * self.byte_width, self.byte_width,
                   self.elem << 2)


class Map(Vector):
    """A map: the values vector, preceded by the offset and byte width of
    its sorted keys vector. Lookup is a binary search over the keys."""

    def keys(self) -> TypedVector:
        w = self.byte_width
        keys_width = _uint(self.buf, self.off - 2 * w, w)
        at = self.off - 3 * w
        return TypedVector(self.buf, at - _uint(self.buf, at, w), keys_width, KEY)

    def __getitem__(self, key):
        if isinstance(key, int):
            return super().__getitem__(key)
        want = key.encode("ascii")
        keys = self.keys()
        lo, hi = 0, len(keys)
        while lo < hi:
            mid = (lo + hi) // 2
            if keys[mid].as_key_bytes < want:
                lo = mid + 1
            else:
                hi = mid
        if lo < len(keys) and keys[lo].as_key_bytes == want:
            return super().__getitem__(lo)
        raise KeyError(key)


def get_root(buf) -> Ref:
    """The root value of a finished buffer (``bytes`` or ``bytearray``)."""
    if len(buf) < 3:
        raise ValueError("buffer is too small")
    byte_width = buf[-1]
    return Ref(buf, len(buf) - 2 - byte_width, byte_width, buf[-2])


def loads(buf) -> Any:
    """The root of ``buf`` as Python values (stock ``Loads``)."""
    return get_root(buf).value
