"""FlatBuffers builder and table reader for the tensor frame schema.

The port depends on no ``flatbuffers`` package, so it carries the part of
the runtime that ``converters/fb_io.py`` uses for ``nnstreamer.fbs``, and
what a writer of TFLite models needs besides (``chip_smoke.py``'s
``.tflite`` writer: 8-bit, float and 64-bit scalars, numeric and offset
vectors, a file identifier):

  * ``Builder`` writes back to front as ``flatbuffers.Builder`` does: every
    scalar aligned to its size from the end of the buffer, strings with a
    NUL, byte vectors copied as one slice, a table's fields prepended in the
    order they are given, a field equal to its default left out, and a
    vtable shared with an earlier identical one (same fields at the same
    offsets, same object size). ``finish`` aligns to the largest scalar
    written and prepends the root offset. For the same calls the output is
    byte-identical to the stock builder's.
  * ``Table`` reads a table as ``flatbuffers.table.Table`` does: a field's
    vtable slot, its scalar, its vector's start and length, a string, a
    nested table.

All offsets are 4-byte little-endian: uoffsets point forward from where
they are stored, a table's soffset to its vtable backward (or forward when
the vtable is shared), vtable entries are 2-byte offsets from the table.
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


class Table:
    """A table at ``pos`` in ``buf`` (a ``bytes``-like object)."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf, pos: int):
        self.buf, self.pos = buf, pos

    @classmethod
    def root(cls, buf) -> "Table":
        return cls(buf, _U32.unpack_from(buf, 0)[0])

    def field(self, slot: int) -> int:
        """The field's offset from the table, 0 when it is absent."""
        vtable = self.pos - _I32.unpack_from(self.buf, self.pos)[0]
        entry = 4 + 2 * slot
        if entry < _U16.unpack_from(self.buf, vtable)[0]:
            return _U16.unpack_from(self.buf, vtable + entry)[0]
        return 0

    def int32(self, slot: int, default: int = 0) -> int:
        o = self.field(slot)
        return _I32.unpack_from(self.buf, self.pos + o)[0] if o else default

    def _indirect(self, at: int) -> int:
        return at + _U32.unpack_from(self.buf, at)[0]

    def vector(self, slot: int) -> Tuple[int, int]:
        """(start of the elements, count) of a vector field; (0, 0) when
        absent."""
        o = self.field(slot)
        if not o:
            return 0, 0
        at = self._indirect(self.pos + o)
        return at + 4, _U32.unpack_from(self.buf, at)[0]

    def string(self, slot: int) -> str:
        start, n = self.vector(slot)
        return bytes(self.buf[start:start + n]).decode("utf-8") if n else ""

    def table_at(self, at: int) -> "Table":
        """The table a uoffset stored at ``at`` points to (a vector of
        tables holds one such offset an element)."""
        return Table(self.buf, self._indirect(at))
