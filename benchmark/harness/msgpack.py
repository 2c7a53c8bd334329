"""A flax ``.msgpack`` writer for a nested dict of numpy arrays, the form
``flax.serialization.to_bytes`` gives it: msgpack maps with str keys, each
array as ext type 1 holding the msgpack array (shape, dtype name, raw C
bytes). Arrays stay under flax's 1 GiB chunking size here."""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

EXT_NDARRAY = 1


def _len(n: int, out: bytearray, fix: int, fix_max: int, codes, fmts) -> None:
    if fix >= 0 and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt in zip(codes, fmts):
        if n < 1 << (8 * struct.calcsize(fmt)):
            out.append(code)
            out += struct.pack(">" + fmt, n)
            return
    raise ValueError(f"msgpack object too large ({n})")


def _int(v: int, out: bytearray) -> None:
    if 0 <= v < 128:
        out.append(v)
        return
    if v < 0:
        raise ValueError("negative ints are not written here")
    for code, fmt in ((0xCC, "B"), (0xCD, "H"), (0xCE, "I"), (0xCF, "Q")):
        if v < 1 << (8 * struct.calcsize(fmt)):
            out.append(code)
            out += struct.pack(">" + fmt, v)
            return
    raise OverflowError(v)


def _pack(obj: Any, out: bytearray) -> None:
    if isinstance(obj, dict):
        _len(len(obj), out, 0x80, 16, (0xDE, 0xDF), ("H", "I"))
        for k, v in obj.items():
            _pack(str(k), out)
            _pack(v, out)
    elif isinstance(obj, str):
        raw = obj.encode()
        _len(len(raw), out, 0xA0, 32, (0xD9, 0xDA, 0xDB), ("B", "H", "I"))
        out += raw
    elif isinstance(obj, bytes):
        _len(len(obj), out, -1, 0, (0xC4, 0xC5, 0xC6), ("B", "H", "I"))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _len(len(obj), out, 0x90, 16, (0xDC, 0xDD), ("H", "I"))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, (int, np.integer)):
        _int(int(obj), out)
    elif isinstance(obj, np.ndarray):
        body = bytearray()
        _pack([list(obj.shape), obj.dtype.name, np.ascontiguousarray(obj).tobytes()], body)
        n = len(body)
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixed:
            out.append(fixed[n])
        else:
            _len(n, out, -1, 0, (0xC7, 0xC8, 0xC9), ("B", "H", "I"))
        out.append(EXT_NDARRAY)
        out += body
    else:
        raise TypeError(f"cannot write {type(obj).__name__}")


def write(path: str, tree: dict) -> int:
    out = bytearray()
    _pack(tree, out)
    with open(path, "wb") as f:
        f.write(out)
    return len(out)
