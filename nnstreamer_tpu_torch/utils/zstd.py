"""Zstandard frames through the system's ``libzstd.so.1`` (ctypes).

Orbax checkpoint directories hold zstd everywhere: tensorstore compresses
the OCDBT manifests and b-tree nodes with it, and zarr's ``zstd`` compressor
each array chunk. Python's standard library has no zstd, and the port takes
no package for it, so this module binds the C library the operating system
ships. The library is looked up and loaded at the first call: a missing one
raises ``RuntimeError`` naming ``libzstd.so.1`` there, and nothing that
never reads or writes an orbax directory (the ``.msgpack`` route) needs it.

``decompress`` takes frames whose header carries their content size and
frames without one (tensorstore writes the latter: its chunks' frames stream
their raw blocks with no size up front), the second through the streaming
``ZSTD_decompressStream``; ``compress`` writes one frame with its content
size, which both readers take. Every library call's result goes through
``ZSTD_isError``.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading
from typing import Optional

LIBRARY = "libzstd.so.1"
#: ZSTD_getFrameContentSize's two sentinels
_UNKNOWN, _ERROR = (1 << 64) - 1, (1 << 64) - 2

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        name = ctypes.util.find_library("zstd")
        try:
            lib = ctypes.CDLL(name or LIBRARY)
        except OSError as e:
            raise RuntimeError(
                f"orbax checkpoint directories need the zstd library "
                f"{LIBRARY}, which this system lacks ({e}); install the "
                "operating system's libzstd, or use a .msgpack checkpoint"
            ) from e
        size_t, vp = ctypes.c_size_t, ctypes.c_void_p
        sigs = {
            "ZSTD_isError": (ctypes.c_uint, [size_t]),
            "ZSTD_getErrorName": (ctypes.c_char_p, [size_t]),
            "ZSTD_compressBound": (size_t, [size_t]),
            "ZSTD_compress": (size_t, [vp, size_t, vp, size_t, ctypes.c_int]),
            "ZSTD_decompress": (size_t, [vp, size_t, vp, size_t]),
            "ZSTD_getFrameContentSize": (ctypes.c_ulonglong, [vp, size_t]),
            "ZSTD_createDStream": (vp, []),
            "ZSTD_freeDStream": (size_t, [vp]),
            "ZSTD_initDStream": (size_t, [vp]),
            "ZSTD_decompressStream": (size_t, [vp, ctypes.POINTER(_OutBuffer),
                                               ctypes.POINTER(_InBuffer)]),
        }
        for fn, (res, args) in sigs.items():
            f = getattr(lib, fn)
            f.restype, f.argtypes = res, args
        _lib = lib
        return lib


def _check(lib: ctypes.CDLL, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise ValueError(f"zstd {what}: {lib.ZSTD_getErrorName(code).decode()}")
    return code


def _addr(buf) -> int:
    return ctypes.addressof((ctypes.c_char * len(buf)).from_buffer(buf)) \
        if len(buf) else 0


def compress(data: bytes, level: int = 1) -> bytes:
    """One zstd frame of ``data`` at ``level`` (content size in its
    header)."""
    lib = _load()
    src = bytearray(data)
    cap = lib.ZSTD_compressBound(len(src))
    dst = bytearray(cap)
    n = _check(lib, lib.ZSTD_compress(_addr(dst), cap, _addr(src), len(src),
                                      int(level)), "compress")
    return bytes(memoryview(dst)[:n])


def decompress(frame: bytes, size_hint: int = 0) -> bytes:
    """The bytes of the zstd frame(s) in ``frame``. ``size_hint`` (the
    expected size, 0 = unknown) sizes the output of a frame that does not
    carry its own."""
    lib = _load()
    src = bytearray(frame)
    size = lib.ZSTD_getFrameContentSize(_addr(src), len(src))
    if size == _ERROR:
        raise ValueError("zstd decompress: not a zstd frame")
    if size != _UNKNOWN:
        dst = bytearray(size)
        n = _check(lib, lib.ZSTD_decompress(_addr(dst), size, _addr(src),
                                            len(src)), "decompress")
        if n != size:
            raise ValueError(f"zstd decompress: {n} bytes, the frame "
                             f"header says {size}")
        return bytes(dst)
    return _decompress_stream(lib, src, size_hint or 4 * len(src) + 64)


def _decompress_stream(lib: ctypes.CDLL, src: bytearray, cap: int) -> bytes:
    ds = lib.ZSTD_createDStream()
    if not ds:
        raise MemoryError("ZSTD_createDStream")
    try:
        _check(lib, lib.ZSTD_initDStream(ds), "initDStream")
        dst = bytearray(max(cap, 1))
        inp = _InBuffer(_addr(src), len(src), 0)
        out = _OutBuffer(_addr(dst), len(dst), 0)
        while True:
            if out.pos == out.size:  # grow: the written part stays
                dst.extend(bytes(len(dst)))
                out = _OutBuffer(_addr(dst), len(dst), out.pos)
            before = (inp.pos, out.pos)
            ret = _check(lib, lib.ZSTD_decompressStream(
                ds, ctypes.byref(out), ctypes.byref(inp)), "decompressStream")
            if ret == 0 and inp.pos == inp.size:
                break
            if (inp.pos, out.pos) == before:
                raise ValueError("zstd decompress: the frame is truncated")
        return bytes(memoryview(dst)[:out.pos])
    finally:
        lib.ZSTD_freeDStream(ds)
