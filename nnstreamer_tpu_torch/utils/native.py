"""ctypes bridge to the native runtime: the sparse COO codec, the aligned
allocator and the lock-free SPSC ring.

Port of nnstreamer_tpu/utils/native.py. The library is
``native/nns_runtime.cpp`` at the root of the repository, built at first
use with g++ into ``nnstreamer_tpu_torch/_build/libnns_runtime-<hash>.so``
(the hash covers the source and the flags, so an edit rebuilds; the
source's own directory is left alone). Without g++, or for an item size
the library does not take, the codec runs numpy and ``aligned_empty``
numpy's allocator, as the JAX bridge does: that path is part of their
contract, not a device fallback. ``SpscRing`` needs the library and raises
without it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from ..core.log import logger

log = logger("native")

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SRC = os.path.join(_ROOT, "native", "nns_runtime.cpp")
BUILD_DIR = os.path.join(_ROOT, "nnstreamer_tpu_torch", "_build")
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _target() -> str:
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libnns_runtime-{digest.hexdigest()[:12]}.so")


def _build() -> Optional[str]:
    """Build the library unless it is built; None without g++. Each build
    writes a file of its own and renames it into place, so processes that
    build at once do not read a half-written library."""
    target = _target()
    if os.path.isfile(target):
        return target
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.tmp{os.getpid()}"
    try:
        subprocess.run(["g++", *FLAGS, SRC, "-o", tmp],
                       check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError) as e:
        log.info("native runtime build unavailable: %s", e)
        return None
    os.replace(tmp, target)
    return target


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built at the first call; None without g++."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = _build()
        if so is None:
            return None
        lib = ctypes.CDLL(so)
        lib.nns_aligned_alloc.restype = ctypes.c_void_p
        lib.nns_aligned_alloc.argtypes = [ctypes.c_size_t, ctypes.c_size_t]
        lib.nns_aligned_free.argtypes = [ctypes.c_void_p]
        lib.nns_ring_create.restype = ctypes.c_void_p
        lib.nns_ring_create.argtypes = [ctypes.c_uint64, ctypes.c_uint64]
        lib.nns_ring_destroy.argtypes = [ctypes.c_void_p]
        lib.nns_ring_push.restype = ctypes.c_int
        lib.nns_ring_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_uint32]
        lib.nns_ring_pop.restype = ctypes.c_int64
        lib.nns_ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_uint64]
        lib.nns_ring_size.restype = ctypes.c_uint64
        lib.nns_ring_size.argtypes = [ctypes.c_void_p]
        lib.nns_sparse_encode.restype = ctypes.c_int64
        lib.nns_sparse_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64]
        lib.nns_sparse_decode.restype = ctypes.c_int64
        lib.nns_sparse_decode.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
            ctypes.c_uint32, ctypes.c_void_p, ctypes.c_uint64]
        _lib = lib
        log.info("native runtime loaded: %s", so)
        return _lib


def sparse_encode_arrays(dense: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """dense → (uint32 flat indices, values). The library tests each
    element's bytes for zero (-0.0 is kept); numpy tests its value."""
    dense = np.ascontiguousarray(dense)
    lib = get_lib()
    if lib is None or dense.dtype.itemsize not in (1, 2, 4, 8):
        flat = dense.reshape(-1)
        idx = np.nonzero(flat)[0].astype(np.uint32)
        return idx, flat[idx]
    n = dense.size
    idx = np.empty(n, np.uint32)
    vals = np.empty(n, dense.dtype)
    nnz = lib.nns_sparse_encode(
        dense.ctypes.data, n, dense.dtype.itemsize,
        idx.ctypes.data, vals.ctypes.data, n)
    if nnz < 0:
        raise RuntimeError("sparse encode overflow")
    return idx[:nnz].copy(), vals[:nnz].copy()


def sparse_decode_arrays(indices: np.ndarray, values: np.ndarray,
                         num_elements: int, dtype) -> np.ndarray:
    """(uint32 flat indices, values) → flat dense array of ``num_elements``;
    an index out of range raises."""
    lib = get_lib()
    dtype = np.dtype(dtype)
    if lib is None or dtype.itemsize not in (1, 2, 4, 8):
        flat = np.zeros(num_elements, dtype)
        flat[indices] = values
        return flat
    out = np.zeros(num_elements, dtype)
    indices = np.ascontiguousarray(indices, np.uint32)
    values = np.ascontiguousarray(values, dtype)
    ret = lib.nns_sparse_decode(indices.ctypes.data, values.ctypes.data,
                                len(indices), dtype.itemsize,
                                out.ctypes.data, num_elements)
    if ret < 0:
        raise ValueError("sparse index out of range")
    return out


def native_available() -> bool:
    return get_lib() is not None


def aligned_empty(shape, dtype, alignment: int = 64) -> np.ndarray:
    """numpy array over an ``alignment``-aligned native allocation, freed
    with the array (tensor_allocator.c equivalent); numpy's allocator
    without the library or for zero bytes."""
    lib = get_lib()
    dtype = np.dtype(dtype)
    count = int(np.prod(shape)) if shape else 1
    nbytes = count * dtype.itemsize
    if lib is None or nbytes == 0:
        return np.empty(shape, dtype)
    ptr = lib.nns_aligned_alloc(nbytes, alignment)
    if not ptr:
        return np.empty(shape, dtype)
    buf = (ctypes.c_uint8 * nbytes).from_address(ptr)
    arr = np.frombuffer(buf, dtype=dtype, count=count).reshape(shape)
    arr = arr.view(_AlignedArray)
    arr._nns_ptr = ptr
    return arr


class _AlignedArray(np.ndarray):
    """Owns a native allocation: the array ``aligned_empty`` returns frees
    it when collected (views of it hold no pointer)."""

    _nns_ptr = None

    def __array_finalize__(self, obj):
        if obj is not None and not hasattr(self, "_nns_ptr"):
            self._nns_ptr = None

    def __del__(self):
        ptr = getattr(self, "_nns_ptr", None)
        if ptr:
            lib = get_lib()
            if lib is not None:
                lib.nns_aligned_free(ptr)


class SpscRing:
    """Lock-free single-producer/single-consumer ring of byte records
    (``capacity_pow2`` slots of ``slot_size`` bytes)."""

    def __init__(self, capacity_pow2: int = 1024, slot_size: int = 4096):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native runtime unavailable")
        self._lib = lib
        self._ring = lib.nns_ring_create(capacity_pow2, slot_size)
        if not self._ring:
            raise RuntimeError("ring allocation failed (capacity must be 2^n)")
        self._slot = slot_size

    def push(self, data: bytes) -> bool:
        """False when the ring is full; a record above the slot size raises."""
        ret = self._lib.nns_ring_push(self._ring, data, len(data))
        if ret == -1:
            raise ValueError(f"record {len(data)}B exceeds slot {self._slot}B")
        return ret == 1

    def pop(self) -> Optional[bytes]:
        """The oldest record, or None when the ring is empty."""
        out = (ctypes.c_uint8 * self._slot)()
        n = self._lib.nns_ring_pop(self._ring, out, self._slot)
        if n == -1:
            return None
        if n == -2:
            raise RuntimeError("slot larger than pop buffer")
        return bytes(out[:n])

    def __len__(self) -> int:
        return int(self._lib.nns_ring_size(self._ring))

    def close(self) -> None:
        if self._ring:
            self._lib.nns_ring_destroy(self._ring)
            self._ring = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
