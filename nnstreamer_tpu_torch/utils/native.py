"""ctypes bridge to the native runtime's sparse COO codec.

Port of the codec part of nnstreamer_tpu/utils/native.py. The library is
``native/nns_runtime.cpp`` at the root of the repository, built at first
use with g++ into ``nnstreamer_tpu_torch/_build/libnns_runtime-<hash>.so``
(the hash covers the source and the flags, so an edit rebuilds; the
source's own directory is left alone). Without g++, or for an item size
the library does not take, the codec runs numpy, as the JAX bridge does:
that path is part of its contract, not a device fallback.
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
    """The loaded codec library, built at the first call; None without g++."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = _build()
        if so is None:
            return None
        lib = ctypes.CDLL(so)
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
