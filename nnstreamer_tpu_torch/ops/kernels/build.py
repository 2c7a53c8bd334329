"""Build the CUDA kernels in ``csrc/`` into shared libraries, at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own by ``nvcc`` for Hopper (``sm_90a``) into ``_build/lib<name>-<hash>.so``
beside the package (the hash covers the source and the flags, so an edit
rebuilds), then loaded with ``ctypes``. No PyTorch header is compiled, which
keeps a build to seconds. ``build_all()`` starts one ``nvcc`` per source, all
at once, and waits for them; ``library(name)`` builds a single one on demand.

Nothing here runs at import: the tests import every module on machines
without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "_build")

#: one entry per kernel source; flags beyond the common ones. nms_sweep,
#: dequant_gelu_requant and preprocess must match their plain versions bit
#: for bit, so nothing may contract a multiply into an add there (the sources
#: also spell their arithmetic with _rn intrinsics).
KERNEL_FLAGS: Dict[str, List[str]] = {
    "class_reduce": [],
    "nms_sweep": ["-fmad=false"],
    "segment_colorize": [],
    "dequant_gelu_requant": ["-fmad=false"],
    "flash_attention": [],
    "preprocess": ["-fmad=false"],
}

COMMON_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
                "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit on the machine with the card")


def _flags(name: str) -> List[str]:
    return COMMON_FLAGS + KERNEL_FLAGS[name]


def _target(name: str) -> str:
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_flags(name)).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _start(name: str, nvcc: str) -> Optional[subprocess.Popen]:
    """Start nvcc for ``name`` unless its library is already built."""
    target = _target(name)
    if os.path.isfile(target):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    cmd = [nvcc, *_flags(name), "-o", f"{target}.tmp{os.getpid()}",
           os.path.join(CSRC, f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: subprocess.Popen) -> str:
    """Wait for one nvcc; keep its output as the build log (``-Xptxas -v``
    reports registers and shared memory); returns that log."""
    out, _ = proc.communicate()
    target = _target(name)
    with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as f:
        f.write(out)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(f"{target}.tmp{os.getpid()}", target)
    return out


def build_all() -> Dict[str, str]:
    """Build every kernel library, one nvcc per source, all started
    together. Returns each rebuilt kernel's nvcc log."""
    nvcc = nvcc_path()
    with _lock:
        procs = {n: _start(n, nvcc) for n in KERNEL_FLAGS}
        return {n: _finish(n, p) for n, p in procs.items() if p is not None}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            proc = _start(name, nvcc_path())
            if proc is not None:
                _finish(name, proc)
            lib = ctypes.CDLL(_target(name))
            _loaded[name] = lib
    return lib
