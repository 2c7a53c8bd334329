"""Loader for the legacy (torch-1.0 era) TorchScript zip format.

Modern ``torch.jit.load`` rejects these files ("Legacy model format is not
supported"), but the format is fully self-describing: the zip carries
``model.json`` (protoVersion 2 — module tree, parameter metadata, raw tensor
blobs) and the TorchScript source for each module's ``forward`` under
``code/``.  The arena source is generated from a *restricted* serializer (no
classes, no imports, a small fixed op vocabulary), so instead of a TorchScript
frontend we execute it directly as Python against a shim ``torch`` namespace
that maps the era's internal ops (``_cast_Float``, ``_convolution``,
``transpose_``, ``ops.prim.NumToTensor`` …) onto modern equivalents.

This serves the reference's own ``pytorch_lenet5.pt`` asset unmodified —
the file its pytorch filter test uses (reference:
tests/nnstreamer_filter_pytorch/runTest.sh:72, served by
ext/nnstreamer/tensor_filter/tensor_filter_pytorch.cc).

Port of nnstreamer_tpu/models/torch_legacy.py, with a device: the tensors
of the file are placed on it once at load (``_read_tensors``), and the shim
puts every tensor the arena code makes with a factory op (``zeros``,
``full``, ``arange``, ...) on it too, whatever ``device=`` the era's
serializer baked in, so every op of a forward runs there with no copy
between the host and the card. ``ops.prim.NumToTensor`` keeps its size
arithmetic on the host: its values are Python ints that the arena turns
back into shapes (``int(...)``), and a host scalar costs the card nothing.
"""

from __future__ import annotations

import functools
import json
import types
import zipfile
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = ["is_legacy_torchscript", "load_legacy_torchscript", "LegacyTorchScriptError"]


class LegacyTorchScriptError(RuntimeError):
    """A legacy-format file was recognised but could not be executed."""


#: model.json dataType → numpy dtype (legacy caffe2-style names)
_DTYPES = {
    "FLOAT": np.float32,
    "DOUBLE": np.float64,
    "FLOAT16": np.float16,
    "INT64": np.int64,
    "INT32": np.int32,
    "INT16": np.int16,
    "INT8": np.int8,
    "UINT8": np.uint8,
    "BOOL": np.bool_,
}


def is_legacy_torchscript(path: str) -> bool:
    """True iff *path* is a legacy TorchScript zip (contains ``*/model.json``).

    Modern TorchScript zips carry ``data.pkl`` + ``constants.pkl`` instead.
    """
    try:
        if not zipfile.is_zipfile(path):
            return False
        with zipfile.ZipFile(path) as z:
            names = z.namelist()
            # a modern archive can carry _extra_files entries named
            # model.json (stored under <root>/extra/); data.pkl is the
            # authoritative modern marker, root-level model.json the legacy one
            if any(n.split("/")[-1] == "data.pkl" for n in names):
                return False
            return any(n.count("/") == 1 and n.endswith("/model.json")
                       for n in names)
    except (OSError, zipfile.BadZipFile):
        return False


#: tensor factories: the tensors they make go to the module's device
_FACTORIES = frozenset(
    {"zeros", "ones", "full", "empty", "arange", "range", "linspace",
     "logspace", "eye", "tensor", "scalar_tensor", "rand", "randn",
     "randint", "zeros_like", "ones_like", "full_like", "empty_like",
     "rand_like", "randn_like", "randint_like"})


def _on_device(fn: Any, device: Any) -> Any:
    @functools.wraps(fn)
    def make(*args: Any, **kwargs: Any) -> Any:
        kwargs["device"] = device
        return fn(*args, **kwargs)

    return make


def _torch_attr(name: str, device: Any) -> Any:
    import torch

    fn = getattr(torch, name)
    return _on_device(fn, device) if device is not None and name in _FACTORIES \
        else fn


class _TorchShim:
    """``torch`` namespace seen by legacy arena code.

    Unknown attributes fall through to real torch (a factory op with the
    module's ``device``); only renamed/removed era-internal ops are
    overridden.
    """

    def __init__(self, device: Any = None) -> None:
        self._device = device

    def __getattr__(self, name: str) -> Any:
        return _torch_attr(name, self.__dict__.get("_device"))

    # -- casts ---------------------------------------------------------
    @staticmethod
    def _cast_Float(x, non_blocking=False):
        return x.float()

    @staticmethod
    def _cast_Double(x, non_blocking=False):
        return x.double()

    @staticmethod
    def _cast_Byte(x, non_blocking=False):
        import torch

        return x.to(torch.uint8)

    @staticmethod
    def _cast_Char(x, non_blocking=False):
        import torch

        return x.to(torch.int8)

    @staticmethod
    def _cast_Int(x, non_blocking=False):
        import torch

        return x.to(torch.int32)

    @staticmethod
    def _cast_Long(x, non_blocking=False):
        import torch

        return x.to(torch.int64)

    # -- renamed / method-only ops ------------------------------------
    @staticmethod
    def transpose_(x, a, b):
        # functional is fine: legacy codegen never aliases the input again
        return x.transpose(a, b)

    @staticmethod
    def view(x, shape):
        return x.reshape(shape)

    @staticmethod
    def size(x, dim=None):
        return x.size() if dim is None else x.size(dim)

    @staticmethod
    def dim(x):
        return x.dim()

    @staticmethod
    def t(x):
        return x.t()

    @staticmethod
    def contiguous(x):
        return x.contiguous()

    @staticmethod
    def _convolution(inp, weight, bias, stride, padding, dilation, transposed,
                     output_padding, groups, *flags):
        """Era signature of aten::_convolution (12 args; modern added more
        trailing bools — absorbed by *flags)."""
        import torch.nn.functional as F

        nd = weight.dim() - 2
        if transposed:
            fn = (F.conv_transpose1d, F.conv_transpose2d, F.conv_transpose3d)[nd - 1]
            return fn(inp, weight, bias, stride, padding, output_padding, groups, dilation)
        fn = (F.conv1d, F.conv2d, F.conv3d)[nd - 1]
        return fn(inp, weight, bias, stride, padding, dilation, groups)

    @staticmethod
    def warn(*args, **kwargs):  # torch.warn(msg, stacklevel=) — codegen chatter
        return None

    @staticmethod
    def format(fmt, *args):  # torch.format("... {}", x) → str.format
        return fmt.format(*args)

    # -- identity / comparison intrinsics ------------------------------
    @staticmethod
    def __is__(a, b):
        return a is b

    @staticmethod
    def __isnot__(a, b):
        return a is not b

    @staticmethod
    def __not__(a):
        return not a


class _PrimOps:
    @staticmethod
    def NumToTensor(n):
        import torch

        return torch.tensor(n)

    @staticmethod
    def unchecked_unwrap_optional(x):
        return x

    @staticmethod
    def TupleConstruct(*xs):
        return tuple(xs)

    @staticmethod
    def min(*xs):
        return min(xs) if len(xs) > 1 else min(xs[0])


class _AtenOps:
    def __init__(self, device: Any = None) -> None:
        self._device = device

    def __getattr__(self, name: str) -> Any:
        return _torch_attr(name, self.__dict__.get("_device"))


class _Ops:
    def __init__(self, device: Any = None) -> None:
        self.prim = _PrimOps()
        self.aten = _AtenOps(device)


class _LegacyModule:
    """A node of the deserialized module tree (params + submodules + forward)."""

    def __init__(self, name: str) -> None:
        self._name = name

    def __call__(self, *args: Any) -> Any:
        return self.forward(*args)

    def forward(self, *args: Any) -> Any:  # replaced per-module when an arena exists
        raise LegacyTorchScriptError(
            f"legacy module {self._name!r} has no torchscript arena")

    # torch.nn.Module API surface the filter touches
    def eval(self) -> "_LegacyModule":
        return self

    def to(self, *a: Any, **k: Any) -> "_LegacyModule":
        return self

    def __repr__(self) -> str:
        return f"<LegacyScriptModule {self._name!r}>"


def _read_tensors(z: zipfile.ZipFile, root: str, j: Dict[str, Any],
                  device: Any = None) -> List[Any]:
    """The file's tensors, on ``device`` (None: the CPU)."""
    import torch

    out = []
    for t in j.get("tensors", []):
        np_dt = _DTYPES.get(t["dataType"])
        if np_dt is None:
            raise LegacyTorchScriptError(f"unsupported tensor dataType {t['dataType']!r}")
        dims = [int(d) for d in t.get("dims", [])]
        strides = [int(s) for s in t.get("strides", [])]
        # a strided view can span more storage than prod(dims) elements
        if dims and strides:
            count = 1 + sum((d - 1) * s for d, s in zip(dims, strides))
        else:
            count = int(np.prod(dims)) if dims else 1
        raw = z.read(root + t["data"]["key"])
        offset = int(t.get("offset", 0)) * np.dtype(np_dt).itemsize
        arr = np.frombuffer(raw, dtype=np_dt, count=count, offset=offset)
        if dims and strides and strides != _contig_strides(dims):
            arr = np.lib.stride_tricks.as_strided(
                arr, shape=dims,
                strides=[s * arr.itemsize for s in strides]).copy()
        else:
            arr = arr[: int(np.prod(dims)) if dims else 1].reshape(dims).copy()
        t = torch.from_numpy(arr)
        out.append(t if device is None else t.to(device))
    return out


def _contig_strides(dims: List[int]) -> List[int]:
    st, acc = [], 1
    for d in reversed(dims):
        st.append(acc)
        acc *= d
    return list(reversed(st))


import builtins as _builtins

#: module roots torch's own dispatch machinery may pull in from the calling
#: frame's builtins (torch.threshold etc. resolve overloads via __import__)
_ALLOWED_IMPORT_ROOTS = frozenset(
    {"torch", "typing", "math", "numbers", "warnings", "collections",
     "functools", "itertools", "operator"})


def _guarded_import(name, globals=None, locals=None, fromlist=(), level=0):
    if name.split(".")[0] not in _ALLOWED_IMPORT_ROOTS:
        raise LegacyTorchScriptError(
            f"legacy arena attempted to import {name!r}")
    return _builtins.__import__(name, globals, locals, fromlist, level)


#: the only builtins era-generated arena code uses. NOTE: this is NOT a
#: security boundary — arena code is still Python and attribute traversal
#: can reach anything (same trust model as torch.jit.load/pickle: model
#: files are code). The guard exists to fail fast on accidental non-arena
#: content, not to contain a hostile file.
_ARENA_BUILTINS = {
    n: getattr(_builtins, n)
    for n in ("int", "float", "bool", "str", "len", "min", "max", "abs",
              "range", "enumerate", "zip", "tuple", "list", "isinstance",
              "getattr", "setattr", "print")
}
_ARENA_BUILTINS["__import__"] = _guarded_import


def _arena_globals(device: Any = None) -> Dict[str, Any]:
    import torch

    return {
        "torch": _TorchShim(device),
        "ops": _Ops(device),
        "annotate": lambda _ty, v: v,
        "unchecked_cast": lambda _ty, v: v,
        "uninitialized": lambda _ty: None,
        "Tensor": torch.Tensor,
        "Optional": Optional,
        "List": List,
        "Dict": Dict,
        "op_version_set": 0,
        "__builtins__": _ARENA_BUILTINS,
    }


def _build_module(z: zipfile.ZipFile, root: str, mdef: Dict[str, Any],
                  tensors: List[Any], device: Any = None) -> _LegacyModule:
    mod = _LegacyModule(mdef.get("name", "<main>"))
    for p in mdef.get("parameters", []):
        setattr(mod, p["name"], tensors[int(p["tensorId"])])
    for s in mdef.get("submodules", []):
        setattr(mod, s["name"], _build_module(z, root, s, tensors, device))
    arena = mdef.get("torchscriptArena")
    if arena:
        src = z.read(root + arena["key"]).decode("utf-8")
        g = _arena_globals(device)
        prelude = set(g)
        try:
            exec(compile(src, arena["key"], "exec"), g)  # noqa: S102 — limited-builtins namespace
        except Exception as e:  # pragma: no cover - defensive
            raise LegacyTorchScriptError(
                f"failed to execute legacy arena {arena['key']!r}: {e}") from e
        # bind only names the arena itself defined (not the prelude lambdas)
        for name in set(g) - prelude:
            fn = g[name]
            if isinstance(fn, types.FunctionType):
                setattr(mod, name, types.MethodType(fn, mod))
    return mod


def load_legacy_torchscript(path: str, device: Any = None) -> _LegacyModule:
    """Deserialize a legacy TorchScript zip into a callable module tree on
    ``device`` (None: the CPU)."""
    with zipfile.ZipFile(path) as z:
        json_name = next(
            (n for n in z.namelist() if n.split("/")[-1] == "model.json"), None)
        if json_name is None:
            raise LegacyTorchScriptError(f"{path}: no model.json — not legacy format")
        root = json_name[: -len("model.json")]
        j = json.loads(z.read(json_name))
        if str(j.get("protoVersion")) not in ("1", "2"):
            raise LegacyTorchScriptError(
                f"{path}: unsupported legacy protoVersion {j.get('protoVersion')!r}")
        tensors = _read_tensors(z, root, j, device)
        return _build_module(z, root, j["mainModule"], tensors, device)
