"""``nnstreamer_python`` compat shim for the reference's custom scripts.

Port of nnstreamer_tpu/filters/nns_python_compat.py. The reference's
python3 subplugin injects a helper module (``import nnstreamer_python as
nns`` — ext/nnstreamer/extra/nnstreamer_python3_helper.cc) whose
``TensorShape`` carries dims in the reference's innermost-first order plus
a numpy dtype. Its script contract (tests/test_models/models/passthrough.py
/ scaler.py):

  * ``getInputDim() / getOutputDim() -> [nns.TensorShape, ...]``
  * ``setInputDim([TensorShape]) -> [TensorShape]``
  * ``invoke(input_list) -> output_list`` over FLAT (raveled) arrays —
    scripts reshape via ``dims[::-1]`` themselves
  * constructor receives the ``custom=`` string as ``*args``

Both packages install a shim under ``sys.modules['nnstreamer_python']``
and the first to install wins, so a script loaded by either package may
hold the other's ``TensorShape``. This module's is a complete stand-in for
the JAX package's (same constructor, methods and mutable dims list), and
``shapes_to_info`` reads any object with ``getDims()``/``getType()``.
"""

from __future__ import annotations

import sys
from typing import Any, List, Optional, Sequence

import numpy as np

from ..core.types import TensorDType, TensorInfo, TensorsInfo


class TensorShape:
    """dims (innermost-first, MUTABLE list — scaler.py edits it in place)
    + numpy element type."""

    def __init__(self, dims: Sequence[int], type: Any = np.uint8):  # noqa: A002
        self._dims = [int(d) for d in dims]
        self._type = np.dtype(type)

    def getDims(self) -> List[int]:  # noqa: N802 — reference API names
        return self._dims

    def getType(self) -> np.dtype:  # noqa: N802
        return self._type

    def setDims(self, dims: Sequence[int]) -> None:  # noqa: N802
        self._dims = [int(d) for d in dims]

    def __repr__(self) -> str:
        return f"TensorShape({self._dims}, {self._type})"


def install_shim() -> None:
    """Make ``import nnstreamer_python`` resolve to this module, unless a
    shim is already installed."""
    sys.modules.setdefault("nnstreamer_python", sys.modules[__name__])


def shapes_to_info(shapes: Optional[Sequence[Any]]) -> Optional[TensorsInfo]:
    """Shapes (any objects with ``getDims()``/``getType()``) → TensorsInfo."""
    if not shapes:
        return None
    infos = []
    for s in shapes:
        dims = [int(d) for d in s.getDims()]
        while len(dims) > 1 and dims[-1] == 1:
            dims.pop()  # reference pads rank to 4 with 1s
        # a 0 dim (script bug) is NOT stripped: TensorInfo rejects it
        infos.append(TensorInfo(tuple(dims),
                                TensorDType.parse(np.dtype(s.getType()))))
    return TensorsInfo(tuple(infos))


def info_to_shapes(info: TensorsInfo) -> List[Any]:
    """TensorsInfo → shapes of the installed ``nnstreamer_python`` (this
    module's class when no shim is installed yet), rank padded to 4."""
    cls = getattr(sys.modules.get("nnstreamer_python"), "TensorShape", TensorShape)
    out = []
    for t in info:
        dims = list(t.dims) + [1] * (4 - len(t.dims))
        out.append(cls(dims, t.dtype.np_dtype))
    return out
