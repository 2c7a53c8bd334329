"""Custom filter backends: custom-easy (in-app callables) and python3
(user script files).

Port of nnstreamer_tpu/filters/custom.py. Reference equivalents:
 * custom-easy — register a C callback + static I/O info in-app
   (include/tensor_filter_custom_easy.h:25-74). Ours registers a Python
   callable over host numpy arrays; outputs that are ``torch.Tensor``s
   stay on their device, anything else becomes a host array.
 * python3 — load a user .py defining ``class CustomFilter`` with
   getInputDimension/getOutputDimension/setInputDimension/invoke
   (tensor_filter_python3.cc:85-135,224-273). Same class contract here,
   numpy in, host arrays out: a ``torch.Tensor`` a script returns is
   copied to the host.

Both run on the host: on a card pipeline each invoke copies its inputs
down (and waits for them), and a following torch-cuda filter copies the
result up again. Neither fusion pass nor the CUDA graphs touch them.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.buffer import TensorMemory
from ..core.registry import SubpluginType, get_subplugin, register_subplugin
from ..core.types import TensorsInfo
from .base import FilterFramework, FilterProps, register_filter

# --------------------------------------------------------------------------- #
# custom-easy
# --------------------------------------------------------------------------- #

_easy_lock = threading.Lock()


def register_custom_easy(name: str, fn: Callable[..., Any],
                         in_info: Any, out_info: Any) -> None:
    """Register an in-app model: ``fn(*arrays) -> array(s) or tensor(s)``
    with fixed I/O.

    ``in_info``/``out_info`` accept TensorsInfo or ("dims", "types") tuples.
    Use as: ``tensor_filter framework=custom-easy model=<name>``.
    """
    ii = in_info if isinstance(in_info, TensorsInfo) else TensorsInfo.from_strings(*in_info)
    oi = out_info if isinstance(out_info, TensorsInfo) else TensorsInfo.from_strings(*out_info)
    register_subplugin(SubpluginType.EASY_CUSTOM, name,
                       {"fn": fn, "in": ii, "out": oi}, replace=True)


def unregister_custom_easy(name: str) -> None:
    from ..core.registry import unregister_subplugin

    unregister_subplugin(SubpluginType.EASY_CUSTOM, name)


@register_filter
class CustomEasyFilter(FilterFramework):
    NAME = "custom-easy"
    ALLOCATE_IN_INVOKE = True
    RUN_WITHOUT_MODEL = False  # model= names the registered callable

    def __init__(self) -> None:
        super().__init__()
        self._entry: Optional[Dict[str, Any]] = None

    def open(self, props: FilterProps) -> None:
        super().open(props)
        name = props.model if isinstance(props.model, str) else None
        if name is None:
            raise ValueError("custom-easy: model= must name a registered callable")
        entry = get_subplugin(SubpluginType.EASY_CUSTOM, name)
        if entry is None:
            raise ValueError(f"custom-easy: {name!r} is not registered")
        self._entry = entry

    def get_model_info(self) -> Tuple[Optional[TensorsInfo], Optional[TensorsInfo]]:
        return self._entry["in"], self._entry["out"]

    def invoke(self, inputs: Sequence[TensorMemory]) -> Sequence[TensorMemory]:
        arrays = [m.host() for m in inputs]
        out = self._entry["fn"](*arrays)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        return [TensorMemory(o if isinstance(o, torch.Tensor) else np.asarray(o))
                for o in outs]


def _host(x: Any) -> np.ndarray:
    """A script's output as a host array (a tensor copied from its device)."""
    return TensorMemory(x).host() if isinstance(x, torch.Tensor) else np.asarray(x)


# --------------------------------------------------------------------------- #
# python3 script filter
# --------------------------------------------------------------------------- #

@register_filter
class Python3Filter(FilterFramework):
    """framework=python3 model=/path/to/script.py

    Two script contracts are served:

    * native: ``class CustomFilter`` with
      ``getInputDimension() -> (dims_str, types_str)`` (or TensorsInfo),
      ``getOutputDimension()``, optional ``setInputDimension(in_info) ->
      out_info``, ``invoke(*arrays) -> array(s)``; optional module-level
      ``make_filter(options_dict)`` constructor;
    * the REFERENCE's contract (tensor_filter_python3.cc +
      nnstreamer_python3_helper.cc — its own test scripts passthrough.py
      / scaler.py run unmodified): ``import nnstreamer_python as nns``
      (shimmed by filters/nns_python_compat.py),
      ``getInputDim()/getOutputDim() -> [nns.TensorShape]``,
      ``setInputDim([TensorShape]) -> [TensorShape]``, and
      ``invoke(list_of_flat_arrays) -> list_of_flat_arrays``; the
      ``custom=`` string arrives as a constructor argument. Flavor is
      detected by the presence of ``getInputDim``/``setInputDim``.
    """

    NAME = "python3"
    ALIASES = ("python",)
    ALLOCATE_IN_INVOKE = True

    def __init__(self) -> None:
        super().__init__()
        self._obj: Any = None

    def open(self, props: FilterProps) -> None:
        from .nns_python_compat import install_shim

        super().open(props)
        install_shim()  # scripts may `import nnstreamer_python as nns`
        path = props.model_path
        if not path or not os.path.isfile(path):
            raise FileNotFoundError(f"python3 filter script not found: {path}")
        from ..converters.pyscript import load_script_module

        mod = load_script_module(path)
        if hasattr(mod, "make_filter"):
            self._obj = mod.make_filter(props.custom_dict())
        elif hasattr(mod, "CustomFilter"):
            # reference semantics: custom= splits on spaces into separate
            # constructor args (tensor_filter_python3.cc:275 g_strsplit).
            # Whether the constructor TAKES arguments is decided by its
            # signature, not by catching TypeError (which would mask a
            # genuine failure inside the constructor body).
            import inspect

            args = tuple(props.custom.split()) if props.custom else ()
            if args:
                try:
                    sig = inspect.signature(mod.CustomFilter.__init__)
                    takes_args = len(sig.parameters) > 1 or any(
                        p.kind is inspect.Parameter.VAR_POSITIONAL
                        for p in sig.parameters.values())
                except (TypeError, ValueError):
                    takes_args = True
                if not takes_args:
                    # native-contract no-arg constructor: custom= is
                    # carried by make_filter there, ignore it here
                    args = ()
            self._obj = mod.CustomFilter(*args)
        else:
            raise ValueError(f"{path}: must define CustomFilter or make_filter")
        self._ref_flavor = hasattr(self._obj, "getInputDim") or \
            hasattr(self._obj, "setInputDim")
        self._out_info: Optional[TensorsInfo] = None

    def get_model_info(self) -> Tuple[Optional[TensorsInfo], Optional[TensorsInfo]]:
        from .nns_python_compat import shapes_to_info

        ii = oi = None
        if hasattr(self._obj, "getInputDimension"):
            ii = _coerce(self._obj.getInputDimension())
        elif hasattr(self._obj, "getInputDim"):
            ii = shapes_to_info(self._obj.getInputDim())
        if hasattr(self._obj, "getOutputDimension"):
            oi = _coerce(self._obj.getOutputDimension())
        elif hasattr(self._obj, "getOutputDim"):
            oi = shapes_to_info(self._obj.getOutputDim())
        self._out_info = oi or self._out_info
        return ii, oi

    def set_input_info(self, in_info: TensorsInfo) -> TensorsInfo:
        from .nns_python_compat import info_to_shapes, shapes_to_info

        if hasattr(self._obj, "setInputDimension"):
            return _coerce(self._obj.setInputDimension(in_info))
        if hasattr(self._obj, "setInputDim"):
            out = shapes_to_info(
                self._obj.setInputDim(info_to_shapes(in_info)))
            if out is None:
                raise ValueError("setInputDim rejected the input dims")
            self._out_info = out
            return out
        return super().set_input_info(in_info)

    def invoke(self, inputs: Sequence[TensorMemory]) -> Sequence[TensorMemory]:
        arrays = [m.host() for m in inputs]
        if self._ref_flavor:
            # reference helper semantics: ONE list argument of raveled
            # arrays in, a list of raveled arrays out — reshaped here to
            # the declared output dims
            flat = [np.ravel(a) for a in arrays]
            outs = self._obj.invoke(flat)
            mems = []
            for i, o in enumerate(outs):
                o = _host(o)
                if self._out_info is not None and i < len(self._out_info):
                    o = o.reshape(self._out_info[i].shape)
                mems.append(TensorMemory(o))
            return mems
        out = self._obj.invoke(*arrays)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        return [TensorMemory(_host(o)) for o in outs]


def _coerce(v: Any) -> Optional[TensorsInfo]:
    if v is None or isinstance(v, TensorsInfo):
        return v
    if isinstance(v, (tuple, list)) and len(v) == 2 and isinstance(v[0], str):
        return TensorsInfo.from_strings(v[0], v[1])
    raise ValueError(f"bad dimension spec {v!r}")
