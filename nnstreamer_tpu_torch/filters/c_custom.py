"""framework=custom — C shared-object filter loader.

Port of nnstreamer_tpu/filters/c_custom.py. The .so runs on the host: its
inputs are the memories' host arrays (a tensor on the card is copied down
first) and its outputs host arrays preallocated here; ``ret < 0`` raises,
``ret > 0`` drops the frame.

Reference: gst/nnstreamer/tensor_filter/tensor_filter_custom.c loading .so
files that implement the custom-filter ABI (tensor_filter_custom.h:46-143).

TWO binary contracts load here, auto-detected by exported symbol:
 * the REFERENCE's ``NNStreamer_custom`` vtable (a .so compiled against
   the reference's own headers runs unmodified — filters/gst_custom_abi.py
   maps the pure-C structs with ctypes);
 * our flat ABI, native/nns_custom.h (simple C symbols; see that header
   for the contract and ``nns-new-filter-torch --kind c`` for a generator).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from ..core.buffer import TensorMemory
from ..core.types import TensorsInfo
from .base import FilterFramework, FilterProps, register_filter


class _NnsTensor(ctypes.Structure):
    _fields_ = [("data", ctypes.c_void_p), ("size", ctypes.c_uint64)]


@register_filter
class CCustomFilter(FilterFramework):
    NAME = "custom"
    ALLOCATE_IN_INVOKE = False

    def __init__(self) -> None:
        super().__init__()
        self._lib: Optional[ctypes.CDLL] = None
        self._gst = None  # reference-ABI loader when detected
        self._in_info: Optional[TensorsInfo] = None
        self._out_info: Optional[TensorsInfo] = None

    def open(self, props: FilterProps) -> None:
        super().open(props)
        path = props.model_path
        if not path or not os.path.isfile(path):
            raise FileNotFoundError(f"custom filter .so not found: {path}")
        lib = ctypes.CDLL(os.path.abspath(path))
        from .gst_custom_abi import GstCustomSo, detect

        if detect(lib):
            # reference ABI: .so exports NNStreamer_custom (construction
            # errors — e.g. NULL initfunc — surface as themselves)
            self._gst = GstCustomSo(lib, os.path.abspath(path),
                                    props.custom or "")
            self._lib = lib
            self._in_info, self._out_info = self._gst.get_model_info()
            return
        for sym in ("nns_custom_get_input_info", "nns_custom_get_output_info",
                    "nns_custom_invoke"):
            if not hasattr(lib, sym):
                raise ValueError(f"{path}: missing required symbol {sym}")
        lib.nns_custom_get_input_info.restype = ctypes.c_int
        lib.nns_custom_get_input_info.argtypes = [ctypes.c_char_p,
                                                  ctypes.c_char_p, ctypes.c_int]
        lib.nns_custom_get_output_info.restype = ctypes.c_int
        lib.nns_custom_get_output_info.argtypes = lib.nns_custom_get_input_info.argtypes
        lib.nns_custom_invoke.restype = ctypes.c_int
        lib.nns_custom_invoke.argtypes = [
            ctypes.c_int, ctypes.POINTER(_NnsTensor),
            ctypes.c_int, ctypes.POINTER(_NnsTensor)]
        if hasattr(lib, "nns_custom_init"):
            lib.nns_custom_init.restype = ctypes.c_int
            lib.nns_custom_init.argtypes = [ctypes.c_char_p]
            ret = lib.nns_custom_init(props.custom.encode())
            if ret != 0:
                raise RuntimeError(f"{path}: nns_custom_init failed ({ret})")
        self._lib = lib
        self._in_info = self._query_info(lib.nns_custom_get_input_info)
        self._out_info = self._query_info(lib.nns_custom_get_output_info)

    @staticmethod
    def _query_info(fn) -> TensorsInfo:
        cap = 512
        dims = ctypes.create_string_buffer(cap)
        types = ctypes.create_string_buffer(cap)
        if fn(dims, types, cap) != 0:
            raise RuntimeError("custom filter info query failed")
        return TensorsInfo.from_strings(dims.value.decode(), types.value.decode())

    def close(self) -> None:
        if getattr(self, "_gst", None) is not None:
            self._gst.close()
            self._gst = None
        elif self._lib is not None and hasattr(self._lib, "nns_custom_exit"):
            self._lib.nns_custom_exit()
        self._lib = None
        super().close()

    def set_input_info(self, in_info: TensorsInfo) -> TensorsInfo:
        if getattr(self, "_gst", None) is not None:
            out = self._gst.set_input_info(in_info)
            if out is not None:
                self._in_info, self._out_info = in_info, out
                return out
        return super().set_input_info(in_info)

    def get_model_info(self) -> Tuple[Optional[TensorsInfo], Optional[TensorsInfo]]:
        return self._in_info, self._out_info

    def invoke(self, inputs: Sequence[TensorMemory]) -> Sequence[TensorMemory]:
        if getattr(self, "_gst", None) is not None:
            outs = self._gst.invoke([m.host() for m in inputs],
                                    self._out_info)
            if outs is None:
                return None  # soft drop (reference ret>0 semantics)
            return [TensorMemory(o) for o in outs]
        n_in = len(inputs)
        in_arrays = [np.ascontiguousarray(m.host()) for m in inputs]
        in_structs = (_NnsTensor * n_in)()
        for i, a in enumerate(in_arrays):
            in_structs[i].data = a.ctypes.data
            in_structs[i].size = a.nbytes
        outs = [np.empty(i.shape, i.dtype.np_dtype) for i in self._out_info]
        out_structs = (_NnsTensor * len(outs))()
        for i, a in enumerate(outs):
            out_structs[i].data = a.ctypes.data
            out_structs[i].size = a.nbytes
        ret = self._lib.nns_custom_invoke(n_in, in_structs, len(outs), out_structs)
        if ret < 0:
            raise RuntimeError(f"custom filter invoke failed ({ret})")
        if ret > 0:
            return None  # soft drop (reference ret>0 semantics)
        return [TensorMemory(a) for a in outs]
