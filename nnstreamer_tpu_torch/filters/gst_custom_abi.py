"""Reference custom-filter .so ABI (``NNStreamer_custom``), ctypes-mapped.

Port of nnstreamer_tpu/filters/gst_custom_abi.py (no change of contract:
host arrays in and out).

``framework=custom`` loads two ABIs: our flat native/nns_custom.h contract
(filters/c_custom.py) and — this module — the REFERENCE's binary contract
(gst/nnstreamer/include/tensor_filter_custom.h:46-143): the .so exports a
``NNStreamer_custom_class *NNStreamer_custom`` vtable of eight function
pointers operating on the pure-C structs from tensor_typedef.h
(GstTensorMemory / GstTensorInfo / GstTensorsInfo) and
nnstreamer_plugin_api_filter.h:139-164 (GstTensorFilterProperties). All of
those are glib-free by design ("char instead of gchar for non-glib custom
plugins"), so a custom filter compiled against the reference headers loads
here unmodified.

Only the fields custom filters actually consume are populated in the
properties struct (model path, custom_properties, input/output meta);
layout/rank arrays are zeroed (= _NNS_LAYOUT_ANY / unset), matching a
fresh reference properties block before negotiation.
"""

from __future__ import annotations

import ctypes
from ctypes import (
    CFUNCTYPE,
    POINTER,
    Structure,
    c_char_p,
    c_int,
    c_size_t,
    c_uint,
    c_uint32,
    c_void_p,
)
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.types import TensorDType, TensorInfo, TensorsInfo

#: NNS_TENSOR_RANK_LIMIT / NNS_TENSOR_SIZE_LIMIT (tensor_typedef.h:34-35).
#: RANK must be exactly 4: ``tensor_dim`` is ``uint32_t[4]``, and a wrong
#: array length shifts every subsequent struct offset the compiled .so
#: reads/writes (GstTensorsInfo embeds 16 GstTensorInfo, and the
#: properties block embeds two GstTensorsInfo).
RANK_LIMIT = 4
SIZE_LIMIT = 16

#: reference ``tensor_type`` enum order (tensor_typedef.h:153-167)
_DTYPES = [TensorDType.INT32, TensorDType.UINT32, TensorDType.INT16,
           TensorDType.UINT16, TensorDType.INT8, TensorDType.UINT8,
           TensorDType.FLOAT64, TensorDType.FLOAT32,
           TensorDType.INT64, TensorDType.UINT64]
_DTYPE_TO_ENUM = {d: i for i, d in enumerate(_DTYPES)}


class GstTensorMemory(Structure):
    _fields_ = [("data", c_void_p), ("size", c_size_t)]


class GstTensorInfo(Structure):
    _fields_ = [("name", c_char_p),
                ("type", c_int),
                ("dimension", c_uint32 * RANK_LIMIT)]


class GstTensorsInfo(Structure):
    _fields_ = [("num_tensors", c_uint),
                ("info", GstTensorInfo * SIZE_LIMIT)]


class GstTensorFilterProperties(Structure):
    # nnstreamer_plugin_api_filter.h:139-164, field for field
    _fields_ = [
        ("fwname", c_char_p),
        ("fw_opened", c_int),
        ("model_files", POINTER(c_char_p)),
        ("num_models", c_int),
        ("input_configured", c_int),
        ("input_meta", GstTensorsInfo),
        ("input_layout", c_int * SIZE_LIMIT),
        ("input_ranks", c_uint * SIZE_LIMIT),
        ("output_configured", c_int),
        ("output_meta", GstTensorsInfo),
        ("output_layout", c_int * SIZE_LIMIT),
        ("output_ranks", c_uint * SIZE_LIMIT),
        ("custom_properties", c_char_p),
        ("hw_list", c_void_p),
        ("num_hw", c_int),
        ("accl_str", c_char_p),
        ("shared_tensor_filter_key", c_char_p),
        ("latency", c_int),
        ("throughput", c_int),
    ]


_InitFn = CFUNCTYPE(c_void_p, POINTER(GstTensorFilterProperties))
_ExitFn = CFUNCTYPE(None, c_void_p, POINTER(GstTensorFilterProperties))
_GetDimFn = CFUNCTYPE(c_int, c_void_p, POINTER(GstTensorFilterProperties),
                      POINTER(GstTensorsInfo))
_SetDimFn = CFUNCTYPE(c_int, c_void_p, POINTER(GstTensorFilterProperties),
                      POINTER(GstTensorsInfo), POINTER(GstTensorsInfo))
_InvokeFn = CFUNCTYPE(c_int, c_void_p, POINTER(GstTensorFilterProperties),
                      POINTER(GstTensorMemory), POINTER(GstTensorMemory))
_DestroyFn = CFUNCTYPE(None, c_void_p)


class NNStreamerCustomClass(Structure):
    # struct _NNStreamer_custom_class (tensor_filter_custom.h:126-137)
    _fields_ = [
        ("initfunc", _InitFn),
        ("exitfunc", _ExitFn),
        ("getInputDim", _GetDimFn),
        ("getOutputDim", _GetDimFn),
        ("setInputDim", _SetDimFn),
        ("invoke", _InvokeFn),
        ("allocate_invoke", _InvokeFn),
        ("destroy_notify", _DestroyFn),
    ]


def struct_to_info(meta: GstTensorsInfo) -> Optional[TensorsInfo]:
    if meta.num_tensors == 0:
        return None
    infos = []
    for i in range(meta.num_tensors):
        ti = meta.info[i]
        dims = []
        for d in ti.dimension:
            if d == 0:
                break
            dims.append(int(d))
        while len(dims) > 1 and dims[-1] == 1:
            dims.pop()
        infos.append(TensorInfo(tuple(dims), _DTYPES[ti.type]))
    return TensorsInfo(tuple(infos))


def info_to_struct(info: TensorsInfo, meta: GstTensorsInfo) -> None:
    meta.num_tensors = len(info)
    for i, t in enumerate(info):
        if t.dtype not in _DTYPE_TO_ENUM:
            raise ValueError(
                f"dtype {t.dtype} has no reference tensor_type enum value "
                "— the custom .so ABI cannot carry bf16/f16 streams")
        meta.info[i].name = None
        meta.info[i].type = _DTYPE_TO_ENUM[t.dtype]
        dims = list(t.dims) + [1] * (RANK_LIMIT - len(t.dims))
        for j in range(RANK_LIMIT):
            meta.info[i].dimension[j] = dims[j]


def detect(lib: ctypes.CDLL) -> bool:
    """True iff the .so exports the reference's NNStreamer_custom symbol
    (detection only — a present-but-invalid vtable must surface ITS error
    from the constructor, not fall through to the flat-ABI probe)."""
    try:
        POINTER(NNStreamerCustomClass).in_dll(lib, "NNStreamer_custom")
        return True
    except ValueError:
        return False


class GstCustomSo:
    """A loaded reference-ABI custom filter (one instance per element)."""

    def __init__(self, lib: ctypes.CDLL, path: str, custom: str):
        self._cls = POINTER(NNStreamerCustomClass).in_dll(
            lib, "NNStreamer_custom").contents
        if not self._cls.initfunc:
            # the reference rejects this at open too
            # (tensor_filter_custom.c:114 "requires a valid 'initfunc'")
            raise RuntimeError(
                f"{path}: NNStreamer_custom.initfunc is NULL")
        if bool(self._cls.invoke) == bool(self._cls.allocate_invoke):
            # exactly one of invoke/allocate_invoke must be set
            # (tensor_filter_custom.c custom_open); neither would call a
            # NULL pointer at the first frame, both is ambiguous
            raise RuntimeError(
                f"{path}: NNStreamer_custom must define exactly one of "
                "invoke/allocate_invoke "
                f"(invoke={bool(self._cls.invoke)}, "
                f"allocate_invoke={bool(self._cls.allocate_invoke)})")
        # keep byte buffers alive for the struct's borrowed pointers
        self._path_b = path.encode()
        self._custom_b = custom.encode() if custom else None
        self._models = (c_char_p * 1)(self._path_b)
        self._prop = GstTensorFilterProperties()
        self._prop.fwname = b"custom"
        self._prop.fw_opened = 1
        self._prop.model_files = self._models
        self._prop.num_models = 1
        self._prop.custom_properties = self._custom_b
        self._priv = self._cls.initfunc(ctypes.byref(self._prop))

    # -- model info --------------------------------------------------------- #
    def get_model_info(self) -> Tuple[Optional[TensorsInfo],
                                      Optional[TensorsInfo]]:
        ii = oi = None
        if self._cls.getInputDim:
            meta = GstTensorsInfo()
            if self._cls.getInputDim(self._priv, ctypes.byref(self._prop),
                                     ctypes.byref(meta)) == 0:
                ii = struct_to_info(meta)
        if self._cls.getOutputDim:
            meta = GstTensorsInfo()
            if self._cls.getOutputDim(self._priv, ctypes.byref(self._prop),
                                      ctypes.byref(meta)) == 0:
                oi = struct_to_info(meta)
        if ii is not None:
            info_to_struct(ii, self._prop.input_meta)
            self._prop.input_configured = 1
        if oi is not None:
            info_to_struct(oi, self._prop.output_meta)
            self._prop.output_configured = 1
        return ii, oi

    def set_input_info(self, in_info: TensorsInfo) -> Optional[TensorsInfo]:
        if not self._cls.setInputDim:
            return None
        cin, cout = GstTensorsInfo(), GstTensorsInfo()
        info_to_struct(in_info, cin)
        ret = self._cls.setInputDim(self._priv, ctypes.byref(self._prop),
                                    ctypes.byref(cin), ctypes.byref(cout))
        if ret != 0:
            raise ValueError(f"custom .so setInputDim failed ({ret})")
        out = struct_to_info(cout)
        info_to_struct(in_info, self._prop.input_meta)
        self._prop.input_configured = 1
        if out is not None:
            info_to_struct(out, self._prop.output_meta)
            self._prop.output_configured = 1
        return out

    # -- execution ---------------------------------------------------------- #
    def invoke(self, arrays: Sequence[np.ndarray],
               out_info: TensorsInfo) -> List[np.ndarray]:
        n_in, n_out = len(arrays), len(out_info)
        c_in = (GstTensorMemory * max(n_in, 1))()
        holders = []
        for i, a in enumerate(arrays):
            a = np.ascontiguousarray(a)
            holders.append(a)
            c_in[i].data = a.ctypes.data_as(c_void_p)
            c_in[i].size = a.nbytes
        c_out = (GstTensorMemory * max(n_out, 1))()
        outs: List[np.ndarray] = []
        use_alloc = bool(self._cls.allocate_invoke) and \
            not bool(self._cls.invoke)
        if not use_alloc:
            for i, t in enumerate(out_info):
                o = np.empty(t.shape, t.dtype.np_dtype)
                outs.append(o)
                c_out[i].data = o.ctypes.data_as(c_void_p)
                c_out[i].size = o.nbytes
            ret = self._cls.invoke(self._priv, ctypes.byref(self._prop),
                                   c_in, c_out)
            if ret > 0:
                return None  # soft drop (tensor_filter.c:702-705)
            if ret < 0:
                raise RuntimeError(f"custom .so invoke failed ({ret})")
            return outs
        # allocate_invoke: the plugin allocates; copy out + destroy_notify
        ret = self._cls.allocate_invoke(self._priv, ctypes.byref(self._prop),
                                        c_in, c_out)
        if ret > 0:
            return None  # soft drop
        if ret < 0:
            raise RuntimeError(f"custom .so allocate_invoke failed ({ret})")
        for i, t in enumerate(out_info):
            raw = ctypes.string_at(c_out[i].data, c_out[i].size)
            outs.append(np.frombuffer(raw, t.dtype.np_dtype)
                        .reshape(t.shape).copy())
            if self._cls.destroy_notify:
                self._cls.destroy_notify(c_out[i].data)
        return outs

    def close(self) -> None:
        if self._cls.exitfunc:
            self._cls.exitfunc(self._priv, ctypes.byref(self._prop))
