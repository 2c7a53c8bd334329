"""tensor_sparse_enc / tensor_sparse_dec — dense↔sparse stream compression.

Reference: gst/nnstreamer/elements/gsttensor_sparse*.c +
tensor_sparse_util.c:31-162: COO-style packing used to cut bandwidth on
query/edge links for sparse activations. Wire layout is reference-exact:
the 128-byte GstTensorMetaInfo header (format=sparse, nnz in the union
word) followed by the nnz raw VALUES then the nnz uint32 flat indices —
values-first per gst_tensor_sparse_to_dense's
``indices = input + element_size * nnz`` (tensor_sparse_util.c:59-61).

Port of nnstreamer_tpu/elements/sparse.py, byte for byte on the wire. The
codec runs on the host (utils/native.py): the encoder reads a tensor on the
card back once, and the decoder emits host arrays.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np

from ..core.buffer import Buffer, TensorMemory
from ..core.meta import META_SIZE, TensorMetaInfo
from ..core.types import Caps, TensorFormat, TensorInfo
from ..graph.element import Element, FlowReturn, Pad, register_element


def sparse_encode(arr: np.ndarray, info: TensorInfo) -> bytes:
    from ..utils import native

    nz, values = native.sparse_encode_arrays(arr)
    meta = TensorMetaInfo(info, TensorFormat.SPARSE, extra=int(nz.size))
    return meta.pack() + values.tobytes() + nz.tobytes()


def sparse_decode(blob: bytes) -> Tuple[np.ndarray, TensorInfo]:
    from ..utils import native

    meta = TensorMetaInfo.parse(blob)
    if meta.format is not TensorFormat.SPARSE:
        raise ValueError("not a sparse tensor blob")
    nnz = meta.extra
    info = meta.info
    off = META_SIZE
    values = np.frombuffer(blob, info.dtype.np_dtype, count=nnz, offset=off)
    off += nnz * info.dtype.itemsize
    idx = np.frombuffer(blob, np.uint32, count=nnz, offset=off)
    flat = native.sparse_decode_arrays(idx, values, info.num_elements,
                                       info.dtype.np_dtype)
    return flat.reshape(info.shape), info


@register_element
class TensorSparseEnc(Element):
    ELEMENT_NAME = "tensor_sparse_enc"

    def __init__(self, name: Optional[str] = None, **props: Any):
        super().__init__(name, **props)
        self.add_sink_pad(template=Caps.any_tensors())
        self.add_src_pad(template=Caps("other/tensors",
                                       {"format": TensorFormat.SPARSE}))

    def on_caps(self, pad: Pad, caps: Caps) -> None:
        pad.caps = caps
        self.send_caps_all(Caps.tensors(format=TensorFormat.SPARSE))

    def chain(self, pad: Pad, buf: Buffer) -> Optional[FlowReturn]:
        mems = []
        for m in buf.memories:
            blob = sparse_encode(m.host(), m.info)
            mems.append(TensorMemory(np.frombuffer(blob, np.uint8).copy()))
        return self.push(buf.with_memories(mems))


@register_element
class TensorSparseDec(Element):
    ELEMENT_NAME = "tensor_sparse_dec"

    def __init__(self, name: Optional[str] = None, **props: Any):
        super().__init__(name, **props)
        self.add_sink_pad(template=Caps("other/tensors",
                                        {"format": TensorFormat.SPARSE}))
        self.add_src_pad(template=Caps.any_tensors())
        self._caps_sent = False

    def on_caps(self, pad: Pad, caps: Caps) -> None:
        pad.caps = caps
        self._caps_sent = False  # declare static caps from first buffer

    def chain(self, pad: Pad, buf: Buffer) -> Optional[FlowReturn]:
        from ..core.types import TensorsConfig, TensorsInfo

        mems = []
        infos = []
        for m in buf.memories:
            arr, info = sparse_decode(m.host().tobytes())
            mems.append(TensorMemory(arr, info))
            infos.append(info)
        if not self._caps_sent:
            self._caps_sent = True
            cfg = TensorsConfig(TensorsInfo(tuple(infos)))
            self.send_caps_all(Caps.tensors(cfg))
        return self.push(buf.with_memories(mems))
