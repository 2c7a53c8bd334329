"""Self-describing tensor headers for flexible/sparse streams and wire links.

Byte-exact implementation of the reference's ``GstTensorMetaInfo``
(tensor_typedef.h:282-297) and its pack/parse helpers
(``gst_tensor_meta_info_update_header`` / ``_parse_header``,
tensor_common.c:1566-1718, consumed by tensor_filter at
tensor_filter.c:598-604 to strip headers before invoke) — so a flexible or
sparse stream produced here parses on an upstream nnstreamer peer and vice
versa.

Wire layout (little-endian uint32 words, 128 bytes fixed — the v1 header
size returned by ``gst_tensor_meta_info_get_header_size``):

    word    field
    0       version: 0xDE000000 | major<<12 | minor  (v1.0 = 0xDE001000)
    1       type: reference ``tensor_type`` enum (int32=0 .. uint64=9)
    2..17   dimension[16] (uint32, innermost-first; first 0 terminates the
            rank — NNS_TENSOR_META_RANK_LIMIT=16, tensor_typedef.h:44)
    18      format: 0 static, 1 flexible, 2 sparse (``tensor_format``)
    19      media_type: ``media_type`` enum (video=0, audio=1, text=2,
            octet=3, tensor=4)
    20      sparse nnz (GstSparseTensorInfo union member; 0 otherwise)
    21..31  zero pad to 128 bytes

bfloat16/float16 are TPU-local dtypes with no ``tensor_type`` enum value.
They pack with EXTENSION codes 100/101 — deliberately past ``_NNS_END`` so
a reference peer's ``gst_tensor_meta_info_validate`` rejects the header
cleanly (``type >= _NNS_END``) instead of misparsing bytes, while
TPU-to-TPU flexible/sparse links (query serving with precision=bf16) keep
working. Typecast to a reference dtype before interoperating with an
upstream nnstreamer peer; the flatbuf/flexbuf serializers
(converters/fb_io.py) stay strict because their schema enum is fixed.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Tuple

from .types import TensorDType, TensorFormat, TensorInfo

#: GST_TENSOR_META_MAKE_VERSION(1,0) (tensor_common.c:1477-1482)
META_VERSION = 0xDE001000
_VERSION_MASK = 0xDE000000
META_SIZE = 128
_MAX_META_DIMS = 16  # NNS_TENSOR_META_RANK_LIMIT

#: reference ``tensor_type`` enum order (tensor_typedef.h:153-167)
DTYPE_CODES = [
    TensorDType.INT32, TensorDType.UINT32, TensorDType.INT16,
    TensorDType.UINT16, TensorDType.INT8, TensorDType.UINT8,
    TensorDType.FLOAT64, TensorDType.FLOAT32,
    TensorDType.INT64, TensorDType.UINT64,
]
_DTYPE_TO_CODE = {d: i for i, d in enumerate(DTYPE_CODES)}
#: TPU-local extension codes, intentionally >= _NNS_END (see module doc)
_EXT_DTYPE_CODES = {TensorDType.BFLOAT16: 100, TensorDType.FLOAT16: 101}
_DTYPE_TO_CODE.update(_EXT_DTYPE_CODES)
_CODE_TO_DTYPE = {v: k for k, v in _DTYPE_TO_CODE.items()}

FORMAT_CODES = [TensorFormat.STATIC, TensorFormat.FLEXIBLE,
                TensorFormat.SPARSE]
_FORMAT_TO_CODE = {f: i for i, f in enumerate(FORMAT_CODES)}

#: ``media_type`` enum (tensor_typedef.h:178-187); "other/tensors" = _NNS_TENSOR
MEDIA_CODES = {
    "video/x-raw": 0,
    "audio/x-raw": 1,
    "text/x-raw": 2,
    "application/octet-stream": 3,
    "other/tensors": 4,
}
_CODE_TO_MEDIA = {v: k for k, v in MEDIA_CODES.items()}

_HEADER_STRUCT = struct.Struct("<II16III I")  # words 0..20
assert _HEADER_STRUCT.size == 84


@dataclass(frozen=True)
class TensorMetaInfo:
    """Self-describing header for one tensor payload."""

    info: TensorInfo
    format: TensorFormat = TensorFormat.FLEXIBLE
    media_type: str = "other/tensors"
    extra: int = 0  # sparse: nnz; otherwise 0

    def pack(self) -> bytes:
        code = _DTYPE_TO_CODE.get(self.info.dtype)
        if code is None:
            raise ValueError(
                f"dtype {self.info.dtype} has no tensor_type wire code")
        if len(self.info.dims) > _MAX_META_DIMS:
            # truncating would emit a header describing a smaller tensor
            # than the payload — the peer's size check then fails opaquely
            raise ValueError(
                f"tensor rank {len(self.info.dims)} exceeds the wire "
                f"header's {_MAX_META_DIMS}-dim limit")
        dims = list(self.info.dims)
        dims += [0] * (_MAX_META_DIMS - len(dims))  # 0-terminated rank
        raw = _HEADER_STRUCT.pack(
            META_VERSION, code, *dims,
            _FORMAT_TO_CODE[self.format],
            MEDIA_CODES.get(self.media_type, 4),
            self.extra,
        )
        return raw + b"\x00" * (META_SIZE - len(raw))

    @classmethod
    def parse(cls, data: bytes) -> "TensorMetaInfo":
        if len(data) < META_SIZE:
            raise ValueError(
                f"meta header truncated: {len(data)} < {META_SIZE}")
        fields = _HEADER_STRUCT.unpack_from(data)
        version, dtype_c = fields[0], fields[1]
        dims_raw = fields[2:2 + _MAX_META_DIMS]
        fmt_c, media_c, extra = fields[18], fields[19], fields[20]
        if (version & _VERSION_MASK) != _VERSION_MASK:
            raise ValueError(f"bad meta version word 0x{version:08x} "
                             "(GST_TENSOR_META_VERSION_VALID fails)")
        if ((version >> 12) & 0xFFF) != 1:
            # only v1 headers have a defined 128-byte layout
            # (GST_TENSOR_META_IS_V1, tensor_common.c:1487 — strict major
            # equality here: the reference's bit-test would let a v3/v5
            # header parse with v1 field offsets)
            raise ValueError(f"meta version word 0x{version:08x} is not v1")
        if dtype_c not in _CODE_TO_DTYPE:
            raise ValueError(f"unknown tensor_type enum {dtype_c}")
        if fmt_c >= len(FORMAT_CODES):
            raise ValueError(f"unknown tensor_format enum {fmt_c}")
        dims = []
        for d in dims_raw:  # first zero terminates the rank (ref validate)
            if d == 0:
                break
            dims.append(int(d))
        if not dims:
            raise ValueError("meta header with dimension[0]=0")
        info = TensorInfo(tuple(dims), _CODE_TO_DTYPE[dtype_c])
        return cls(info, FORMAT_CODES[fmt_c],
                   _CODE_TO_MEDIA.get(media_c, "other/tensors"), extra)

    @property
    def payload_size(self) -> int:
        """``gst_tensor_meta_info_get_data_size``: dense byte size, or for
        sparse the packed values+indices size."""
        if self.format is TensorFormat.SPARSE:
            return self.extra * (self.info.dtype.itemsize + 4)
        return self.info.size_bytes


def wrap_flex(payload: bytes, info: TensorInfo,
              media_type: str = "other/tensors") -> bytes:
    """Prefix a raw tensor payload with a flexible-format header
    (``gst_tensor_meta_info_append_header``)."""
    return TensorMetaInfo(
        info, TensorFormat.FLEXIBLE, media_type).pack() + payload


def unwrap_flex(data: bytes) -> Tuple[TensorMetaInfo, bytes]:
    """Split a flex-format blob into (meta, payload); validates size."""
    meta = TensorMetaInfo.parse(data)
    payload = data[META_SIZE:]
    if len(payload) < meta.payload_size:
        raise ValueError(
            f"flex payload truncated: {len(payload)} < {meta.payload_size}")
    return meta, payload
