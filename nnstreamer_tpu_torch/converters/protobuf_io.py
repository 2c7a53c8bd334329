"""Protobuf tensor serialization: decoder mode=protobuf + converter subplugin.

Port of nnstreamer_tpu/converters/protobuf_io.py on the port's own proto3
codec (``proto_codec``; no ``google.protobuf`` needed). Reference:
ext/nnstreamer/tensor_decoder/tensordec-protobuf.cc +
tensor_converter/tensor_converter_protobuf.cc — tensors ↔ protobuf messages
for interop links. Schema: converters/proto/tensors.proto. A message is
byte-identical to the JAX package's ``SerializeToString()``; a timestamp of
0 is a proto3 default, so it comes back as None, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

from ..core.buffer import Buffer, TensorMemory
from ..core.types import Caps, TensorDType, TensorInfo, TensorsConfig, TensorsInfo
from ..decoders.base import Decoder, register_decoder
from . import payload_view, register_converter, wire_bytes
from .proto_codec import FrameMsg, TensorMsg, decode_frame, encode_frame


def proto_blob(buf: Buffer) -> bytearray:
    """``frame_to_proto`` into a fresh ``bytearray``."""
    msg = FrameMsg(pts_ns=buf.pts or 0, duration_ns=buf.duration or 0,
                   offset=buf.offset or 0)
    for m in buf.memories:
        msg.tensors.append(TensorMsg(name=m.info.name or "",
                                     dtype=str(m.info.dtype),
                                     dims=list(m.info.dims),
                                     data=payload_view(m)))
    return encode_frame(msg)


def frame_to_proto(buf: Buffer) -> bytes:
    return bytes(proto_blob(buf))


def proto_to_frame(data: bytes) -> Buffer:
    if not isinstance(data, (bytes, bytearray)):
        data = bytes(data)
    msg = decode_frame(data)
    mems = []
    for t in msg.tensors:
        info = TensorInfo(tuple(t.dims), TensorDType.parse(t.dtype),
                          t.name or None)
        mems.append(TensorMemory.from_bytes(t.data, info))
    return Buffer(mems, pts=msg.pts_ns or None,
                  duration=msg.duration_ns or None,
                  offset=msg.offset or None)


@register_decoder
class ProtobufDecoder(Decoder):
    """tensors → other/protobuf frames (reference media name — the
    converter auto-dispatches its protobuf subplugin from the caps)."""

    MODE = "protobuf"

    def out_caps(self, config: TensorsConfig) -> Caps:
        return Caps("other/protobuf")

    def decode(self, buf: Buffer, config: TensorsConfig) -> Buffer:
        blob = np.frombuffer(proto_blob(buf), np.uint8)
        return buf.with_memories([TensorMemory(blob)])


def _protobuf_converter(buf: Buffer, props) -> tuple:
    frame = proto_to_frame(wire_bytes(buf))
    cfg = TensorsConfig(TensorsInfo(tuple(m.info for m in frame.memories)))
    return frame.memories, cfg


register_converter("protobuf", _protobuf_converter)
