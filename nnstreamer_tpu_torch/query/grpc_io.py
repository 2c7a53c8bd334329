"""gRPC tensor transport elements; port of nnstreamer_tpu/query/grpc_io.py
(the same message bodies). ``grpc`` is imported where a server or channel
starts, never at module import: without ``grpcio`` the elements raise
ImportError at start, naming it.

Reference: ext/nnstreamer/tensor_source/tensor_src_grpc + tensor_sink_grpc +
extra/nnstreamer_grpc_* (``service TensorService { rpc SendTensors(stream
Tensors); rpc RecvTensors(...) }``, nnstreamer.proto; either side may be the
gRPC server, blocking or async).

Implemented with grpcio's generic handlers (no codegen needed); method
``/nns.TensorService/SendTensors`` (client-streaming push). The message body
is selected by ``idl=``, mirroring the reference's two IDL builds
(nnstreamer_grpc_protobuf.cc / nnstreamer_grpc_flatbuf.cc):

  * ``idl=flex`` (default) — our wire meta-JSON + flex-tensor payload
    (query/protocol.py);
  * ``idl=protobuf`` — proto/tensors.proto messages (converters/protobuf_io,
    on the port's own protobuf codec);
  * ``idl=flatbuf`` — nnstreamer.fbs-layout FlatBuffers frames
    (converters/fb_io, on the port's own FlatBuffers codec),
    byte-compatible with the reference schema.

Elements:

  * ``tensor_grpc_sink`` — client by default (streams buffers to a server),
    or ``server=true`` to serve RecvTensors pulls.
  * ``tensor_grpc_src``  — server by default (receives SendTensors pushes),
    or ``server=false`` to pull RecvTensors from a remote sink-server.
"""

from __future__ import annotations

import queue as _q
import struct
import threading
from typing import Any, Iterator, Optional

from ..core.buffer import Buffer
from ..core.log import logger
from ..core.types import Caps, TensorFormat
from ..graph.element import Element, FlowReturn, Pad, register_element
from ..graph.pipeline import SourceElement
from .protocol import buffer_to_payload, payload_to_buffer

log = logger("grpc")

SEND_METHOD = "/nns.TensorService/SendTensors"
RECV_METHOD = "/nns.TensorService/RecvTensors"


def _encode_flex(buf: Buffer) -> bytes:
    import json

    meta, payload = buffer_to_payload(buf)
    meta_b = json.dumps(meta, separators=(",", ":")).encode()
    return struct.pack("<I", len(meta_b)) + meta_b + payload


def _decode_flex(raw: bytes) -> Buffer:
    import json

    (mlen,) = struct.unpack_from("<I", raw)
    meta = json.loads(raw[4:4 + mlen])
    return payload_to_buffer(meta, raw[4 + mlen:])


def _codec(idl: str):
    """(encode, decode) pair for an IDL name."""
    idl = (idl or "flex").lower()
    if idl == "flex":
        return _encode_flex, _decode_flex
    if idl == "protobuf":
        from ..converters.protobuf_io import frame_to_proto, proto_to_frame

        return frame_to_proto, proto_to_frame
    if idl == "flatbuf":
        from ..converters.fb_io import flatbuf_to_frame, frame_to_flatbuf

        def enc(buf: Buffer) -> bytes:
            return frame_to_flatbuf(buf, buf.config)

        def dec(raw: bytes) -> Buffer:
            return flatbuf_to_frame(raw)[0]

        return enc, dec
    raise ValueError(f"grpc: unknown idl {idl!r} (flex/protobuf/flatbuf)")


@register_element
class TensorGrpcSrc(SourceElement):
    ELEMENT_NAME = "tensor_grpc_src"

    def __init__(self, name: Optional[str] = None, **props: Any):
        self.host = "127.0.0.1"
        self.port = 55115
        self.server = True
        self.idl = "flex"
        super().__init__(name, **props)
        self._encode, self._decode = _codec(self.idl)
        self._inbox: "_q.Queue[Buffer]" = _q.Queue(maxsize=64)
        self._grpc_server = None

    def negotiate(self) -> Caps:
        if self.server:
            self._start_server()
        else:
            self._start_pull_client()
        return Caps.tensors(format=TensorFormat.FLEXIBLE)

    def _start_server(self) -> None:
        import grpc

        element = self

        class Handler(grpc.GenericRpcHandler):
            def service(self, handler_call_details):
                if handler_call_details.method == SEND_METHOD:
                    def send_tensors(request_iterator, context):
                        for raw in request_iterator:
                            element._inbox.put(element._decode(raw))
                        return b""

                    return grpc.stream_unary_rpc_method_handler(
                        send_tensors,
                        request_deserializer=lambda b: b,
                        response_serializer=lambda b: b)
                return None

        from concurrent import futures

        self._grpc_server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
        self._grpc_server.add_generic_rpc_handlers((Handler(),))
        self.bound_port = self._grpc_server.add_insecure_port(
            f"{self.host}:{int(self.port)}")
        self._grpc_server.start()

    def _start_pull_client(self) -> None:
        import grpc

        channel = grpc.insecure_channel(f"{self.host}:{int(self.port)}")
        stream = channel.unary_stream(
            RECV_METHOD, request_serializer=lambda b: b,
            response_deserializer=lambda b: b)

        def pull() -> None:
            try:
                for raw in stream(b""):
                    self._inbox.put(self._decode(raw))
            except grpc.RpcError as e:
                log.warning("grpc pull ended: %s", e)

        threading.Thread(target=pull, daemon=True,
                         name=f"grpc-pull:{self.name}").start()

    def create(self) -> Optional[Buffer]:
        while not self._stop_flag.is_set():
            try:
                return self._inbox.get(timeout=0.1)
            except _q.Empty:
                continue
        return None

    def stop(self) -> None:
        super().stop()
        if self._grpc_server is not None:
            self._grpc_server.stop(grace=0.5)
            self._grpc_server = None


@register_element
class TensorGrpcSink(Element):
    ELEMENT_NAME = "tensor_grpc_sink"

    def __init__(self, name: Optional[str] = None, **props: Any):
        self.host = "127.0.0.1"
        self.port = 55115
        self.server = False
        self.idl = "flex"
        super().__init__(name, **props)
        self._encode, self._decode = _codec(self.idl)
        self.add_sink_pad(template=Caps.any_tensors())
        self._outq: "_q.Queue[Optional[bytes]]" = _q.Queue(maxsize=64)
        self._call_thread: Optional[threading.Thread] = None
        self._grpc_server = None

    def start(self) -> None:
        import grpc

        if self.server:
            element = self

            class Handler(grpc.GenericRpcHandler):
                def service(self, handler_call_details):
                    if handler_call_details.method == RECV_METHOD:
                        def recv_tensors(request, context) -> Iterator[bytes]:
                            while True:
                                item = element._outq.get()
                                if item is None:
                                    return
                                yield item

                        return grpc.unary_stream_rpc_method_handler(
                            recv_tensors,
                            request_deserializer=lambda b: b,
                            response_serializer=lambda b: b)
                    return None

            from concurrent import futures

            self._grpc_server = grpc.server(
                futures.ThreadPoolExecutor(max_workers=4))
            self._grpc_server.add_generic_rpc_handlers((Handler(),))
            self.bound_port = self._grpc_server.add_insecure_port(
                f"{self.host}:{int(self.port)}")
            self._grpc_server.start()
            return

        channel = grpc.insecure_channel(f"{self.host}:{int(self.port)}")
        stream_call = channel.stream_unary(
            SEND_METHOD, request_serializer=lambda b: b,
            response_deserializer=lambda b: b)

        def run_call() -> None:
            def gen() -> Iterator[bytes]:
                while True:
                    item = self._outq.get()
                    if item is None:
                        return
                    yield item

            try:
                stream_call(gen())
            except grpc.RpcError as e:
                self.post_error(f"grpc send failed: {e.code()}")

        self._call_thread = threading.Thread(target=run_call, daemon=True,
                                             name=f"grpc-send:{self.name}")
        self._call_thread.start()

    def chain(self, pad: Pad, buf: Buffer) -> Optional[FlowReturn]:
        self._outq.put(self._encode(buf))
        return FlowReturn.OK

    def stop(self) -> None:
        self._outq.put(None)
        if self._call_thread is not None:
            self._call_thread.join(timeout=5)
            self._call_thread = None
        if self._grpc_server is not None:
            self._grpc_server.stop(grace=0.5)
            self._grpc_server = None
