"""tensor_query wire protocol — port of nnstreamer_tpu/query/protocol.py,
byte for byte on the wire.

Reference: gst/nnstreamer/tensor_query/tensor_query_common.c/.h — commands
REQUEST_INFO/RESPOND_APPROVE/RESPOND_DENY/TRANSFER_START/DATA/END/CLIENT_ID
(:42-51) with a C-struct data header (:57-68) over raw GSocket TCP.

Framing (plain TCP; one message per frame instead of the reference's
START/DATA×N/END triple — fewer round trips on the offload hot path):

    magic   u32  0x4E515250 ("NQRP")
    cmd     u8
    meta_len u32 (LE)
    payload_len u64 (LE)
    meta    JSON (caps/config, pts/duration, tensor sizes, client id)
    payload concatenated tensor blobs (each = 128B flex meta header + raw
            bytes; sparse tensors use the sparse wire layout)

Payloads are framework-agnostic bytes, so a port peer and a JAX peer talk
to each other. A tensor on the card becomes wire bytes through one
device-to-host copy (``TensorMemory.host()``, or the event of an earlier
``prefetch()``); received bytes become host ``TensorMemory`` objects, which
the next device element copies up. Compression: ``sparse=true`` in meta
marks sparse-encoded payloads (tensor_sparse_enc on the link).
"""

from __future__ import annotations

import enum
import json
import socket
import struct
from typing import Any, Dict, List, Optional, Tuple

from ..core.buffer import Buffer, TensorMemory
from ..core.meta import unwrap_flex, wrap_flex
from ..obs import metrics as _obs
from ..obs import tracing as _tracing

MAGIC = 0x4E515250
_HEADER = struct.Struct("<IBIQ")
MAX_MESSAGE = 1 << 31


class Cmd(enum.IntEnum):
    INFO_REQ = 1      # client → server: hello + stream caps
    INFO_APPROVE = 2  # server → client: accepted (+server caps)
    INFO_DENY = 3
    DATA = 4          # client → server: one frame
    RESULT = 5        # server → client: one result frame
    ERROR = 6
    PING = 7
    PONG = 8
    # chunked transfer (reference TRANSFER_START/DATA/END,
    # tensor_query_common.h:42-68): payloads over CHUNK_SIZE stream as
    # bounded chunks with a per-chunk receive timeout, assembled into one
    # preallocated buffer (no monolithic send, no unbounded recv stall)
    CHUNK_START = 9
    CHUNK_DATA = 10
    CHUNK_END = 11
    # fleet observability piggyback: a client ships its metric/health/span
    # snapshot ahead of a DATA frame; fire-and-forget (no reply frame)
    OBS_PUSH = 12
    # disaggregated serving: one finished KV radix path migrates
    # prefill→decode backend; the receiver answers RESULT (pages spliced)
    # or ERROR (rejected)
    KV_PAGE_XFER = 13


class QueryProtocolError(RuntimeError):
    pass


#: wire-level telemetry shared by BOTH roles (client and server live in
#: one process in tests and hybrid deployments): message counts by
#: direction x command, and payload bytes by direction. Registered at
#: import; recording is a no-op until metrics are enabled.
_MSG_TOTAL = _obs.registry().counter(
    "nnstpu_query_messages_total",
    "Query protocol messages by direction and command",
    ("direction", "cmd"))
_BYTES_TOTAL = _obs.registry().counter(
    "nnstpu_query_bytes_total",
    "Query protocol payload bytes by direction", ("direction",))


#: chaos injection point (resilience/chaos.py installs/clears this):
#: called as ``hook(direction, cmd, meta, payload, endpoint) ->
#: payload|None`` at the top of send_message ("send") and per received
#: frame ("recv"); ``endpoint`` is the socket's peer as "host:port"
#: (None when unresolvable) so a plan can target one backend of a
#: routed set. None return drops the frame, a raise propagates into
#: the caller's normal error handling. Disabled cost: one global load
#: + None check — the peer lookup only happens with a hook installed.
CHAOS_HOOK = None


def _peer_of(sock: socket.socket) -> Optional[str]:
    """The socket's peer as ``"host:port"`` — chaos targeting only, so
    failure is answered with None, never an exception."""
    try:
        peer = sock.getpeername()
        return f"{peer[0]}:{peer[1]}"
    except Exception:
        return None

#: max bytes per wire chunk; also the granularity of receive timeouts
CHUNK_SIZE = 1 << 20
#: a chunk that doesn't arrive within this window fails the transfer —
#: per-chunk progress detection instead of one whole-payload stall
CHUNK_TIMEOUT = 15.0


def pack_message(cmd: Cmd, meta: Dict[str, Any], payload: bytes = b"") -> bytes:
    meta_b = json.dumps(meta, separators=(",", ":")).encode("utf-8")
    return _HEADER.pack(MAGIC, int(cmd), len(meta_b), len(payload)) + meta_b + payload


def _pack_frame_header(cmd: Cmd, meta: Dict[str, Any],
                       payload_len: int) -> bytes:
    """Header + meta only, declaring ``payload_len`` bytes to follow —
    lets send_message stream a memoryview payload without concatenating
    (and therefore copying) it into one bytes object first."""
    meta_b = json.dumps(meta, separators=(",", ":")).encode("utf-8")
    return _HEADER.pack(MAGIC, int(cmd), len(meta_b), payload_len) + meta_b


def recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly n bytes (list-accumulated; O(n) for large payloads)."""
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            raise ConnectionError("peer closed")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def _recv_one(sock: socket.socket) -> Tuple[Cmd, Dict[str, Any], bytes]:
    hdr = recv_exact(sock, _HEADER.size)
    magic, cmd, meta_len, payload_len = _HEADER.unpack(hdr)
    if magic != MAGIC:
        raise QueryProtocolError(f"bad magic 0x{magic:08x}")
    if payload_len > MAX_MESSAGE:
        raise QueryProtocolError(f"payload too large: {payload_len}")
    meta = json.loads(recv_exact(sock, meta_len) or b"{}")
    payload = recv_exact(sock, payload_len) if payload_len else b""
    return Cmd(cmd), meta, payload


def recv_message(sock: socket.socket,
                 chunk_timeout: float = CHUNK_TIMEOUT
                 ) -> Tuple[Cmd, Dict[str, Any], bytes]:
    cmd, meta, payload = _recv_one(sock)
    if CHAOS_HOOK is not None:
        payload = CHAOS_HOOK("recv", cmd, meta, payload, _peer_of(sock))
        if payload is None:
            # frame dropped by the fault plan: deliver the next one —
            # from the caller's view the frame simply never arrived
            return recv_message(sock, chunk_timeout)
    if cmd is not Cmd.CHUNK_START:
        _MSG_TOTAL.labels("recv", cmd.name).inc()
        _BYTES_TOTAL.labels("recv").inc(len(payload))
        return cmd, meta, payload
    # chunked transfer: assemble into a preallocated buffer under a
    # per-chunk timeout
    try:
        total = int(meta.pop("chunked_total"))
        inner = Cmd(int(meta.pop("chunked_cmd")))
    except (KeyError, ValueError, TypeError) as e:
        # TypeError included: {"chunked_total": null} decodes to None
        # and int(None) must fail the transfer, not the receive loop
        raise QueryProtocolError(f"bad CHUNK_START meta: {e}")
    if total > MAX_MESSAGE or total < 0:
        raise QueryProtocolError(f"chunked payload too large: {total}")
    # chunked assembly is the one receive with real duration: time it
    # as a span parented on the sender's context when one rode along
    rspan = _tracing.NOOP_SPAN
    if _tracing.enabled():
        rctx = _tracing.ctx_from_wire(meta.get(_tracing.TRACE_META_KEY))
        if rctx is not None:
            _tracing.store().mark_export(rctx.trace_id)
            rspan = _tracing.start_span(
                "query.recv", parent=rctx,
                attrs={"cmd": Cmd(inner).name, "bytes": total})
    assembled = bytearray(total)
    got = 0
    prev_timeout = sock.gettimeout()
    sock.settimeout(chunk_timeout)
    try:
        while True:
            try:
                ccmd, cmeta, chunk = _recv_one(sock)
            except socket.timeout:
                raise QueryProtocolError(
                    f"chunk timeout after {got}/{total} bytes "
                    f"({chunk_timeout}s without progress)")
            if ccmd is Cmd.CHUNK_DATA:
                off = int(cmeta.get("off", -1))
                if off != got:
                    # offsets must be strictly sequential: a duplicate or
                    # overlapping chunk would otherwise inflate the byte
                    # counter and let a hole pass the completeness check
                    raise QueryProtocolError(
                        f"chunk out of order: off={off}, expected {got}")
                if off + len(chunk) > total:
                    raise QueryProtocolError(
                        f"chunk out of bounds: off={off} len={len(chunk)}")
                assembled[off:off + len(chunk)] = chunk
                got += len(chunk)
            elif ccmd is Cmd.CHUNK_END:
                if got != total:
                    raise QueryProtocolError(
                        f"chunked transfer incomplete: {got}/{total} bytes")
                _MSG_TOTAL.labels("recv", inner.name).inc()
                _BYTES_TOTAL.labels("recv").inc(total)
                rspan.end()
                return inner, meta, bytes(assembled)
            else:
                raise QueryProtocolError(
                    f"unexpected {ccmd.name} inside chunked transfer")
    except QueryProtocolError:
        rspan.set_attribute("error", True)
        rspan.end()
        raise
    finally:
        sock.settimeout(prev_timeout)


def send_message(sock: socket.socket, cmd: Cmd, meta: Dict[str, Any],
                 payload: bytes = b"") -> None:
    if CHAOS_HOOK is not None:
        payload = CHAOS_HOOK("send", cmd, meta, payload, _peer_of(sock))
        if payload is None:
            return  # frame silently eaten by the installed fault plan
    _MSG_TOTAL.labels("sent", cmd.name).inc()
    _BYTES_TOTAL.labels("sent").inc(len(payload))
    span = _tracing.NOOP_SPAN
    if _tracing.enabled():
        # stamp the caller's context into the wire meta so the peer can
        # adopt it as a remote parent; the send itself becomes a span.
        # Disabled path: no flag set, no `trace` key, zero wire bytes
        # added — the cross-wire format is strictly additive.
        ctx = _tracing.current_context()
        if ctx is not None and _tracing.TRACE_META_KEY not in meta:
            meta = dict(meta)
            meta[_tracing.TRACE_META_KEY] = ctx.to_wire()
            # the trace id now exists on two hosts: mark it for export
            _tracing.store().mark_export(ctx.trace_id)
            span = _tracing.start_span(
                "query.send", parent=ctx,
                attrs={"cmd": cmd.name, "bytes": len(payload)})
    try:
        if len(payload) <= CHUNK_SIZE:
            sock.sendall(pack_message(cmd, meta, payload))
            return
        start = dict(meta, chunked_cmd=int(cmd), chunked_total=len(payload))
        sock.sendall(pack_message(Cmd.CHUNK_START, start))
        view = memoryview(payload)
        for off in range(0, len(payload), CHUNK_SIZE):
            chunk = view[off:off + CHUNK_SIZE]
            # header+meta first, then the memoryview slice straight to
            # the socket: the payload bytes are never copied on the
            # send side (sendall accepts buffer-protocol objects)
            sock.sendall(_pack_frame_header(
                Cmd.CHUNK_DATA, {"off": off}, len(chunk)))
            sock.sendall(chunk)
        sock.sendall(pack_message(Cmd.CHUNK_END, {}))
    finally:
        span.end()


# --------------------------------------------------------------------------- #
# Buffer ↔ payload
# --------------------------------------------------------------------------- #

def buffer_to_payload(buf: Buffer, sparse: bool = False) -> Tuple[Dict[str, Any], bytes]:
    """Frame → (meta, payload). A memory on the card is read back once
    (its ``prefetch()`` event when one was issued on the producing thread,
    else a synchronous copy on the caller's stream); bfloat16 crosses as
    its raw bits under its ``TensorInfo``."""
    from ..elements.sparse import sparse_encode

    blobs: List[bytes] = []
    for m in buf.memories:
        if sparse:
            blobs.append(sparse_encode(m.host(), m.info))
        else:
            blobs.append(wrap_flex(m.tobytes(), m.info))
    meta = {
        "pts": buf.pts,
        "duration": buf.duration,
        "offset": buf.offset,
        "num_tensors": len(blobs),
        "sizes": [len(b) for b in blobs],
        "sparse": sparse,
    }
    return meta, b"".join(blobs)


def payload_to_buffer(meta: Dict[str, Any], payload: bytes) -> Buffer:
    """(meta, payload) → a frame of host memories."""
    from ..elements.sparse import sparse_decode

    mems: List[TensorMemory] = []
    off = 0
    for size in meta.get("sizes", []):
        blob = payload[off:off + size]
        off += size
        if meta.get("sparse"):
            arr, info = sparse_decode(blob)
            mems.append(TensorMemory(arr, info))
        else:
            tmeta, raw = unwrap_flex(blob)
            mems.append(TensorMemory.from_bytes(raw[:tmeta.info.size_bytes],
                                                tmeta.info))
    return Buffer(mems, pts=meta.get("pts"), duration=meta.get("duration"),
                  offset=meta.get("offset"))
