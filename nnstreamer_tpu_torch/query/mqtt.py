"""MQTT 3.1.1 wire protocol: packet codec, minimal broker, client, SNTP —
port of nnstreamer_tpu/query/mqtt.py, byte for byte on the wire.

Reference: gst/mqtt/ — mqttsink/mqttsrc publish GStreamer buffers through a
real MQTT broker (paho-mqtt-c), prepending a fixed 1024-byte
``GstMQTTMessageHdr`` (mqttcommon.h:29-63) to every message and timestamping
with an NTP-derived Unix epoch (ntputil.c ``ntputil_get_epoch``).

This module speaks genuine **MQTT 3.1.1 (protocol level 4)** frames —
CONNECT/CONNACK, SUBSCRIBE/SUBACK (with ``+``/``#`` wildcards),
PUBLISH (QoS 0), UNSUBSCRIBE/UNSUBACK, PINGREQ/PINGRESP, DISCONNECT — so
the elements interoperate with any standard broker (mosquitto, EMQX, …);
``MqttBroker`` is a built-in spec-subset broker for tests and single-host
deployments.  ``MessageHdr`` reproduces the reference header's exact binary
layout (same offsets, 1024 bytes) so an upstream subscriber can parse our
messages' metadata.  ``ntp_epoch_us`` is a real SNTP client with the
reference's conversion semantics (µs since Unix epoch, 1900→1970 delta).
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..core.log import logger
from ..graph.element import join_or_warn
from .protocol import recv_exact as _recv_exact

log = logger("mqtt")

# -- packet types (MQTT 3.1.1 §2.2.1) --------------------------------------- #
CONNECT, CONNACK = 1, 2
PUBLISH = 3
PUBACK = 4
SUBSCRIBE, SUBACK = 8, 9
UNSUBSCRIBE, UNSUBACK = 10, 11
PINGREQ, PINGRESP = 12, 13
DISCONNECT = 14

PROTOCOL_NAME = b"MQTT"
PROTOCOL_LEVEL = 4  # 3.1.1


# --------------------------------------------------------------------------- #
# primitives
# --------------------------------------------------------------------------- #

def encode_remaining_length(n: int) -> bytes:
    """Variable-length remaining-length field (§2.2.3, 128-base varint)."""
    if n < 0 or n > 268_435_455:
        raise ValueError(f"remaining length out of range: {n}")
    out = bytearray()
    while True:
        n, digit = divmod(n, 128)
        out.append(digit | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _utf8_field(s: bytes) -> bytes:
    if len(s) > 0xFFFF:
        raise ValueError("utf8 field too long")
    return struct.pack(">H", len(s)) + s


def _packet(ptype: int, flags: int, body: bytes) -> bytes:
    return bytes([(ptype << 4) | flags]) + encode_remaining_length(len(body)) + body


# --------------------------------------------------------------------------- #
# encoders
# --------------------------------------------------------------------------- #

def encode_connect(client_id: str, keep_alive: int = 60,
                   clean_session: bool = True) -> bytes:
    flags = 0x02 if clean_session else 0x00
    body = (_utf8_field(PROTOCOL_NAME) + bytes([PROTOCOL_LEVEL, flags])
            + struct.pack(">H", keep_alive) + _utf8_field(client_id.encode()))
    return _packet(CONNECT, 0, body)


def encode_connack(session_present: bool = False, return_code: int = 0) -> bytes:
    return _packet(CONNACK, 0, bytes([1 if session_present else 0, return_code]))


def encode_publish(topic: str, payload: bytes, qos: int = 0,
                   retain: bool = False, packet_id: int = 0) -> bytes:
    flags = (qos << 1) | (1 if retain else 0)
    body = _utf8_field(topic.encode())
    if qos > 0:
        body += struct.pack(">H", packet_id)
    return _packet(PUBLISH, flags, body + payload)


def encode_subscribe(packet_id: int, topics: Sequence[Tuple[str, int]]) -> bytes:
    body = struct.pack(">H", packet_id)
    for topic, qos in topics:
        body += _utf8_field(topic.encode()) + bytes([qos])
    return _packet(SUBSCRIBE, 0x2, body)  # reserved flags 0010 (§3.8.1)


def encode_suback(packet_id: int, return_codes: Sequence[int]) -> bytes:
    return _packet(SUBACK, 0, struct.pack(">H", packet_id) + bytes(return_codes))


def encode_puback(packet_id: int) -> bytes:
    return _packet(PUBACK, 0, struct.pack(">H", packet_id))


def encode_unsubscribe(packet_id: int, topics: Sequence[str]) -> bytes:
    body = struct.pack(">H", packet_id)
    for t in topics:
        body += _utf8_field(t.encode())
    return _packet(UNSUBSCRIBE, 0x2, body)


def encode_unsuback(packet_id: int) -> bytes:
    return _packet(UNSUBACK, 0, struct.pack(">H", packet_id))


def encode_pingreq() -> bytes:
    return _packet(PINGREQ, 0, b"")


def encode_pingresp() -> bytes:
    return _packet(PINGRESP, 0, b"")


def encode_disconnect() -> bytes:
    return _packet(DISCONNECT, 0, b"")


# --------------------------------------------------------------------------- #
# decoders
# --------------------------------------------------------------------------- #

#: mid-frame read budget once a packet's first byte has arrived: a frame
#: must either complete or the connection is declared broken — a short poll
#: timeout must never tear a partially-read frame (stream desync)
FRAME_TIMEOUT = 30.0


def read_packet(sock: socket.socket,
                first: Optional[int] = None) -> Tuple[int, int, bytes]:
    """Read one MQTT control packet → (type, flags, body). ``first`` is the
    already-consumed fixed-header byte when the caller polled for it."""
    if first is None:
        first = _recv_exact(sock, 1)[0]
    ptype, flags = first >> 4, first & 0x0F
    mult, length = 1, 0
    for _ in range(4):
        digit = _recv_exact(sock, 1)[0]
        length += (digit & 0x7F) * mult
        if not digit & 0x80:
            break
        mult *= 128
    else:
        raise ValueError("malformed remaining length")
    body = _recv_exact(sock, length) if length else b""
    return ptype, flags, body


def _take_utf8(body: bytes, off: int) -> Tuple[bytes, int]:
    (n,) = struct.unpack_from(">H", body, off)
    off += 2
    return body[off:off + n], off + n


def parse_connect(body: bytes) -> Dict[str, Any]:
    name, off = _take_utf8(body, 0)
    if name != PROTOCOL_NAME:
        raise ValueError(f"not an MQTT 3.1.1 CONNECT (protocol {name!r})")
    level, flags = body[off], body[off + 1]
    (keep_alive,) = struct.unpack_from(">H", body, off + 2)
    client_id, off = _take_utf8(body, off + 4)
    return {"level": level, "clean_session": bool(flags & 0x02),
            "keep_alive": keep_alive, "client_id": client_id.decode()}


def parse_publish(flags: int, body: bytes) -> Tuple[str, bytes, int, int]:
    """→ (topic, payload, qos, packet_id) — packet_id 0 for QoS 0."""
    topic, off = _take_utf8(body, 0)
    qos = (flags >> 1) & 0x3
    packet_id = 0
    if qos > 0:
        (packet_id,) = struct.unpack_from(">H", body, off)
        off += 2
    return topic.decode(), body[off:], qos, packet_id


def parse_subscribe(body: bytes) -> Tuple[int, List[Tuple[str, int]]]:
    (packet_id,) = struct.unpack_from(">H", body, 0)
    off, topics = 2, []
    while off < len(body):
        t, off = _take_utf8(body, off)
        topics.append((t.decode(), body[off]))
        off += 1
    return packet_id, topics


def parse_unsubscribe(body: bytes) -> Tuple[int, List[str]]:
    (packet_id,) = struct.unpack_from(">H", body, 0)
    off, topics = 2, []
    while off < len(body):
        t, off = _take_utf8(body, off)
        topics.append(t.decode())
    return packet_id, topics


def topic_matches(filt: str, name: str) -> bool:
    """MQTT topic-filter matching with ``+`` (one level) and ``#`` (tail)."""
    fparts, nparts = filt.split("/"), name.split("/")
    for i, fp in enumerate(fparts):
        if fp == "#":
            return True
        if i >= len(nparts):
            return False
        if fp != "+" and fp != nparts[i]:
            return False
    return len(fparts) == len(nparts)


# --------------------------------------------------------------------------- #
# GstMQTTMessageHdr — reference-exact binary layout (mqttcommon.h:29-63)
# --------------------------------------------------------------------------- #

HDR_LEN = 1024            # GST_MQTT_LEN_MSG_HDR
MAX_CAPS_LEN = 512        # GST_MQTT_MAX_LEN_GST_CAPS_STR
MAX_NUM_MEMS = 16         # GST_MQTT_MAX_NUM_MEMS

#: C layout: guint num_mems; [4-byte alignment pad]; gsize size_mems[16];
#: gint64 base_time_epoch; gint64 sent_time_epoch; GstClockTime duration,
#: dts, pts; gchar gst_caps_str[512]; zero-padded to 1024 bytes.
_HDR = struct.Struct("<I4x16QqqQQQ512s")
CLOCK_NONE_U64 = 0xFFFFFFFFFFFFFFFF  # GST_CLOCK_TIME_NONE


@dataclass
class MessageHdr:
    num_mems: int = 0
    size_mems: Tuple[int, ...] = ()
    base_time_epoch: int = 0   # µs, Unix epoch (reference semantics)
    sent_time_epoch: int = 0   # µs
    duration: Optional[int] = None  # ns (GstClockTime)
    dts: Optional[int] = None
    pts: Optional[int] = None
    caps_str: str = ""

    def pack(self) -> bytes:
        if self.num_mems > MAX_NUM_MEMS or len(self.size_mems) > MAX_NUM_MEMS:
            raise ValueError(
                f"{self.num_mems} memories exceed the header's "
                f"GST_MQTT_MAX_NUM_MEMS={MAX_NUM_MEMS}")
        sizes = list(self.size_mems)
        sizes += [0] * (MAX_NUM_MEMS - len(sizes))
        caps = self.caps_str.encode()[:MAX_CAPS_LEN - 1]
        body = _HDR.pack(
            self.num_mems, *sizes,
            self.base_time_epoch, self.sent_time_epoch,
            CLOCK_NONE_U64 if self.duration is None else self.duration,
            CLOCK_NONE_U64 if self.dts is None else self.dts,
            CLOCK_NONE_U64 if self.pts is None else self.pts,
            caps)
        return body + b"\x00" * (HDR_LEN - len(body))

    @classmethod
    def unpack(cls, data: bytes) -> "MessageHdr":
        if len(data) < HDR_LEN:
            raise ValueError(f"MQTT message header truncated: {len(data)}")
        vals = _HDR.unpack_from(data, 0)
        num = vals[0]
        if num > MAX_NUM_MEMS:
            raise ValueError(f"num_mems {num} exceeds {MAX_NUM_MEMS}")
        sizes = vals[1:17]
        dur, dts, pts = vals[19], vals[20], vals[21]
        caps = vals[22].split(b"\x00", 1)[0].decode(errors="replace")
        return cls(num_mems=num, size_mems=tuple(sizes[:num]),
                   base_time_epoch=vals[17], sent_time_epoch=vals[18],
                   duration=None if dur == CLOCK_NONE_U64 else dur,
                   dts=None if dts == CLOCK_NONE_U64 else dts,
                   pts=None if pts == CLOCK_NONE_U64 else pts,
                   caps_str=caps)


# --------------------------------------------------------------------------- #
# SNTP (ntputil.c ntputil_get_epoch semantics)
# --------------------------------------------------------------------------- #

NTP_DELTA = 2_208_988_800  # seconds 1900→1970 (NTPUTIL_TIMESTAMP_DELTA)
NTP_DEFAULT = ("pool.ntp.org", 123)


def ntp_epoch_us(hosts: Sequence[Tuple[str, int]] = (),
                 timeout: float = 2.0) -> int:
    """Unix-epoch µs from the first reachable NTP server (48-byte SNTP
    mode-3 query; transmit timestamp at offset 40, converted exactly as the
    reference: (sec − 1900→1970 delta)·1e6 + frac/2³²·1e6).  Raises
    OSError if no server answers."""
    candidates = list(hosts) or [NTP_DEFAULT]
    last_err: Optional[Exception] = None
    for host, port in candidates:
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            sock.settimeout(timeout)
            pkt = bytearray(48)
            pkt[0] = 0x1B  # LI=0 VN=3 Mode=3 (client)
            sock.sendto(bytes(pkt), (host, int(port)))
            data, _ = sock.recvfrom(48)
            if len(data) < 48:
                raise OSError("short NTP response")
            # SNTP (RFC 4330) reply parsing: the pack side lives on the
            # NTP server, not in this codebase
            # nnslint: disable=wire/struct-format
            sec, frac = struct.unpack_from(">II", data, 40)
            if sec <= NTP_DELTA:
                raise OSError(f"NTP transmit timestamp invalid: {sec}")
            return ((sec - NTP_DELTA) * 1_000_000
                    + int(frac / 4294967295.0 * 1_000_000))
        except OSError as e:
            last_err = e
        finally:
            sock.close()
    raise OSError(f"no NTP server reachable: {last_err}")


def get_epoch_us(ntp_hosts: Optional[Sequence[Tuple[str, int]]] = None) -> int:
    """Publisher clock: NTP when hosts are configured (falling back on
    failure), else the system real-time clock (the reference's
    ``default_mqtt_get_unix_epoch`` ≙ g_get_real_time)."""
    if ntp_hosts:
        try:
            return ntp_epoch_us(ntp_hosts)
        except OSError as e:
            log.warning("NTP sync failed (%s); using system clock", e)
    return time.time_ns() // 1000


# --------------------------------------------------------------------------- #
# broker
# --------------------------------------------------------------------------- #

class MqttBroker:
    """Minimal MQTT 3.1.1 broker: CONNECT handshake, QoS-0 fanout with
    ``+``/``#`` wildcard subscriptions, ping, unsubscribe. Accepts any
    spec-conforming client."""

    def __init__(self, host: str = "127.0.0.1", port: int = 1883):
        self._subs: List[Tuple[str, socket.socket]] = []  # guarded-by: _lock
        self._lock = threading.Lock()
        #: per-subscriber write locks: concurrent publishers must not
        #: interleave frame bytes on one subscriber socket
        self._wlocks: Dict[int, threading.Lock] = {}  # guarded-by: _lock
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(64)
        self._listener.settimeout(0.2)
        self.host, self.port = self._listener.getsockname()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MqttBroker":
        self._thread = threading.Thread(target=self._accept_loop, daemon=True,
                                        name="mqtt-broker")
        self._thread.start()
        return self

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            # Nagle + delayed ACK stalls small PUBLISH forwards ~40 ms
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._conn_loop, args=(conn,),
                             daemon=True).start()

    def _conn_loop(self, conn: socket.socket) -> None:
        try:
            ptype, _, body = read_packet(conn)
            if ptype != CONNECT:
                return
            info = parse_connect(body)
            if info["level"] != PROTOCOL_LEVEL:
                conn.sendall(encode_connack(return_code=0x01))  # bad version
                return
            conn.sendall(encode_connack())
            while not self._stop.is_set():
                ptype, flags, body = read_packet(conn)
                if ptype == PUBLISH:
                    topic, payload, qos, pid = parse_publish(flags, body)
                    if qos == 1:
                        conn.sendall(encode_puback(pid))
                    self._fanout(topic, payload)
                elif ptype == SUBSCRIBE:
                    pid, topics = parse_subscribe(body)
                    with self._lock:
                        self._subs.extend((t, conn) for t, _q in topics)
                    conn.sendall(encode_suback(pid, [0] * len(topics)))
                elif ptype == UNSUBSCRIBE:
                    pid, topics = parse_unsubscribe(body)
                    with self._lock:
                        self._subs = [
                            (t, c) for t, c in self._subs
                            if not (c is conn and t in topics)]
                    conn.sendall(encode_unsuback(pid))
                elif ptype == PINGREQ:
                    conn.sendall(encode_pingresp())
                elif ptype == DISCONNECT:
                    return
        except (ConnectionError, OSError, ValueError):
            pass
        finally:
            with self._lock:
                self._subs = [(t, c) for t, c in self._subs if c is not conn]
                self._wlocks.pop(id(conn), None)
            try:
                conn.close()
            except OSError:
                pass

    def _fanout(self, topic: str, payload: bytes) -> None:
        with self._lock:
            targets = [c for t, c in self._subs if topic_matches(t, topic)]
            wlocks = {id(c): self._wlocks.setdefault(id(c), threading.Lock())
                      for c in targets}
        frame = encode_publish(topic, payload)
        dead = []
        for c in dict.fromkeys(targets):  # de-dupe, keep order
            try:
                with wlocks[id(c)]:
                    c.sendall(frame)
            except OSError:
                dead.append(c)
        if dead:
            with self._lock:
                self._subs = [(t, c) for t, c in self._subs if c not in dead]
                for c in dead:
                    self._wlocks.pop(id(c), None)

    def stop(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        # join the accept thread: its (timeout-bounded) accept() keeps
        # the kernel LISTEN socket alive past close(), so an immediate
        # broker restart on the same port races EADDRINUSE without this
        t = self._thread
        if t is not None and t is not threading.current_thread():
            join_or_warn(t, "mqtt-broker", timeout=2.0)
        self._thread = None


# --------------------------------------------------------------------------- #
# client
# --------------------------------------------------------------------------- #

class MqttClient:
    """Small synchronous MQTT 3.1.1 client (QoS 0) for the pub/sub
    elements and tests; works against any 3.1.1 broker."""

    def __init__(self, host: str, port: int, client_id: str,
                 keep_alive: int = 60, timeout: float = 5.0):
        self.keep_alive = int(keep_alive)
        self.sock = socket.create_connection((host, int(port)), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.sock.sendall(encode_connect(client_id, self.keep_alive))
        ptype, _, body = read_packet(self.sock)
        if ptype != CONNACK or len(body) < 2 or body[1] != 0:
            raise ConnectionError(f"MQTT CONNECT refused: {body!r}")
        self._packet_id = 0
        self._last_send = time.monotonic()

    def _sendall(self, data: bytes) -> None:
        self.sock.sendall(data)
        self._last_send = time.monotonic()

    def _keepalive_tick(self) -> None:
        """§3.1.2.10: the broker may drop a client silent for 1.5×
        keep-alive; send PINGREQ when more than half the interval has
        passed without any control packet from us (receiving doesn't
        count)."""
        if self.keep_alive > 0 and \
                time.monotonic() - self._last_send > self.keep_alive / 2:
            self._sendall(encode_pingreq())

    def _next_id(self) -> int:
        self._packet_id = (self._packet_id % 0xFFFF) + 1
        return self._packet_id

    def publish(self, topic: str, payload: bytes) -> None:
        self._sendall(encode_publish(topic, payload))

    def subscribe(self, *topics: str) -> None:
        pid = self._next_id()
        self.sock.sendall(encode_subscribe(pid, [(t, 0) for t in topics]))
        ptype, _, body = read_packet(self.sock)
        if ptype != SUBACK:
            raise ConnectionError(f"expected SUBACK, got type {ptype}")
        (rid,) = struct.unpack_from(">H", body, 0)
        if rid != pid or any(rc == 0x80 for rc in body[2:]):
            raise ConnectionError(f"SUBSCRIBE rejected: {body!r}")

    def recv_publish(self, timeout: Optional[float] = None
                     ) -> Optional[Tuple[str, bytes]]:
        """Next PUBLISH (answering pings in between); None on timeout.
        The timeout applies between frames only — once a frame's first
        byte arrives the rest reads under FRAME_TIMEOUT, so a short poll
        interval cannot desync the stream mid-packet."""
        while True:
            self._keepalive_tick()
            self.sock.settimeout(timeout)
            try:
                first = _recv_exact(self.sock, 1)[0]
            except socket.timeout:
                return None
            self.sock.settimeout(FRAME_TIMEOUT)
            ptype, flags, body = read_packet(self.sock, first)
            if ptype == PUBLISH:
                topic, payload, _qos, _pid = parse_publish(flags, body)
                return topic, payload
            if ptype == PINGRESP:
                continue  # answer to our keep-alive PINGREQ

    def ping(self) -> bool:
        self._sendall(encode_pingreq())
        ptype, _, _ = read_packet(self.sock)
        return ptype == PINGRESP

    def close(self) -> None:
        try:
            self.sock.sendall(encode_disconnect())
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
