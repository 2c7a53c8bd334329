"""mqttsink / mqttsrc — publish/subscribe streams over real MQTT 3.1.1;
port of nnstreamer_tpu/query/pubsub.py.

Reference: gst/mqtt/ (mqttsink.c / mqttsrc.c, 3404 LoC): arbitrary Gst
streams ride MQTT PUBLISH messages whose payload is a fixed 1024-byte
``GstMQTTMessageHdr`` (num_mems, per-memory sizes, base/sent Unix epochs,
pts/dts/duration, caps string; mqttcommon.h:29-63) followed by the raw
memory bytes; publisher clocks are NTP-synced (ntputil.c) so subscribers on
other hosts can compute transit latency.

This build keeps that contract byte-for-byte (query/mqtt.py
``MessageHdr``) and speaks genuine MQTT 3.1.1 frames, so any standard
broker (mosquitto, EMQX, …) — or the built-in ``MqttBroker`` — carries the
stream, and an upstream nnstreamer subscriber can parse our header.

Elements:
  * ``mqttsink pub-topic=t host=… port=…`` — publishes every buffer;
    ``ntp-sync=true`` (+ ``ntp-host``/``ntp-port``) timestamps with an NTP
    epoch instead of the system clock; ``sparse=true`` ships each memory
    sparse-encoded under ``format=sparse`` caps (the reference's
    tensor_sparse link compression, §2.5 — pays off on mostly-zero
    tensors crossing slow links);
  * ``mqttsrc sub-topic=t`` — subscribes (MQTT wildcards ``+``/``#`` work)
    and re-emits buffers, recording ``mqtt_latency_us`` (receiver epoch −
    sender epoch) in buffer meta.
"""

from __future__ import annotations

import time
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from ..core.buffer import Buffer, TensorMemory
from ..core.log import logger
from ..core.types import Caps, TensorFormat
from ..graph.element import Element, FlowReturn, Pad, register_element
from ..graph.pipeline import SourceElement
from .mqtt import (
    MessageHdr,
    MqttBroker,
    MqttClient,
    get_epoch_us,
)

log = logger("pubsub")

#: backward-compatible alias (rounds 1-2 exposed the bespoke broker under
#: this name; it is now a real MQTT 3.1.1 broker)
PubSubBroker = MqttBroker


class EpochClock:
    """Per-element epoch source: one SNTP query at element start pins the
    offset between the NTP epoch and the local monotonic-ish system clock;
    per-buffer reads are then a local clock read plus the cached offset.
    (The reference also syncs once per connection, not per message —
    mqttsink.c via ntputil; querying NTP in the per-buffer hot path would
    cap FPS at the NTP RTT.)"""

    def __init__(self, ntp_hosts=None):
        self._offset_us = get_epoch_us(ntp_hosts) - time.time_ns() // 1000

    def now_us(self) -> int:
        return time.time_ns() // 1000 + self._offset_us


def _buffer_to_mqtt(buf: Buffer, base_epoch_us: int,
                    clock: EpochClock, sparse: bool = False,
                    stream_config: Optional[Any] = None) -> bytes:
    """Buffer → GstMQTTMessageHdr + raw (or sparse-encoded) memory bytes."""
    from ..core.types import TensorFormat as _TF
    from ..core.types import TensorsConfig
    from ..graph.parse import caps_to_gst_string

    config = buf.config or stream_config
    if config is None:  # static per-memory infos still describe the frame
        config = TensorsConfig(buf.tensors_info)
    if sparse:
        from ..elements.sparse import sparse_encode

        blobs = [sparse_encode(m.host(), m.info) for m in buf.memories]
        # keep the full stream config (dims/types/rate of the DENSE
        # tensors) and mark only the payload encoding as sparse
        caps = caps_to_gst_string(
            Caps.tensors(config).with_fields(format=_TF.SPARSE))
    else:
        blobs = [m.tobytes() for m in buf.memories]
        caps = caps_to_gst_string(Caps.tensors(config))
    hdr = MessageHdr(
        num_mems=len(blobs),
        size_mems=tuple(len(b) for b in blobs),
        base_time_epoch=base_epoch_us,
        sent_time_epoch=clock.now_us(),
        duration=buf.duration, dts=buf.dts, pts=buf.pts,
        caps_str=caps)
    return hdr.pack() + b"".join(blobs)


def _mqtt_to_buffer(payload: bytes,
                    recv_epoch_us: int) -> Buffer:
    """GstMQTTMessageHdr + raw memories → Buffer (config from caps_str)."""
    from ..graph.parse import parse_caps_string

    hdr = MessageHdr.unpack(payload)
    off = 1024
    config = None
    infos = None
    is_sparse = False
    if hdr.caps_str:
        try:
            caps = parse_caps_string(hdr.caps_str)
            if caps.media_type == "other/tensors":
                from ..core.types import TensorFormat as _TF

                is_sparse = caps.get("format") is _TF.SPARSE
                if caps.get("dims") is not None:
                    if is_sparse:  # dims/types describe the dense tensors
                        caps = caps.with_fields(format=_TF.STATIC)
                    config = caps.to_config()
                    infos = list(config.info)
        except (ValueError, KeyError):
            log.warning("unparsable caps in MQTT header: %r", hdr.caps_str)
    mems: List[TensorMemory] = []
    for i, size in enumerate(hdr.size_mems):
        blob = payload[off:off + size]
        if len(blob) != size:
            raise ValueError(
                f"MQTT payload truncated: memory {i} wants {size} bytes, "
                f"{len(blob)} left")
        off += size
        if is_sparse:
            from ..elements.sparse import sparse_decode

            arr, info = sparse_decode(bytes(blob))
            mems.append(TensorMemory(arr, info))
        elif infos is not None and i < len(infos):
            mems.append(TensorMemory.from_bytes(blob, infos[i]))
        else:
            mems.append(TensorMemory(np.frombuffer(
                bytearray(blob), np.uint8)))
    buf = Buffer(mems, pts=hdr.pts, dts=hdr.dts, duration=hdr.duration,
                 config=config)
    buf.meta["mqtt_latency_us"] = recv_epoch_us - hdr.sent_time_epoch
    buf.meta["mqtt_base_epoch_us"] = hdr.base_time_epoch
    return buf


def _parse_ntp_hosts(el: Any) -> Optional[Sequence[Tuple[str, int]]]:
    if not getattr(el, "ntp_sync", False):
        return None
    return [(str(el.ntp_host), int(el.ntp_port))]


@register_element
class MqttSink(Element):
    ELEMENT_NAME = "mqttsink"

    def __init__(self, name: Optional[str] = None, **props: Any):
        self.host = "127.0.0.1"
        self.port = 1883
        self.pub_topic = "nns/stream"
        self.client_id = ""
        self.keep_alive = 60
        self.ntp_sync = False
        self.ntp_host = "pool.ntp.org"
        self.ntp_port = 123
        self.sparse = False
        super().__init__(name, **props)
        self.add_sink_pad()
        self._client: Optional[MqttClient] = None
        self._base_epoch_us = 0
        self._clock: Optional[EpochClock] = None
        self._stream_config = None

    def on_caps(self, pad: Pad, caps: Caps) -> None:
        pad.caps = caps
        if caps.media_type == "other/tensors" \
                and caps.get("dims") is not None:
            # negotiated stream config rides the wire header even when
            # individual buffers don't carry one
            self._stream_config = caps.to_config()

    def start(self) -> None:
        cid = self.client_id or f"nns_tpu_sink_{id(self) & 0xFFFF:04x}"
        self._client = MqttClient(self.host, int(self.port), cid,
                                  int(self.keep_alive))
        self._clock = EpochClock(_parse_ntp_hosts(self))
        self._base_epoch_us = self._clock.now_us()

    def chain(self, pad: Pad, buf: Buffer) -> Optional[FlowReturn]:
        payload = _buffer_to_mqtt(buf, self._base_epoch_us, self._clock,
                                  sparse=bool(self.sparse),
                                  stream_config=self._stream_config)
        try:
            self._client.publish(self.pub_topic, payload)
        except OSError as e:
            log.error("mqttsink publish failed: %s", e)
            return FlowReturn.ERROR
        return FlowReturn.OK

    def stop(self) -> None:
        if self._client is not None:
            self._client.close()
            self._client = None


@register_element
class MqttSrc(SourceElement):
    ELEMENT_NAME = "mqttsrc"

    def __init__(self, name: Optional[str] = None, **props: Any):
        self.host = "127.0.0.1"
        self.port = 1883
        self.sub_topic = "nns/stream"
        self.client_id = ""
        self.keep_alive = 60
        self.ntp_sync = False
        self.ntp_host = "pool.ntp.org"
        self.ntp_port = 123
        super().__init__(name, **props)
        self._client: Optional[MqttClient] = None
        self._clock: Optional[EpochClock] = None

    def negotiate(self) -> Caps:
        cid = self.client_id or f"nns_tpu_src_{id(self) & 0xFFFF:04x}"
        self._client = MqttClient(self.host, int(self.port), cid,
                                  int(self.keep_alive))
        self._client.subscribe(self.sub_topic)
        self._clock = EpochClock(_parse_ntp_hosts(self))
        return Caps.tensors(format=TensorFormat.FLEXIBLE)

    def create(self) -> Optional[Buffer]:
        while not self._stop_flag.is_set():
            try:
                got = self._client.recv_publish(timeout=0.2)
            except (ConnectionError, OSError):
                return None
            if got is None:
                continue
            _topic, payload = got
            try:
                return _mqtt_to_buffer(payload, self._clock.now_us())
            except Exception as e:  # noqa: BLE001 - untrusted network
                # input: a corrupt message (bad header, codes, or sparse
                # indices raising Index/KeyError deep in the codec) must
                # be dropped, never end the subscription
                log.warning("mqttsrc dropped malformed message: %s", e)
                continue
        return None

    def stop(self) -> None:
        super().stop()
        if self._client is not None:
            self._client.close()
            self._client = None
