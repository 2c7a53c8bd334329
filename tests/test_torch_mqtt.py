"""The port's MQTT layer: every case of tests/test_mqtt.py, run against
``nnstreamer_tpu_torch`` on the CPU. Each case runs under a timeout of its
own (SIGALRM).

MQTT 3.1.1 wire-protocol tests (query/mqtt.py + pubsub elements).

Mirrors the reference's MQTT element tests (tests/gstreamer_mqtt/
unittest_mqtt_w_helper.cc uses a mocked paho; here the protocol itself is
asserted against scripted sockets — real 3.1.1 frames, reference-exact
GstMQTTMessageHdr layout per mqttcommon.h:29-63, and ntputil.c SNTP
conversion semantics)."""

import signal
import socket
import struct
import threading
import time

import numpy as np
import pytest

from nnstreamer_tpu_torch.query import mqtt

#: each case's own limit, seconds
CASE_TIMEOUT_S = 60


@pytest.fixture(autouse=True)
def _case_timeout():
    def expire(signum, frame):
        raise TimeoutError(f"case exceeded {CASE_TIMEOUT_S} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(CASE_TIMEOUT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


class TestPacketCodec:
    def test_remaining_length_varint(self):
        for n, expect in [(0, b"\x00"), (127, b"\x7f"),
                          (128, b"\x80\x01"), (16383, b"\xff\x7f"),
                          (268435455, b"\xff\xff\xff\x7f")]:
            assert mqtt.encode_remaining_length(n) == expect
        with pytest.raises(ValueError):
            mqtt.encode_remaining_length(268435456)

    def test_connect_roundtrip(self):
        pkt = mqtt.encode_connect("cl1", keep_alive=30)
        # fixed header: type 1, flags 0
        assert pkt[0] == 0x10
        # body parses back
        body = pkt[2:]
        info = mqtt.parse_connect(body)
        assert info == {"level": 4, "clean_session": True,
                        "keep_alive": 30, "client_id": "cl1"}

    def test_publish_roundtrip(self):
        pkt = mqtt.encode_publish("a/b", b"payload")
        assert pkt[0] == 0x30
        topic, payload, qos, pid = mqtt.parse_publish(pkt[0] & 0xF, pkt[2:])
        assert (topic, payload, qos, pid) == ("a/b", b"payload", 0, 0)

    def test_publish_qos1_has_packet_id_and_broker_pubacks(self):
        pkt = mqtt.encode_publish("t", b"x", qos=1, packet_id=42)
        topic, payload, qos, pid = mqtt.parse_publish((pkt[0]) & 0xF, pkt[2:])
        assert (qos, pid) == (1, 42)
        broker = mqtt.MqttBroker(port=0).start()
        try:
            c = mqtt.MqttClient(broker.host, broker.port, "q1")
            c.sock.sendall(pkt)
            ptype, _, body = mqtt.read_packet(c.sock)
            assert ptype == mqtt.PUBACK
            assert struct.unpack(">H", body)[0] == 42
            c.close()
        finally:
            broker.stop()

    def test_subscribe_flags_and_roundtrip(self):
        pkt = mqtt.encode_subscribe(7, [("t/+/x", 0), ("u/#", 0)])
        assert pkt[0] == 0x82  # reserved flags 0010 (spec 3.8.1)
        pid, topics = mqtt.parse_subscribe(pkt[2:])
        assert pid == 7 and topics == [("t/+/x", 0), ("u/#", 0)]

    def test_topic_wildcards(self):
        assert mqtt.topic_matches("a/+/c", "a/b/c")
        assert not mqtt.topic_matches("a/+/c", "a/b/d")
        assert mqtt.topic_matches("a/#", "a/b/c/d")
        assert mqtt.topic_matches("#", "anything/at/all")
        assert not mqtt.topic_matches("a/b", "a/b/c")
        assert not mqtt.topic_matches("a/b/c", "a/b")


class TestMessageHdr:
    def test_layout_offsets_match_reference(self):
        """mqttcommon.h:29-63: 1024 total; num_mems@0, size_mems@8 (after
        4-byte alignment pad), epochs@136/144, duration/dts/pts@152-176,
        caps@176 (512 bytes)."""
        hdr = mqtt.MessageHdr(
            num_mems=2, size_mems=(10, 20), base_time_epoch=111,
            sent_time_epoch=222, duration=5, dts=6, pts=7, caps_str="caps!")
        raw = hdr.pack()
        assert len(raw) == 1024
        assert struct.unpack_from("<I", raw, 0)[0] == 2
        assert struct.unpack_from("<Q", raw, 8)[0] == 10
        assert struct.unpack_from("<Q", raw, 16)[0] == 20
        assert struct.unpack_from("<q", raw, 136)[0] == 111
        assert struct.unpack_from("<q", raw, 144)[0] == 222
        assert struct.unpack_from("<Q", raw, 152)[0] == 5
        assert struct.unpack_from("<Q", raw, 160)[0] == 6
        assert struct.unpack_from("<Q", raw, 168)[0] == 7
        assert raw[176:181] == b"caps!"

    def test_none_timestamps_use_clock_time_none(self):
        raw = mqtt.MessageHdr(num_mems=0).pack()
        assert struct.unpack_from("<Q", raw, 168)[0] == 0xFFFFFFFFFFFFFFFF
        back = mqtt.MessageHdr.unpack(raw)
        assert back.pts is None and back.dts is None and back.duration is None

    def test_roundtrip(self):
        hdr = mqtt.MessageHdr(num_mems=3, size_mems=(1, 2, 3),
                              base_time_epoch=-5, sent_time_epoch=9,
                              pts=123, caps_str="other/tensors")
        back = mqtt.MessageHdr.unpack(hdr.pack())
        assert back == hdr

    def test_unpack_rejects_garbage(self):
        with pytest.raises(ValueError):
            mqtt.MessageHdr.unpack(b"short")
        bad = bytearray(mqtt.MessageHdr(num_mems=0).pack())
        struct.pack_into("<I", bad, 0, 17)  # > GST_MQTT_MAX_NUM_MEMS
        with pytest.raises(ValueError):
            mqtt.MessageHdr.unpack(bytes(bad))


class TestScriptedSocketProtocol:
    """Raw-socket assertions: the broker answers hand-built MQTT 3.1.1
    frames byte-for-byte (no client library involved)."""

    def test_connect_subscribe_publish_wire_format(self):
        broker = mqtt.MqttBroker(port=0).start()
        try:
            sub = socket.create_connection((broker.host, broker.port), 5)
            # hand-built CONNECT: MQTT, level 4, clean session, id "s"
            body = (b"\x00\x04MQTT\x04\x02\x00\x3c" + b"\x00\x01s")
            sub.sendall(bytes([0x10, len(body)]) + body)
            connack = sub.recv(4)
            assert connack == b"\x20\x02\x00\x00"
            # SUBSCRIBE pid=1 "t" qos0 → SUBACK pid=1 rc=0
            sbody = b"\x00\x01" + b"\x00\x01t" + b"\x00"
            sub.sendall(bytes([0x82, len(sbody)]) + sbody)
            assert sub.recv(5) == b"\x90\x03\x00\x01\x00"

            pub = socket.create_connection((broker.host, broker.port), 5)
            body = (b"\x00\x04MQTT\x04\x02\x00\x3c" + b"\x00\x01p")
            pub.sendall(bytes([0x10, len(body)]) + body)
            assert pub.recv(4) == b"\x20\x02\x00\x00"
            pbody = b"\x00\x01t" + b"hello"
            pub.sendall(bytes([0x30, len(pbody)]) + pbody)

            sub.settimeout(5)
            frame = sub.recv(64)
            assert frame == bytes([0x30, len(pbody)]) + pbody
        finally:
            broker.stop()

    def test_bad_protocol_level_refused(self):
        broker = mqtt.MqttBroker(port=0).start()
        try:
            c = socket.create_connection((broker.host, broker.port), 5)
            body = b"\x00\x04MQTT\x03\x02\x00\x3c" + b"\x00\x01x"  # level 3
            c.sendall(bytes([0x10, len(body)]) + body)
            assert c.recv(4) == b"\x20\x02\x00\x01"  # unacceptable version
        finally:
            broker.stop()


class TestClientBroker:
    def test_pub_sub_ping_unsubscribe(self):
        broker = mqtt.MqttBroker(port=0).start()
        try:
            sub = mqtt.MqttClient(broker.host, broker.port, "sub")
            pub = mqtt.MqttClient(broker.host, broker.port, "pub")
            sub.subscribe("sensors/+/temp")
            pub.publish("sensors/k1/temp", b"21.5")
            got = sub.recv_publish(timeout=5)
            assert got == ("sensors/k1/temp", b"21.5")
            assert pub.ping()
            # unsubscribe stops delivery
            sub.sock.sendall(mqtt.encode_unsubscribe(9, ["sensors/+/temp"]))
            ptype, _, body = mqtt.read_packet(sub.sock)
            assert ptype == mqtt.UNSUBACK
            pub.publish("sensors/k1/temp", b"22")
            assert sub.recv_publish(timeout=0.4) is None
            sub.close()
            pub.close()
        finally:
            broker.stop()


class TestSntp:
    def test_ntp_epoch_from_scripted_server(self):
        """Scripted UDP NTP server returns a fixed transmit timestamp; the
        conversion must match ntputil.c:211-229 exactly."""
        srv = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        srv.bind(("127.0.0.1", 0))
        host, port = srv.getsockname()
        sec = mqtt.NTP_DELTA + 1_700_000_000
        frac = 0x80000000  # 0.5s

        def serve():
            data, addr = srv.recvfrom(64)
            assert data[0] == 0x1B
            resp = bytearray(48)
            struct.pack_into(">II", resp, 40, sec, frac)
            srv.sendto(bytes(resp), addr)

        t = threading.Thread(target=serve, daemon=True)
        t.start()
        got = mqtt.ntp_epoch_us([(host, port)])
        expect = 1_700_000_000 * 1_000_000 + int(
            frac / 4294967295.0 * 1_000_000)
        assert got == expect
        srv.close()

    def test_ntp_invalid_timestamp_rejected(self):
        srv = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        srv.bind(("127.0.0.1", 0))
        host, port = srv.getsockname()

        def serve():
            data, addr = srv.recvfrom(64)
            srv.sendto(bytes(48), addr)  # all-zero → sec <= delta

        threading.Thread(target=serve, daemon=True).start()
        with pytest.raises(OSError):
            mqtt.ntp_epoch_us([(host, port)])
        srv.close()

    def test_get_epoch_falls_back_to_system_clock(self):
        # unroutable host port → fallback near time.time
        before = time.time_ns() // 1000
        got = mqtt.get_epoch_us([("127.0.0.1", 1)])
        after = time.time_ns() // 1000
        assert before <= got <= after + 10_000_000


class TestElementsOverRealMqtt:
    def test_tensor_stream_with_header_parity(self):
        """mqttsink publishes; a RAW MqttClient (not our element) receives
        and parses the reference-layout header + payload."""
        from fractions import Fraction

        from nnstreamer_tpu_torch.core import Caps, TensorsConfig, TensorsInfo
        from nnstreamer_tpu_torch.graph import Pipeline

        broker = mqtt.MqttBroker(port=0).start()
        try:
            watcher = mqtt.MqttClient(broker.host, broker.port, "watcher")
            watcher.subscribe("nns/#")

            tp = Pipeline("publisher", device="cpu")
            caps = Caps.tensors(TensorsConfig(
                TensorsInfo.from_strings("2:1", "float32"), 30))
            src = tp.add_new("appsrc", caps=caps,
                             data=[np.full((1, 2), 7.5, np.float32)])
            msink = tp.add_new("mqttsink", port=broker.port,
                               pub_topic="nns/t0")
            Pipeline.link(src, msink)
            tp.run(timeout=30)

            got = watcher.recv_publish(timeout=5)
            assert got is not None
            topic, payload = got
            assert topic == "nns/t0"
            hdr = mqtt.MessageHdr.unpack(payload)
            assert hdr.num_mems == 1
            assert hdr.size_mems == (8,)
            assert "other/tensors" in hdr.caps_str
            assert "dimensions=(string)2:1" in hdr.caps_str
            vals = np.frombuffer(payload[1024:1032], np.float32)
            np.testing.assert_array_equal(vals, [7.5, 7.5])
            assert hdr.sent_time_epoch > 0
            watcher.close()
        finally:
            broker.stop()


class TestKeepAlive:
    def test_idle_client_sends_pingreq(self):
        """§3.1.2.10: a client silent for 1.5x keep-alive gets dropped by
        real brokers; our client must PINGREQ when idle past half the
        interval (receiving doesn't count as activity)."""
        broker = mqtt.MqttBroker(port=0).start()
        try:
            c = mqtt.MqttClient(broker.host, broker.port, "ka", keep_alive=1)
            c.subscribe("t")
            t0 = time.monotonic()
            # poll well past keep_alive/2 with no traffic: the tick must
            # fire PINGREQ (and swallow the PINGRESP) without erroring
            while time.monotonic() - t0 < 1.2:
                assert c.recv_publish(timeout=0.1) is None
            assert c._last_send > t0, "no PINGREQ was sent while idle"
            c.close()
        finally:
            broker.stop()


class TestHeaderLimits:
    def test_pack_rejects_too_many_memories(self):
        with pytest.raises(ValueError, match="GST_MQTT_MAX_NUM_MEMS"):
            mqtt.MessageHdr(num_mems=17, size_mems=tuple(range(17))).pack()


class TestSparseLink:
    def test_sparse_compressed_stream(self):
        """mqttsink sparse=true ships sparse-encoded memories under
        format=sparse caps (reference tensor_sparse link compression);
        subscriber transparently decodes to dense."""
        from fractions import Fraction

        from nnstreamer_tpu_torch.core import Caps, TensorsConfig, TensorsInfo
        from nnstreamer_tpu_torch.graph import Pipeline

        broker = mqtt.MqttBroker(port=0).start()
        try:
            rp = Pipeline("rx", device="cpu")
            msrc = rp.add_new("mqttsrc", port=broker.port, sub_topic="s")
            rsink = rp.add_new("tensor_sink", store=True)
            Pipeline.link(msrc, rsink)
            rp.start()
            time.sleep(0.3)

            dense = np.zeros((64, 64), np.float32)
            dense[3, 7] = 42.0
            watcher = mqtt.MqttClient(broker.host, broker.port, "w")
            watcher.subscribe("s")
            tp = Pipeline("tx", device="cpu")
            caps = Caps.tensors(TensorsConfig(
                TensorsInfo.from_strings("64:64", "float32"),
                Fraction(30, 1)))
            src = tp.add_new("appsrc", caps=caps, data=[dense])
            msink = tp.add_new("mqttsink", port=broker.port, pub_topic="s",
                               sparse=True)
            Pipeline.link(src, msink)
            tp.run(timeout=30)

            got = watcher.recv_publish(timeout=5)
            assert got is not None
            hdr = mqtt.MessageHdr.unpack(got[1])
            assert "sparse" in hdr.caps_str
            assert hdr.size_mems[0] < dense.nbytes // 4  # compressed
            deadline = time.monotonic() + 10
            while rsink.num_buffers < 1 and time.monotonic() < deadline:
                time.sleep(0.05)
            rp.stop()
            np.testing.assert_array_equal(
                rsink.buffers[0].memories[0].host(), dense)
            watcher.close()
        finally:
            broker.stop()

    def test_sparse_preserves_config_and_survives_corruption(self):
        """Sparse wire carries the dense dims/types/rate; a corrupt sparse
        message is dropped, not fatal to the subscription."""
        from fractions import Fraction

        from nnstreamer_tpu_torch.core import Caps, TensorsConfig, TensorsInfo
        from nnstreamer_tpu_torch.graph import Pipeline

        broker = mqtt.MqttBroker(port=0).start()
        try:
            rp = Pipeline("rx", device="cpu")
            msrc = rp.add_new("mqttsrc", port=broker.port, sub_topic="s2")
            rsink = rp.add_new("tensor_sink", store=True)
            Pipeline.link(msrc, rsink)
            rp.start()
            time.sleep(0.3)

            # 1: corrupt sparse message straight to the topic
            evil = mqtt.MqttClient(broker.host, broker.port, "evil")
            hdr = mqtt.MessageHdr(
                num_mems=1, size_mems=(16,), sent_time_epoch=1,
                caps_str='other/tensors,format=(string)sparse,'
                         'dimensions=(string)4:4,types=(string)float32')
            evil.publish("s2", hdr.pack() + b"\xff" * 16)

            # 2: then a valid sparse frame from the element
            dense = np.zeros((4, 4), np.float32)
            dense[1, 2] = 5.0
            tp = Pipeline("tx", device="cpu")
            caps = Caps.tensors(TensorsConfig(
                TensorsInfo.from_strings("4:4", "float32"),
                Fraction(25, 1)))
            src = tp.add_new("appsrc", caps=caps, data=[dense])
            msink = tp.add_new("mqttsink", port=broker.port,
                               pub_topic="s2", sparse=True)
            Pipeline.link(src, msink)
            tp.run(timeout=30)

            deadline = time.monotonic() + 10
            while rsink.num_buffers < 1 and time.monotonic() < deadline:
                time.sleep(0.05)
            rp.stop()
            assert rsink.num_buffers == 1  # corrupt one dropped, good kept
            b = rsink.buffers[0]
            np.testing.assert_array_equal(b.memories[0].host(), dense)
            assert b.config is not None
            assert b.config.rate == Fraction(25, 1)
            evil.close()
        finally:
            broker.stop()


class TestBrokerLifecycle:
    """Regression (nnslint concurrency/thread-join): stop() must join
    the accept thread — returning while it is still inside its bounded
    accept() keeps the LISTEN socket alive past close(), so an
    immediate rebind of the same port races EADDRINUSE."""

    def test_stop_joins_accept_thread_and_frees_port(self):
        broker = mqtt.MqttBroker(port=0).start()
        port = broker.port
        worker = broker._thread
        assert worker is not None and worker.is_alive()
        broker.stop()
        assert broker._thread is None
        assert not worker.is_alive()
        # deterministic rebind of the very same port
        broker2 = mqtt.MqttBroker(port=port).start()
        try:
            c = mqtt.MqttClient(broker2.host, broker2.port, "rebind")
            c.close()
        finally:
            broker2.stop()

    def test_stop_is_reentrant(self):
        broker = mqtt.MqttBroker(port=0).start()
        broker.stop()
        broker.stop()  # second stop: no thread left, must not raise
