"""The port's query/offload layer: every case of tests/test_query.py,
run against ``nnstreamer_tpu_torch`` on the CPU (localhost server+client
pipelines, the reference tests/nnstreamer_query/runTest.sh pattern: both
ends in one test host, plus protocol unit tests). Each case runs under a
timeout of its own (SIGALRM) and leaves no fault plan or repo slot behind.
Two ``cuda`` cases (skipped without a card; this file imports no JAX): a
card tensor poisoned by the chaos ``corrupt`` fault stays on the card, and
the serversink's async send of a graph-produced card tensor equals a
synchronous one.
"""

import signal
import socket
import threading
import time

import numpy as np
import pytest

from nnstreamer_tpu_torch.core import Buffer, Caps, TensorsConfig, TensorsInfo
from nnstreamer_tpu_torch.graph import Pipeline
from nnstreamer_tpu_torch.query import DiscoveryBroker, discover, register_node
from nnstreamer_tpu_torch.query.protocol import (
    Cmd,
    buffer_to_payload,
    pack_message,
    payload_to_buffer,
)


#: each case's own limit, seconds
CASE_TIMEOUT_S = 90


@pytest.fixture(autouse=True)
def _case_guard():
    """A timeout of the case's own, and no chaos plan or repo slot left
    for the next case."""
    def expire(signum, frame):
        raise TimeoutError(f"case exceeded {CASE_TIMEOUT_S} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(CASE_TIMEOUT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
        from nnstreamer_tpu_torch.elements.repo import reset_repo
        from nnstreamer_tpu_torch.resilience import chaos

        chaos.uninstall()
        reset_repo()


def caps_of(dims, types, rate=30):
    return Caps.tensors(TensorsConfig(TensorsInfo.from_strings(dims, types), rate))


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class TestProtocol:
    def test_buffer_payload_roundtrip(self):
        buf = Buffer.of(np.arange(6, dtype=np.float32).reshape(2, 3),
                        np.ones((4,), np.uint8), pts=123, duration=7)
        meta, payload = buffer_to_payload(buf)
        out = payload_to_buffer(meta, payload)
        assert out.pts == 123 and out.duration == 7
        np.testing.assert_array_equal(out.memories[0].host(),
                                      buf.memories[0].host())
        np.testing.assert_array_equal(out.memories[1].host(),
                                      buf.memories[1].host())

    def test_sparse_payload(self):
        dense = np.zeros((8, 8), np.float32)
        dense[2, 3] = 9.0
        buf = Buffer.of(dense)
        meta, payload = buffer_to_payload(buf, sparse=True)
        dense_meta, dense_payload = buffer_to_payload(buf, sparse=False)
        assert len(payload) < len(dense_payload)
        out = payload_to_buffer(meta, payload)
        np.testing.assert_array_equal(out.memories[0].host(), dense)

    def test_bad_magic_rejected(self):
        import struct
        from nnstreamer_tpu_torch.query.protocol import QueryProtocolError, recv_message

        a, b = socket.socketpair()
        try:
            a.sendall(struct.pack("<IBIQ", 0xDEAD, 1, 0, 0))
            with pytest.raises(QueryProtocolError, match="magic"):
                recv_message(b)
        finally:
            a.close()
            b.close()


class TestQueryOffload:
    def _server_pipeline(self, port):
        sp = Pipeline("server", device="cpu")
        ssrc = sp.add_new("tensor_query_serversrc", host="127.0.0.1",
                          port=port, id=0, dims="4:1", types="float32")
        filt = sp.add_new("tensor_filter", model=lambda x: x * 10)
        ssink = sp.add_new("tensor_query_serversink", id=0)
        Pipeline.link(ssrc, filt, ssink)
        return sp

    def test_offload_roundtrip(self):
        port = free_port()
        sp = self._server_pipeline(port)
        sp.start()
        try:
            time.sleep(0.2)
            cp = Pipeline("client", device="cpu")
            src = cp.add_new("appsrc", caps=caps_of("4:1", "float32"),
                             data=[np.full((1, 4), i, np.float32)
                                   for i in range(5)])
            qc = cp.add_new("tensor_query_client", host="127.0.0.1", port=port)
            sink = cp.add_new("tensor_sink", store=True)
            Pipeline.link(src, qc, sink)
            cp.run(timeout=60)
            assert sink.num_buffers == 5
            np.testing.assert_array_equal(sink.buffers[3].memories[0].host(),
                                          np.full((1, 4), 30.0, np.float32))
            # timestamps preserved across the wire
            assert sink.buffers[3].offset == 3
        finally:
            sp.stop()

    def test_sparse_link(self):
        port = free_port()
        sp = self._server_pipeline(port)
        sp.start()
        try:
            time.sleep(0.2)
            cp = Pipeline("client", device="cpu")
            data = np.zeros((1, 4), np.float32)
            data[0, 1] = 2.0
            src = cp.add_new("appsrc", caps=caps_of("4:1", "float32"),
                             data=[data])
            qc = cp.add_new("tensor_query_client", host="127.0.0.1",
                            port=port, sparse=True)
            sink = cp.add_new("tensor_sink", store=True)
            Pipeline.link(src, qc, sink)
            cp.run(timeout=60)
            np.testing.assert_array_equal(sink.buffers[0].memories[0].host(),
                                          data * 10)
        finally:
            sp.stop()

    def test_client_retry_then_fail(self):
        port = free_port()  # nothing listening
        cp = Pipeline("client", device="cpu")
        src = cp.add_new("appsrc", caps=caps_of("4:1", "float32"),
                         data=[np.zeros((1, 4), np.float32)])
        qc = cp.add_new("tensor_query_client", host="127.0.0.1", port=port,
                        max_request_retry=2, timeout_s=1.0)
        sink = cp.add_new("tensor_sink")
        Pipeline.link(src, qc, sink)
        from nnstreamer_tpu_torch.graph import PipelineError

        with pytest.raises(PipelineError, match="failed after retries"):
            cp.run(timeout=60)


class TestHybridDiscovery:
    def test_register_discover(self):
        broker = DiscoveryBroker(port=0).start()
        try:
            assert register_node("object_detection", "127.0.0.1", 5001,
                                 broker_port=broker.port)
            nodes = discover("object_detection", broker_port=broker.port)
            assert nodes == [("127.0.0.1", 5001)]
            assert discover("missing", broker_port=broker.port) == []
        finally:
            broker.stop()

    def test_client_via_broker(self):
        broker = DiscoveryBroker(port=0).start()
        port = free_port()
        sp = Pipeline("server", device="cpu")
        ssrc = sp.add_new("tensor_query_serversrc", host="127.0.0.1",
                          port=port, id=0, dims="2:1", types="float32")
        filt = sp.add_new("tensor_filter", model=lambda x: x + 1)
        ssink = sp.add_new("tensor_query_serversink", id=0)
        Pipeline.link(ssrc, filt, ssink)
        sp.start()
        try:
            time.sleep(0.2)
            register_node("addone", "127.0.0.1", port, broker_port=broker.port)
            cp = Pipeline("client", device="cpu")
            src = cp.add_new("appsrc", caps=caps_of("2:1", "float32"),
                             data=[np.zeros((1, 2), np.float32)])
            qc = cp.add_new("tensor_query_client", operation="addone",
                            broker_port=broker.port)
            sink = cp.add_new("tensor_sink", store=True)
            Pipeline.link(src, qc, sink)
            cp.run(timeout=60)
            np.testing.assert_array_equal(sink.buffers[0].memories[0].host(),
                                          np.ones((1, 2), np.float32))
        finally:
            sp.stop()
            broker.stop()


class TestMultiProcess:
    def test_server_in_separate_process(self, tmp_path):
        """True cross-process offload (reference runs server & client as
        separate gst-launch processes)."""
        import subprocess
        import sys

        port = free_port()
        server_code = f"""
import numpy as np
from nnstreamer_tpu_torch.graph import Pipeline
p = Pipeline(device="cpu")
ssrc = p.add_new("tensor_query_serversrc", host="127.0.0.1", port={port},
                 id=0, dims="3:1", types="float32")
f = p.add_new("tensor_filter", model=lambda x: -x)
ssink = p.add_new("tensor_query_serversink", id=0)
Pipeline.link(ssrc, f, ssink)
p.start()
print("READY", flush=True)
import time
time.sleep(60)  # lifetime window; the test terminates us once done
p.stop()
"""
        import os

        env = dict(os.environ)
        env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))
        proc = subprocess.Popen([sys.executable, "-u", "-c", server_code],
                                stdout=subprocess.PIPE, env=env, text=True)
        try:
            line = proc.stdout.readline()
            assert "READY" in line
            cp = Pipeline("client", device="cpu")
            src = cp.add_new("appsrc", caps=caps_of("3:1", "float32"),
                             data=[np.full((1, 3), 4.0, np.float32)])
            qc = cp.add_new("tensor_query_client", host="127.0.0.1", port=port)
            sink = cp.add_new("tensor_sink", store=True)
            Pipeline.link(src, qc, sink)
            cp.run(timeout=60)
            np.testing.assert_array_equal(sink.buffers[0].memories[0].host(),
                                          np.full((1, 3), -4.0, np.float32))
        finally:
            proc.terminate()
            proc.wait(timeout=10)


class TestGrpc:
    def test_push_sink_to_server_src(self):
        pytest.importorskip("grpc")
        sp = Pipeline("grpc-server", device="cpu")
        gsrc = sp.add_new("tensor_grpc_src", port=0, server=True)
        ssink = sp.add_new("tensor_sink", store=True)
        Pipeline.link(gsrc, ssink)
        sp.start()
        try:
            time.sleep(0.3)
            port = gsrc.bound_port
            cp = Pipeline("grpc-client", device="cpu")
            src = cp.add_new("appsrc", caps=caps_of("3:1", "float32"),
                             data=[np.full((1, 3), i, np.float32)
                                   for i in range(4)])
            gsink = cp.add_new("tensor_grpc_sink", port=port, server=False)
            Pipeline.link(src, gsink)
            cp.run(timeout=30)
            deadline = time.monotonic() + 10
            while ssink.num_buffers < 4 and time.monotonic() < deadline:
                time.sleep(0.05)
            assert ssink.num_buffers == 4
            np.testing.assert_array_equal(
                ssink.buffers[2].memories[0].host(),
                np.full((1, 3), 2.0, np.float32))
        finally:
            sp.stop()


class TestPubSub:
    def test_mqtt_style_pubsub(self):
        from nnstreamer_tpu_torch.query.pubsub import PubSubBroker

        broker = PubSubBroker(port=0).start()
        try:
            rp = Pipeline("subscriber", device="cpu")
            msrc = rp.add_new("mqttsrc", port=broker.port, sub_topic="cam0")
            rsink = rp.add_new("tensor_sink", store=True)
            Pipeline.link(msrc, rsink)
            rp.start()
            time.sleep(0.3)
            tp = Pipeline("publisher", device="cpu")
            src = tp.add_new("appsrc", caps=caps_of("2:1", "float32"),
                             data=[np.full((1, 2), i, np.float32)
                                   for i in range(3)])
            msink = tp.add_new("mqttsink", port=broker.port, pub_topic="cam0")
            Pipeline.link(src, msink)
            tp.run(timeout=30)
            deadline = time.monotonic() + 10
            while rsink.num_buffers < 3 and time.monotonic() < deadline:
                time.sleep(0.05)
            rp.stop()
            assert rsink.num_buffers == 3
            assert "mqtt_latency_us" in rsink.buffers[0].meta
        finally:
            broker.stop()


class TestGrpcIdlVariants:
    @pytest.mark.parametrize("idl", ["protobuf", "flatbuf"])
    def test_push_roundtrip(self, idl):
        """gRPC transport with the reference's two IDL message formats
        (nnstreamer_grpc_protobuf.cc / nnstreamer_grpc_flatbuf.cc +
        nnstreamer.fbs/.proto)."""
        pytest.importorskip("grpc")  # the port's codecs need no flatbuffers
        rp = Pipeline("receiver", device="cpu")
        gsrc = rp.add_new("tensor_grpc_src", port=0, idl=idl)
        rsink = rp.add_new("tensor_sink", store=True)
        Pipeline.link(gsrc, rsink)
        rp.start()
        try:
            deadline = time.monotonic() + 5
            while not hasattr(gsrc, "bound_port") \
                    and time.monotonic() < deadline:
                time.sleep(0.05)
            port = gsrc.bound_port
            tp = Pipeline("tx", device="cpu")
            arrs = [np.full((1, 3), i, np.float32) for i in range(3)]
            src = tp.add_new("appsrc", caps=caps_of("3:1", "float32"),
                             data=arrs)
            gsink = tp.add_new("tensor_grpc_sink", port=port, idl=idl)
            Pipeline.link(src, gsink)
            tp.run(timeout=30)
            deadline = time.monotonic() + 10
            while rsink.num_buffers < 3 and time.monotonic() < deadline:
                time.sleep(0.05)
            assert rsink.num_buffers == 3
            got = sorted(float(b.memories[0].host().reshape(-1)[0])
                         for b in rsink.buffers)
            assert got == [0.0, 1.0, 2.0]
        finally:
            rp.stop()


class TestChunkedTransfer:
    """Chunked DATA framing (reference TRANSFER_START/DATA/END,
    tensor_query_common.h:42-68) + per-chunk timeouts + fault injection."""

    @staticmethod
    def _pipe():
        a, b = socket.socketpair()
        return a, b

    def test_large_payload_streams_in_chunks(self):
        from nnstreamer_tpu_torch.query.protocol import (
            CHUNK_SIZE, recv_message, send_message)

        a, b = self._pipe()
        payload = bytes(np.random.default_rng(0).bytes(3 * CHUNK_SIZE + 17))
        t = threading.Thread(
            target=send_message, args=(a, Cmd.DATA, {"k": 1}, payload),
            daemon=True)
        t.start()
        cmd, meta, got = recv_message(b)
        assert cmd is Cmd.DATA and meta == {"k": 1}
        assert got == payload
        t.join(5)
        a.close(); b.close()

    def test_small_payload_single_message(self):
        from nnstreamer_tpu_torch.query.protocol import recv_message, send_message

        a, b = self._pipe()
        send_message(a, Cmd.RESULT, {"x": 2}, b"tiny")
        cmd, meta, got = recv_message(b)
        assert (cmd, meta, got) == (Cmd.RESULT, {"x": 2}, b"tiny")
        a.close(); b.close()

    def test_chunk_timeout_detects_stalled_sender(self):
        from nnstreamer_tpu_torch.query.protocol import (
            QueryProtocolError, pack_message, recv_message)

        a, b = self._pipe()
        # CHUNK_START promising data, then silence: per-chunk timeout must
        # fire instead of hanging for the whole payload
        a.sendall(pack_message(Cmd.CHUNK_START,
                               {"chunked_cmd": int(Cmd.DATA),
                                "chunked_total": 5 * 1024 * 1024}))
        t0 = time.monotonic()
        with pytest.raises(QueryProtocolError, match="chunk timeout"):
            recv_message(b, chunk_timeout=0.3)
        assert time.monotonic() - t0 < 5
        a.close(); b.close()

    def test_truncated_frame_rejected(self):
        from nnstreamer_tpu_torch.query.protocol import recv_message

        a, b = self._pipe()
        full = pack_message(Cmd.DATA, {"sizes": [999]}, b"x" * 10)
        a.sendall(full[: len(full) // 2])
        a.close()  # peer dies mid-frame
        with pytest.raises(ConnectionError):
            recv_message(b)
        b.close()

    def test_chunk_out_of_bounds_rejected(self):
        from nnstreamer_tpu_torch.query.protocol import (
            QueryProtocolError, pack_message, recv_message)

        a, b = self._pipe()
        a.sendall(pack_message(Cmd.CHUNK_START,
                               {"chunked_cmd": int(Cmd.DATA),
                                "chunked_total": 10}))
        a.sendall(pack_message(Cmd.CHUNK_DATA, {"off": 8}, b"xxxx"))
        with pytest.raises(QueryProtocolError, match="out of order"):
            recv_message(b, chunk_timeout=2.0)
        a.close(); b.close()

    def test_duplicate_chunk_rejected(self):
        """A duplicated/overlapping chunk must not let a hole pass the
        completeness check (byte counters alone would be fooled)."""
        from nnstreamer_tpu_torch.query.protocol import (
            QueryProtocolError, pack_message, recv_message)

        a, b = self._pipe()
        a.sendall(pack_message(Cmd.CHUNK_START,
                               {"chunked_cmd": int(Cmd.DATA),
                                "chunked_total": 8}))
        a.sendall(pack_message(Cmd.CHUNK_DATA, {"off": 0}, b"1234"))
        a.sendall(pack_message(Cmd.CHUNK_DATA, {"off": 0}, b"1234"))
        a.sendall(pack_message(Cmd.CHUNK_END, {}))
        with pytest.raises(QueryProtocolError, match="out of order"):
            recv_message(b, chunk_timeout=2.0)
        a.close(); b.close()

    def test_null_chunk_meta_rejected(self):
        """{"chunked_total": null} decodes to None; int(None) raises
        TypeError, which must surface as QueryProtocolError — a bad peer
        never crashes the receive loop with a raw TypeError."""
        from nnstreamer_tpu_torch.query.protocol import (
            QueryProtocolError, pack_message, recv_message)

        a, b = self._pipe()
        a.sendall(pack_message(Cmd.CHUNK_START,
                               {"chunked_cmd": int(Cmd.DATA),
                                "chunked_total": None}))
        with pytest.raises(QueryProtocolError, match="bad CHUNK_START"):
            recv_message(b, chunk_timeout=2.0)
        a.close(); b.close()

    def test_incomplete_chunked_transfer_rejected(self):
        from nnstreamer_tpu_torch.query.protocol import (
            QueryProtocolError, pack_message, recv_message)

        a, b = self._pipe()
        a.sendall(pack_message(Cmd.CHUNK_START,
                               {"chunked_cmd": int(Cmd.DATA),
                                "chunked_total": 8}))
        a.sendall(pack_message(Cmd.CHUNK_DATA, {"off": 0}, b"1234"))
        a.sendall(pack_message(Cmd.CHUNK_END, {}))
        with pytest.raises(QueryProtocolError, match="incomplete"):
            recv_message(b, chunk_timeout=2.0)
        a.close(); b.close()


class TestFaultInjection:
    """Server/client resilience (reference runTest.sh kills background
    pipelines mid-stream; unittest_query asserts error paths)."""

    def test_server_survives_garbage_and_truncated_clients(self):
        """A malformed client must not take the server down; the next
        well-behaved client still gets service."""
        sp = Pipeline("server", device="cpu")
        ssrc = sp.add_new("tensor_query_serversrc", port=0, id=0,
                          dims="2:1", types="float32")
        ssink = sp.add_new("tensor_query_serversink", id=0)
        Pipeline.link(ssrc, ssink)
        sp.start()
        try:
            deadline = time.monotonic() + 5
            while not hasattr(ssrc, "bound_port") \
                    and time.monotonic() < deadline:
                time.sleep(0.05)
            port = ssrc.bound_port
            # 1: pure garbage bytes
            g = socket.create_connection(("127.0.0.1", port), 5)
            g.sendall(b"\xde\xad\xbe\xef" * 8)
            g.close()
            # 2: valid header then truncated body + hard close
            t = socket.create_connection(("127.0.0.1", port), 5)
            full = pack_message(Cmd.DATA, {"sizes": [100]}, b"y" * 100)
            t.sendall(full[:20])
            t.close()
            time.sleep(0.2)
            # 3: real client pipeline still gets echo service
            cp = Pipeline("client", device="cpu")
            arrs = [np.full((1, 2), i, np.float32) for i in range(2)]
            src = cp.add_new("appsrc", caps=caps_of("2:1", "float32"),
                             data=arrs)
            qc = cp.add_new("tensor_query_client", port=port)
            sink = cp.add_new("tensor_sink", store=True)
            Pipeline.link(src, qc, sink)
            cp.run(timeout=30)
            assert sink.num_buffers == 2
        finally:
            sp.stop()

    def test_client_error_on_server_killed_mid_stream(self):
        """Server dies between frames → client either recovers by retry
        (reconnect) or surfaces a pipeline error — never hangs."""
        from nnstreamer_tpu_torch.graph import PipelineError

        sp = Pipeline("server", device="cpu")
        ssrc = sp.add_new("tensor_query_serversrc", port=0, id=0,
                          dims="2:1", types="float32")
        ssink = sp.add_new("tensor_query_serversink", id=0)
        Pipeline.link(ssrc, ssink)
        sp.start()
        deadline = time.monotonic() + 5
        while not hasattr(ssrc, "bound_port") and time.monotonic() < deadline:
            time.sleep(0.05)
        port = ssrc.bound_port

        killed = threading.Event()

        def frames():
            yield np.full((1, 2), 0, np.float32)
            sp.stop()  # hard kill between frames
            killed.set()
            yield np.full((1, 2), 1, np.float32)
            yield np.full((1, 2), 2, np.float32)

        cp = Pipeline("client", device="cpu")
        src = cp.add_new("appsrc", caps=caps_of("2:1", "float32"),
                         data=frames())
        qc = cp.add_new("tensor_query_client", port=port,
                        max_request_retry=2)
        sink = cp.add_new("tensor_sink", store=True)
        Pipeline.link(src, qc, sink)
        t0 = time.monotonic()
        try:
            cp.run(timeout=60)
        except PipelineError:
            pass  # surfacing the failure is acceptable; hanging is not
        assert killed.is_set()
        assert time.monotonic() - t0 < 60
        assert sink.num_buffers >= 1  # pre-kill frame was served


class TestTwoInterpreterQuery:
    def test_cross_process_offload(self, tmp_path):
        """True two-interpreter test (reference runs server & client as
        separate gst-launch processes, tests/nnstreamer_query/runTest.sh:41-80):
        the server pipeline lives in a SEPARATE python process; this process
        runs the client pipeline against it."""
        import os
        import subprocess
        import sys

        port_file = tmp_path / "port.txt"
        code = f"""
import os, sys, time
sys.path.insert(0, {os.path.dirname(os.path.dirname(os.path.abspath(__file__)))!r})
from nnstreamer_tpu_torch.graph import Pipeline
p = Pipeline("server", device="cpu")
ssrc = p.add_new("tensor_query_serversrc", port=0, id=0, dims="2:1", types="float32")
filt = p.add_new("tensor_filter", framework="xla-tpu", model="zoo://scaler?dims=2:1&types=float32&scale=3")
ssink = p.add_new("tensor_query_serversink", id=0)
Pipeline.link(ssrc, filt, ssink)
p.start()
deadline = time.monotonic() + 10
while not hasattr(ssrc, "bound_port") and time.monotonic() < deadline:
    time.sleep(0.05)
open({str(port_file)!r}, "w").write(str(ssrc.bound_port))
time.sleep(30)
"""
        srv = subprocess.Popen([sys.executable, "-c", code],
                               stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE)
        try:
            deadline = time.monotonic() + 60
            while not port_file.exists() and time.monotonic() < deadline:
                if srv.poll() is not None:
                    raise AssertionError(
                        "server process died: "
                        + srv.stderr.read().decode()[-2000:])
                time.sleep(0.1)
            port = int(port_file.read_text())

            cp = Pipeline("client", device="cpu")
            arrs = [np.full((1, 2), float(i), np.float32) for i in range(3)]
            src = cp.add_new("appsrc", caps=caps_of("2:1", "float32"),
                             data=arrs)
            qc = cp.add_new("tensor_query_client", port=port)
            sink = cp.add_new("tensor_sink", store=True)
            Pipeline.link(src, qc, sink)
            cp.run(timeout=60)
            assert sink.num_buffers == 3
            for i, b in enumerate(sink.buffers):
                np.testing.assert_allclose(b.memories[0].host(),
                                           np.full((1, 2), i * 3.0))
        finally:
            srv.kill()
            srv.wait(timeout=10)


class TestPipelinedOffload:
    """async_depth on tensor_query_client/serversink: pipelined offload
    (TPU-first RTT hiding; default depth=1 keeps reference-sync semantics)."""

    def _server(self, port, depth=8):
        sp = Pipeline("server", device="cpu")
        ssrc = sp.add_new("tensor_query_serversrc", host="127.0.0.1",
                          port=port, id=0, dims="4:1", types="float32")
        filt = sp.add_new("tensor_filter", model=lambda x: x * 10)
        ssink = sp.add_new("tensor_query_serversink", id=0,
                           async_depth=depth)
        Pipeline.link(ssrc, filt, ssink)
        return sp

    def test_pipelined_roundtrip_order_and_values(self):
        port = free_port()
        sp = self._server(port)
        sp.start()
        try:
            time.sleep(0.2)
            n = 40
            cp = Pipeline("client", device="cpu")
            src = cp.add_new("appsrc", caps=caps_of("4:1", "float32"),
                             data=[np.full((1, 4), i, np.float32)
                                   for i in range(n)])
            qc = cp.add_new("tensor_query_client", host="127.0.0.1",
                            port=port, async_depth=8)
            sink = cp.add_new("tensor_sink", store=True)
            Pipeline.link(src, qc, sink)
            cp.run(timeout=120)
            assert sink.num_buffers == n  # EOS drained every in-flight frame
            for i, b in enumerate(sink.buffers):
                np.testing.assert_array_equal(
                    b.memories[0].host(),
                    np.full((1, 4), i * 10, np.float32))
                assert b.offset == i  # timestamps restored in order
        finally:
            sp.stop()

    def test_pipelined_faster_than_sync_with_slow_server(self):
        """A server with per-frame latency must overlap across the window."""
        port = free_port()
        sp = Pipeline("server", device="cpu")
        ssrc = sp.add_new("tensor_query_serversrc", host="127.0.0.1",
                          port=port, id=0, dims="4:1", types="float32")

        from nnstreamer_tpu_torch.filters.custom import register_custom_easy

        def slow(x):
            time.sleep(0.05)
            return x

        register_custom_easy("qtest_slow_echo", slow,
                             ("4:1", "float32"), ("4:1", "float32"))
        filt = sp.add_new("tensor_filter", framework="custom-easy",
                          model="qtest_slow_echo")
        ssink = sp.add_new("tensor_query_serversink", id=0, async_depth=16)
        Pipeline.link(ssrc, filt, ssink)
        sp.start()
        try:
            time.sleep(0.2)
            n = 20
            cp = Pipeline("client", device="cpu")
            src = cp.add_new("appsrc", caps=caps_of("4:1", "float32"),
                             data=[np.zeros((1, 4), np.float32)] * n)
            qc = cp.add_new("tensor_query_client", host="127.0.0.1",
                            port=port, async_depth=16)
            sink = cp.add_new("tensor_sink", store=True)
            Pipeline.link(src, qc, sink)
            t0 = time.monotonic()
            cp.run(timeout=120)
            wall = time.monotonic() - t0
            assert sink.num_buffers == n
            # the server filter itself is serial (20 × 50 ms ≥ 1 s), but
            # client-side send/receive overlap must not ADD per-frame
            # round trips on top; sync mode costs ≥ n × (invoke + 2 RTT)
            assert wall < n * 0.05 * 2.5, f"no overlap: {wall:.2f}s"
        finally:
            sp.stop()

    def test_reader_failure_surfaces_on_bus(self):
        from nnstreamer_tpu_torch.graph.pipeline import PipelineError

        port = free_port()
        sp = self._server(port)
        sp.start()
        time.sleep(0.2)

        killed = {}

        def gen():
            for i in range(100):
                if i == 25 and not killed:
                    killed["yes"] = True
                    sp.stop()  # kill server with frames in flight
                    time.sleep(0.3)
                yield np.zeros((1, 4), np.float32)

        cp = Pipeline("client", device="cpu")
        src = cp.add_new("appsrc", caps=caps_of("4:1", "float32"),
                         data=gen())
        qc = cp.add_new("tensor_query_client", host="127.0.0.1", port=port,
                        async_depth=8)
        sink = cp.add_new("tensor_sink", store=True)
        Pipeline.link(src, qc, sink)
        with pytest.raises((PipelineError, TimeoutError)):
            cp.run(timeout=30)

    def test_pipelined_reconnects_after_server_restart(self):
        """A cleanly closed connection between streams must reconnect on
        the next frame (reader exits cleanly, next chain redials)."""
        port = free_port()
        sp1 = self._server(port)
        sp1.start()
        time.sleep(0.2)
        cp = Pipeline("client", device="cpu")
        src = cp.add_new("appsrc", caps=caps_of("4:1", "float32"))
        qc = cp.add_new("tensor_query_client", host="127.0.0.1", port=port,
                        async_depth=4, max_request_retry=10)
        sink = cp.add_new("tensor_sink", store=True)
        Pipeline.link(src, qc, sink)
        cp.start()
        try:
            src.push_buffer(np.full((1, 4), 1, np.float32))
            deadline = time.monotonic() + 30
            while sink.num_buffers < 1 and time.monotonic() < deadline:
                time.sleep(0.02)
            assert sink.num_buffers == 1
            sp1.stop()          # server goes away between frames
            time.sleep(0.3)
            sp2 = self._server(port)
            sp2.start()
            time.sleep(0.3)
            try:
                src.push_buffer(np.full((1, 4), 2, np.float32))
                src.end_of_stream()
                assert cp.wait_eos(30)
                assert sink.num_buffers == 2
                np.testing.assert_array_equal(
                    sink.buffers[1].memories[0].host(),
                    np.full((1, 4), 20, np.float32))
            finally:
                sp2.stop()
        finally:
            cp.stop()
            sp1.stop()


class TestLintRegressions:
    """Focused regressions for the true positives nnslint surfaced
    (see docs/analysis.md): the INFO_DENY dispatch gap, thread-leak
    joins, and the _peer_of never-raise boundary."""

    def _serve(self, port):
        sp = Pipeline("server", device="cpu")
        ssrc = sp.add_new("tensor_query_serversrc", host="127.0.0.1",
                          port=port, id=90, dims="4:1", types="float32")
        filt = sp.add_new("tensor_filter", model=lambda x: x)
        ssink = sp.add_new("tensor_query_serversink", id=90)
        Pipeline.link(ssrc, filt, ssink)
        sp.start()
        time.sleep(0.2)
        return sp

    def test_server_denies_caps_mismatch_with_info_deny(self):
        from nnstreamer_tpu_torch.query.protocol import recv_message, send_message

        port = free_port()
        sp = self._serve(port)
        try:
            # wrong media type: explicit INFO_DENY naming the mismatch,
            # not a generic error after the first DATA frame
            with socket.create_connection(("127.0.0.1", port), 5) as s:
                send_message(s, Cmd.INFO_REQ, {"caps": "video/x-raw(w=4)"})
                cmd, meta, _ = recv_message(s)
                assert cmd is Cmd.INFO_DENY
                assert "caps mismatch" in meta["error"]
            # compatible (and unknown) caps still approve
            for caps in ("other/tensors(dims=4:1)", ""):
                with socket.create_connection(("127.0.0.1", port), 5) as s:
                    send_message(s, Cmd.INFO_REQ, {"caps": caps})
                    cmd, meta, _ = recv_message(s)
                    assert cmd is Cmd.INFO_APPROVE, caps
        finally:
            sp.stop()

    def test_client_surfaces_deny_reason(self):
        from nnstreamer_tpu_torch.query.client import TensorQueryClient

        port = free_port()
        sp = self._serve(port)
        try:
            qc = TensorQueryClient(host="127.0.0.1", port=port,
                                   timeout_s=2.0)
            qc.sink_pad.caps = Caps("video/x-raw", {"w": 4})
            with pytest.raises(ConnectionError, match="caps mismatch"):
                qc._connect()
        finally:
            sp.stop()

    def test_server_stop_joins_all_workers(self):
        port = free_port()
        sp = self._serve(port)
        with socket.create_connection(("127.0.0.1", port), 5):
            time.sleep(0.3)  # let the accept loop spawn the conn worker
        sp.stop()
        leaked = [t.name for t in threading.enumerate()
                  if t.name.startswith("qsrv-")]
        assert leaked == []

    def test_discovery_broker_stop_joins_thread(self):
        broker = DiscoveryBroker(port=0).start()
        worker = broker._thread
        assert worker is not None and worker.is_alive()
        broker.stop()
        assert broker._thread is None
        assert not worker.is_alive()
        # the joined listener releases the port for an immediate rebind
        broker2 = DiscoveryBroker(port=broker.port).start()
        broker2.stop()

    def test_peer_of_never_raises(self):
        from nnstreamer_tpu_torch.query.protocol import _peer_of

        class WeirdSock:
            def getpeername(self):
                raise RuntimeError("socket layer bug")  # outside OSError

        class TupleLess:
            def getpeername(self):
                return 7  # peer[0] raises TypeError

        s = socket.socket()
        s.close()
        assert _peer_of(s) is None            # OSError path
        assert _peer_of(WeirdSock()) is None  # arbitrary exception
        assert _peer_of(TupleLess()) is None


# --------------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------------- #

@pytest.mark.cuda
def test_poison_stays_on_the_card():
    import torch

    from nnstreamer_tpu_torch.core.buffer import TensorMemory
    from nnstreamer_tpu_torch.resilience import chaos

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for dtype, want in ((torch.float32, float("nan")),
                        (torch.int32, 2 ** 31 - 1), (torch.uint8, 255),
                        (torch.int64, 2 ** 63 - 1), (torch.bfloat16, 1.0)):
        t = torch.zeros((3, 5), dtype=dtype, device="cuda")
        buf = Buffer([TensorMemory(t)])
        chaos._poison_buffer(buf)
        mem = buf.memories[0]
        assert mem._host is None and mem._device.device.type == "cuda"
        got = mem._device.cpu()
        if dtype is torch.float32:
            assert torch.isnan(got).all()
        else:
            assert (got == want).all()


@pytest.mark.cuda
def test_async_serversink_sends_graph_outputs_as_sync():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from nnstreamer_tpu_torch.query.server import wait_bound_port

    rng = np.random.default_rng(17)
    frames = [rng.standard_normal((2, 4)).astype(np.float32)
              for _ in range(24)]
    got = {}
    for depth in (1, 8):
        sp = Pipeline(f"card{depth}", device="cuda")
        src = sp.add_new("tensor_query_serversrc", host="127.0.0.1", port=0,
                         id=100 + depth, dims="4:2", types="float32")
        filt = sp.add_new("tensor_filter", model=lambda x: x * 3 - 1)
        sink = sp.add_new("tensor_query_serversink", id=100 + depth,
                          async_depth=depth)
        Pipeline.link(src, filt, sink)
        sp.start()
        try:
            port = wait_bound_port(src)
            cp = Pipeline("card-client", device="cuda")
            csrc = cp.add_new("appsrc", caps=caps_of("4:2", "float32"),
                              data=frames)
            qc = cp.add_new("tensor_query_client", host="127.0.0.1",
                            port=port, async_depth=8)
            csink = cp.add_new("tensor_sink", store=True)
            Pipeline.link(csrc, qc, csink)
            cp.run(timeout=60)
            got[depth] = [b.memories[0].host().tobytes()
                          for b in csink.buffers]
        finally:
            sp.stop()
    assert len(got[8]) == len(frames)
    assert got[8] == got[1]
