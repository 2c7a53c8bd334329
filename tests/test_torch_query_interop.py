"""The port's query and resilience layers against the JAX package's.

Cross-package wire: a port client against a JAX server and a JAX client
against a port server return the same seeded frames; ``pack_message``,
``buffer_to_payload`` and the chunked send put the same bytes on the wire
for float32, uint8, int64, bfloat16, multi-tensor, sparse and > 1 MiB
payloads; the MQTT ``MessageHdr``, a ``PUBLISH`` frame and a whole mqttsink
message are byte-equal; discovery registers and resolves across packages;
the gRPC flex and protobuf bodies are byte-equal. Parity: a seeded
``FaultPlan`` fires the same faults at the same calls, ``_poison_buffer``
gives the JAX values (a torch tensor stays a torch tensor on its device),
``BackendSet.pick`` makes the JAX choices from the same seed and loads (ring
placement and spill included), and ``ROUTER_SLO_HOOK.record_dispatch``
counts the JAX router's bytes. The diag bundle's ``routing`` stanza is the
live routers' view. The CLI's query flags parse, refuse and wire as the JAX
CLI's, with ``NNS_TPU_CHAOS``. (The ``cuda`` cases are in
tests/test_torch_query.py, which imports no JAX.)

Every case runs under a timeout of its own (SIGALRM), binds port 0 and
leaves no fault plan, SLO registry or repo slot behind.
"""

import random
import signal
import socket
import threading
import time

import numpy as np
import pytest
import torch

import nnstreamer_tpu.query.protocol as jproto
import nnstreamer_tpu_torch.query.protocol as tproto
from nnstreamer_tpu.core import Buffer as JBuffer
from nnstreamer_tpu.core import Caps as JCaps
from nnstreamer_tpu.core import TensorsConfig as JTensorsConfig
from nnstreamer_tpu.core import TensorsInfo as JTensorsInfo
from nnstreamer_tpu.graph import Pipeline as JPipeline
from nnstreamer_tpu.query import router as jrouter
from nnstreamer_tpu.resilience import chaos as jchaos
from nnstreamer_tpu_torch.core import Buffer, Caps, TensorsConfig, TensorsInfo
from nnstreamer_tpu_torch.core.buffer import TensorMemory
from nnstreamer_tpu_torch.core.types import TensorDType
from nnstreamer_tpu_torch.graph import Pipeline
from nnstreamer_tpu_torch.query import router as trouter
from nnstreamer_tpu_torch.query.server import wait_bound_port
from nnstreamer_tpu_torch.resilience import chaos as tchaos

BF16 = TensorDType.BFLOAT16.np_dtype

#: each case's own limit, seconds
CASE_TIMEOUT_S = 90


@pytest.fixture(autouse=True)
def _case_guard():
    def expire(signum, frame):
        raise TimeoutError(f"case exceeded {CASE_TIMEOUT_S} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(CASE_TIMEOUT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
        from nnstreamer_tpu.elements.repo import reset_repo as jreset
        from nnstreamer_tpu.obs import slo as jslo
        from nnstreamer_tpu_torch.elements.repo import reset_repo
        from nnstreamer_tpu_torch.obs import slo as tslo

        tchaos.uninstall()
        jchaos.uninstall()
        tslo.disable()
        jslo.disable()
        reset_repo()
        jreset()


def _caps(pkg, dims, types):
    if pkg == "jax":
        return JCaps.tensors(JTensorsConfig(
            JTensorsInfo.from_strings(dims, types), 30))
    return Caps.tensors(TensorsConfig(TensorsInfo.from_strings(dims, types),
                                      30))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


#: the echo server's stream: one frame of four tensors, each dtype the
#: wire must carry unchanged
ECHO_DIMS, ECHO_TYPES = "4:2,3:1,5:1,2:2", "float32,uint8,int64,bfloat16"


def _echo_frames(n, seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((2, 4)).astype(np.float32),
             rng.integers(0, 256, (1, 3), dtype=np.uint8),
             rng.integers(-2 ** 40, 2 ** 40, (1, 5), dtype=np.int64),
             rng.standard_normal((2, 2)).astype(np.float32).astype(BF16))
            for _ in range(n)]


def _server(pkg, sid, scale=False, dims="4:2"):
    """A server pipeline of either package on port 0: the echo
    (serversrc ! serversink) over ECHO_*, or a float32 ``x * 2`` filter
    over ``dims``. Returns (pipeline, port)."""
    if pkg == "jax":
        from nnstreamer_tpu.query.server import wait_bound_port as jwait

        p, wait = JPipeline(f"jsrv{sid}"), jwait
    else:
        p, wait = Pipeline(f"tsrv{sid}", device="cpu"), wait_bound_port
    dims, types = (dims, "float32") if scale else (ECHO_DIMS, ECHO_TYPES)
    src = p.add_new("tensor_query_serversrc", host="127.0.0.1", port=0,
                    id=sid, dims=dims, types=types)
    sink = p.add_new("tensor_query_serversink", id=sid)
    if scale:
        type(p).link(src, p.add_new("tensor_filter", model=lambda x: x * 2),
                     sink)
    else:
        type(p).link(src, sink)
    p.start()
    return p, wait(src)


def _client_run(pkg, port, frames, dims, types, depth=1):
    """A client pipeline of either package: appsrc ! tensor_query_client
    ! tensor_sink over ``frames``; returns each frame's host arrays."""
    if pkg == "jax":
        p = JPipeline("jcli")
    else:
        p = Pipeline("tcli", device="cpu")
    src = p.add_new("appsrc", caps=_caps(pkg, dims, types), data=frames)
    qc = p.add_new("tensor_query_client", host="127.0.0.1", port=port,
                   async_depth=depth, timeout_s=5.0)
    sink = p.add_new("tensor_sink", store=True)
    type(p).link(src, qc, sink)
    p.run(timeout=60)
    return [[np.asarray(m.host()) for m in b.memories] for b in sink.buffers]


# --------------------------------------------------------------------------- #
# Cross-package wire: clients against servers
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("client,server", [("torch", "jax"), ("jax", "torch")])
@pytest.mark.parametrize("depth", [1, 4])
def test_cross_package_echo_returns_the_frames(client, server, depth):
    frames = _echo_frames(6)
    sp, port = _server(server, 40 + depth)
    try:
        got = _client_run(client, port, frames, ECHO_DIMS, ECHO_TYPES, depth)
    finally:
        sp.stop()
    assert len(got) == len(frames)
    for want, out in zip(frames, got):
        assert [a.dtype.name for a in out] == [a.dtype.name for a in want]
        for a, b in zip(want, out):
            assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("client,server", [("torch", "jax"), ("jax", "torch")])
def test_cross_package_filter_hop(client, server):
    rng = np.random.default_rng(11)
    frames = [rng.standard_normal((2, 4)).astype(np.float32)
              for _ in range(5)]
    sp, port = _server(server, 50, scale=True)
    try:
        got = _client_run(client, port, frames, "4:2", "float32")
    finally:
        sp.stop()
    for x, out in zip(frames, got):
        assert out[0].tobytes() == (x * 2).tobytes()


# --------------------------------------------------------------------------- #
# Wire bytes equal the JAX package's
# --------------------------------------------------------------------------- #

def _payload_cases():
    rng = np.random.default_rng(5)
    sparse = np.zeros((16, 16), np.float32)
    sparse[3, 7], sparse[9, 1] = 4.5, -2.0
    return {
        "float32": ([rng.standard_normal((3, 5)).astype(np.float32)], False),
        "uint8": ([rng.integers(0, 256, (1, 32, 32, 3), dtype=np.uint8)],
                  False),
        "int64": ([rng.integers(-2 ** 50, 2 ** 50, (7,), dtype=np.int64)],
                  False),
        "bfloat16": ([rng.standard_normal((4, 6)).astype(np.float32)
                      .astype(BF16)], False),
        "multi": ([rng.standard_normal((2, 2)).astype(np.float32),
                   np.arange(5, dtype=np.uint8),
                   np.arange(3, dtype=np.int64)], False),
        "sparse": ([sparse], True),
        "chunked": ([rng.integers(0, 256, (3 * (1 << 20) + 17,),
                                  dtype=np.uint8)], False),
    }


@pytest.mark.parametrize("case", list(_payload_cases()))
def test_buffer_to_payload_bytes_equal_jax(case):
    arrays, sparse = _payload_cases()[case]
    jm, jp = jproto.buffer_to_payload(
        JBuffer.of(*arrays, pts=33, duration=7, offset=2), sparse=sparse)
    tm, tp = tproto.buffer_to_payload(
        Buffer.of(*arrays, pts=33, duration=7, offset=2), sparse=sparse)
    assert tm == jm and list(tm) == list(jm)  # key order is wire order
    assert tp == jp
    assert tproto.pack_message(tproto.Cmd.DATA, tm, tp) \
        == jproto.pack_message(jproto.Cmd.DATA, jm, jp)
    # the port decodes the JAX payload (and the reverse) to the same arrays
    back = tproto.payload_to_buffer(jm, jp)
    jback = jproto.payload_to_buffer(tm, tp)
    for a, m, jmm in zip(arrays, back.memories, jback.memories):
        assert np.asarray(m.host()).tobytes() == a.tobytes()
        assert np.asarray(jmm.host()).tobytes() == a.tobytes()
    assert (back.pts, back.duration, back.offset) == (33, 7, 2)


def test_torch_tensor_payload_equals_its_numpy_one():
    """A torch tensor memory (the port's device form) crosses as the bytes
    of its numpy twin, bfloat16 through its bits."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 4)).astype(np.float32)
    for arr, t in ((x, torch.from_numpy(x.copy())),
                   (x.astype(BF16), torch.from_numpy(x).to(torch.bfloat16))):
        assert tproto.buffer_to_payload(Buffer.of(t)) \
            == jproto.buffer_to_payload(JBuffer.of(arr))


def _sent_bytes(mod, payload, meta):
    a, b = socket.socketpair()
    out = []

    def drain():
        while True:
            chunk = b.recv(1 << 20)
            if not chunk:
                return
            out.append(chunk)

    t = threading.Thread(target=drain, daemon=True)
    t.start()
    mod.send_message(a, mod.Cmd.DATA, meta, payload)
    a.close()
    t.join(10)
    b.close()
    return b"".join(out)


def test_chunked_send_bytes_equal_jax():
    payload = np.random.default_rng(2).bytes(2 * tproto.CHUNK_SIZE + 99)
    meta = {"pts": 1, "sizes": [len(payload)]}
    assert tproto.CHUNK_SIZE == jproto.CHUNK_SIZE
    assert _sent_bytes(tproto, payload, dict(meta)) \
        == _sent_bytes(jproto, payload, dict(meta))


def test_info_approve_meta_order_equals_jax():
    """INFO_APPROVE's keys in JAX's order (the JSON is key-order bytes)."""
    for pkg, (pipe, port) in (("jax", _server("jax", 61)),
                              ("torch", _server("torch", 62))):
        try:
            with socket.create_connection(("127.0.0.1", port), 5) as s:
                tproto.send_message(s, tproto.Cmd.INFO_REQ, {"caps": ""})
                cmd, meta, _ = tproto.recv_message(s)
        finally:
            pipe.stop()
        assert cmd is tproto.Cmd.INFO_APPROVE, pkg
        assert list(meta) == ["caps", "client_id", "instance"], pkg


# --------------------------------------------------------------------------- #
# MQTT, discovery and gRPC across packages
# --------------------------------------------------------------------------- #

def test_mqtt_header_publish_and_message_bytes_equal_jax():
    from nnstreamer_tpu.query import mqtt as jm
    from nnstreamer_tpu.query import pubsub as jps
    from nnstreamer_tpu_torch.query import mqtt as tm
    from nnstreamer_tpu_torch.query import pubsub as tps

    kw = dict(num_mems=2, size_mems=(8, 3), base_time_epoch=-4,
              sent_time_epoch=99, duration=5, dts=None, pts=77,
              caps_str="other/tensors,format=(string)static")
    assert tm.MessageHdr(**kw).pack() == jm.MessageHdr(**kw).pack()
    assert tm.encode_publish("cam/0", b"\x00xyz") \
        == jm.encode_publish("cam/0", b"\x00xyz")
    assert tm.encode_connect("c1", 30) == jm.encode_connect("c1", 30)
    assert tm.encode_subscribe(3, [("a/#", 0)]) \
        == jm.encode_subscribe(3, [("a/#", 0)])

    class Clock:
        def now_us(self):
            return 1_700_000_000_000_000

    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 4)).astype(np.float32)
    y = np.zeros((8, 8), np.float32)
    y[2, 5] = 3.0
    for arrays, sparse in (((x,), False), ((y,), True)):
        info = "4:1" if arrays[0] is x else "8:8"
        jcfg = JTensorsConfig(JTensorsInfo.from_strings(info, "float32"), 30)
        tcfg = TensorsConfig(TensorsInfo.from_strings(info, "float32"), 30)
        jmsg = jps._buffer_to_mqtt(JBuffer.of(*arrays, pts=5), 11, Clock(),
                                   sparse=sparse, stream_config=jcfg)
        tmsg = tps._buffer_to_mqtt(Buffer.of(*arrays, pts=5), 11, Clock(),
                                   sparse=sparse, stream_config=tcfg)
        assert tmsg == jmsg
        back = tps._mqtt_to_buffer(jmsg, 1_700_000_000_000_500)
        np.testing.assert_array_equal(back.memories[0].host(), arrays[0])
        assert back.meta["mqtt_latency_us"] == 500


def test_mqtt_stream_across_packages():
    """A JAX mqttsink through the port's broker into a port mqttsrc."""
    from nnstreamer_tpu_torch.query.mqtt import MqttBroker

    broker = MqttBroker(port=0).start()
    try:
        rp = Pipeline("rx", device="cpu")
        msrc = rp.add_new("mqttsrc", port=broker.port, sub_topic="x/+")
        rsink = rp.add_new("tensor_sink", store=True)
        Pipeline.link(msrc, rsink)
        rp.start()
        time.sleep(0.3)
        frames = [np.full((1, 3), i, np.float32) for i in range(3)]
        tp = JPipeline("tx")
        src = tp.add_new("appsrc", caps=_caps("jax", "3:1", "float32"),
                         data=frames)
        msink = tp.add_new("mqttsink", port=broker.port, pub_topic="x/a")
        JPipeline.link(src, msink)
        tp.run(timeout=30)
        deadline = time.monotonic() + 10
        while rsink.num_buffers < 3 and time.monotonic() < deadline:
            time.sleep(0.05)
        rp.stop()
        assert [b.memories[0].host().tobytes() for b in rsink.buffers] \
            == [f.tobytes() for f in frames]
    finally:
        broker.stop()


@pytest.mark.parametrize("broker_pkg", ["jax", "torch"])
def test_discovery_across_packages(broker_pkg):
    from nnstreamer_tpu.query import hybrid as jh
    from nnstreamer_tpu_torch.query import hybrid as th

    broker = (jh if broker_pkg == "jax" else th).DiscoveryBroker(port=0)
    broker.start()
    try:
        assert th.register_node("det", "127.0.0.1", 5001,
                                broker_port=broker.port)
        assert jh.register_node("det", "127.0.0.1", 5002,
                                broker_port=broker.port)
        want = [("127.0.0.1", 5001), ("127.0.0.1", 5002)]
        assert th.discover("det", broker_port=broker.port) == want
        assert jh.discover("det", broker_port=broker.port) == want
        assert jh.unregister_node("det", "127.0.0.1", 5001,
                                  broker_port=broker.port)
        assert th.discover("det", broker_port=broker.port) == want[1:]
    finally:
        broker.stop()


def test_client_resolves_a_jax_server_through_discovery():
    from nnstreamer_tpu.query import hybrid as jh

    broker = jh.DiscoveryBroker(port=0).start()
    sp, port = _server("jax", 70, scale=True)
    try:
        jh.register_node("x2", "127.0.0.1", port, broker_port=broker.port)
        p = Pipeline("via-broker", device="cpu")
        x = np.arange(8, dtype=np.float32).reshape(2, 4)
        src = p.add_new("appsrc", caps=_caps("torch", "4:2", "float32"),
                        data=[x])
        qc = p.add_new("tensor_query_client", operation="x2",
                       broker_port=broker.port)
        sink = p.add_new("tensor_sink", store=True)
        Pipeline.link(src, qc, sink)
        p.run(timeout=30)
        assert sink.buffers[0].memories[0].host().tobytes() \
            == (x * 2).tobytes()
    finally:
        sp.stop()
        broker.stop()


@pytest.mark.parametrize("idl", ["flex", "protobuf"])
def test_grpc_bodies_equal_jax(idl):
    pytest.importorskip("grpc")
    from nnstreamer_tpu.query import grpc_io as jg
    from nnstreamer_tpu_torch.query import grpc_io as tg

    rng = np.random.default_rng(6)
    arrays = (rng.standard_normal((2, 3)).astype(np.float32),
              rng.integers(0, 256, (4,), dtype=np.uint8))
    jcfg = JTensorsConfig(JTensorsInfo.from_strings("3:2,4", "float32,uint8"),
                          30)
    tcfg = TensorsConfig(TensorsInfo.from_strings("3:2,4", "float32,uint8"),
                         30)
    jbody = jg._codec(idl)[0](JBuffer.of(*arrays, pts=9, config=jcfg))
    tbody = tg._codec(idl)[0](Buffer.of(*arrays, pts=9, config=tcfg))
    assert tbody == jbody
    back = tg._codec(idl)[1](jbody)
    for a, m in zip(arrays, back.memories):
        assert np.asarray(m.host()).tobytes() == a.tobytes()


def test_grpc_push_from_jax_sink_to_port_src():
    pytest.importorskip("grpc")
    rp = Pipeline("grpc-rx", device="cpu")
    gsrc = rp.add_new("tensor_grpc_src", port=0, idl="protobuf")
    rsink = rp.add_new("tensor_sink", store=True)
    Pipeline.link(gsrc, rsink)
    rp.start()
    try:
        deadline = time.monotonic() + 5
        while not hasattr(gsrc, "bound_port") and time.monotonic() < deadline:
            time.sleep(0.05)
        frames = [np.full((1, 3), i, np.float32) for i in range(3)]
        tp = JPipeline("grpc-tx")
        src = tp.add_new("appsrc", caps=_caps("jax", "3:1", "float32"),
                         data=frames)
        gsink = tp.add_new("tensor_grpc_sink", port=gsrc.bound_port,
                           idl="protobuf")
        JPipeline.link(src, gsink)
        tp.run(timeout=30)
        deadline = time.monotonic() + 10
        while rsink.num_buffers < 3 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert sorted(float(b.memories[0].host().reshape(-1)[0])
                      for b in rsink.buffers) == [0.0, 1.0, 2.0]
    finally:
        rp.stop()


# --------------------------------------------------------------------------- #
# Chaos determinism and the poison's values
# --------------------------------------------------------------------------- #

_PLAN = {"seed": 13, "faults": [
    {"kind": "drop", "target": "send", "cmd": "DATA", "p": 0.3},
    {"kind": "delay", "target": "recv", "p": 0.2, "delay_s": 0.0},
    {"kind": "corrupt", "target": "chain:sink", "nth": [2, 5]},
    {"kind": "partition", "target": "send", "cmd": "DATA",
     "endpoint": "10.0.0.1:1", "nth": 3},
    {"kind": "disconnect", "target": "send", "p": 0.1, "max_fires": 2},
    {"kind": "drop", "target": "chain", "p": 0.25}]}


def _calls():
    rng = random.Random(4)
    targets = [("send", "DATA", None), ("send", "DATA", "10.0.0.1:1"),
               ("send", "INFO_REQ", None), ("recv", "RESULT", None),
               ("chain:sink", None, None), ("chain:mux", None, None)]
    return [rng.choice(targets) for _ in range(300)]


def test_seeded_plan_fires_as_jax():
    tplan = tchaos.FaultPlan.from_spec(_PLAN)
    jplan = jchaos.FaultPlan.from_spec(_PLAN)
    for i, (t, c, ep) in enumerate(_calls()):
        if i == 200:
            tplan.heal()
            jplan.heal()
        got = [f.kind for f in tplan.decide(t, c, ep)]
        assert got == [f.kind for f in jplan.decide(t, c, ep)], i
    assert tplan.fired == jplan.fired
    assert len(tplan.fired) > 20


def test_wire_hook_outputs_equal_jax():
    spec = {"seed": 2, "faults": [
        {"kind": "drop", "target": "send", "nth": [2]},
        {"kind": "corrupt", "target": "send", "p": 0.4}]}
    outs = {}
    for name, mod, cmd in (("torch", tchaos, tproto.Cmd.DATA),
                           ("jax", jchaos, jproto.Cmd.DATA)):
        mod.install(mod.FaultPlan.from_spec(spec))
        try:
            outs[name] = [mod._wire_hook("send", cmd, {}, bytes([i, 1, 2]))
                          for i in range(30)]
        finally:
            mod.uninstall()
    assert outs["torch"] == outs["jax"]
    assert None in outs["torch"]


_POISON_DTYPES = [np.float32, np.float16, np.float64, np.int32, np.uint8,
                  np.int64, np.int8, np.uint16, BF16]


@pytest.mark.parametrize("dtype", _POISON_DTYPES,
                         ids=lambda d: np.dtype(d).name)
def test_poison_values_equal_jax(dtype):
    base = (np.arange(12).reshape(3, 4) % 2).astype(dtype)
    jb = JBuffer.of(base.copy(), np.ones(2, np.float32))
    jchaos._poison_buffer(jb)
    want = np.asarray(jb.memories[0].host())
    # a host memory stays a host array
    tb = Buffer.of(base.copy(), np.ones(2, np.float32))
    tchaos._poison_buffer(tb)
    assert tb.memories[0]._device is None
    assert np.asarray(tb.memories[0].host()).tobytes() == want.tobytes()
    # a torch memory stays a torch tensor on its device
    t = TensorMemory(base.copy()).device("cpu")
    tb = Buffer([TensorMemory(t)])
    tchaos._poison_buffer(tb)
    mem = tb.memories[0]
    assert isinstance(mem._device, torch.Tensor) and mem._host is None
    assert mem._device.device.type == "cpu"
    assert np.asarray(mem.host()).tobytes() == want.tobytes()
    assert mem.info == tb.memories[0].info


def test_poison_of_a_bool_frame_equals_jax():
    """Neither package's TensorInfo names bool, so the frame rides in
    memories that carry their info as given: ones, as in JAX."""
    class Mem:
        is_device = False
        _device = None

        def __init__(self, arr):
            self.arr, self.info = arr, "info"

        def host(self):
            return self.arr

    base = np.array([[True, False, False]])
    jb, tb = JBuffer([Mem(base)]), Buffer([Mem(base)])
    jchaos._poison_buffer(jb)
    tchaos._poison_buffer(tb)
    want = np.asarray(jb.memories[0].host())
    assert want.dtype == np.bool_ and want.all()
    assert np.asarray(tb.memories[0].host()).tobytes() == want.tobytes()
    t = torch.zeros(3, dtype=torch.bool)
    assert torch.full_like(t, tchaos._poison_value(t.dtype)).numpy() \
        .tobytes() == np.ones(3, np.bool_).tobytes()


def test_chain_corrupt_poisons_a_cpu_filter_output():
    """The graph-side corrupt on a filter's torch output: the frames flow
    on, poisoned, as torch tensors."""
    plan = tchaos.FaultPlan([tchaos.Fault(kind="corrupt",
                                          target="chain:psink", nth=(2,))])
    tchaos.install(plan)
    try:
        p = Pipeline("poison", device="cpu")
        src = p.add_new("appsrc", caps=_caps("torch", "4:1", "float32"),
                        data=[np.full((1, 4), i, np.float32)
                              for i in range(3)])
        filt = p.add_new("tensor_filter", model=lambda x: x + 1)
        sink = p.add_new("tensor_sink", "psink", store=True)
        Pipeline.link(src, filt, sink)
        p.run(timeout=30)
    finally:
        tchaos.uninstall()
    outs = [b.memories[0] for b in sink.buffers]
    assert len(outs) == 3 and all(m._device is not None for m in outs)
    assert np.isnan(outs[1].host()).all()
    assert outs[2].host().tolist() == [[3.0] * 4]


# --------------------------------------------------------------------------- #
# Router parity
# --------------------------------------------------------------------------- #

_EPS = "127.0.0.1:9101,127.0.0.1:9102,127.0.0.1:9103,127.0.0.1:9104"


def _sets(seed, **kw):
    return (trouter.BackendSet(trouter.parse_endpoints(_EPS), owner="par",
                               rng=random.Random(seed), **kw),
            jrouter.BackendSet(jrouter.parse_endpoints(_EPS), owner="par",
                               rng=random.Random(seed), **kw))


def test_two_choice_picks_equal_jax():
    ts, js = _sets(21)
    loads = [(0, None), (3, 0.01), (1, 0.2), (0, 0.05)]
    for bs in (ts, js):
        for be, (inflight, ewma) in zip(bs.backends(), loads):
            be.inflight, be.ewma_s = inflight, ewma
    tp = [ts.pick().endpoint for _ in range(200)]
    jp = [js.pick().endpoint for _ in range(200)]
    assert tp == jp
    assert len(set(tp)) > 1
    excl = frozenset({"127.0.0.1:9101"})
    assert [ts.pick(exclude=excl).endpoint for _ in range(50)] \
        == [js.pick(exclude=excl).endpoint for _ in range(50)]


def test_ring_placement_and_spill_equal_jax():
    ts, js = _sets(3, breaker_threshold=1)
    sessions = [f"user-{i}" for i in range(300)]
    assert [ts.pick(session=s).endpoint for s in sessions] \
        == [js.pick(session=s).endpoint for s in sessions]
    assert ts._ring == js._ring
    # the home of a third of the sessions dies: they spill the same way
    for bs in (ts, js):
        bs.get("127.0.0.1:9102").breaker.record_failure()
    assert [ts.pick(session=s).endpoint for s in sessions] \
        == [js.pick(session=s).endpoint for s in sessions]
    # a live add remaps the same sessions
    ts.add("127.0.0.1:9105")
    js.add("127.0.0.1:9105")
    assert [ts.pick(session=s).endpoint for s in sessions] \
        == [js.pick(session=s).endpoint for s in sessions]


def _routed_dispatches(pkg, ports, frames, sessions):
    mod = trouter if pkg == "torch" else jrouter
    proto = tproto if pkg == "torch" else jproto
    buf_cls = Buffer if pkg == "torch" else JBuffer
    bs = mod.BackendSet(mod.parse_endpoints(
        ",".join(f"127.0.0.1:{p}" for p in ports)), owner=f"slo-{pkg}",
        timeout_s=5.0, rng=random.Random(9))
    r = mod.QueryRouter(bs, f"slo-{pkg}")
    r.set_caps_provider(lambda: str(_caps(pkg, "4:2", "float32")))
    outs = []
    try:
        for x, sess in zip(frames, sessions):
            meta, payload = proto.buffer_to_payload(buf_cls.of(x))
            if sess is not None:
                meta["session"] = sess
            rmeta, rpayload = r.dispatch(meta, payload, session=sess)
            outs.append(proto.payload_to_buffer(rmeta, rpayload)
                        .memories[0].host().tobytes())
    finally:
        r.close()
    return outs


def test_router_slo_hook_counts_equal_jax():
    from nnstreamer_tpu.obs import slo as jslo
    from nnstreamer_tpu_torch.obs import slo as tslo

    rng = np.random.default_rng(12)
    frames = [rng.standard_normal((2, 4)).astype(np.float32)
              for _ in range(9)]
    sessions = ["cam", "cam", None, "lm", "cam", "anon-1", None, "lm", "cam"]
    snaps, outs = {}, {}
    for pkg, slo_mod in (("torch", tslo), ("jax", jslo)):
        reg = slo_mod.enable()
        reg.set_objective("cam", goodput_ratio=0.9)
        reg.set_objective("lm", p99_ms=100.0)
        servers = [_server(pkg, 80 + i, scale=True) for i in range(2)]
        try:
            outs[pkg] = _routed_dispatches(pkg, [p for _, p in servers],
                                           frames, sessions)
        finally:
            for sp, _ in servers:
                sp.stop()
        snaps[pkg] = {t: (row["bytes_tx"], row["bytes_rx"])
                      for t, row in slo_mod.snapshot()["tenants"].items()}
        slo_mod.disable()
    assert outs["torch"] == outs["jax"]
    assert outs["torch"] == [(x * 2).tobytes() for x in frames]
    assert snaps["torch"] == snaps["jax"]
    assert snaps["torch"]["cam"][0] > 0 and snaps["torch"]["_other"][0] > 0


def test_diag_bundle_routing_stanza_is_the_live_view(tmp_path):
    from nnstreamer_tpu_torch.graph import element as gel
    from nnstreamer_tpu_torch.obs import diag

    eps = [f"127.0.0.1:{_free_port()}" for _ in range(2)]
    qc = gel.make_element("tensor_query_client", "routed-diag",
                          backends=",".join(eps))
    qc.start()
    deng = diag.enable(str(tmp_path / "bundles"))
    try:
        bid = deng.bundles.capture({"kind": "manual", "key": "routing"})
        doc = deng.bundles.get(bid)
        live = qc.router.snapshot()
    finally:
        diag.disable()
        qc.stop()
    views = [v for v in doc["routing"] if v["name"] == "routed-diag"]
    assert views == [live]
    assert [b["endpoint"] for b in live["backends"]] == eps
    assert all(b["breaker"] == "closed" and b["state"] == "active"
               for b in live["backends"])


# --------------------------------------------------------------------------- #
# The CLI's query flags
# --------------------------------------------------------------------------- #

_BAD_ARGS = [
    ["--hedge-ms", "5"],
    ["--backends", "a:1", "--hedge-ms", "5"],
    ["--backends", "a:1,b:2", "--hedge-ms", "0"],
    ["--backends", "justahost"],
    ["--backends", "a:1,a:1"],
    ["--deadline-ms", "50"],
    ["--fallback", "passthrough"],
]


@pytest.mark.parametrize("extra", _BAD_ARGS, ids=lambda a: " ".join(a))
def test_cli_refuses_bad_query_flags_as_jax(extra, capsys):
    from nnstreamer_tpu.cli import main as jmain
    from nnstreamer_tpu_torch.cli import main as tmain

    pipeline = "videotestsrc num-buffers=1 ! tensor_sink"
    errs = {}
    for name, main, args in (("torch", tmain, ["--device", "cpu"]),
                             ("jax", jmain, [])):
        with pytest.raises(SystemExit) as e:
            main(args + extra + [pipeline])
        assert e.value.code == 2
        errs[name] = [ln for ln in capsys.readouterr().err.splitlines()
                      if "error:" in ln][-1].split("error:", 1)[1]
    assert errs["torch"] == errs["jax"]


def test_cli_routes_with_every_query_flag_and_a_fault_plan(
        monkeypatch, capsys):
    """--backends A,B --hedge-ms --deadline-ms --fallback passthrough with a
    one-fault NNS_TPU_CHAOS plan: exit 0, the chaos line, every frame
    back through the router and equal to the servers' result."""
    from nnstreamer_tpu_torch.cli import main
    from nnstreamer_tpu_torch.graph import parse as parse_mod

    servers = [_server("torch", 90 + i, scale=True, dims="3:4:2:1")
               for i in range(2)]
    seen = {}
    parse = parse_mod.parse_pipeline

    def parsing(*a, **kw):
        seen["p"] = parse(*a, **kw)
        return seen["p"]

    monkeypatch.setattr(parse_mod, "parse_pipeline", parsing)
    monkeypatch.setenv("NNS_TPU_CHAOS", '{"seed": 3, "faults": [{"kind": '
                       '"drop", "target": "chain:out", "nth": 2}]}')
    backends = ",".join(f"127.0.0.1:{p}" for _, p in servers)
    try:
        rc = main(["--device", "cpu", "--backends", backends, "--hedge-ms",
                   "5", "--deadline-ms", "2000", "--fallback", "passthrough",
                   "videotestsrc num-buffers=4 width=4 height=2 "
                   "pattern=random ! tensor_converter ! tensor_transform "
                   "mode=typecast option=float32 ! tensor_query_client "
                   "name=q ! tensor_sink name=out store=true"])
    finally:
        for sp, _ in servers:
            sp.stop()
    err = capsys.readouterr().err
    assert rc == 0, err
    assert "chaos: fault plan installed (seed=3, 1 faults)" in err
    assert tchaos.active() is None  # the CLI left no plan behind
    p = seen["p"]
    qc, sink = p.elements["q"], p.elements["out"]
    assert qc.deadline_ms == 2000.0 and qc.fallback == "passthrough"
    assert qc.hedge_ms == 5.0 and len(qc.backends) == 2
    assert sink.num_buffers == 3  # the plan dropped the 2nd at the sink
    for b in sink.buffers:
        out = b.memories[0].host()
        # the servers' x * 2 of uint8 pixels: even values in [0, 510]
        assert out.shape == (1, 2, 4, 3) and out.dtype == np.float32
        assert (out % 2 == 0).all() and out.max() <= 510
