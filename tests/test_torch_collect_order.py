"""The port's N-input elements push their sets in order and EOS after them.

``CollectingElement`` (tensor_mux, tensor_merge, tensor_crop) takes its
sets out of ``CollectPads`` on whichever pad's thread completed them. A set
taken out a moment before another pad's EOS arrives must still reach the
sink before that EOS, and sets must leave in the order they were
collected. These cases widen that window on purpose: the collector's
``push`` sleeps after handing out the last set while the other pad's EOS
is delivered from a second thread. Without the element's ordered outbox
the EOS overtakes the set and the sink drops it (``FlowReturn.EOS``).

A pad's thread must also never wait for another pad's downstream push: a
set completed while another thread is blocked downstream is left to that
thread, and the call returns at once (the repo loop's state pad behind a
full ``queue``). What is left so stays bounded: under ``sync_mode=refresh``
every arrival makes a set, and a pad that outruns a blocked drainer waits
once the outbox holds more than one set per pad.
"""

import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from nnstreamer_tpu_torch import core as tcore  # noqa: E402
from nnstreamer_tpu_torch import graph as tgraph  # noqa: E402

MS = 1_000_000
N_SETS = 3
WINDOW_S = 0.3
IMG = np.arange(16 * 20 * 3, dtype=np.uint8).reshape(1, 16, 20, 3)


def caps(dims, types):
    return tcore.Caps.tensors(tcore.TensorsConfig(
        tcore.TensorsInfo.from_strings(dims, types), 30))


FLEX = tcore.Caps.tensors(tcore.TensorsConfig(
    tcore.TensorsInfo((), tcore.TensorFormat.FLEXIBLE), 30))


def frames(kind, pad, i):
    """Pad ``pad``'s ``i``-th buffer for ``kind``, stamped ``i`` × 33 ms."""
    if kind == "tensor_crop":
        arr = IMG if pad == 0 else np.asarray([[i, i, 4, 4]], np.int32)
    else:
        arr = np.full(2, 10 * pad + i, np.float32)
    return tcore.Buffer.from_arrays([arr], pts=i * 33 * MS, duration=33 * MS)


KINDS = {
    "tensor_mux": ({"sync_mode": "nosync"}, [caps("2", "float32")] * 2),
    "tensor_merge": ({"mode": "linear", "option": "0", "sync_mode": "nosync"},
                     [caps("2", "float32")] * 2),
    "tensor_crop": ({}, [caps("3:20:16:1", "uint8"), FLEX]),
}


def build(kind, sink_chain=None, props=None):
    """``kind`` (its ``KINDS`` props, or ``props``) with two feeder elements
    and a storing sink that logs each buffer's PTS and the EOS in arrival
    order."""
    kind_props, pad_caps = KINDS[kind]
    props = kind_props if props is None else props
    el = tgraph.make_element(kind, **props)
    sink = tgraph.make_element("tensor_sink", store=True)
    feeders = []
    for i in range(2):
        f = tgraph.Element(f"feed{i}")
        f.add_src_pad()
        f.src_pad.link(el.free_sink_pad())
        feeders.append(f)
    el.free_src_pad().link(sink.sink_pad)
    log = []
    chain = sink.chain

    def logged_chain(pad, buf):
        if sink_chain is not None:
            sink_chain(buf)
        log.append(buf.pts)
        return chain(pad, buf)

    sink.chain = logged_chain
    sink.on_eos = lambda: log.append("eos")
    sink.start()
    el.start()
    for f, c in zip(feeders, pad_caps):
        f.send_caps(c)
    return el, feeders, sink, log


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_eos_never_overtakes_a_set_handed_out_before_it(kind):
    el, feeders, sink, log = build(kind)
    for i in range(N_SETS - 1):
        feeders[0].push(frames(kind, 0, i))
        feeders[1].push(frames(kind, 1, i))
    feeders[1].push(frames(kind, 1, N_SETS - 1))

    handed_out = threading.Event()
    collect_push = el._collect.push

    def slow_push(key, buf):
        out = collect_push(key, buf)
        if out:
            handed_out.set()
            time.sleep(WINDOW_S)  # pad 1's EOS is delivered meanwhile
        return out

    el._collect.push = slow_push
    last = threading.Thread(target=feeders[0].push,
                            args=(frames(kind, 0, N_SETS - 1),))
    last.start()
    assert handed_out.wait(10)
    feeders[1].push_event_all(tgraph.Event.eos())
    last.join(10)
    assert not last.is_alive()
    feeders[0].push_event_all(tgraph.Event.eos())

    want = [i * 33 * MS for i in range(N_SETS)] + ["eos"]
    assert log == want, f"{kind}: sink saw {log}"
    assert sink.num_buffers == N_SETS


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_a_pad_never_waits_for_another_pads_push(kind):
    """Set 0 blocks downstream on one thread; set 1, completed on another,
    is left to that thread: its call returns while the sink is still
    blocked, and both sets then arrive in order."""
    release = threading.Event()
    entered = threading.Event()

    def blocking(buf):
        if buf.pts == 0:
            entered.set()
            release.wait(10)

    el, feeders, sink, log = build(kind, sink_chain=blocking)
    feeders[0].push(frames(kind, 0, 0))
    first = threading.Thread(target=feeders[1].push, args=(frames(kind, 1, 0),))
    first.start()
    assert entered.wait(10)
    feeders[0].push(frames(kind, 0, 1))
    t0 = time.monotonic()
    feeders[1].push(frames(kind, 1, 1))
    returned_in = time.monotonic() - t0
    blocked_meanwhile = not release.is_set() and log == []
    release.set()
    first.join(10)
    assert not first.is_alive()
    assert returned_in < 5 and blocked_meanwhile
    for f in feeders:
        f.push_event_all(tgraph.Event.eos())
    assert log == [0, 33 * MS, "eos"], f"{kind}: sink saw {log}"


def test_refresh_outbox_stays_bounded_behind_a_blocked_sink():
    """Refresh mode makes a set on every arrival. While set 0 is blocked
    downstream, pad 1's thread pushes 20 more: it is held back once the
    outbox is over one set per pad (2), and every set then arrives in
    order."""
    n = 20
    release = threading.Event()
    entered = threading.Event()

    def blocking(buf):
        if buf.pts == 0:
            entered.set()
            release.wait(10)

    el, feeders, sink, log = build("tensor_mux", sink_chain=blocking,
                                   props={"sync_mode": "refresh"})
    feeders[1].push(frames("tensor_mux", 1, 0))  # no set: pad 0 has none yet
    first = threading.Thread(target=feeders[0].push,
                             args=(frames("tensor_mux", 0, 0),))
    first.start()
    assert entered.wait(10)
    rest = threading.Thread(target=lambda: [
        feeders[1].push(frames("tensor_mux", 1, i)) for i in range(1, n + 1)])
    rest.start()
    longest = 0
    deadline = time.monotonic() + 1.0
    while time.monotonic() < deadline:
        longest = max(longest, len(el._outbox))
        time.sleep(0.001)
    held_back = rest.is_alive() and log == []
    release.set()
    first.join(10)
    rest.join(10)
    assert not first.is_alive() and not rest.is_alive()
    # one set per pad, and the one a held-back thread has just added
    assert held_back and longest <= len(el.sink_pads) + 1, longest
    for f in feeders:
        f.push_event_all(tgraph.Event.eos())
    assert log == [i * 33 * MS for i in range(n + 1)] + ["eos"], log
