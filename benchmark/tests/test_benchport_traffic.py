"""The camera clock, the closed loop and the window's records."""

import threading
import time

import numpy as np

from benchmark.harness.driver import Driver, Stream, window_records
from benchmark.harness.stats import percentile


def _streams(n, sink=None):
    pool = np.arange(8).reshape(8, 1)
    out = []
    for i in range(n):
        out.append(Stream(i, (sink or (lambda f: None)), pool, offset=i))
    return out


def test_camera_clock_pushes_each_frame_at_its_due_time():
    streams = _streams(3)
    d = Driver({"loop": "open", "fps": 50}, streams, np.random.default_rng(5))
    d.start()
    d.run(d.t0 + 0.51)
    for s in streams:
        due = np.asarray(s.due)
        assert len(due) == int((0.51 - d.phase[s.index]) / 0.02) + 1
        assert np.allclose(np.diff(due), 0.02)
        assert d.t0 <= due[0] < d.t0 + 0.02
        assert (np.asarray(s.pushed) >= due).all()
    # one phase a stream, dealt out by the seed
    assert len({round(s.due[0] - d.t0, 9) for s in streams}) == 3
    d2 = Driver({"loop": "open", "fps": 50}, _streams(3), np.random.default_rng(5))
    assert np.array_equal(d.phase, d2.phase)


def test_even_phases_are_one_set_of_arrivals_for_every_seed():
    mix = {"loop": "open", "fps": 50}
    got = [Driver(mix, _streams(4), np.random.default_rng(seed)).phase for seed in (1, 2, 2 ** 31 + 7)]
    for p in got:
        assert np.allclose(np.sort(p), np.arange(4) * 0.02 / 4)
    # dealt out to the cameras in another order by another seed
    assert any(not np.array_equal(got[0], p) for p in got[1:])


def test_camera_clock_continues_across_runs():
    streams = _streams(1)
    d = Driver({"loop": "open", "fps": 100}, streams, np.random.default_rng(1))
    d.start()
    d.run(d.t0 + 0.1)
    d.run(d.t0 + 0.2)
    assert np.allclose(np.diff(streams[0].due), 0.01)
    assert len(streams[0].due) == 20


def test_closed_loop_keeps_its_frames_outstanding():
    pending = []
    lock = threading.Lock()

    def push(frame):
        with lock:
            pending.append(frame)

    streams = _streams(2, push)
    d = Driver({"loop": "closed", "outstanding": 4}, streams, np.random.default_rng(0))
    d.start()
    assert [s.seq for s in streams] == [4, 4]
    for _ in range(10):  # the "system" answers each stream's oldest frame
        for s in streams:
            d.on_result(s, len(s.arrived))
        assert d.outstanding() == 8
    d.stop()
    d.on_result(streams[0], len(streams[0].arrived))
    assert d.outstanding() == 7  # no push once stopped
    assert [s.pool_index(0) for s in streams] == [0, 1]


def test_window_records_take_every_frame_and_its_stall():
    s = _streams(1)[0]
    w0, w1 = 10.0, 20.0
    for k in range(100):
        due = 9.0 + k * 0.12
        s.due.append(due)
        s.pushed.append(due + 0.001)
        s.seq += 1
        lat = 0.010 if k != 50 else 2.0  # one stall
        if k < 95:
            s.arrived[k] = due + lat
    rec = window_records([s], True, (w0, w1))
    inside = [k for k in range(100) if w0 <= 9.0 + k * 0.12 < w1]
    assert rec["attempted"] == len(inside)
    assert rec["failed"] == len([k for k in inside if k >= 95])
    assert len(rec["latency_s"]) == rec["attempted"] - rec["failed"]
    assert abs(max(rec["latency_s"]) - 2.0) < 1e-9
    assert np.allclose(rec["lag_s"], 0.001)
    assert rec["done"] == sum(1 for k, t in s.arrived.items() if w0 <= t < w1)
    # the tail is the tail of all frames, the stall in it
    lat = rec["latency_s"]
    assert abs(percentile(lat, 100) - 2.0) < 1e-9
    assert abs(percentile(lat, 50) - 0.010) < 1e-9
    big = [0.010] * 19 + [2.0]
    assert percentile(big, 95) > 0.010
