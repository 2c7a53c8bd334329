"""The one traffic generator. A mix file (``benchmark/traffic/<mix>.json``)
gives its parameters; this module drives the streams:

* ``"loop": "open"`` — every stream is a camera: frames fall due at
  ``fps`` on the stream's own clock, the streams' phases spread evenly
  over the period and dealt out to them by the seed, and one
  generator thread pushes each frame at its due time whatever the system
  does. A frame's latency runs from its due time to its result at the
  sink; how late the push ran behind the due time is the generator's lag.
* ``"loop": "closed"`` — every stream keeps ``outstanding`` frames in the
  pipeline: its next frame is pushed when its sink returns one. Latency
  runs from the push to the result.

Frames come from a pool made at set-up and cycled, each stream from its own
offset, so nothing is made inside the window. Every push is recorded
before it is made, so the sink's callback always finds it.
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np


class Stream:
    """One pipeline's feed and its records, indexed by sequence number (the
    appsrc's buffer offset)."""

    def __init__(self, index: int, push: Callable, pool: np.ndarray, offset: int) -> None:
        self.index = index
        self._push = push
        self.pool = pool
        self.offset = offset
        self.seq = 0
        #: the sequence number of the stream's first frame on the open loop's clock
        self.first_open: Optional[int] = None
        self.due: List[float] = []
        self.pushed: List[float] = []
        self.arrived: Dict[int, float] = {}

    def pool_index(self, seq: int) -> int:
        return (self.offset + seq) % len(self.pool)

    def push(self, due: float) -> int:
        seq = self.seq
        self.seq += 1
        self.due.append(due)
        self.pushed.append(time.perf_counter())
        self._push(self.pool[self.pool_index(seq)])
        return seq


class Driver:
    """Drives ``streams`` as the mix says. ``run(until)`` returns when the
    clock passes ``until`` (perf_counter seconds); ``on_result`` is to be
    called from each sink's callback with (stream, seq)."""

    def __init__(self, mix: dict, streams: List[Stream], rng: np.random.Generator) -> None:
        self.mix = mix
        self.streams = streams
        self.open = mix["loop"] == "open"
        self.active = False
        self._lock = threading.Lock()
        if self.open:
            self.period = 1.0 / float(mix["fps"])
            n = len(streams)
            # the same arrivals for every seed, the seed deals them out
            self.phase = rng.permutation(n) * self.period / n
        self.t0: Optional[float] = None

    # -- closed loop ---------------------------------------------------------- #
    def on_result(self, stream: Stream, seq: int) -> None:
        t = time.perf_counter()
        with self._lock:
            stream.arrived[seq] = t
            if not self.open and self.active:
                stream.push(time.perf_counter())

    def start(self) -> None:
        """Begin the traffic: a closed loop fills every stream's
        outstanding frames; an open loop fixes its clock."""
        self.t0 = time.perf_counter()
        self.active = True
        if not self.open:
            with self._lock:
                for s in self.streams:
                    for _ in range(int(self.mix["outstanding"])):
                        s.push(time.perf_counter())

    def run(self, until: float) -> None:
        """Generate until ``until``; an open loop pushes each frame due
        before it at its due time. A closed loop only waits."""
        if not self.open:
            while time.perf_counter() < until:
                time.sleep(min(0.05, max(until - time.perf_counter(), 0.0)))
            return
        heap = []
        for s in self.streams:
            if s.first_open is None:
                s.first_open = s.seq
            k = s.seq - s.first_open
            heap.append((self.t0 + self.phase[s.index] + k * self.period, s.index))
        heapq.heapify(heap)
        while self.active:
            due, i = heap[0]
            if due >= until:
                break
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            self.streams[i].push(due)
            heapq.heapreplace(heap, (due + self.period, i))

    def stop(self) -> None:
        self.active = False

    def outstanding(self) -> int:
        with self._lock:
            return sum(s.seq - len(s.arrived) for s in self.streams)


def window_records(streams: List[Stream], open_loop: bool, window,
                   plain_until: Optional[float] = None) -> dict:
    """Every frame of the window ``(w0, w1)``: its latency (from its due
    time, or its push in a closed loop, to its result), the generator's lag
    (open loop), the frames done in the window, those due or pushed in it,
    and those of them without a result; and the frames done in the window's
    first part, up to ``plain_until``, where no instrument was on."""
    w0, w1 = window
    plain_until = w1 if plain_until is None else plain_until
    lat, lag, done, attempted, failed, plain = [], [], 0, 0, 0, 0
    for s in streams:
        starts = s.due if open_loop else s.pushed
        for seq, t in enumerate(starts):
            arr = s.arrived.get(seq)
            if arr is not None and w0 <= arr < w1:
                done += 1
                plain += arr < plain_until
            if not w0 <= t < w1:
                continue
            attempted += 1
            if open_loop:
                lag.append(s.pushed[seq] - s.due[seq])
            if arr is None:
                failed += 1
            else:
                lat.append(arr - t)
    return {"latency_s": lat, "lag_s": lag, "done": done, "attempted": attempted,
            "failed": failed, "seconds": w1 - w0, "plain_done": plain,
            "plain_seconds": plain_until - w0}
