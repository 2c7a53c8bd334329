"""The traced run's instruments, all in the benchmark's own files:

* ``ChainSpans`` wraps each element's chain entry of the cell's pipelines
  and keeps, by element, the calls and the self time (the chain's time less
  the downstream chains it calls on the same thread) while ``on``, and
  while the profiler runs (``recording``) each call's range on the clock of
  the profiler's timeline;
* ``DeviceTrace`` runs ``torch.profiler`` over a part of the window and
  reduces its timeline: the union of the device's operation intervals
  (busy seconds), each kernel's calls and seconds, and the idle gaps,
  each labelled by the element chain that was open, innermost, on the host
  at the gap's middle.
"""

from __future__ import annotations

import bisect
import collections
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

#: idle gaps shorter than this are summed under one label, not attributed
LABEL_MIN_NS = 20_000


class ChainSpans:
    def __init__(self) -> None:
        self.self_ns: Dict[str, int] = collections.Counter()
        self.calls: Dict[str, int] = collections.Counter()
        self._tls = threading.local()
        self._lock = threading.Lock()
        self.on = False
        #: (start, end, element) in epoch ns while ``recording``
        self.ranges: List[Tuple[int, int, str]] = []
        self.recording = False
        self._epoch = time.time_ns() - time.perf_counter_ns()

    def wrap(self, element) -> None:
        kind = getattr(element, "ELEMENT_NAME", type(element).__name__)
        orig = element._chain_entry
        spans = self

        def timed(pad, buf):
            if not (spans.on or spans.recording):
                return orig(pad, buf)
            stack = getattr(spans._tls, "stack", None)
            if stack is None:
                stack = spans._tls.stack = []
            stack.append(0)
            t0 = time.perf_counter_ns()
            try:
                return orig(pad, buf)
            finally:
                t1 = time.perf_counter_ns()
                dt = t1 - t0
                child = stack.pop()
                if stack:
                    stack[-1] += dt
                with spans._lock:
                    if spans.on:
                        spans.self_ns[kind] += dt - child
                        spans.calls[kind] += 1
                    if spans.recording:
                        spans.ranges.append((t0 + spans._epoch, t1 + spans._epoch, kind))

        element._chain_entry = timed

    def ms_per_call(self, kind: str) -> Optional[float]:
        n = self.calls.get(kind, 0)
        return self.self_ns[kind] / n / 1e6 if n else None


class DeviceTrace:
    def __init__(self, spans: ChainSpans) -> None:
        self.spans = spans
        self.prof = None
        self.t0_ns = self.t1_ns = 0
        self.summary: Optional[dict] = None

    @staticmethod
    def _profile():
        from torch.profiler import ProfilerActivity, profile

        # the device's timeline only: the host's side is the benchmark's own
        # spans, and the profiler's host callbacks on every pipeline thread
        # slow the run
        acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else [ProfilerActivity.CPU]
        return profile(activities=acts)

    def warm_up(self) -> None:
        """Start and stop the profiler once around a small operation: the
        process's first start initialises the device's tracing, which
        holds every thread of the process for seconds."""
        prof = self._profile()
        prof.start()
        torch.ones(1, device="cuda" if torch.cuda.is_available() else "cpu").add_(1)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()

    def start(self) -> None:
        t = time.perf_counter()
        self.prof = self._profile()
        self.prof.start()
        self.start_s = time.perf_counter() - t
        self.t0_ns = time.time_ns()
        self.spans.recording = True

    def close(self) -> None:
        """End the traced interval; the profiler runs on until ``stop``."""
        self.t1_ns = time.time_ns()
        self.spans.recording = False

    def stop(self) -> None:
        """Stop the profiler. Call it with no thread launching work on the
        card: stopping it while another thread replays a CUDA graph
        deadlocked or crashed the process (the engine cells)."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()

    def reduce(self) -> dict:
        """busy and window seconds, kernels by name, and idle gaps by the
        host's open element chain."""
        if self.summary is not None:
            return self.summary
        events = self.prof.profiler.kineto_results.events()
        dev: List[Tuple[int, int]] = []
        kernels: Dict[str, List[float]] = {}
        ranges = list(self.spans.ranges)
        cuda = torch.autograd.DeviceType.CUDA
        lo, hi = self.t0_ns, self.t1_ns
        for e in events:
            start, dur = e.start_ns(), e.duration_ns()
            if e.device_type() == cuda and start < hi and start + dur > lo:
                dev.append((start, start + dur))
                k = kernels.setdefault(e.name(), [0, 0.0])
                k[0] += 1
                k[1] += dur / 1e9
        merged: List[List[int]] = []
        for a, b in sorted(dev):
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        busy = sum(b - a for a, b in merged)
        gaps, prev = [], lo
        for a, b in merged:
            if a > prev:
                gaps.append((prev, a))
            prev = b
        if hi > prev:
            gaps.append((prev, hi))
        ranges.sort()
        starts = [r[0] for r in ranges]
        idle: Dict[str, float] = collections.Counter()
        for a, b in gaps:
            if b - a < LABEL_MIN_NS:
                idle["gaps under 20 us"] += (b - a) / 1e9
                continue
            mid = (a + b) // 2
            i = bisect.bisect_right(starts, mid)
            label = "no element chain open"
            # the innermost open range: the latest start that still covers mid
            for j in range(i - 1, max(i - 4096, -1), -1):
                if ranges[j][1] >= mid:
                    label = ranges[j][2]
                    break
            idle[label] += (b - a) / 1e9
        self.summary = {
            "start_s": getattr(self, "start_s", 0.0),
            "busy_s": busy / 1e9, "window_s": (hi - lo) / 1e9, "kernels": kernels,
            "device_ops": sorted(([n[:120], v[1]] for n, v in kernels.items()),
                                 key=lambda x: -x[1])[:10],
            "idle_gaps": sorted(([k, v] for k, v in idle.items()), key=lambda x: -x[1])[:10]}
        return self.summary

    def kernel(self, *needles: str) -> Tuple[int, float]:
        """Calls and seconds of the kernels whose name holds any needle."""
        calls, secs = 0, 0.0
        for name, (n, s) in self.reduce()["kernels"].items():
            if any(x in name for x in needles):
                calls += n
                secs += s
        return calls, secs
