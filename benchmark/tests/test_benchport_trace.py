"""The traced run's reductions: self time of nested chains, the union of
the device's intervals, and the idle gaps by the open chain."""

import time

from benchmark.harness.trace import ChainSpans, DeviceTrace


class _El:
    def __init__(self, name, work_s, nxt=None):
        self.ELEMENT_NAME = name
        self.work_s, self.nxt = work_s, nxt

    def _chain_entry(self, pad, buf):
        time.sleep(self.work_s)
        if self.nxt is not None:
            self.nxt._chain_entry(pad, buf)


def test_chain_self_time_leaves_out_the_downstream_chains():
    sink = _El("tensor_sink", 0.005)
    dec = _El("tensor_decoder", 0.010, sink)
    filt = _El("tensor_filter", 0.020, dec)
    spans = ChainSpans()
    for el in (sink, dec, filt):
        spans.wrap(el)
    spans.on = True
    for _ in range(5):
        filt._chain_entry(None, None)
    assert spans.calls["tensor_filter"] == spans.calls["tensor_decoder"] == 5
    # each below its own sleep plus the sleeps downstream of it
    assert 19.5 < spans.ms_per_call("tensor_filter") < 32.0
    assert 9.5 < spans.ms_per_call("tensor_decoder") < 14.5
    assert 4.5 < spans.ms_per_call("tensor_sink") < 9.5


class _Ev:
    def __init__(self, name, start, dur):
        self._n, self._s, self._d = name, start, dur

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        import torch
        return torch.autograd.DeviceType.CUDA


class _Results:
    def __init__(self, events):
        self._e = events

    def events(self):
        return self._e


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": _Results(events)})()


def test_busy_is_the_union_of_device_intervals_and_gaps_are_labelled():
    spans = ChainSpans()
    tr = DeviceTrace(spans)
    tr.t0_ns, tr.t1_ns = 1_000_000, 2_000_000
    tr.prof = _Prof([
        _Ev("k_a", 1_000_000, 200_000),      # [1.0, 1.2] ms
        _Ev("k_b", 1_100_000, 200_000),      # overlaps: union [1.0, 1.3]
        _Ev("k_a", 1_500_000, 100_000),      # [1.5, 1.6]
        _Ev("k_c", 1_600_005, 10),           # a gap of 5 ns
        _Ev("k_c", 1_950_000, 100_000),      # clipped at the window's end
    ])
    spans.ranges = [(1_250_000, 1_550_000, "tensor_filter"),
                    (1_350_000, 1_450_000, "tensor_decoder")]
    s = tr.reduce()
    assert s["busy_s"] * 1e9 == 300_000 + 100_000 + 10 + 50_000
    assert s["window_s"] == 0.001
    gaps = dict(s["idle_gaps"])
    # [1.3, 1.5]: its middle 1.4 lies inside the decoder's range, the innermost
    assert abs(gaps["tensor_decoder"] - 200e-6) < 1e-12
    assert abs(gaps["no element chain open"] - 349_985e-9) < 1e-15
    assert abs(gaps["gaps under 20 us"] - 5e-9) < 1e-15
    calls, secs = tr.kernel("k_a")
    assert calls == 2 and abs(secs - 300e-6) < 1e-15
    ops = dict(s["device_ops"])
    assert abs(ops["k_b"] - 200e-6) < 1e-15
