"""One run of one cell: set-up, warm-up, the measured window, the check of
what the window produced against the plain reference, and the result line.

The cell's pipelines are the configuration's launch string, one a stream,
built by the program's parser and fed through ``appsrc``'s
``push_buffer``; results are taken at ``tensor_sink``'s ``new-data``
callback. An engine cell enrols every pipeline on one
``sched.DeviceEngine``, as ``nns-launch --sched`` does.
"""

from __future__ import annotations

import gc
import json
import shutil
import sys
import tempfile
import threading
import time
from fractions import Fraction
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import guard
from .driver import Driver, Stream, window_records
from .manifest import Manifest, read_metrics
from .trace import ChainSpans, DeviceTrace

#: seconds to wait past the window's close for a frame still in the system
DRAIN_S = 60.0
#: frames each stream runs before the traffic starts (captures, builds)
PRIME_FRAMES = 2
#: frames of the pool (cycled), made at set-up
POOL = 64
#: seconds a traced run profiles, at the end of its window
TRACE_S = 2.0
#: seconds the first frames may take (a checkout's first run builds kernels)
FIRST_TIMEOUT_S = 1200.0


class NoCard(RuntimeError):
    pass


def check_card(chips: int) -> str:
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"{torch.cuda.device_count()} cards, the cell asks for {chips}")
    return torch.cuda.get_device_name(0)


def make_pool(shape, seed: int, device) -> np.ndarray:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 2)
    return torch.randint(0, 256, (POOL,) + tuple(shape), generator=gen, device=device,
                         dtype=torch.uint8).cpu().numpy()


def _caps(h: int, w: int):
    from nnstreamer_tpu_torch.core.types import Caps

    return Caps("video/x-raw", {"format": "RGB", "width": w, "height": h,
                                "framerate": Fraction(30)})


class Cell:
    """A cell set up for one run. ``device`` is the card, or the CPU in the
    harness's own tests (which skip ``check_card``)."""

    def __init__(self, manifest: Manifest, name: str, seed: int, device,
                 streams: Optional[int] = None, config: Optional[dict] = None) -> None:
        self.manifest, self.name, self.seed, self.device = manifest, name, seed, device
        self.wl = manifest.workload(name)
        self.cfg = config or manifest.config(self.wl["config"])
        self.mix = manifest.traffic(self.wl["traffic"])
        self.maker = manifest.maker(self.wl["config"])
        self.n = int(streams or self.wl["streams"])
        self.workdir = tempfile.mkdtemp(prefix="nnsbench-")
        self.state: Dict[str, Any] = {}
        self.pipelines: List[Any] = []
        self.engine = None
        self.spans = ChainSpans()
        self.tracer: Optional[DeviceTrace] = None
        self.captured: Dict[tuple, dict] = {}
        self.stride = 1

    # -- set-up ---------------------------------------------------------------- #
    def build(self) -> None:
        from nnstreamer_tpu_torch.graph import Pipeline
        from nnstreamer_tpu_torch.graph.parse import parse_pipeline

        self.state = self.maker.build(self.cfg, self.seed, self.workdir, self.device)
        size = int(self.cfg["input_size"])
        frame = self.mix.get("frame")
        scaled = frame is not None
        h, w = (frame[0], frame[1]) if scaled else (size, size)
        self.pool = make_pool((h, w, 3), self.seed, self.device)
        scale = f"videoscale width={size} height={size} ! " if scaled else ""
        launch = self.cfg["launch"].format(scale=scale, size=size, **self.state["vars"])
        if self.wl.get("engine"):
            from nnstreamer_tpu_torch.sched import DeviceEngine

            self.engine = DeviceEngine("bench", max_coalesce=int(self.wl["max_coalesce"]))
        rng = np.random.default_rng(self.seed)
        offsets = rng.integers(0, POOL, self.n)
        self.streams: List[Stream] = []
        dev = None if torch.device(self.device).type == "cuda" else "cpu"
        for i in range(self.n):
            p = parse_pipeline(launch, Pipeline(f"{self.name}.{i}", scheduler=self.engine,
                                                device=dev))
            src, sink = p.get_by_name("src"), p.get_by_name("sink")
            src.caps = _caps(h, w)
            stream = Stream(i, src.push_buffer, self.pool, int(offsets[i]))
            sink.new_data = self._on_data(stream)
            self.streams.append(stream)
            self.pipelines.append(p)
        self.driver = Driver(self.mix, self.streams, rng)
        self.window = (float("inf"), float("inf"))
        self.sample_phase = rng.integers(0, 1 << 30, self.n)
        for p in self.pipelines:
            p.start()

    def _on_data(self, stream: Stream):
        def cb(buf):
            seq = int(buf.offset)
            if seq % self.stride == self.sample_phase[stream.index] % self.stride:
                t = stream.due[seq] if self.driver.open else stream.pushed[seq]
                if self.window[0] <= t < self.window[1]:
                    self.captured[(stream.index, seq)] = self.maker.capture(buf)
            self.driver.on_result(stream, seq)
        return cb

    def _wait(self, pred, timeout: float, what: str) -> None:
        t_end = time.perf_counter() + timeout
        while not pred():
            if time.perf_counter() > t_end:
                raise TimeoutError(what)
            self._raise_pipeline_errors()
            time.sleep(0.01)

    def _raise_pipeline_errors(self) -> None:
        for p in self.pipelines:
            err = p.bus.error
            if err is not None:
                raise RuntimeError(f"pipeline {p.name}: {err.source}: {err.data.get('text')}")

    def warm(self, timeout: float, trace: bool = False) -> None:
        """Each stream's first frames (builds and captures), then the
        traffic itself for the mix's warm-up seconds. A traced run starts
        and stops the profiler once in between, while the pipelines are
        idle: its first start stalls the process for seconds."""
        for s in self.streams:
            for _ in range(PRIME_FRAMES):
                s.push(time.perf_counter())
        self._wait(lambda: all(len(s.arrived) == s.seq for s in self.streams), timeout,
                   "the first frames did not come back")
        if trace:
            self.tracer = DeviceTrace(self.spans)
            self.tracer.warm_up()
        self.driver.start()
        t = time.perf_counter() + float(self.mix["warm_s"])
        before = sum(len(s.arrived) for s in self.streams)
        t_start = time.perf_counter()
        self.driver.run(t)
        rate = (sum(len(s.arrived) for s in self.streams) - before) / max(
            time.perf_counter() - t_start, 1e-9)
        self.warm_rate = rate

    # -- the window ------------------------------------------------------------ #
    def measure(self, seconds: float, trace: bool) -> None:
        target = int(self.wl["sample"])
        expected = self.warm_rate * seconds
        self.stride = max(1, int(expected // max(target, 1)))
        tracer = None
        if trace:
            for p in self.pipelines:
                for el in p.elements.values():
                    self.spans.wrap(el)
            tracer = self.tracer or DeviceTrace(self.spans)
        t0 = time.perf_counter()
        self.window = (t0, t0 + seconds)
        self.plain_until = self.window[1]
        # the generator runs on its own thread: a push that waits on a full
        # pipeline delays the traffic (its lag counts), never the trace
        gen = threading.Thread(target=self.driver.run, args=(self.window[1],),
                               name="bench-generator", daemon=True)
        gen.start()
        if tracer is not None:
            # the window's first half runs with no instrument on (mfu reads
            # its rate); then the spans count self time; the profiler runs
            # over its last trace_s, the spans recording each chain's range
            trace_s = min(TRACE_S, seconds / 3)
            self.plain_until = t0 + seconds / 2
            time.sleep(max(self.plain_until - time.perf_counter(), 0.0))
            self.spans.on = True
            time.sleep(max(self.window[1] - trace_s - time.perf_counter(), 0.0))
            self.spans.on = False
            tracer.start()
            time.sleep(max(self.window[1] - time.perf_counter(), 0.0))
            tracer.close()
        gen.join(timeout=max(self.window[1] - time.perf_counter(), 0.0) + DRAIN_S)
        self.driver.stop()
        gen.join()
        self.tracer = tracer
        self.coalesce = self.engine.coalesce_stats() if self.engine is not None else None
        t_end = time.perf_counter() + DRAIN_S
        while self.driver.outstanding() and time.perf_counter() < t_end:
            time.sleep(0.01)
        if tracer is not None:
            tracer.stop()  # once every frame is in: nothing launches on the card

    def records(self) -> Dict[str, Any]:
        return window_records(self.streams, self.driver.open, self.window, self.plain_until)

    def stop(self) -> None:
        for p in self.pipelines:
            p.stop()
        if self.engine is not None:
            self.engine.stop()

    def free(self) -> None:
        self.pipelines.clear()
        self.engine = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    # -- the check ------------------------------------------------------------- #
    def model_frames(self, keys) -> np.ndarray:
        from benchmark.reference.resize import resize_rgb

        size = int(self.cfg["input_size"])
        out = []
        for stream, seq in keys:
            frame = self.pool[self.streams[stream].pool_index(seq)]
            if frame.shape[:2] != (size, size):
                frame = resize_rgb(frame, size, size)
            out.append(frame)
        return np.stack(out)

    def check(self) -> Dict[str, Any]:
        """The judge's numbers over the sampled frames of the window,
        against the reference computed now, in blocks."""
        keys = sorted(self.captured)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        refs = self.maker.reference(self.state, self.model_frames(keys), self.device) \
            if keys else []
        numbers = self.maker.judge(self.state, [(self.captured[k], r) for k, r in zip(keys, refs)])
        self.work = self.maker.work(self.state, refs)
        return {"numbers": numbers, "compared": len(keys)}

    def cleanup(self) -> None:
        shutil.rmtree(self.workdir, ignore_errors=True)


def decide(limits: Dict[str, float], checked: Dict[str, Any], rec: Dict[str, Any],
           sample_min: int) -> tuple:
    """The compared numbers beside their limits, and ``correct``: every
    number within its limit, every frame of the window answered, and at
    least ``sample_min`` frames compared."""
    checks = {k: {"value": float(v), "limit": float(limits[k])}
              for k, v in checked["numbers"].items()}
    checks["frames_without_result"] = {"value": float(rec["failed"]), "limit": 0.0}
    correct = all(c["value"] <= c["limit"] for c in checks.values()) \
        and checked["compared"] >= sample_min
    checks["frames_compared_at_least"] = {"value": float(checked["compared"]),
                                          "limit": float(sample_min)}
    return checks, correct


def run(root: str, args, t_start: float) -> int:
    manifest = Manifest(root)
    wl = manifest.workload(args.workload)
    try:
        kind = check_card(int(wl["chips"]))
    except NoCard as e:
        print(f"benchmark: no card for {args.workload}: {e}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    peak_tf32 = torch.backends.cudnn.allow_tf32
    cell = Cell(manifest, args.workload, args.seed, device, streams=args.streams)
    try:
        cell.build()
        cell.warm(timeout=FIRST_TIMEOUT_S, trace=bool(args.trace))
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start
        cell.measure(float(args.seconds), bool(args.trace))
        rec = cell.records()
        cell.stop()
        memory_peak = torch.cuda.max_memory_allocated(device)
        summary = cell.tracer.reduce() if cell.tracer is not None else None
        flops = cell.maker.flops_per_frame(cell.state)
        peak = cell.maker.peak_flops(cell.state)
        cell.free()
        checked = cell.check()
    finally:
        torch.backends.cudnn.allow_tf32 = peak_tf32
        cell.cleanup()
    found = guard.loaded()
    if found:
        print(f"benchmark: the run's process holds {found}", file=sys.stderr)
        return 3
    limits = {**cell.cfg["limits"], **cell.wl.get("limits", {})}
    checks, correct = decide(limits, checked, rec, int(cell.wl["sample_min"]))
    ctx = {"records": rec, "setup_s": setup_s, "cell": cell, "summary": summary,
           "spans": cell.spans, "coalesce": cell.coalesce, "flops_per_frame": flops,
           "peak_flops": peak, "work": cell.work, "traced": bool(args.trace)}
    metrics = read_metrics(manifest, args.workload, bool(args.trace), ctx)
    result = {"correct": bool(correct), "attempted": rec["attempted"], "failed": rec["failed"],
              "metrics": metrics,
              "device": {"platform": "gpu", "kind": kind, "count": int(wl["chips"]),
                         "memory_peak_bytes": int(memory_peak)}}
    if summary is not None:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = checks
    if summary is not None:
        print(f"trace: the profiler took {summary['start_s']!r} s to start, "
              f"{summary['window_s']!r} s traced", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0
