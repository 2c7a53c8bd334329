"""Device-time profiling, compile/roofline telemetry, and Perfetto trace
export.

Port of nnstreamer_tpu/obs/profile.py. The obs stack up to here answers
*whether* a request was slow (metrics), *which* request (traces), and *who*
is unhealthy (health). This module answers *where the device time went*:

  * **Dispatch records** — every filter dispatch is timed on the host
    (submit → return), and every Nth dispatch is additionally timed on the
    card: a ``torch.cuda.Event`` pair is recorded on the current stream
    around the call, the host waits on the end event alone
    (``Event.synchronize``, never the device-wide ``torch.cuda.synchronize``,
    which would collide with a capture another thread has open) and the
    record keeps ``elapsed_time`` — device time proper, where the JAX
    package's ``block_until_ready`` probe measures submit-to-ready wall. On
    CPU tensors, which run synchronously, the sampled ``device_ns`` is the
    call's wall. Records land in a bounded ring.
  * **Compile observability** — graph-cache hit/miss counters (the
    filter's composition per bundle and configuration, and the
    per-(label, shape, dtype) program), the first call of a signature (the
    eager warm-up and CUDA graph capture of ``core/graphs.py``) in the
    compile histogram, and a cost per (label, shapes, dtypes) captured
    once: FLOPs counted by ``torch.utils.flop_counter.FlopCounterMode``
    during that eager warm-up (never inside a capture), bytes as parameter
    + input + output bytes. The JAX package reads XLA's HLO
    ``cost_analysis()`` instead; the two are different reckonings (the
    counter sees matrix products and convolutions only, and none of the
    hand kernels), so the MFU and roofline gauges are the port's own and
    not comparable with the JAX package's.
  * **Live MFU / roofline gauges** — per-lane achieved-FLOP/s EWMA over
    the card's peak and operational intensity over its ridge intensity
    (``utils/probes.py``'s tables), exported as
    ``nnstpu_profile_mfu_ratio{engine=...}`` and friends.
  * **Perfetto timeline** — ``perfetto_trace()`` renders host lanes (one
    per pipeline thread, from SpanStore spans), device lanes (one per
    bundle/kernel label, from profiler records), serving lanes (per-phase
    rows plus a batch-occupancy counter track) and sched lanes as Chrome
    ``trace_event`` JSON, served at ``GET /debug/profile``.
  * **Autotuner substrate** — aggregated ``(label, shapes, dtypes,
    device) → cost`` samples (``samples()`` / ``dump_samples()``).

Kernel labels: the hand kernels' wrappers call ``KERNEL_HOOK`` with
``cuda.<kernel>`` (the JAX package's ``pallas.<kernel>``). A JAX kernel is
labelled once per compiled program, at trace time; a wrapper here runs on
every eager call and once per CUDA graph capture (a replay never re-enters
Python), so ``record_kernel`` keeps every call made while its thread
captures and the first eager call per (label, shape, dtype).

Zero-overhead-when-off contract (the chaos-hook pattern): consumers gate on
module-global hooks that are ``None`` unless profiling is on —

    if _profile.DISPATCH_HOOK is not None:   # one load + None check
        outs = _profile.DISPATCH_HOOK.dispatch(self, arrays, fn=fn)
    else:
        outs = fn(*arrays)

``enable()`` installs the hooks (including ``PROFILE_CHAIN_HOOK`` in
graph/element.py for host-lane fallback timing when tracing is off, and
``EPILOGUE_SELECT_HOOK`` in ops/epilogue.py); ``disable()`` clears them.
``NNSTPU_PROFILE=1`` enables at import, and ``--profile[=N]`` from the CLI.
No hook makes a CUDA call while its thread captures a graph.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import events as _events
from . import metrics as _metrics
from . import quality as _quality
from . import slo as _slo
from . import tracing as _tracing

__all__ = [
    "Profiler", "profiler", "enabled", "enable", "disable",
    "perfetto_trace", "samples", "dump_samples", "report",
    "DISPATCH_HOOK", "ENGINE_HOOK", "KERNEL_HOOK", "SCHED_HOOK",
]

#: Hook consumed by filters/torch_cuda.py around the filter's program call.
#: The active Profiler when profiling is on, else None — dispatch sites pay
#: one module-attribute load + None check when off.
DISPATCH_HOOK: Optional["Profiler"] = None

#: Hook consumed by serving/lm_engine.py to record prefill/decode/verify
#: phase timings + occupancy.
ENGINE_HOOK: Optional["Profiler"] = None

#: Hook consumed by the ops/kernels wrappers: records which hand kernels
#: (label, shape, dtype) run, and which a CUDA graph captured.
KERNEL_HOOK = None  # Optional[Callable[[str, Any, Any], None]]

#: Hook consumed by sched/engine.py after each coalesced device batch.
SCHED_HOOK: Optional["Profiler"] = None

#: default ring capacity / device-timing cadence (every Nth dispatch is
#: timed with a CUDA event pair and waits on its end event)
DEFAULT_MAX_RECORDS = 4096
DEFAULT_SAMPLE_EVERY = 8


def _capturing() -> bool:
    """True while this thread captures a CUDA graph (core/graphs.py): no
    event, no sync and no card read may happen then."""
    from ..core import graphs

    return graphs.capturing()


def _leaf_count(x: Any) -> int:
    """Elements of one parameter leaf (a torch tensor or a numpy array)."""
    numel = getattr(x, "numel", None)
    if callable(numel):
        return int(numel())
    return int(getattr(x, "size", 0) or 0)


def _leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [] if tree is None else [tree]


def _nbytes(x: Any) -> int:
    if hasattr(x, "element_size") and callable(getattr(x, "numel", None)):
        return int(x.numel()) * int(x.element_size())
    return int(getattr(x, "nbytes", 0) or 0)


def _out_leaves(outs: Any) -> List[Any]:
    return list(outs) if isinstance(outs, (list, tuple)) else [outs]


def _param_bytes(bundle: Any) -> float:
    """Bytes of a filter's model weights: the module's parameters and
    buffers, or the leaves of a parameter tree."""
    model = getattr(bundle, "_bundle", None)
    if model is None:
        return 0.0
    module = getattr(model, "module", None)
    if module is not None and hasattr(module, "parameters"):
        ts = list(module.parameters()) + list(module.buffers())
    else:
        ts = _leaves(getattr(model, "params", None))
    return float(sum(_nbytes(t) for t in ts))


class _Timing:
    """Device timing of one sampled call on the card: a CUDA event pair on
    the current stream around it, and a wait on the end event alone."""

    __slots__ = ("start", "end", "stream")

    def __init__(self, device: Any) -> None:
        import torch

        self.stream = torch.cuda.current_stream(device)
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)
        self.start.record(self.stream)

    def finish(self) -> int:
        self.end.record(self.stream)
        self.end.synchronize()
        return int(self.start.elapsed_time(self.end) * 1e6)


def _cuda_device(arrays: Sequence[Any]) -> Any:
    """The card of the first CUDA tensor among ``arrays``, else None."""
    for a in arrays:
        dev = getattr(a, "device", None)
        if getattr(dev, "type", None) == "cuda":
            return dev
    return None


class Profiler:
    """Bounded, lock-protected store of dispatch/engine/kernel records plus
    the derived live telemetry (graph-cache counters, compile histograms,
    MFU/roofline gauges, autotuner samples).

    All recording methods are reached only through the module hooks, so
    none of them is on any hot path while profiling is off."""

    def __init__(self, max_records: int = DEFAULT_MAX_RECORDS,
                 sample_every: int = DEFAULT_SAMPLE_EVERY,
                 enabled: bool = False):
        self._lock = threading.Lock()
        self._records: deque = deque(maxlen=int(max_records))
        self.sample_every = max(1, int(sample_every))
        self._enabled = bool(enabled)
        self._n_dispatch = 0            # guarded-by: _lock
        self._dropped = 0               # guarded-by: _lock
        self._last_done_ns: Dict[str, int] = {}   # guarded-by: _lock
        # (label, shapes, dtypes, device) -> aggregate cost sample
        self._samples: Dict[Tuple, Dict[str, Any]] = {}  # guarded-by: _lock
        # (label, shapes, dtypes) -> {"flops","bytes"} (None while unknown)
        self._cost_seen: Dict[Tuple, Optional[Dict[str, float]]] = {}
        # (label, shape, dtype) of kernels recorded from an eager call
        self._kernel_seen: set = set()  # guarded-by: _lock
        # utilization state per lane name ("lm", "xla")
        self._util: Dict[str, Dict[str, float]] = {}
        self._params_cache: Dict[int, float] = {}  # id(engine) -> n_params
        self._peak_cache: Optional[Tuple[float, float]] = None
        self._m: Optional[Dict[str, Any]] = None

    # -- lifecycle ------------------------------------------------------ #
    @property
    def is_enabled(self) -> bool:
        return self._enabled

    def resize(self, max_records: int) -> None:
        with self._lock:
            self._records = deque(self._records, maxlen=int(max_records))

    def reset(self) -> None:
        with self._lock:
            self._records.clear()
            self._samples.clear()
            self._cost_seen.clear()
            self._kernel_seen.clear()
            self._util.clear()
            self._last_done_ns.clear()
            self._n_dispatch = 0
            self._dropped = 0

    # -- metric families ------------------------------------------------ #
    def _register_metrics(self) -> None:
        """Idempotent: registry._register returns the existing family. The
        label values are the JAX package's (``site="xla"``, ``kind="xla"``
        for the filter's dispatches), so one dashboard reads both. The
        card's peaks are read here, on the enabling thread: the gauges'
        callbacks run on the exporter's thread and ask the card nothing."""
        self._peaks()
        reg = _metrics.registry()
        self._m = {
            "jit": reg.counter(
                "nnstpu_profile_jit_cache_total",
                "program cache lookups (bundle composition, per-shape "
                "program)", ("site", "event")),
            "compile": reg.histogram(
                "nnstpu_profile_compile_seconds",
                "first call of a program signature (eager warm-up and "
                "CUDA graph capture)", ("site",)),
            "dispatch": reg.histogram(
                "nnstpu_profile_dispatch_seconds",
                "profiled dispatch durations by record kind and clock "
                "(device = CUDA-event-timed sample)",
                ("kind", "clock")),
            "mfu": reg.gauge(
                "nnstpu_profile_mfu_ratio",
                "achieved FLOP/s EWMA over the card's peak, per lane",
                ("engine",)),
            "roofline": reg.gauge(
                "nnstpu_profile_roofline_ratio",
                "operational intensity over the card's ridge intensity "
                "(<1 memory-bound, >1 compute-bound)", ("engine",)),
            "achieved": reg.gauge(
                "nnstpu_profile_achieved_flops",
                "achieved FLOP/s EWMA, per lane", ("engine",)),
        }
        # re-attach collection callbacks for lanes that already exist
        # (enable → disable → enable keeps prior state readable)
        for name in list(self._util):
            self._attach_util_gauges(name)

    # -- peak / roofline ------------------------------------------------ #
    def _peaks(self) -> Tuple[float, float]:
        """(peak FLOP/s, peak memory bytes/s) of the card (the CPU's
        nominal figures without one), cached. The peak is the bf16 tensor
        core's, the card's one headline figure, as the JAX package takes
        the chip's."""
        if self._peak_cache is None:
            try:
                import torch

                from ..utils import probes
                dev = torch.device("cuda" if torch.cuda.is_available()
                                   else "cpu")
                self._peak_cache = (probes.chip_peak_flops(dev),
                                    probes.chip_peak_hbm_bw(dev))
            except Exception:
                self._peak_cache = (0.0, 0.0)
        return self._peak_cache

    def _mfu_of(self, name: str) -> float:
        peak, _ = self._peaks()
        st = self._util.get(name)
        return (st["flops_s"] / peak) if (st and peak) else 0.0

    def _roofline_of(self, name: str) -> float:
        peak, bw = self._peaks()
        st = self._util.get(name)
        if not st or not peak or not bw or not st["intensity"]:
            return 0.0
        return st["intensity"] / (peak / bw)

    def _achieved_of(self, name: str) -> float:
        st = self._util.get(name)
        return st["flops_s"] if st else 0.0

    def _attach_util_gauges(self, name: str) -> None:
        if self._m is None:
            return
        self._m["mfu"].labels(name).set_function(
            lambda n=name: self._mfu_of(n))
        self._m["roofline"].labels(name).set_function(
            lambda n=name: self._roofline_of(n))
        self._m["achieved"].labels(name).set_function(
            lambda n=name: self._achieved_of(n))

    def _update_util(self, name: str, flops: float, bytes_: float,
                     dt_s: float) -> None:
        """Fold one measured interval into the lane's achieved-FLOP/s EWMA
        + operational intensity (drives the live gauges)."""
        if dt_s <= 0.0 or flops <= 0.0:
            return
        with self._lock:
            st = self._util.get(name)
            fresh = st is None
            if fresh:
                st = self._util[name] = {
                    "flops_s": 0.0, "intensity": 0.0, "n": 0}
            achieved = flops / dt_s
            alpha = 0.25
            st["flops_s"] = achieved if st["n"] == 0 else \
                (1.0 - alpha) * st["flops_s"] + alpha * achieved
            if bytes_ > 0.0:
                st["intensity"] = flops / bytes_
            st["n"] += 1
        if fresh:
            self._attach_util_gauges(name)

    # -- ring ----------------------------------------------------------- #
    def _append(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._records) == self._records.maxlen:
                self._dropped += 1
            self._records.append(rec)

    def records(self, kind: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            recs = list(self._records)
        return recs if kind is None else [r for r in recs
                                          if r["kind"] == kind]

    def diag_snapshot(self, max_records: int = 256) -> Dict[str, Any]:
        """Bounded freeze for obs.diag debug bundles: full stats and
        aggregated samples, but only the newest ``max_records`` raw
        records — a bundle must stay shippable, and the raw ring can
        hold tens of thousands of dispatch rows."""
        recs = self.records()
        return {
            "enabled": self._enabled,
            "stats": self.stats(),
            "records_total": len(recs),
            "records": recs[-max_records:],
            "samples": self.samples(),
        }

    # -- compile observability (filters/torch_cuda.py) ------------------ #
    def on_jit_cache(self, site: str, hit: bool) -> None:
        """Count a program-cache lookup. site="bundle" is a filter's
        composition for a bundle and configuration already composed;
        site="executable" the per-(label, shape, dtype) program."""
        if self._m is not None:
            self._m["jit"].labels(site, "hit" if hit else "miss").inc()

    def record_compile(self, site: str, seconds: float) -> None:
        if self._m is not None:
            self._m["compile"].labels(site).observe(seconds)

    def _cost_lookup(self, key: Tuple) -> Tuple[bool, Optional[Dict[str, float]]]:
        """(hit, cost) for a (label, shapes, dtypes) key; a miss claims the
        key, so the cost is reckoned once."""
        with self._lock:
            if key in self._cost_seen:
                hit, cost = True, self._cost_seen[key]
            else:
                hit, cost = False, None
                self._cost_seen[key] = None
        self.on_jit_cache("executable", hit)
        return hit, cost

    @contextlib.contextmanager
    def _counting(self, fn: Any, counter: List[Any]):
        """FLOPs of the call inside: ``counter`` receives a started
        FlopCounterMode. A ``CapturedFn`` enters it around its eager
        warm-up only (core/graphs.py ``costing``), so no capture runs under
        it; any other callable runs eagerly under it."""
        from torch.utils.flop_counter import FlopCounterMode

        from ..core import graphs

        mode = FlopCounterMode(display=False)
        counter.append(mode)
        if isinstance(fn, graphs.CapturedFn):
            with graphs.costing(mode):
                yield
        else:
            with mode:
                yield

    def _run(self, fn: Any, arrays: Sequence[Any], sync: bool,
             counter: Optional[List[Any]] = None):
        """Call ``fn(*arrays)``: (outs, t0, t1, device_ns, wait_ns). A
        sampled call is timed on the card by a CUDA event pair (on CPU
        tensors by its own wall), and its host waits for the end event. The
        host interval [t0, t1] holds the start event's record, so the event
        pair lies within [t0, t1 + wait]."""
        dev = _cuda_device(arrays)
        ctx = self._counting(fn, counter) if counter is not None \
            else contextlib.nullcontext()
        t0 = time.monotonic_ns()
        timing = _Timing(dev) if sync and dev is not None else None
        with ctx:
            outs = fn(*arrays)
        t1 = time.monotonic_ns()
        device_ns = wait_ns = None
        if timing is not None:
            device_ns = timing.finish()
            wait_ns = time.monotonic_ns() - t1
        elif sync:
            device_ns, wait_ns = t1 - t0, 0
        return outs, t0, t1, device_ns, wait_ns

    # -- dispatch recording (filters/torch_cuda.py) --------------------- #
    def dispatch(self, bundle: Any, arrays: List[Any],
                 fn: Any = None) -> Any:
        """Run the filter's program under the profiler: host timing always,
        device timing (a CUDA event pair) every Nth dispatch, the cost once
        per (label, shapes, dtypes). Called with the filter's dispatch lock
        held — same exclusion as the bare call. ``fn`` is the program
        (default the filter's ``_fn``); the label is the filter's fused
        epilogue label or its bundle's name."""
        fn = fn if fn is not None else bundle._fn
        if _capturing():
            return fn(*arrays)
        label = getattr(bundle, "_epilogue_label", None) \
            or getattr(getattr(bundle, "_bundle", None), "name", None) \
            or type(bundle).__name__
        shapes = tuple(tuple(int(d) for d in a.shape) for a in arrays)
        dtypes = tuple(str(a.dtype).removeprefix("torch.") for a in arrays)
        key = (label, shapes, dtypes)
        hit, cost = self._cost_lookup(key)
        with self._lock:
            self._n_dispatch += 1
            sync = self._n_dispatch % self.sample_every == 0
            last = self._last_done_ns.get(label)
        counter: Optional[List[Any]] = None if hit else []
        outs, t0, t1, device_ns, wait_ns = self._run(fn, arrays, sync,
                                                     counter)
        if not hit:
            self.record_compile("xla", (t1 - t0) / 1e9)
            flops = float(counter[0].get_total_flops()) if counter else 0.0
            cost = {"flops": flops,
                    "bytes": _param_bytes(bundle)
                    + sum(_nbytes(a) for a in arrays)
                    + sum(_nbytes(o) for o in _out_leaves(outs))}
            with self._lock:
                self._cost_seen[key] = cost
        done = time.monotonic_ns()
        gap_ns = max(t0 - last, 0) if last is not None else None
        with self._lock:
            self._last_done_ns[label] = done
        self._record_sample(key, t1 - t0, device_ns, cost, arrays)
        args: Dict[str, Any] = {"shapes": shapes, "dtypes": dtypes}
        if cost:
            args.update(flops=cost["flops"], bytes=cost["bytes"])
        if wait_ns is not None:
            args["wait_ns"] = wait_ns
        self._append({
            "kind": "dispatch", "label": label, "t0_ns": t0,
            "dur_ns": t1 - t0, "device_ns": device_ns, "gap_ns": gap_ns,
            "tid": threading.get_ident(), "args": args,
        })
        if self._m is not None:
            self._m["dispatch"].labels("xla", "host").observe(
                (t1 - t0) / 1e9)
            if device_ns is not None:
                self._m["dispatch"].labels("xla", "device").observe(
                    device_ns / 1e9)
        # a signature's first call is its warm-up and capture, not compute
        if hit and cost and device_ns:
            self._update_util("xla", cost["flops"], cost["bytes"],
                              device_ns / 1e9)
        return outs

    def dispatch_fn(self, label: str, fn: Any, *arrays: Any) -> Any:
        """Profiled dispatch for device work outside a filter's program —
        unfused transform-element math and decoder device reduces. Each
        call appends one kind="dispatch" record under the caller's explicit
        label, so dispatches-per-frame on a pipeline is the dispatch-record
        count over the frame count."""
        if _capturing():
            return fn(*arrays)
        shapes = tuple(tuple(int(d) for d in a.shape) for a in arrays)
        dtypes = tuple(str(a.dtype).removeprefix("torch.") for a in arrays)
        with self._lock:
            self._n_dispatch += 1
            sync = self._n_dispatch % self.sample_every == 0
            last = self._last_done_ns.get(label)
        outs, t0, t1, device_ns, wait_ns = self._run(fn, arrays, sync)
        done = time.monotonic_ns()
        gap_ns = max(t0 - last, 0) if last is not None else None
        with self._lock:
            self._last_done_ns[label] = done
        args: Dict[str, Any] = {"shapes": shapes, "dtypes": dtypes}
        if wait_ns is not None:
            args["wait_ns"] = wait_ns
        self._append({
            "kind": "dispatch", "label": str(label), "t0_ns": t0,
            "dur_ns": t1 - t0, "device_ns": device_ns, "gap_ns": gap_ns,
            "tid": threading.get_ident(), "args": args,
        })
        if self._m is not None:
            self._m["dispatch"].labels("xla", "host").observe(
                (t1 - t0) / 1e9)
            if device_ns is not None:
                self._m["dispatch"].labels("xla", "device").observe(
                    device_ns / 1e9)
        return outs

    # -- epilogue fusion advice (ops/epilogue.py) ----------------------- #
    def epilogue_select(self, filter_label: str,
                        chain_labels: List[str]) -> bool:
        """Cost-sample-driven fuse/don't-fuse advice for one candidate
        chain. With no host-lane element records for the chain's stages
        (cold profiler, fresh pipeline) fusion proceeds unconditionally.
        Only when observed element records say the whole chain costs under
        ~1µs of host time combined do we decline."""
        del filter_label
        per: Dict[str, List[int]] = {}
        for r in self.records(kind="element"):
            per.setdefault(r["label"], []).append(int(r["dur_ns"]))
        seen = [per[c] for c in chain_labels if c in per]
        if not seen:
            return True
        combined = sum(sum(d) / len(d) for d in seen)
        return combined >= 1_000.0

    @staticmethod
    def _device_kind(arrays: Any) -> str:
        """The card's name for CUDA tensors, else the device type."""
        for a in arrays:
            dev = getattr(a, "device", None)
            if dev is None:
                continue
            if getattr(dev, "type", None) == "cuda":
                import torch

                return torch.cuda.get_device_name(dev)
            return str(getattr(dev, "type", dev))
        return "unknown"

    def _record_sample(self, key: Tuple, host_ns: int,
                       device_ns: Optional[int],
                       cost: Optional[Dict[str, float]],
                       arrays: Any) -> None:
        """Fold one dispatch into the (shape, dtype, fusion, device) → cost
        aggregate — the autotuner's training substrate."""
        label, shapes, dtypes = key
        with self._lock:
            s = self._samples.get(key)
            if s is None:
                s = self._samples[key] = {
                    "label": label, "shapes": shapes, "dtypes": dtypes,
                    "device": self._device_kind(arrays),
                    "n": 0, "host_ns": 0, "device_ns": 0, "device_n": 0,
                    "flops": 0.0, "bytes": 0.0,
                }
            if cost:
                s["flops"] = cost["flops"]
                s["bytes"] = cost["bytes"]
            s["n"] += 1
            s["host_ns"] += int(host_ns)
            if device_ns is not None:
                s["device_ns"] += int(device_ns)
                s["device_n"] += 1

    # -- engine recording (serving/lm_engine.py) ------------------------ #
    def _engine_params(self, engine: Any) -> float:
        key = id(engine)
        n = self._params_cache.get(key)
        if n is None:
            try:
                n = float(sum(_leaf_count(x)
                              for x in _leaves(engine.params)))
            except Exception:
                n = 0.0
            self._params_cache[key] = n
        return n

    def record_engine(self, engine: Any, phase: str, t0_ns: int,
                      t1_ns: int, *, tokens: int = 0, steps: int = 1,
                      active: Optional[int] = None,
                      queued: Optional[int] = None,
                      slots: Optional[int] = None,
                      compiled: bool = False,
                      **attrs: Any) -> None:
        """One engine phase interval (prefill / decode / verify). The
        interval ends on a host-blocking read of the phase's tokens, so
        wall duration ≈ device time for the phase. FLOPs are the JAX
        package's analytic 2·N·tokens (N = parameter count) and bytes its
        one 4-byte read of every parameter a step — that package's own
        approximation, kept as it is for w8a8 params too."""
        name = str(getattr(engine, "_engine_label", "lm"))
        dur_ns = max(int(t1_ns - t0_ns), 0)
        nparams = self._engine_params(engine)
        flops = 2.0 * nparams * float(tokens)
        bytes_ = 4.0 * nparams * float(max(steps, 1))
        args: Dict[str, Any] = {"tokens": tokens, "steps": steps, **attrs}
        if active is not None:
            args.update(active=active, queued=queued, slots=slots)
        self._append({
            "kind": "engine", "label": f"{name}.{phase}", "t0_ns": t0_ns,
            "dur_ns": dur_ns, "device_ns": dur_ns, "gap_ns": None,
            "tid": threading.get_ident(), "args": args,
        })
        if active is not None:
            self._append({
                "kind": "occupancy", "label": name, "t0_ns": t1_ns,
                "dur_ns": 0, "device_ns": None, "gap_ns": None,
                "tid": 0,
                "args": {"active": int(active), "queued": int(queued or 0),
                         "slots": int(slots or 0)},
            })
        if self._m is not None:
            self._m["dispatch"].labels("engine", "host").observe(
                dur_ns / 1e9)
            if compiled:
                self._m["compile"].labels("engine").observe(dur_ns / 1e9)
        if not compiled:  # first-use intervals are capture, not compute
            self._update_util(name, flops, bytes_, dur_ns / 1e9)

    # -- scheduler batches (sched/engine.py SCHED_HOOK) ----------------- #
    def record_sched(self, engine: str, label: str, t0_ns: int,
                     t1_ns: int, *, width: int = 1,
                     tenants: Optional[Sequence[str]] = None,
                     queued: int = 0, inflight: int = 0) -> None:
        """One coalesced device batch from a DeviceEngine dispatch loop:
        the interval covers dispatch through result scatter (host view);
        ``width`` is the coalesce width, ``tenants`` the names served,
        ``queued``/``inflight`` the post-batch engine state."""
        self._append({
            "kind": "sched", "label": f"{engine}.{label}",
            "t0_ns": t0_ns, "dur_ns": max(int(t1_ns - t0_ns), 0),
            "device_ns": None, "gap_ns": None,
            "tid": threading.get_ident(),
            "args": {"engine": engine, "width": int(width),
                     "tenants": list(tenants or ()),
                     "queued": int(queued), "inflight": int(inflight)},
        })
        if self._m is not None:
            self._m["dispatch"].labels("sched", "host").observe(
                max(t1_ns - t0_ns, 0) / 1e9)

    # -- kernel labels (ops/kernels) ------------------------------------ #
    def record_kernel(self, name: str, shape: Any, dtype: Any) -> None:
        """A hand kernel's label: which kernels (with what shapes) ran.
        Every call made while this thread captures a CUDA graph is kept
        (``args["capture"]``), and the first eager call per (label, shape,
        dtype); a replay never calls it. Touches only static metadata."""
        try:
            shp = tuple(int(d) for d in shape)
        except Exception:
            shp = ()
        dt = str(dtype).removeprefix("torch.")
        capture = _capturing()
        if not capture:
            key = (str(name), shp, dt)
            with self._lock:
                if key in self._kernel_seen:
                    return
                self._kernel_seen.add(key)
        self._append({
            "kind": "kernel", "label": str(name),
            "t0_ns": time.monotonic_ns(), "dur_ns": 0,
            "device_ns": None, "gap_ns": None,
            "tid": threading.get_ident(),
            "args": {"shape": shp, "dtype": dt, "capture": capture},
        })

    # -- host-lane fallback (graph/element.py PROFILE_CHAIN_HOOK) ------- #
    def profiled_chain(self, peer: Any, buf: Any) -> Any:
        """Timed stand-in for ``peer.element._chain_entry(peer, buf)``:
        host-lane records per element when tracing is off (with tracing
        on, pipeline.element spans already cover the host lanes)."""
        t0 = time.monotonic_ns()
        ret = peer.element._chain_entry(peer, buf)
        t1 = time.monotonic_ns()
        self._append({
            "kind": "element", "label": str(peer.element.name),
            "t0_ns": t0, "dur_ns": t1 - t0, "device_ns": None,
            "gap_ns": None, "tid": threading.get_ident(), "args": {},
        })
        if self._m is not None:
            self._m["dispatch"].labels("element", "host").observe(
                (t1 - t0) / 1e9)
        return ret

    # -- derived views --------------------------------------------------- #
    def samples(self) -> List[Dict[str, Any]]:
        """Aggregated cost samples, slowest mean device time first."""
        with self._lock:
            out = [dict(s) for s in self._samples.values()]
        for s in out:
            s["mean_host_us"] = (s["host_ns"] / s["n"] / 1e3) if s["n"] \
                else 0.0
            s["mean_device_us"] = (s["device_ns"] / s["device_n"] / 1e3) \
                if s["device_n"] else None
        out.sort(key=lambda s: -(s["mean_device_us"] or s["mean_host_us"]))
        return out

    def dump_samples(self, path: str) -> int:
        """Persist the (shape, dtype, fusion, device) → cost records.
        Returns the count."""
        rows = self.samples()
        with open(path, "w", encoding="utf-8") as fp:
            json.dump({"version": 1, "samples": rows}, fp, indent=1,
                      default=str)
        return len(rows)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            kinds: Dict[str, int] = {}
            for r in self._records:
                kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
            return {
                "enabled": self._enabled,
                "records": len(self._records),
                "dropped": self._dropped,
                "dispatches": self._n_dispatch,
                "by_kind": kinds,
                "sample_every": self.sample_every,
                "lanes": {n: dict(st) for n, st in self._util.items()},
            }

    def report(self) -> str:
        """Human-readable exit summary for ``--profile``."""
        st = self.stats()
        lines = [
            f"profile: {st['records']} records "
            f"({st['dropped']} dropped), {st['dispatches']} dispatches, "
            f"device-timed every {st['sample_every']}",
        ]
        for name in sorted(st["lanes"]):
            lines.append(
                f"  lane {name}: mfu={self._mfu_of(name):.4f} "
                f"roofline={self._roofline_of(name):.3f} "
                f"achieved={self._achieved_of(name):.3e} FLOP/s")
        for s in self.samples()[:10]:
            dev = s["mean_device_us"]
            lines.append(
                f"  {s['label']} {s['shapes']}: n={s['n']} "
                f"host={s['mean_host_us']:.1f}us "
                f"device={f'{dev:.1f}us' if dev is not None else 'n/a'} "
                f"flops={s['flops']:.3g}")
        return "\n".join(lines)


# --------------------------------------------------------------------------- #
# Perfetto / Chrome trace_event export
# --------------------------------------------------------------------------- #

_PID_HOST, _PID_DEVICE, _PID_SERVING, _PID_SCHED, _PID_SLO = 1, 2, 3, 4, 5
_PID_FLEET = 6
_PID_QUALITY = 7


def perfetto_trace(span_store: Optional[_tracing.SpanStore] = None,
                   prof: Optional["Profiler"] = None) -> Dict[str, Any]:
    """Chrome ``trace_event`` JSON (loads in Perfetto / chrome://tracing)
    with four process groups:

      * pid 1 **host** — pipeline.* (and other host) spans, one thread lane
        per pipeline thread; profiler element records fill in when tracing
        is off
      * pid 2 **device** — profiler dispatch records, one lane per bundle
        label (slice duration = CUDA-event device time when the dispatch
        was sampled, else host dispatch time) + kernel label instants
      * pid 3 **serving** — serving.* spans in one lane per phase
        (admission_wait / prefill / decode …) + a slot-occupancy counter
        track from engine records
      * pid 4 **sched** — DeviceEngine coalesced-batch slices, one lane per
        work label, plus a coalesce-width / queue-depth counter track
      * pid 5 **slo** — one cumulative goodput counter track per tenant
        (met/missed/shed) from obs/slo.py, present when the SLO layer is
        recording
      * pid 6 **fleet** — fleet.* spans (session migrations and restores,
        one lane per operation) from fleet/, present when the fleet acted
      * pid 7 **quality** — one counter track per data-plane tap (mean /
        PSI drift score / cumulative NaN count) from obs/quality, present
        when quality telemetry is recording

    All timestamps share the process monotonic clock (µs)."""
    store = span_store if span_store is not None else _tracing.store()
    p = prof if prof is not None else _PROFILER
    ev: List[Dict[str, Any]] = []

    def meta(pid: int, tid: int, mname: str, value: str) -> None:
        ev.append({"ph": "M", "name": mname, "pid": pid, "tid": tid,
                   "args": {"name": value}})

    meta(_PID_HOST, 0, "process_name", "host")
    meta(_PID_DEVICE, 0, "process_name", "device")
    meta(_PID_SERVING, 0, "process_name", "serving")
    meta(_PID_SCHED, 0, "process_name", "sched")

    thread_names = {t.ident: t.name for t in threading.enumerate()}
    named_host: set = set()
    rows: Dict[int, Dict[str, int]] = {
        _PID_SERVING: {}, _PID_DEVICE: {}, _PID_SCHED: {}, _PID_FLEET: {}}

    def row(pid: int, label: str) -> int:
        r = rows[pid].get(label)
        if r is None:
            if pid == _PID_FLEET and not rows[pid]:
                # the fleet group appears only once the fleet acted
                meta(_PID_FLEET, 0, "process_name", "fleet")
            r = rows[pid][label] = len(rows[pid]) + 1
            meta(pid, r, "thread_name", label)
        return r

    def host_lane(tid: int) -> int:
        if tid not in named_host:
            named_host.add(tid)
            meta(_PID_HOST, tid, "thread_name",
                 thread_names.get(tid, f"thread-{tid}"))
        return tid

    for s in store.snapshot_spans():
        layer, _, rest = s.name.partition(".")
        dur = max(s.end_ns - s.start_ns, 0) / 1e3
        if layer in ("serving", "fleet"):
            pid = _PID_SERVING if layer == "serving" else _PID_FLEET
            ev.append({
                "name": rest or s.name, "cat": layer, "ph": "X",
                "ts": s.start_ns / 1e3, "dur": dur, "pid": pid,
                "tid": row(pid, rest or s.name), "args": s.attrs,
            })
            continue
        ev.append({
            "name": str(s.attrs.get("element", rest or s.name)),
            "cat": layer, "ph": "X", "ts": s.start_ns / 1e3, "dur": dur,
            "pid": _PID_HOST, "tid": host_lane(getattr(s, "tid", 0)),
            "args": s.attrs,
        })

    for r in p.records():
        kind = r["kind"]
        if kind in ("dispatch", "engine"):
            dur_ns = r["device_ns"] if r["device_ns"] is not None \
                else r["dur_ns"]
            args = dict(r["args"])
            args["clock"] = "device" if r["device_ns"] is not None \
                else "host"
            if r["gap_ns"] is not None:
                args["gap_us"] = r["gap_ns"] / 1e3
            ev.append({
                "name": r["label"], "cat": kind, "ph": "X",
                "ts": r["t0_ns"] / 1e3, "dur": dur_ns / 1e3,
                "pid": _PID_DEVICE, "tid": row(_PID_DEVICE, r["label"]),
                "args": args,
            })
        elif kind == "kernel":
            ev.append({
                "name": r["label"], "cat": "kernel", "ph": "i", "s": "p",
                "ts": r["t0_ns"] / 1e3, "pid": _PID_DEVICE,
                "tid": row(_PID_DEVICE, r["label"]), "args": r["args"],
            })
        elif kind == "sched":
            ev.append({
                "name": r["label"], "cat": "sched", "ph": "X",
                "ts": r["t0_ns"] / 1e3, "dur": r["dur_ns"] / 1e3,
                "pid": _PID_SCHED, "tid": row(_PID_SCHED, r["label"]),
                "args": r["args"],
            })
            ev.append({
                "name": f"{r['args']['engine']}.coalesce", "ph": "C",
                "ts": r["t0_ns"] / 1e3, "pid": _PID_SCHED, "tid": 0,
                "args": {"width": r["args"]["width"],
                         "queued": r["args"]["queued"],
                         "inflight": r["args"]["inflight"]},
            })
        elif kind == "occupancy":
            ev.append({
                "name": f"{r['label']}.slots", "ph": "C",
                "ts": r["t0_ns"] / 1e3, "pid": _PID_SERVING, "tid": 0,
                "args": {"active": r["args"]["active"],
                         "queued": r["args"]["queued"]},
            })
        elif kind == "element":
            ev.append({
                "name": r["label"], "cat": "element", "ph": "X",
                "ts": r["t0_ns"] / 1e3, "dur": r["dur_ns"] / 1e3,
                "pid": _PID_HOST, "tid": host_lane(r["tid"]),
                "args": r["args"],
            })

    slo_points = _slo.trace_points()
    if slo_points:
        meta(_PID_SLO, 0, "process_name", "slo")
        for pt in slo_points:
            ev.append({
                "name": f"{pt['tenant']}.goodput", "ph": "C",
                "ts": pt["t_ns"] / 1e3, "pid": _PID_SLO, "tid": 0,
                "args": {"met": pt["met"], "missed": pt["missed"],
                         "shed": pt["shed"]},
            })

    q_points = _quality.trace_points()
    if q_points:
        meta(_PID_QUALITY, 0, "process_name", "quality")
        for pt in q_points:
            ev.append({
                "name": f"{pt['tap']}.quality", "ph": "C",
                "ts": pt["t_ns"] / 1e3, "pid": _PID_QUALITY, "tid": 0,
                "args": {"mean": pt["mean"], "psi": pt["psi"],
                         "nan": pt["nan"]},
            })

    return {
        "traceEvents": ev,
        "displayTimeUnit": "ms",
        "otherData": {
            "profile_enabled": p.is_enabled,
            "tracing_enabled": store.is_enabled,
            "slo_enabled": _slo.enabled(),
            "quality_enabled": _quality.enabled(),
            **p.stats(),
        },
    }


# --------------------------------------------------------------------------- #
# Process-global profiler + hook install
# --------------------------------------------------------------------------- #

_PROFILER = Profiler(enabled=False)


def profiler() -> Profiler:
    return _PROFILER


def enabled() -> bool:
    return _PROFILER._enabled


def enable(max_records: Optional[int] = None,
           sample_every: Optional[int] = None) -> None:
    """Turn profiling on: register metric families and install every hook.
    ``max_records`` resizes the ring (``--profile=N``); ``sample_every``
    sets the device-timing cadence."""
    global DISPATCH_HOOK, ENGINE_HOOK, KERNEL_HOOK, SCHED_HOOK
    p = _PROFILER
    if max_records is not None:
        p.resize(max_records)
    if sample_every is not None:
        p.sample_every = max(1, int(sample_every))
    p._enabled = True
    p._register_metrics()
    DISPATCH_HOOK = p
    ENGINE_HOOK = p
    KERNEL_HOOK = p.record_kernel
    SCHED_HOOK = p
    try:
        from ..graph import element as _gel
        _gel.PROFILE_CHAIN_HOOK = p.profiled_chain
    except ImportError:  # mid-import of graph: pipeline hooks come later
        pass
    try:
        from ..ops import epilogue as _epi
        _epi.EPILOGUE_SELECT_HOOK = p.epilogue_select
    except ImportError:
        pass
    _events.record("profile.capture_start",
                   f"profiling on (ring={p._records.maxlen}, "
                   f"device-timed every {p.sample_every})")


def disable() -> None:
    """Turn profiling off and clear every hook — hot paths are back to one
    None check. Recorded data stays readable until reset()."""
    global DISPATCH_HOOK, ENGINE_HOOK, KERNEL_HOOK, SCHED_HOOK
    p = _PROFILER
    if p._enabled:
        _events.record("profile.capture_stop",
                       f"profiling off ({len(p._records)} records held)")
    p._enabled = False
    DISPATCH_HOOK = None
    ENGINE_HOOK = None
    KERNEL_HOOK = None
    SCHED_HOOK = None
    try:
        from ..graph import element as _gel
        _gel.PROFILE_CHAIN_HOOK = None
    except ImportError:
        pass
    try:
        from ..ops import epilogue as _epi
        _epi.EPILOGUE_SELECT_HOOK = None
    except ImportError:
        pass


def samples() -> List[Dict[str, Any]]:
    return _PROFILER.samples()


def dump_samples(path: str) -> int:
    return _PROFILER.dump_samples(path)


def report() -> str:
    return _PROFILER.report()


if os.environ.get("NNSTPU_PROFILE", "") == "1":
    enable()
