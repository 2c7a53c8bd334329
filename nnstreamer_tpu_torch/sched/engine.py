"""DeviceEngine — one dispatch loop multiplexing many tenants per card.

Port of nnstreamer_tpu/sched/engine.py. Without it every pipeline
dispatches to the device one buffer at a time from its own threads. Here
every concurrently-running pipeline (or serving engine) registers as a
**tenant**, pushes ready work into its own queue, and a single per-engine
dispatch loop

  1. **drains fairly** — deficit-round-robin over weighted tenant queues,
     highest priority class first, with a hard *starvation bound*: tenants
     whose head-of-line work has waited longer than ``starve_ms`` are
     force-served round-robin regardless of weight/priority, so the
     worst-case head wait is ``starve_ms`` plus one service lap;
  2. **coalesces** — the lead item's batch pulls same-filter/same-shape head
     runs from every other tenant queue into ONE device batch
     (``TorchCudaFilter.invoke_coalesced``: one CUDA graph per batch width,
     or the filter's existing bucket ladder under ``bucket=``), scattering
     per-tenant results back to the submitters' futures;
  3. **overlaps host and device** — PyTorch enqueues CUDA work and returns,
     so futures resolve with device-resident tensors immediately after
     dispatch and tenants' host-side post-processing of batch *k* runs while
     the card executes it. After each batch the loop records a CUDA event
     on the dispatching stream and keeps at most ``inflight`` batches
     (default 2 — double buffering) un-synced before waiting on the oldest
     event; ``stop()`` drains the window. CPU tensors record nothing;
  4. **sheds** — work whose ``resilience.Deadline`` (per-buffer, or the
     tenant's default ``deadline_ms``) expires while queued resolves to
     ``SHED`` instead of dispatching, accounted through
     ``resilience.record_shed`` (site ``sched``, tenant attribute) — the
     graph's soft-drop semantics.

Clocks are injectable (``clock=`` seconds) so the fairness/starvation logic
unit-tests against a fake clock without sleeping. ``autostart=False`` plus
``step()`` runs the loop body synchronously for the same reason.

Telemetry as in the JAX engine: the ``nnstpu_sched_*`` families and
``sched.*`` events (sched/telemetry.py), a ``kind="sched"`` health
component per engine (the watchdog's starvation-storm rule) and the
profiler's ``SCHED_HOOK`` per batch, the SLO layer's ``SCHED_SLO_HOOK``
(each shed, and each batch's per-tenant attribution) and diag's
``DIAG_HOOK`` (the submitter's trace context at submit, the batch's
attribution spans and cost sample at its end), and the fleet's
``AUTOSCALE_HOOK`` (each batch's occupancy, for the autoscaler).
"""

from __future__ import annotations

import collections
import threading
import time
import weakref
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

import torch

from .. import fleet as _fleet
from ..core.log import logger
from ..graph.element import join_or_warn
from ..obs import diag as _diag
from ..obs import health as _health
from ..obs import profile as _profile
from ..obs import slo as _slo
from ..resilience import policy as _rp
from . import telemetry as _tel

log = logger("sched")


class _Shed:
    """Sentinel resolved into futures whose work was deadline-shed.
    Consumers treat it as the graph's soft-drop (buffer dropped)."""

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return "<sched.SHED>"


#: singleton shed marker — ``future.result() is SHED`` is the contract
SHED = _Shed()


class WorkFuture:
    """Minimal completion handle for one submitted work item."""

    __slots__ = ("_ev", "_value", "_exc")

    def __init__(self) -> None:
        self._ev = threading.Event()
        self._value: Any = None
        self._exc: Optional[BaseException] = None

    def set_result(self, value: Any) -> None:
        self._value = value
        self._ev.set()

    def set_exception(self, exc: BaseException) -> None:
        self._exc = exc
        self._ev.set()

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._ev.wait(timeout):
            raise TimeoutError("sched work not complete")
        if self._exc is not None:
            raise self._exc
        return self._value


class _Work:
    __slots__ = ("tenant", "key", "filt", "inputs", "fn", "future",
                 "t_enq", "deadline", "label", "diag")

    def __init__(self, tenant: "Tenant", key: Any, filt: Any,
                 inputs: Any, fn: Optional[Callable[[], Any]],
                 future: WorkFuture, t_enq: float, deadline: Any,
                 label: str) -> None:
        self.tenant = tenant
        self.key = key
        self.filt = filt
        self.inputs = inputs
        self.fn = fn
        self.future = future
        self.t_enq = t_enq
        self.deadline = deadline
        self.label = label
        # (trace context, enqueue ns) captured at submit when the diag
        # layer is on — feeds the critical-path sched_wait span
        self.diag: Any = None


def _work_rows(w: "_Work") -> int:
    """Row weight for per-tenant busy-time attribution: the leading dim
    of the first input tensor; opaque callables count as one row."""
    if w.inputs:
        try:
            shape = w.inputs[0].shape
            if shape:
                return max(int(shape[0]), 1)
        except Exception:
            pass
    return 1


def _coalesce_key(filt: Any, inputs: Sequence[Any]) -> Tuple:
    """Same-bundle/same-shape work coalesces; shapes/dtypes come from
    TensorMemory metadata (no device→host read). Filters that publish a
    ``coalesce_token`` (TorchCudaFilter does: bundle identity + every
    result-affecting knob) coalesce ACROSS instances — that is what lets N
    pipelines over one zoo spec share device batches; anything else
    anchors on object identity."""
    anchor = getattr(filt, "coalesce_token", None)
    return (anchor if anchor is not None else id(filt),
            tuple((tuple(m.shape), str(m.dtype)) for m in inputs))


def _batch_event(outs: Sequence[Any]) -> Optional["torch.cuda.Event"]:
    """A CUDA event recorded after a batch's work, on the stream that
    dispatched it (the current stream of the first CUDA output's device);
    None when no output lives on a card."""
    for out in outs:
        for m in (out if isinstance(out, (list, tuple)) else ()):
            t = m if isinstance(m, torch.Tensor) else getattr(m, "_device", None)
            if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(t.device))
                return ev
    return None


class Tenant:
    """One registered work source: a weighted, prioritized FIFO queue.

    ``weight`` scales the DRR quantum (a weight-2 tenant drains twice the
    items per round of a weight-1 peer under contention); ``priority``
    classes are strict — higher drains first — but the engine's starvation
    bound caps how long any lower class can be bypassed. ``deadline_ms`` is
    the default per-item deadline applied at submit when the work carries
    none of its own.
    """

    def __init__(self, engine: "DeviceEngine", name: str, weight: float,
                 priority: int, deadline_ms: Optional[float]) -> None:
        if weight <= 0:
            raise ValueError(f"tenant weight must be > 0, got {weight}")
        self.engine = engine
        self.name = name
        self.weight = float(weight)
        self.priority = int(priority)
        self.deadline_ms = deadline_ms
        self.queue: Deque[_Work] = collections.deque()
        self.deficit = 0.0
        #: bounded wait samples (seconds) for median/max reporting
        self.waits: Deque[float] = collections.deque(maxlen=4096)
        self.stats: Dict[str, int] = {
            "submitted": 0, "completed": 0, "shed": 0, "errors": 0}

    # -- public API ------------------------------------------------------- #
    def submit(self, filt: Any, inputs: Sequence[Any],
               deadline: Any = None, label: str = "") -> WorkFuture:
        """Queue one filter invoke; returns its future. The result is the
        filter's output list, or ``SHED`` if the deadline expired before
        dispatch."""
        return self.engine._submit(
            self, _coalesce_key(filt, inputs), filt, inputs, None,
            deadline, label or getattr(filt, "name", "") or "invoke")

    def call(self, fn: Callable[[], Any], deadline: Any = None,
             label: str = "call") -> Any:
        """Run an opaque callable under this tenant's fair share and block
        for its result (serving engines enroll their iteration steps this
        way — not coalescible, but scheduled). Returns the callable's
        result, or ``SHED`` when the deadline expired."""
        fut = self.engine._submit(self, None, None, None, fn,
                                  deadline, label)
        return fut.result()

    def pending(self) -> int:
        return len(self.queue)

    def wait_stats(self) -> Dict[str, float]:
        """Median/max of the recent submit→dispatch waits (seconds)."""
        w = sorted(self.waits)
        if not w:
            return {"median_s": 0.0, "max_s": 0.0, "n": 0}
        return {"median_s": w[len(w) // 2], "max_s": w[-1], "n": len(w)}


class DeviceEngine:
    """Central device dispatch engine (one per device).

    Knobs: ``max_coalesce`` caps items per device batch; ``quantum`` is the
    DRR replenish per round (items, scaled by tenant weight); ``starve_ms``
    is the fairness bound — the longest any tenant's head-of-line work may
    wait while others are served; ``inflight`` bounds un-synced dispatched
    batches (2 = double buffering); ``clock`` injects a monotonic-seconds
    source for tests.
    """

    def __init__(self, name: str = "dev0", *, max_coalesce: int = 8,
                 quantum: float = 2.0, starve_ms: float = 100.0,
                 inflight: int = 2,
                 clock: Callable[[], float] = time.monotonic,
                 autostart: bool = True) -> None:
        if max_coalesce < 1 or inflight < 1 or quantum <= 0:
            raise ValueError("max_coalesce/inflight >= 1, quantum > 0")
        self.name = name
        self.max_coalesce = int(max_coalesce)
        self.quantum = float(quantum)
        self.starve_s = float(starve_ms) / 1e3
        self.inflight = int(inflight)
        self.clock = clock
        self._autostart = autostart
        self._cv = threading.Condition()
        self._tenants: List[Tenant] = []   # guarded-by: _cv
        self._rr = 0                       # DRR cursor, guarded-by: _cv
        self._relief_rr = 0                # starvation-relief cursor
        self._running = False
        self._thread: Optional[threading.Thread] = None
        #: dispatched-but-unsynced batches: one CUDA event each (None for a
        #: batch with nothing on a card). Only the dispatch loop touches it
        #: while it runs (single consumer); stop() drains it after the join.
        self._inflight_q: Deque[Optional["torch.cuda.Event"]] = \
            collections.deque()
        self._pipelines: Dict[int, Tuple[Any, Tenant]] = {}
        self.stats: Dict[str, int] = {
            "batches": 0, "items": 0, "shed": 0, "starvation_reliefs": 0,
            "coalesce_fallbacks": 0}
        #: bounded per-batch coalesce widths for median reporting
        self.widths: Deque[int] = collections.deque(maxlen=4096)
        self._busy_s = 0.0
        self._wait_s = 0.0
        self._t_started: Optional[float] = None  # wall anchor for occupancy()
        eref = weakref.ref(self)

        def _probe() -> Optional[Dict[str, Any]]:
            eng = eref()
            if eng is None:
                return None  # engine collected — retire the component
            return {"starvation_reliefs": eng.stats["starvation_reliefs"],
                    "batches": eng.stats["batches"],
                    "shed": eng.stats["shed"]}

        _health.component(f"sched:{name}", kind="sched", probe=_probe,
                          attrs={"engine": name})
        #: operator-set per-name admission overrides (nns-launch
        #: --sched-tenants): applied IN PLACE OF register() arguments, so
        #: deployment config beats programmatic defaults
        self._presets: Dict[str, Tuple[float, int, Optional[float]]] = {}

    # -- tenant lifecycle -------------------------------------------------- #
    def preset(self, name: str, *, weight: float = 1.0, priority: int = 0,
               deadline_ms: Optional[float] = None) -> None:
        """Pin admission parameters for a tenant NAME before it exists: when
        a tenant registers under ``name`` (a pipeline attaching, a serving
        engine enrolling), these values override whatever the caller
        passed. The ``--sched-tenants`` CLI flag lands here."""
        if weight <= 0:
            raise ValueError("preset weight must be > 0")
        self._presets[name] = (float(weight), int(priority), deadline_ms)

    def register(self, name: str, *, weight: float = 1.0,
                 priority: int = 0,
                 deadline_ms: Optional[float] = None) -> Tenant:
        # suffixed pipeline tenants ("cam#1") inherit the base preset
        pre = self._presets.get(name) \
            or self._presets.get(name.split("#", 1)[0])
        if pre is not None:
            weight, priority, deadline_ms = pre
        tenant = Tenant(self, name, weight, priority, deadline_ms)
        with self._cv:
            if any(t.name == name for t in self._tenants):
                raise ValueError(f"duplicate tenant name {name!r}")
            self._tenants.append(tenant)
        ref = weakref.ref(tenant)
        _tel.watch_queue_depth(
            name, lambda: float(len(t.queue)) if (t := ref()) is not None
            else 0.0)
        _tel.event_tenant_register(name, weight=weight, priority=priority)
        return tenant

    def deregister(self, tenant: Tenant) -> None:
        """Remove a tenant; any still-queued work resolves to SHED so no
        submitter can hang on a future nobody will run."""
        with self._cv:
            if tenant in self._tenants:
                self._tenants.remove(tenant)
            leftovers = list(tenant.queue)
            tenant.queue.clear()
        for w in leftovers:
            self._shed(w, "tenant deregistered")
        _tel.event_tenant_deregister(tenant.name)

    def tenants(self) -> List[Tenant]:
        with self._cv:
            return list(self._tenants)

    # -- pipeline attachment (graph/pipeline.py opt-in path) --------------- #
    def attach_pipeline(self, pipeline: Any) -> Tenant:
        """Enroll a pipeline: one tenant (weight/priority/deadline from the
        pipeline's ``sched_*`` attributes), every element offered the
        engine via its ``sched_enroll`` hook (a no-op base; the
        tensor_filter override routes its invokes here)."""
        key = id(pipeline)
        if key in self._pipelines:
            return self._pipelines[key][1]
        base = getattr(pipeline, "name", f"pipeline{key}")
        name, suffix = base, 1
        with self._cv:
            taken = {t.name for t in self._tenants}
        while name in taken:  # two pipelines may share the default name
            name = f"{base}#{suffix}"
            suffix += 1
        tenant = self.register(
            name,
            weight=getattr(pipeline, "sched_weight", 1.0),
            priority=getattr(pipeline, "sched_priority", 0),
            deadline_ms=getattr(pipeline, "sched_deadline_ms", None))
        for el in pipeline.elements.values():
            el.sched_enroll(self, tenant)
        self._pipelines[key] = (weakref.ref(pipeline), tenant)
        if self._autostart:
            self.start()
        return tenant

    def detach_pipeline(self, pipeline: Any) -> None:
        entry = self._pipelines.pop(id(pipeline), None)
        if entry is None:
            return
        for el in pipeline.elements.values():
            el.sched_detach()
        self.deregister(entry[1])

    def executor(self, tenant: Tenant, filt: Any,
                 label: str = "") -> Callable:
        """Bound invoke-through-the-engine callable for one filter — what
        ``TensorFilter.sched_enroll`` installs on its chain path. Returns
        the filter's outputs, or None (graph soft-drop) when the work was
        shed."""

        def run(inputs: Sequence[Any], deadline: Any = None):
            fut = tenant.submit(filt, inputs, deadline=deadline,
                                label=label)
            res = fut.result()
            return None if res is SHED else res

        return run

    # -- submission --------------------------------------------------------- #
    def _submit(self, tenant: Tenant, key: Any, filt: Any, inputs: Any,
                fn: Optional[Callable[[], Any]], deadline: Any,
                label: str) -> WorkFuture:
        fut = WorkFuture()
        if deadline is None and tenant.deadline_ms is not None:
            deadline = _rp.Deadline.after_ms(tenant.deadline_ms)
        work = _Work(tenant, key, filt, inputs, fn, fut,
                     self.clock(), deadline, label)
        dhook = _diag.DIAG_HOOK
        if dhook is not None:
            work.diag = dhook.tap_submit()
        if deadline is not None and deadline.expired():
            self._shed(work, "deadline expired at submit")
            return fut
        with self._cv:
            tenant.stats["submitted"] += 1
            tenant.queue.append(work)
            self._cv.notify_all()
        if self._autostart:
            self.start()
        return fut

    def _shed(self, work: _Work, why: str) -> None:
        work.tenant.stats["shed"] += 1
        self.stats["shed"] += 1
        _rp.record_shed(
            "sched", f"{work.tenant.name}: {work.label} shed ({why})",
            tenant=work.tenant.name, label=work.label)
        shook = _slo.SCHED_SLO_HOOK
        if shook is not None:
            shook.record_shed(
                work.tenant.name, "sched",
                wait_s=max(self.clock() - work.t_enq, 0.0))
        work.future.set_result(SHED)

    # -- fair draining ------------------------------------------------------ #
    def _shed_expired_heads(self, now: float) -> None:
        """Drop expired head-of-line work so a dead deadline never occupies
        a dispatch slot (guarded-by: _cv)."""
        for t in self._tenants:
            while t.queue and t.queue[0].deadline is not None \
                    and t.queue[0].deadline.expired():
                self._shed(t.queue.popleft(), "deadline expired in queue")

    def _pick_lead(self, now: float) -> Optional[Tenant]:
        """Choose the tenant whose head item leads the next batch
        (guarded-by: _cv). Starvation bound first, then strict priority,
        then weighted DRR inside the class."""
        ready = [t for t in self._tenants if t.queue]
        if not ready:
            return None
        # fairness bound: over-bound heads win outright, served ROUND-ROBIN
        # among themselves — oldest-head-first would let a deep equally-old
        # backlog monopolize relief forever, so the bound is: any tenant's
        # head-of-line wait <= starve_s + |tenants| service rounds
        starved = [t for t in ready
                   if now - t.queue[0].t_enq > self.starve_s]
        if starved:
            start = self._relief_rr % max(len(self._tenants), 1)
            lead = min(starved, key=lambda t: (self._tenants.index(t)
                                               - start)
                       % max(len(self._tenants), 1))
            self._relief_rr = self._tenants.index(lead) + 1
            self.stats["starvation_reliefs"] += 1
            _tel.event_starvation_relief(
                lead.name, now - lead.queue[0].t_enq, self.starve_s)
            return lead
        top = max(t.priority for t in ready)
        klass = [t for t in ready if t.priority == top]
        # deficit round robin from the cursor: first tenant past the cursor
        # holding a full item's credit serves. When nobody has credit,
        # replenish proportionally (quantum * weight) by the exact
        # closed-form amount that brings the best-funded tenant to 1.0 —
        # weight-proportional service without a retry loop.
        if all(t.deficit < 1.0 for t in klass):
            k = min((1.0 - t.deficit) / (self.quantum * t.weight)
                    for t in klass)
            for t in klass:
                t.deficit += k * self.quantum * t.weight
        start = self._rr % max(len(self._tenants), 1)
        order = sorted(klass, key=lambda t: (self._tenants.index(t)
                                             - start)
                       % max(len(self._tenants), 1))
        for t in order:
            if t.deficit >= 1.0 - 1e-9:
                self._rr = self._tenants.index(t) + 1
                return t
        return order[0]  # float-edge fallback; deterministic anyway

    def _take_batch(self, now: float) -> List[_Work]:
        """Form one device batch (guarded-by: _cv): the lead tenant's
        same-key head run, topped up with matching head runs from every
        other ready tenant (free co-riders still pay deficit), capped at
        ``max_coalesce``. Per-tenant FIFO order is preserved — only HEAD
        runs coalesce."""
        self._shed_expired_heads(now)
        lead = self._pick_lead(now)
        if lead is None:
            return []
        head = lead.queue[0]
        batch: List[_Work] = []
        budget = self.max_coalesce
        if head.key is None:  # opaque callable: never coalesced
            lead.queue.popleft()
            lead.deficit = max(lead.deficit - 1.0, -self.max_coalesce)
            return [head]
        # a starvation-relief lead may hold < 1 credit; it still serves at
        # least its head item (its deficit going negative is the DRR debt
        # it repays over later rounds)
        allowance = max(1, min(int(lead.deficit), budget))
        while lead.queue and lead.queue[0].key == head.key \
                and len(batch) < allowance:
            batch.append(lead.queue.popleft())
        lead.deficit -= len(batch)
        budget -= len(batch)
        if budget > 0:
            for t in self._tenants:
                if t is lead or budget <= 0:
                    continue
                while t.queue and t.queue[0].key == head.key and budget > 0:
                    batch.append(t.queue.popleft())
                    t.deficit -= 1.0
                    budget -= 1
        return batch

    # -- execution ----------------------------------------------------------- #
    def step(self, block: bool = False, timeout: float = 0.1) -> bool:
        """Run one dispatch-loop iteration: form a batch and execute it.
        Returns True if work was dispatched. ``block`` waits up to
        ``timeout`` for work to arrive (the loop thread's mode); tests call
        with the default for synchronous, fake-clock stepping."""
        with self._cv:
            batch = self._take_batch(self.clock())
            if not batch and block:
                self._cv.wait(timeout)
                batch = self._take_batch(self.clock())
        if not batch:
            return False
        self._execute(batch)
        return True

    def _execute(self, batch: List[_Work]) -> None:
        now = self.clock()
        for w in batch:
            wait = max(now - w.t_enq, 0.0)
            _tel.record_wait(w.tenant.name, wait)
            w.tenant.waits.append(wait)
            self._wait_s += wait
        t0 = time.monotonic_ns()
        try:
            outs = self._dispatch(batch)
        except Exception as e:  # noqa: BLE001 — submitters own the error
            for w in batch:
                w.tenant.stats["errors"] += 1
                w.future.set_exception(e)
            return
        # batch accounting BEFORE scatter-back: resolving a future unblocks
        # its submitter, and anything downstream of it (EOS, a stats
        # reader) must already see this batch counted
        self.stats["batches"] += 1
        self.stats["items"] += len(batch)
        self.widths.append(len(batch))
        # the batch's completion point on the dispatching stream, recorded
        # before the futures resolve (their holders enqueue more work)
        done = _batch_event(outs)
        # scatter-back: futures resolve with device-resident tensors —
        # tenant host threads overlap with the still-executing device
        for w, out in zip(batch, outs):
            w.tenant.stats["completed"] += 1
            w.future.set_result(out)
        # bounded double-buffer window: sync the OLDEST outstanding batch
        # only once `inflight` newer ones have been dispatched
        self._inflight_q.append(done)
        while len(self._inflight_q) > self.inflight:
            ev = self._inflight_q.popleft()
            if ev is not None:
                ev.synchronize()
        t1 = time.monotonic_ns()
        busy = (t1 - t0) / 1e9
        self._busy_s += busy
        _tel.record_batch(self.name, len(batch), busy)
        _tel.INFLIGHT_DEPTH.labels(self.name).set(len(self._inflight_q))
        hook = _profile.SCHED_HOOK
        if hook is not None:
            hook.record_sched(
                self.name, batch[0].label or "batch", t0, t1,
                width=len(batch),
                tenants=sorted({w.tenant.name for w in batch}),
                queued=sum(len(t.queue) for t in self.tenants()),
                inflight=len(self._inflight_q))
        shook = _slo.SCHED_SLO_HOOK
        if shook is not None:
            shook.record_sched_batch(
                self.name, busy,
                [(w.tenant.name, max(now - w.t_enq, 0.0), _work_rows(w),
                  w.deadline) for w in batch])
        fhook = _fleet.AUTOSCALE_HOOK
        if fhook is not None:
            # engine busy fraction as a scale signal, sampled at batch
            # boundaries — same one-load None gate as the hooks above
            fhook.observe_occupancy(self.name, self.occupancy())
        dhook = _diag.DIAG_HOOK
        if dhook is not None:
            # critical-path spans + cost-anomaly sample for the batch
            dhook.observe_sched_batch(self.name, batch, t0, t1)

    def _dispatch(self, batch: List[_Work]) -> List[Any]:
        """One device dispatch for the whole batch; returns per-item
        outputs, order-aligned with ``batch``."""
        head = batch[0]
        if head.fn is not None:
            return [head.fn()]
        filt = head.filt
        if len(batch) == 1 or not hasattr(filt, "invoke_coalesced"):
            return [filt.invoke(w.inputs) for w in batch]
        try:
            if getattr(filt, "supports_donate_coalesce", False):
                # the concatenation is engine-owned scratch the filter may
                # release early (filters/torch_cuda.py). Attribute-gated —
                # passing the kwarg to a filter that lacks it would
                # TypeError into permanent serial fallback
                return filt.invoke_coalesced(
                    [w.inputs for w in batch], donate=True)
            return filt.invoke_coalesced([w.inputs for w in batch])
        except Exception as e:  # noqa: BLE001 — fall back to serial
            self.stats["coalesce_fallbacks"] += 1
            _tel.event_coalesce_fallback(
                head.label, len(batch), f"{type(e).__name__}: {e}")
            return [filt.invoke(w.inputs) for w in batch]

    # -- loop lifecycle ------------------------------------------------------ #
    def start(self) -> None:
        with self._cv:
            if self._running:
                return
            self._running = True
            self._t_started = time.monotonic()
            self._thread = threading.Thread(
                target=self._loop, name=f"sched:{self.name}", daemon=True)
            self._thread.start()
        _tel.event_engine_start(self.name)

    def stop(self) -> None:
        with self._cv:
            if not self._running:
                return
            self._running = False
            self._cv.notify_all()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            join_or_warn(t, f"sched:{self.name}")
        self._thread = None
        # drain the double-buffer window so no work is left unsynced
        while self._inflight_q:
            ev = self._inflight_q.popleft()
            if ev is not None:
                ev.synchronize()
        _tel.event_engine_stop(self.name, batches=self.stats["batches"])

    def _loop(self) -> None:
        while True:
            with self._cv:
                if not self._running:
                    return
            try:
                self.step(block=True)
            except Exception:  # noqa: BLE001 — loop must never die silently
                log.exception("sched %s: dispatch loop error", self.name)

    # -- reporting ----------------------------------------------------------- #
    def pending(self) -> int:
        with self._cv:
            return sum(len(t.queue) for t in self._tenants)

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until every queue is empty (bench/tests barrier). True on
        success."""
        t0 = time.monotonic()
        while self.pending() > 0:
            if time.monotonic() - t0 > timeout:
                return False
            if self._thread is None:
                self.step()
            else:
                time.sleep(0.0005)
        return True

    def coalesce_stats(self) -> Dict[str, float]:
        """Width distribution of recent batches."""
        w = sorted(self.widths)
        if not w:
            return {"median": 0.0, "mean": 0.0, "max": 0, "n": 0}
        return {"median": float(w[len(w) // 2]),
                "mean": sum(w) / len(w), "max": w[-1], "n": len(w)}

    @property
    def busy_seconds(self) -> float:
        """Total dispatch+sync time on the dispatch loop."""
        return self._busy_s

    @property
    def wait_seconds(self) -> float:
        """Total submit→dispatch queue wait across all executed work."""
        return self._wait_s

    def occupancy(self) -> float:
        """Fraction of wall time since start() spent in dispatch+sync — the
        coarse engine-busy signal (host time, not the card's busy share)."""
        if self._t_started is None:
            return 0.0
        wall = max(time.monotonic() - self._t_started, 1e-9)
        return min(self._busy_s / wall, 1.0)
