"""Continuous batching for causal-LM generation — port of
nnstreamer_tpu/serving/lm_engine.py (the contiguous-KV engine).

S fixed cache slots, one batched decode step over all of them
(``lm_decode_step_slots``), and a host-side iteration-level scheduler that
admits queued prompts into free slots the moment they open: a stream that
finishes frees its slot at the next iteration and the next prompt
prefills into it while the other slots keep decoding.

- **Bucketed prefill.** Prompts are right-padded to a power-of-two bucket
  (from 16, capped at max_len) and prefilled with ``lm_prefill_window``
  (the function of the JAX engine's ``lm_prefill_masked``, computed as one
  verify window at position 0): exact by masking, since padded K/V slots
  are overwritten before any step attends to them. Each row gets the bits
  a decode step or a paged prefix-hit window would give it, so a prompt's
  tokens do not depend on which route admitted it.
- **Chunked decode.** Between scheduler interventions the engine runs
  ``chunk`` decode steps with the tokens fed back on the device and reads
  the chunk's tokens back once. Chunk tails are floored to a power of
  two, as the JAX package does to bound its compiled shapes, so the two
  engines take the same steps. Every slot, empty or not, decodes and
  advances its position each step.
- **Speculative decoding** (``spec_draft`` > 0): prompt-lookup drafts
  verified in one window per iteration, greedy streams only; greedy
  output is unchanged.
- **Paged KV cache** (``kv_page_size`` > 0): the per-slot stores give way
  to one shared page pool (serving/kv_cache.py). Admission is gated on the
  pages a request needs, not on a slot-sized region, prompts sharing a
  prefix share its pages (radix lookup and copy-on-write), and each program
  gathers the slots' pages into the contiguous layout, runs the same step
  forms and scatters back only the touched pages. ``kv_slot_pages`` bounds a
  slot's view (its effective max_len).

Greedy-exactness contract: every stream's output matches isolated
single-stream generation token for token, whatever shares the batch.

Where the JAX engine decides on the device (``jax.lax.cond`` on "all
slots greedy"), this one decides on the host from its slot table, so a
chunk adds no device→host read beyond its tokens. The caches are float32
whatever the params are, and the step forms write them in place.

The JAX engine's jitted programs are CUDA graphs here (core/graphs.py),
one per static signature, sharing one memory pool: the admit prefill keyed
by (bucket, greedy), with the prompt, its true length and the slot as device
inputs and the slot's seed key and sampling controls read from the slot
state (under paging keyed by ("kv", hit > 0, bucket), greedy and the
columns the window can see, the hit length a device input too); the decode
chunk keyed by (steps, greedy), the chunk or one of its power-of-two tails;
the verify window keyed by its width. The slot state (caches or page pools, page table, tokens, positions,
seed keys, controls) is allocated once and every program writes it in
place, so the graphs replay over it. The page table is mirrored on the host
(the scheduler is its only writer) and copied to its device tensor before
each program call, outside any capture; page copies made by the allocator
(copy-on-write, re-uploads) run on the same stream as the programs. On the
CPU, and inside ``graphs.disabled()``, the same programs run eagerly.

``enroll(scheduler)`` makes the engine a tenant of a ``sched.DeviceEngine``:
each iteration then runs on the engine's dispatch thread under its fair
share, beside the pipelines' batches, and the programs capture and replay
there, on the same stream as the allocator's page copies.

Telemetry as in the JAX engine: the ``nnstpu_serving_*`` families
(streams, tokens, TTFT, per-token latency, prefills and first-use buckets,
active slots and queue depth read from host state), a ``kind="serving"``
health component with the "engine warmed" readiness condition, the
``serving.admission_reject`` event, the ``serving.request`` span with its
admission-wait, compile, prefill and decode children, the profiler's
``ENGINE_HOOK`` per prefill, decode chunk and verify window, and
``live_engines()`` (the CLI's per-engine KV exit summary).

Not ported yet (ROADMAP): disaggregation roles, page imports and sessions
(freeze/export/checkpoint), deadlines, the autotuner (its chunk and page
size picks), and the diag, quality and slo hooks (§A7).
"""

from __future__ import annotations

import os
import time
import weakref
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core import graphs
from ..core.hw import resolve_device
from ..models import causal_lm
from ..obs import events as _events
from ..obs import health as _health
from ..obs import metrics as _obs
from ..obs import profile as _profile
from ..obs import tracing as _tracing
from ..ops.int8 import stack_shape
from . import sampling
from .kv_cache import PagedKVCache


def _env_int(name: str) -> Optional[int]:
    """An optional integer environment knob: empty or unset gives None,
    anything else that is not an integer raises naming the variable."""
    v = os.environ.get(name, "")
    if not v:
        return None
    try:
        return int(v)
    except ValueError:
        raise ValueError(f"{name} must be an integer, got {v!r}")


#: weak registry of every constructed engine — the CLI walks it at exit to
#: print per-engine KV summaries without threading a handle through the
#: pipeline graph
_LIVE_ENGINES: "weakref.WeakSet[LMEngine]" = weakref.WeakSet()


def live_engines() -> List["LMEngine"]:
    """Engines constructed in this process and still alive (weak set —
    collected engines drop out). Order is unspecified."""
    return list(_LIVE_ENGINES)


def next_pow2_bucket(n: int, lo: int = 16) -> int:
    """Smallest power of two >= n (floored at ``lo``)."""
    b = lo
    while b < n:
        b *= 2
    return b


def _accept_from_window(tokens_in: torch.Tensor, logits: torch.Tensor,
                        pos_w: torch.Tensor):
    """Per-slot draft acceptance from a verify window's logits. tokens_in
    (S, W); logits (S, W, V); pos_w (S, 1) after the window. Returns
    (carried (S, 1, 1), pos + m, greedy (S, W), m (S,))."""
    w = tokens_in.shape[1]
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)  # (S, W)
    # draft j (column j >= 1) is confirmed iff it equals the model's output
    # at column j - 1 and every earlier draft was confirmed
    ok = (tokens_in[:, 1:] == greedy[:, :-1]).to(torch.int32)
    m = 1 + torch.cumprod(ok, dim=-1).sum(-1)  # (S,) in 1..W
    pos_m = (pos_w - w + m[:, None]).to(torch.int32)
    carried = torch.gather(greedy, 1, (m - 1)[:, None].to(torch.int64))
    return carried[:, :, None], pos_m, greedy, m


@dataclass
class _Request:
    rid: int
    prompt: np.ndarray          # (T,) int32
    max_new: int
    eos: Optional[int]
    temperature: float = 0.0    # <= 0 → greedy
    top_k: int = 0              # <= 0 → disabled
    top_p: float = 1.0          # >= 1 → disabled
    seed: int = 0
    out: List[int] = field(default_factory=list)
    done: bool = False
    #: kv_cache.PageLease while admitted under paging (None otherwise),
    #: released at retirement
    kv_lease: Any = None
    t_submit: float = 0.0       # monotonic stamp for the TTFT histogram
    # span parents admission-wait / prefill / compile / decode children
    span: Any = None            # serving.request — submit → retire
    wait_span: Any = None       # serving.admission_wait — submit → admit
    decode_span: Any = None     # serving.decode — admit → retire


class LMEngine:
    """Continuous-batching engine over one causal LM.

    ``params``/``n_heads``/``max_len`` as for ``models.causal_lm`` (a tree
    of tensors on one device, float or w8a8); ``n_slots`` is the decode
    batch; ``chunk`` the decode steps per scheduler iteration; ``bucket``
    maps a prompt length to its padded prefill length; ``gang=True``
    admits only when every slot is free (static batching, the baseline);
    ``spec_draft`` > 0 turns on speculative decoding. ``device`` is where
    the slot state lives (cuda unless the caller names the CPU); the
    params must be there already.

    Paged KV cache: ``kv_page_size`` > 0 swaps the per-slot stores for a
    shared pool of ``kv_pages`` pages with radix prefix sharing;
    ``kv_slot_pages`` bounds one request's capacity (pages × page size,
    default max_len's worth); ``kv_host_offload`` keeps evicted pages in
    host memory for re-upload. Each defaults from NNS_LM_KV_PAGE_SIZE /
    NNS_LM_KV_PAGES / NNS_LM_KV_SLOT_PAGES / NNS_LM_KV_OFFLOAD (the CLI's
    ``--kv-page-size``/``--kv-pages`` set them); an explicit
    ``kv_page_size=0`` pins the contiguous path whatever the environment.
    """

    def __init__(self, params: Dict[str, Any], n_heads: int, max_len: int,
                 n_slots: int = 4, chunk: Optional[int] = None,
                 bucket=None, gang: bool = False, spec_draft: int = 0,
                 kv_page_size: Optional[int] = None,
                 kv_pages: Optional[int] = None,
                 kv_slot_pages: Optional[int] = None,
                 kv_host_offload: Optional[bool] = None,
                 device: Any = None) -> None:
        chunk = 8 if chunk is None else chunk
        if n_slots < 1 or chunk < 1:
            raise ValueError("n_slots and chunk must be >= 1")
        if spec_draft < 0 or spec_draft + 1 > max_len:
            raise ValueError("spec_draft must be in [0, max_len-1]")
        self.device = resolve_device(device)
        embed = params["embed"]
        if embed.device != self.device:
            raise ValueError(f"params live on {embed.device}, the engine on "
                             f"{self.device}")
        self.params = params
        self.n_heads = n_heads
        self.max_len = max_len
        self.n_slots = n_slots
        self.chunk = chunk
        self.gang = gang
        self.spec_draft = spec_draft
        self._bucket = bucket or (
            lambda n: min(next_pow2_bucket(n), max_len))
        n_layers = stack_shape(params["wqkv"])[0]
        hd = embed.shape[1] // n_heads
        dev = self.device
        # paged-KV configuration: explicit arguments win, unset ones fall
        # back to the NNS_LM_KV_* environment
        ps = kv_page_size if kv_page_size is not None \
            else (_env_int("NNS_LM_KV_PAGE_SIZE") or 0)
        if ps < 0:
            raise ValueError("kv_page_size must be >= 0 (0 = contiguous)")
        self._kv: Optional[PagedKVCache] = None
        self._m_slot = max_len  # one request's token capacity
        self._kc = self._vc = None
        if ps:
            if max_len % ps:
                raise ValueError(
                    f"kv_page_size={ps} must divide max_len={max_len}")
            slot_pages = kv_slot_pages if kv_slot_pages is not None \
                else (_env_int("NNS_LM_KV_SLOT_PAGES") or max_len // ps)
            if not 1 <= slot_pages <= max_len // ps:
                raise ValueError(
                    f"kv_slot_pages={slot_pages} outside "
                    f"[1, max_len/page_size={max_len // ps}]")
            self._m_slot = slot_pages * ps
            if spec_draft + 1 > self._m_slot:
                raise ValueError(
                    f"spec_draft={spec_draft} needs kv_slot_pages * "
                    f"kv_page_size > spec_draft (got {self._m_slot})")
            n_pages = kv_pages if kv_pages is not None \
                else (_env_int("NNS_LM_KV_PAGES") or n_slots * slot_pages)
            offload = kv_host_offload if kv_host_offload is not None \
                else os.environ.get("NNS_LM_KV_OFFLOAD", "") == "1"
            self._kv = PagedKVCache(n_layers, n_heads, ps, n_pages, hd,
                                    host_offload=bool(offload), device=dev,
                                    label=self._engine_label)
            self._kv_slot_pages = slot_pages
            #: per-slot page tables on the host (the scheduler is the only
            #: writer; entries past a request's pages hold the null page 0)
            #: and their device copy, which the programs read
            self._table_host = np.zeros((n_slots, slot_pages), np.int32)
            self._table = torch.zeros((n_slots, slot_pages),
                                      dtype=torch.int64, device=dev)
        else:
            # device-resident per-slot stores (leading axis = slot), float32
            # whatever the params' dtype; the paged engine has none, its
            # K/V live in the page pool
            shape = (n_slots, n_layers * n_heads, max_len, hd)
            self._kc = torch.zeros(shape, dtype=torch.float32, device=dev)
            self._vc = torch.zeros(shape, dtype=torch.float32, device=dev)
        self._tokens = torch.zeros((n_slots, 1, 1), dtype=torch.int32,
                                   device=dev)
        self._pos = torch.zeros((n_slots, 1), dtype=torch.int32, device=dev)
        self._skeys = torch.zeros((n_slots, 2), dtype=torch.int64, device=dev)
        self._temp = torch.zeros((n_slots,), dtype=torch.float32, device=dev)
        self._topk = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
        self._topp = torch.ones((n_slots,), dtype=torch.float32, device=dev)
        # the programs, one graph per signature each, one pool
        pool = graphs.Pool()
        self._prefill_prog = graphs.CapturedFn(
            self._prefill_program, "LMEngine admit prefill", pool, dev)
        self._paged_prefill_prog = graphs.CapturedFn(
            self._paged_prefill_program, "LMEngine paged admit prefill",
            pool, dev)
        self._chunk_prog = graphs.CapturedFn(
            self._chunk_program, "LMEngine decode chunk", pool, dev)
        self._verify_prog = graphs.CapturedFn(
            self._verify_program, "LMEngine verify window", pool, dev)
        # host-side scheduler state: positions are deterministic (true_len
        # at admission, +n per chunk), so capacity checks read no device
        # value; the temperature mirror picks the greedy fast path
        self._pos_host: List[int] = [0] * n_slots
        self._temp_host: List[float] = [0.0] * n_slots
        self._slot_req: List[Optional[_Request]] = [None] * n_slots
        self._queue: deque = deque()
        self._finished: Dict[int, List[int]] = {}
        self._next_rid = 0
        # decode_steps/slot_steps/wasted_slot_steps account the chunk path
        # only; speculative iterations are in the spec_* keys
        self.stats = {"prefills": 0, "decode_steps": 0,
                      "slot_steps": 0, "wasted_slot_steps": 0,
                      "tokens_out": 0, "wall_s": 0.0,
                      "spec_iterations": 0, "spec_drafted": 0,
                      "spec_accepted": 0}
        # sched.DeviceEngine tenancy (enroll()/unenroll()); None means
        # step_iteration runs direct
        self._sched_tenant = None
        self._sched_engine = None
        self._init_metrics()
        self._init_health()
        _LIVE_ENGINES.add(self)

    #: the engine's tenant name on a DeviceEngine (``--sched-tenants lm:W``)
    #: and its label in the metric series
    _engine_label = "lm"

    def _init_metrics(self) -> None:
        """Register the serving metric families. Handles are real whether
        or not collection is enabled — recording is the registry's cheap
        no-op when it is off. Depth-style gauges read the host-side slot
        table and queue through weakrefs at collection time (never a card
        tensor: a scrape runs on the exporter's thread, mid-capture)."""
        reg = _obs.registry()
        lbl = self._engine_label
        self._m_streams = reg.counter(
            "nnstpu_serving_streams_total",
            "Streams admitted into slots / completed",
            ("engine", "event"))
        self._m_tokens = reg.counter(
            "nnstpu_serving_tokens_total",
            "Generated tokens across completed streams",
            ("engine",)).labels(lbl)
        self._m_ttft = reg.histogram(
            "nnstpu_serving_ttft_seconds",
            "Submit-to-first-token latency", ("engine",)).labels(lbl)
        self._m_tok_lat = reg.histogram(
            "nnstpu_serving_token_latency_seconds",
            "Per-token decode latency (chunk wall / steps, sampled "
            "once per chunk)", ("engine",)).labels(lbl)
        self._m_prefills = reg.counter(
            "nnstpu_serving_prefills_total",
            "Prompt prefills by padded bucket length",
            ("engine", "bucket"))
        self._m_compiles = reg.counter(
            "nnstpu_serving_prefill_compiles_total",
            "First-use prefill buckets (each is one program capture)",
            ("engine", "bucket"))
        self._seen_buckets: set = set()
        # gauges sample the MOST RECENTLY constructed engine per label
        ref = weakref.ref(self)
        reg.gauge(
            "nnstpu_serving_active_slots",
            "Slots currently occupied by a live stream",
            ("engine",)).labels(lbl).set_function(
                lambda: sum(r is not None for r in ref()._slot_req)
                if ref() is not None else 0)
        reg.gauge(
            "nnstpu_serving_queue_depth",
            "Requests queued awaiting a free slot",
            ("engine",)).labels(lbl).set_function(
                lambda: len(ref()._queue) if ref() is not None else 0)

    def _init_health(self) -> None:
        """Register the engine's health component + warmed-readiness
        condition (obs/health.py): the watchdog's admission-stall rule
        reads ``oldest_wait_s`` from the probe; /readyz reads "first
        bucket captured" from the condition. Both go through weakrefs and
        host state; both are the shared no-op while health is off."""
        lbl = self._engine_label
        ref = weakref.ref(self)

        def probe():
            eng = ref()
            if eng is None:
                return None
            oldest = min((r.t_submit for r in eng._queue), default=None)
            return {
                "queued": len(eng._queue),
                "active": sum(r is not None for r in eng._slot_req),
                "warmed": bool(eng._seen_buckets),
                "oldest_wait_s": (time.monotonic() - oldest)
                if oldest is not None else 0.0,
            }

        self._hc = _health.component(
            f"serving.engine:{lbl}", kind="serving", probe=probe,
            attrs={"engine": lbl})
        _health.add_readiness(
            f"engine:{lbl}",
            lambda: (lambda e: None if e is None
                     else bool(e._seen_buckets))(ref()))

    # -- public API ------------------------------------------------------- #

    def submit(self, prompt: Sequence[int], max_new: int,
               eos: Optional[int] = None, *, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 1.0, seed: int = 0) -> int:
        """Queue a generation request; returns its request id. The defaults
        decode greedily; ``seed`` fixes a sampled request's random stream
        (reproducible, independent of what shares the batch)."""
        p = np.asarray(prompt, np.int32).reshape(-1)
        if p.size < 1:
            self._reject("empty prompt")
            raise ValueError("empty prompt")
        if max_new < 1:
            self._reject("max_new must be >= 1")
            raise ValueError("max_new must be >= 1")
        if p.size + max_new - 1 > self.max_len:
            # the last generated token needs no cache slot, hence -1
            self._reject("prompt + max_new exceeds cache capacity")
            raise ValueError(
                f"prompt ({p.size}) + max_new ({max_new}) exceeds cache "
                f"capacity max_len={self.max_len}")
        if self._kv is not None:
            if p.size + max_new - 1 > self._m_slot:
                self._reject("prompt + max_new exceeds paged slot view")
                raise ValueError(
                    f"prompt ({p.size}) + max_new ({max_new}) exceeds "
                    f"paged per-request capacity kv_slot_pages * "
                    f"kv_page_size = {self._m_slot}")
            need = -(-(p.size + max_new - 1) // self._kv.page_size)
            if need > self._kv.n_pages:
                # would deadlock admission: even an empty pool could never
                # cover this request's reservation
                self._reject("request page budget exceeds pool")
                raise ValueError(
                    f"request needs {need} KV pages but the pool has "
                    f"only kv_pages={self._kv.n_pages}")
        rid = self._next_rid
        self._next_rid += 1
        req = _Request(
            rid, p, max_new, eos, temperature=float(temperature),
            top_k=int(top_k), top_p=float(top_p), seed=int(seed),
            t_submit=time.monotonic())
        if _tracing.enabled():
            # parent on the caller's current context (an instrumented
            # element chain sets it) so an offloaded request joins the
            # pipeline's trace; without one this roots a fresh trace
            req.span = _tracing.start_span(
                "serving.request", parent=_tracing.current_context(),
                attrs={"engine": self._engine_label, "rid": rid,
                       "prompt_len": int(p.size), "max_new": int(max_new)})
            req.wait_span = _tracing.start_span(
                "serving.admission_wait", parent=req.span.context,
                attrs={"queued_behind": len(self._queue)})
        self._queue.append(req)
        return rid

    def _reject(self, reason: str) -> None:
        """Flight-recorder entry for an admission rejection — one flag
        check while events are off."""
        self._hc.count("rejected")
        _events.record("serving.admission_reject",
                       f"{self._engine_label}: {reason}",
                       severity="warning", engine=self._engine_label,
                       reason=reason)

    def pending(self) -> int:
        return len(self._queue) + sum(r is not None for r in self._slot_req)

    def step_iteration(self) -> bool:
        """One scheduler iteration: admit into free slots, then one decode
        chunk (or verify window). Returns True while work remains. When
        enrolled as a sched.DeviceEngine tenant, the iteration runs under
        the engine's deficit-round-robin fair share, on its dispatch
        thread, so serving steps and pipeline batches interleave on one
        card."""
        tenant = self._sched_tenant
        if tenant is not None:
            ret = tenant.call(self._step_direct,
                              label=f"{self._engine_label}.step")
            # SHED only fires when the tenant carries a default deadline;
            # the iteration didn't run, so work remains
            return True if not isinstance(ret, bool) else ret
        return self._step_direct()

    def _step_direct(self) -> bool:
        t0 = time.monotonic()
        self._admit()
        self._decode()
        self.stats["wall_s"] += time.monotonic() - t0
        return self.pending() > 0

    # -- sched.DeviceEngine tenancy ---------------------------------------- #
    def enroll(self, scheduler: Any, *, name: Optional[str] = None,
               weight: float = 1.0, priority: int = 0) -> None:
        """Share the card with streaming pipelines: register this engine as
        a tenant of a ``sched.DeviceEngine``. Subsequent ``step_iteration``
        calls queue as opaque tenant work, so serving iterations and
        pipeline batches take turns under one deficit-round-robin fairness.
        Re-enrolling moves the engine to the new scheduler."""
        self.unenroll()
        self._sched_tenant = scheduler.register(
            name or self._engine_label, weight=weight, priority=priority)
        self._sched_engine = scheduler

    def unenroll(self) -> None:
        """Detach from the scheduler (no-op when not enrolled);
        step_iteration goes back to direct execution."""
        tenant, eng = self._sched_tenant, self._sched_engine
        self._sched_tenant = None
        self._sched_engine = None
        if tenant is not None and eng is not None:
            eng.deregister(tenant)

    def run(self) -> Dict[int, List[int]]:
        """Drive until every request finishes; returns {request id:
        generated tokens}."""
        while self.step_iteration():
            pass
        return dict(self._finished)

    @property
    def results(self) -> Dict[int, List[int]]:
        return dict(self._finished)

    @property
    def kv_stats(self) -> Optional[Dict[str, int]]:
        """Paged-KV-cache counters (hit and prompt tokens, COW copies,
        evictions, pages_peak, ...), or None when running contiguous."""
        return None if self._kv is None else dict(self._kv.stats)

    @property
    def prefix_hit_rate(self) -> Optional[float]:
        """Fraction of prompt tokens served from the radix prefix cache
        (0.0 before any lookup); None when running contiguous."""
        return None if self._kv is None else self._kv.prefix_hit_rate()

    def kv_prefix_digest(self, max_entries: int = 64) -> List[str]:
        """Bounded radix-prefix digest: chained path hashes a prefix-aware
        router probes. Empty when running contiguous."""
        return [] if self._kv is None else self._kv.prefix_digest(max_entries)

    # -- scheduler internals ---------------------------------------------- #

    def _admit(self) -> None:
        if self.gang and any(r is not None for r in self._slot_req):
            return  # static batching: wait for the whole gang to finish
        for slot in range(self.n_slots):
            if self._slot_req[slot] is not None or not self._queue:
                continue
            req = self._queue.popleft()
            t = int(req.prompt.size)
            plan = None
            if self._kv is not None:
                plan = self._paged_plan(req)
                if plan is None:
                    # the pool cannot cover this request's reservation yet:
                    # requeue at the front (FIFO, no starvation by smaller
                    # latecomers) and stop admitting; pages free as active
                    # streams retire
                    self._queue.appendleft(req)
                    break
            if req.wait_span is not None:
                req.wait_span.end()
            hit = self._paged_admit(slot, req, plan) \
                if self._kv is not None else 0
            ts = t - hit  # suffix tokens the prefill must still compute
            tb = self._bucket(t) if self._kv is None \
                else min(self._bucket(ts), self._m_slot)
            padded = np.zeros((1, tb), np.int32)
            padded[0, :ts] = req.prompt[hit:]
            # the paged programs are distinct from the contiguous one (and
            # the prefix-hit suffix prefill from the no-hit install), so
            # they warm separate bucket entries / compile counters
            bkey: Any = tb if self._kv is None else ("kv", hit > 0, tb)
            blabel = str(tb) if self._kv is None or not hit else f"kv{tb}"
            first_use = bkey not in self._seen_buckets
            pspan = cspan = _tracing.NOOP_SPAN
            if req.span is not None:
                if first_use:
                    # the first call of a signature captures its graph;
                    # ending after the prefill call bounds the capture
                    cspan = _tracing.start_span(
                        "serving.compile", parent=req.span.context,
                        attrs={"bucket": tb, "kernel": "prefill"})
                pspan = _tracing.start_span(
                    "serving.prefill", parent=req.span.context,
                    attrs={"bucket": tb, "slot": slot})
            tp0 = time.monotonic_ns() \
                if _profile.ENGINE_HOOK is not None else 0
            if self._kv is None:
                first = self._prefill_into(slot, padded, t, req)
            else:
                first = self._prefill_paged(slot, padded, hit, ts, req)
            cspan.end()
            self.stats["prefills"] += 1
            lbl = self._engine_label
            self._m_prefills.labels(lbl, blabel).inc()
            if first_use:
                self._seen_buckets.add(bkey)
                self._m_compiles.labels(lbl, blabel).inc()
            self._m_streams.labels(lbl, "admitted").inc()
            req.out.append(int(first))
            # TTFT after the int() read-back: the first token exists for
            # the caller once it is on the host
            self._m_ttft.observe(time.monotonic() - req.t_submit)
            pspan.end()  # the prefill span covers the first token's read
            if _profile.ENGINE_HOOK is not None:
                # the int(first) read above waited for the prefill, so the
                # interval is device-bound; first-use intervals are
                # capture-dominated and recorded as such
                _profile.ENGINE_HOOK.record_engine(
                    self, "prefill", tp0, time.monotonic_ns(),
                    tokens=t, steps=1, compiled=first_use,
                    bucket=blabel, slot=slot)
            if req.span is not None:
                req.decode_span = _tracing.start_span(
                    "serving.decode", parent=req.span.context,
                    attrs={"slot": slot})
            self._pos_host[slot] = t
            self._slot_req[slot] = req
            self._retire_if_done(slot, req)

    def _prefill_into(self, slot: int, padded: np.ndarray, true_len: int,
                      req: _Request) -> torch.Tensor:
        """Prefill one padded prompt, install its cache and sampling state
        into ``slot``; returns the first generated token (a device scalar)."""
        dev = self.device
        self._start_slot(slot, req)
        return self._prefill_prog(
            torch.from_numpy(padded).to(dev),
            torch.full((), true_len, dtype=torch.int32, device=dev),
            torch.full((1,), slot, dtype=torch.int64, device=dev),
            greedy=req.temperature <= 0.0)

    def _start_slot(self, slot: int, req: _Request) -> None:
        """The slot's seed key and sampling controls for ``req``."""
        self._skeys[slot] = sampling.seed_key(req.seed, self.device)
        self._set_controls(slot, req.temperature, req.top_k, req.top_p)

    def _first_token(self, logits: torch.Tensor, consumed: torch.Tensor,
                     slot: torch.Tensor, greedy: bool) -> torch.Tensor:
        """The first generated token from the prefill's last-row logits
        (V,): argmax, or a draw keyed by the slot's seed folded with the
        tokens consumed."""
        if greedy:  # skips the sampler's sort/softmax/cumsum
            return torch.argmax(logits, dim=-1).to(torch.int32)
        key = sampling.fold_in(self._skeys.index_select(0, slot)[0], consumed)
        return sampling.sample_row(
            logits, key, self._temp.index_select(0, slot),
            self._topk.index_select(0, slot),
            self._topp.index_select(0, slot))

    def _prefill_program(self, tokens: torch.Tensor, true_len: torch.Tensor,
                         slot: torch.Tensor, *, greedy: bool) -> torch.Tensor:
        """The admit prefill: tokens (1, bucket), true_len (), slot (1,)
        int64; writes the slot's cache, position and first token."""
        logits, kc, vc, pos = causal_lm.lm_prefill_window(
            self.params, tokens, true_len, self.n_heads, self.max_len)
        # the first token is emitted having consumed true_len tokens
        first = self._first_token(logits[0], true_len, slot, greedy)
        self._kc.index_copy_(0, slot, kc[None])
        self._vc.index_copy_(0, slot, vc[None])
        self._install_slot(slot, pos, first)
        return first

    def _install_slot(self, slot: torch.Tensor, pos: torch.Tensor,
                      first: torch.Tensor) -> None:
        self._pos.index_copy_(0, slot, pos.reshape(1, 1))
        self._tokens.index_copy_(0, slot, first.reshape(1, 1, 1))

    def _set_controls(self, slot: int, temperature: float, top_k: int,
                      top_p: float) -> None:
        self._temp[slot] = temperature
        self._topk[slot] = top_k
        self._topp[slot] = top_p
        self._temp_host[slot] = temperature

    # -- paged-KV scheduling ---------------------------------------------- #

    def _paged_plan(self, req: _Request):
        """Radix lookup, hit trimming and admissibility for one queued
        request: the plan to commit, or None while the pool cannot cover
        the request's page reservation."""
        kv = self._kv
        t = int(req.prompt.size)
        plan = kv.lookup(req.prompt)
        # the suffix prefills as a padded window at pos0 = hit, so the hit
        # plus the padded bucket width must fit the slot view; trim the hit
        # (COW tail first, then the deepest node) until it does
        while plan.hit_len and plan.hit_len + min(
                self._bucket(t - plan.hit_len), self._m_slot) > self._m_slot:
            plan.drop_tail()
        b_needed = -(-(t + req.max_new - 1) // kv.page_size)
        return plan if kv.admissible(plan, b_needed) else None

    def _paged_admit(self, slot: int, req: _Request, plan) -> int:
        """Commit the plan (pin shared pages, COW-copy the partial match,
        allocate private prompt pages) and write the slot's page-table row.
        Returns the prefix-hit length in tokens, where the suffix prefill
        starts."""
        kv = self._kv
        t = int(req.prompt.size)
        b_needed = -(-(t + req.max_new - 1) // kv.page_size)
        lease = kv.admit(plan, b_needed)
        req.kv_lease = lease
        row = np.zeros(self._kv_slot_pages, np.int32)
        row[:len(lease.pages)] = lease.pages
        self._table_host[slot] = row
        return lease.hit_len

    def _sync_table(self) -> None:
        """Copy the host page table to its device tensor: one host-to-device
        copy on the engine's stream, before a program call and outside any
        capture, so a replay reads this iteration's table."""
        self._table.copy_(torch.from_numpy(self._table_host))

    def _prefill_paged(self, slot: int, padded: np.ndarray, hit: int,
                       true_len: int, req: _Request) -> torch.Tensor:
        """Prefill into the slot's pages; returns the first token (a device
        scalar). With no hit, the unchanged admit prefill at the slot view's
        capacity, its cache scattered into the pages; with a hit, only the
        padded suffix window at pos0 = hit against the gathered view."""
        dev = self.device
        self._start_slot(slot, req)
        self._sync_table()
        return self._paged_prefill_prog(
            torch.from_numpy(padded).to(dev),
            torch.full((), hit, dtype=torch.int32, device=dev),
            torch.full((), true_len, dtype=torch.int32, device=dev),
            torch.full((1,), slot, dtype=torch.int64, device=dev),
            hit=hit > 0, greedy=req.temperature <= 0.0,
            cols=causal_lm.attend_cols(hit + padded.shape[1], self._m_slot))

    def _paged_prefill_program(self, tokens: torch.Tensor, pos0: torch.Tensor,
                               true_len: torch.Tensor, slot: torch.Tensor, *,
                               hit: bool, greedy: bool, cols: int) -> torch.Tensor:
        """The paged admit prefill: tokens (1, bucket), pos0 and true_len (),
        slot (1,) int64; writes the slot's pages, position and first token.
        ``cols``: the columns the window can see (``attend_cols``)."""
        kv = self._kv
        table = self._table.index_select(0, slot)[0]  # (B,)
        if hit:
            logits, _, _, pos = causal_lm.lm_prefill_paged(
                self.params, tokens, kv.kpool, kv.vpool, table, pos0,
                true_len, self.n_heads, cols)
        else:
            logits, kc, vc, pos = causal_lm.lm_prefill_window(
                self.params, tokens, true_len, self.n_heads, self._m_slot)
            # rows past the prompt's pages hold the null page: the padded
            # tail's garbage K/V lands there, never in live pages
            lh, m, hd = kc.shape
            b = table.shape[0]
            for pool, c in ((kv.kpool, kc), (kv.vpool, vc)):
                pool.index_copy_(0, table, c.view(lh, b, m // b, hd)
                                 .transpose(0, 1))
        # the sampling key folds in pos0 + true_len, the tokens consumed, so
        # a prefix-hit admission draws what a full prefill would
        first = self._first_token(logits[0], pos0 + true_len, slot, greedy)
        self._install_slot(slot, pos, first)
        return first

    def _ensure_pages(self, active: List[int], w: int) -> None:
        """Grow the active slots' page tables to cover the next ``w`` write
        positions, capped at each request's reservation bound (writes past
        it go to the null page by table construction). Cannot fail:
        admission reserved the full budget."""
        kv = self._kv
        ps = kv.page_size
        for s in active:
            req = self._slot_req[s]
            lease = req.kv_lease
            bound = int(req.prompt.size) + req.max_new - 1
            need = -(-min(self._pos_host[s] + w, bound) // ps)
            while len(lease.pages) < need:
                pid = kv.lease_alloc(lease)
                self._table_host[s, len(lease.pages) - 1] = pid

    def _decode(self) -> None:
        active = [s for s, r in enumerate(self._slot_req) if r is not None]
        if not active:
            return
        # per-request capacity: max_len contiguous, the slot view's
        # kv_slot_pages * page_size under paging (admission reserved every
        # active request's pages, so pool headroom is no gate)
        headroom = self._m_slot - max(self._pos_host[s] for s in active)
        if self.spec_draft > 0 and headroom >= self.spec_draft + 1 \
                and all(self._slot_req[s].temperature <= 0.0
                        for s in active) \
                and any(self._slot_req[s].max_new - len(self._slot_req[s].out)
                        > 1 for s in active):
            # a verify window writes spec_draft + 1 cache slots; near
            # capacity, with a sampled stream, or when every stream needs
            # at most one more token, plain chunks serve better
            if self._kv is not None:
                self._ensure_pages(active, self.spec_draft + 1)
            self._decode_speculative(active)
            return
        # cap the chunk so no active slot decodes past capacity
        remaining = max(r.max_new - len(r.out) for r in self._slot_req
                        if r is not None)
        n = max(1, min(self.chunk, headroom, remaining))
        if n < self.chunk:
            n = 1 << (n.bit_length() - 1)  # power-of-two tails
        if self._kv is not None:
            self._ensure_pages(active, n)
        t0 = time.monotonic()
        outs = self._run_chunk(n).cpu().numpy()  # (S, n)
        self._m_tok_lat.observe((time.monotonic() - t0) / n)
        if _profile.ENGINE_HOOK is not None:
            # the read-back waited for the chunk: wall ≈ device time; the
            # occupancy sample drives the Perfetto serving counter lane
            _profile.ENGINE_HOOK.record_engine(
                self, "decode", int(t0 * 1e9), time.monotonic_ns(),
                tokens=n * len(active), steps=n, active=len(active),
                queued=len(self._queue), slots=self.n_slots)
        for s in range(self.n_slots):
            self._pos_host[s] += n  # every slot's position advances
        self.stats["decode_steps"] += n
        self.stats["slot_steps"] += n * len(active)
        for slot in active:
            req = self._slot_req[slot]
            for i in range(n):
                if req.done or len(req.out) >= req.max_new:
                    # slots x steps = kept tokens + wasted
                    self.stats["wasted_slot_steps"] += 1
                    continue
                tok = int(outs[slot, i])
                req.out.append(tok)
                if req.eos is not None and tok == req.eos:
                    req.done = True  # the chunk's tail counts as waste
            self._retire_if_done(slot, req)
        # slot-steps spent by empty slots decoding garbage
        self.stats["wasted_slot_steps"] += n * (self.n_slots - len(active))

    def _run_chunk(self, n: int) -> torch.Tensor:
        """Run ``n`` decode steps over all slots with the tokens fed back on
        the device; returns the (S, n) generated tokens (on the device)."""
        if self._kv is not None:
            self._sync_table()
        return self._chunk_prog(
            n=n, greedy=all(t <= 0.0 for t in self._temp_host))

    def _chunk_program(self, *, n: int, greedy: bool) -> torch.Tensor:
        """The decode chunk: ``n`` steps from the slot state, which it
        advances in place; returns the (S, n) tokens. Under paging the
        slots' views are gathered once, the n steps run on them, and only
        the pages an n-step window can touch are scattered back."""
        kv = self._kv
        if kv is None:
            kc, vc = self._kc, self._vc
        else:
            kc = causal_lm.paged_view_slots(kv.kpool, self._table)
            vc = causal_lm.paged_view_slots(kv.vpool, self._table)
        tokens, pos, outs = self._tokens, self._pos, []
        for _ in range(n):
            logits, _, _, pos = causal_lm.lm_decode_step_slots(
                self.params, tokens, kc, vc, pos, self.n_heads)
            if greedy:  # skips the sampler's sort/softmax/cumsum
                nxt = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
            else:
                # pos is post-step = tokens consumed: keys depend on
                # (seed, consumed) only
                keys = sampling.step_keys(self._skeys, pos[:, 0])
                nxt = sampling.sample_logits(logits[:, 0], keys, self._temp,
                                             self._topk, self._topp)
            tokens = nxt[:, None, None]
            outs.append(nxt)
        if kv is not None:
            # the write positions the chunk started from: self._pos, still
            # unchanged here
            nt = causal_lm.paged_touch_span(n, kv.page_size,
                                            self._kv_slot_pages)
            p0s = self._pos[:, 0]
            causal_lm.paged_update_slots(kv.kpool, kc, self._table, p0s, nt)
            causal_lm.paged_update_slots(kv.vpool, vc, self._table, p0s, nt)
        self._tokens.copy_(tokens)
        self._pos.copy_(pos)
        return torch.stack(outs, dim=1)

    def _verify_program(self, drafts: torch.Tensor):
        """One speculative verify window over all slots, the slot's last
        token then its (S, g) drafts: advances the tokens and positions in
        place past each slot's accepted drafts; returns (greedy (S, W),
        m (S,))."""
        tokens_in = torch.cat([self._tokens[:, 0], drafts], dim=1)
        if self._kv is None:
            logits, _, _, pos_w = causal_lm.lm_verify_window_slots(
                self.params, tokens_in, self._kc, self._vc, self._pos,
                self.n_heads)
        else:
            logits, _, _, pos_w = causal_lm.lm_verify_window_paged(
                self.params, tokens_in, self._kv.kpool, self._kv.vpool,
                self._table, self._pos, self.n_heads)
        carried, pos_m, greedy, m = _accept_from_window(tokens_in, logits,
                                                        pos_w)
        self._tokens.copy_(carried)
        self._pos.copy_(pos_m)
        return greedy, m

    def _decode_speculative(self, active: List[int]) -> None:
        """One speculative iteration: host-drafted prompt-lookup tokens
        verified in one window; each slot's acceptance rolls its position
        back past rejected drafts (their K/V are overwritten before they
        can be attended to)."""
        g = self.spec_draft
        drafts = np.zeros((self.n_slots, g), np.int32)
        for s in active:
            drafts[s] = self._draft_tokens(self._slot_req[s], g)
        if self._kv is not None:
            self._sync_table()
        t0 = time.monotonic()
        outs, m = self._verify_prog(torch.from_numpy(drafts).to(self.device))
        outs = outs.cpu().numpy()
        m = m.cpu().numpy()
        # per-token latency of the verify window: wall over the mean
        # accepted tokens across active slots
        accepted = float(np.mean(m[active])) if active else 1.0
        self._m_tok_lat.observe(
            (time.monotonic() - t0) / max(accepted, 1.0))
        if _profile.ENGINE_HOOK is not None:
            _profile.ENGINE_HOOK.record_engine(
                self, "verify", int(t0 * 1e9), time.monotonic_ns(),
                tokens=int(np.sum(m[active])) if active else 0, steps=1,
                active=len(active), queued=len(self._queue),
                slots=self.n_slots, draft=g)
        for s in range(self.n_slots):
            self._pos_host[s] += int(m[s])
        self.stats["spec_iterations"] += 1
        for slot in active:
            req = self._slot_req[slot]
            took = 0
            for i in range(int(m[slot])):
                if req.done or len(req.out) >= req.max_new:
                    break
                tok = int(outs[slot, i])
                req.out.append(tok)
                took += 1
                if req.eos is not None and tok == req.eos:
                    req.done = True
            self.stats["spec_drafted"] += g
            # tokens beyond the first are the speculation's win
            self.stats["spec_accepted"] += max(0, took - 1)
            self._retire_if_done(slot, req)

    @staticmethod
    def _draft_tokens(req: _Request, g: int) -> np.ndarray:
        """Prompt-lookup drafting: the last earlier occurrence of the
        stream's trailing n-gram (n = 3, 2, 1) in its own history proposes
        the g tokens that followed it (padded by repetition)."""
        hist = np.concatenate([req.prompt, np.asarray(req.out, np.int32)])
        for n in (3, 2, 1):
            if len(hist) <= n:
                continue
            pat = hist[-n:]
            windows = np.lib.stride_tricks.sliding_window_view(hist[:-1], n)
            hits = np.flatnonzero((windows == pat).all(1))
            if len(hits):
                i = int(hits[-1])
                cont = hist[i + n:i + n + g]
                out = np.full(g, int(cont[-1]), np.int32)
                out[:len(cont)] = cont
                return out
        return np.full(g, int(hist[-1]), np.int32)

    def _retire_if_done(self, slot: int, req: _Request) -> None:
        # both append sites stop at an eos token, so eos can only be last
        hit_eos = req.eos is not None and bool(req.out) \
            and req.out[-1] == req.eos
        if hit_eos or len(req.out) >= req.max_new:
            req.done = True
            if req.decode_span is not None:
                # tokens-per-decode-span: with the span duration this yields
                # the request's realized per-token decode latency
                req.decode_span.set_attribute("tokens", len(req.out) - 1)
                req.decode_span.end()
            if req.span is not None:
                req.span.set_attribute("tokens", len(req.out))
                req.span.end()
            self.stats["tokens_out"] += len(req.out)
            self._m_streams.labels(self._engine_label, "completed").inc()
            self._m_tokens.inc(len(req.out))
            self._finished[req.rid] = req.out
            self._slot_req[slot] = None
            if req.kv_lease is not None:
                # positions 0..consumed-1 hold valid K/V (the last output
                # token was never written back): their full pages register
                # as shareable prefix nodes, the rest are freed
                seq = req.prompt if len(req.out) <= 1 else np.concatenate(
                    [req.prompt, np.asarray(req.out[:-1], np.int32)])
                self._kv.release(req.kv_lease, seq)
                req.kv_lease = None
                self._table_host[slot] = 0
            if req.temperature > 0.0:
                # restore greedy defaults so a finished sampled stream does
                # not keep the greedy fast path off for the others
                self._set_controls(slot, 0.0, 0, 1.0)
