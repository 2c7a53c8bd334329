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

Deadlines and sessions: ``submit(..., deadline=, session=)`` as in the JAX
engine. A request whose deadline has passed at submit, or while it waits
in the queue, finishes empty without a slot (``resilience.shed``, site
``serving``); ``session`` is recorded on the request and its span. The
obs layers hook in as the JAX engine's do, each a None check while off:
``slo.ENGINE_SLO_HOOK`` (prefill, decode and verify time, and each
request's met/missed/shed outcome), ``diag.DIAG_HOOK`` (each retired
request), ``quality.QUALITY_HOOK`` (the confidence admission below) and
``tune.TUNE_HOOK`` (the chunk and page-size picks at construction, from
the store or cost model only, so constructing an engine never runs on the
card; the draft length re-derived from the accept rate).

With quality on, admission runs a second captured program per signature,
keyed apart by ``conf=True``: the same prefill, which also returns the
entropy, top-1 probability and top-1/top-2 margin of the first-token
logits (``_conf_from_row``). The triple stays on the card until the request
retires, where it is read back outside any capture.

Roles and sessions as in the JAX engine (serving/disagg.py,
fleet/migrate.py, fleet/checkpoint.py): ``role="prefill"`` runs prefill only
(``max_new == 1``) and exports the finished KV pages, ``role="decode"``
splices imported pages (``enqueue_kv_import``, drained at the top of an
iteration) and prefix-hits them; both need the paged cache. A session's
committed token path is recorded at retirement, so ``freeze_session``,
``export_session``, ``checkpoint_session`` and ``adopt_restored_session``
can ship, snapshot and restore it; a frozen session's submits are refused.
A paged engine runs its programs on its pool's stream (the stream current
at construction), and every page import and export, from any thread, is
issued on that stream too.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import weakref
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import graphs
from ..core.hw import resolve_device
from ..models import causal_lm
from .. import tune as _tune
from ..obs import diag as _diag
from ..obs import events as _events
from ..obs import health as _health
from ..obs import metrics as _obs
from ..obs import profile as _profile
from ..obs import quality as _quality
from ..obs import slo as _slo
from ..obs import tracing as _tracing
from ..ops.int8 import stack_shape
from ..resilience import policy as _rp
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


#: disaggregated-serving roles (serving/disagg.py): "prefill" engines run
#: prefill only and export finished KV pages; "decode" engines accept
#: imported pages and decode (they can still re-prefill from scratch when a
#: transfer fails); "unified" is the classic both-phases engine and the
#: default
ROLES = ("unified", "prefill", "decode")

#: bound on the per-engine session→token-path table behind live migration
#: (LRU-evicted; an evicted session migrates by the re-prefill absorb path
#: instead of a page shipment)
SESSION_PATHS_LIMIT = 256

#: weak registry of every constructed engine — the CLI walks it at exit to
#: print per-engine KV summaries without threading a handle through the
#: pipeline graph
_LIVE_ENGINES: "weakref.WeakSet[LMEngine]" = weakref.WeakSet()


def live_engines() -> List["LMEngine"]:
    """Engines constructed in this process and still alive (weak set —
    collected engines drop out). Order is unspecified."""
    return list(_LIVE_ENGINES)


def _conf_key(want_conf: bool) -> Dict[str, bool]:
    """The static keyword that keys the confidence admission apart from
    the plain one in the graph cache; none at all while quality is off, so
    the plain admission's key is the same as without the quality layer."""
    return {"conf": True} if want_conf else {}


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


def _conf_from_row(row: torch.Tensor) -> torch.Tensor:
    """Model-confidence signals from one logits row: Shannon entropy (nats)
    of the softmax, top-1 probability, and the top-1/top-2 probability
    margin — the per-request signal obs/quality records at retirement.
    Returns a (3,) float32 tensor."""
    p = torch.softmax(row.to(torch.float32), dim=-1)
    ent = -torch.sum(torch.where(p > 0, p * torch.log(p),
                                 torch.zeros_like(p)))
    top2 = torch.topk(p, 2).values
    return torch.stack([ent, top2[0], top2[0] - top2[1]])


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
    #: resilience.policy.Deadline (or None): shed instead of admitted once
    #: expired
    deadline: Any = None
    #: routing affinity key (recorded on the request span)
    session: Optional[str] = None
    #: the confidence admission's (3,) card tensor while quality is on
    conf: Any = None
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
                 role: Optional[str] = None,
                 device: Any = None) -> None:
        # prefill/decode chunk: explicit wins; unset consults the autotuner
        # (store/model only — no sweep closure: constructing an engine
        # must never run on the card), else the hand-set 8
        if chunk is None:
            chunk = 8
            tn = _tune.TUNE_HOOK
            if tn is not None:
                chunk = int(tn.pick(
                    "lm_chunk", _tune.device_kind(), "serving.lm",
                    _tune.shape_sig(("slots", n_slots),
                                    ("len", max_len),
                                    ("heads", n_heads)),
                    candidates=(4, 8, 16, 32), default=8))
        if n_slots < 1 or chunk < 1:
            raise ValueError("n_slots and chunk must be >= 1")
        # disaggregated-serving role: explicit argument wins, else the
        # NNS_LM_ROLE environment (the CLI's --role), else unified — the
        # precedence of the NNS_LM_KV_* knobs
        r = role if role is not None \
            else (os.environ.get("NNS_LM_ROLE", "") or "unified")
        if r not in ROLES:
            raise ValueError(
                f"role must be one of {ROLES}, got {r!r}")
        self.role = r
        if spec_draft < 0 or spec_draft + 1 > max_len:
            raise ValueError("spec_draft must be in [0, max_len-1]")
        self.device = self._engine_device(device)
        embed = params["embed"]
        self._check_params(params)
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
        if ps == 0 and kv_page_size is None and _tune.TUNE_HOOK is not None \
                and (kv_pages is not None or _env_int("NNS_LM_KV_PAGES")):
            # a page budget was given without a page granularity: the
            # tuner owns it (store/model only — the same no-dispatch rule
            # as the chunk knob); kv_page_size=0 explicit still pins the
            # contiguous path
            cands = tuple(c for c in (16, 32, 64, 128, 256)
                          if c <= max_len and max_len % c == 0)
            if cands:
                dflt = 64 if 64 in cands else cands[0]
                ps = int(_tune.TUNE_HOOK.pick(
                    "lm_kv_page_size", _tune.device_kind(), "serving.lm",
                    _tune.shape_sig(("len", max_len),
                                    ("heads", n_heads)),
                    candidates=cands, default=dflt))
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
            self._kc, self._vc = self._alloc_slot_caches(n_layers, hd)
        if self.role != "unified" and self._kv is None:
            # the page pool is the transfer substrate: a prefill engine has
            # nothing to export and a decode engine nowhere to splice
            # imports without it
            raise ValueError(
                f"role={self.role!r} requires the paged KV cache "
                f"(set kv_page_size > 0)")
        # cross-backend KV-page imports (serving/disagg.py): documents land
        # here from the wire thread and are spliced by the scheduler thread
        # at the top of each iteration — PagedKVCache itself is
        # single-threaded by contract
        self._kv_imports: deque = deque()
        self._kv_imports_lock = threading.Lock()
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
        # live-migration session state (fleet/migrate.py): the token path
        # each session last committed to the KV cache — what export_session
        # ships — plus the set frozen mid-migration (their submits are
        # refused so the router fails them over to the re-pinned target).
        # LRU-bounded; eviction only costs the evicted session its
        # migration warmth.
        self._session_paths: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._frozen_sessions: set = set()
        # path snapshots taken at freeze time: export_session ships the
        # snapshot, so a retire landing between freeze and export cannot
        # move the exported path under the migrator's feet
        self._frozen_paths: Dict[str, np.ndarray] = {}
        # sessions whose migration was absorbed (resume_session): their next
        # prefill re-derives state the fleet failed to ship, and the diag
        # critical path bills it as re_prefill, not compute
        self._reprefill_sessions: set = set()
        # sessions a crash-restore spliced a checkpoint into
        # (adopt_restored_session): their next prefill rides the imported
        # pages and diag bills it as restore, not re_prefill
        self._restored_sessions: set = set()
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

    # -- device-layout hooks (serving/tp_engine.py overrides them) --------- #

    def _engine_device(self, device: Any) -> torch.device:
        return resolve_device(device)

    def _check_params(self, params: Dict[str, Any]) -> None:
        embed = params["embed"]
        if embed.device != self.device:
            raise ValueError(f"params live on {embed.device}, the engine on "
                             f"{self.device}")

    def _admit_window(self, tokens: torch.Tensor, true_len: torch.Tensor):
        """The contiguous admit prefill's forward: (logits (1, vocab), kc,
        vc, pos) of a right-padded prompt."""
        return causal_lm.lm_prefill_window(self.params, tokens, true_len,
                                           self.n_heads, self.max_len)

    def _step_slots(self, tokens: torch.Tensor, kc: torch.Tensor,
                    vc: torch.Tensor, pos: torch.Tensor):
        """One decode step over every slot's views, written in place."""
        return causal_lm.lm_decode_step_slots(self.params, tokens, kc, vc,
                                              pos, self.n_heads)

    def _window_slots(self, tokens_in: torch.Tensor, kc: torch.Tensor,
                      vc: torch.Tensor, pos: torch.Tensor):
        """One verify window over every contiguous slot, in place."""
        return causal_lm.lm_verify_window_slots(self.params, tokens_in, kc,
                                                vc, pos, self.n_heads)

    def _alloc_slot_caches(self, n_layers: int, hd: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The per-slot K/V stores (leading axis = slot), float32 whatever
        the params' dtype."""
        shape = (self.n_slots, n_layers * self.n_heads, self.max_len, hd)
        return (torch.zeros(shape, dtype=torch.float32, device=self.device),
                torch.zeros(shape, dtype=torch.float32, device=self.device))

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
               top_k: int = 0, top_p: float = 1.0, seed: int = 0,
               deadline: Any = None,
               session: Optional[str] = None) -> int:
        """Queue a generation request; returns its request id. The defaults
        decode greedily; ``seed`` fixes a sampled request's random stream
        (reproducible, independent of what shares the batch).
        ``deadline`` (a resilience.policy.Deadline) enables load shedding:
        a request whose deadline has already expired — at submit, or later
        while still queued at admission — finishes empty at once
        (``resilience.shed``) instead of occupying a slot. ``session`` is
        the routing affinity key: recorded on the request and its span, not
        a scheduling input."""
        p = np.asarray(prompt, np.int32).reshape(-1)
        if p.size < 1:
            self._reject("empty prompt")
            raise ValueError("empty prompt")
        if session is not None and str(session) in self._frozen_sessions:
            # mid-migration: the session's KV pages are in flight to
            # another backend — refusing here makes the router fail the
            # request over to the re-pinned target under its original
            # deadline instead of decoding against a torn cache
            self._reject("session frozen for migration")
            raise ValueError(
                f"session {session!r} is frozen for migration")
        if max_new < 1:
            self._reject("max_new must be >= 1")
            raise ValueError("max_new must be >= 1")
        if self.role == "prefill" and max_new != 1:
            # a prefill engine's product is the KV pages, not tokens: the
            # single generated token only proves exactness (it must match
            # what the decode backend regenerates from the imported prefix)
            self._reject("prefill role accepts max_new=1 only")
            raise ValueError(
                f"role='prefill' engines run prefill only "
                f"(max_new must be 1, got {max_new})")
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
            t_submit=time.monotonic(), deadline=deadline,
            session=str(session) if session is not None else None)
        if deadline is not None and deadline.expired():
            # shed at the door: the caller's budget is already spent, so
            # queueing would only delay everyone behind it
            self._shed_request(req, "deadline expired at submit")
            return rid
        if _tracing.enabled():
            # parent on the caller's current context (an instrumented
            # element chain sets it) so an offloaded request joins the
            # pipeline's trace; without one this roots a fresh trace
            req.span = _tracing.start_span(
                "serving.request", parent=_tracing.current_context(),
                attrs={"engine": self._engine_label, "rid": rid,
                       "prompt_len": int(p.size), "max_new": int(max_new)})
            if req.session is not None:
                req.span.set_attribute("session", req.session)
            if req.span.recording and req.span.context.parent_id is not None:
                # remote-parented request (came in over the query wire):
                # mark the trace so the fleet push exports the engine-side
                # spans — admission, prefill and decode join the client's
                # tree on the aggregator
                _tracing.store().mark_export(req.span.context.trace_id)
            req.wait_span = _tracing.start_span(
                "serving.admission_wait", parent=req.span.context,
                attrs={"queued_behind": len(self._queue)})
        self._queue.append(req)
        return rid

    def _slo_tenant(self) -> str:
        """Tenant name for per-tenant SLO attribution: the sched tenant when
        enrolled on a DeviceEngine, else the engine label."""
        t = self._sched_tenant
        return t.name if t is not None else self._engine_label

    def _shed_request(self, req: _Request, why: str) -> None:
        """Deadline load shedding: finish the request empty right now —
        spending prefill and decode on a result whose deadline has passed
        starves requests that can still meet theirs."""
        self._hc.count("shed")
        self._m_streams.labels(self._engine_label, "shed").inc()
        _rp.record_shed(
            "serving", f"{self._engine_label}: rid {req.rid} shed ({why})",
            engine=self._engine_label, rid=req.rid)
        shook = _slo.ENGINE_SLO_HOOK
        if shook is not None:
            shook.record_shed(
                self._slo_tenant(), "serving",
                wait_s=max(time.monotonic() - req.t_submit, 0.0))
        if req.wait_span is not None:
            req.wait_span.end()
        if req.span is not None:
            req.span.set_attribute("shed", True)
            req.span.end()
        req.done = True
        self._finished[req.rid] = req.out  # empty: the budget was spent

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
        with self._on_stream():
            if self._kv_imports:  # truthiness: free when nothing arrived
                self.drain_kv_imports()
            self._admit()
            self._decode()
        self.stats["wall_s"] += time.monotonic() - t0
        return self.pending() > 0

    def _on_stream(self):
        """Make the page pool's stream current for an iteration (a no-op for
        a contiguous engine or on the CPU), so the programs and the pool's
        imports and exports from other threads share one stream whichever
        thread steps the engine."""
        if self._kv is None:
            return contextlib.nullcontext()
        return self._kv.on_stream()

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

    # -- disaggregated serving (serving/disagg.py) ------------------------- #

    def prefill_and_export(self, prompt: Sequence[int], *,
                           eos: Optional[int] = None,
                           temperature: float = 0.0, top_k: int = 0,
                           top_p: float = 1.0, seed: int = 0,
                           deadline: Any = None,
                           session: Optional[str] = None):
        """Prefill-role entry point: prefill ``prompt`` (max_new=1 — the one
        sampled token proves exactness), then export the finished full-page
        KV path for wire transfer.

        Returns ``(first_token_or_None, export_doc_or_None)``: the token is
        None when the request was shed (expired deadline) and the document
        is None when no full page finished (short prompt) or the pages were
        evicted before export — the decode backend then re-prefills from
        scratch.
        """
        if self._kv is None:
            raise RuntimeError(
                "prefill_and_export requires the paged KV cache")
        p = np.asarray(prompt, np.int32).reshape(-1)
        rid = self.submit(
            p, 1, eos, temperature=temperature, top_k=top_k, top_p=top_p,
            seed=seed, deadline=deadline, session=session)
        self.run()
        out = self._finished.get(rid, [])
        if not out:  # shed at the door or at admission
            return None, None
        return out[0], self._kv.export_pages(p)

    # -- live migration (fleet/migrate.py) --------------------------------- #

    def freeze_session(self, session: str) -> bool:
        """Refuse new submits for ``session`` while its KV pages are in
        flight to another backend. Returns whether the session has a
        recorded token path to export. Requests already in a slot run to
        completion — freezing gates admission, not decode."""
        s = str(session)
        self._frozen_sessions.add(s)
        path = self._session_paths.get(s)
        if path is not None and s not in self._frozen_paths:
            # snapshot the path at freeze time: retires replace (never
            # mutate) the recorded array, so this reference pins exactly
            # the state the freeze observed. Re-freezing keeps the original
            # snapshot (export_session freezes again before exporting)
            self._frozen_paths[s] = path
        return s in self._frozen_paths

    def resume_session(self, session: str) -> None:
        """Lift a migration freeze (the absorb path when the page shipment
        failed and this backend must keep serving)."""
        s = str(session)
        self._frozen_sessions.discard(s)
        self._frozen_paths.pop(s, None)
        self._reprefill_sessions.add(s)

    def export_session(self, session: str) -> Optional[Dict[str, Any]]:
        """Freeze ``session`` and export the KV pages covering its last
        committed token path (``kv_cache.export_pages`` — the document the
        disagg prefill→decode hand-off ships). None when the engine runs
        contiguous, the session is unknown, or its pages were already
        evicted — the migration target then re-prefills.

        Freeze happens first: a ``submit()`` racing this export gets the
        frozen-session error and fails over to the re-pinned target, and the
        exported document covers the freeze-time path snapshot."""
        s = str(session)
        self.freeze_session(s)
        path = self._frozen_paths.get(s)
        if self._kv is None or path is None:
            return None
        return self._kv.export_pages(path)

    # -- crash checkpoint/restore (fleet/checkpoint.py) -------------------- #

    def session_watermarks(self) -> Dict[str, int]:
        """Committed token-path length per live session — the monotone
        checkpoint sequence number. Empty until a session retires a turn."""
        return {s: int(p.size) for s, p in self._session_paths.items()}

    def checkpoint_session(
            self, session: str) -> Optional[Tuple[np.ndarray, Dict[str, Any]]]:
        """Read-only checkpoint snapshot: ``(token_path, pages_doc)`` for the
        session's last committed turn, or None when the session is unknown,
        the engine runs contiguous, or the path's pages were evicted. Unlike
        :meth:`export_session` this does not freeze: ``export_pages`` walks
        the radix tree read-only and reads the pool on its stream."""
        path = self._session_paths.get(str(session))
        if path is None or self._kv is None:
            return None
        doc = self._kv.export_pages(path)
        if doc is None:
            return None
        return path, doc

    def adopt_restored_session(self, session: str, path: Any, *,
                               restored: bool = True) -> None:
        """Crash-restore adoption: record ``path`` as the session's committed
        token path (so the next export or checkpoint works) and tag its next
        prefill for the diag critical path — ``restore`` when a checkpoint's
        pages were spliced, ``re_prefill`` when the stale, corrupt or missing
        fallback recomputes from scratch."""
        s = str(session)
        if path is not None:
            self._record_session_path(s, np.asarray(path, np.int32)
                                      .reshape(-1))
        self._frozen_sessions.discard(s)
        self._frozen_paths.pop(s, None)
        if restored:
            self._restored_sessions.add(s)
            self._reprefill_sessions.discard(s)
        else:
            self._reprefill_sessions.add(s)
            self._restored_sessions.discard(s)

    def _record_session_path(self, session: str, seq: np.ndarray) -> None:
        self._session_paths[session] = seq
        self._session_paths.move_to_end(session)
        while len(self._session_paths) > SESSION_PATHS_LIMIT:
            self._session_paths.popitem(last=False)

    def enqueue_kv_import(self, doc: Dict[str, Any]) -> None:
        """Queue a wire-received page document for splicing (any thread);
        the scheduler thread drains at the top of its next iteration."""
        with self._kv_imports_lock:
            self._kv_imports.append(doc)

    def drain_kv_imports(self) -> int:
        """Splice every queued page document into the pool (scheduler thread
        or a quiesced engine only — PagedKVCache is single-threaded).
        Returns pages spliced; a rejected document (geometry mismatch, pool
        exhaustion) is dropped with a flight-recorder event — the next
        request over that prefix prefills locally."""
        if self._kv is None:
            return 0
        spliced = 0
        while True:
            with self._kv_imports_lock:
                if not self._kv_imports:
                    break
                doc = self._kv_imports.popleft()
            try:
                spliced += self._kv.import_pages(doc)
            except (ValueError, RuntimeError) as e:
                _events.record(
                    "serving.kv_import_reject",
                    f"{self._engine_label}: page import dropped ({e})",
                    severity="warning", engine=self._engine_label)
        return spliced

    # -- scheduler internals ---------------------------------------------- #

    def _admit(self) -> None:
        if self.gang and any(r is not None for r in self._slot_req):
            return  # static batching: wait for the whole gang to finish
        for slot in range(self.n_slots):
            if self._slot_req[slot] is not None or not self._queue:
                continue
            req = self._queue.popleft()
            while req is not None and req.deadline is not None \
                    and req.deadline.expired():
                # expired while queued: shed and give the slot to the next
                # request that can still meet its deadline
                self._shed_request(req, "deadline expired in queue")
                req = self._queue.popleft() if self._queue else None
            if req is None:
                continue
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
                if req.session is not None \
                        and req.session in self._restored_sessions:
                    # first prefill after a checkpoint splice — it rides
                    # the imported radix pages; diag bills it as restore
                    # (cheap) rather than re_prefill (full)
                    self._restored_sessions.discard(req.session)
                    pspan.set_attribute("restore", True)
                elif req.session is not None \
                        and req.session in self._reprefill_sessions:
                    # post-absorb recompute, not fresh work — the diag
                    # critical path bills this span as re_prefill
                    self._reprefill_sessions.discard(req.session)
                    pspan.set_attribute("re_prefill", True)
            tp0 = time.monotonic_ns() \
                if (_profile.ENGINE_HOOK is not None
                    or _slo.ENGINE_SLO_HOOK is not None) else 0
            # obs/quality confidence tap: one None check selects the
            # confidence admission, which also returns the first-token
            # logits' (entropy, top1, margin) for the retire path
            want_conf = _quality.QUALITY_HOOK is not None
            if self._kv is None:
                first = self._prefill_into(slot, padded, t, req, want_conf)
            else:
                first = self._prefill_paged(slot, padded, hit, ts, req,
                                            want_conf)
            if want_conf:
                first, req.conf = first
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
            shook = _slo.ENGINE_SLO_HOOK
            if shook is not None:
                shook.record_engine_phase(
                    self._slo_tenant(), "prefill",
                    (time.monotonic_ns() - tp0) / 1e9)
            if req.span is not None:
                req.decode_span = _tracing.start_span(
                    "serving.decode", parent=req.span.context,
                    attrs={"slot": slot})
            self._pos_host[slot] = t
            self._slot_req[slot] = req
            self._retire_if_done(slot, req)

    def _prefill_into(self, slot: int, padded: np.ndarray, true_len: int,
                      req: _Request, want_conf: bool = False):
        """Prefill one padded prompt, install its cache and sampling state
        into ``slot``; returns the first generated token (a device scalar),
        with the confidence triple when ``want_conf`` (the obs/quality
        admission, a program of its own)."""
        dev = self.device
        self._start_slot(slot, req)
        return self._prefill_prog(
            torch.from_numpy(padded).to(dev),
            torch.full((), true_len, dtype=torch.int32, device=dev),
            torch.full((1,), slot, dtype=torch.int64, device=dev),
            greedy=req.temperature <= 0.0, **_conf_key(want_conf))

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
                         slot: torch.Tensor, *, greedy: bool,
                         conf: bool = False):
        """The admit prefill: tokens (1, bucket), true_len (), slot (1,)
        int64; writes the slot's cache, position and first token. With
        ``conf`` returns (first, the first-token logits' confidence
        triple)."""
        logits, kc, vc, pos = self._admit_window(tokens, true_len)
        # the first token is emitted having consumed true_len tokens
        first = self._first_token(logits[0], true_len, slot, greedy)
        self._kc.index_copy_(0, slot, kc[None])
        self._vc.index_copy_(0, slot, vc[None])
        self._install_slot(slot, pos, first)
        return (first, _conf_from_row(logits[0])) if conf else first

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
                       true_len: int, req: _Request, want_conf: bool = False):
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
            cols=causal_lm.attend_cols(hit + padded.shape[1], self._m_slot),
            **_conf_key(want_conf))

    def _paged_prefill_program(self, tokens: torch.Tensor, pos0: torch.Tensor,
                               true_len: torch.Tensor, slot: torch.Tensor, *,
                               hit: bool, greedy: bool, cols: int,
                               conf: bool = False):
        """The paged admit prefill: tokens (1, bucket), pos0 and true_len (),
        slot (1,) int64; writes the slot's pages, position and first token.
        ``cols``: the columns the window can see (``attend_cols``); with
        ``conf`` returns (first, the confidence triple)."""
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
        return (first, _conf_from_row(logits[0])) if conf else first

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
        shook = _slo.ENGINE_SLO_HOOK
        if shook is not None:
            shook.record_engine_phase(
                self._slo_tenant(), "decode", time.monotonic() - t0)
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
            logits, _, _, pos = self._step_slots(tokens, kc, vc, pos)
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
            logits, _, _, pos_w = self._window_slots(tokens_in, self._kc,
                                                     self._vc, self._pos)
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
        shook = _slo.ENGINE_SLO_HOOK
        if shook is not None:
            shook.record_engine_phase(
                self._slo_tenant(), "verify", time.monotonic() - t0)
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
        if _tune.TUNE_HOOK is not None:
            self._retune_spec_draft()

    #: re-derive the draft length every this many verify iterations
    _SPEC_RETUNE_EVERY = 32
    #: per-dispatch overhead in verify-row equivalents: the fixed cost a
    #: verify window amortizes; it shapes where the accept-rate curve
    #: peaks, not whether speculation runs
    _SPEC_OVERHEAD_ROWS = 4.0

    def _retune_spec_draft(self) -> None:
        """Pick the draft length whose expected tokens per verify cost is
        highest under the observed per-token accept rate a: expected tokens
        for draft k are 1 + a + ... + a^k, the cost is the (k + 1)-row
        window plus the fixed overhead. Closed form, no sweep; reached only
        when speculation is on."""
        it = self.stats["spec_iterations"]
        if self.spec_draft <= 0 or it == 0 \
                or it % self._SPEC_RETUNE_EVERY:
            return
        drafted = self.stats["spec_drafted"]
        if drafted < self._SPEC_RETUNE_EVERY:
            return
        a = min(max(self.stats["spec_accepted"] / drafted, 0.0), 0.99)
        cap = min(16, max(self._m_slot - 1, 1))
        best_k, best_rate = 1, 0.0
        for k in range(1, cap + 1):
            toks = (1.0 - a ** (k + 1)) / (1.0 - a)
            rate = toks / (self._SPEC_OVERHEAD_ROWS + k + 1)
            if rate > best_rate + 1e-9:
                best_k, best_rate = k, rate
        if best_k != self.spec_draft:
            tn = _tune.TUNE_HOOK
            if tn is not None:
                tn.observe(
                    "lm_spec_draft", _tune.device_kind(), "serving.lm",
                    _tune.shape_sig(("len", self.max_len)), best_k)
            self.spec_draft = best_k

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
            shook = _slo.ENGINE_SLO_HOOK
            if shook is not None:
                missed = (req.deadline is not None
                          and req.deadline.expired())
                shook.record_outcome(
                    self._slo_tenant(), "missed" if missed else "met",
                    max(time.monotonic() - req.t_submit, 0.0))
            dhook = _diag.DIAG_HOOK
            if dhook is not None:
                dhook.observe_request(
                    self._engine_label, req.rid, req.session,
                    req.span.context.trace_id
                    if req.span is not None else None,
                    max(time.monotonic() - req.t_submit, 0.0))
            qhook = _quality.QUALITY_HOOK
            if qhook is not None and req.conf is not None:
                # read back the (3,) confidence triple the admission
                # computed on the card: the one added sync of quality, at
                # retirement, outside any capture
                ent, top1, margin = req.conf.cpu().to(torch.float64).tolist()
                qhook.record_confidence(
                    self._engine_label, self._slo_tenant(), req.session,
                    float(ent), float(top1), float(margin))
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
                if req.session is not None:
                    # the committed token path is the session's exportable
                    # KV state — fleet/migrate.py ships the pages covering
                    # it on a scale-in drain
                    self._record_session_path(req.session, seq)
                self._table_host[slot] = 0
            if req.temperature > 0.0:
                # restore greedy defaults so a finished sampled stream does
                # not keep the greedy fast path off for the others
                self._set_controls(slot, 0.0, 0, 1.0)
