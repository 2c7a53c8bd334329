"""Continuous batching for causal-LM generation — port of
nnstreamer_tpu/serving/lm_engine.py (the contiguous-KV engine).

S fixed cache slots, one batched decode step over all of them
(``lm_decode_step_slots``), and a host-side iteration-level scheduler that
admits queued prompts into free slots the moment they open: a stream that
finishes frees its slot at the next iteration and the next prompt
prefills into it while the other slots keep decoding.

- **Bucketed prefill.** Prompts are right-padded to a power-of-two bucket
  (from 16, capped at max_len) and prefilled with ``lm_prefill_masked``:
  exact by masking, since padded K/V slots are overwritten before any
  step attends to them.
- **Chunked decode.** Between scheduler interventions the engine runs
  ``chunk`` decode steps with the tokens fed back on the device and reads
  the chunk's tokens back once. Chunk tails are floored to a power of
  two, as the JAX package does to bound its compiled shapes, so the two
  engines take the same steps. Every slot, empty or not, decodes and
  advances its position each step.
- **Speculative decoding** (``spec_draft`` > 0): prompt-lookup drafts
  verified in one window per iteration, greedy streams only; greedy
  output is unchanged.

Greedy-exactness contract: every stream's output matches isolated
single-stream generation token for token, whatever shares the batch.

Where the JAX engine decides on the device (``jax.lax.cond`` on "all
slots greedy"), this one decides on the host from its slot table, so a
chunk adds no device→host read beyond its tokens. The caches are float32
whatever the params are, and the step forms write them in place.

The JAX engine's three jitted programs are CUDA graphs here
(core/graphs.py), one per static signature, sharing one memory pool: the
admit prefill keyed by (bucket, greedy), with the prompt, its true length
and the slot as device inputs and the slot's seed key and sampling
controls read from the slot state; the decode chunk keyed by (steps,
greedy), the chunk or one of its power-of-two tails; the verify window
keyed by its width. The slot state (caches, tokens, positions, seed keys,
controls) is allocated once and every program writes it in place, so the
graphs replay over it. On the CPU, and inside ``graphs.disabled()``, the
same programs run eagerly.

``enroll(scheduler)`` makes the engine a tenant of a ``sched.DeviceEngine``:
each iteration then runs on the engine's dispatch thread under its fair
share, beside the pipelines' batches, and the three programs capture and
replay there.

Not ported yet (ROADMAP): the paged KV cache (``kv_page_size`` > 0 raises),
disaggregation roles and sessions (freeze/export/checkpoint), deadlines,
the autotuner, and the obs, diag, health, quality, slo and tracing hooks.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core import graphs
from ..core.hw import resolve_device
from ..models import causal_lm
from ..ops.int8 import stack_shape
from . import sampling


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
    """

    def __init__(self, params: Dict[str, Any], n_heads: int, max_len: int,
                 n_slots: int = 4, chunk: Optional[int] = None,
                 bucket=None, gang: bool = False, spec_draft: int = 0,
                 kv_page_size: Optional[int] = None,
                 device: Any = None) -> None:
        chunk = 8 if chunk is None else chunk
        if n_slots < 1 or chunk < 1:
            raise ValueError("n_slots and chunk must be >= 1")
        if kv_page_size:
            raise NotImplementedError(
                "kv_page_size > 0: the paged KV cache (serving/kv_cache.py) "
                "is not ported yet (a later slice of the port); use the "
                "contiguous engine (kv_page_size=0)")
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
        # device-resident slot state (leading axis = slot); the stores are
        # float32 whatever the params' dtype
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
        # the three programs, one graph per signature each, one pool
        pool = graphs.Pool()
        self._prefill_prog = graphs.CapturedFn(
            self._prefill_program, "LMEngine admit prefill", pool, dev)
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

    #: the engine's tenant name on a DeviceEngine (``--sched-tenants lm:W``)
    _engine_label = "lm"

    # -- public API ------------------------------------------------------- #

    def submit(self, prompt: Sequence[int], max_new: int,
               eos: Optional[int] = None, *, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 1.0, seed: int = 0) -> int:
        """Queue a generation request; returns its request id. The defaults
        decode greedily; ``seed`` fixes a sampled request's random stream
        (reproducible, independent of what shares the batch)."""
        p = np.asarray(prompt, np.int32).reshape(-1)
        if p.size < 1:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError("max_new must be >= 1")
        if p.size + max_new - 1 > self.max_len:
            # the last generated token needs no cache slot, hence -1
            raise ValueError(
                f"prompt ({p.size}) + max_new ({max_new}) exceeds cache "
                f"capacity max_len={self.max_len}")
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(_Request(
            rid, p, max_new, eos, temperature=float(temperature),
            top_k=int(top_k), top_p=float(top_p), seed=int(seed)))
        return rid

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

    # -- scheduler internals ---------------------------------------------- #

    def _admit(self) -> None:
        if self.gang and any(r is not None for r in self._slot_req):
            return  # static batching: wait for the whole gang to finish
        for slot in range(self.n_slots):
            if self._slot_req[slot] is not None or not self._queue:
                continue
            req = self._queue.popleft()
            t = int(req.prompt.size)
            padded = np.zeros((1, self._bucket(t)), np.int32)
            padded[0, :t] = req.prompt
            first = self._prefill_into(slot, padded, t, req)
            self.stats["prefills"] += 1
            req.out.append(int(first))
            self._pos_host[slot] = t
            self._slot_req[slot] = req
            self._retire_if_done(slot, req)

    def _prefill_into(self, slot: int, padded: np.ndarray, true_len: int,
                      req: _Request) -> torch.Tensor:
        """Prefill one padded prompt, install its cache and sampling state
        into ``slot``; returns the first generated token (a device scalar)."""
        dev = self.device
        self._skeys[slot] = sampling.seed_key(req.seed, dev)
        self._set_controls(slot, req.temperature, req.top_k, req.top_p)
        return self._prefill_prog(
            torch.from_numpy(padded).to(dev),
            torch.full((), true_len, dtype=torch.int32, device=dev),
            torch.full((1,), slot, dtype=torch.int64, device=dev),
            greedy=req.temperature <= 0.0)

    def _prefill_program(self, tokens: torch.Tensor, true_len: torch.Tensor,
                         slot: torch.Tensor, *, greedy: bool) -> torch.Tensor:
        """The admit prefill: tokens (1, bucket), true_len (), slot (1,)
        int64; writes the slot's cache, position and first token."""
        logits, kc, vc, pos = causal_lm.lm_prefill_masked(
            self.params, tokens, true_len, self.n_heads, self.max_len)
        if greedy:  # skips the sampler's sort/softmax/cumsum
            first = torch.argmax(logits[0], dim=-1).to(torch.int32)
        else:
            # the first token is emitted having consumed true_len tokens
            key = sampling.fold_in(self._skeys.index_select(0, slot)[0],
                                   true_len)
            first = sampling.sample_row(
                logits[0], key, self._temp.index_select(0, slot),
                self._topk.index_select(0, slot),
                self._topp.index_select(0, slot))
        self._kc.index_copy_(0, slot, kc[None])
        self._vc.index_copy_(0, slot, vc[None])
        self._pos.index_copy_(0, slot, pos.reshape(1, 1))
        self._tokens.index_copy_(0, slot, first.reshape(1, 1, 1))
        return first

    def _set_controls(self, slot: int, temperature: float, top_k: int,
                      top_p: float) -> None:
        self._temp[slot] = temperature
        self._topk[slot] = top_k
        self._topp[slot] = top_p
        self._temp_host[slot] = temperature

    def _decode(self) -> None:
        active = [s for s, r in enumerate(self._slot_req) if r is not None]
        if not active:
            return
        headroom = self.max_len - max(self._pos_host[s] for s in active)
        if self.spec_draft > 0 and headroom >= self.spec_draft + 1 \
                and all(self._slot_req[s].temperature <= 0.0
                        for s in active) \
                and any(self._slot_req[s].max_new - len(self._slot_req[s].out)
                        > 1 for s in active):
            # a verify window writes spec_draft + 1 cache slots; near
            # capacity, with a sampled stream, or when every stream needs
            # at most one more token, plain chunks serve better
            self._decode_speculative(active)
            return
        # cap the chunk so no active slot decodes past capacity
        remaining = max(r.max_new - len(r.out) for r in self._slot_req
                        if r is not None)
        n = max(1, min(self.chunk, headroom, remaining))
        if n < self.chunk:
            n = 1 << (n.bit_length() - 1)  # power-of-two tails
        outs = self._run_chunk(n).cpu().numpy()  # (S, n)
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
        return self._chunk_prog(
            n=n, greedy=all(t <= 0.0 for t in self._temp_host))

    def _chunk_program(self, *, n: int, greedy: bool) -> torch.Tensor:
        """The decode chunk: ``n`` steps from the slot state, which it
        advances in place; returns the (S, n) tokens."""
        tokens, pos, outs = self._tokens, self._pos, []
        for _ in range(n):
            logits, _, _, pos = causal_lm.lm_decode_step_slots(
                self.params, tokens, self._kc, self._vc, pos, self.n_heads)
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
        self._tokens.copy_(tokens)
        self._pos.copy_(pos)
        return torch.stack(outs, dim=1)

    def _verify_program(self, drafts: torch.Tensor):
        """One speculative verify window over all slots, the slot's last
        token then its (S, g) drafts: advances the tokens and positions in
        place past each slot's accepted drafts; returns (greedy (S, W),
        m (S,))."""
        tokens_in = torch.cat([self._tokens[:, 0], drafts], dim=1)
        logits, _, _, pos_w = causal_lm.lm_verify_window_slots(
            self.params, tokens_in, self._kc, self._vc, self._pos,
            self.n_heads)
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
        outs, m = self._verify_prog(torch.from_numpy(drafts).to(self.device))
        outs = outs.cpu().numpy()
        m = m.cpu().numpy()
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
            self.stats["tokens_out"] += len(req.out)
            self._finished[req.rid] = req.out
            self._slot_req[slot] = None
            if req.temperature > 0.0:
                # restore greedy defaults so a finished sampled stream does
                # not keep the greedy fast path off for the others
                self._set_controls(slot, 0.0, 0, 1.0)
