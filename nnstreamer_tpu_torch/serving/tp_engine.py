"""Distributed continuous batching: the slot engine over a TP mesh — port
of nnstreamer_tpu/serving/tp_engine.py.

``TPLMEngine`` keeps ``LMEngine``'s scheduler (queues, slots, chunking,
admission, retirement, sampling, speculative decoding) and swaps its three
programs for tensor-parallel ones: the per-slot K/V stores shard by head
over ``mesh[axis]`` (parallel/tp_decode.py's layout), the admit prefill is
the TP window prefill (parallel/tp_prefill.py), and the decode chunk and the
verify window run the TP step over every slot.

One process per rank: every rank builds the engine and makes the same
``submit``s in the same order (the ``torchrun`` idiom). The scheduler is
deterministic and the logits after each layer's sums are the same bits on
every rank, so the ranks stay in lockstep, sampling included. Each
iteration checks that: one all_gather of a digest of the scheduler's state
(queued and admitted request ids, positions, each stream's tokens so far)
over the axis, and a rank that differs makes every rank raise
(``LockstepError``) instead of hanging in a collective. What reads the wall
clock is decided by rank 0 and broadcast: a request's ``deadline`` is
checked through ``_RankZeroDeadline``, so shedding is the same everywhere.
The obs hooks fire on each rank in its own process, with ``engine="tp"``.

Under NCCL the admit prefill, the decode chunk and the verify window are
CUDA graphs as in ``LMEngine``. The communicator is up before any capture:
the lockstep all_gather runs eagerly at the top of every iteration, ahead
of its programs, and ``core.graphs.CapturedFn`` runs each program eagerly
once before capturing it. Under gloo they run eagerly, inside
``graphs.disabled()``: gloo's collectives cannot be captured. NCCL over
more than one rank, captured collectives included, has not yet run on
cards (ROADMAP §C).

Paging is refused (the slot stores shard by head), and with it the
prefill/decode roles, which need the paged cache.
"""

from __future__ import annotations

import contextlib
import hashlib
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core import graphs
from ..core.hw import resolve_device
from ..parallel.mesh import (all_gather, axis_group, axis_size, broadcast,
                             mesh_device)
from ..parallel.tp_decode import (tp_decode_step_slots, tp_shard_params,
                                  tp_verify_window_slots)
from ..parallel.tp_prefill import tp_prefill_window
from .lm_engine import LMEngine

__all__ = ["TPLMEngine", "LockstepError"]


class LockstepError(RuntimeError):
    """The ranks' schedulers diverged (their submits or state differ)."""


class _RankZeroDeadline:
    """A deadline whose ``expired()`` is rank 0's answer, broadcast over
    the axis: the ranks shed the same requests at the same points."""

    __slots__ = ("real", "_engine")

    def __init__(self, real: Any, engine: "TPLMEngine") -> None:
        self.real = real
        self._engine = engine

    def expired(self) -> bool:
        return self._engine._rank_zero_flag(self.real.expired())


class TPLMEngine(LMEngine):
    """Continuous batching with the K/V stores head-sharded over
    ``mesh[axis]``: ``LMEngine``'s API and outputs. ``params`` is the full
    tree (a port tree on any device, or a JAX tree as numpy); each rank
    keeps its slice (``tp_shard_params``) on its device, and ``self.params``
    stays the caller's tree, for shapes only."""

    #: serving series carry engine="tp", apart from single-card engines
    _engine_label = "tp"

    def __init__(self, params: Dict[str, Any], n_heads: int, max_len: int,
                 mesh: Any, axis: str = "model", **kw: Any) -> None:
        n = axis_size(mesh, axis)
        if n_heads % n:
            raise ValueError(f"n_heads={n_heads} not divisible by "
                             f"mesh axis {axis}={n}")
        if any(kw.get(k) for k in ("kv_page_size", "kv_pages",
                                   "kv_slot_pages", "kv_host_offload")):
            raise ValueError(
                "TPLMEngine does not support the paged KV cache (kv_* "
                "options): its slot caches shard by head over the mesh; "
                "use the single-device LMEngine for paging")
        # pin the contiguous path so the NNS_LM_KV_* environment (the
        # nns-launch flag transport) cannot turn paging on
        kw["kv_page_size"] = 0
        # read by the device-layout hooks during LMEngine.__init__
        self.mesh, self.axis, self._n = mesh, axis, n
        self._group = axis_group(mesh, axis)
        self._gloo = n > 1 and str(dist.get_backend(self._group)) == "gloo"
        device = kw.pop("device", None)
        if device is not None and resolve_device(device) != mesh_device(mesh):
            raise ValueError(
                f"TPLMEngine runs on its rank's device {mesh_device(mesh)}, "
                f"not device={device!r}: each rank's device is the "
                "launcher's (parallel/launch.py)")
        super().__init__(params, n_heads, max_len, **kw)
        self._tp = tp_shard_params(params, n_heads, mesh, axis)
        self.lockstep_checks = 0

    # -- device-layout hooks ---------------------------------------------- #

    def _engine_device(self, device: Any) -> torch.device:
        return mesh_device(self.mesh)

    def _check_params(self, params: Dict[str, Any]) -> None:
        return  # the caller's tree, for shapes: each rank slices its own

    def _alloc_slot_caches(self, n_layers: int, hd: int):
        # sharded from birth: the full (S, L·H, M, hd) stores may not fit
        # one card in the regime this engine exists for
        hn = self.n_heads // self._n
        shape = (self.n_slots, n_layers * hn, self.max_len, hd)
        return (torch.zeros(shape, dtype=torch.float32, device=self.device),
                torch.zeros(shape, dtype=torch.float32, device=self.device))

    def _admit_window(self, tokens: torch.Tensor, true_len: torch.Tensor):
        return tp_prefill_window(self._tp, tokens, true_len, self.n_heads,
                                 self.max_len, self.mesh, self.axis)

    def _step_slots(self, tokens, kc, vc, pos):
        return tp_decode_step_slots(self._tp, tokens, kc, vc, pos,
                                    self.n_heads, self.mesh, self.axis)

    def _window_slots(self, tokens_in, kc, vc, pos):
        return tp_verify_window_slots(self._tp, tokens_in, kc, vc, pos,
                                      self.n_heads, self.mesh, self.axis)

    # -- lockstep ----------------------------------------------------------- #

    def submit(self, prompt: Sequence[int], max_new: int,
               eos: Optional[int] = None, *, deadline: Any = None,
               **kw: Any) -> int:
        if deadline is not None:
            deadline = _RankZeroDeadline(deadline, self)
        return super().submit(prompt, max_new, eos, deadline=deadline, **kw)

    def _rank_zero_flag(self, flag: bool) -> bool:
        t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                         device=self.device)
        return bool(broadcast(t, self.mesh, self.axis, src=0).item())

    def _digest(self) -> int:
        """A 62-bit digest of the scheduler state the ranks must share
        (queued prompts, slots, positions, tokens so far)."""
        h = hashlib.blake2b(digest_size=8)
        for req in self._queue:
            h.update(np.asarray([req.rid, req.prompt.size, req.max_new],
                                np.int64).tobytes())
            h.update(req.prompt.tobytes())
        for s, req in enumerate(self._slot_req):
            h.update(np.asarray([s, -1 if req is None else req.rid,
                                 self._pos_host[s]], np.int64).tobytes())
            if req is not None:
                h.update(np.asarray(req.out, np.int64).tobytes())
        h.update(np.asarray([self._next_rid], np.int64).tobytes())
        return int.from_bytes(h.digest(), "little") >> 2

    def check_lockstep(self) -> None:
        """Every rank's scheduler digest over the axis: raise on all ranks
        when one differs."""
        if self._n == 1:
            return
        mine = torch.tensor([self._digest()], dtype=torch.int64,
                            device=self.device)
        got = all_gather(mine, self.mesh, self.axis).cpu().tolist()
        self.lockstep_checks += 1
        if len(set(got)) != 1:
            raise LockstepError(
                f"{self._engine_label}: ranks left lockstep (scheduler "
                f"digests {got}); every rank must make the same submits in "
                "the same order")

    def _mode(self):
        # gloo's collectives cannot be captured in a CUDA graph
        return graphs.disabled() if self._gloo else contextlib.nullcontext()

    def _step_direct(self) -> bool:
        with self._mode():
            self.check_lockstep()
            return super()._step_direct()
