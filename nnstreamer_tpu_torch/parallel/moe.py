"""Expert parallelism: switch-routed mixture of experts over a mesh — port of
nnstreamer_tpu/parallel/moe.py.

A learned top-1 router sends each token to one of E experts; tokens fill
per-expert capacity buffers (``cap = ceil(N / E · capacity_factor)`` over
the N tokens of the batch, in token order) and the ones over capacity are
dropped (their output is zero: the residual outside the layer carries
them). ``moe_apply`` is the single-device form, JAX's arithmetic.

``make_expert_parallel_moe`` shards the expert FFN stacks over the
``expert`` axis (E/EP experts a rank) and the batch over ``data``. Where
GSPMD derives the collectives from the shardings, they are explicit here
(``moe_apply_sharded``, which also takes sequence shards, for the MoE
transformer's sp×ep): each rank routes its own slice of the tokens; slot
positions come from every token's expert gathered in the global token
order (``all_gather``), so routing and drops equal the single-device
run's; the dispatch buffers go to the experts' ranks by ``all_to_all``
over ``expert`` (and a sum over the block axis, whose slots are disjoint);
the expert outputs come back by ``all_to_all`` over ``expert``; the
combined rows are gathered so every rank returns the whole batch's output,
as the JAX function returns it.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from ..ops.kernels.epilogue import gelu_tanh
from .mesh import (all_gather, all_to_all, axis_index, axis_size, mesh_device,
                   mesh_shape, psum)
from .sharding import as_tensor

__all__ = ["init_moe_params", "moe_apply", "moe_shardings", "dp_guard",
           "moe_apply_sharded", "make_expert_parallel_moe"]


def init_moe_params(seed: int, d_model: int, d_hidden: int, n_experts: int,
                    dtype: Any = np.float32) -> Dict[str, np.ndarray]:
    """Router (D, E) and expert FFN stacks w1 (E, D, H), w2 (E, H, D) as
    numpy, with the JAX initializer's statistics (normal / sqrt(fan-in)).
    The draws are numpy's: parity with the JAX package comes from
    converting its params (models/convert.moe_params)."""
    rng = np.random.default_rng(seed)
    s_in, s_hid = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_hidden)

    def normal(shape, scale):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(scale)).astype(dtype)

    return {"router": normal((d_model, n_experts), s_in),
            "w1": normal((n_experts, d_model, d_hidden), s_in),
            "w2": normal((n_experts, d_hidden, d_model), s_hid)}


def _route(xf: torch.Tensor, router: torch.Tensor):
    """(gates (N, E) float32, expert (N,), gate (N,), onehot (N, E))."""
    gates = torch.softmax((xf @ router).to(torch.float32), dim=-1)
    expert = torch.argmax(gates, dim=-1)
    gate = gates.amax(dim=-1)
    onehot = F.one_hot(expert, gates.shape[-1]).to(torch.float32)
    return gates, expert, gate, onehot


def _dispatch(onehot: torch.Tensor, pos: torch.Tensor, cap: int,
              dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dispatch (N, E, C) in ``dtype``, keep (N,) float32)."""
    keep = (pos < cap).to(torch.float32)
    slot = F.one_hot(pos.clamp(0, cap - 1), cap).to(torch.float32) \
        * keep[:, None]
    return ((onehot * keep[:, None])[:, :, None] * slot[:, None, :]).to(dtype), keep


def _experts(xin: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    h = gelu_tanh(torch.einsum("ecd,edh->ech", xin, w1))
    return torch.einsum("ech,ehd->ecd", h, w2)


def moe_apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
              capacity_factor: float = 1.25
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Top-1 (switch) MoE FFN, (B, S, D) → (B, S, D), with aux: the
    load-balancing loss (Switch Transformer eq. 4), per-expert token counts
    and the dropped count. Routing bookkeeping is float32 whatever x's
    dtype (a bf16 cumsum rounds above 256)."""
    b, s, d = x.shape
    e = params["router"].shape[-1]
    n = b * s
    cap = int(np.ceil(n / e * capacity_factor))
    xf = x.reshape(n, d)
    gates, _, gate, onehot = _route(xf, params["router"])
    pos = ((torch.cumsum(onehot, 0) * onehot).sum(-1) - 1).to(torch.int64)
    dispatch, keep = _dispatch(onehot, pos, cap, x.dtype)
    xin = torch.einsum("nec,nd->ecd", dispatch, xf)
    yexp = _experts(xin, params["w1"], params["w2"])
    yf = torch.einsum("nec,ecd->nd",
                      dispatch * gate[:, None, None].to(x.dtype), yexp)
    counts = onehot.sum(0)
    importance = gates.mean(0)
    aux = {"load_balance_loss": e * torch.sum(importance * (counts / n)),
           "expert_counts": counts,
           "dropped": n - torch.sum(onehot * keep[:, None])}
    return yf.reshape(b, s, d), aux


def moe_shardings(params: Dict[str, Any], mesh: Any,
                  ep_axis: str = "expert") -> Dict[str, list]:
    """Placements: the router replicated, the expert stacks sharded on
    their expert dim over ``ep_axis``."""
    names = list(mesh_shape(mesh))
    rep = [Replicate() for _ in names]
    ep = [Shard(0) if a == ep_axis else Replicate() for a in names]
    return {"router": rep, "w1": ep, "w2": ep}


def dp_guard(fn: Callable[..., Any], dp: int, dp_axis: Optional[str],
             what: str = "moe") -> Callable[..., Any]:
    """Wrap ``fn(params, x, **kw)`` with a clear batch-divisibility error
    for the data axis."""
    if dp <= 1:
        return fn

    def infer(p, x, **kw):
        if x.shape[0] % dp:
            raise ValueError(
                f"{what}: batch {x.shape[0]} not divisible by the "
                f"{dp_axis!r} axis size {dp}; pad the batch or pass "
                f"dp_axis=None")
        return fn(p, x, **kw)

    return infer


def moe_apply_sharded(params: Dict[str, torch.Tensor], x: torch.Tensor,
                      mesh: Any, ep_axis: str = "expert",
                      block_axis: Optional[str] = None,
                      seq_blocks: bool = False,
                      capacity_factor: float = 1.25
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Switch MoE over a mesh on this rank's block of tokens ``x`` (B, S,
    D) — the same block on every rank of ``ep_axis`` — returning the
    block's (B, S, D) output and the aux of all the tokens. ``params``
    holds the router (D, E) and this rank's E/EP experts of ``w1``/``w2``.

    The blocks lie along ``block_axis`` (None: one block, all the tokens):
    cuts of the batch (``data``: the global token order is block-major)
    or, with ``seq_blocks``, of the sequence (``sp``: the global (b, s)
    order interleaves them). Each rank routes its 1/EP slice of the block;
    every token's expert, gathered over both axes (N × E floats), gives the
    single-device capacity positions in the global (b, s) order, so the
    same tokens drop as on one device. Dispatch buffers go to the experts'
    ranks by ``all_to_all`` over ``ep_axis`` (and a sum over the block
    axis: the slots are disjoint), the expert outputs come back the same
    way, and the slices are gathered back into the block."""
    router, w1, w2 = params["router"], params["w1"], params["w2"]
    b, s, d = x.shape
    e = router.shape[-1]
    ep = axis_size(mesh, ep_axis)
    if e % ep:
        raise ValueError(f"moe: {e} experts not divisible by the "
                         f"{ep_axis!r} axis size {ep}")
    nb = axis_size(mesh, block_axis) if block_axis else 1
    j = axis_index(mesh, block_axis) if nb > 1 else 0
    n_blk = b * s
    n = n_blk * nb
    if n_blk % ep:
        raise ValueError(f"moe: {n_blk} tokens a data shard not divisible by "
                         f"the {ep_axis!r} axis size {ep}")
    cap = int(np.ceil(n / e * capacity_factor))
    m = axis_index(mesh, ep_axis)
    xf = x.reshape(ep, -1, d)[m]                                  # my slice
    gates, _, gate, onehot = _route(xf, router)
    every = all_gather(onehot, mesh, ep_axis, 0)[None]            # (1, n_blk, E)
    if nb > 1:
        every = all_gather(every, mesh, block_axis, 0)            # (nb, n_blk, E)
    glob = (every.reshape(nb, b, s, e).transpose(0, 1) if seq_blocks
            else every).reshape(n, e)                             # (b, s) order
    gpos = (torch.cumsum(glob, 0) * glob).sum(-1) - 1
    mine = (gpos.reshape(b, nb, s)[:, j] if seq_blocks
            else gpos.reshape(nb, n_blk)[j]).reshape(ep, -1)[m]
    dispatch, _ = _dispatch(onehot, mine.to(torch.int64), cap, x.dtype)
    xin = torch.einsum("nec,nd->ecd", dispatch, xf)               # (E, C, D)
    # token → expert: each expert rank gets every slice's slots of its
    # experts (disjoint, so the sums are exact)
    recv = all_to_all(xin, mesh, ep_axis, 0, 0)
    xin_mine = recv.reshape(ep, e // ep, cap, d).sum(0)
    if nb > 1:
        xin_mine = psum(xin_mine, mesh, block_axis)
    yexp = _experts(xin_mine, w1, w2)                             # (E/EP, C, D)
    # expert → token: every slice needs every expert's slots
    yall = all_to_all(yexp.repeat(ep, 1, 1), mesh, ep_axis, 0, 0)
    yf = torch.einsum("nec,ecd->nd",
                      dispatch * gate[:, None, None].to(x.dtype), yall)
    y = all_gather(yf, mesh, ep_axis, 0).reshape(b, s, d)
    gsum = psum(gates.sum(0), mesh, ep_axis)
    if nb > 1:
        gsum = psum(gsum, mesh, block_axis)
    counts = glob.sum(0)
    kept = (glob * (gpos < cap).to(glob.dtype)[:, None]).sum()
    aux = {"load_balance_loss": e * torch.sum((gsum / n) * (counts / n)),
           "expert_counts": counts, "dropped": n - kept}
    return y, aux


def make_expert_parallel_moe(params: Dict[str, Any], mesh: Any,
                             ep_axis: str = "expert",
                             dp_axis: Optional[str] = "data",
                             capacity_factor: float = 1.25):
    """(apply, placed): ``placed`` holds this rank's experts (DTensors per
    ``moe_shardings``); ``apply(placed, x)`` takes the whole (B, S, D)
    batch, the same on every rank, and returns (y, aux) for all of it:
    each rank runs its data shard through ``moe_apply_sharded``, and the
    shards are gathered over ``data``."""
    dev = mesh_device(mesh)
    shardings = moe_shardings(params, mesh, ep_axis)
    placed = {k: distribute_tensor(as_tensor(v, dev), mesh, shardings[k],
                                   src_data_rank=None)
              for k, v in params.items()}
    axes = mesh_shape(mesh)
    dp = axes.get(dp_axis, 1) if dp_axis else 1

    def apply(p: Dict[str, Any], x: torch.Tensor):
        x = as_tensor(x, dev)
        local = {k: v.to_local() for k, v in p.items()}
        if dp > 1:
            x = x.chunk(dp, dim=0)[axis_index(mesh, dp_axis)]
        y, aux = moe_apply_sharded(local, x, mesh, ep_axis,
                                   dp_axis if dp > 1 else None,
                                   capacity_factor=capacity_factor)
        if dp > 1:
            y = all_gather(y, mesh, dp_axis, 0)
        return y, aux

    return dp_guard(apply, dp, dp_axis), placed
