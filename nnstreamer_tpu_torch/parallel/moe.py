"""Expert parallelism: switch-routed mixture of experts over a mesh — port of
nnstreamer_tpu/parallel/moe.py.

A learned top-1 router sends each token to one of E experts; tokens fill
per-expert capacity buffers (``cap = ceil(N / E · capacity_factor)`` over
the N tokens of the batch, in token order) and the ones over capacity are
dropped (their output is zero: the residual outside the layer carries
them). ``moe_apply`` is the single-device form, JAX's arithmetic.

``make_expert_parallel_moe`` shards the expert FFN stacks over the
``expert`` axis (E/EP experts a rank) and the batch over ``data``. Where
GSPMD derives the collectives from the shardings, they are explicit here:
each rank routes its own slice of the tokens; slot positions take a
prefix of the per-expert counts of the slices before it (``all_gather``),
so routing and drops equal the single-device run's; the dispatch buffers
go to the experts' ranks by ``all_to_all`` over ``expert`` (and a sum over
``data``, whose slots are disjoint); the expert outputs come back by
``all_to_all`` over ``expert``; the combined rows are gathered so every
rank returns the whole batch's output, as the JAX function returns it.
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
           "make_expert_parallel_moe"]


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
    """Wrap ``fn(params, x)`` with a clear batch-divisibility error for the
    data axis."""
    if dp <= 1:
        return fn

    def infer(p, x):
        if x.shape[0] % dp:
            raise ValueError(
                f"{what}: batch {x.shape[0]} not divisible by the "
                f"{dp_axis!r} axis size {dp}; pad the batch or pass "
                f"dp_axis=None")
        return fn(p, x)

    return infer


def make_expert_parallel_moe(params: Dict[str, Any], mesh: Any,
                             ep_axis: str = "expert",
                             dp_axis: Optional[str] = "data",
                             capacity_factor: float = 1.25):
    """(apply, placed): ``placed`` holds this rank's experts (DTensors per
    ``moe_shardings``); ``apply(placed, x)`` takes the whole (B, S, D)
    batch, the same on every rank, and returns (y, aux) for all of it."""
    dev = mesh_device(mesh)
    shardings = moe_shardings(params, mesh, ep_axis)
    placed = {k: distribute_tensor(as_tensor(v, dev), mesh, shardings[k],
                                   src_data_rank=None)
              for k, v in params.items()}
    axes = mesh_shape(mesh)
    dp = axes.get(dp_axis, 1) if dp_axis else 1
    ep = axis_size(mesh, ep_axis)

    def apply(p: Dict[str, Any], x: torch.Tensor):
        x = as_tensor(x, dev)
        b, s, d = x.shape
        router = p["router"].to_local()
        w1, w2 = p["w1"].to_local(), p["w2"].to_local()  # (E/EP, ...)
        e = router.shape[-1]
        if e % ep:
            raise ValueError(f"moe: {e} experts not divisible by the "
                             f"{ep_axis!r} axis size {ep}")
        n = b * s
        cap = int(np.ceil(n / e * capacity_factor))
        di = axis_index(mesh, dp_axis) if dp > 1 else 0
        xd = x.reshape(dp, n // dp, d)[di]  # this data shard's tokens
        if xd.shape[0] % ep:
            raise ValueError(f"moe: {xd.shape[0]} tokens a data shard not "
                             f"divisible by the {ep_axis!r} axis size {ep}")
        xf = xd.reshape(ep, -1, d)[axis_index(mesh, ep_axis)]  # my slice
        gates, _, gate, onehot = _route(xf, router)
        counts = onehot.sum(0)
        # slots continue the count of the slices before this one (token
        # order is data-major, then expert): the single-device positions
        every = all_gather(counts[None], mesh, ep_axis, 0)        # (EP, E)
        if dp > 1:
            every = all_gather(every[None], mesh, dp_axis, 0)     # (dp, EP, E)
        every = every.reshape(-1, e)
        me = di * ep + axis_index(mesh, ep_axis)
        offset = every[:me].sum(0)
        pos = ((torch.cumsum(onehot, 0) * onehot).sum(-1) - 1
               + (onehot * offset).sum(-1)).to(torch.int64)
        dispatch, keep = _dispatch(onehot, pos, cap, x.dtype)
        xin = torch.einsum("nec,nd->ecd", dispatch, xf)          # (E, C, D)
        # token → expert: each expert rank gets every slice's slots of its
        # experts (disjoint, so the sums are exact)
        recv = all_to_all(xin, mesh, ep_axis, 0, 0)               # (E, C, D)
        xin_mine = recv.reshape(ep, e // ep, cap, d).sum(0)
        if dp > 1:
            xin_mine = psum(xin_mine, mesh, dp_axis)
        yexp = _experts(xin_mine, w1, w2)                         # (E/EP, C, D)
        # expert → token: every slice needs every expert's slots
        yall = all_to_all(yexp.repeat(ep, 1, 1), mesh, ep_axis, 0, 0)
        yf = torch.einsum("nec,ecd->nd",
                          dispatch * gate[:, None, None].to(x.dtype), yall)
        y = all_gather(yf, mesh, ep_axis, 0)
        if dp > 1:
            y = all_gather(y, mesh, dp_axis, 0)
        tot = psum(torch.stack([(onehot * keep[:, None]).sum()]), mesh, ep_axis)
        gsum = psum(gates.sum(0), mesh, ep_axis)
        csum = psum(counts, mesh, ep_axis)
        if dp > 1:
            tot = psum(tot, mesh, dp_axis)
            gsum = psum(gsum, mesh, dp_axis)
            csum = psum(csum, mesh, dp_axis)
        aux = {"load_balance_loss": e * torch.sum((gsum / n) * (csum / n)),
               "expert_counts": csum, "dropped": n - tot[0]}
        return y.reshape(b, s, d), aux

    return dp_guard(apply, dp, dp_axis), placed
