"""Sharded training and inference steps over a mesh — port of
nnstreamer_tpu/parallel/train.py.

The batch shards over ``data``; the parameters (and the optimizer's
moments) are placed over ``model`` by ``sharding.param_spec``, as DTensors.
GSPMD picks the collectives from those annotations; here they are
explicit and the compute is data-parallel: each step gathers the
parameters over ``model`` (``sharding.full_value``), runs the forward and backward
on the rank's data shard, averages the gradients over ``data`` (``psum`` /
size: with equal shards, the gradient of the whole batch's mean loss), and
each rank updates only its own chunk of every parameter and moment with
the port's optimizers (ops/optim.py). The model axis thus shards the state,
not the arithmetic (the JAX package's compiler may also split the GEMMs).

The batch is the whole batch on every rank (the JAX step's global view);
each rank takes its ``data`` shard, so the batch must divide by the data
axis size.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
from torch.distributed.tensor import DTensor, Shard

from ..ops.optim import Optimizer
from .mesh import (all_gather, axis_index, mesh_device, mesh_shape, psum)
from .sharding import as_tensor, full_value, shard_params, tree_flatten

__all__ = ["cross_entropy_loss", "make_sharded_train_step",
           "make_sharded_infer_step", "data_shard", "local_chunk",
           "mean_over_data", "leaf_states"]


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.gather(logp, -1, labels.to(torch.int64)[:, None]).mean()


def data_shard(x: Any, mesh: Any) -> torch.Tensor:
    """This rank's rows of the whole batch ``x`` along the ``data`` axis."""
    x = as_tensor(x, mesh_device(mesh))
    dp = mesh_shape(mesh).get("data", 1)
    if dp == 1:
        return x
    if x.shape[0] % dp:
        raise ValueError(f"batch {x.shape[0]} not divisible by the 'data' "
                         f"axis size {dp}")
    return x.chunk(dp, dim=0)[axis_index(mesh, "data")]


def local_chunk(full: torch.Tensor, like: DTensor) -> torch.Tensor:
    """The chunk of a full-size tensor that ``like``'s placements give this
    rank."""
    out = full
    mesh = like.device_mesh
    for i, pl in enumerate(like.placements):
        if isinstance(pl, Shard):
            n = mesh.size(i)
            out = out.chunk(n, dim=pl.dim)[mesh.get_local_rank(i)]
    return out


def mean_over_data(t: torch.Tensor, mesh: Any) -> torch.Tensor:
    dp = mesh_shape(mesh).get("data", 1)
    if dp == 1:
        return t
    return psum(t, mesh, "data") / torch.full((), float(dp), dtype=t.dtype,
                                              device=t.device)


def make_sharded_train_step(
        apply_fn: Callable[..., Any], params: Any, mesh: Any,
        optimizer: Optional[Optimizer] = None,
        loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = cross_entropy_loss):
    """(step, sharded_params, opt_state). ``step(params, opt_state, x, y)
    -> (params, opt_state, loss)`` takes the whole batch and returns the
    whole batch's mean loss; params and state are updated in place and
    returned. ``opt_state`` is a tree of the optimizer's per-leaf states,
    each moment a DTensor placed as its parameter. Default optimizer:
    sgd(1e-3) with momentum 0.9, as the JAX default."""
    opt = optimizer if optimizer is not None else Optimizer("sgd", 1e-3)
    sharded = shard_params(params, mesh)
    flat, rebuild = tree_flatten(sharded)

    def init_leaf(p: DTensor) -> Dict[str, Any]:
        state = opt.init(p.to_local())
        return {k: {kk: (vv if kk == "count" else DTensor.from_local(
            vv, p.device_mesh, p.placements, run_check=False))
            for kk, vv in v.items()} for k, v in state.items()}

    opt_state = rebuild([init_leaf(p) for _, p in flat])

    def step(params: Any, opt_state: Any, x: Any, y: Any):
        pflat, prebuild = tree_flatten(params)
        dparams = [p for _, p in pflat]
        with torch.enable_grad():
            full = [full_value(p).detach().requires_grad_(True)
                    for p in dparams]
            loss = loss_fn(apply_fn(prebuild(full), data_shard(x, mesh)),
                           data_shard(y, mesh))
            grads = torch.autograd.grad(loss, full)
        states = leaf_states(params, opt_state)
        with torch.no_grad():
            for p, g, st in zip(dparams, grads, states):
                g = local_chunk(mean_over_data(g, mesh), p)
                opt.update(p.to_local(), g.contiguous(), _local_state(st))
        return params, opt_state, mean_over_data(loss.detach(), mesh)

    return step, sharded, opt_state


def leaf_states(params: Any, opt_state: Any) -> list:
    """The per-leaf state dicts of ``opt_state`` (the params tree with each
    leaf replaced by its state), in parameter order."""
    if isinstance(params, dict):
        return [s for k in params for s in leaf_states(params[k], opt_state[k])]
    if isinstance(params, (list, tuple)):
        return [s for p, o in zip(params, opt_state) for s in leaf_states(p, o)]
    return [opt_state]


def _local_state(state: Dict[str, Any]) -> Dict[str, Any]:
    """A leaf state with each DTensor moment as its local chunk (a view,
    so the update writes the DTensor's storage)."""
    return {k: {kk: (vv.to_local() if isinstance(vv, DTensor) else vv)
                for kk, vv in v.items()} for k, v in state.items()}


def make_sharded_infer_step(apply_fn: Callable[..., Any], params: Any,
                            mesh: Any):
    """(fn, sharded_params): ``fn(params, x)`` runs the rank's data shard
    of the whole batch ``x`` and returns the whole batch's output on every
    rank (gathered over ``data``)."""
    sharded = shard_params(params, mesh)

    def infer(p: Any, x: Any) -> torch.Tensor:
        pflat, prebuild = tree_flatten(p)
        full = prebuild([full_value(leaf) for _, leaf in pflat])
        with torch.no_grad():
            out = apply_fn(full, data_shard(x, mesh))
        if mesh_shape(mesh).get("data", 1) > 1:
            out = all_gather(out, mesh, "data", 0)
        return out

    return infer, sharded

