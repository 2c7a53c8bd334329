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

``sharded_bundle`` serves the sharded infer step through ``tensor_filter``:
a module bundle's parameters and buffers become the step's parameter tree
(``param_form``), and the leader/follower protocol (parallel/leader.py)
runs every invoke on all ranks.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Shard

from ..ops.optim import Optimizer
from .mesh import (all_gather, axis_index, mesh_device, mesh_shape, psum)
from .sharding import as_tensor, full_value, shard_params, tree_flatten

__all__ = ["cross_entropy_loss", "make_sharded_train_step",
           "make_sharded_infer_step", "sharded_bundle", "param_form",
           "data_shard", "local_chunk", "mean_over_data", "leaf_states"]


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
    of the whole batch ``x`` and returns the whole batch's output (each
    output of a tuple) on every rank, gathered over ``data``."""
    sharded = shard_params(params, mesh)
    gather = mesh_shape(mesh).get("data", 1) > 1

    def infer(p: Any, x: Any) -> Any:
        pflat, prebuild = tree_flatten(p)
        full = prebuild([full_value(leaf) for _, leaf in pflat])
        with torch.no_grad():
            out = apply_fn(full, data_shard(x, mesh))
        if not gather:
            return out
        if isinstance(out, (tuple, list)):
            return type(out)(all_gather(o, mesh, "data", 0) for o in out)
        return all_gather(out, mesh, "data", 0)

    return infer, sharded


class _Bound(nn.Module):
    """A bundle's ``forward(module, *xs)`` as a module over ``module``, for
    ``torch.func.functional_call``."""

    def __init__(self, module: nn.Module, forward: Callable[..., Any]) -> None:
        super().__init__()
        self.inner = module
        self._forward = forward

    def forward(self, *xs: Any) -> Any:
        return self._forward(self.inner, *xs)


def param_form(base: Any):
    """(apply_fn, params) of a ModelBundle, ``apply_fn(params, *xs) ==
    base.apply(*xs)``: a ``(fn, params)`` bundle's own pair; a module
    bundle's parameters and buffers by state_dict key, run through
    ``functional_call``; a plain callable with no parameters."""
    if base.apply_params is not None and base.params is not None:
        return base.apply_params, base.params
    if base.module is not None:
        fwd = base.forward if base.forward is not None \
            else (lambda m, *xs: m(*xs))
        bound = _Bound(base.module, fwd)
        params = {k: v.detach() for k, v in bound.state_dict().items()}
        return (lambda p, *xs: torch.func.functional_call(bound, p, xs)), params
    return (lambda p, *xs: base.apply(*xs)), {}


def sharded_bundle(base: Any, mesh: Any) -> Any:
    """Wrap a ModelBundle for mesh-sharded serving inside a pipeline:
    ``tensor_filter model=sharded_bundle(b, mesh)`` on rank 0 fans each
    request batch over the mesh's ``data`` axis with the parameters placed
    over ``model`` (``make_sharded_infer_step``), while the other ranks run
    ``parallel.leader.follow`` on their own ``sharded_bundle(b, mesh)``.
    The bundle keeps ``base``'s public metadata only, is pre-built (``jit:
    False``: the filter neither captures nor coalesces it) and carries
    ``batch_multiple`` (the data axis: the filter zero-pads an uneven
    final batch to it and trims the outputs) and its input placement."""
    from .leader import served_bundle

    apply_fn, params = param_form(base)
    infer, sharded = make_sharded_infer_step(apply_fn, params, mesh)
    axes = mesh_shape(mesh)
    dp = int(axes.get("data", 1))
    return served_bundle(
        base, lambda x: infer(sharded, x), mesh,
        f"{base.name}@{'x'.join(str(v) for v in axes.values())}",
        batch_multiple=dp)

