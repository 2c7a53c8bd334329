"""Pipeline parallelism: GPipe staged execution over a mesh axis — port of
nnstreamer_tpu/parallel/stages.py.

Rank s of the ``stage`` axis holds stage s's parameters, computes its stage
each tick, and hands its activation to rank s+1 (``ppermute``): M
microbatches take M + S − 1 ticks, the (S − 1) bubble ticks included,
stage 0 injecting microbatch t at tick t. The last stage collects the
outputs, and a ``psum`` over the axis gives every rank the result, as in
the JAX program. Exactness: ``make_gpipe_apply(stage_fn, mesh)(params,
x)`` equals ``sequential_apply`` within float tolerance (the stage GEMMs
see a microbatch's rows instead of the batch's).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from .mesh import axis_index, axis_size, mesh_device, mesh_shape, ppermute, psum
from .sharding import as_tensor, tree_flatten, tree_map

__all__ = ["stack_stage_params", "sequential_apply", "make_gpipe_apply",
           "shard_stage_params"]


def stack_stage_params(per_stage_params: List[Any]) -> Any:
    """S per-stage trees → one tree of leaves with a leading stage axis
    (numpy or tensors in, tensors out, on the first leaf's device)."""
    flats = [tree_flatten(p) for p in per_stage_params]
    _, rebuild = flats[0]
    dev = None
    cols = []
    for i in range(len(flats[0][0])):
        leaves = [f[0][i][1] for f in flats]
        if dev is None:
            dev = leaves[0].device if isinstance(leaves[0], torch.Tensor) \
                else torch.device("cpu")
        cols.append(torch.stack([as_tensor(leaf, dev) for leaf in leaves]))
    return rebuild(cols)


def sequential_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                     stacked_params: Any, x: torch.Tensor) -> torch.Tensor:
    """The single-device oracle: x through all S stages in order."""
    flat, rebuild = tree_flatten(stacked_params)
    n_stages = flat[0][1].shape[0]
    for s in range(n_stages):
        x = stage_fn(rebuild([leaf[s] for _, leaf in flat]), x)
    return x


def _stage_slice(leaf: Any, idx: int) -> torch.Tensor:
    if isinstance(leaf, DTensor):
        return leaf.to_local()[0]
    return leaf[idx]


def make_gpipe_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                     mesh: Any, axis: str = "stage",
                     n_microbatches: Optional[int] = None):
    """``pipelined(stacked_params, x) -> y`` over ``mesh[axis]``'s ranks.

    ``stage_fn(stage_params, h) -> h`` keeps the activation's shape;
    ``stacked_params`` leaves carry a leading S axis (plain, or placed by
    ``shard_stage_params``); ``x`` is the whole batch (B, ...), every rank
    passing the same, split into M microbatches (default M = S). Every rank
    returns y."""
    n_stages = axis_size(mesh, axis)

    def pipelined(stacked_params: Any, x: torch.Tensor) -> torch.Tensor:
        m = n_microbatches or n_stages
        if x.shape[0] % m:
            raise ValueError(
                f"pp: batch {x.shape[0]} not divisible into {m} microbatches")
        flat, rebuild = tree_flatten(stacked_params)
        for _, leaf in flat:
            if leaf.shape[0] != n_stages:
                # a divisible mismatch (8 stages on a 4-rank axis) would
                # otherwise run only every k-th stage
                raise ValueError(
                    f"pp: stacked params carry {leaf.shape[0]} stages but "
                    f"mesh axis {axis!r} has {n_stages} devices")
        idx = axis_index(mesh, axis)
        dev = mesh_device(mesh)
        p = rebuild([as_tensor(_stage_slice(leaf, idx), dev)
                     for _, leaf in flat])
        micro = as_tensor(x, dev).reshape((m, x.shape[0] // m) + tuple(x.shape[1:]))
        perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
        state = torch.zeros_like(micro[0])
        outbuf = torch.zeros_like(micro)
        for t in range(m + n_stages - 1):
            # stage 0 injects microbatch t (clamped past the end: that
            # result never reaches the collection window)
            h = micro[min(t, m - 1)] if idx == 0 else state
            y = stage_fn(p, h)
            o = t - (n_stages - 1)
            if idx == n_stages - 1 and o >= 0:
                outbuf[o] = y
            state = ppermute(y, mesh, axis, perm)
        # only the last stage holds results; the sum replicates them
        out = psum(outbuf, mesh, axis)
        return out.reshape((-1,) + tuple(out.shape[2:]))

    return pipelined


def shard_stage_params(stacked_params: Any, mesh: Any,
                       axis: str = "stage") -> Any:
    """Place stacked stage params with the leading axis over ``axis``: each
    rank keeps its own stage (a DTensor, sharded on dim 0 over ``axis``,
    replicated over the other axes)."""
    names = list(mesh_shape(mesh))
    dev = mesh_device(mesh)
    placements = [Shard(0) if a == axis else Replicate() for a in names]
    return tree_map(lambda leaf: distribute_tensor(
        as_tensor(leaf, dev), mesh, placements, src_data_rank=None),
        stacked_params)
