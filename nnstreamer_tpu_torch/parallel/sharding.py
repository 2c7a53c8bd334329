"""Parameter placement over a mesh — port of nnstreamer_tpu/parallel/
sharding.py with ``DTensor`` placements in place of GSPMD's
``NamedSharding``s.

The rule is the JAX package's, shape-driven:
  * a leaf whose trailing (output-feature) axis divides by the ``model``
    axis size shards that axis over ``model`` (``Shard`` of the last dim);
  * everything else, and every leaf on a mesh without a ``model`` axis of
    size > 1, is replicated.
Every other mesh dimension (``data``) replicates. ``shard_params`` gives
each leaf as a ``DTensor``: each rank keeps its own chunk, cut from the
full value every rank holds (``src_data_rank=None``: no scatter, since the
ranks build the same tree from the same seed or file).
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from .mesh import all_gather, mesh_device, mesh_shape

__all__ = ["param_spec", "shard_params", "param_shardings", "tree_map",
           "tree_flatten", "as_tensor", "full_value"]


def tree_flatten(tree: Any, path: str = ""
                 ) -> Tuple[List[Tuple[str, Any]], Callable[[List[Any]], Any]]:
    """(path, leaf) pairs of a nested dict/list/tuple in key order, and the
    function that rebuilds the tree from new leaves. Paths join keys with
    "/", as the JAX package's key paths print."""
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [tree_flatten(tree[k], f"{path}/{k}" if path else str(k))
                 for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = list(range(len(tree)))
        parts = [tree_flatten(v, f"{path}/{i}" if path else str(i))
                 for i, v in enumerate(tree)]
    else:
        return [(path, tree)], lambda leaves: leaves[0]
    flat: List[Tuple[str, Any]] = []
    sizes = []
    for leaves, _ in parts:
        flat += leaves
        sizes.append(len(leaves))

    def rebuild(leaves: List[Any]) -> Any:
        out, i = [], 0
        for (_, sub), n in zip(parts, sizes):
            out.append(sub(leaves[i:i + n]))
            i += n
        if isinstance(tree, dict):
            return dict(zip(keys, out))
        return type(tree)(out)

    return flat, rebuild


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and of same-shaped ``rest``)."""
    flat, rebuild = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return rebuild([fn(leaf, *(o[i][1] for o in others))
                    for i, (_, leaf) in enumerate(flat)])


def full_value(t: Any) -> Any:
    """A DTensor's whole value on every rank, gathered through
    parallel/mesh.py's ``all_gather`` over each sharded mesh dimension;
    anything else as it is. (Under gloo with the ranks on one card, ranks
    that gathered through ``DTensor.full_tensor`` died with SIGSEGV in the
    sharded train step; through ``all_gather`` they run.)"""
    if not isinstance(t, DTensor):
        return t
    out = t.to_local()
    mesh = t.device_mesh
    for i, pl in enumerate(t.placements):
        if isinstance(pl, Shard):
            out = all_gather(out, mesh, mesh.mesh_dim_names[i], dim=pl.dim)
    return out


def as_tensor(leaf: Any, device: torch.device) -> torch.Tensor:
    """A numpy or torch leaf as a tensor on ``device`` (a DTensor's full
    value)."""
    if isinstance(leaf, DTensor):
        leaf = full_value(leaf)
    if isinstance(leaf, np.ndarray):
        leaf = torch.from_numpy(np.ascontiguousarray(leaf))
    return torch.as_tensor(leaf).to(device)


def param_spec(path: str, shape: Tuple[int, ...], mesh: Any) -> List[Any]:
    """The placements of one leaf, one per mesh dimension. ``path`` is the
    leaf's key path (for rule overrides); the rule is shape-driven."""
    axes = mesh_shape(mesh)
    tp = axes.get("model", 1)
    shards = bool(shape) and tp > 1 and shape[-1] % tp == 0 \
        and shape[-1] >= tp
    return [Shard(len(shape) - 1) if shards and name == "model"
            else Replicate() for name in axes]


def shard_params(params: Any, mesh: Any) -> Any:
    """Place a parameter tree on the mesh per ``param_spec``: each leaf a
    DTensor holding this rank's chunk."""
    dev = mesh_device(mesh)
    flat, rebuild = tree_flatten(params)
    placed = []
    for path, leaf in flat:
        t = as_tensor(leaf, dev)
        placed.append(distribute_tensor(t, mesh, param_spec(path, tuple(t.shape), mesh),
                                        src_data_rank=None))
    return rebuild(placed)


def param_shardings(params: Any, mesh: Any) -> Any:
    """The matching tree of placements."""
    flat, rebuild = tree_flatten(params)
    return rebuild([param_spec(path, tuple(np.shape(leaf)) if not isinstance(
        leaf, torch.Tensor) else tuple(leaf.shape), mesh) for path, leaf in flat])
