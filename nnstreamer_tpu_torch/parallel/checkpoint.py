"""Sharded train-state checkpoints: save from a mesh, restore to a mesh —
port of nnstreamer_tpu/parallel/checkpoint.py.

The format is ``torch.distributed.checkpoint`` over the DTensor state, a
directory of each rank's shards and one metadata file, where the JAX
package writes an orbax directory: the port does not depend on orbax, and
the port never reads JAX's orbax directories (a chosen divergence, pinned by
tests/test_torch_parallel.py). As in JAX:

  * ``save_sharded_state(path, params, opt_state=None)`` writes the logical
    arrays of a (possibly sharded) state; every rank calls it;
  * ``restore_sharded_state(path, params_like, mesh=, opt_state_like=)``
    reads them straight into the placement ``param_spec`` gives on
    ``mesh`` — which may differ from the mesh the state was saved on (each
    rank reads the chunks its new placement needs) — with each moment of
    the optimizer state placed as its parameter; without ``mesh``, every
    leaf comes back whole as numpy;
  * either side may be partial: a params-only restore of a full checkpoint
    leaves the stored optimizer state unread, and an ``opt_state_like``
    against a params-only checkpoint returns ``opt_state=None``.

``params_like``/``opt_state_like`` give shapes and dtypes (their values are
not read): trees of tensors, DTensors or numpy arrays.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.distributed.checkpoint as dcp
from torch.distributed.tensor import distribute_tensor

from .mesh import mesh_device
from .sharding import full_value, param_spec, tree_flatten

__all__ = ["save_sharded_state", "restore_sharded_state"]


def _flat_state(tree: Any, prefix: str) -> Dict[str, Any]:
    flat, _ = tree_flatten(tree)
    return {f"{prefix}/{path}": leaf for path, leaf in flat}


def save_sharded_state(path: str, params: Any, opt_state: Any = None) -> None:
    """Write a train state (leaves DTensors on any mesh, or tensors) as one
    ``torch.distributed.checkpoint`` directory. ``opt_state=None`` saves
    params only."""
    if path.endswith(".msgpack"):
        raise ValueError(
            "sharded checkpoints are directories; the flat .msgpack format "
            "(utils/checkpoints.save_variables) has no restore path here — "
            "use a directory path")
    state = _flat_state(params, "params")
    if opt_state is not None:
        state.update(_flat_state(opt_state, "opt_state"))
    dcp.save(state, checkpoint_id=os.path.abspath(path))


def _shape_dtype(leaf: Any) -> Tuple[Tuple[int, ...], torch.dtype]:
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), leaf.dtype
    a = np.asarray(leaf)
    return tuple(a.shape), torch.from_numpy(np.zeros((), a.dtype)).dtype


def _target(like: Any, prefix: str, mesh: Any,
            placements_of: Any) -> Tuple[Dict[str, Any], Any]:
    """(the flat target state, the rebuild of the tree) for ``like``."""
    flat, rebuild = tree_flatten(like)
    state: Dict[str, Any] = {}
    for path, leaf in flat:
        shape, dtype = _shape_dtype(leaf)
        if mesh is None:
            state[f"{prefix}/{path}"] = torch.empty(shape, dtype=dtype)
        else:
            full = torch.empty(shape, dtype=dtype, device=mesh_device(mesh))
            state[f"{prefix}/{path}"] = distribute_tensor(
                full, mesh, placements_of(path, shape), src_data_rank=None)
    return state, rebuild


def _saved_keys(path: str) -> set:
    reader = dcp.FileSystemReader(path)
    return set(reader.read_metadata().state_dict_metadata)


def restore_sharded_state(path: str, params_like: Any, mesh: Any = None,
                          opt_state_like: Any = None) -> Tuple[Any, Any]:
    """(params, opt_state) read into ``mesh``'s placements (DTensors), or
    whole as numpy without ``mesh``. ``opt_state=None`` when the caller
    gave no template or the checkpoint holds none."""
    abspath = os.path.abspath(path)
    saved = _saved_keys(abspath)
    has_opt = any(k.startswith("opt_state/") for k in saved)
    want_opt = opt_state_like is not None and has_opt
    p_flat, _ = tree_flatten(params_like)
    by_path = {p: _shape_dtype(leaf)[0] for p, leaf in p_flat}

    def param_placements(p: str, shape: Tuple[int, ...]):
        return param_spec(p, shape, mesh)

    def opt_placements(p: str, shape: Tuple[int, ...]):
        # a moment is placed as the parameter whose path it extends (the
        # state tree is the params tree with each leaf replaced by its
        # optimizer state); scalars (the step count) replicate
        owner = max((q for q in by_path if p.startswith(q + "/")),
                    key=len, default=None)
        if owner is None or tuple(by_path[owner]) != tuple(shape):
            return param_spec(p, (), mesh)
        return param_spec(owner, shape, mesh)

    state, p_rebuild = _target(params_like, "params", mesh, param_placements)
    o_rebuild = None
    if want_opt:
        o_state, o_rebuild = _target(opt_state_like, "opt_state", mesh,
                                     opt_placements)
        state.update(o_state)
    missing = sorted(set(state) - saved)
    if missing:
        raise ValueError(f"checkpoint {path} lacks {missing[:4]} "
                         f"({len(missing)} leaves)")
    dcp.load(state, checkpoint_id=abspath)

    def out(prefix: str, like: Any, rebuild: Any) -> Any:
        flat, _ = tree_flatten(like)
        leaves = [state[f"{prefix}/{p}"] for p, _ in flat]
        if mesh is None:
            leaves = [full_value(t).cpu().numpy() for t in leaves]
        return rebuild(leaves)

    params = out("params", params_like, p_rebuild)
    opt = out("opt_state", opt_state_like, o_rebuild) if want_opt else None
    return params, opt
