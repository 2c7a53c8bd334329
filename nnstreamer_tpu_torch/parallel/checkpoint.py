"""Sharded train-state checkpoints: save from a mesh, restore to a mesh —
port of nnstreamer_tpu/parallel/checkpoint.py.

``save_sharded_state`` writes ``torch.distributed.checkpoint`` over the
DTensor state, a directory of each rank's shards and one metadata file,
where the JAX package writes an orbax directory (a chosen divergence of the
save side, pinned by tests/test_torch_parallel.py). ``restore_sharded_state``
reads both: its own directories, and the orbax directories the JAX
package's ``save_sharded_state`` writes (utils/orbax_dir.py; every rank
reads the logical arrays and keeps its placement's part). As in JAX:

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
not read): trees of tensors, DTensors or numpy arrays. The port's optimizer
state is the params tree with each leaf replaced by its optimizer's state
(``{"0": {"trace": ...}, "1": {}}``); in an orbax directory the JAX package
stores optax's, the moments' trees under ``opt_state/<i>/<name>/`` and one
``count`` for all leaves, which a restore maps leaf by leaf.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.distributed.checkpoint as dcp
from torch.distributed.tensor import distribute_tensor

from ..utils import orbax_dir
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


def _placements(params_like: Any, mesh: Any):
    """(placements of a params path, placements of an opt_state path)."""
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

    return param_placements, opt_placements


def restore_sharded_state(path: str, params_like: Any, mesh: Any = None,
                          opt_state_like: Any = None) -> Tuple[Any, Any]:
    """(params, opt_state) read into ``mesh``'s placements (DTensors), or
    whole as numpy without ``mesh``. ``opt_state=None`` when the caller
    gave no template or the checkpoint holds none."""
    abspath = os.path.abspath(path)
    if orbax_dir.is_orbax_dir(abspath):
        return _restore_orbax(abspath, params_like, mesh, opt_state_like)
    saved = _saved_keys(abspath)
    has_opt = any(k.startswith("opt_state/") for k in saved)
    want_opt = opt_state_like is not None and has_opt
    param_placements, opt_placements = _placements(params_like, mesh)
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


def _optax_paths(p: str) -> Tuple[str, ...]:
    """Where an orbax directory of the JAX package keeps the port's
    optimizer-state leaf ``p`` (``<param path>/<i>/<name>``): the port's own
    path, optax's moment ``<i>/<name>/<param path>``, or optax's one
    ``<i>/<name>`` (the count)."""
    parts = p.split("/")
    if len(parts) < 3:
        return (p,)
    leaf, i, name = "/".join(parts[:-2]), parts[-2], parts[-1]
    return (p, f"{i}/{name}/{leaf}", f"{i}/{name}")


def _restore_orbax(path: str, params_like: Any, mesh: Any,
                   opt_state_like: Any) -> Tuple[Any, Any]:
    """restore_sharded_state of an orbax directory: the logical arrays,
    read whole on every rank, cast to the template's dtypes and cut to
    this rank's placement."""
    stored, _ = tree_flatten(orbax_dir.load(path))
    saved = {p: leaf for p, leaf in stored}
    param_placements, opt_placements = _placements(params_like, mesh)

    def place(value: Any, like: Any, p: str, placements_of: Any) -> Any:
        shape, dtype = _shape_dtype(like)
        a = np.array(value)  # a copy; 0-d stays 0-d
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            if a.dtype.name == "bfloat16" else torch.from_numpy(a)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"checkpoint {path}: {p} has shape "
                             f"{tuple(t.shape)}, the template {tuple(shape)}")
        t = t.to(dtype)
        if mesh is None:
            return t.numpy()
        return distribute_tensor(t.to(mesh_device(mesh)), mesh,
                                 placements_of(p, shape), src_data_rank=None)

    def read(prefix: str, like: Any, candidates: Any, placements_of: Any):
        flat, rebuild = tree_flatten(like)
        leaves, missing = [], []
        for p, leaf in flat:
            key = next((f"{prefix}/{c}" for c in candidates(p)
                        if f"{prefix}/{c}" in saved), None)
            if key is None:
                missing.append(f"{prefix}/{p}")
                continue
            leaves.append(place(saved[key], leaf, p, placements_of))
        if missing:
            raise ValueError(f"checkpoint {path} lacks {missing[:4]} "
                             f"({len(missing)} leaves)")
        return rebuild(leaves)

    params = read("params", params_like, lambda p: (p,), param_placements)
    has_opt = any(p.startswith("opt_state/") for p in saved)
    opt = read("opt_state", opt_state_like, _optax_paths, opt_placements) \
        if opt_state_like is not None and has_opt else None
    return params, opt
