"""Device meshes and the collectives every parallel module calls — port of
nnstreamer_tpu/parallel/mesh.py on ``torch.distributed``.

The JAX layer has one controller: a single process drives a ``Mesh`` of
devices and writes per-device code under ``shard_map`` with explicit
collectives. PyTorch's idiom is one process per rank (parallel/launch.py
starts them), so here a mesh is a ``torch.distributed.device_mesh.
DeviceMesh`` with named dimensions over the ranks of the default process
group, the ``shard_map`` body is the rank's own code, and the JAX
primitives are the small functions below, named after them:

  * ``psum`` / ``pmax``  → ``all_reduce`` SUM / MAX over the axis's group;
    under gloo on CUDA tensors (ranks sharing one card) an ``all_gather``
    and the reduction in coordinate order, which ``scripts/psum_ab.py``
    timed faster there, in turns, inside the TP decode step;
  * ``ppermute``         → a rotation: paired ``isend``/``irecv``; under
    gloo on CUDA tensors an ``all_to_all_single`` with one non-empty split
    each way, since gloo's send/recv takes no CUDA tensor (the rank
    aborts, "writev ... Bad address"), while its all_reduce, broadcast,
    all_gather and all_to_all_single do (``scripts/probe_torch_dist.py``
    on the H100);
  * ``all_to_all``       → ``all_to_all_single`` in JAX's tiled form;
  * ``all_gather``       → ``all_gather_into_tensor`` (gloo on CUDA
    tensors: ``all_gather`` of a list, the form the probe ran;
    ``sharding.full_value`` gathers a DTensor through it);
  * ``axis_index``       → ``DeviceMesh.get_local_rank(axis)``.

Every module calls these, so a backend difference is handled here, once,
by the process group's backend and the tensor's device, never by a ``try``
that falls back. The CPU ranks of the tests take the forms NCCL takes. The
collectives return new tensors and leave their inputs as they were, as the
JAX primitives do.

``COLLECTIVE_CLOCK``: None (the default) or a dict the helpers add each
call's host-clock seconds and count to, by operation, with the device
synchronised before and after the call so the time is the collective's own
(a measurement aid; it serialises the stream).

Axes: ``data`` (batch / data parallel) × ``model`` (tensor parallel), and
``sp``, ``stage`` and ``expert`` for sequence, pipeline and expert
parallelism.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["make_mesh", "auto_mesh_2d", "mesh_shape", "mesh_device",
           "axis_size", "axis_index", "axis_group", "psum", "pmax",
           "ppermute", "all_to_all", "all_gather", "broadcast",
           "world"]

#: None, or {op: [calls, seconds]} that every collective adds to (see above)
COLLECTIVE_CLOCK: Optional[Dict[str, List[float]]] = None


class _clocked:
    """Time one collective into ``COLLECTIVE_CLOCK`` (a no-op while None)."""

    def __init__(self, op: str, t: torch.Tensor) -> None:
        self.op, self.cuda = op, t.is_cuda

    def __enter__(self) -> None:
        if COLLECTIVE_CLOCK is not None:
            if self.cuda:
                torch.cuda.synchronize()
            self.t0 = time.perf_counter()

    def __exit__(self, *exc: object) -> None:
        if COLLECTIVE_CLOCK is not None:
            if self.cuda:
                torch.cuda.synchronize()
            rec = COLLECTIVE_CLOCK.setdefault(self.op, [0, 0.0])
            rec[0] += 1
            rec[1] += time.perf_counter() - self.t0


def world() -> int:
    """Ranks in the default process group (1 outside one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _device_type() -> str:
    """The ranks' device type: cuda when this rank was placed on a card
    (parallel/launch.py sets the current device), else cpu."""
    from .launch import rank_device

    return rank_device().type


def make_mesh(axes: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence[int]] = None) -> DeviceMesh:
    """Build a mesh over the ranks. ``axes`` maps axis name → size; the
    sizes' product must equal the number of ranks. Default: all ranks on
    ``data`` (pure data parallelism). ``devices`` is the ranks, in mesh
    order (default every rank in order); the port takes every rank, as
    each rank must build the mesh."""
    n_ranks = world()
    ranks = list(range(n_ranks)) if devices is None else list(devices)
    if axes is None:
        axes = {"data": len(ranks)}
    need = math.prod(axes.values())
    if need != len(ranks):
        raise ValueError(f"mesh axes {axes} need {need} devices, "
                         f"have {len(ranks)}")
    if ranks != list(range(n_ranks)):
        raise ValueError(f"a mesh spans every rank in order; got ranks "
                         f"{ranks} of {n_ranks}")
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: run the code on ranks "
            "started by parallel/launch.py (run_ranks / RankGroup)")
    return init_device_mesh(_device_type(), tuple(axes.values()),
                            mesh_dim_names=tuple(axes.keys()))


def auto_mesh_2d(n_devices: Optional[int] = None,
                 model_parallel: Optional[int] = None) -> DeviceMesh:
    """data×model mesh: the largest model axis <= sqrt(n) that divides n
    (or an explicit ``model_parallel``)."""
    n = n_devices or world()
    if model_parallel is None:
        model_parallel = 1
        for m in range(int(math.isqrt(n)), 0, -1):
            if n % m == 0:
                model_parallel = m
                break
    if n % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide "
                         f"n={n}")
    return make_mesh({"data": n // model_parallel, "model": model_parallel},
                     devices=list(range(n)))


def mesh_shape(mesh: DeviceMesh) -> Dict[str, int]:
    """Axis name → size, JAX's ``mesh.shape``."""
    return {name: int(mesh.size(i))
            for i, name in enumerate(mesh.mesh_dim_names)}


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on the mesh (launch.py made it current)."""
    from .launch import rank_device

    return rank_device()


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh_shape(mesh)[axis]


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (``lax.axis_index``)."""
    return int(mesh.get_local_rank(axis))


def axis_group(mesh: DeviceMesh, axis: str):
    return mesh.get_group(axis)


def _backend(group) -> str:
    return str(dist.get_backend(group)).lower()


def _gloo_cuda(group, x: torch.Tensor) -> bool:
    """Gloo on a CUDA tensor: the ranks share a card (launch.py's plan)."""
    return x.is_cuda and _backend(group) == "gloo"


def _reduce(x: torch.Tensor, mesh: DeviceMesh, axis: str, op,
            name: str) -> torch.Tensor:
    out = x.contiguous().clone()
    n = axis_size(mesh, axis)
    if n == 1:
        return out
    group = axis_group(mesh, axis)
    with _clocked(name, out):
        if _gloo_cuda(group, out):
            # the decode step's small activations cross faster gathered and
            # reduced here, in coordinate order (every rank the same bits),
            # than through gloo's all_reduce (scripts/psum_ab.py)
            parts = [torch.empty_like(out) for _ in range(n)]
            dist.all_gather(parts, out, group=group)
            out = parts[0]
            for p in parts[1:]:
                out = out + p if op == dist.ReduceOp.SUM else torch.maximum(out, p)
        else:
            dist.all_reduce(out, op=op, group=group)
    return out


def psum(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """Sum over ``axis`` (``lax.psum``); every rank gets the sum."""
    return _reduce(x, mesh, axis, dist.ReduceOp.SUM, "psum")


def pmax(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """Elementwise maximum over ``axis`` (``lax.pmax``)."""
    return _reduce(x, mesh, axis, dist.ReduceOp.MAX, "pmax")


def _group_ranks(mesh: DeviceMesh, axis: str) -> List[int]:
    return dist.get_process_group_ranks(axis_group(mesh, axis))


def ppermute(x: torch.Tensor, mesh: DeviceMesh, axis: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute``: ``perm`` lists (source, destination) pairs of axis
    coordinates; each rank gets the tensor its source sent, zeros when no
    pair names it as a destination. An isend pairs with an irecv; gloo
    on CUDA tensors exchanges through all_to_all_single with one non-empty
    split each way."""
    n = axis_size(mesh, axis)
    me = axis_index(mesh, axis)
    x = x.contiguous()
    if n == 1:
        return x.clone() if (0, 0) in list(perm) else torch.zeros_like(x)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"ppermute: {perm} sends or receives twice at {me}")
    group = axis_group(mesh, axis)
    out = torch.zeros_like(x)
    if _gloo_cuda(group, x):
        numel = x.numel()
        ins = [numel if dst and j == dst[0] else 0 for j in range(n)]
        outs = [numel if src and j == src[0] else 0 for j in range(n)]
        with _clocked("ppermute", x):
            dist.all_to_all_single(out.view(-1), x.view(-1),
                                   output_split_sizes=outs,
                                   input_split_sizes=ins, group=group)
        return out
    ranks = _group_ranks(mesh, axis)
    ops = []
    if dst:
        ops.append(dist.P2POp(dist.isend, x, ranks[dst[0]], group))
    if src:
        ops.append(dist.P2POp(dist.irecv, out, ranks[src[0]], group))
    with _clocked("ppermute", x):
        for w in dist.batch_isend_irecv(ops) if ops else []:
            w.wait()
    return out


def all_to_all(x: torch.Tensor, mesh: DeviceMesh, axis: str,
               split_axis: int, concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all(..., tiled=True)``: ``x`` is cut into n equal
    chunks along ``split_axis``, chunk j goes to coordinate j, and the
    chunks received are joined along ``concat_axis`` in source order."""
    n = axis_size(mesh, axis)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} "
                         f"not divisible by {axis}={n}")
    if n == 1:
        return x.clone()
    chunks = torch.stack(x.chunk(n, dim=split_axis)).contiguous()
    recv = torch.empty_like(chunks)
    with _clocked("all_to_all", chunks):
        dist.all_to_all_single(recv, chunks, group=axis_group(mesh, axis))
    return torch.cat(list(recv.unbind(0)), dim=concat_axis)


def all_gather(x: torch.Tensor, mesh: DeviceMesh, axis: str,
               dim: int = 0) -> torch.Tensor:
    """Every coordinate's ``x`` joined along ``dim`` in coordinate order
    (``lax.all_gather(..., tiled=True)``)."""
    n = axis_size(mesh, axis)
    x = x.contiguous()
    if n == 1:
        return x.clone()
    group = axis_group(mesh, axis)
    with _clocked("all_gather", x):
        if _gloo_cuda(group, x):
            # the list form (the one scripts/probe_torch_dist.py ran)
            parts = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(parts, x, group=group)
        else:
            # flat: the one layout every backend takes
            out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
            dist.all_gather_into_tensor(out, x.view(-1), group=group)
            parts = list(out.view((n,) + tuple(x.shape)).unbind(0))
    return torch.cat(parts, dim=dim)


def broadcast(x: torch.Tensor, mesh: DeviceMesh, axis: Optional[str],
              src: int = 0) -> torch.Tensor:
    """Coordinate ``src``'s ``x`` on every rank of the axis; with ``axis``
    None, rank ``src``'s on every rank of the mesh (which spans them all,
    ``make_mesh``) in one call."""
    out = x.contiguous().clone()
    if axis is None:
        if mesh.size() > 1:
            with _clocked("broadcast", out):
                dist.broadcast(out, src)
    elif axis_size(mesh, axis) > 1:
        ranks = _group_ranks(mesh, axis)
        with _clocked("broadcast", out):
            dist.broadcast(out, ranks[src], group=axis_group(mesh, axis))
    return out
