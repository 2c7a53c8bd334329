"""Leader/follower invoke of a sharded bundle across ranks (port-only).

The JAX package serves a mesh-sharded program from one process: the
filter calls it and XLA drives every device. Here each rank is a process,
so a sharded bundle that ``tensor_filter`` serves (``parallel.
sharded_bundle``, ``models.moe_transformer.ep_bundle``) runs as a
leader/follower protocol over the ranks of its mesh:

  * every rank builds the same served bundles, in the same order (in
    lockstep, as ``TPLMEngine``'s ranks make the same submits); each one
    is registered with its mesh's ``Session`` under its index k;
  * rank 0, the leader, owns the pipeline: its filter calls the bundle,
    and each call (``Session.invoke``) first broadcasts a fixed header of
    ``HEADER`` int64 slots — op, bundle index k, dtype, ndim, dims — then
    the batch, zero-padded to the bundle's ``batch_multiple``, through
    ``mesh.broadcast`` over the whole mesh;
  * the other ranks run ``follow(served)``: they take each header, receive
    the batch into a tensor of its shape and run bundle k's sharded
    function, whose collectives meet the leader's; the outputs are
    gathered over ``data`` and the leader trims the padding rows;
  * stopping the leader's pipeline closes its filter, which calls
    ``Session.stop``: the ``OP_STOP`` header, after which every follower
    returns from ``follow`` with its counts.

The ops are ``OP_INVOKE`` (run bundle k, which also selects it: a
leader's reload to another bundle of the session needs no message of its
own) and ``OP_STOP``. A follower waits for a header in a collective, so
it never waits past the process group's timeout (parallel/launch.py): a
leader that fails or hangs fails its followers, and the parent's
``RankGroup.run`` raises ``RankError``. No path falls back to serving
unsharded.

A served bundle's function issues collectives, so it must run exactly
once an invoke on the leader: the filter never captures it in a CUDA
graph (a capture runs a signature eagerly first, which would issue the
collectives twice on the leader alone) and never coalesces it
(``metadata["jit"] is False``, filters/torch_cuda.py).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from .mesh import broadcast, mesh_device

__all__ = ["Session", "session_of", "served_bundle", "follow", "HEADER",
           "OP_INVOKE", "OP_STOP"]

#: int64 slots of a header: op, bundle index, dtype code, ndim, dims
HEADER = 16
_MAX_DIMS = HEADER - 4
OP_INVOKE, OP_STOP = 1, 2
_DTYPES = (torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64,
           torch.float16, torch.bfloat16, torch.float32, torch.float64,
           torch.bool)

#: the live sessions of this process, by id of their mesh
_SESSIONS: Dict[int, "Session"] = {}
_registry_lock = threading.Lock()


class Session:
    """The served bundles of one mesh on this rank, by index, and the
    protocol's state: the leader's invoke count, the followers' too."""

    def __init__(self, mesh: Any) -> None:
        self.mesh = mesh
        self.device = mesh_device(mesh)
        self.leader = dist.get_rank() == 0
        self.fns: List[Tuple[Callable[[torch.Tensor], Any], int]] = []
        self.invokes = 0
        self.stopped = False
        self._lock = threading.Lock()

    def add(self, fn: Callable[[torch.Tensor], Any], batch_multiple: int) -> int:
        """Register a sharded function; its index k."""
        self.fns.append((fn, int(batch_multiple)))
        return len(self.fns) - 1

    def _send(self, hdr: torch.Tensor) -> torch.Tensor:
        return broadcast(hdr, self.mesh, None)

    def invoke(self, k: int, x: Any) -> Any:
        """The leader's call of bundle ``k`` on the whole batch ``x``: the
        header, the padded batch, the sharded run; the outputs trimmed
        back to ``x``'s batch."""
        if not self.leader:
            raise RuntimeError(f"rank {dist.get_rank()} follows: a sharded "
                               "bundle is called on rank 0; run follow(served)")
        x = torch.as_tensor(x).to(self.device).contiguous()
        if x.dim() > _MAX_DIMS or x.dtype not in _DTYPES:
            raise ValueError(f"sharded invoke: unsupported input "
                             f"{tuple(x.shape)} {x.dtype}")
        fn, mult = self.fns[k]
        batch = int(x.shape[0]) if x.dim() else 1
        pad = (-batch) % mult if mult > 1 and x.dim() else 0
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        hdr = torch.zeros(HEADER, dtype=torch.int64)
        hdr[:4] = torch.tensor([OP_INVOKE, k, _DTYPES.index(x.dtype), x.dim()])
        hdr[4:4 + x.dim()] = torch.tensor(x.shape, dtype=torch.int64)
        with self._lock:
            if self.stopped:
                raise RuntimeError("the sharded session is stopped")
            self._send(hdr.to(self.device))
            x = broadcast(x, self.mesh, None)
            out = fn(x)
            self.invokes += 1
        if not pad:
            return out
        return _trim(out, batch, batch + pad)

    def stop(self) -> None:
        """End the session: the leader sends ``OP_STOP`` (once); every
        follower then returns from ``follow``."""
        with self._lock:
            if self.stopped:
                return
            self.stopped = True
            if self.leader:
                hdr = torch.zeros(HEADER, dtype=torch.int64)
                hdr[0] = OP_STOP
                self._send(hdr.to(self.device))
        self._unregister()

    def _unregister(self) -> None:
        with _registry_lock:
            if _SESSIONS.get(id(self.mesh)) is self:
                del _SESSIONS[id(self.mesh)]

    def follow(self) -> Dict[str, Any]:
        """A follower's loop: serve the leader's invokes until ``OP_STOP``;
        returns {"invokes": n}."""
        if self.leader:
            raise RuntimeError("rank 0 leads: it serves the pipeline")
        blank = torch.zeros(HEADER, dtype=torch.int64, device=self.device)
        while True:
            op, k, code, ndim, *dims = self._send(blank).tolist()
            if op == OP_STOP:
                self.stopped = True
                self._unregister()
                return {"invokes": self.invokes}
            if op != OP_INVOKE:
                raise RuntimeError(f"sharded follower: unknown op {op}")
            x = torch.empty(dims[:ndim], dtype=_DTYPES[code], device=self.device)
            self.fns[k][0](broadcast(x, self.mesh, None))
            self.invokes += 1


def _trim(out: Any, batch: int, padded: int) -> Any:
    """Each batch-led output (leading dim == the padded batch) cut back to
    ``batch`` rows; others as they are."""
    if isinstance(out, (tuple, list)):
        return type(out)(_trim(o, batch, padded) for o in out)
    if isinstance(out, torch.Tensor) and out.dim() and out.shape[0] == padded:
        return out[:batch]
    return out


def session_of(mesh: Any) -> Session:
    """This rank's session of ``mesh`` (made at its first served bundle)."""
    with _registry_lock:
        sess = _SESSIONS.get(id(mesh))
        if sess is None or sess.mesh is not mesh:
            sess = _SESSIONS[id(mesh)] = Session(mesh)
        return sess


def served_bundle(base: Any, fn: Callable[[torch.Tensor], Any], mesh: Any,
                  name: str, batch_multiple: Optional[int] = None) -> Any:
    """A ModelBundle serving ``fn`` (the sharded function of the whole
    batch, run on every rank) through the leader/follower protocol: its
    ``apply`` is the leader's invoke. The metadata is ``base``'s public
    keys (its private ones — the filter's graph and quant caches on the
    bundle — would serve the unsharded program) with ``jit: False`` (a
    pre-built program), the input placement, the session and, when given,
    ``batch_multiple`` (the filter pads an uneven batch to it)."""
    from ..models.zoo import ModelBundle

    sess = session_of(mesh)
    k = sess.add(fn, batch_multiple or 1)
    meta = {key: v for key, v in base.metadata.items() if not key.startswith("_")}
    if batch_multiple is not None:
        meta["batch_multiple"] = int(batch_multiple)
    return ModelBundle(
        name, lambda x: sess.invoke(k, x), device=sess.device,
        in_info=base.in_info, out_info=base.out_info,
        metadata={**meta, "jit": False, "input_sharding": sess.device,
                  "session": sess})


def follow(served: Any) -> Dict[str, Any]:
    """Run the follower's loop of ``served``'s session (every rank but the
    leader calls it after building the same served bundles); returns when
    the leader stops."""
    return served.metadata["session"].follow()
