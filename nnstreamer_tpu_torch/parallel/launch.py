"""Start ranks and run functions on them: the port's launcher.

The JAX layer needs none — one process drives every device of a mesh. In
PyTorch each rank is a process, so this module starts them and hands them
work:

  * ``RankGroup(world, device=, timeout=)`` starts ``world`` processes from
    the ``spawn`` context (a parent that has touched CUDA cannot fork),
    meets them through a ``FileStore`` in a temporary directory (no port to
    race for) and gives each ``init_process_group(timeout=)``, so a
    collective that hangs fails its caller within the timeout;
  * ``group.run(fn, *args)`` runs ``fn(*args)`` on every rank and returns
    the ranks' results in rank order, tensors turned to numpy; a rank's
    exception is raised in the parent as ``RankError`` naming the rank
    (the lowest that raised, once the others answered or within a few
    seconds of the first error: a rank hung outside a collective is not
    waited for);
  * ``run_ranks(fn, world, *args)`` is one group for one call.

``fn`` travels by its import path, so rank functions live in modules that a
fresh interpreter can import (and that import no JAX: a spawned child loads
only what its function's module does).

Devices and backend (``plan``), chosen once and printed, never by a ``try``
that falls back: rank r runs on ``cuda:(r % cards)`` unless the caller asks
for the CPU. The backend is NCCL when every rank has a card of its own, and
gloo when ranks share a card (NCCL takes one rank a card) and on the CPU.
Each rank runs torch with one intra-op thread: the ranks share the host's
cores (with gloo's own threads).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import shutil
import sys
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List, Optional, Tuple

import torch

__all__ = ["RankGroup", "RankError", "run_ranks", "plan", "rank_device",
           "to_host"]

#: this process's device as a rank (set in a rank process by the launcher;
#: None elsewhere)
_RANK_DEVICE: Optional[torch.device] = None

#: seconds the parent waits for the other ranks' answers after one rank
#: raised: a rank left waiting in a collective fails within the timeout,
#: and a hung one is not waited for
_ERROR_GRACE_S = 5.0


class RankError(RuntimeError):
    """A rank raised: ``rank`` is its index, the message its traceback."""

    def __init__(self, rank: int, tb: str) -> None:
        super().__init__(f"rank {rank} raised:\n{tb}")
        self.rank = rank


def rank_device() -> torch.device:
    """The device this rank computes on: the launcher's choice inside a
    rank it started; elsewhere (a process group of the caller's own) the
    current card, by the port's rule (``core.hw.resolve_device``): it
    raises when there is none."""
    if _RANK_DEVICE is not None:
        return _RANK_DEVICE
    from ..core.hw import resolve_device

    return resolve_device("cuda")


def plan(world: int, device: Any = None,
         backend: Optional[str] = None) -> Tuple[List[str], str]:
    """(each rank's device, backend) for ``world`` ranks. ``device`` is
    "cpu" or "cuda" (default cuda, which raises without a card);
    ``backend`` overrides the choice ("gloo" on cards of their own, to
    measure it), and NCCL refuses ranks that share a card."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"CPU ranks run gloo, not {backend!r}")
        return ["cpu"] * world, "gloo"
    if kind != "cuda":
        raise ValueError(f"unsupported device {device!r} (use cuda or cpu)")
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the ranks on the CPU")
    devices = [f"cuda:{r % cards}" for r in range(world)]
    own = world <= cards
    if backend is None:
        backend = "nccl" if own else "gloo"
    if backend == "nccl" and not own:
        raise ValueError(f"NCCL takes one rank a card: {world} ranks on "
                         f"{cards} card(s)")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unsupported backend {backend!r}")
    return devices, backend


def to_host(obj: Any) -> Any:
    """Tensors in a (nested) result → numpy; everything else as is."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.cpu().numpy()
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return obj


def _rank_main(rank: int, world: int, device: str, backend: str,
               store_path: str, timeout_s: float, tasks, results) -> None:
    """A rank's process: join the group, then run tasks until told to stop."""
    global _RANK_DEVICE
    import torch.distributed as dist

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    # the ranks share the host's cores with each other and with gloo's own
    # threads: one intra-op thread a rank
    torch.set_num_threads(1)
    _RANK_DEVICE = dev
    try:
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world,
                                timeout=timedelta(seconds=timeout_s))
    except BaseException:  # the parent reports it, naming this rank
        results.put((rank, -1, False, traceback.format_exc()))
        raise
    results.put((rank, -1, True, None))
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            seq, fn, args = task
            try:
                out = to_host(fn(*args))
                results.put((rank, seq, True, out))
            except Exception:  # noqa: BLE001 — every failure goes to the parent
                results.put((rank, seq, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankGroup:
    """``world`` rank processes that run functions on demand.

    ``device`` "cpu" or "cuda" (default cuda); ``timeout`` the seconds a
    collective may wait before it fails its rank (and the default for how
    long ``run`` waits for every rank to answer, doubled, plus a minute for
    the start). A group whose rank failed or timed out is closed: its
    processes may be stuck in a collective, so ``run`` refuses after."""

    def __init__(self, world: int, device: Any = None,
                 timeout: float = 60.0, quiet: bool = False,
                 backend: Optional[str] = None) -> None:
        self.world = world
        self.devices, self.backend = plan(world, device, backend)
        self.timeout = float(timeout)
        self.closed = False
        self._seq = 0
        if not quiet:
            shared = "shared" if len(set(self.devices)) < world \
                and self.devices[0] != "cpu" else "one each"
            print(f"rank group: {world} ranks on {sorted(set(self.devices))} "
                  f"({shared}), backend {self.backend}, collective timeout "
                  f"{self.timeout:g} s", flush=True)
        ctx = mp.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="nns_ranks_")
        store = os.path.join(self._dir, "store")
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(world)]
        self._procs = [
            ctx.Process(target=_rank_main, name=f"rank{r}", daemon=True,
                        args=(r, world, self.devices[r], self.backend, store,
                              self.timeout, self._tasks[r], self._results))
            for r in range(world)]
        for p in self._procs:
            p.start()
        try:
            self._collect(-1, self.timeout + 120.0)
        except BaseException:
            self.close()
            raise

    def _collect(self, seq: int, wait: float) -> List[Any]:
        deadline = time.monotonic() + wait
        out: List[Any] = [None] * self.world
        seen: set = set()
        errors: List[Tuple[int, str]] = []
        while len(seen) < self.world:
            left = deadline - time.monotonic()
            if left <= 0:
                missing = sorted(set(range(self.world)) - seen)
                self.close(grace=0.5)  # the missing ranks are stuck
                if errors:  # the others may be hung: the error is the news
                    raise RankError(*min(errors))
                raise TimeoutError(f"ranks {missing} did not answer within "
                                   f"{wait:g} s; the group is closed")
            try:
                rank, s, ok, payload = self._results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs)
                        if r not in seen and p.exitcode is not None]
                if dead:
                    codes = {r: self._procs[r].exitcode for r in dead}
                    self.close()
                    raise RuntimeError(f"ranks {dead} exited ({codes}) "
                                       "without answering; the group is closed")
                continue
            if s != seq:
                continue  # an answer to a task a timeout abandoned
            seen.add(rank)
            if ok:
                out[rank] = payload
            else:
                if not errors:
                    deadline = min(deadline, time.monotonic() + _ERROR_GRACE_S)
                errors.append((rank, payload))
        if errors:
            self.close()
            rank, tb = min(errors)
            raise RankError(rank, tb)
        return out

    def run(self, fn: Callable[..., Any], *args: Any,
            wait: Optional[float] = None) -> List[Any]:
        """``fn(*args)`` on every rank; the results in rank order."""
        if self.closed:
            raise RuntimeError("the rank group is closed")
        self._seq += 1
        for q in self._tasks:
            q.put((self._seq, fn, args))
        return self._collect(self._seq, 2 * self.timeout + 30.0
                             if wait is None else wait)

    def close(self, grace: float = 10.0) -> None:
        """Stop every rank (asked first, terminated after ``grace`` seconds)
        and remove the rendezvous directory."""
        if self.closed:
            return
        self.closed = True
        for q in self._tasks:
            try:
                q.put(None)
            except (OSError, ValueError):
                pass
        deadline = time.monotonic() + grace
        for p in self._procs:
            p.join(max(0.0, deadline - time.monotonic()))
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(5.0)
        for q in self._tasks + [self._results]:
            q.close()
            q.join_thread()
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "RankGroup":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def __del__(self) -> None:
        if not getattr(self, "closed", True) and not sys.is_finalizing():
            self.close()


def run_ranks(fn: Callable[..., Any], world: int, *args: Any,
              timeout: float = 60.0, device: Any = None,
              quiet: bool = False, backend: Optional[str] = None) -> List[Any]:
    """``fn(*args)`` on ``world`` new ranks; their results in rank order."""
    with RankGroup(world, device=device, timeout=timeout, quiet=quiet,
                   backend=backend) as g:
        return g.run(fn, *args)

