"""CUDA graphs: one captured program per static signature.

The port's counterpart of ``jax.jit``'s shape-keyed cache. The JAX package
compiles the filter's whole invoke and the LM engine's prefill, decode
chunk and verify window once per static shape and dispatches one program
per call; eager PyTorch would launch every kernel of those programs from
Python each call. ``CapturedFn`` captures each signature once into a
``torch.cuda.CUDAGraph`` and replays it:

  * the key is every positional tensor's shape, dtype, stride and device,
    plus the keyword arguments, which the callable receives as static
    values (Python values that select the program, as ``jax.jit``'s
    ``static_argnames``);
  * the first call of a key runs the callable eagerly on a side stream —
    its result is the call's result, and it builds the kernels, sets their
    attributes and lets cuDNN and cuBLAS choose — then captures the
    callable on static copies of the tensors, in ``thread_local`` mode (the
    pipeline's other threads keep copying to and from the card meanwhile);
  * a later call copies its tensors into the static copies (a tensor that
    is its own static copy is not copied), replays the graph and returns
    clones of the static outputs, since downstream elements keep a frame's
    outputs past the next replay;
  * tensors the callable reaches other than through its arguments (weights,
    an engine's slot state) are used in place: they must stay where they
    are for as long as the graphs live;
  * one memory pool (``Pool``) is shared by an owner's graphs; every graph
    keeps its static outputs, and replays run in stream order, so graphs
    of one pool may replay in any order;
  * a capture that fails raises, naming the callable, as ``jax.jit``
    refuses a function that syncs on a tracer; nothing falls back to eager
    on the card;
  * CPU tensors (a CPU has no graphs) and calls inside ``disabled()`` run
    the callable eagerly.

Launch counts keep meaning "launches that ran on the device": the kernel
wrappers add to their counts through ``count``, which, while this thread
captures, records the launch into the graph instead; every replay then
adds the graph's recorded launches. ``stats()`` reports the process's
captures, replays and eager warm-ups.
"""

from __future__ import annotations

import contextlib
import gc
import threading
from typing import Any, Callable, Dict, Hashable, Iterator, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

_lock = threading.Lock()
_local = threading.local()
_disabled = 0
_STATS = {"captures": 0, "replays": 0, "warmups": 0}
#: captures holding the garbage collector off, and whether it ran before
_gc_holds = 0
_gc_was_enabled = False

#: a recorded launch: (counter owner, attribute, key of a dict attribute or None)
Launch = Tuple[Any, str, Optional[str]]


@contextlib.contextmanager
def disabled() -> Iterator[None]:
    """Run every ``CapturedFn`` of the process eagerly while inside (the
    counterpart of ``jax.disable_jit()``): the eager reference a replay is
    held against."""
    global _disabled
    with _lock:
        _disabled += 1
    try:
        yield
    finally:
        with _lock:
            _disabled -= 1


def enabled() -> bool:
    """False inside ``disabled()``."""
    return _disabled == 0


def stats() -> Dict[str, int]:
    """The process's graph captures, replays and eager warm-ups."""
    with _lock:
        return dict(_STATS)


def reset_stats() -> None:
    with _lock:
        for k in _STATS:
            _STATS[k] = 0


def _bump(owner: Any, name: str, key: Optional[str]) -> None:
    if key is None:
        setattr(owner, name, getattr(owner, name) + 1)
    else:
        getattr(owner, name)[key] += 1


def count(owner: Any, name: str = "launches", key: Optional[str] = None) -> None:
    """Add one launch to ``owner.<name>`` (``owner.<name>[key]`` for a dict
    of counts). While this thread captures a graph the launch is recorded
    into the graph, which adds it on every replay."""
    rec = getattr(_local, "recording", None)
    if rec is not None:
        rec.append((owner, name, key))
        return
    with _lock:
        _bump(owner, name, key)


@contextlib.contextmanager
def recording(launches: List[Launch]) -> Iterator[None]:
    """While inside, this thread's ``count`` calls append to ``launches``
    (a capture's launches) instead of adding to the counts."""
    _local.recording = launches
    try:
        yield
    finally:
        _local.recording = None


def add_launches(launches: List[Launch]) -> None:
    """Add recorded launches to their counts (a replay ran them)."""
    with _lock:
        for launch in launches:
            _bump(*launch)


def signature(args: Tuple[torch.Tensor, ...],
              static: Dict[str, Hashable]) -> Hashable:
    """The graph key of a call: each tensor's shape, dtype, stride and
    device, and the static values by name."""
    return (tuple((tuple(a.shape), a.dtype, a.stride(), a.device)
                  for a in args), tuple(sorted(static.items())))


@contextlib.contextmanager
def _no_collection() -> Iterator[None]:
    """No garbage collection while inside: a graph that died in a reference
    cycle (an engine and its programs) is destroyed when the collector runs,
    and destroying a graph is a call a capturing thread may not make — it
    invalidates the capture. The dead ones are collected first. Captures on
    several threads share one hold: the collector comes back when the last
    ends."""
    global _gc_holds, _gc_was_enabled
    gc.collect()
    with _lock:
        if _gc_holds == 0:
            _gc_was_enabled = gc.isenabled()
            gc.disable()
        _gc_holds += 1
    try:
        yield
    finally:
        with _lock:
            _gc_holds -= 1
            if _gc_holds == 0 and _gc_was_enabled:
                gc.enable()


class Pool:
    """A graph memory pool shared by one owner's ``CapturedFn``s, made at
    the first capture."""

    def __init__(self) -> None:
        self._handle = None

    def handle(self):
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle


class _Graph:
    """One captured signature: the graph, its static inputs and outputs,
    and the launches its capture recorded."""

    def __init__(self, graph: "torch.cuda.CUDAGraph",
                 static_in: Tuple[torch.Tensor, ...], static_out: Any,
                 launches: List[Launch]) -> None:
        self.graph = graph
        self.static_in = static_in
        self.out_leaves, self.out_spec = pytree.tree_flatten(static_out)
        self.launches = launches

    def replay(self, args: Tuple[torch.Tensor, ...]) -> Any:
        for s, a in zip(self.static_in, args):
            if s.data_ptr() != a.data_ptr():
                s.copy_(a)
        self.graph.replay()
        add_launches(self.launches)
        with _lock:
            _STATS["replays"] += 1
        return pytree.tree_unflatten(
            [o.clone() if isinstance(o, torch.Tensor) else o
             for o in self.out_leaves], self.out_spec)


class CapturedFn:
    """``fn(*tensors, **static)`` run as one CUDA graph per signature.

    ``name`` names the callable in errors; ``pool`` is the owner's shared
    ``Pool`` (a pool of its own when None); ``device`` is where a callable
    without tensor arguments runs (its key is its static values alone)."""

    def __init__(self, fn: Callable[..., Any], name: Optional[str] = None,
                 pool: Optional[Pool] = None, device: Any = None) -> None:
        self.fn = fn
        self.name = name or getattr(fn, "__qualname__", repr(fn))
        self.pool = pool if pool is not None else Pool()
        self.device = None if device is None else torch.device(device)
        self._graphs: Dict[Hashable, _Graph] = {}
        self._streams: Dict[torch.device, "torch.cuda.Stream"] = {}
        self._lock = threading.Lock()

    def __len__(self) -> int:
        """The signatures captured so far."""
        return len(self._graphs)

    def __call__(self, *args: torch.Tensor, **static: Hashable) -> Any:
        dev = args[0].device if args else self.device
        if dev is None or dev.type != "cuda" or _disabled \
                or getattr(_local, "recording", None) is not None:
            # eager: a CPU, disabled(), or inside another capture (which
            # takes this call's launches into its own graph)
            return self.fn(*args, **static)
        key = signature(args, static)
        with self._lock:
            g = self._graphs.get(key)
            if g is not None:
                return g.replay(args)
            out, self._graphs[key] = self._warm_and_capture(dev, args, static)
            return out

    def _warm_and_capture(self, dev: torch.device,
                          args: Tuple[torch.Tensor, ...],
                          static: Dict[str, Hashable]) -> Tuple[Any, _Graph]:
        side = self._streams.get(dev)
        if side is None:
            side = self._streams[dev] = torch.cuda.Stream(dev)
        cur = torch.cuda.current_stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self.fn(*args, **static)
            with _lock:
                _STATS["warmups"] += 1
            # normal tensors (not inference tensors): replays copy into them
            # whatever mode the caller is in
            with torch.inference_mode(False):
                static_in = tuple(a.clone() for a in args)
            graph = torch.cuda.CUDAGraph()
            launches: List[Launch] = []
            with _no_collection():
                graph.capture_begin(pool=self.pool.handle(),
                                    capture_error_mode="thread_local")
                try:
                    with recording(launches):
                        static_out = self.fn(*static_in, **static)
                except BaseException as e:
                    with contextlib.suppress(RuntimeError):
                        graph.capture_end()  # the capture is invalid already
                    raise RuntimeError(
                        f"CUDA graph capture of {self.name} failed: {e}") from e
                try:
                    graph.capture_end()
                except RuntimeError as e:
                    raise RuntimeError(
                        f"CUDA graph capture of {self.name} failed: {e}") from e
        cur.wait_stream(side)
        for o in pytree.tree_leaves(out):
            if isinstance(o, torch.Tensor) and o.device.type == "cuda":
                o.record_stream(cur)  # made on the side stream, used on cur
        with _lock:
            _STATS["captures"] += 1
        return out, _Graph(graph, static_in, static_out, launches)
