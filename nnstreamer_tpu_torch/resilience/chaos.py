"""Deterministic chaos injection — seeded fault plans for the wire and
the graph; port of nnstreamer_tpu/resilience/chaos.py (the same plans fire
the same faults at the same calls in both packages).

Testing the resilience policies used to require hand-rolled socket
games (kill a server mid-recv, hope the timing lands). This harness
makes faults first-class and REPRODUCIBLE: a :class:`FaultPlan` is a
seeded schedule of drop/delay/corrupt/disconnect/kill faults, fired either
on the Nth matching call or probabilistically from a per-fault PRNG —
the same seed always yields the same schedule, independent of wall
clock and (per target) of thread interleaving.

Injection points (the hosting modules own the hook variables so this
module is never imported on the hot path):

* ``query.protocol.CHAOS_HOOK`` — called at the top of
  ``send_message`` (target ``"send"``) and after each frame in
  ``recv_message`` (target ``"recv"``); returning ``None`` drops the
  frame, raising propagates into the caller's error handling.
* ``graph.element.CHAOS_CHAIN_HOOK`` — called by ``Pad.push`` before
  the peer's chain (target ``"chain:<element-name>"``); truthy return
  drops the buffer (the graph's legal drop semantics).

Both hooks are module globals that are ``None`` unless a plan is
installed — the disabled cost is one global load + ``is None`` check,
the same zero-overhead contract as tracing. Enable via
:func:`install`, or the ``NNS_TPU_CHAOS`` environment variable (a JSON
plan, honored by ``nns-launch``; see :func:`plan_from_env`).
"""

from __future__ import annotations

import json
import os
import random
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..core.log import logger
from ..obs import events as _events
from ..obs import metrics as _obs

log = logger("chaos")

#: environment variable carrying a JSON fault plan (nns-launch honors it)
ENV_VAR = "NNS_TPU_CHAOS"

KINDS = ("drop", "delay", "corrupt", "disconnect", "partition", "kill")

_INJECTED_TOTAL = _obs.registry().counter(
    "nnstpu_chaos_injected_total",
    "Faults fired by the installed fault plan", ("kind",))

#: endpoint -> kill handle for the ``kill`` fault kind: a launched
#: backend's pid (int), a Popen-like object exposing ``.pid``, or a
#: zero-arg callable (how tests SIGKILL an in-process worker shim).
#: A plain dict guarded by its own lock — registration happens at
#: launch/teardown time, never on the wire hot path, and the hook only
#: reads it after a fault already fired.
_KILL_TARGETS: Dict[str, Any] = {}
_KILL_LOCK = threading.Lock()


def register_kill_target(endpoint: str, target: Any) -> None:
    """Make ``endpoint`` killable by a planned ``kill`` fault.

    ``target`` is SIGKILLed when the fault fires: an int pid, an
    object with ``.pid`` (subprocess.Popen), or a zero-arg callable
    (in-process workers — tests register ``worker.kill``). Launchers
    register their children here so a chaos plan can crash exactly one
    backend of a routed set, no drain, no goodbye."""
    with _KILL_LOCK:
        _KILL_TARGETS[str(endpoint)] = target


def unregister_kill_target(endpoint: str) -> None:
    with _KILL_LOCK:
        _KILL_TARGETS.pop(str(endpoint), None)


def _do_kill(endpoint: Optional[str]) -> str:
    """SIGKILL the registered target for ``endpoint``; returns a
    human-readable note for the audit event. An unregistered endpoint
    is a no-op beyond the note — the fault still severs the frame, so
    the plan's schedule is unchanged either way."""
    with _KILL_LOCK:
        target = _KILL_TARGETS.get(str(endpoint))
    if target is None:
        return f"no kill target registered for {endpoint}"
    if callable(target):
        target()
        return f"killed in-process target for {endpoint}"
    pid = getattr(target, "pid", target)
    os.kill(int(pid), signal.SIGKILL)
    return f"SIGKILLed pid {int(pid)} ({endpoint})"


@dataclass
class Fault:
    """One fault rule inside a :class:`FaultPlan`.

    ``target`` is ``"send"`` / ``"recv"`` (the query wire; ``cmd``
    optionally restricts to one command name, e.g. ``"DATA"`` so the
    INFO handshake survives) or ``"chain:<element>"`` (a specific sink
    element; bare ``"chain"`` matches every element). ``endpoint``
    narrows a wire fault to one peer (``"host:port"`` as seen by the
    socket) — how a plan kills exactly one backend of a routed set.
    Fire selection: ``nth`` (an int or collection of ints, 1-based call
    numbers within the matching stream) is exact; otherwise ``p`` draws
    per matching call from the fault's own seeded PRNG. ``max_fires``
    caps total fires without disturbing the draw sequence.

    Kind ``partition`` is stateful: once its nth/p trigger fires, the
    fault latches and EVERY subsequent matching frame raises
    ConnectionError — one side of a network partition, not a one-shot
    disconnect. The latch counts as a single fire in the audit log.

    Kind ``kill`` SIGKILLs the backend behind the matched frame (the
    fault's ``endpoint`` names the victim; see
    :func:`register_kill_target`) and then raises ConnectionError —
    a planned crash with no drain and no goodbye, for the
    fleet/checkpoint restore acceptance tests. Subsequent frames to
    the dead endpoint fail naturally, so ``max_fires=1`` is the usual
    spelling.
    """

    kind: str
    target: str = "send"
    cmd: Optional[str] = None
    endpoint: Optional[str] = None
    nth: Any = None
    p: float = 0.0
    delay_s: float = 0.01
    max_fires: Optional[int] = None
    nth_set: frozenset = field(init=False, repr=False)

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(one of {KINDS})")
        if self.nth is None:
            self.nth_set = frozenset()
        elif isinstance(self.nth, int):
            self.nth_set = frozenset({self.nth})
        else:
            self.nth_set = frozenset(int(n) for n in self.nth)

    def matches(self, target: str, cmd: Optional[str],
                endpoint: Optional[str] = None) -> bool:
        if self.target == "chain":
            if not target.startswith("chain:"):
                return False
        elif self.target != target:
            return False
        if self.endpoint is not None and self.endpoint != endpoint:
            return False
        return self.cmd is None or self.cmd == cmd


class FaultPlan:
    """A seeded, deterministic schedule of faults.

    Each fault owns a PRNG seeded from ``(seed, fault_index)`` and a
    counter of *matching* calls, so its fire schedule is a pure function
    of the plan and the per-target call sequence — two plans built from
    the same spec make identical decisions (the determinism test pins
    this). ``fired`` is an audit log of every injection.
    """

    def __init__(self, faults: List[Fault], seed: int = 0):
        self.seed = int(seed)
        self.faults = list(faults)
        self._lock = threading.Lock()
        self._counts = [0] * len(self.faults)
        self._fires = [0] * len(self.faults)
        # partition faults latch: once triggered they fire on every
        # subsequent matching frame until the plan is uninstalled
        self._latched = [False] * len(self.faults)
        self._latch_pending: List[Fault] = []
        # per-fault PRNG, seeded from (seed, index) mixed into one int
        # (tuple seeding is deprecated); large odd multiplier keeps
        # nearby seeds from producing overlapping streams
        self._rngs = [random.Random(self.seed * 1_000_003 + i)
                      for i in range(len(self.faults))]
        self.fired: List[Dict[str, Any]] = []

    @classmethod
    def from_spec(cls, spec: Dict[str, Any]) -> "FaultPlan":
        """Build from a JSON-shaped dict:
        ``{"seed": 7, "faults": [{"kind": "drop", "target": "send",
        "cmd": "DATA", "p": 0.1}, ...]}``."""
        faults = [Fault(**f) for f in spec.get("faults", ())]
        return cls(faults, seed=int(spec.get("seed", 0)))

    def decide(self, target: str, cmd: Optional[str] = None,
               endpoint: Optional[str] = None) -> List[Fault]:
        """Advance the schedule one call at ``target``; returns the
        faults that fire on this call (usually zero or one)."""
        hits: List[Fault] = []
        with self._lock:
            for i, f in enumerate(self.faults):
                if not f.matches(target, cmd, endpoint):
                    continue
                if self._latched[i]:
                    # partition already triggered: fires silently on
                    # every matching frame (audited once, at the latch)
                    hits.append(f)
                    continue
                self._counts[i] += 1
                n = self._counts[i]
                if f.nth_set:
                    fire = n in f.nth_set
                elif f.p > 0.0:
                    # always draw so capped faults keep the sequence
                    fire = self._rngs[i].random() < f.p
                else:
                    fire = False
                if fire and (f.max_fires is None
                             or self._fires[i] < f.max_fires):
                    self._fires[i] += 1
                    if f.kind == "partition":
                        self._latched[i] = True
                        self._latch_pending.append(f)
                    self.fired.append({"kind": f.kind, "target": target,
                                       "cmd": cmd, "endpoint": endpoint,
                                       "call": n})
                    hits.append(f)
        return hits

    def heal(self) -> None:
        """Release every latched partition (the net heals); the rest of
        the schedule continues where it left off."""
        with self._lock:
            self._latched = [False] * len(self.faults)
            self._latch_pending.clear()

    def take_latch_notice(self, f: Fault) -> bool:
        """True exactly once per latch of ``f`` — lets the hook emit
        the partition event/log at the latch moment instead of on
        every subsequently blocked frame."""
        with self._lock:
            try:
                self._latch_pending.remove(f)
                return True
            except ValueError:
                return False


_ACTIVE: Optional[FaultPlan] = None


def active() -> Optional[FaultPlan]:
    return _ACTIVE


def _corrupt(payload: bytes) -> bytes:
    """Deterministically damage a payload (first byte inverted) — enough
    to fail deserialization/checksums without hiding which frame it was."""
    if not payload:
        return payload
    return bytes([payload[0] ^ 0xFF]) + payload[1:]


def _fire(f: Fault, target: str, detail: str) -> None:
    _INJECTED_TOTAL.labels(f.kind).inc()
    log.warning("chaos: injected %s at %s (%s)", f.kind, target, detail)
    _events.record("chaos.inject",
                   f"injected {f.kind} at {target} ({detail})",
                   severity="warning", kind=f.kind, target=target)


def _wire_hook(direction: str, cmd: Any, meta: Dict[str, Any],
               payload: bytes,
               endpoint: Optional[str] = None) -> Optional[bytes]:
    """Installed as ``protocol.CHAOS_HOOK``. Returns the (possibly
    corrupted) payload, or None to drop the frame; raises
    ConnectionError for an injected disconnect or an active partition.
    ``endpoint`` is the socket's peer (``"host:port"``) when the
    protocol layer can resolve it — how endpoint-scoped faults single
    out one backend of a routed set."""
    plan = _ACTIVE
    if plan is None:
        return payload
    name = getattr(cmd, "name", str(cmd))
    for f in plan.decide(direction, name, endpoint):
        if f.kind == "partition":
            # frames keep dying while the partition holds, but the
            # event/log land once, at the latch; the counter tracks
            # every blackholed frame
            if plan.take_latch_notice(f):
                _fire(f, direction, f"cmd={name} endpoint={endpoint}")
            else:
                _INJECTED_TOTAL.labels(f.kind).inc()
            raise ConnectionError(
                f"chaos: partition active ({direction} {name} "
                f"endpoint={endpoint})")
        if f.kind == "kill":
            # kill -9 the backend BEHIND this frame (no drain, no
            # goodbye), then die like the severed connection the peer
            # would actually see. The fault's own endpoint wins over
            # the frame's — a recv-side plan can still name its victim
            note = _do_kill(f.endpoint or endpoint)
            _fire(f, direction, f"cmd={name} {note}")
            raise ConnectionError(
                f"chaos: backend killed ({direction} {name} "
                f"endpoint={f.endpoint or endpoint})")
        _fire(f, direction, f"cmd={name}" if endpoint is None
              else f"cmd={name} endpoint={endpoint}")
        if f.kind == "delay":
            time.sleep(f.delay_s)
        elif f.kind == "disconnect":
            raise ConnectionError(
                f"chaos: injected disconnect ({direction} {name})")
        elif f.kind == "corrupt":
            payload = _corrupt(payload)
        elif f.kind == "drop":
            return None
    return payload


def _poison_value(dtype: Any) -> Any:
    """The poison for one dtype, numpy's classification of it: NaN for
    floating and complex dtypes, the dtype's max for integers, 1 for the
    rest (bool, and bfloat16, which numpy's ``ml_dtypes`` type does not
    class as floating: the JAX package's poison of a bfloat16 frame is
    ones, and so is this one)."""
    import torch

    if isinstance(dtype, torch.dtype):
        if dtype in (torch.float16, torch.float32, torch.float64) \
                or dtype.is_complex:
            return float("nan")
        if dtype is torch.bool or dtype is torch.bfloat16 \
                or dtype.is_floating_point:
            return 1
        return torch.iinfo(dtype).max
    import numpy as np

    if np.issubdtype(dtype, np.floating) \
            or np.issubdtype(dtype, np.complexfloating):
        return np.nan
    if np.issubdtype(dtype, np.integer):
        return np.iinfo(dtype).max
    return 1


def _poison_buffer(buf: Any) -> None:
    """Graph-side corrupt: silently wreck the buffer's first tensor
    *in place* (value-semantically — the TensorMemory is replaced, not
    mutated). Float dtypes become all-NaN, integer dtypes saturate to
    the dtype max, anything else goes constant-ones (:func:`_poison_value`).
    Unlike the wire corrupt (which fails deserialization loudly), this is
    the quiet failure mode real accelerator bugs produce: data keeps
    flowing, wrong — exactly what obs/quality's NaN-storm and dead-output
    rules exist to catch.

    A tensor is poisoned where it lives: a torch tensor (on the card or
    the CPU) becomes a filled torch tensor on its own device, so a card
    frame is never copied down and up again for it; a host array becomes
    a filled host array. Quality taps read host copies only, so a
    poisoned card frame counts as ``skipped_device`` there."""
    import numpy as np
    import torch

    from ..core.buffer import TensorMemory

    if not getattr(buf, "memories", None):
        return
    mem = buf.memories[0]
    if mem.is_device:
        t = mem.device()
        out = torch.full_like(t, _poison_value(t.dtype))
        buf.memories[0] = TensorMemory(out, info=mem.info)
        return
    arr = np.array(mem.host(), copy=True)
    arr[...] = _poison_value(arr.dtype)
    buf.memories[0] = TensorMemory(arr, info=mem.info)


def _chain_hook(element: str, buf: Any) -> bool:
    """Installed as ``element.CHAOS_CHAIN_HOOK``. True drops the
    buffer; delay sleeps in the pushing thread; corrupt NaN-poisons the
    buffer's first tensor and lets it flow on (see
    :func:`_poison_buffer`); disconnect/partition raise (the graph
    turns that into a bus error)."""
    plan = _ACTIVE
    if plan is None:
        return False
    target = f"chain:{element}"
    drop = False
    for f in plan.decide(target):
        _fire(f, target, f"pts={buf.pts}")
        if f.kind == "delay":
            time.sleep(f.delay_s)
        elif f.kind == "drop":
            drop = True
        elif f.kind == "corrupt":
            _poison_buffer(buf)
        else:
            raise RuntimeError(f"chaos: injected {f.kind} at {target}")
    return drop


def install(plan: FaultPlan) -> FaultPlan:
    """Activate a plan: point the protocol and graph hook globals at
    this module. Imports are lazy — an idle chaos module never touches
    the hot-path modules."""
    global _ACTIVE
    from ..graph import element as _element
    from ..query import protocol as _protocol

    _ACTIVE = plan
    _protocol.CHAOS_HOOK = _wire_hook
    _element.CHAOS_CHAIN_HOOK = _chain_hook
    _events.record("chaos.install",
                   f"fault plan installed (seed={plan.seed}, "
                   f"{len(plan.faults)} faults)", seed=plan.seed)
    return plan


def uninstall() -> None:
    """Deactivate: hooks back to None (the zero-overhead state)."""
    global _ACTIVE
    from ..graph import element as _element
    from ..query import protocol as _protocol

    _protocol.CHAOS_HOOK = None
    _element.CHAOS_CHAIN_HOOK = None
    _ACTIVE = None


def plan_from_env() -> Optional[FaultPlan]:
    """Parse :data:`ENV_VAR` into a plan (None when unset/invalid —
    a malformed plan is reported, never fatal: chaos must not be able
    to take a pipeline down by typo)."""
    raw = os.environ.get(ENV_VAR)
    if not raw:
        return None
    try:
        return FaultPlan.from_spec(json.loads(raw))
    except (ValueError, TypeError, KeyError) as e:
        log.warning("%s ignored (bad plan: %s)", ENV_VAR, e)
        return None
