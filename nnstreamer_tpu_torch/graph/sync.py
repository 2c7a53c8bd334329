"""Time-synchronization policies for N-input collection (mux/merge/crop).

Port of nnstreamer_tpu/graph/sync.py, unchanged in behaviour: the policies
and ``CollectPads`` are pure Python over the port's ``Buffer``.

Equivalent of the reference's sync engine (tensor_common.h:62-69 policies
NOSYNC/SLOWEST/BASEPAD/REFRESH; logic tensor_common_pipeline.c; documented in
Documentation/synchronization-policies-at-mux-merge.md):

  * ``nosync``  — combine in arrival order: emit when every pad has a buffer.
  * ``slowest`` — sync on the slowest pad: base PTS = max of head PTS across
    pads; older buffers on faster pads are dropped (keep nearest ≤ base).
  * ``basepad`` — base PTS from a designated pad (option "idx:duration_ns");
    other pads pick their buffer nearest the base within the duration window.
  * ``refresh`` — emit on every new arrival on any pad, re-using the last
    seen buffer of the other pads.

``CollectPads`` is the GstCollectPads stand-in: per-pad FIFOs + a policy that
yields ready frame-sets. Thread-safe; chain calls may arrive from multiple
streaming threads.
"""

from __future__ import annotations

import collections
import enum
import threading
from typing import Deque, Dict, List, Optional, Tuple

from ..core.buffer import Buffer


class SyncPolicy(enum.Enum):
    NOSYNC = "nosync"
    SLOWEST = "slowest"
    BASEPAD = "basepad"
    REFRESH = "refresh"

    @classmethod
    def parse(cls, s) -> "SyncPolicy":
        if isinstance(s, SyncPolicy):
            return s
        return cls(str(s).strip().lower())


def _pts(buf: Buffer) -> int:
    return buf.pts if buf.pts is not None else 0


class CollectPads:
    """Collects buffers from N named inputs and yields synchronized sets.

    ``push(key, buf)`` returns a list of ready sets; each set is a dict
    ``key → Buffer`` plus the chosen output PTS. ``set_eos(key)`` marks an
    input finished; ``exhausted`` turns True when no further set can ever be
    produced (mux forwards EOS then).
    """

    def __init__(self, keys: List[str], policy: SyncPolicy = SyncPolicy.SLOWEST,
                 base_key: Optional[str] = None, base_duration_ns: int = 0):
        self.keys = list(keys)
        self.policy = policy
        self.base_key = base_key if base_key is not None else (self.keys[0] if self.keys else None)
        self.base_duration_ns = base_duration_ns
        self._queues: Dict[str, Deque[Buffer]] = {k: collections.deque() for k in self.keys}
        self._last: Dict[str, Optional[Buffer]] = {k: None for k in self.keys}
        self._eos: Dict[str, bool] = {k: False for k in self.keys}
        self._lock = threading.Lock()

    def add_key(self, key: str) -> None:
        with self._lock:
            self.keys.append(key)
            self._queues[key] = collections.deque()
            self._last[key] = None
            self._eos[key] = False
            if self.base_key is None:
                self.base_key = key

    # ------------------------------------------------------------------ #
    def push(self, key: str, buf: Buffer) -> List[Tuple[Dict[str, Buffer], Optional[int]]]:
        with self._lock:
            self._queues[key].append(buf)
            self._last[key] = buf
            out = []
            while True:
                s = self._try_collect(trigger=key)
                if s is None:
                    break
                out.append(s)
                if self.policy is SyncPolicy.REFRESH:
                    break  # refresh emits exactly once per arrival
            return out

    def set_eos(self, key: str) -> List[Tuple[Dict[str, Buffer], Optional[int]]]:
        with self._lock:
            self._eos[key] = True
            out = []
            while True:
                s = self._try_collect(trigger=None)
                if s is None:
                    break
                out.append(s)
            return out

    @property
    def exhausted(self) -> bool:
        """No further output possible: some pad is EOS with an empty queue
        (refresh: all pads EOS)."""
        with self._lock:
            if self.policy is SyncPolicy.REFRESH:
                return all(self._eos.values())
            return any(self._eos[k] and not self._queues[k] for k in self.keys)

    # ------------------------------------------------------------------ #
    def _try_collect(self, trigger: Optional[str]):
        if self.policy is SyncPolicy.REFRESH:
            if trigger is None:
                return None
            if all(self._last[k] is not None for k in self.keys):
                s = {k: self._last[k] for k in self.keys}
                # consume the trigger buffer; others stay as "last"
                if self._queues[trigger]:
                    self._queues[trigger].popleft()
                return s, _pts(s[trigger])
            if self._queues[trigger]:
                self._queues[trigger].popleft()  # buffered as last already
            return None

        live = [k for k in self.keys if not (self._eos[k] and not self._queues[k])]
        if len(live) < len(self.keys):
            # a pad is finished: no complete set can form (caller checks
            # `exhausted` and forwards EOS)
            return None
        if not all(self._queues[k] for k in self.keys):
            return None

        if self.policy is SyncPolicy.NOSYNC:
            s = {k: self._queues[k].popleft() for k in self.keys}
            return s, _pts(s[self.keys[0]])

        if self.policy is SyncPolicy.SLOWEST:
            base = max(_pts(q[0]) for q in self._queues.values() if q)
        else:  # BASEPAD
            base = _pts(self._queues[self.base_key][0])

        window = self.base_duration_ns
        chosen: Dict[str, Buffer] = {}
        for k in self.keys:
            q = self._queues[k]
            # drop stale buffers strictly older than base (outside window)
            while len(q) > 1 and _pts(q[0]) + window < base and _pts(q[1]) <= base:
                q.popleft()
            if not q:
                return None
            chosen[k] = q[0]
        for k in self.keys:
            self._queues[k].popleft()
        return chosen, base
