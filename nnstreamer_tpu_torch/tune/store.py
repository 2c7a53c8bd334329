"""Persistent knob store: ``(device_kind, label, shape_sig, knob)`` →
chosen value.

The store is the autotuner's memory. Every resolution the
:class:`~nnstreamer_tpu_torch.tune.tuner.Tuner` makes — a measured sweep, a
cost-model pick, or a fleet adoption — lands here keyed by where it is
valid: the device kind (block shapes tuned on one TPU generation do not
transfer to another), the dispatch label (the profiler's kernel/filter
identity), and a caller-supplied shape signature (the knob's value is
shape-dependent: a 2048-token flash dispatch wants different blocks
than an 8192-token one).

On-disk format (``version`` 1) is a flat JSON object so the fleet layer
can ship it verbatim inside push docs:

    {"version": 1,
     "entries": {"<device>|<label>|<sig>|<knob>":
                 {"value": ..., "source": "sweep|model|fleet|observed",
                  "cost_us": 12.3, "ts": 1700000000.0}}}

``value`` is any JSON scalar or list (callers coerce — e.g. the flash
site unpacks a 2-list back into ``(block_q, block_k)``). ``cost_us`` is
the measured/predicted cost of the chosen value when known; fleet
merges prefer the lower-cost entry when both sides know one.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Any, Dict, Optional

STORE_VERSION = 1

#: hard cap on entries shipped in one fleet push doc — the push body is
#: size-bounded (obs/fleet.py MAX_PUSH_BYTES); a store can grow without
#: bound locally but federation ships only the newest slice
MAX_PUSH_ENTRIES = 256


def key_of(device: str, label: str, shape_sig: str, knob: str) -> str:
    return f"{device}|{label}|{shape_sig}|{knob}"


class TuneStore:
    """Dict-of-records with atomic JSON persistence.

    Single-threaded by contract like the rest of the knob plumbing: the
    tuner consults it from dispatch sites, and the fleet adoption hook
    runs on the pusher thread — adoption therefore goes through
    :meth:`merge_doc`, which only ever replaces whole records (a dict
    swap, atomic under the GIL).
    """

    def __init__(self, path: Optional[str] = None) -> None:
        self.path = path
        self._entries: Dict[str, Dict[str, Any]] = {}
        self.dirty = False
        if path and os.path.exists(path):
            self.load(path)

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, device: str, label: str, shape_sig: str,
            knob: str) -> Optional[Dict[str, Any]]:
        return self._entries.get(key_of(device, label, shape_sig, knob))

    def put(self, device: str, label: str, shape_sig: str, knob: str,
            value: Any, source: str,
            cost_us: Optional[float] = None) -> Dict[str, Any]:
        rec = {"value": value, "source": source,
               "cost_us": None if cost_us is None else float(cost_us),
               "ts": time.time()}
        self._entries[key_of(device, label, shape_sig, knob)] = rec
        self.dirty = True
        return rec

    def entries(self) -> Dict[str, Dict[str, Any]]:
        return dict(self._entries)

    # -- persistence ---------------------------------------------------- #
    def load(self, path: Optional[str] = None) -> int:
        p = path or self.path
        if not p:
            return 0
        with open(p, "r", encoding="utf-8") as f:
            doc = json.load(f)
        if doc.get("version") != STORE_VERSION:
            raise ValueError(
                f"tune store {p}: unsupported version {doc.get('version')!r}")
        ents = doc.get("entries")
        if isinstance(ents, dict):
            self._entries.update(
                {k: v for k, v in ents.items() if isinstance(v, dict)})
        self.dirty = False
        return len(self._entries)

    def save(self, path: Optional[str] = None) -> Optional[str]:
        p = path or self.path
        if not p:
            return None
        doc = {"version": STORE_VERSION, "entries": self._entries}
        # atomic replace: a crashed save never truncates the store a
        # warm restart was counting on
        d = os.path.dirname(os.path.abspath(p)) or "."
        fd, tmp = tempfile.mkstemp(prefix=".tune-", dir=d)
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(doc, f, sort_keys=True)
            os.replace(tmp, p)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self.dirty = False
        return p

    # -- federation ----------------------------------------------------- #
    def to_doc(self) -> Dict[str, Any]:
        """The slice of the store a fleet push carries: newest-first,
        capped at :data:`MAX_PUSH_ENTRIES`."""
        items = sorted(self._entries.items(),
                       key=lambda kv: kv[1].get("ts") or 0.0,
                       reverse=True)[:MAX_PUSH_ENTRIES]
        return {"version": STORE_VERSION, "entries": dict(items)}

    def merge_doc(self, doc: Any) -> int:
        """Adopt entries from a fleet-shipped doc. A remote record wins
        only where this store has nothing for the key, or where the
        remote knows a strictly lower measured cost — a local sweep is
        never overwritten by a lossier remote pick. Returns how many
        records were adopted."""
        if not isinstance(doc, dict):
            return 0
        ents = doc.get("entries")
        if not isinstance(ents, dict):
            return 0
        n = 0
        for k, rec in ents.items():
            if not isinstance(rec, dict) or "value" not in rec:
                continue
            mine = self._entries.get(k)
            if mine is not None:
                rc, mc = rec.get("cost_us"), mine.get("cost_us")
                if rc is None or (mc is not None and rc >= mc):
                    continue
            self._entries[k] = {"value": rec["value"], "source": "fleet",
                                "cost_us": rec.get("cost_us"),
                                "ts": rec.get("ts") or time.time()}
            n += 1
        if n:
            self.dirty = True
        return n
