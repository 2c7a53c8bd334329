"""Deadlines — port of the deadline section of
nnstreamer_tpu/resilience/policy.py.

* :class:`Deadline` — a point in LOCAL monotonic time carried in
  ``Buffer.meta[DEADLINE_META_KEY]``; on the wire it travels as
  *remaining milliseconds*, so peers never compare foreign clock domains.
  Expired work is shed (:func:`record_shed`) instead of queued.

``record_shed`` keeps the JAX signature. The JAX package also counts each
shed in ``nnstpu_resilience_shed_total`` and records a ``resilience.shed``
event; both wait for the port of obs (ROADMAP §A7). The rest of the JAX
module (RetryPolicy, RetryBudget, CircuitBreaker, fallback and hedge
accounting) waits for the query layer (§A8).
"""

from __future__ import annotations

import time
from typing import Any, Optional

from ..core.log import logger

log = logger("resilience")

#: ``Buffer.meta`` key carrying a :class:`Deadline` through the graph
DEADLINE_META_KEY = "deadline"


class Deadline:
    """A point in local monotonic time after which work is worthless.

    Created from a relative budget (:meth:`after_ms`); compared only
    against the local monotonic clock. Crossing the wire it is encoded
    as *remaining* milliseconds (:meth:`to_wire`) and re-anchored on the
    receiver's clock (:meth:`from_wire`) — transit time is absorbed into
    the budget rather than mis-credited by comparing two hosts' clocks.
    """

    __slots__ = ("at",)

    def __init__(self, at: float):
        self.at = float(at)  # monotonic seconds

    @classmethod
    def after_ms(cls, ms: float) -> "Deadline":
        return cls(time.monotonic() + float(ms) / 1e3)

    @classmethod
    def after_s(cls, s: float) -> "Deadline":
        return cls(time.monotonic() + float(s))

    def remaining_s(self) -> float:
        return self.at - time.monotonic()

    def expired(self) -> bool:
        return time.monotonic() >= self.at

    def to_wire(self) -> float:
        """Remaining budget in milliseconds (floored at 0)."""
        return max(self.remaining_s(), 0.0) * 1e3

    @classmethod
    def from_wire(cls, ms: Any) -> Optional["Deadline"]:
        try:
            return cls.after_ms(float(ms))
        except (TypeError, ValueError):
            return None

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Deadline(remaining={self.remaining_s() * 1e3:.1f}ms)"


def deadline_of(buf: Any) -> Optional[Deadline]:
    """The :class:`Deadline` riding on a buffer, if any."""
    d = buf.meta.get(DEADLINE_META_KEY)
    return d if isinstance(d, Deadline) else None


def set_deadline(buf: Any, deadline: Deadline) -> None:
    buf.meta[DEADLINE_META_KEY] = deadline


def record_shed(site: str, message: str, **attrs: Any) -> None:
    """Account one shed work unit. The JAX package's counter and event
    wait for obs (ROADMAP §A7); the shed is logged at debug level."""
    log.debug("shed at %s: %s %s", site, message, attrs or "")
