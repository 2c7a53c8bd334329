"""Fault policies — backoff, retry budgets, circuit breaking, deadlines.

Port of nnstreamer_tpu/resilience/policy.py (stdlib only): the same
policies, metric families and events.

The reference treats failure handling as a bounded retry counter
(``max-request-retry``, tensor_query_client.c:769-776) and leaves
degradation under partial failure to the application. This module is the
react half of the observe→react loop the obs stack opened: policies that
decide WHEN to retry, when to stop trying, and when work is no longer
worth doing at all.

Pieces (wired through query/serving by their owners, not here):

* :class:`RetryPolicy` — exponential backoff with FULL jitter
  (delay ~ U(0, min(cap, base·mult^attempt))); jitter decorrelates the
  reconnect storms the health watchdog's storm rule exists to detect.
* :class:`RetryBudget` — a single attempt allowance shared by every
  loop on one request path, so nested loops cannot multiply into
  retry² dials per frame.
* :class:`CircuitBreaker` — closed/open/half-open with a bounded probe
  count, injectable clock for deterministic tests, state exposed as the
  ``nnstpu_resilience_breaker_state`` gauge and ``resilience.breaker_*``
  events.
* :class:`Deadline` — a point in LOCAL monotonic time carried in
  ``Buffer.meta[DEADLINE_META_KEY]``; on the wire it travels as
  *remaining milliseconds* (``WIRE_KEY``), so peers never compare
  foreign clock domains. Expired work is shed
  (:func:`record_shed`) instead of queued.
"""

from __future__ import annotations

import random
import threading
import time
import weakref
from typing import Any, Callable, Optional

from ..core.log import logger
from ..obs import events as _events
from ..obs import metrics as _obs

log = logger("resilience")

#: ``Buffer.meta`` key carrying a :class:`Deadline` through the graph
DEADLINE_META_KEY = "deadline"
#: wire frame-meta key: REMAINING milliseconds at send time (a float) —
#: never an absolute stamp, so client and server clocks never mix
WIRE_KEY = "deadline_ms"

_reg = _obs.registry()
#: every shed is both a counter bump and a flight-recorder event; the
#: ``site`` label separates client-side drops from engine admission
_SHED_TOTAL = _reg.counter(
    "nnstpu_resilience_shed_total",
    "Work units dropped because their deadline had already expired",
    ("site",))
_RETRY_TOTAL = _reg.counter(
    "nnstpu_resilience_retries_total",
    "Retry attempts taken from a shared retry budget",
    ("site",))
_FALLBACK_TOTAL = _reg.counter(
    "nnstpu_resilience_fallback_total",
    "Buffers routed to a local fallback instead of the remote path",
    ("element",))
#: hedged sends are spent capacity, not free latency wins — account
#: every one so operators can see what the P95 tail costs
_HEDGE_TOTAL = _reg.counter(
    "nnstpu_resilience_hedges_total",
    "Hedged duplicate dispatches issued against slow primaries",
    ("element",))
#: 0=closed 1=half-open 2=open; sampled at collection time through a
#: weakref so the registry never pins a retired breaker
_BREAKER_STATE = _reg.gauge(
    "nnstpu_resilience_breaker_state",
    "Circuit state per breaker (0=closed, 1=half-open, 2=open)",
    ("breaker",))


# --------------------------------------------------------------------------- #
# Retry
# --------------------------------------------------------------------------- #

class RetryPolicy:
    """Exponential backoff with full jitter.

    ``delay(attempt)`` for attempt 0,1,2,… draws uniformly from
    ``[0, min(max_s, base_s * multiplier**attempt)]`` — the AWS
    "full jitter" scheme: the cap grows exponentially, the draw spreads
    retries of many clients across the whole window instead of
    synchronizing them into waves. Pass a seeded ``rng`` for
    deterministic schedules (tests, chaos runs); the default shares the
    module PRNG.
    """

    def __init__(self, base_s: float = 0.05, max_s: float = 1.0,
                 multiplier: float = 2.0, jitter: bool = True,
                 rng: Optional[random.Random] = None):
        if base_s <= 0 or max_s <= 0 or multiplier < 1.0:
            raise ValueError("base_s/max_s must be > 0, multiplier >= 1")
        self.base_s = float(base_s)
        self.max_s = float(max_s)
        self.multiplier = float(multiplier)
        self.jitter = bool(jitter)
        self._rng = rng if rng is not None else random

    def cap(self, attempt: int) -> float:
        """The un-jittered backoff ceiling for ``attempt`` (0-based)."""
        return min(self.max_s, self.base_s * self.multiplier ** max(attempt, 0))

    def delay(self, attempt: int) -> float:
        c = self.cap(attempt)
        return self._rng.uniform(0.0, c) if self.jitter else c

    def sleep(self, attempt: int) -> float:
        """Sleep the jittered delay; returns the seconds slept."""
        d = self.delay(attempt)
        if d > 0:
            time.sleep(d)
        return d


class RetryBudget:
    """A single pool of attempts shared by every retry loop on one
    request path. Each loop calls :meth:`take` before an attempt; once
    the pool drains every loop sees False — nested loops can no longer
    multiply into attempts² total tries."""

    def __init__(self, attempts: int, site: str = "query"):
        self.attempts = max(int(attempts), 1)
        self.used = 0
        self._site = site

    def take(self) -> bool:
        """Consume one attempt; False once the budget is exhausted."""
        if self.used >= self.attempts:
            return False
        if self.used > 0:
            # the first try is free capacity, not a "retry"
            _RETRY_TOTAL.labels(self._site).inc()
        self.used += 1
        return True

    @property
    def remaining(self) -> int:
        return self.attempts - self.used

    @property
    def exhausted(self) -> bool:
        return self.used >= self.attempts


# --------------------------------------------------------------------------- #
# Circuit breaker
# --------------------------------------------------------------------------- #

#: breaker states (string-valued for snapshots; gauge codes below)
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"
_STATE_CODE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    """Closed → open → half-open → closed failure gate.

    CLOSED counts consecutive failures; at ``failure_threshold`` the
    circuit opens and :meth:`allow` refuses callers for ``reset_s``.
    After the cooldown the next :meth:`allow` transitions to HALF_OPEN
    and admits up to ``half_open_probes`` probe calls: one success
    closes the circuit, one failure re-opens it (restarting the
    cooldown). The ``clock`` is injectable so tests drive the full
    transition sequence without sleeping.

    Thread-safe; transitions emit ``resilience.breaker_open`` /
    ``breaker_half_open`` / ``breaker_close`` events and the state gauge
    samples live through a weakref.
    """

    def __init__(self, name: str, failure_threshold: int = 5,
                 reset_s: float = 5.0, half_open_probes: int = 1,
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1 or reset_s < 0 or half_open_probes < 1:
            raise ValueError("failure_threshold/half_open_probes must be "
                             ">= 1, reset_s >= 0")
        self.name = name
        self.failure_threshold = int(failure_threshold)
        self.reset_s = float(reset_s)
        self.half_open_probes = int(half_open_probes)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED  # guarded-by: _lock
        self._failures = 0  # guarded-by: _lock
        self._opened_at = 0.0  # guarded-by: _lock
        self._probes = 0  # guarded-by: _lock
        ref = weakref.ref(self)
        _BREAKER_STATE.labels(name).set_function(
            lambda: (lambda b: 0 if b is None
                     else _STATE_CODE[b._state])(ref()))

    @property
    def state(self) -> str:
        with self._lock:
            # an elapsed cooldown is observable as half-open even before
            # the next allow() call lands
            if self._state == OPEN and \
                    self._clock() - self._opened_at >= self.reset_s:
                self._to_half_open()
            return self._state

    def allow(self) -> bool:
        """May a call proceed right now? Open → False; half-open → True
        for the bounded probe quota only."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self._clock() - self._opened_at < self.reset_s:
                    return False
                self._to_half_open()
            if self._probes < self.half_open_probes:
                self._probes += 1
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                self._to_closed()
            else:
                self._failures = 0

    def record_failure(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                self._to_open("probe failed")
                return
            self._failures += 1
            if self._state == CLOSED \
                    and self._failures >= self.failure_threshold:
                self._to_open(f"{self._failures} consecutive failures")

    # transitions run under self._lock (the event ring takes its own
    # independent lock; no ordering hazard)
    def _to_open(self, why: str) -> None:  # guarded-by: _lock
        self._state = OPEN
        self._opened_at = self._clock()
        self._probes = 0
        log.warning("breaker %s OPEN: %s", self.name, why)
        _events.record("resilience.breaker_open",
                       f"{self.name}: circuit opened ({why})",
                       severity="warning", breaker=self.name)

    def _to_half_open(self) -> None:  # guarded-by: _lock
        self._state = HALF_OPEN
        self._probes = 0
        _events.record("resilience.breaker_half_open",
                       f"{self.name}: cooldown elapsed, probing",
                       breaker=self.name)

    def _to_closed(self) -> None:  # guarded-by: _lock
        self._state = CLOSED
        self._failures = 0
        self._probes = 0
        log.info("breaker %s closed: probe succeeded", self.name)
        _events.record("resilience.breaker_close",
                       f"{self.name}: probe succeeded, circuit closed",
                       breaker=self.name)


# --------------------------------------------------------------------------- #
# Deadlines
# --------------------------------------------------------------------------- #

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
    """Account one shed work unit: counter + ``resilience.shed`` event
    (one flag check each while obs is off)."""
    _SHED_TOTAL.labels(site).inc()
    _events.record("resilience.shed", message, severity="warning",
                   site=site, **attrs)


def record_fallback(element: str, message: str, **attrs: Any) -> None:
    """Account one buffer routed to a local fallback path."""
    _FALLBACK_TOTAL.labels(element).inc()
    _events.record("resilience.fallback", message, element=element, **attrs)


def record_hedge(element: str, message: str, **attrs: Any) -> None:
    """Account one hedged duplicate dispatch (query.router)."""
    _HEDGE_TOTAL.labels(element).inc()
    _events.record("resilience.hedge", message, element=element, **attrs)


def backend_breaker_name(owner: str, endpoint: str) -> str:
    """Canonical breaker name for one backend of a routed set —
    ``query:<owner>:<endpoint>`` — so the per-breaker state gauge
    separates backends instead of aggregating a fleet into one series.
    Cardinality is bounded by the configured backend set."""
    return f"query:{owner}:{endpoint}"


def fleet_breaker_name(controller: str) -> str:
    """Canonical breaker name for a fleet controller's scale actions —
    ``fleet:<controller>`` — a run of failed worker launches opens the
    breaker so the reconcile loop stops hammering a broken launch path
    instead of flapping. Cardinality: one per controller (usually 1)."""
    return f"fleet:{controller}"
