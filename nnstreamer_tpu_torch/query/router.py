"""query.router — health-routed multi-backend offload; port of
nnstreamer_tpu/query/router.py.

The query client (client.py) talks to exactly one ``tensor_query``
server: one dead backend means degraded-local-fallback for the whole
pipeline. This module turns that point-to-point link into a routed
fleet — a :class:`BackendSet` of N servers behind one
:class:`QueryRouter` that keeps serving through backend loss:

* **Placement** is least-loaded-of-two-random-choices ("power of two
  choices"): draw two distinct healthy backends, dispatch to the less
  loaded. Load is the obs.fleet aggregator's per-instance
  queue-depth/readiness snapshot (``FleetAggregator.routing_view``)
  when an aggregator is attached, falling back to locally observed
  in-flight counts + EWMA latency otherwise.
* **Per-backend isolation.** Every backend owns its connection, its
  :class:`resilience.policy.CircuitBreaker` (named
  ``query:<router>:<host:port>`` so the state gauge separates
  backends), and draws dial/resend attempts from the request's one
  shared :class:`RetryBudget` — the no-retry² rule, per fleet.
* **Mid-stream failover.** A buffer whose backend dies mid-request is
  transparently re-dispatched to a healthy peer under its ORIGINAL
  deadline (``router.failover`` event + counter); the dead backend's
  breaker opens and the router stops placing there until its
  half-open probe succeeds.
* **Hedged dispatch** (``hedge_ms > 0``): a latency-critical buffer
  gets a second send to a different backend once the observed P95
  round-trip (floored at ``hedge_ms``) elapses without a response;
  first result wins, the loser's round trip completes in the
  background and is discarded (its connection stays in protocol sync)
  — "The Tail at Scale" hedging against outliers.
* **Session affinity.** ``buf.meta["session"]`` consistent-hashes
  onto the ring (stable under backend add/remove) so multi-turn LM
  requests land where their paged prefix cache lives; a dead
  affinity target spills to two-choice placement with an explicit
  ``router.spill`` event.
* **Live add/remove + graceful drain** — the autoscaling primitive:
  :meth:`BackendSet.add` / :meth:`remove`; draining a backend stops
  new placements, lets in-flight requests finish, then closes.
* **Deadline-aware admission**: an expired buffer is shed at the
  router door (``resilience.shed`` site="router"), never dispatched.

The router raises :class:`RouterError` only when every backend is
down and the budget is spent; the hosting client then takes its
existing ``fallback=`` path (health DEGRADED, not pipeline error).

Zero-overhead contract: a client without ``backends=`` never
constructs a router — the per-buffer cost is one attribute is-None
check in ``chain()``, the same contract as the chaos hooks.
"""

from __future__ import annotations

import hashlib
import random
import socket
import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .. import tune as _tune
from ..core.log import logger
from ..obs import events as _events
from ..obs import fleet as _fleet
from ..obs import metrics as _obs
from ..obs import slo as _slo
from ..obs import tracing as _tracing
from ..resilience import policy as _rp
from .protocol import (
    Cmd,
    QueryProtocolError,
    recv_message,
    send_message,
)

log = logger("query")

__all__ = ["Backend", "BackendSet", "QueryRouter", "RouterError",
           "parse_endpoints"]

#: backend lifecycle states (the ``nnstpu_router_backend_state`` gauge
#: mirrors them: 0=active, 1=draining, 2=closed)
ACTIVE = "active"
DRAINING = "draining"
CLOSED = "closed"
_STATE_CODE = {ACTIVE: 0, DRAINING: 1, CLOSED: 2}

#: bound on the session pin/owner tables (LRU-evicted) — placement
#: state, not correctness state: an evicted session just re-places
#: through the affinity ring on its next buffer
SESSION_PIN_LIMIT = 4096

#: virtual nodes per backend on the affinity hash ring — enough spread
#: that removing one backend of N only remaps ~1/N of the sessions
RING_VNODES = 32

#: EWMA smoothing for per-backend round-trip latency
EWMA_ALPHA = 0.2

#: bounded reservoir of recent round trips feeding the hedge P95
LATENCY_WINDOW = 128


class RouterError(ConnectionError):
    """Every routable backend refused/failed and the retry budget is
    spent — the caller's last resort (local fallback) takes over."""


def parse_endpoints(spec: Any) -> List[Tuple[str, int]]:
    """``"host:port,host:port"`` (or a list of such strings) into
    [(host, port)] — validated, deduplicated, order-preserving."""
    if isinstance(spec, str):
        parts = [p.strip() for p in spec.split(",")]
    else:
        parts = [str(p).strip() for p in spec]
    out: List[Tuple[str, int]] = []
    seen = set()
    for p in parts:
        if not p:
            continue
        host, sep, port_s = p.rpartition(":")
        if not sep or not host:
            raise ValueError(
                f"backend {p!r} must be host:port")
        try:
            port = int(port_s)
        except ValueError:
            raise ValueError(f"backend {p!r} has a non-integer port")
        if not 0 < port < 65536:
            raise ValueError(f"backend {p!r} port out of range")
        key = (host, port)
        if key in seen:
            raise ValueError(f"backend {p!r} listed twice")
        seen.add(key)
        out.append(key)
    return out


# --------------------------------------------------------------------------- #
# Backend: one server endpoint with its own connection + breaker
# --------------------------------------------------------------------------- #

class Backend:
    """One ``tensor_query`` server endpoint.

    Owns a lazily dialed connection (serial request/response under
    ``_wire_lock`` — concurrency across the fleet comes from different
    backends proceeding in parallel, e.g. a hedge), a circuit breaker,
    and the local load signals (in-flight count, EWMA latency) used
    when no fleet aggregator is attached. ``instance`` is the server's
    advertised obs.fleet instance id (INFO_APPROVE handshake), joining
    this endpoint to its fleet snapshot for routed placement.
    """

    def __init__(self, host: str, port: int, owner: str,
                 timeout_s: float = 10.0, breaker_threshold: int = 5,
                 breaker_reset_s: float = 5.0):
        self.host = host
        self.port = int(port)
        self.endpoint = f"{host}:{port}"
        self.owner = owner
        self.timeout_s = float(timeout_s)
        self.state = ACTIVE
        self.instance: Optional[str] = None  # fleet id, learned on dial
        self.breaker = _rp.CircuitBreaker(
            _rp.backend_breaker_name(owner, self.endpoint),
            failure_threshold=int(breaker_threshold),
            reset_s=float(breaker_reset_s))
        self._sock: Optional[socket.socket] = None
        #: serializes the request/response exchange on this connection
        self._wire_lock = threading.Lock()
        #: guards state/in-flight bookkeeping (never held across I/O)
        self._lock = threading.Lock()
        self.inflight = 0
        self.ewma_s: Optional[float] = None
        self.dispatched = 0

    # -- connection ------------------------------------------------------- #
    def _connect(self, caps: str) -> socket.socket:
        sock = socket.create_connection((self.host, self.port),
                                        timeout=self.timeout_s)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            send_message(sock, Cmd.INFO_REQ, {"caps": caps})
            cmd, meta, _ = recv_message(sock)
            if cmd is Cmd.INFO_DENY:
                raise ConnectionError(
                    f"{self.endpoint}: server denied connection: "
                    f"{meta.get('error', meta)}")
            if cmd is not Cmd.INFO_APPROVE:
                raise ConnectionError(
                    f"{self.endpoint}: unexpected handshake reply "
                    f"{cmd}: {meta}")
        except BaseException:
            try:
                sock.close()
            except OSError:
                pass
            raise
        inst = meta.get("instance")
        self.instance = str(inst) if inst else None
        _events.record("router.connect",
                       f"{self.owner}: connected backend {self.endpoint}"
                       + (f" (instance {self.instance})"
                          if self.instance else ""),
                       element=self.owner, backend=self.endpoint)
        return sock

    def request(self, meta: Dict[str, Any], payload: bytes,
                caps: str) -> Tuple[Dict[str, Any], bytes]:
        """One synchronous round trip on this backend's connection.
        Raises ConnectionError/OSError/QueryProtocolError on failure
        (the connection is dropped so the next attempt dials fresh);
        breaker and load-signal accounting happen here so every caller
        — primary, failover, hedge — feeds the same placement state."""
        with self._lock:
            if self.state == CLOSED:
                raise ConnectionError(f"{self.endpoint}: backend closed")
            self.inflight += 1
        t0 = time.monotonic()
        try:
            with self._wire_lock:
                if self._sock is None:
                    self._sock = self._connect(caps)
                sock = self._sock
                try:
                    send_message(sock, Cmd.DATA, meta, payload)
                    cmd, rmeta, rpayload = recv_message(sock)
                except BaseException:
                    self._drop_conn()
                    raise
                if cmd is Cmd.ERROR:
                    self._drop_conn()
                    raise QueryProtocolError(
                        rmeta.get("error", "server error"))
                if cmd is not Cmd.RESULT:
                    self._drop_conn()
                    raise QueryProtocolError(f"unexpected reply {cmd}")
            rtt = time.monotonic() - t0
            with self._lock:
                self.ewma_s = rtt if self.ewma_s is None else \
                    (1 - EWMA_ALPHA) * self.ewma_s + EWMA_ALPHA * rtt
                self.dispatched += 1
            self.breaker.record_success()
            return rmeta, rpayload
        except (ConnectionError, OSError, QueryProtocolError):
            self.breaker.record_failure()
            raise
        finally:
            with self._lock:
                self.inflight -= 1

    def _drop_conn(self) -> None:
        """Close the socket (wire lock held by the caller) so the next
        request dials fresh — a half-consumed exchange is never reused."""
        s, self._sock = self._sock, None
        if s is not None:
            try:
                s.close()
            except OSError:
                pass

    def ensure_connected(self, caps: str) -> None:
        """Dial + INFO handshake without sending a request, so the
        fleet ``instance`` id is learned up front — prefix-aware
        placement joins digests to endpoints through it, and a backend
        that never dispatched would otherwise stay anonymous."""
        with self._wire_lock:
            if self._sock is None:
                self._sock = self._connect(caps)

    def local_load(self) -> float:
        """Load score from locally observed signals: requests in flight
        weighted by how slow this backend has been lately."""
        with self._lock:
            lat = self.ewma_s if self.ewma_s is not None else 0.0
            return self.inflight * (1.0 + lat)

    def close(self) -> None:
        with self._lock:
            self.state = CLOSED
        with self._wire_lock:
            self._drop_conn()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Backend({self.endpoint}, {self.state})"


# --------------------------------------------------------------------------- #
# BackendSet: membership, affinity ring, two-choice placement
# --------------------------------------------------------------------------- #

def _ring_hash(key: str) -> int:
    """Stable 64-bit hash (NOT Python's salted ``hash``) so affinity
    survives process restarts and is identical across hosts."""
    return int.from_bytes(
        hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest(), "big")


class BackendSet:
    """The router's membership view: live add/remove, graceful drain,
    the consistent-hash affinity ring, and two-random-choice placement
    fed by fleet or local load signals."""

    def __init__(self, endpoints: Sequence[Tuple[str, int]], owner: str,
                 timeout_s: float = 10.0, breaker_threshold: int = 5,
                 breaker_reset_s: float = 5.0,
                 rng: Optional[random.Random] = None):
        self.owner = owner
        self._timeout_s = float(timeout_s)
        self._breaker_threshold = int(breaker_threshold)
        self._breaker_reset_s = float(breaker_reset_s)
        self._lock = threading.Lock()
        self._backends: Dict[str, Backend] = {}  # guarded-by: _lock
        self._ring: List[Tuple[int, str]] = []  # guarded-by: _lock
        # session placement state (both guarded-by: _lock, LRU-bounded):
        # _pins are explicit re-homes (migration / eager drain re-pin)
        # consulted BEFORE the ring; _owners is the observed last
        # successful placement, which is what drain enumerates
        self._pins: "OrderedDict[str, str]" = OrderedDict()
        self._owners: "OrderedDict[str, str]" = OrderedDict()
        self._rng = rng if rng is not None else random.Random()
        for host, port in endpoints:
            self.add(f"{host}:{port}")
        if not self._backends:
            raise ValueError("BackendSet needs at least one backend")

    # -- membership ------------------------------------------------------- #
    def add(self, endpoint: str) -> Backend:
        """Live add (the autoscaling scale-up primitive): the backend
        joins the ring and becomes placeable immediately."""
        (host, port), = parse_endpoints(endpoint)
        ep = f"{host}:{port}"
        with self._lock:
            if ep in self._backends:
                raise ValueError(f"backend {ep} already in the set")
            be = Backend(host, port, self.owner,
                         timeout_s=self._timeout_s,
                         breaker_threshold=self._breaker_threshold,
                         breaker_reset_s=self._breaker_reset_s)
            self._backends[ep] = be
            self._rebuild_ring()
        _events.record("router.backend_add",
                       f"{self.owner}: backend {ep} added",
                       element=self.owner, backend=ep)
        return be

    def drain(self, endpoint: str) -> Backend:
        """Graceful drain: stop placing on the backend, leave its
        in-flight requests to finish. :meth:`reap_drained` (called on
        every dispatch) closes it once idle — scale-down without
        dropping a single buffer. Sessions the backend owns are
        re-pinned EAGERLY here, so the first post-drain buffer dials
        its new home directly instead of paying a lazy failover round
        trip."""
        with self._lock:
            be = self._backends.get(endpoint)
            if be is None:
                raise KeyError(f"no backend {endpoint}")
            with be._lock:
                be.state = DRAINING
            self._rebuild_ring()
        _events.record("router.drain",
                       f"{self.owner}: backend {endpoint} draining "
                       f"({be.inflight} in flight)",
                       element=self.owner, backend=endpoint)
        self._repin_sessions(endpoint)
        self.reap_drained()
        return be

    def remove(self, endpoint: str, drain: bool = True) -> None:
        """Live remove: with ``drain=True`` (default) in-flight work
        finishes first; ``drain=False`` severs immediately (in-flight
        requests on it fail over via the normal dispatch loop)."""
        if drain:
            be = self.drain(endpoint)
            deadline = time.monotonic() + be.timeout_s
            while be.inflight > 0 and time.monotonic() < deadline:
                time.sleep(0.01)
        with self._lock:
            be = self._backends.pop(endpoint, None)
            self._rebuild_ring()
            # drop placement state naming the gone backend (drain
            # already re-pinned; this covers the drain=False sever)
            for table in (self._pins, self._owners):
                for s in [s for s, ep in table.items() if ep == endpoint]:
                    del table[s]
        if be is not None:
            be.close()
            _events.record("router.backend_remove",
                           f"{self.owner}: backend {endpoint} removed",
                           element=self.owner, backend=endpoint)

    def reap_drained(self) -> None:
        """Close any draining backend whose in-flight count hit zero."""
        with self._lock:
            done = [be for be in self._backends.values()
                    if be.state == DRAINING and be.inflight == 0]
        for be in done:
            be.close()
            _events.record("router.backend_closed",
                           f"{self.owner}: drained backend {be.endpoint} "
                           f"closed", element=self.owner,
                           backend=be.endpoint)

    def _rebuild_ring(self) -> None:  # guarded-by: _lock
        """Affinity ring over ACTIVE backends (draining/closed members
        take no new sessions). Caller holds ``_lock``."""
        ring: List[Tuple[int, str]] = []
        for ep, be in self._backends.items():
            if be.state != ACTIVE:
                continue
            for v in range(RING_VNODES):
                ring.append((_ring_hash(f"{ep}#{v}"), ep))
        ring.sort()
        self._ring = ring

    def backends(self) -> List[Backend]:
        with self._lock:
            return list(self._backends.values())

    def get(self, endpoint: str) -> Optional[Backend]:
        with self._lock:
            return self._backends.get(endpoint)

    # -- session placement state ------------------------------------------- #
    def pin_session(self, session: str, endpoint: str) -> None:
        """Explicitly re-home a session (migration / drain hand-off):
        :meth:`_affinity` honors the pin before the ring, so the next
        buffer dials ``endpoint`` directly."""
        with self._lock:
            self._pins[session] = endpoint
            self._pins.move_to_end(session)
            self._owners[session] = endpoint
            self._owners.move_to_end(session)
            self._trim_session_tables()

    def unpin_session(self, session: str) -> None:
        with self._lock:
            self._pins.pop(session, None)

    def note_session(self, session: str, endpoint: str) -> None:
        """Record where a session's buffer actually landed (dispatch
        success path). Keeps the ownership census current and makes an
        existing pin track reality after a failover moved the session."""
        with self._lock:
            self._owners[session] = endpoint
            self._owners.move_to_end(session)
            if session in self._pins and self._pins[session] != endpoint:
                self._pins[session] = endpoint
                self._pins.move_to_end(session)
            self._trim_session_tables()

    def sessions_owned(self, endpoint: str) -> List[str]:
        """Sessions currently homed on ``endpoint`` (observed placement
        union explicit pins) — the drain/migration census."""
        with self._lock:
            return sorted(
                {s for s, ep in self._owners.items() if ep == endpoint}
                | {s for s, ep in self._pins.items() if ep == endpoint})

    def _trim_session_tables(self) -> None:  # guarded-by: _lock
        while len(self._pins) > SESSION_PIN_LIMIT:
            self._pins.popitem(last=False)
        while len(self._owners) > SESSION_PIN_LIMIT:
            self._owners.popitem(last=False)

    def _repin_sessions(self, endpoint: str) -> int:
        """Eagerly re-home every session owned by a draining backend
        (the ring already excludes it). Each session re-places through
        the normal :meth:`pick` path — deterministic ring hash first —
        and lands as an explicit pin."""
        moved = 0
        for s in self.sessions_owned(endpoint):
            be = self.pick(session=s, exclude=frozenset({endpoint}))
            if be is None:
                continue
            self.pin_session(s, be.endpoint)
            moved += 1
        if moved:
            _events.record(
                "router.repin",
                f"{self.owner}: {moved} session(s) eagerly re-pinned "
                f"off draining {endpoint}",
                element=self.owner, backend=endpoint, sessions=moved)
        return moved

    def repin_dead_owner(self, endpoint: str) -> List[Tuple[str, str]]:
        """Crash re-pin (fleet/checkpoint restore): the owner died
        WITHOUT a drain — no export round trip happened — so re-home
        every session it owned onto survivors and return the
        ``(session, new_endpoint)`` map the checkpoint splice needs.
        Must run BEFORE :meth:`remove`, which drops the ownership
        census this reads."""
        moved: List[Tuple[str, str]] = []
        for s in self.sessions_owned(endpoint):
            be = self.pick(session=s, exclude=frozenset({endpoint}))
            if be is None:
                continue
            self.pin_session(s, be.endpoint)
            moved.append((s, be.endpoint))
        if moved:
            _events.record(
                "router.repin_dead",
                f"{self.owner}: {len(moved)} session(s) re-pinned off "
                f"dead owner {endpoint}",
                severity="warning", element=self.owner, backend=endpoint,
                sessions=len(moved))
        return moved

    def __len__(self) -> int:
        with self._lock:
            return len(self._backends)

    # -- load signals ------------------------------------------------------ #
    def _fleet_load(self, be: Backend) -> Optional[float]:
        """Queue depth from the attached aggregator's routing view, or
        None when no view covers this backend (unknown instance, no
        aggregator, instance not yet pushed)."""
        agg = _fleet.aggregator()
        if agg is None or be.instance is None:
            return None
        view = agg.routing_view().get(be.instance)
        if view is None:
            return None
        if not view["routable"]:
            return float("inf")  # stale/not-ready: last-choice only
        return float(view["queue_depth"])

    def _load(self, be: Backend) -> float:
        fleet = self._fleet_load(be)
        if fleet is not None:
            # tiebreak equal fleet depths with the local signal so two
            # idle backends still spread instead of pile-on
            return fleet * 1e3 + be.local_load()
        return be.local_load()

    # -- placement --------------------------------------------------------- #
    def _routable(self, exclude: frozenset) -> List[Backend]:
        with self._lock:
            cands = [be for be in self._backends.values()
                     if be.state == ACTIVE and be.endpoint not in exclude]
        # non-consuming gate: `state` transitions an elapsed cooldown to
        # half-open WITHOUT spending the probe quota. allow() is called
        # only on the backend actually selected (see pick) — calling it
        # here would burn the half-open probe on every candidate scan
        # and strand recovering backends in half-open forever
        return [be for be in cands if be.breaker.state != _rp.OPEN]

    def pick(self, session: Optional[str] = None,
             exclude: frozenset = frozenset(),
             prefix_hashes: Optional[Sequence[str]] = None
             ) -> Optional[Backend]:
        """Choose a backend: session affinity first (consistent hash,
        spilling with an event when the target is unroutable), then the
        backend advertising the longest shared KV prefix
        (``prefix_hashes`` probed against the fleet digest —
        serving.disagg placement), else
        least-loaded-of-two-random-choices. None when nothing routable
        remains — the caller's fallback decision point. Selection is a
        commitment: the winner's breaker admission (the half-open probe
        quota) is consumed here, never for losing candidates."""
        if session is not None:
            be = self._affinity(session, exclude)
            if be is not None:
                return be
        if prefix_hashes:
            be = self._prefix_match(prefix_hashes, exclude)
            if be is not None:
                return be
        cands = self._routable(exclude)
        if not cands:
            return None
        if len(cands) == 1:
            return cands[0] if cands[0].breaker.allow() else None
        a, b = self._rng.sample(cands, 2)
        first, second = (a, b) if self._load(a) <= self._load(b) \
            else (b, a)
        if first.breaker.allow():
            return first
        if second.breaker.allow():
            return second
        return None

    def _prefix_match(self, hashes: Sequence[str],
                      exclude: frozenset) -> Optional[Backend]:
        """The backend whose fleet digest holds the request's longest
        leading prefix (FleetAggregator.longest_prefix) — a prefix hit
        over the wire beats a least-loaded placement that would
        re-prefill from token zero. None when no aggregator is
        attached, no instance advertises the prefix, or the holder is
        not in this set / not admissible; the caller falls through to
        two-choice."""
        agg = _fleet.aggregator()
        if agg is None:
            return None
        inst, depth = agg.longest_prefix(hashes)
        if inst is None or depth <= 0:
            return None
        with self._lock:
            cands = [be for be in self._backends.values()
                     if be.state == ACTIVE and be.instance == inst
                     and be.endpoint not in exclude]
        for be in cands:
            if be.breaker.state != _rp.OPEN and be.breaker.allow():
                _PREFIX_PLACED.labels(self.owner).inc()
                _events.record(
                    "router.prefix_place",
                    f"{self.owner}: placed on {be.endpoint} holding "
                    f"{depth} shared KV prefix page(s)",
                    element=self.owner, backend=be.endpoint, depth=depth)
                return be
        return None

    def _affinity(self, session: str,
                  exclude: frozenset) -> Optional[Backend]:
        # explicit pins (migration / drain re-pin) outrank the ring:
        # the pinned backend holds the session's migrated KV pages
        with self._lock:
            pinned = self._pins.get(session)
        if pinned is not None:
            be = self.get(pinned)
            if be is not None and be.state == ACTIVE \
                    and pinned not in exclude and be.breaker.allow():
                return be
            # pinned home unroutable (dead, draining, or excluded by a
            # failed attempt): the pin is stale — drop it and let the
            # ring/two-choice place the session fresh
            with self._lock:
                self._pins.pop(session, None)
        with self._lock:
            ring = self._ring
        if not ring:
            return None
        h = _ring_hash(session)
        # first vnode clockwise of the session's point
        lo, hi = 0, len(ring)
        while lo < hi:
            mid = (lo + hi) // 2
            if ring[mid][0] < h:
                lo = mid + 1
            else:
                hi = mid
        ep = ring[lo % len(ring)][1]
        be = self.get(ep)
        if be is not None and be.state == ACTIVE \
                and ep not in exclude and be.breaker.allow():
            return be
        # the session's home is dead/draining/excluded: spill — the
        # remote prefix cache there is lost; say so explicitly
        _events.record("router.spill",
                       f"{self.owner}: session affinity target {ep} "
                       f"unroutable — spilling to two-choice placement",
                       severity="warning", element=self.owner, backend=ep)
        return None

    def close(self) -> None:
        for be in self.backends():
            be.close()


# --------------------------------------------------------------------------- #
# QueryRouter: dispatch with failover + hedging
# --------------------------------------------------------------------------- #

#: router telemetry — registered here (query/router.py owns the
#: ``router`` metric layer; check_metric_names.py pins that). The
#: ``backend`` label is host:port endpoints from the configured set:
#: cardinality bounded by fleet size, never by request volume.
_reg = _obs.registry()
_DISPATCH_TOTAL = _reg.counter(
    "nnstpu_router_dispatch_total",
    "Buffers dispatched by the query router, by backend",
    ("element", "backend"))
_FAILOVER_TOTAL = _reg.counter(
    "nnstpu_router_failover_total",
    "Buffers re-dispatched to a peer after their backend failed"
    " mid-request", ("element",))
_RTT = _reg.histogram(
    "nnstpu_router_roundtrip_seconds",
    "Routed request round-trip latency (winning attempt)",
    ("element",))
_BACKEND_STATE = _reg.gauge(
    "nnstpu_router_backend_state",
    "Backend lifecycle per router (0=active, 1=draining, 2=closed)",
    ("element", "backend"))
_INFLIGHT = _reg.gauge(
    "nnstpu_router_inflight_depth",
    "Requests in flight per backend", ("element", "backend"))
_PREFIX_PLACED = _reg.counter(
    "nnstpu_router_prefix_placed_total",
    "Dispatches placed on the backend advertising the longest shared"
    " KV prefix (serving.disagg prefix-aware routing)", ("element",))


class QueryRouter:
    """Spreads one client's offload across a :class:`BackendSet`.

    ``dispatch`` is the whole contract: one (meta, payload) request in,
    one (rmeta, rpayload) result out, surviving backend loss by
    failover and (optionally) hedging the tail. ``hedge_ms`` <= 0
    disables hedging; > 0 arms it with that floor under the live P95.
    """

    def __init__(self, backends: BackendSet, name: str,
                 max_request_retry: int = 3, hedge_ms: float = 0.0,
                 retry_policy: Optional[_rp.RetryPolicy] = None):
        self.backends = backends
        self.name = name
        self.max_request_retry = max(int(max_request_retry), 1)
        self.hedge_ms = float(hedge_ms)
        self._retry = retry_policy if retry_policy is not None \
            else _rp.RetryPolicy()
        #: set by the hosting client during its EOS drain: membership
        #: growth is refused while draining (a backend added mid-drain
        #: could never owe the drain a result)
        self.draining = False
        self._lat_lock = threading.Lock()
        self._latencies: List[float] = []
        self._caps: Callable[[], str] = lambda: ""
        ref = weakref.ref(self)
        for be in backends.backends():
            self._register_gauges(ref, be.endpoint)
        _live_routers.add(self)

    def _register_gauges(self, ref, endpoint: str) -> None:
        _BACKEND_STATE.labels(self.name, endpoint).set_function(
            lambda: (lambda r: 0 if r is None or
                     r.backends.get(endpoint) is None
                     else _STATE_CODE[r.backends.get(endpoint).state])(
                         ref()))
        _INFLIGHT.labels(self.name, endpoint).set_function(
            lambda: (lambda r: 0 if r is None or
                     r.backends.get(endpoint) is None
                     else r.backends.get(endpoint).inflight)(ref()))

    def set_caps_provider(self, fn: Callable[[], str]) -> None:
        """The handshake caps string, provided lazily — negotiation may
        not have happened when the router is constructed."""
        self._caps = fn

    def prime(self) -> int:
        """Dial every ACTIVE backend once (handshake only) so each
        learns its fleet instance id before the first dispatch —
        prefix-aware placement needs the endpoint-to-instance join.
        Unreachable backends are skipped (their breakers record the
        failure); returns how many backends are now identified."""
        caps = self._caps()
        n = 0
        for be in self.backends.backends():
            if be.state != ACTIVE:
                continue
            if be.instance is None:
                try:
                    be.ensure_connected(caps)
                except (ConnectionError, OSError, QueryProtocolError):
                    be.breaker.record_failure()
                    continue
            n += be.instance is not None
        return n

    def choose(self, session: Optional[str] = None,
               prefix_hashes: Optional[Sequence[str]] = None
               ) -> Optional[Backend]:
        """Placement WITHOUT dispatch: the backend :meth:`dispatch`
        would pick right now (affinity -> prefix digest -> two-choice).
        serving.disagg uses it to choose the decode target before the
        prefill even runs, so pages stream to where the request will
        land. The choice is advisory — the later dispatch re-picks
        unless pinned via ``prefer=``."""
        return self.backends.pick(session=session,
                                  prefix_hashes=prefix_hashes)

    # -- membership passthrough (gauges track new members) ----------------- #
    def add_backend(self, endpoint: str) -> Backend:
        import weakref

        if self.draining:
            raise RuntimeError(
                f"{self.name}: draining — refusing to add backend "
                f"{endpoint}")
        be = self.backends.add(endpoint)
        self._register_gauges(weakref.ref(self), be.endpoint)
        return be

    def remove_backend(self, endpoint: str, drain: bool = True) -> None:
        self.backends.remove(endpoint, drain=drain)

    def drain_backend(self, endpoint: str) -> Backend:
        return self.backends.drain(endpoint)

    # -- hedging ----------------------------------------------------------- #
    def _observe_latency(self, rtt: float) -> None:
        with self._lat_lock:
            self._latencies.append(rtt)
            if len(self._latencies) > LATENCY_WINDOW:
                del self._latencies[:len(self._latencies)
                                    - LATENCY_WINDOW]

    def hedge_delay_s(self) -> float:
        """Observed P95 round trip, floored at ``hedge_ms`` — hedge
        only requests already slower than ~19 of 20 peers, never
        earlier than the configured floor."""
        floor = self.hedge_ms / 1e3
        with self._lat_lock:
            lats = sorted(self._latencies)
        if len(lats) < 20:
            return floor
        return max(floor, lats[int(len(lats) * 0.95)])

    # -- dispatch ----------------------------------------------------------- #
    def dispatch(self, meta: Dict[str, Any], payload: bytes,
                 deadline: Optional[_rp.Deadline] = None,
                 session: Optional[str] = None,
                 prefix_hashes: Optional[Sequence[str]] = None,
                 prefer: Optional[str] = None
                 ) -> Tuple[Dict[str, Any], bytes]:
        """Route one request. Raises :class:`RouterError` once every
        routable backend has failed it and the shared retry budget is
        spent; raises nothing for a single backend death — that is the
        failover path, not an error.

        ``prefix_hashes`` (kv_cache.prompt_path_hashes) turns on
        prefix-cache-aware placement; ``prefer`` pins the first attempt
        to a specific endpoint when it is still routable (serving.disagg
        sends the decode request to the backend it just streamed pages
        to) — on failure the normal failover loop takes over."""
        budget = _rp.RetryBudget(self.max_request_retry, site="router")
        tried: set = set()
        used_backend = False  # at least one real attempt hit a wire
        last: Optional[Exception] = None
        attempt = 0
        span = _tracing.start_span(
            "router.dispatch", parent=_tracing.current_context(),
            attrs={"element": self.name})
        try:
            while budget.take():
                if deadline is not None and deadline.expired():
                    _rp.record_shed(
                        "router",
                        f"{self.name}: deadline expired after "
                        f"{attempt} attempt(s)", element=self.name)
                    raise _ShedSignal()
                # exclude backends that already failed THIS buffer so a
                # failover lands on a peer; once every peer has been
                # tried, clear the exclusion and let backoff + breaker
                # probes drive recovery
                exclude = frozenset(tried)
                be = None
                if prefer is not None and prefer not in exclude:
                    cand = self.backends.get(prefer)
                    if cand is not None and cand.state == ACTIVE \
                            and cand.breaker.state != _rp.OPEN \
                            and cand.breaker.allow():
                        be = cand
                if be is None:
                    be = self.backends.pick(session=session,
                                            exclude=exclude,
                                            prefix_hashes=prefix_hashes)
                if be is None and tried:
                    tried.clear()
                    be = self.backends.pick(session=session,
                                            prefix_hashes=prefix_hashes)
                if be is None:
                    last = RouterError(
                        f"{self.name}: no routable backend "
                        f"({len(self.backends)} configured)")
                    self._retry.sleep(attempt)
                    attempt += 1
                    continue
                if deadline is not None:
                    # recomputed per attempt: a retry must not
                    # resurrect budget the earlier attempt spent
                    meta = dict(meta)
                    meta[_rp.WIRE_KEY] = deadline.to_wire()
                if used_backend:
                    # this buffer already hit a wire and lost it:
                    # landing on `be` now is a failover re-dispatch
                    _FAILOVER_TOTAL.labels(self.name).inc()
                    _events.record(
                        "router.failover",
                        f"{self.name}: re-dispatching to "
                        f"{be.endpoint} after backend failure",
                        severity="warning", element=self.name,
                        backend=be.endpoint)
                try:
                    t0 = time.monotonic()
                    rmeta, rpayload = self._attempt(
                        be, meta, payload, deadline, session, tried)
                    rtt = time.monotonic() - t0
                    self._observe_latency(rtt)
                    _RTT.labels(self.name).observe(rtt)
                    rhook = _slo.ROUTER_SLO_HOOK
                    if rhook is not None:
                        rhook.record_dispatch(
                            session, len(payload), len(rpayload))
                    span.set_attribute("backend", be.endpoint)
                    if session is not None:
                        self.backends.note_session(session, be.endpoint)
                    self.backends.reap_drained()
                    return rmeta, rpayload
                except (ConnectionError, OSError,
                        QueryProtocolError) as e:
                    last = e
                    used_backend = True
                    tried.add(be.endpoint)
                    log.warning("router %s: backend %s failed "
                                "(attempt %d/%d): %s", self.name,
                                be.endpoint, budget.used,
                                budget.attempts, e)
                    if not budget.exhausted:
                        self._retry.sleep(attempt)
                attempt += 1
            span.set_attribute("error", True)
            raise RouterError(
                f"{self.name}: request failed on every routable "
                f"backend after {budget.used} attempt(s): {last}")
        finally:
            span.end()

    def _attempt(self, be: Backend, meta: Dict[str, Any], payload: bytes,
                 deadline: Optional[_rp.Deadline],
                 session: Optional[str], tried: set
                 ) -> Tuple[Dict[str, Any], bytes]:
        """One placement: the primary round trip, hedged with a second
        backend when armed and the P95 window elapses first."""
        caps = self._caps()
        _DISPATCH_TOTAL.labels(self.name, be.endpoint).inc()
        if self.hedge_ms <= 0:
            # no manual floor: the autotuner arms hedging from the
            # observed P95 alone once the latency window holds enough
            # samples to make that quantile real (hedge_delay_s's own
            # threshold) — `--hedge-ms` stops being required knowledge
            tn = _tune.TUNE_HOOK
            if tn is None or not tn.auto_hedge:
                return be.request(meta, payload, caps)
            with self._lat_lock:
                n = len(self._latencies)
            if n < 20:
                return be.request(meta, payload, caps)
        return self._hedged(be, meta, payload, caps, session, tried)

    def _hedged(self, primary: Backend, meta: Dict[str, Any],
                payload: bytes, caps: str, session: Optional[str],
                tried: set) -> Tuple[Dict[str, Any], bytes]:
        """First-response-wins across the primary and (after the hedge
        delay) one peer. Both run full round trips — the loser's result
        is discarded, not aborted, so its connection stays in protocol
        sync for the next request."""
        done = threading.Condition()
        results: List[Tuple[str, Any, Any]] = []  # (who, result|None, err)

        def run(be: Backend, who: str) -> None:
            try:
                r = be.request(meta, payload, caps)
                err = None
            except (ConnectionError, OSError, QueryProtocolError) as e:
                r, err = None, e
            with done:
                results.append((who, r, err))
                done.notify_all()

        t_p = threading.Thread(target=run, args=(primary, "primary"),
                               daemon=True,
                               name=f"router-primary:{self.name}")
        t_p.start()
        delay = self.hedge_delay_s()
        with done:
            done.wait_for(lambda: results, timeout=delay)
        hedge_be: Optional[Backend] = None
        if not results:
            # primary is past the P95 window: hedge onto a DIFFERENT
            # backend (exclude the primary and this buffer's failures)
            hedge_be = self.backends.pick(
                exclude=frozenset(tried) | {primary.endpoint})
            if hedge_be is not None:
                _rp.record_hedge(
                    self.name,
                    f"{self.name}: hedging {primary.endpoint} -> "
                    f"{hedge_be.endpoint} after {delay * 1e3:.0f}ms",
                    backend=hedge_be.endpoint)
                _DISPATCH_TOTAL.labels(
                    self.name, hedge_be.endpoint).inc()
                threading.Thread(
                    target=run, args=(hedge_be, "hedge"), daemon=True,
                    name=f"router-hedge:{self.name}").start()
        expected = 2 if hedge_be is not None else 1
        with done:
            while True:
                for who, r, err in results:
                    if r is not None:
                        return r
                if len(results) >= expected:
                    # every runner failed: surface the primary's error
                    for who, r, err in results:
                        if who == "primary":
                            raise err
                    raise results[0][2]
                done.wait(0.05)

    def snapshot(self) -> Dict[str, Any]:
        """Programmatic view for tests/debugging."""
        out = []
        for be in self.backends.backends():
            out.append({
                "endpoint": be.endpoint, "state": be.state,
                "instance": be.instance, "inflight": be.inflight,
                "ewma_s": be.ewma_s, "breaker": be.breaker.state,
                "dispatched": be.dispatched,
            })
        return {"name": self.name, "hedge_ms": self.hedge_ms,
                "backends": out}

    def close(self) -> None:
        self.backends.close()


#: live router registry (WeakSet, like obs/tracing's pipeline
#: registry): a collected router never lingers in a debug bundle's
#: routing view
_live_routers: "weakref.WeakSet" = weakref.WeakSet()


def routing_view() -> List[Dict[str, Any]]:
    """Snapshot of every live router — the bundle capture's routing
    evidence (who was routable, breakers, inflight, EWMA) at incident
    time."""
    return [r.snapshot() for r in list(_live_routers)]


class _ShedSignal(Exception):
    """Internal: dispatch hit an expired deadline — the client sheds
    the buffer (legal drop) instead of erroring or falling back."""
