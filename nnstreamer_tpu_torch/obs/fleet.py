"""obs.fleet — cross-process observability for a multi-host deployment;
port of nnstreamer_tpu/obs/fleet.py (stdlib only).

Metrics, tracing, and health alone are strictly single-process
subsystems: a client pipeline offloading to a remote ``tensor_query``
server sees only its own half of every request, and a serving fleet
would need one scrape target per process. This module makes the
subsystem pod-shaped — **one scrape endpoint, one trace tree, one
health verdict**:

  * **Metric federation.** Workers periodically push compact registry
    snapshots (plus health and exported spans) to an *aggregator*,
    which re-exposes every instance's series on its ``/metrics`` with
    ``instance``/``role`` labels appended. Counters and histograms are
    cumulative per instance, so merging is last-snapshot-wins per
    instance; ``# HELP``/``# TYPE`` are emitted exactly once per
    family however many instances report it, and a family whose type
    disagrees across instances is skipped with a
    ``fleet.merge_conflict`` event instead of corrupting the scrape.
  * **Remote span collection.** Workers export completed spans of
    traces whose ids crossed the query wire (marked at wire
    send/adopt time — obs/tracing.py ``mark_export``); the aggregator
    ingests them into its span store, so ``/debug/traces/<id>``
    renders the full cross-host tree stitched by the propagated trace
    id.
  * **Fleet health rollup.** Each push carries the worker's health
    snapshot and readiness verdict. The aggregator's ``/healthz`` /
    ``/readyz`` / ``/debug/fleet`` report worst-of-fleet status with
    per-instance detail; a missing push heartbeat flips the instance
    ``stalled`` (kind="fleet" watchdog rule, obs/health.py) and a
    long-gone instance expires entirely (``fleet.expire``).

Transport is dual: an ``OBS_PUSH`` frame piggybacked on an open
``tensor_query`` connection (the client sends one ahead of a DATA
frame when the push interval has elapsed — no extra socket, no extra
thread), and a standalone HTTP ``POST /fleet/push`` to the
aggregator's exporter for processes that have no query wire (a
serving-only host, the CLI ``--obs-push URL`` path).

Zero-overhead contract, same as the rest of obs: with fleet push
disabled there are **no extra wire bytes** (``wire_frame_due`` is a
module-global None check; no ``OBS_PUSH`` frame is ever built), **no
background threads** (the HTTP pusher thread only exists while a URL
push is enabled), and span export costs one attribute read in the
span store. Stdlib only.
"""

from __future__ import annotations

import http.client
import json
import os
import socket
import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple
from urllib.parse import urlsplit

from . import events as _events
from . import health as _health
from . import metrics as _metrics
from . import quality as _quality
from . import slo as _slo
from . import tracing as _tracing
from .metrics import _escape_help, _escape_label, _fmt

__all__ = [
    "FleetAggregator", "FleetPusher", "PUSH_VERSION", "aggregator",
    "build_push", "default_instance", "disable_aggregator",
    "disable_push", "enable_aggregator", "enable_push", "ingest_wire",
    "push_enabled", "pusher", "wire_frame_due",
]

#: push document schema version (bump on incompatible change; the
#: aggregator rejects unknown majors with a clear error)
PUSH_VERSION = 1

#: default seconds between pushes (CLI/API override)
DEFAULT_INTERVAL_S = 2.0

#: staleness: an instance whose last push is older than
#: ``ttl_factor * its advertised interval`` is stale (not-ready +
#: watchdog ``stalled``); older than ``expire_factor * interval`` it
#: is dropped from the fleet entirely
TTL_FACTOR = 3.0
EXPIRE_FACTOR = 15.0

#: bounded count of expired-instance tombstones kept for routing views
TOMBSTONE_LIMIT = 64

#: gauge families whose series sum to an instance's routing queue
#: depth (serving admission queue, query inbox, pipeline queues)
QUEUE_DEPTH_FAMILIES = ("nnstpu_serving_queue_depth",
                        "nnstpu_query_inbox_depth",
                        "nnstpu_pipeline_queue_depth")

#: per-push span batch bound (the store-side queue is bounded too)
MAX_SPANS_PER_PUSH = 512

#: HTTP ingestion body cap — a push is a snapshot, not a bulk upload
MAX_PUSH_BYTES = 8 << 20

#: digest entries per push — bounds both doc size and the router's
#: probe cost; deep trees advertise their first 64 BFS nodes, which
#: covers the hot shared prefixes placement actually cares about
MAX_KV_PREFIX_ENTRIES = 64

#: serving/disagg.py installs a zero-arg callable returning the local
#: engine's bounded radix-prefix digest (kv_cache.prefix_digest());
#: None (the default) keeps the push doc exactly as it was — the
#: usual zero-overhead-when-off hook (slo.ENGINE_SLO_HOOK pattern)
KV_DIGEST_HOOK = None

#: tune/ installs a zero-arg callable returning the local autotuner
#: store's push slice (tune.TuneStore.to_doc()); None keeps the push
#: doc exactly as before — same contract as KV_DIGEST_HOOK
TUNE_PUSH_HOOK = None

#: tune/ installs a one-arg callable that merges a fleet-shipped tune
#: doc into the local store. The pusher fires it with the ``tune``
#: field of every push-ack (see FleetPusher.push_now) — the adoption
#: path that lets a fresh instance skip sweeps the fleet already paid
#: for. None-gated like every other hook here.
TUNE_ADOPT_HOOK = None

#: fleet/ installs a zero-arg callable returning the local
#: FleetController's bounded action journal (controller.actions()) so
#: scale/migration decisions federate through push docs like every
#: other telemetry slice. None-gated like the hooks above; assigned
#: only by fleet.enable()/disable() (nnslint ownership rule).
FLEET_ACTIONS_HOOK = None

#: obs/diag installs a zero-arg callable returning the local debug-
#: bundle references + trigger accounting (DiagEngine.push_doc) so an
#: aggregator can enumerate the whole fleet's captured evidence for
#: one incident. None keeps the push doc exactly as before; assigned
#: only by obs/diag enable()/disable() (nnslint diag ownership rule).
DIAG_PUSH_HOOK = None

#: fleet/checkpoint.py installs a zero-arg callable returning the
#: local CheckpointDaemon's session → last-checkpointed-seq watermarks
#: (daemon.watermarks()). They ride every push doc so that when this
#: instance dies WITHOUT a drain, its tombstone still says which
#: checkpoints must exist somewhere — the staleness bar the restore
#: path holds survivors' blobs to. None-gated like every hook here;
#: assigned only by fleet/checkpoint.py (nnslint checkpoint rule).
CHECKPOINT_HOOK = None

#: checkpoint watermark entries per push/tombstone — bounds both the
#: doc and what a tombstone pins in memory awaiting restore
MAX_CHECKPOINT_SESSIONS = 256

#: tombstones still carrying unconsumed checkpoint watermarks are
#: protected from compaction for this long after expiry (the restore
#: window), and at most this many are protected at once — past either
#: bound they compact like any other stone (the bounded-window fix)
RESTORE_WINDOW_S = 60.0
RESTORE_PROTECT_LIMIT = 16


def default_instance() -> str:
    """``host:pid`` unless ``NNSTPU_INSTANCE`` names the process —
    unique per process on a pod without any coordination."""
    return os.environ.get("NNSTPU_INSTANCE") \
        or f"{socket.gethostname()}:{os.getpid()}"


def build_push(instance: str, role: str, seq: int,
               interval_s: float = DEFAULT_INTERVAL_S,
               registry: Optional[_metrics.MetricsRegistry] = None,
               health_registry: Optional[_health.HealthRegistry] = None,
               span_store: Optional[_tracing.SpanStore] = None,
               max_spans: int = MAX_SPANS_PER_PUSH,
               kv_prefix: Optional[List[str]] = None,
               checkpoints: Optional[Dict[str, int]] = None,
               endpoint: Optional[str] = None) -> Dict[str, Any]:
    """Assemble one push document from the given (default: process-
    global) registries — the single source of truth for the push
    schema, shared by the pusher, the wire piggyback, and tests."""
    reg = registry if registry is not None else _metrics.registry()
    hreg = health_registry if health_registry is not None \
        else _health.registry()
    store = span_store if span_store is not None else _tracing.store()
    ready, conds = hreg.readiness()
    if kv_prefix is None and KV_DIGEST_HOOK is not None:
        kv_prefix = KV_DIGEST_HOOK()
    if checkpoints is None and CHECKPOINT_HOOK is not None:
        checkpoints = CHECKPOINT_HOOK()
    return {
        "v": PUSH_VERSION,
        "instance": instance,
        "role": role,
        "seq": int(seq),
        "ts": time.time(),
        "interval_s": float(interval_s),
        "metrics": reg.snapshot(),
        "health": hreg.snapshot(),
        "ready": {"ready": ready, "conditions": conds},
        "spans": store.drain_export(max_spans),
        # None while the SLO layer is off — a worker without per-tenant
        # accounting pushes the same doc it always did
        "slo": _slo.push_data(),
        # None while no digest source is registered (same contract as
        # slo): the bounded radix-prefix digest the router probes for
        # prefix-cache-aware placement, capped at MAX_KV_PREFIX_ENTRIES
        "kv_prefix": (None if kv_prefix is None
                      else [str(h) for h in kv_prefix]
                      [:MAX_KV_PREFIX_ENTRIES]),
        # None while the autotuner is off (same contract again): the
        # local store's tuned-config slice, federated so any instance's
        # sweep result reaches the whole fleet
        "tune": TUNE_PUSH_HOOK() if TUNE_PUSH_HOOK is not None else None,
        # None while no controller runs here (same contract): the
        # bounded autoscale action journal, so any aggregator can
        # answer "who scaled what, when, and why"
        "fleet_actions": (FLEET_ACTIONS_HOOK()
                          if FLEET_ACTIONS_HOOK is not None else None),
        # None while diag is off (same contract): bundle references +
        # trigger accounting, so the aggregator enumerates fleet-wide
        # incident evidence without shipping the bundles themselves
        "diag": DIAG_PUSH_HOOK() if DIAG_PUSH_HOOK is not None else None,
        # None while data-plane quality is off (same contract): the
        # per-tap frame/NaN/PSI summary + anomaly verdicts, small
        # enough to ride every push so an aggregator can answer
        # "which instance's which tap is producing garbage"
        "quality": _quality.push_data(),
        # None while no checkpoint daemon runs here (same contract):
        # session → last-checkpointed seq, bounded — the slice a
        # tombstone keeps so a crash restore knows what freshness to
        # demand of survivors' shelved blobs
        "checkpoints": (None if checkpoints is None else
                        {str(s): int(q) for s, q in
                         sorted(checkpoints.items())
                         [:MAX_CHECKPOINT_SESSIONS]}),
        # None unless the worker serves a wire endpoint: how the fleet
        # controller maps a tombstoned instance back to the router
        # backend whose sessions need re-homing
        "endpoint": None if endpoint is None else str(endpoint),
    }


# --------------------------------------------------------------------------- #
# Pusher (worker side)
# --------------------------------------------------------------------------- #

class FleetPusher:
    """Ships this process's snapshots to an aggregator.

    ``url`` (``http://host:port`` or a bare ``host:port``) starts a
    daemon thread POSTing to ``/fleet/push`` every ``interval_s``;
    ``url=None`` is wire-only mode — no thread, pushes ride the query
    wire via :meth:`wire_frame` whenever the client sends anyway.
    Both modes share one interval clock per channel, and both flip
    span export on in the span store so wire-crossing traces queue
    their spans for the next push.
    """

    def __init__(self, url: Optional[str] = None,
                 interval_s: float = DEFAULT_INTERVAL_S,
                 instance: Optional[str] = None, role: str = "worker",
                 registry: Optional[_metrics.MetricsRegistry] = None,
                 health_registry: Optional[_health.HealthRegistry] = None,
                 span_store: Optional[_tracing.SpanStore] = None,
                 kv_digest: Optional[Any] = None):
        self.instance = instance or default_instance()
        self.role = role
        # per-pusher digest source; None defers to the module-level
        # KV_DIGEST_HOOK inside build_push (serving/disagg.py installs
        # that hook when a worker starts, so a plain FleetPusher next to
        # a DisaggWorker advertises the digest with no extra wiring)
        self._kv_digest = kv_digest
        self.interval_s = max(float(interval_s), 0.05)
        self._registry = registry
        self._health_registry = health_registry
        self._store = span_store if span_store is not None \
            else _tracing.store()
        self._host, self._port = self._parse_url(url)
        self._seq = 0
        self._seq_lock = threading.Lock()
        self._last_wire = 0.0
        self._http_failing = False
        self.pushes_sent = 0
        self.push_errors = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._store.set_export(True)
        if self._host is not None:
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name=f"obs-fleet-push:{self.instance}")
            self._thread.start()

    @staticmethod
    def _parse_url(url: Optional[str]) -> Tuple[Optional[str], int]:
        if not url:
            return None, 0
        if "//" not in url:
            url = "http://" + url
        parts = urlsplit(url)
        if parts.scheme != "http" or not parts.hostname:
            raise ValueError(
                f"fleet push URL must be http://host:port, got {url!r}")
        return parts.hostname, parts.port or 9464

    def _next_doc(self) -> Dict[str, Any]:
        with self._seq_lock:
            self._seq += 1
            seq = self._seq
        return build_push(self.instance, self.role, seq,
                          interval_s=self.interval_s,
                          registry=self._registry,
                          health_registry=self._health_registry,
                          span_store=self._store,
                          kv_prefix=(self._kv_digest()
                                     if self._kv_digest is not None
                                     else None))

    # -- HTTP channel --------------------------------------------------- #
    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.push_now()

    def push_now(self) -> bool:
        """One synchronous HTTP push (the thread's tick; callable
        directly for deterministic tests). Failures are counted and
        journaled on state *change* only — a down aggregator must not
        flood the event ring at push rate."""
        if self._host is None:
            return False
        doc = self._next_doc()
        body = json.dumps(doc, default=str).encode("utf-8")
        try:
            conn = http.client.HTTPConnection(
                self._host, self._port, timeout=5.0)
            try:
                conn.request("POST", "/fleet/push", body=body,
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                ack = resp.read()
                if resp.status != 200:
                    raise OSError(f"aggregator replied {resp.status}")
            finally:
                conn.close()
            # the ack carries the fleet's merged tuned configs (obs/
            # exporter.py _post_fleet_push): adopt them when the
            # autotuner is on. First-push adoption is what lets a fresh
            # instance skip sweeps the fleet already paid for — enable
            # fleet push before the first dispatch and the configs are
            # local before any knob is consulted.
            hook = TUNE_ADOPT_HOOK
            if hook is not None and ack:
                try:
                    tdoc = json.loads(ack).get("tune")
                    if tdoc is not None:
                        hook(tdoc)
                except (ValueError, AttributeError):
                    pass  # pre-tune aggregator or non-JSON ack
        except (OSError, http.client.HTTPException) as e:
            # the doc drained the span export queue — put the batch
            # back so a briefly unreachable aggregator loses nothing
            self._store.requeue_export(doc.get("spans") or [])
            self.push_errors += 1
            if not self._http_failing:
                self._http_failing = True
                _events.record(
                    "fleet.push_failed",
                    f"{self.instance}: push to {self._host}:{self._port} "
                    f"failed: {e}", severity="warning",
                    instance=self.instance)
            return False
        self.pushes_sent += 1
        if self._http_failing:
            self._http_failing = False
            _events.record("fleet.push_recovered",
                           f"{self.instance}: pushes reaching "
                           f"{self._host}:{self._port} again",
                           instance=self.instance)
        return True

    # -- query-wire channel --------------------------------------------- #
    def wire_frame(self) -> Optional[Tuple[Dict[str, Any], bytes]]:
        """(meta, payload) for one ``OBS_PUSH`` frame when the wire
        interval has elapsed, else None. Called by the query client
        immediately before a DATA send — same thread, same socket, so
        the push never races a request frame. The interval gate is a
        locked check-then-set: two query-client elements sharing the
        process-global pusher must not both emit a frame in one
        interval."""
        now = time.monotonic()
        with self._seq_lock:
            if now - self._last_wire < self.interval_s:
                return None
            self._last_wire = now
        doc = self._next_doc()
        meta = {"instance": doc["instance"], "role": doc["role"],
                "seq": doc["seq"], "v": doc["v"]}
        return meta, json.dumps(doc, default=str).encode("utf-8")

    def close(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5)
        self._thread = None
        # Final flush: a worker that lived shorter than one interval
        # would otherwise exit without ever reporting. Best-effort —
        # push_now() swallows a down aggregator.
        if self._host is not None:
            self.push_now()
        self._store.set_export(False)


# --------------------------------------------------------------------------- #
# Aggregator
# --------------------------------------------------------------------------- #

class _Instance:
    """Latest state pushed by one worker process."""

    __slots__ = ("instance", "role", "seq", "ts", "interval_s",
                 "metrics", "health", "ready", "slo", "kv_prefix",
                 "tune", "actions", "diag", "quality", "checkpoints",
                 "endpoint", "via", "pushes",
                 "spans_ingested", "first_mono", "last_mono")

    def __init__(self, instance: str):
        self.instance = instance
        self.role = "worker"
        self.seq = 0
        self.ts = 0.0
        self.interval_s = DEFAULT_INTERVAL_S
        self.metrics: Dict[str, Any] = {}
        self.health: Dict[str, Any] = {}
        self.ready: Dict[str, Any] = {"ready": False, "conditions": {}}
        self.slo: Optional[Dict[str, Any]] = None
        #: frozenset of radix path hashes (None until the instance
        #: first advertises one) — set membership IS the prefix probe:
        #: chained hashes mean hashes[i] present implies path 0..i held
        self.kv_prefix: Optional[frozenset] = None
        #: the instance's tune-store slice (None until it pushes one)
        self.tune: Optional[Dict[str, Any]] = None
        #: the instance's autoscale action journal (None until a
        #: controller there pushes one)
        self.actions: Optional[List[Dict[str, Any]]] = None
        #: the instance's diag slice: debug-bundle references +
        #: trigger accounting (None until diag pushes one)
        self.diag: Optional[Dict[str, Any]] = None
        #: the instance's data-plane quality slice: per-tap frame/NaN/
        #: PSI summary + anomaly verdicts (None until quality pushes)
        self.quality: Optional[Dict[str, Any]] = None
        #: the instance's checkpoint watermarks, session → seq (None
        #: until a checkpoint daemon there pushes them) — copied into
        #: the tombstone on expiry so the restore path outlives the
        #: worker
        self.checkpoints: Optional[Dict[str, int]] = None
        #: the instance's wire endpoint (None until advertised) — the
        #: router-backend join key a restore needs
        self.endpoint: Optional[str] = None
        self.via = "http"
        self.pushes = 0
        self.spans_ingested = 0
        self.first_mono = time.monotonic()
        self.last_mono = self.first_mono


class FleetAggregator:
    """Holds the fleet state and renders the merged views.

    ``ttl_s``/``expire_after_s`` override the per-instance defaults
    (``TTL_FACTOR`` / ``EXPIRE_FACTOR`` × the instance's advertised
    push interval). Expiry runs lazily on every ingest and read — no
    thread of its own; the health watchdog (when enabled) additionally
    drives the ``stalled`` verdict between reads.
    """

    def __init__(self, ttl_s: Optional[float] = None,
                 expire_after_s: Optional[float] = None,
                 span_store: Optional[_tracing.SpanStore] = None,
                 instance: Optional[str] = None, role: str = "aggregator"):
        self.ttl_s = ttl_s
        self.expire_after_s = expire_after_s
        self.instance = instance or default_instance()
        self.role = role
        self._store = span_store if span_store is not None \
            else _tracing.store()
        self._lock = threading.Lock()
        self._instances: "OrderedDict[str, _Instance]" = OrderedDict()
        #: expired instances, kept (bounded) so routing views report
        #: them as not-routable instead of silently dropping the key;
        #: a fresh push from the same instance clears its tombstone
        self._tombstones: "OrderedDict[str, Dict[str, Any]]" = \
            OrderedDict()
        #: (instance, family) pairs already journaled as conflicts —
        #: one event per drift, not one per scrape
        self._conflicts: set = set()
        self.pushes_ingested = 0
        self.bad_pushes = 0

    # -- staleness ------------------------------------------------------- #
    def _ttl(self, rec: _Instance) -> float:
        if self.ttl_s is not None:
            return float(self.ttl_s)
        return max(TTL_FACTOR * rec.interval_s, 0.5)

    def _expire_after(self, rec: _Instance) -> float:
        if self.expire_after_s is not None:
            return float(self.expire_after_s)
        return max(EXPIRE_FACTOR * rec.interval_s, 2.0)

    def _expire_now(self) -> None:
        now = time.monotonic()
        dead: List[_Instance] = []
        with self._lock:
            for iid in list(self._instances):
                rec = self._instances[iid]
                if now - rec.last_mono > self._expire_after(rec):
                    dead.append(self._instances.pop(iid))
                    # expiry leaves a tombstone, not silence: a router
                    # asking about this instance must see "known dead"
                    # (routable=False), not an absent key it could
                    # misread as "never part of the fleet"
                    stone: Dict[str, Any] = {
                        "role": rec.role, "expired_mono": now}
                    # carry the last pushed checkpoint watermarks +
                    # endpoint into the stone: the worker is gone, so
                    # this copy is all a crash restore has to judge
                    # survivors' blobs by (bounded at ingest)
                    if rec.endpoint:
                        stone["endpoint"] = rec.endpoint
                    if rec.checkpoints is not None:
                        stone["checkpoints"] = dict(rec.checkpoints)
                    self._tombstones[iid] = stone
                    self._tombstones.move_to_end(iid)
            self._compact_tombstones()
        for rec in dead:
            _events.record(
                "fleet.expire",
                f"instance {rec.instance} expired after "
                f"{now - rec.last_mono:.1f}s without a push",
                severity="warning", instance=rec.instance, role=rec.role)

    def _compact_tombstones(self) -> None:  # guarded-by: _lock
        """Deterministic oldest-first compaction: when churn pushes the
        tombstone census past the bound, evict the stones that expired
        EARLIEST (by expiry time, tiebroken by instance id) — never
        whichever insertion order a re-expiry happened to leave. The
        newest deaths are the ones a router still needs to learn.

        Stones still carrying unconsumed checkpoint watermarks are
        skipped while inside the RESTORE_WINDOW_S grace (a restore
        that hasn't run yet must still find them), but the protection
        is bounded twice over: the grace expires, and at most
        RESTORE_PROTECT_LIMIT stones enjoy it at once — the OLDEST
        protected stones lose it first when crash churn exceeds the
        bound, so compaction always terminates."""
        now = time.monotonic()

        def protected(stone: Dict[str, Any]) -> bool:
            return ("checkpoints" in stone
                    and now - float(stone.get("expired_mono", 0.0))
                    <= RESTORE_WINDOW_S)

        guard = sorted(
            (kv for kv in self._tombstones.items() if protected(kv[1])),
            key=lambda kv: (-float(kv[1].get("expired_mono", 0.0)),
                            kv[0]))
        immune = {iid for iid, _ in guard[:RESTORE_PROTECT_LIMIT]}
        while len(self._tombstones) > TOMBSTONE_LIMIT:
            evictable = [kv for kv in self._tombstones.items()
                         if kv[0] not in immune]
            if not evictable:
                break  # every stone is inside the bounded window
            oldest = min(
                evictable,
                key=lambda kv: (float(kv[1].get("expired_mono", 0.0)),
                                kv[0]))[0]
            del self._tombstones[oldest]

    def confirm_drain(self, iid: str) -> bool:
        """Controller-confirmed drain (fleet/controller.py): the
        instance was deliberately scaled in and its sessions migrated,
        so drop both its live record and any tombstone — deliberate
        autoscale churn must never crowd still-dead backends out of
        the bounded tombstone list. Returns whether anything cleared."""
        with self._lock:
            had_rec = self._instances.pop(iid, None) is not None
            had_stone = self._tombstones.pop(iid, None) is not None
        cleared = had_rec or had_stone
        if cleared:
            _events.record(
                "fleet.drain_confirmed",
                f"instance {iid} drained by controller — record and "
                f"tombstone cleared", instance=iid)
        return cleared

    def restorables(self) -> List[Dict[str, Any]]:
        """Tombstoned instances a crash restore should handle: died
        without a drain, advertised a wire endpoint, and their
        checkpoint watermarks are still unconsumed. Sorted oldest
        death first — the controller works the backlog in the order
        the fleet lost them."""
        self._expire_now()
        with self._lock:
            rows = [
                {"instance": iid,
                 "endpoint": stone["endpoint"],
                 "checkpoints": dict(stone.get("checkpoints") or {}),
                 "expired_mono": float(stone.get("expired_mono", 0.0))}
                for iid, stone in self._tombstones.items()
                if stone.get("endpoint")
                and not stone.get("restore_consumed")]
        return sorted(rows, key=lambda r: (r["expired_mono"],
                                           r["instance"]))

    def consume_restore(self, iid: str) -> Optional[Dict[str, Any]]:
        """Atomically claim a tombstone's restore payload (endpoint +
        checkpoint watermarks). First caller wins — a second restore
        attempt gets None instead of splicing the same sessions twice.
        The stone itself stays for the routing view until
        ``confirm_drain`` clears it, but once consumed it loses its
        compaction protection (the window closes on consumption, not
        just on time)."""
        with self._lock:
            stone = self._tombstones.get(iid)
            if stone is None or stone.get("restore_consumed") \
                    or not stone.get("endpoint"):
                return None
            stone["restore_consumed"] = True
            payload = {"instance": iid,
                       "endpoint": stone["endpoint"],
                       "checkpoints": dict(
                           stone.pop("checkpoints", None) or {})}
        return payload

    # -- ingestion ------------------------------------------------------- #
    def ingest(self, doc: Any, via: str = "http") -> None:
        """Validate and store one push document; raises ValueError on a
        malformed document (the HTTP route maps that to 400)."""
        if not isinstance(doc, dict):
            self.bad_pushes += 1
            raise ValueError("push document must be a JSON object")
        iid = doc.get("instance")
        if not isinstance(iid, str) or not iid:
            self.bad_pushes += 1
            raise ValueError("push document missing 'instance'")
        v = doc.get("v", 0)
        if not isinstance(v, int) or v > PUSH_VERSION:
            self.bad_pushes += 1
            raise ValueError(
                f"unsupported push version {v!r} (this aggregator "
                f"speaks v<={PUSH_VERSION})")
        # Coerce every scalar into locals BEFORE touching the fleet
        # table: a push that fails validation must leave no ghost
        # half-mutated instance behind (one bad push would otherwise
        # flip /readyz 503 fleet-wide until expiry), and non-scalar
        # junk (e.g. "seq": [1]) must surface as the ValueError the
        # HTTP route and wire handler are contracted to catch.
        try:
            role = str(doc.get("role")) if doc.get("role") else None
            seq = int(doc.get("seq") or 0)
            ts = float(doc.get("ts") or 0.0)
            interval_s = max(
                float(doc.get("interval_s") or DEFAULT_INTERVAL_S), 0.05)
        except (TypeError, ValueError) as e:
            self.bad_pushes += 1
            raise ValueError(
                f"malformed push field from {iid}: {e}") from e
        spans = doc.get("spans") or []
        metrics = doc.get("metrics")
        health = doc.get("health")
        ready = doc.get("ready")
        slo_doc = doc.get("slo")
        kv_prefix = doc.get("kv_prefix")
        tune_doc = doc.get("tune")
        actions_doc = doc.get("fleet_actions")
        diag_doc = doc.get("diag")
        quality_doc = doc.get("quality")
        ckpt_doc = doc.get("checkpoints")
        endpoint_doc = doc.get("endpoint")
        new = False
        with self._lock:
            rec = self._instances.get(iid)
            if rec is None:
                rec = _Instance(iid)
                self._instances[iid] = rec
                new = True
            if role:
                rec.role = role
            rec.seq = seq
            rec.ts = ts
            rec.interval_s = interval_s
            if isinstance(metrics, dict):
                rec.metrics = metrics
            if isinstance(health, dict):
                rec.health = health
            if isinstance(ready, dict):
                rec.ready = ready
            if isinstance(slo_doc, dict):
                rec.slo = slo_doc
            if isinstance(kv_prefix, (list, tuple)):
                # replace, never merge: the digest is a snapshot of
                # what the instance holds NOW — evicted paths must
                # stop attracting placements
                rec.kv_prefix = frozenset(
                    str(h) for h in kv_prefix[:MAX_KV_PREFIX_ENTRIES])
            if isinstance(tune_doc, dict):
                rec.tune = tune_doc
            if isinstance(actions_doc, list):
                rec.actions = actions_doc
            if isinstance(diag_doc, dict):
                rec.diag = diag_doc
            if isinstance(quality_doc, dict):
                rec.quality = quality_doc
            if isinstance(ckpt_doc, dict):
                # replace, never merge — the watermarks are a snapshot
                # of what the daemon has stored NOW; junk values drop
                # per-entry rather than poisoning the slice
                marks: Dict[str, int] = {}
                for s, q in list(ckpt_doc.items())[
                        :MAX_CHECKPOINT_SESSIONS]:
                    try:
                        marks[str(s)] = int(q)
                    except (TypeError, ValueError):
                        continue
                rec.checkpoints = marks
            if isinstance(endpoint_doc, str) and endpoint_doc:
                rec.endpoint = endpoint_doc
            rec.via = via
            rec.pushes += 1
            rec.last_mono = time.monotonic()
            self.pushes_ingested += 1
            # a returning instance is alive again: drop its tombstone
            self._tombstones.pop(iid, None)
        if isinstance(spans, list) and spans:
            ingested = self._store.ingest_remote(spans, iid)
            with self._lock:
                rec.spans_ingested += ingested
        if new:
            self._register_health(iid)
        _events.record(
            "fleet.push",
            f"push from {iid} (seq {rec.seq}, via {via}, "
            f"{len(spans)} span(s))",
            severity="debug", instance=iid, role=rec.role, seq=rec.seq,
            via=via)
        self._expire_now()

    def _register_health(self, iid: str) -> None:
        """One kind="fleet" component per instance: the watchdog's
        missing-heartbeat rule reads the probe's push age; an expired
        instance retires the component (probe → None). A no-op while
        health is off."""
        ref = weakref.ref(self)

        def probe() -> Optional[Dict[str, Any]]:
            agg = ref()
            if agg is None:
                return None
            with agg._lock:
                rec = agg._instances.get(iid)
                if rec is None:
                    return None
                return {
                    "push_age_s": time.monotonic() - rec.last_mono,
                    "ttl_s": agg._ttl(rec),
                    "pushes": rec.pushes,
                    "role": rec.role,
                }

        _health.component(f"fleet:{iid}", kind="fleet", probe=probe,
                          attrs={"instance": iid})

    # -- merged exposition ------------------------------------------------ #
    def exposition(self, local_registry: Optional[_metrics.MetricsRegistry]
                   = None) -> str:
        """Prometheus text for the whole fleet: the local registry's
        series plus every live instance's pushed snapshot, each series
        tagged with ``instance``/``role``. HELP/TYPE exactly once per
        family; a family whose type conflicts with the first-seen
        schema is skipped per offending instance (``fleet.merge_
        conflict`` journaled once)."""
        self._expire_now()
        reg = local_registry if local_registry is not None \
            else _metrics.registry()
        sources: List[Tuple[str, str, Dict[str, Any]]] = [
            (self.instance, self.role, reg.snapshot())]
        with self._lock:
            for rec in self._instances.values():
                sources.append((rec.instance, rec.role, rec.metrics))
        conflicts: List[Tuple[str, str, str, str]] = []
        fams: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        for iid, role, snap in sources:
            for name in sorted(snap):
                fam = snap[name]
                ftype = fam.get("type", "")
                cur = fams.get(name)
                if cur is None:
                    cur = {"type": ftype, "help": fam.get("help", ""),
                           "rows": []}
                    fams[name] = cur
                elif cur["type"] != ftype:
                    key = (iid, name)
                    with self._lock:
                        fresh = key not in self._conflicts
                        if fresh:
                            self._conflicts.add(key)
                    if fresh:
                        conflicts.append((iid, name, ftype, cur["type"]))
                    continue
                for series in fam.get("series", []):
                    labels = dict(series.get("labels") or {})
                    labels["instance"] = iid
                    labels["role"] = role
                    cur["rows"].append((labels, series))
        for iid, name, ftype, want in conflicts:
            _events.record(
                "fleet.merge_conflict",
                f"{iid}: family {name} pushed as {ftype!r}, fleet has "
                f"{want!r} — skipped", severity="warning", instance=iid,
                family=name)
        lines: List[str] = []
        for name in sorted(fams):
            fam = fams[name]
            if not fam["rows"]:
                continue
            if fam["help"]:
                lines.append(f"# HELP {name} {_escape_help(fam['help'])}")
            lines.append(f"# TYPE {name} {fam['type']}")
            for labels, series in fam["rows"]:
                base = ",".join(
                    f'{k}="{_escape_label(str(v))}"'
                    for k, v in labels.items())
                if fam["type"] == "histogram":
                    # snapshot buckets are already cumulative
                    buckets = series.get("buckets") or {}
                    for bound in sorted(buckets, key=float):
                        le = f'le="{_fmt(float(bound))}"'
                        lines.append(
                            f"{name}_bucket{{{base},{le}}} "
                            f"{buckets[bound]}")
                    count = series.get("count", 0)
                    lines.append(
                        f'{name}_bucket{{{base},le="+Inf"}} {count}')
                    lines.append(f"{name}_sum{{{base}}} "
                                 f"{_fmt(float(series.get('sum', 0.0)))}")
                    lines.append(f"{name}_count{{{base}}} {count}")
                else:
                    lines.append(
                        f"{name}{{{base}}} "
                        f"{_fmt(float(series.get('value', 0.0)))}")
        return "\n".join(lines) + "\n" if lines else ""

    # -- health / readiness rollup ---------------------------------------- #
    def health_rollup(self, local: Dict[str, Any]) -> Dict[str, Any]:
        """Worst-of-fleet /healthz body: the local snapshot's components
        plus one ``fleet:<instance>`` entry per live instance carrying
        its pushed status (stale push ⇒ ``stalled`` regardless of what
        it last claimed). The kind="fleet" components _register_health
        put in the *local* registry (for the watchdog's heartbeat rule)
        are dropped here — this rollup is the authoritative per-instance
        view, and keeping both would list every instance twice with
        potentially conflicting statuses."""
        self._expire_now()
        now = time.monotonic()
        components = [c for c in local.get("components", [])
                      if c.get("kind") != "fleet"]
        # re-derive the local verdict from the surviving components so a
        # watchdog-stalled fleet:<iid> duplicate can't leak its status in
        worst = _health.Status.OK
        for c in components:
            s = _health.status_from_string(str(c.get("status", "ok")))
            if s > worst:
                worst = s
        with self._lock:
            recs = list(self._instances.values())
        for rec in recs:
            age = now - rec.last_mono
            stale = age > self._ttl(rec)
            st = "stalled" if stale \
                else str(rec.health.get("status", "ok"))
            s = _health.status_from_string(st)
            if s > worst:
                worst = s
            components.append({
                "name": f"fleet:{rec.instance}",
                "kind": "fleet",
                "status": st,
                "detail": (f"no push for {age:.1f}s" if stale else
                           f"last push {age:.1f}s ago (seq {rec.seq})"),
                "role": rec.role,
                "push_age_s": age,
                "via": rec.via,
                "components": len(rec.health.get("components", [])),
            })
        return {
            "status": _health.status_string(worst),
            "ok": worst <= _health.Status.DEGRADED,
            "components": components,
            "fleet": {"instances": len(recs)},
        }

    def slo_rollup(self, local: Optional[Dict[str, Any]] = None
                   ) -> Dict[str, Any]:
        """Fleet-wide SLO view for ``/debug/slo``: each live instance's
        pushed per-tenant snapshot (plus this process's own when given),
        and the tenants breaching their burn budget anywhere in the
        fleet — the page an operator reads before asking which worker
        to drain."""
        self._expire_now()
        with self._lock:
            recs = list(self._instances.values())
        instances: Dict[str, Any] = {}
        breached: set = set()

        def scan(iid: str, snap: Optional[Dict[str, Any]]) -> None:
            if not isinstance(snap, dict) or not snap.get("enabled"):
                return
            instances[iid] = snap
            for tenant, row in (snap.get("tenants") or {}).items():
                burn = row.get("burn") if isinstance(row, dict) else None
                if isinstance(burn, dict) and burn.get("breached"):
                    breached.add(tenant)

        if local is not None:
            scan(self.instance, local)
        for rec in recs:
            scan(rec.instance, rec.slo)
        return {"instances": instances, "breached": sorted(breached)}

    def ready_rollup(self, local_ready: bool,
                     local_conds: Dict[str, bool]
                     ) -> Tuple[bool, Dict[str, bool]]:
        """Fleet /readyz: local readiness AND every live instance both
        fresh and self-reporting ready."""
        self._expire_now()
        now = time.monotonic()
        conds = dict(local_conds)
        with self._lock:
            recs = list(self._instances.values())
        for rec in recs:
            fresh = (now - rec.last_mono) <= self._ttl(rec)
            conds[f"fleet:{rec.instance}"] = \
                fresh and bool(rec.ready.get("ready"))
        return local_ready and all(conds.values()), conds

    # -- routing view ------------------------------------------------------ #
    @staticmethod
    def _queue_depth(rec: _Instance) -> float:
        """Instance load as one plain scalar: the sum of every series
        in its pushed queue-depth gauge families. Buried sub-doc → a
        number a placement loop can compare without parsing."""
        total = 0.0
        for fam_name in QUEUE_DEPTH_FAMILIES:
            fam = rec.metrics.get(fam_name)
            if not isinstance(fam, dict):
                continue
            for series in fam.get("series") or ():
                try:
                    total += float(series.get("value", 0.0))
                except (TypeError, ValueError):
                    continue
        return total

    def routing_view(self) -> Dict[str, Dict[str, Any]]:
        """Per-instance placement signals as plain scalars — what the
        query router consumes. Each live instance maps to::

            {"routable": bool,   # fresh AND self-reported ready
             "ready": bool, "stale": bool, "queue_depth": float,
             "role": str, "push_age_s": float}

        An EXPIRED instance stays in the view as a tombstone
        (``routable=False, expired=True``) instead of vanishing — a
        router must read "known dead", never mistake absence for
        "never existed"."""
        self._expire_now()
        now = time.monotonic()
        with self._lock:
            recs = list(self._instances.values())
            stones = {iid: dict(t) for iid, t in self._tombstones.items()}
        view: Dict[str, Dict[str, Any]] = {}
        for rec in recs:
            age = now - rec.last_mono
            stale = age > self._ttl(rec)
            ready = bool(rec.ready.get("ready"))
            view[rec.instance] = {
                "routable": (not stale) and ready,
                "ready": ready,
                "stale": stale,
                "queue_depth": self._queue_depth(rec),
                "role": rec.role,
                "push_age_s": age,
                "kv_prefix_size": len(rec.kv_prefix or ()),
            }
        for iid, stone in stones.items():
            if iid in view:
                continue
            view[iid] = {
                "routable": False,
                "ready": False,
                "stale": True,
                "expired": True,
                "queue_depth": float("inf"),
                "role": stone.get("role", "worker"),
                "push_age_s": now - float(stone.get("expired_mono", now)),
                "kv_prefix_size": 0,
            }
        return view

    def scale_signals(self) -> Dict[str, Any]:
        """Controller-facing snapshot (fleet/controller.observe): the
        routing view reduced to the scalars the autoscale policy
        prices — total finite queue depth over routable instances, the
        routable census, and the fleet's breached-tenant list."""
        view = self.routing_view()
        queue_depth, routable = 0.0, 0
        for row in view.values():
            if not row.get("routable"):
                continue
            routable += 1
            depth = float(row.get("queue_depth", 0.0))
            if depth != float("inf"):
                queue_depth += depth
        return {"queue_depth": queue_depth, "routable": routable,
                "breached": self.slo_rollup()["breached"],
                "instances": len(view)}

    def actions_rollup(self) -> Dict[str, Any]:
        """Fleet-wide autoscale action journals (``/debug/fleet/
        actions``): every live instance's pushed journal, keyed by
        instance — who scaled what, when, and why."""
        self._expire_now()
        with self._lock:
            recs = list(self._instances.values())
        return {rec.instance: rec.actions for rec in recs
                if rec.actions is not None}

    def checkpoints_rollup(self) -> Dict[str, Any]:
        """Fleet-wide checkpoint state (``/debug/fleet/checkpoints``):
        every live instance's pushed watermarks keyed by instance,
        plus the tombstoned instances whose watermarks still await a
        restore — the one view an operator scans to answer "whose
        sessions are covered, and who died holding coverage"."""
        self._expire_now()
        with self._lock:
            recs = list(self._instances.values())
            pending = [
                {"instance": iid,
                 "endpoint": stone.get("endpoint"),
                 "sessions": len(stone.get("checkpoints") or {}),
                 "consumed": bool(stone.get("restore_consumed"))}
                for iid, stone in self._tombstones.items()
                if "checkpoints" in stone or stone.get("restore_consumed")]
        return {
            "instances": {rec.instance: {"endpoint": rec.endpoint,
                                         "checkpoints": rec.checkpoints}
                          for rec in recs
                          if rec.checkpoints is not None},
            "pending_restore": pending,
        }

    def diag_rollup(self) -> Dict[str, Any]:
        """Fleet-wide incident evidence (``/debug/bundles``): every
        live instance's pushed bundle references + trigger accounting,
        keyed by instance — given one incident's time window, this
        enumerates which instances captured evidence for it and which
        bundle ids to fetch from whom."""
        self._expire_now()
        with self._lock:
            recs = list(self._instances.values())
        return {rec.instance: rec.diag for rec in recs
                if rec.diag is not None}

    def quality_rollup(self) -> Dict[str, Any]:
        """Fleet-wide data-plane quality (``/debug/quality``): every
        live instance's pushed per-tap summary keyed by instance, plus
        the flattened ``anomalous`` list (``instance/tap``) — the one
        line an operator scans to find which instance's which tap is
        producing garbage."""
        self._expire_now()
        with self._lock:
            recs = list(self._instances.values())
        per_instance = {rec.instance: rec.quality for rec in recs
                        if rec.quality is not None}
        anomalous = sorted(
            f"{iid}/{tap}"
            for iid, doc in per_instance.items()
            for tap in (doc.get("anomalies") or {}))
        return {"instances": per_instance, "anomalous": anomalous}

    def longest_prefix(self, hashes: Sequence[str]
                       ) -> Tuple[Optional[str], int]:
        """The routable instance holding the longest shared KV prefix.

        ``hashes`` is the request's chained page-path hash list
        (kv_cache.prompt_path_hashes): because each hash chains over
        its whole path, digest membership of ``hashes[i]`` proves the
        instance holds pages 0..i — the probe is i set lookups, and it
        stops at the first miss. Returns ``(instance, depth)`` where
        depth counts matched leading pages, or ``(None, 0)`` when no
        fresh+ready instance advertises any of the prefix. Only
        instances that would be ``routable`` in :meth:`routing_view`
        are considered — a stale digest must not attract placements."""
        if not hashes:
            return None, 0
        self._expire_now()
        now = time.monotonic()
        with self._lock:
            recs = list(self._instances.values())
        best: Optional[str] = None
        best_depth = 0
        for rec in recs:
            dig = rec.kv_prefix
            if not dig or not rec.ready.get("ready") \
                    or now - rec.last_mono > self._ttl(rec):
                continue
            depth = 0
            for h in hashes:
                if h not in dig:
                    break
                depth += 1
            if depth > best_depth:
                best, best_depth = rec.instance, depth
        return best, best_depth

    def tuned_view(self) -> Optional[Dict[str, Any]]:
        """The fleet's merged autotuned-config doc: the union of every
        instance's pushed tune slice, lowest measured cost winning per
        key (latest timestamp breaking unknown-cost ties). This is what
        the push-ack carries back to workers — an instance's sweep
        result reaches its peers one push interval later. None while no
        instance has pushed any tune data, so pre-tune acks stay
        byte-identical."""
        with self._lock:
            docs = [rec.tune for rec in self._instances.values()
                    if isinstance(rec.tune, dict)]
        merged: Dict[str, Dict[str, Any]] = {}
        for doc in docs:
            ents = doc.get("entries")
            if not isinstance(ents, dict):
                continue
            for k, rec in ents.items():
                if not isinstance(rec, dict) or "value" not in rec:
                    continue
                cur = merged.get(k)
                if cur is not None:
                    rc, cc = rec.get("cost_us"), cur.get("cost_us")
                    if cc is not None:
                        # a measured incumbent yields only to a
                        # strictly better measurement
                        if rc is None or rc >= cc:
                            continue
                    elif rc is None and (rec.get("ts") or 0) <= \
                            (cur.get("ts") or 0):
                        continue  # both unmeasured: newest wins
                merged[k] = rec
        if not merged:
            return None
        return {"version": 1, "entries": merged}

    # -- /debug/fleet ------------------------------------------------------ #
    def snapshot(self) -> Dict[str, Any]:
        self._expire_now()
        now = time.monotonic()
        with self._lock:
            recs = list(self._instances.values())
            stones = list(self._tombstones)
        instances = []
        for rec in recs:
            age = now - rec.last_mono
            instances.append({
                "instance": rec.instance,
                "role": rec.role,
                "seq": rec.seq,
                "via": rec.via,
                "pushes": rec.pushes,
                "push_age_s": age,
                "ttl_s": self._ttl(rec),
                "stale": age > self._ttl(rec),
                "interval_s": rec.interval_s,
                "families": len(rec.metrics),
                "spans_ingested": rec.spans_ingested,
                "health_status": rec.health.get("status"),
                "ready": bool(rec.ready.get("ready")),
                "queue_depth": self._queue_depth(rec),
            })
        return {
            "aggregator": {"instance": self.instance, "role": self.role},
            "pushes_ingested": self.pushes_ingested,
            "bad_pushes": self.bad_pushes,
            "instances": instances,
            "expired": stones,
        }

    def close(self) -> None:
        with self._lock:
            self._instances.clear()


# --------------------------------------------------------------------------- #
# Module-global pusher + aggregator
# --------------------------------------------------------------------------- #

_PUSHER: Optional[FleetPusher] = None
_AGGREGATOR: Optional[FleetAggregator] = None


def pusher() -> Optional[FleetPusher]:
    return _PUSHER


def push_enabled() -> bool:
    return _PUSHER is not None


def enable_push(url: Optional[str] = None,
                interval_s: float = DEFAULT_INTERVAL_S,
                role: str = "worker",
                instance: Optional[str] = None) -> FleetPusher:
    """Start the process-global fleet pusher. ``url=None`` is wire-only
    (pushes piggyback on query-client traffic; no thread). Replaces a
    previous pusher. Also enables metric collection — pushing a
    disabled registry's empty snapshot would be all gaps."""
    global _PUSHER
    if _PUSHER is not None:
        _PUSHER.close()
    _metrics.enable()
    _PUSHER = FleetPusher(url=url, interval_s=interval_s, role=role,
                          instance=instance)
    return _PUSHER


def disable_push() -> None:
    global _PUSHER
    if _PUSHER is not None:
        _PUSHER.close()
        _PUSHER = None


def wire_frame_due() -> Optional[Tuple[Dict[str, Any], bytes]]:
    """THE query-client fast path: one module-global read when fleet
    push is off — no frame, no bytes, no allocation."""
    p = _PUSHER
    return p.wire_frame() if p is not None else None


def aggregator() -> Optional[FleetAggregator]:
    return _AGGREGATOR


def enable_aggregator(ttl_s: Optional[float] = None,
                      expire_after_s: Optional[float] = None
                      ) -> FleetAggregator:
    """Turn this process into the fleet aggregator: the exporter's
    ``/metrics``, ``/healthz``, ``/readyz`` switch to the merged fleet
    views, ``POST /fleet/push`` and ``GET /debug/fleet`` activate, and
    ``OBS_PUSH`` frames arriving on any serversrc are ingested."""
    global _AGGREGATOR
    if _AGGREGATOR is None:
        _AGGREGATOR = FleetAggregator(ttl_s=ttl_s,
                                      expire_after_s=expire_after_s)
    else:
        if ttl_s is not None:
            _AGGREGATOR.ttl_s = ttl_s
        if expire_after_s is not None:
            _AGGREGATOR.expire_after_s = expire_after_s
    return _AGGREGATOR


def disable_aggregator() -> None:
    global _AGGREGATOR
    if _AGGREGATOR is not None:
        _AGGREGATOR.close()
        _AGGREGATOR = None


def ingest_wire(meta: Dict[str, Any], payload: bytes) -> None:
    """Server-side ``OBS_PUSH`` handler: decode and ingest when this
    process aggregates, count-and-drop otherwise. Never raises into
    the connection loop — a worker's bad push must not kill the
    client's data stream."""
    agg = _AGGREGATOR
    if agg is None:
        return
    try:
        agg.ingest(json.loads(payload or b"{}"), via="wire")
    except Exception as e:  # noqa: BLE001 — the contract in the docstring
        _events.record("fleet.bad_push",
                       f"undecodable wire push from "
                       f"{meta.get('instance', '?')}: {e}",
                       severity="warning",
                       instance=str(meta.get("instance", "?")))
