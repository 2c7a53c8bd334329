"""Crash checkpoints + restore — survive kill -9 with warm sessions.

Port of nnstreamer_tpu/fleet/checkpoint.py (stdlib and numpy only).

fleet/migrate.py made *graceful* scale-in lossless: drain → export →
ship → re-pin. A backend killed -9 skips every one of those steps — no
freeze, no export round trip — and until now every session it owned
paid a full re-prefill on its new home. This module closes that gap
with the classic two halves:

**Checkpoint** (:class:`CheckpointDaemon`): periodically — and only
when a session committed new tokens since its last snapshot — export
each live session's recorded token path plus the KV pages covering it
(``LMEngine.checkpoint_session``, a read-only walk that never freezes
admission) into a pluggable :class:`CheckpointStore`. Blobs are
self-describing and self-verifying: one JSON header line (session,
monotone per-session sequence number = committed path length, token
path, page geometry) followed by the raw page payload, with a blake2b
digest over both — a truncated or bit-flipped blob is rejected at
parse, never spliced. :class:`LocalDirStore` writes them
atomically (tmp + ``os.replace``) with bounded per-session retention;
:class:`NeighborStore` — the production default — ships each blob to
neighbor workers over the existing ``Cmd.KV_PAGE_XFER`` wire
(``meta["checkpoint"]`` frames; serving/disagg.py files them into the
receiving worker's attached store), so a worker's state survives the
loss of its own host.

**Restore** (:class:`SessionRestorer`): when the aggregator tombstones
an instance that never drained, the controller's ``restore`` reconcile
action re-pins the dead worker's owned sessions onto survivors
(``BackendSet.repin_dead_owner``) and, per session, asks each survivor
to forward its newest stored checkpoint to the session's new home
(``lm_ctl: checkpoint_send`` → a ``meta["restore"]`` page frame the
target splices and adopts). Staleness is decided against the
tombstone's last pushed checkpoint watermark: a blob older than what
the dead worker last claimed to have stored is refused, and the
session falls back to today's re-prefill absorb — token-identically
either way (greedy decode is a pure function of the token history the
client resends), the checkpoint only buys back the cache warmth. The
diag critical path bills the first post-restore prefill as ``restore``
or ``re_prefill`` accordingly, and
``nnstpu_fleet_restored_sessions_total{outcome=...}`` counts which
path each session took.

Zero-overhead contract: nothing here touches the decode hot path. The
daemon reads ``session_watermarks()`` (a dict comprehension over the
bounded session table) under the worker's engine lock at its own
cadence; the only global is ``obs.fleet.CHECKPOINT_HOOK`` (push-doc
watermarks), None-gated like every hook there and assigned only by
this module (nnslint ``naming/checkpoint`` rule).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core.log import logger
from ..graph.element import join_or_warn
from ..obs import events as _events
from ..obs import fleet as _obsfleet
from ..obs import metrics as _obs
from ..obs import tracing as _tracing
from ..query.protocol import QueryProtocolError
from ..resilience import policy as _rp
from .migrate import LM_CAPS

log = logger("fleet")

#: blob format version — bumped on any header/payload layout change;
#: parse refuses newer versions instead of misreading them
BLOB_VERSION = 1
#: newest checkpoints kept per session (older ones are the corruption
#: fallback chain, not an archive)
DEFAULT_RETENTION = 4
#: daemon cadence when run as a thread
DEFAULT_INTERVAL_S = 5.0

_reg = _obs.registry()
_CKPT_SESSIONS = _reg.counter(
    "nnstpu_fleet_checkpoint_sessions_total",
    "Session checkpoints written (one per session per daemon pass that"
    " saw new committed tokens)")
_CKPT_BYTES = _reg.counter(
    "nnstpu_fleet_checkpoint_bytes_total",
    "Checkpoint blob bytes written to stores (header + page payload)")
_CKPT_SECONDS = _reg.histogram(
    "nnstpu_fleet_checkpoint_seconds",
    "One daemon pass: snapshot + blob build + store put, all sessions")
_CKPT_REJECTS = _reg.counter(
    "nnstpu_fleet_checkpoint_reject_total",
    "Stored blobs refused at parse (never spliced)", ("reason",))
_RESTORED = _reg.counter(
    "nnstpu_fleet_restored_sessions_total",
    "Sessions re-homed off a dead (non-drained) worker, by which path"
    " rebuilt their state", ("outcome",))
_RESTORE_SECONDS = _reg.histogram(
    "nnstpu_fleet_restore_seconds",
    "Per-session crash restore wall time (survivor scan + page splice"
    " or fallback adoption)")


# --------------------------------------------------------------------------- #
# Blob format: one JSON header line + raw page payload, digest over both
# --------------------------------------------------------------------------- #

def _digest(header: Dict[str, Any], payload: bytes) -> str:
    h = hashlib.blake2b(digest_size=16)
    h.update(json.dumps(header, sort_keys=True,
                        separators=(",", ":")).encode())
    h.update(payload)
    return h.hexdigest()


def build_blob(session: str, seq: int, path: Any,
               doc: Optional[Dict[str, Any]]) -> bytes:
    """Serialize one session checkpoint. ``doc`` is the
    ``kv_cache.export_pages`` document (None records the token path
    alone — restore then adopts the path but the prefill recomputes).
    The digest covers the header *and* the payload, so truncation and
    bit flips in either half fail the same check."""
    from ..serving.disagg import encode_pages
    path_list = [int(t) for t in np.asarray(path).reshape(-1)]
    pages_meta, payload = (None, b"")
    if doc is not None and doc.get("entries"):
        pages_meta, payload = encode_pages(doc)
    header: Dict[str, Any] = {
        "v": BLOB_VERSION, "session": str(session), "seq": int(seq),
        "path": path_list, "pages": pages_meta,
    }
    header["digest"] = _digest(header, payload)
    return json.dumps(header, sort_keys=True,
                      separators=(",", ":")).encode() + b"\n" + payload


def parse_blob(blob: bytes) -> Dict[str, Any]:
    """Parse + verify one checkpoint blob.

    Returns ``{"session", "seq", "path", "doc"}`` (``doc`` None when
    the blob carried no pages). Raises ValueError on truncation, a
    digest mismatch, an unknown version, or malformed structure — the
    caller's cue to fall back to the next-older blob."""
    from ..serving.disagg import decode_pages
    head, sep, payload = blob.partition(b"\n")
    if not sep:
        raise ValueError("checkpoint blob truncated before header end")
    try:
        header = json.loads(head)
    except (ValueError, UnicodeDecodeError) as e:
        raise ValueError(f"checkpoint header unreadable: {e}")
    if not isinstance(header, dict):
        raise ValueError("checkpoint header is not an object")
    if int(header.get("v", 0)) > BLOB_VERSION:
        raise ValueError(
            f"checkpoint blob v{header.get('v')} is newer than this "
            f"reader (v{BLOB_VERSION})")
    want = header.pop("digest", None)
    if not want or _digest(header, payload) != want:
        raise ValueError("checkpoint digest mismatch (truncated or "
                         "corrupt blob)")
    session = header.get("session")
    path = header.get("path")
    if not isinstance(session, str) or not isinstance(path, list):
        raise ValueError("checkpoint header missing session/path")
    doc = None
    if header.get("pages") is not None:
        # geometry re-validation: decode_pages refuses a payload whose
        # byte count disagrees with the declared page layout
        doc = decode_pages(header["pages"], payload)
    return {"session": session, "seq": int(header.get("seq", 0)),
            "path": [int(t) for t in path], "doc": doc}


def _reject(reason: str, detail: str) -> None:
    _CKPT_REJECTS.labels(reason).inc()
    _events.record("fleet.checkpoint_reject",
                   f"checkpoint blob refused: {detail}",
                   severity="warning", reason=reason)


# --------------------------------------------------------------------------- #
# Stores
# --------------------------------------------------------------------------- #

class CheckpointStore:
    """Store contract, three methods:

    ``put(session, seq, blob)`` durably files one blob (raises on
    failure — the daemon journals and retries next pass);
    ``latest(session)`` returns the newest blob that *parses and
    verifies* (older blobs are the fallback chain for a corrupt head),
    or None where blobs are not locally readable (NeighborStore);
    ``watermarks()`` maps session → highest stored seq, the slice that
    rides push docs so a restore can judge staleness after the worker
    is gone."""

    def put(self, session: str, seq: int, blob: bytes) -> None:
        raise NotImplementedError

    def latest(self, session: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def watermarks(self) -> Dict[str, int]:
        raise NotImplementedError

    def close(self) -> None:  # pragma: no cover - trivial default
        pass


class MemoryStore(CheckpointStore):
    """In-process store: what a worker holds for its neighbors, and
    the test double. Same retention/verification semantics as the dir
    store, minus the filesystem."""

    def __init__(self, retention: int = DEFAULT_RETENTION):
        self.retention = max(1, int(retention))
        self._lock = threading.Lock()
        self._blobs: Dict[str, "OrderedDict[int, bytes]"] = {}

    def put(self, session: str, seq: int, blob: bytes) -> None:
        s = str(session)
        with self._lock:
            per = self._blobs.setdefault(s, OrderedDict())
            per[int(seq)] = bytes(blob)
            per.move_to_end(int(seq))
            while len(per) > self.retention:
                per.popitem(last=False)

    def latest(self, session: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            per = dict(self._blobs.get(str(session)) or {})
        for seq in sorted(per, reverse=True):
            try:
                return parse_blob(per[seq])
            except ValueError as e:
                _reject("verify", f"{session} seq {seq}: {e}")
        return None

    def watermarks(self) -> Dict[str, int]:
        with self._lock:
            return {s: max(per) for s, per in self._blobs.items() if per}


def _session_dirname(session: str) -> str:
    """Filesystem-safe, collision-free directory name for a session id
    (a readable prefix plus a short hash of the exact id)."""
    safe = re.sub(r"[^A-Za-z0-9._-]", "_", str(session))[:48]
    tag = hashlib.blake2b(str(session).encode(), digest_size=4).hexdigest()
    return f"{safe}-{tag}"


class LocalDirStore(CheckpointStore):
    """Directory-backed store: ``root/<session>/<seq>.ckpt``.

    Writes are atomic — blob lands in a dot-tmp sibling, is fsynced,
    then ``os.replace``d into place — so a crash mid-write leaves at
    worst an ignored tmp file, never a half-blob under the real name
    (and a half-blob smuggled in anyway still fails its digest)."""

    def __init__(self, root: str, retention: int = DEFAULT_RETENTION):
        self.root = str(root)
        self.retention = max(1, int(retention))
        self._lock = threading.Lock()
        #: session -> dirname; rebuilt from disk so watermarks survive
        #: the writer process (the whole point of the store)
        self._dirs: Dict[str, str] = {}
        os.makedirs(self.root, exist_ok=True)
        self._rescan()

    def _rescan(self) -> None:
        for d in sorted(os.listdir(self.root)):
            newest = self._newest_blob(os.path.join(self.root, d))
            if newest is None:
                continue
            try:
                with open(newest, "rb") as fp:
                    head = fp.readline()
                session = json.loads(head).get("session")
            except (OSError, ValueError, AttributeError):
                continue
            if isinstance(session, str):
                self._dirs[session] = d

    def _sdir(self, session: str) -> str:
        with self._lock:
            d = self._dirs.setdefault(str(session),
                                      _session_dirname(session))
        return os.path.join(self.root, d)

    @staticmethod
    def _seq_files(sdir: str) -> List[Tuple[int, str]]:
        try:
            names = os.listdir(sdir)
        except OSError:
            return []
        out = []
        for n in names:
            if n.endswith(".ckpt") and not n.startswith("."):
                try:
                    out.append((int(n[:-5]), os.path.join(sdir, n)))
                except ValueError:
                    continue
        return sorted(out)

    def _newest_blob(self, sdir: str) -> Optional[str]:
        files = self._seq_files(sdir)
        return files[-1][1] if files else None

    def put(self, session: str, seq: int, blob: bytes) -> None:
        sdir = self._sdir(session)
        os.makedirs(sdir, exist_ok=True)
        final = os.path.join(sdir, f"{int(seq):012d}.ckpt")
        tmp = os.path.join(sdir, f".{int(seq):012d}.tmp")
        with open(tmp, "wb") as fp:
            fp.write(blob)
            fp.flush()
            os.fsync(fp.fileno())
        os.replace(tmp, final)
        # retention: drop the oldest beyond the bound (never the one
        # just written — seq is monotone per session)
        files = self._seq_files(sdir)
        for _sq, p in files[:max(0, len(files) - self.retention)]:
            try:
                os.unlink(p)
            except OSError:
                pass

    def latest(self, session: str) -> Optional[Dict[str, Any]]:
        for seq, p in reversed(self._seq_files(self._sdir(session))):
            try:
                with open(p, "rb") as fp:
                    return parse_blob(fp.read())
            except (OSError, ValueError) as e:
                _reject("verify", f"{session} seq {seq}: {e}")
        return None

    def watermarks(self) -> Dict[str, int]:
        with self._lock:
            dirs = dict(self._dirs)
        out: Dict[str, int] = {}
        for session, d in dirs.items():
            files = self._seq_files(os.path.join(self.root, d))
            if files:
                out[session] = files[-1][0]
        return out


class NeighborStore(CheckpointStore):
    """The production default: blobs live on *other* workers.

    ``put`` ships the blob to up to ``fanout`` neighbor endpoints as a
    ``meta["checkpoint"]`` frame on the existing KV_PAGE_XFER op; the
    receiving worker files it into its attached store
    (serving/disagg.py). ``latest`` is None by construction — reading
    back happens on the restore path via ``lm_ctl: checkpoint_send``
    against the survivors, not here. Watermarks track what was acked,
    which is exactly what the push doc must claim exists."""

    def __init__(self, endpoints: List[str], *, fanout: int = 1,
                 timeout_s: float = 5.0):
        self.endpoints = [str(e) for e in endpoints]
        self.fanout = max(1, int(fanout))
        self.timeout_s = float(timeout_s)
        self._clients: Dict[str, Any] = {}
        self._lock = threading.Lock()
        self._marks: Dict[str, int] = {}

    def _client(self, endpoint: str) -> Any:
        from ..serving.disagg import PageTransferClient
        from ..query.router import parse_endpoints
        with self._lock:
            c = self._clients.get(endpoint)
            if c is None:
                (host, port), = parse_endpoints(endpoint)
                c = PageTransferClient(host, port, timeout_s=self.timeout_s)
                self._clients[endpoint] = c
        return c

    def put(self, session: str, seq: int, blob: bytes) -> None:
        meta = {"checkpoint": {"v": BLOB_VERSION, "session": str(session),
                               "seq": int(seq)}}
        acked = 0
        for ep in self.endpoints:
            try:
                self._client(ep).send_frame(meta, blob)
                acked += 1
            except (ConnectionError, OSError, QueryProtocolError) as e:
                log.debug("checkpoint ship to %s failed: %s", ep, e)
                with self._lock:
                    c = self._clients.pop(ep, None)
                if c is not None:
                    c.close()
            if acked >= self.fanout:
                break
        if acked == 0:
            raise OSError(
                f"no neighbor accepted checkpoint for {session!r} "
                f"(tried {len(self.endpoints)})")
        with self._lock:
            self._marks[str(session)] = max(
                int(seq), self._marks.get(str(session), 0))

    def latest(self, session: str) -> Optional[Dict[str, Any]]:
        return None  # blobs live on the neighbors; restore asks them

    def watermarks(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._marks)

    def close(self) -> None:
        with self._lock:
            clients, self._clients = list(self._clients.values()), {}
        for c in clients:
            c.close()


# --------------------------------------------------------------------------- #
# CheckpointDaemon
# --------------------------------------------------------------------------- #

class _NullLock:
    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc: Any) -> bool:
        return False


class CheckpointDaemon:
    """Periodic engine snapshotter for one engine.

    ``run_once()`` is the deterministic unit (tests and the bench lane
    call it directly; ``start()`` wraps it in a timer thread): read the
    engine's per-session committed-path watermarks, and for every
    session at least ``min_new_tokens`` past its last checkpoint take a
    read-only snapshot and file it. ``lock`` is the engine's serializer
    (a DisaggWorker passes its ``_elock``) — held only around the two
    engine reads, never across a store put, so a slow store can't stall
    serving. Sequence numbers are the committed token-path length:
    monotone per session with no extra state, and comparable against
    the live engine after the daemon is gone."""

    def __init__(self, engine: Any, store: CheckpointStore, *,
                 interval_s: float = DEFAULT_INTERVAL_S,
                 min_new_tokens: int = 1, lock: Any = None,
                 clock: Callable[[], float] = time.monotonic,
                 name: str = "ckpt") -> None:
        self.engine = engine
        self.store = store
        self.interval_s = float(interval_s)
        self.min_new_tokens = max(1, int(min_new_tokens))
        self.name = name
        self._elock = lock if lock is not None else _NullLock()
        self._clock = clock
        self._last: Dict[str, int] = {}
        self._hook_installed = False
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.stats: Dict[str, int] = {
            "passes": 0, "written": 0, "skipped": 0, "failed": 0}

    def watermarks(self) -> Dict[str, int]:
        """Session → last checkpointed seq — the push-doc slice the
        restore path judges staleness against."""
        return dict(self._last)

    def run_once(self) -> int:
        """One pass; returns checkpoints written."""
        self.stats["passes"] += 1
        t0 = self._clock()
        with self._elock:
            marks = self.engine.session_watermarks()
        written = 0
        for session in sorted(marks):
            seq = int(marks[session])
            if seq < self._last.get(session, 0) + self.min_new_tokens:
                self.stats["skipped"] += 1
                continue
            with self._elock:
                snap = self.engine.checkpoint_session(session)
            if snap is None:
                self.stats["skipped"] += 1
                continue
            path, doc = snap
            # re-derive seq from the snapshot itself: the path may have
            # advanced between the watermark read and the snapshot
            seq = int(np.asarray(path).size)
            blob = build_blob(session, seq, path, doc)
            try:
                self.store.put(session, seq, blob)
            except Exception as e:  # noqa: BLE001 — store is pluggable
                self.stats["failed"] += 1
                _events.record(
                    "fleet.checkpoint_fail",
                    f"checkpoint put failed for {session}: {e}",
                    severity="warning", session=session, error=str(e))
                continue
            self._last[session] = seq
            self.stats["written"] += 1
            written += 1
            _CKPT_SESSIONS.inc()
            _CKPT_BYTES.inc(len(blob))
        if written:
            _CKPT_SECONDS.observe(self._clock() - t0)
            _events.record(
                "fleet.checkpoint_write",
                f"{self.name}: {written} session checkpoint(s) written",
                severity="debug", daemon=self.name, written=written)
        return written

    def install_hook(self) -> None:
        """Publish this daemon's watermarks in push docs (first daemon
        wins — one worker per process is the deployment shape; tests
        pass watermarks explicitly to build_push instead)."""
        if _obsfleet.CHECKPOINT_HOOK is None:
            _obsfleet.CHECKPOINT_HOOK = self.watermarks
            self._hook_installed = True

    def uninstall_hook(self) -> None:
        if self._hook_installed \
                and _obsfleet.CHECKPOINT_HOOK == self.watermarks:
            _obsfleet.CHECKPOINT_HOOK = None
        self._hook_installed = False

    def start(self) -> None:
        if self._thread is not None:
            return
        self.install_hook()
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(self.interval_s):
                try:
                    self.run_once()
                except Exception:  # a sick daemon must not crash serving
                    log.exception("checkpoint pass failed")

        self._thread = threading.Thread(
            target=loop, name=f"fleet-ckpt:{self.name}", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        self._thread = None
        if t is not None:
            join_or_warn(t, f"fleet-ckpt:{self.name}", timeout=5.0)
        self.uninstall_hook()


# --------------------------------------------------------------------------- #
# SessionRestorer
# --------------------------------------------------------------------------- #

class SessionRestorer:
    """Re-homes a dead (non-drained) worker's sessions onto survivors
    and splices their newest valid checkpoints in.

    Driven by the controller's ``restore`` reconcile action with the
    tombstone's endpoint + checkpoint watermarks. Per session: re-pin
    (``repin_dead_owner``), then ask each survivor — new home first,
    it may hold the blob itself — to forward its stored checkpoint to
    the new home (``lm_ctl: checkpoint_send`` with ``min_seq`` = the
    watermark, so anything older than the dead worker's last claimed
    checkpoint is refused as stale). No survivor fresh enough →
    fallback: the new home adopts the session for re-prefill
    (``lm_ctl: adopt_session``), exactly the migrate absorb path."""

    def __init__(self, router: Any, *, caps: str = LM_CAPS,
                 timeout_s: float = 10.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.router = router
        self.caps = caps
        self.timeout_s = float(timeout_s)
        self._clock = clock
        self.stats: Dict[str, int] = {"restored": 0, "re_prefilled": 0}

    def restore_instance(self, instance: str, endpoint: str,
                         watermarks: Optional[Dict[str, int]] = None,
                         deadline: Optional[_rp.Deadline] = None
                         ) -> Dict[str, Any]:
        """Restore every session the dead ``endpoint`` owned. Returns
        the action report the controller journals."""
        t0 = self._clock()
        marks = {str(s): int(q) for s, q in (watermarks or {}).items()}
        _events.record(
            "fleet.restore_start",
            f"instance {instance} ({endpoint}) died without drain; "
            f"restoring its sessions onto survivors",
            severity="warning", instance=instance, endpoint=endpoint)
        # census + re-pin BEFORE severing: remove() drops the ownership
        # tables this reads
        moved = self.router.backends.repin_dead_owner(endpoint)
        try:
            self.router.remove_backend(endpoint, drain=False)
        except KeyError:
            pass
        survivors = {be.endpoint: be
                     for be in self.router.backends.backends()
                     if be.state == "active"}
        sessions: List[Dict[str, Any]] = []
        for session, target_ep in moved:
            ts = self._clock()
            dl = deadline or _rp.Deadline.after_s(self.timeout_s)
            outcome, seq = self._restore_one(
                session, target_ep, marks.get(session, 0), survivors, dl)
            dt = self._clock() - ts
            _RESTORED.labels(outcome).inc()
            _RESTORE_SECONDS.observe(dt)
            self.stats["restored" if outcome == "checkpoint"
                       else "re_prefilled"] += 1
            sessions.append({"session": session, "target": target_ep,
                             "outcome": outcome, "seq": seq,
                             "seconds": dt})
        report = {
            "instance": instance, "endpoint": endpoint,
            "sessions": sessions,
            "restored": sum(1 for s in sessions
                            if s["outcome"] == "checkpoint"),
            "re_prefilled": sum(1 for s in sessions
                                if s["outcome"] == "re_prefill"),
            "seconds": self._clock() - t0,
        }
        _events.record(
            "fleet.restore_done",
            f"instance {instance}: {report['restored']} session(s) "
            f"restored from checkpoint, {report['re_prefilled']} fell "
            f"back to re-prefill",
            instance=instance, endpoint=endpoint,
            restored=report["restored"],
            re_prefilled=report["re_prefilled"])
        return report

    def _restore_one(self, session: str, target_ep: str, min_seq: int,
                     survivors: Dict[str, Any], dl: _rp.Deadline
                     ) -> Tuple[str, int]:
        span = _tracing.start_span(
            "fleet.restore", parent=_tracing.current_context(),
            attrs={"session": session, "target": target_ep})
        outcome, seq = "re_prefill", 0
        try:
            order = [ep for ep in sorted(survivors) if ep == target_ep]
            order += [ep for ep in sorted(survivors) if ep != target_ep]
            for ep in order:
                meta = {"lm_ctl": {"op": "checkpoint_send",
                                   "session": session,
                                   "xfer_to": target_ep,
                                   "min_seq": int(min_seq)},
                        _rp.WIRE_KEY: dl.to_wire()}
                try:
                    rmeta, _ = survivors[ep].request(meta, b"", self.caps)
                except (ConnectionError, OSError, QueryProtocolError):
                    continue
                if rmeta.get("sent"):
                    outcome, seq = "checkpoint", int(rmeta.get("seq", 0))
                    break
            if outcome != "checkpoint":
                # stale / missing / ship failed everywhere: the new
                # home adopts the session cold and re-prefills
                tgt = survivors.get(target_ep)
                if tgt is not None:
                    try:
                        tgt.request(
                            {"lm_ctl": {"op": "adopt_session",
                                        "session": session,
                                        "restored": False}},
                            b"", self.caps)
                    except (ConnectionError, OSError,
                            QueryProtocolError):
                        pass
                _events.record(
                    "fleet.restore_fallback",
                    f"session {session}: no checkpoint >= seq "
                    f"{min_seq} on any survivor; re-prefill absorb",
                    severity="warning", session=session,
                    target=target_ep, min_seq=int(min_seq))
        finally:
            span.set_attribute("outcome", outcome)
            span.end()
        return outcome, seq
