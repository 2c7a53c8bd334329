"""serving.disagg — disaggregated prefill/decode serving over the
query wire; port of nnstreamer_tpu/serving/disagg.py (numpy page codec).

Prefill and decode sit on opposite ends of the roofline (chunked
prefill is compute-bound; decode steps are bandwidth-bound), so
co-locating both phases on one card wastes
whichever resource the current phase doesn't need. This module splits
them across backends — the DistServe/Mooncake shape, and the same
split-the-pipeline-across-machines idea as NNStreamer's edge offload
(PAPERS.md, arXiv:1901.04985) applied to the prefill/decode boundary:

* A **prefill backend** (``LMEngine(role="prefill")``) runs chunked
  prefill only, then streams the finished KV pages to a decode
  backend as one ``Cmd.KV_PAGE_XFER`` frame (radix chunk keys +
  dtype/layout header in meta, concatenated page bits as the payload,
  auto-chunked by the protocol like DATA, deadline re-anchored on the
  receiver's clock).
* The **decode backend** splices the pages into its own pool via
  ``kv_cache.import_pages`` — bit-identical to locally-prefilled
  state, COW-shareable and evictable like any released prefix — and
  its next admission prefix-hits them, regenerating the handoff token
  bit-exactly (position-folded sampling keys make the suffix prefill
  deterministic).
* :class:`DisaggClient` orchestrates the pair over two
  :class:`~..query.router.QueryRouter` fleets: it picks the decode
  target *first* (prefix-digest-aware — the fleet push doc carries
  each backend's bounded radix digest), tells the prefill backend
  where to stream (``xfer_to``), then dispatches the decode request
  pinned to that target under the ORIGINAL deadline. A prefill
  backend dying mid-transfer is absorbed, not surfaced: the decode
  backend simply finds no imported prefix and re-prefills from
  scratch (``disagg.reprefill`` event + counter).
* :class:`PageSpiller` reuses the same transfer path for pressure
  relief: a hot backend sheds cold ref-0 leaf subtrees to a named
  neighbor instead of evicting them — the content survives on the
  fleet, and the neighbor's next shared-prefix request hits it.

Exactness contract (tests/test_disagg.py): the disaggregated path is
token-for-token identical to a unified engine on the same seeded
requests, and ``nnstpu_disagg_pages_sent_total ==
nnstpu_disagg_pages_received_total`` on a clean run.
"""

from __future__ import annotations

import os
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core.log import logger
from ..obs import events as _events
from ..obs import fleet as _fleet
from ..obs import metrics as _obs
from ..obs import tracing as _tracing
from ..query import server as _server
from ..query.protocol import (
    Cmd,
    QueryProtocolError,
    recv_message,
    send_message,
)
from ..query.router import BackendSet, QueryRouter, RouterError, \
    _ShedSignal, parse_endpoints
from ..resilience import policy as _rp
from .kv_cache import PagedKVCache, prompt_path_hashes

log = logger("serving")

__all__ = [
    "DisaggClient",
    "DisaggWorker",
    "PageSpiller",
    "PageTransferClient",
    "clear_import_target",
    "decode_pages",
    "encode_pages",
    "parse_disagg_spec",
    "register_import_target",
]

#: the worker's wire caps string — both sides of a disagg deployment
#: speak LM request dicts, not tensor frames
LM_CAPS = "disagg/lm"

# --------------------------------------------------------------------------- #
# Telemetry — serving/disagg.py owns the ``disagg`` metric/span/event
# layer (scripts/nnslint naming/disagg pins that)
# --------------------------------------------------------------------------- #

_reg = _obs.registry()
_PAGES_SENT = _reg.counter(
    "nnstpu_disagg_pages_sent_total",
    "KV pages shipped to a peer backend and acknowledged")
_PAGES_RECV = _reg.counter(
    "nnstpu_disagg_pages_received_total",
    "KV pages accepted off the wire for splicing into the local pool")
_XFER_BYTES = _reg.counter(
    "nnstpu_disagg_xfer_bytes_total",
    "Page payload bytes shipped over KV_PAGE_XFER frames")
_XFER_SECONDS = _reg.histogram(
    "nnstpu_disagg_xfer_seconds",
    "KV page transfer round trip (encode + wire + remote splice + ack)")
_REPREFILL = _reg.counter(
    "nnstpu_disagg_reprefill_total",
    "Decode requests that re-prefilled from scratch because the"
    " prefill backend or its page transfer was lost")
_SPILL_PAGES = _reg.counter(
    "nnstpu_disagg_spill_pages_total",
    "Cold KV pages shed to a neighbor backend instead of evicted")


# --------------------------------------------------------------------------- #
# Wire framing: transfer document <-> (meta, payload)
# --------------------------------------------------------------------------- #

def encode_pages(doc: Dict[str, Any]) -> Tuple[Dict[str, Any], bytes]:
    """A ``kv_cache.export_pages`` document as one wire frame: meta
    carries the dtype/layout header + root-first chunk keys, the
    payload the concatenated K then V page bits per entry (the
    protocol auto-chunks anything over CHUNK_SIZE). JSON never sees
    the page bits — only the bounded key lists."""
    entries = doc["entries"]
    blobs: List[bytes] = []
    for ent in entries:
        blobs.append(np.ascontiguousarray(ent["k"]).tobytes())
        blobs.append(np.ascontiguousarray(ent["v"]).tobytes())
    meta = {
        "header": {k: doc[k] for k in
                   ("v", "page_size", "lh", "hd", "dtype")},
        "keys": [list(ent["key"]) for ent in entries],
    }
    return meta, b"".join(blobs)


def decode_pages(meta: Dict[str, Any], payload: bytes) -> Dict[str, Any]:
    """Reconstruct the transfer document from a KV_PAGE_XFER frame.
    Raises ValueError on malformed meta or a payload whose size does
    not match the declared geometry — the server maps that to an ERROR
    reply before anything touches a page pool."""
    hdr = meta.get("header")
    keys = meta.get("keys")
    if not isinstance(hdr, dict) or not isinstance(keys, list) or not keys:
        raise ValueError("KV_PAGE_XFER meta needs 'header' and 'keys'")
    try:
        lh = int(hdr["lh"])
        ps = int(hdr["page_size"])
        hd = int(hdr["hd"])
        dt = np.dtype(str(hdr["dtype"]))
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"bad page transfer header: {e}")
    page_bytes = lh * ps * hd * dt.itemsize
    if page_bytes <= 0 or len(payload) != 2 * page_bytes * len(keys):
        raise ValueError(
            f"page payload is {len(payload)} bytes; header geometry "
            f"declares {2 * page_bytes * len(keys)}")
    entries = []
    off = 0
    for key in keys:
        k = np.frombuffer(payload, dt, lh * ps * hd, off).reshape(lh, ps, hd)
        off += page_bytes
        v = np.frombuffer(payload, dt, lh * ps * hd, off).reshape(lh, ps, hd)
        off += page_bytes
        entries.append({"key": [int(x) for x in key], "k": k, "v": v})
    doc = {"v": int(hdr.get("v", 1)), "page_size": ps, "lh": lh,
           "hd": hd, "dtype": str(hdr["dtype"]), "entries": entries}
    return doc


# --------------------------------------------------------------------------- #
# PageTransferClient: one outbound transfer connection
# --------------------------------------------------------------------------- #

class PageTransferClient:
    """Ships page documents to one peer backend.

    Owns a lazily dialed connection (INFO handshake, then one
    KV_PAGE_XFER round trip per :meth:`send_pages`). Failures drop the
    connection so the next send dials fresh; the caller decides
    whether a failed transfer matters (the prefill worker reports it,
    the spiller just keeps the pages)."""

    def __init__(self, host: str, port: int, timeout_s: float = 10.0):
        self.host = host
        self.port = int(port)
        self.endpoint = f"{host}:{port}"
        self.timeout_s = float(timeout_s)
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()

    def _connect(self) -> socket.socket:
        sock = socket.create_connection((self.host, self.port),
                                        timeout=self.timeout_s)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            send_message(sock, Cmd.INFO_REQ, {"caps": LM_CAPS})
            cmd, meta, _ = recv_message(sock)
            if cmd is not Cmd.INFO_APPROVE:
                raise ConnectionError(
                    f"{self.endpoint}: transfer handshake refused: "
                    f"{meta.get('error', meta)}")
        except BaseException:
            try:
                sock.close()
            except OSError:
                pass
            raise
        return sock

    def send_pages(self, doc: Dict[str, Any],
                   deadline: Optional[_rp.Deadline] = None,
                   extra: Optional[Dict[str, Any]] = None) -> int:
        """One transfer round trip: returns the peer's spliced-page
        count. Raises ConnectionError/OSError/QueryProtocolError when
        the peer is gone or rejects the document — the caller's
        re-prefill / keep-local decision point. ``extra`` merges extra
        meta keys into the frame (the fleet restore tag rides here)."""
        meta, payload = encode_pages(doc)
        if extra:
            meta.update(extra)
        rmeta = self.send_frame(meta, payload, deadline,
                                pages=len(doc["entries"]))
        _PAGES_SENT.inc(len(doc["entries"]))
        return int(rmeta.get("kv_imported", 0))

    def send_frame(self, meta: Dict[str, Any], payload: bytes,
                   deadline: Optional[_rp.Deadline] = None, *,
                   pages: int = 0) -> Dict[str, Any]:
        """One raw KV_PAGE_XFER round trip (page docs AND the fleet
        checkpoint frames that reuse the op); returns the reply meta."""
        if deadline is not None:
            # remaining-ms on the wire, re-anchored by the receiver —
            # the transfer spends the same budget the request does
            meta[_rp.WIRE_KEY] = deadline.to_wire()
        span = _tracing.start_span(
            "disagg.xfer", parent=_tracing.current_context(),
            attrs={"peer": self.endpoint, "pages": pages,
                   "bytes": len(payload)})
        t0 = time.monotonic()
        try:
            with self._lock:
                if self._sock is None:
                    self._sock = self._connect()
                sock = self._sock
                try:
                    send_message(sock, Cmd.KV_PAGE_XFER, meta, payload)
                    cmd, rmeta, _ = recv_message(sock)
                except BaseException:
                    self._drop_conn()
                    raise
                if cmd is Cmd.ERROR:
                    raise QueryProtocolError(
                        rmeta.get("error", "transfer rejected"))
                if cmd is not Cmd.RESULT:
                    self._drop_conn()
                    raise QueryProtocolError(
                        f"unexpected transfer reply {cmd}")
            _XFER_BYTES.inc(len(payload))
            _XFER_SECONDS.observe(time.monotonic() - t0)
            return rmeta
        except (ConnectionError, OSError, QueryProtocolError):
            span.set_attribute("error", True)
            raise
        finally:
            span.end()

    def _drop_conn(self) -> None:  # guarded-by: _lock (caller holds it)
        s, self._sock = self._sock, None
        if s is not None:
            try:
                s.close()
            except OSError:
                pass

    def close(self) -> None:
        with self._lock:
            self._drop_conn()


# --------------------------------------------------------------------------- #
# Import target: splice wire pages into an engine's pool
# --------------------------------------------------------------------------- #

def _import_hook_for(engine: Any):
    """The KV_PAGE_XFER handler for one engine: decode the frame,
    queue the document on the engine's import inbox (the scheduler
    thread splices at its next iteration), count the pages accepted
    off the wire. Raises ValueError on a malformed frame — the server
    answers ERROR."""
    def hook(meta: Dict[str, Any], payload: bytes,
             dl: Optional[_rp.Deadline]) -> int:
        doc = decode_pages(meta, payload)
        engine.enqueue_kv_import(doc)
        n = len(doc["entries"])
        _PAGES_RECV.inc(n)
        return n
    return hook


def register_import_target(engine: Any) -> None:
    """Route every KV_PAGE_XFER a serversrc in this process receives
    into ``engine``'s page pool. One target per process (the usual
    module-global hook contract); :class:`DisaggWorker` binds its own
    engine per worker instead and does not need this."""
    _server.KV_IMPORT_HOOK = _import_hook_for(engine)


def clear_import_target() -> None:
    _server.KV_IMPORT_HOOK = None


# --------------------------------------------------------------------------- #
# DisaggWorker: one role-tagged engine behind a wire endpoint
# --------------------------------------------------------------------------- #

def parse_disagg_spec(spec: str) -> Tuple[List[Tuple[str, int]],
                                          List[Tuple[str, int]]]:
    """``"PREFILL_EPS;DECODE_EPS"`` (each side a ``host:port,...``
    list) into (prefill, decode) endpoint lists — the
    ``nns-launch-torch --disagg`` format."""
    head, sep, tail = str(spec).partition(";")
    if not sep or not head.strip() or not tail.strip():
        raise ValueError(
            f"disagg spec must be 'PREFILL_EPS;DECODE_EPS' with both "
            f"sides non-empty, got {spec!r}")
    return parse_endpoints(head), parse_endpoints(tail)


class DisaggWorker:
    """One LM engine served over the query wire, role-tagged.

    Speaks the tensor_query framing with LM request dicts instead of
    tensor frames: ``DATA`` meta carries ``{"lm": {prompt, max_new,
    sampling knobs, seed, session, xfer_to}}`` and the reply is
    ``RESULT {"tokens": [...]}``. A ``role="prefill"`` engine runs
    :meth:`~.lm_engine.LMEngine.prefill_and_export` and streams the
    document to ``xfer_to``; any other role submits/runs normally
    (a decode engine's admission prefix-hits whatever was imported).
    ``KV_PAGE_XFER`` frames splice synchronously under the engine
    lock, so a transfer acked before the decode request arrives is
    visible to it — the ordering :class:`DisaggClient` relies on.

    ``instance`` defaults to ``host:bound_port`` — unique per worker
    even with many workers in one test process, and the id the fleet
    digest + router prefix placement join on.
    """

    def __init__(self, engine: Any, host: str = "127.0.0.1",
                 port: int = 0, instance: Optional[str] = None):
        self.engine = engine
        self.role = getattr(engine, "role", "unified")
        self._elock = threading.Lock()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, int(port)))
        self._listener.listen(16)
        self._listener.settimeout(0.2)
        self.host = host
        self.port = self._listener.getsockname()[1]
        self.endpoint = f"{host}:{self.port}"
        self.instance = instance or self.endpoint
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._conns: List[socket.socket] = []
        self._xfer_clients: Dict[str, PageTransferClient] = {}
        self._push_seq = 0
        # neighbor checkpoint shelf (fleet/checkpoint.py): blobs OTHER
        # workers shipped here for safekeeping, served back on the
        # restore path (lm_ctl: checkpoint_send). Attached explicitly
        # or created lazily on the first checkpoint frame.
        self._ckpt_store: Optional[Any] = None
        # this worker's own daemon, when one runs (push_fleet
        # advertises its watermarks so a restore can judge staleness
        # after this worker is gone)
        self._ckpt_daemon: Optional[Any] = None
        self._ckpt_owned = False
        # zero-code deployment path (nns-launch-torch --checkpoint-dir):
        # NNS_FLEET_CKPT_DIR starts a daemon snapshotting this engine
        # into a shared LocalDirStore every NNS_FLEET_CKPT_INTERVAL s
        ckpt_dir = os.environ.get("NNS_FLEET_CKPT_DIR")
        if ckpt_dir:
            from ..fleet import checkpoint as _ckpt
            store = _ckpt.LocalDirStore(ckpt_dir)
            self._ckpt_store = store
            self._ckpt_daemon = _ckpt.CheckpointDaemon(
                engine, store,
                interval_s=float(os.environ.get(
                    "NNS_FLEET_CKPT_INTERVAL",
                    _ckpt.DEFAULT_INTERVAL_S)),
                lock=self._elock, name=f"ckpt:{self.endpoint}")
            self._ckpt_daemon.start()
            self._ckpt_owned = True
        # default fleet wiring: a worker that serves a KV cache IS the
        # process's digest source, so installing fleet.KV_DIGEST_HOOK here
        # means any FleetPusher in the process advertises this engine's
        # radix-prefix digest without per-deployment glue. First worker
        # wins (one digest per push doc); stop() clears only our own.
        self._digest_hook_installed = False
        if _fleet.KV_DIGEST_HOOK is None \
                and hasattr(engine, "kv_prefix_digest"):
            def _digest(worker=self):
                with worker._elock:
                    return worker.engine.kv_prefix_digest()
            _fleet.KV_DIGEST_HOOK = _digest
            self._digest_hook = _digest
            self._digest_hook_installed = True
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name=f"disagg-accept:{self.endpoint}")
        self._threads.append(t)
        t.start()

    # -- checkpoints (fleet/checkpoint.py) ---------------------------------- #
    @property
    def checkpoint_store(self) -> Optional[Any]:
        return self._ckpt_store

    def attach_checkpoint_store(self, store: Any) -> None:
        """Install the shelf this worker files neighbor checkpoint
        frames into AND serves ``checkpoint_send`` from. A shared
        LocalDirStore makes every worker a read replica; the default
        (lazy MemoryStore) keeps each worker's shelf private."""
        self._ckpt_store = store

    def attach_checkpoint_daemon(self, daemon: Any) -> None:
        """Advertise the local daemon's watermarks in this worker's
        push docs (the tombstone slice restores judge staleness by)."""
        self._ckpt_daemon = daemon

    def _ckpt_shelf(self) -> Any:
        if self._ckpt_store is None:
            from ..fleet import checkpoint as _ckpt
            self._ckpt_store = _ckpt.MemoryStore()
        return self._ckpt_store

    # -- fleet ------------------------------------------------------------- #
    def push_fleet(self, agg: Optional[_fleet.FleetAggregator] = None
                   ) -> Dict[str, Any]:
        """Publish this worker's snapshot — including the engine's
        bounded radix-prefix digest — to the given (default: process-
        global) aggregator. Deterministic single push for tests and
        the DisaggClient placement loop; a deployment would run a
        FleetPusher with fleet.KV_DIGEST_HOOK instead."""
        self._push_seq += 1
        with self._elock:
            digest = self.engine.kv_prefix_digest()
        marks = None if self._ckpt_daemon is None \
            else self._ckpt_daemon.watermarks()
        doc = _fleet.build_push(self.instance, self.role, self._push_seq,
                                kv_prefix=digest, checkpoints=marks,
                                endpoint=self.endpoint)
        # readiness here is the worker's, not the process health
        # registry's: this method runs iff the accept loop is serving
        doc["ready"] = {"ready": not self._stop.is_set(), "conditions": {}}
        target = agg if agg is not None else _fleet.aggregator()
        if target is not None:
            target.ingest(doc, via="wire")
        return doc

    # -- wire loops -------------------------------------------------------- #
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._conns.append(conn)
            t = threading.Thread(target=self._conn_loop, args=(conn,),
                                 daemon=True,
                                 name=f"disagg-conn:{self.endpoint}")
            self._threads.append(t)
            t.start()

    def _conn_loop(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                cmd, meta, payload = recv_message(conn)
                if cmd is Cmd.INFO_REQ:
                    send_message(conn, Cmd.INFO_APPROVE,
                                 {"caps": LM_CAPS,
                                  "instance": self.instance,
                                  "role": self.role})
                elif cmd is Cmd.PING:
                    send_message(conn, Cmd.PONG, {})
                elif cmd is Cmd.KV_PAGE_XFER:
                    _server.handle_kv_page_xfer(
                        conn, meta, payload, hook=self._kv_import)
                elif cmd is Cmd.OBS_PUSH:
                    _fleet.ingest_wire(meta, payload)
                elif cmd is Cmd.DATA:
                    self._handle_lm(conn, meta)
                else:
                    send_message(conn, Cmd.ERROR,
                                 {"error": f"unexpected cmd {cmd}"})
        except (ConnectionError, QueryProtocolError, OSError) as e:
            log.debug("disagg conn on %s closed: %s", self.endpoint, e)
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _kv_import(self, meta: Dict[str, Any], payload: bytes,
                   dl: Optional[_rp.Deadline]) -> int:
        """Synchronous splice under the engine lock — when the sender
        sees the RESULT ack, the pages are already in the pool, so a
        decode request racing in right behind it prefix-hits them.

        Two fleet/checkpoint.py frame kinds ride the same op: a
        ``meta["checkpoint"]`` frame is a neighbor's blob to shelve
        (payload = the blob, never touches the pool); a
        ``meta["restore"]`` tag on a normal page frame additionally
        adopts the session once the splice lands, so its next prefill
        carries the ``restore`` diag attribution."""
        ck = meta.get("checkpoint")
        if isinstance(ck, dict):
            session, seq = ck.get("session"), ck.get("seq")
            if not isinstance(session, str) or not session:
                raise ValueError("checkpoint frame needs a 'session'")
            self._ckpt_shelf().put(session, int(seq or 0), payload)
            return 0
        doc = decode_pages(meta, payload)
        rs = meta.get("restore")
        with self._elock:
            kv: Optional[PagedKVCache] = self.engine._kv
            if kv is None:
                raise RuntimeError("engine has no paged KV cache")
            n = kv.import_pages(doc)
            if isinstance(rs, dict) and rs.get("session"):
                # adoption only after a successful splice — a rejected
                # doc raises above and the sender falls back
                self.engine.adopt_restored_session(
                    str(rs["session"]), rs.get("path"), restored=True)
        _PAGES_RECV.inc(len(doc["entries"]))
        return n

    def _handle_lm(self, conn: socket.socket, meta: Dict[str, Any]) -> None:
        ctl = meta.get("lm_ctl")
        if isinstance(ctl, dict):
            self._handle_ctl(conn, ctl, meta)
            return
        req = meta.get("lm")
        if not isinstance(req, dict) or "prompt" not in req:
            send_message(conn, Cmd.ERROR,
                         {"error": "DATA meta needs an 'lm' request dict"})
            return
        dl = _rp.Deadline.from_wire(meta.get(_rp.WIRE_KEY))
        kw = dict(temperature=float(req.get("temperature", 0.0)),
                  top_k=int(req.get("top_k", 0)),
                  top_p=float(req.get("top_p", 1.0)),
                  seed=int(req.get("seed", 0)),
                  deadline=dl, session=req.get("session"))
        prompt = req["prompt"]
        try:
            if self.role == "prefill":
                with self._elock:
                    tok, doc = self.engine.prefill_and_export(prompt, **kw)
                reply = {"tokens": [] if tok is None else [int(tok)],
                         "pages_sent": 0}
                xfer_to = req.get("xfer_to")
                if doc is not None and xfer_to:
                    reply["pages_sent"] = self._ship(doc, str(xfer_to),
                                                     dl, reply)
            else:
                with self._elock:
                    rid = self.engine.submit(
                        prompt, int(req.get("max_new", 1)),
                        req.get("eos"), **kw)
                    self.engine.run()
                    out = self.engine.results.get(rid, [])
                reply = {"tokens": [int(t) for t in out]}
        except ValueError as e:
            send_message(conn, Cmd.ERROR, {"error": str(e)})
            return
        send_message(conn, Cmd.RESULT, reply)

    def _handle_ctl(self, conn: socket.socket, ctl: Dict[str, Any],
                    meta: Dict[str, Any]) -> None:
        """Fleet control plane (fleet/migrate.py) riding the LM DATA
        wire: ``export_session`` freezes a session, exports its KV
        pages, and ships them to the migration target over the same
        KV_PAGE_XFER op the prefill→decode hand-off uses;
        ``resume_session`` lifts the freeze (migration absorb path)."""
        op = ctl.get("op")
        session = ctl.get("session")
        if not session:
            send_message(conn, Cmd.ERROR,
                         {"error": "lm_ctl needs a 'session'"})
            return
        dl = _rp.Deadline.from_wire(meta.get(_rp.WIRE_KEY))
        if op == "export_session":
            with self._elock:
                doc = self.engine.export_session(str(session))
            reply: Dict[str, Any] = {"session": str(session),
                                     "pages_sent": 0,
                                     "exported": doc is not None}
            xfer_to = ctl.get("xfer_to")
            if doc is not None and xfer_to:
                reply["pages_sent"] = self._ship(doc, str(xfer_to),
                                                 dl, reply)
            if reply.get("xfer_error"):
                # shipment failed with the source alive: keep serving
                # here until the controller's drain moves the session
                with self._elock:
                    self.engine.resume_session(str(session))
            send_message(conn, Cmd.RESULT, reply)
        elif op == "resume_session":
            with self._elock:
                self.engine.resume_session(str(session))
            send_message(conn, Cmd.RESULT, {"session": str(session),
                                            "resumed": True})
        elif op == "checkpoint_send":
            send_message(conn, Cmd.RESULT,
                         self._checkpoint_send(str(session), ctl, dl))
        elif op == "adopt_session":
            # crash-restore fallback (fleet/checkpoint.SessionRestorer):
            # this worker becomes the session's home with no pages —
            # restored=False marks its next prefill re_prefill
            with self._elock:
                self.engine.adopt_restored_session(
                    str(session), ctl.get("path"),
                    restored=bool(ctl.get("restored", False)))
            send_message(conn, Cmd.RESULT, {"session": str(session),
                                            "adopted": True})
        else:
            send_message(conn, Cmd.ERROR,
                         {"error": f"unknown lm_ctl op {op!r}"})

    def _checkpoint_send(self, session: str, ctl: Dict[str, Any],
                         dl: Optional[_rp.Deadline]) -> Dict[str, Any]:
        """Serve one shelved checkpoint to a restore target: newest
        valid blob for ``session``, refused as stale when older than
        ``min_seq`` (the dead worker's last pushed watermark), shipped
        to ``xfer_to`` as a restore-tagged page frame the target
        splices AND adopts in one ack."""
        reply: Dict[str, Any] = {"session": session, "found": False,
                                 "sent": False}
        store = self._ckpt_store
        ck = store.latest(session) if store is not None else None
        if ck is None:
            return reply
        reply["found"] = True
        reply["seq"] = int(ck["seq"])
        min_seq = int(ctl.get("min_seq") or 0)
        if ck["seq"] < min_seq:
            reply["stale"] = True
            return reply
        xfer_to = ctl.get("xfer_to")
        if ck["doc"] is None or not xfer_to:
            return reply  # path-only blob: nothing to warm with
        meta, payload = encode_pages(ck["doc"])
        meta["restore"] = {"session": session, "seq": int(ck["seq"]),
                           "path": [int(t) for t in ck["path"]]}
        try:
            client = self._xfer_clients.get(str(xfer_to))
            if client is None:
                (host, port), = parse_endpoints(str(xfer_to))
                client = PageTransferClient(host, port)
                self._xfer_clients[str(xfer_to)] = client
            client.send_frame(meta, payload, dl,
                              pages=len(ck["doc"]["entries"]))
        except Exception as e:  # noqa: BLE001 — reply carries the failure
            reply["xfer_error"] = str(e)
            return reply
        reply["sent"] = True
        reply["pages"] = len(ck["doc"]["entries"])
        return reply

    def _ship(self, doc: Dict[str, Any], xfer_to: str,
              dl: Optional[_rp.Deadline], reply: Dict[str, Any]) -> int:
        """Stream an export document to the decode backend; a dead or
        rejecting peer is reported in the reply, never raised — the
        client's re-prefill path owns that failure."""
        try:
            client = self._xfer_clients.get(xfer_to)
            if client is None:
                (host, port), = parse_endpoints(xfer_to)
                client = PageTransferClient(host, port)
                self._xfer_clients[xfer_to] = client
            client.send_pages(doc, deadline=dl)
        except Exception as e:  # noqa: BLE001 — reply carries the failure
            reply["xfer_error"] = str(e)
            return 0
        return len(doc["entries"])

    def stop(self) -> None:
        self._stop.set()
        if self._ckpt_owned and self._ckpt_daemon is not None:
            self._ckpt_daemon.stop()
        if self._digest_hook_installed \
                and _fleet.KV_DIGEST_HOOK is self._digest_hook:
            _fleet.KV_DIGEST_HOOK = None
        try:
            self._listener.close()
        except OSError:
            pass
        for c in self._xfer_clients.values():
            c.close()
        cur = threading.current_thread()
        for t in self._threads:
            if t is not cur:
                t.join(timeout=2.0)

    def kill(self) -> None:
        """kill -9 semantics for in-process workers (the chaos ``kill``
        fault's shim target): no drain, no export round trip, no
        goodbye push — the listener and every live connection just die
        mid-frame, exactly what peers of a SIGKILLed subprocess see.
        The engine object survives only because the test process does;
        nothing reads it again."""
        self._stop.set()
        if self._ckpt_owned and self._ckpt_daemon is not None:
            # a real SIGKILL takes the daemon thread with it; stopping
            # (not flushing) ours is the in-process equivalent
            self._ckpt_daemon.stop()
        if self._digest_hook_installed \
                and _fleet.KV_DIGEST_HOOK is self._digest_hook:
            _fleet.KV_DIGEST_HOOK = None
        # sever live connections too: a conn thread parked in recv on
        # an already-delivered frame must die mid-frame, not serve one
        # last request the way a graceful stop() would
        for sock in [self._listener, *self._conns,
                     *[c._sock for c in self._xfer_clients.values()
                       if c._sock is not None]]:
            try:
                sock.close()
            except OSError:
                pass


# --------------------------------------------------------------------------- #
# DisaggClient: prefill fleet + decode fleet behind one generate()
# --------------------------------------------------------------------------- #

def _as_endpoints(spec: Any) -> List[Tuple[str, int]]:
    """Endpoint spec in any accepted shape — a ``host:port,...``
    string, a list of such strings, or an already-parsed
    ``[(host, port)]`` list — normalized to the latter."""
    if isinstance(spec, str):
        return parse_endpoints(spec)
    spec = list(spec)
    if spec and isinstance(spec[0], (tuple, list)):
        return [(str(h), int(p)) for h, p in spec]
    return parse_endpoints(spec)


class DisaggClient:
    """Routes one LM request across a prefill fleet and a decode fleet.

    Per :meth:`generate` call:

    1. choose the decode target FIRST — prefix-digest-aware
       (``prompt_path_hashes`` probed against the fleet digest via the
       router's ``longest_prefix`` placement), so a backend already
       holding the prompt's prefix wins before two-choice;
    2. dispatch the prefill request with ``xfer_to=<decode endpoint>``
       — the prefill backend streams its finished pages there;
    3. dispatch the decode request pinned (``prefer=``) to that same
       backend under the ORIGINAL deadline.

    A failed prefill or transfer is absorbed: the decode backend finds
    no imported prefix and re-prefills from scratch
    (``disagg.reprefill``). Failover within either fleet is the
    routers' existing contract.
    """

    def __init__(self, prefill: Any, decode: Any = None, *,
                 page_size: int, name: str = "disagg",
                 timeout_s: float = 10.0, max_request_retry: int = 3,
                 retry_policy: Optional[_rp.RetryPolicy] = None):
        if isinstance(prefill, str) and ";" in prefill and decode is None:
            prefill, decode = parse_disagg_spec(prefill)
        if decode is None:
            raise ValueError(
                "DisaggClient needs both fleets: pass (prefill, decode) "
                "or one 'PREFILL_EPS;DECODE_EPS' spec string")
        self.page_size = int(page_size)
        self.name = name
        self._prefill = QueryRouter(
            BackendSet(_as_endpoints(prefill), f"{name}.prefill",
                       timeout_s=timeout_s),
            f"{name}.prefill", max_request_retry=max_request_retry,
            retry_policy=retry_policy)
        self._decode = QueryRouter(
            BackendSet(_as_endpoints(decode), f"{name}.decode",
                       timeout_s=timeout_s),
            f"{name}.decode", max_request_retry=max_request_retry,
            retry_policy=retry_policy)
        for r in (self._prefill, self._decode):
            r.set_caps_provider(lambda: LM_CAPS)
        self._primed = False
        self.stats = {"requests": 0, "reprefills": 0, "pages_sent": 0}

    def _prime_once(self) -> None:
        if not self._primed:
            # learn every backend's fleet instance id up front — the
            # decode choice must be able to prefix-match on request one
            self._prefill.prime()
            self._decode.prime()
            self._primed = True

    def generate(self, prompt: Any, max_new: int, *,
                 eos: Optional[int] = None, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0, seed: int = 0,
                 session: Optional[str] = None,
                 deadline: Optional[_rp.Deadline] = None) -> List[int]:
        """One request through the disaggregated path; returns the
        generated tokens (empty when shed on an expired deadline)."""
        self._prime_once()
        self.stats["requests"] += 1
        p = [int(x) for x in np.asarray(prompt, np.int32).reshape(-1)]
        hashes = prompt_path_hashes(p, self.page_size)
        target = self._decode.choose(session=session, prefix_hashes=hashes)
        lm = {"prompt": p, "temperature": temperature, "top_k": top_k,
              "top_p": top_p, "seed": seed}
        if eos is not None:
            lm["eos"] = eos
        if session is not None:
            lm["session"] = session
        try:
            pre = dict(lm, max_new=1)
            if target is not None:
                pre["xfer_to"] = target.endpoint
            rmeta, _ = self._prefill.dispatch(
                {"lm": pre}, b"", deadline=deadline)
            sent = int(rmeta.get("pages_sent", 0))
            self.stats["pages_sent"] += sent
            if sent == 0 or rmeta.get("xfer_error"):
                # prefilled but nothing landed remotely (short prompt,
                # dead transfer target, rejected import): decode will
                # prefill from token zero
                self._note_reprefill(rmeta.get("xfer_error")
                                     or "no pages transferred")
        except (RouterError, QueryProtocolError) as e:
            # the whole prefill fleet failed this request — classic
            # transfer-source-died: decode re-prefills under the
            # request's ORIGINAL deadline, which keeps ticking below
            self._note_reprefill(str(e))
        except _ShedSignal:
            # expired at the prefill door: the decode dispatch below
            # would shed too — the whole request is a legal drop
            return []
        try:
            rmeta, _ = self._decode.dispatch(
                {"lm": dict(lm, max_new=int(max_new))}, b"",
                deadline=deadline, session=session, prefix_hashes=hashes,
                prefer=target.endpoint if target is not None else None)
        except _ShedSignal:
            return []
        return [int(t) for t in rmeta.get("tokens", [])]

    def _note_reprefill(self, why: str) -> None:
        self.stats["reprefills"] += 1
        _REPREFILL.inc()
        _events.record(
            "disagg.reprefill",
            f"{self.name}: decode re-prefills from scratch ({why})",
            severity="warning", element=self.name)

    def close(self) -> None:
        self._prefill.close()
        self._decode.close()


# --------------------------------------------------------------------------- #
# PageSpiller: shed cold subtrees to a neighbor instead of evicting
# --------------------------------------------------------------------------- #

class PageSpiller:
    """Pressure relief over the transfer path: when the pool's
    claimable capacity drops below ``(1 - watermark) * n_pages``, ship
    up to ``max_nodes`` of the coldest ref-0 leaf paths to a peer and
    :meth:`~.kv_cache.PagedKVCache.shed` each one that the peer acks —
    the content keeps existing on the fleet instead of being destroyed
    by eviction. A dead or rejecting peer costs nothing: the pages stay
    local and the next eviction handles them the classic way.

    The spill target is resolved per :meth:`maybe_spill` call: an
    explicit ``neighbor`` always wins; without one the least-loaded
    routable instance from the fleet aggregator's
    :meth:`~nnstreamer_tpu_torch.obs.fleet.FleetAggregator.routing_view` is
    dialed (DisaggWorker instances advertise their ``host:port``
    endpoint as their fleet id, so the view's keys are dialable).
    ``self_instance`` excludes this process from its own candidates.
    With neither a neighbor nor an aggregator, spilling is off.

    Call :meth:`maybe_spill` from the engine's owning thread (the
    cache is single-threaded); it is one comparison when the pool is
    below the watermark."""

    def __init__(self, kv: PagedKVCache,
                 neighbor: Optional[PageTransferClient] = None,
                 watermark: float = 0.85, max_nodes: int = 4,
                 self_instance: Optional[str] = None):
        if not 0.0 < watermark <= 1.0:
            raise ValueError("watermark must be in (0, 1]")
        self.kv = kv
        self.neighbor = neighbor
        self.watermark = float(watermark)
        self.max_nodes = int(max_nodes)
        self.self_instance = self_instance
        #: dialed fleet peers, kept across spills so a repeat target
        #: reuses its handshaken connection
        self._peers: Dict[str, PageTransferClient] = {}

    def _pick_target(self) -> Optional[PageTransferClient]:
        if self.neighbor is not None:
            return self.neighbor
        agg = _fleet.aggregator()
        if agg is None:
            return None
        best_iid, best_depth = None, None
        for iid, row in agg.routing_view().items():
            if not row.get("routable") or iid == self.self_instance:
                continue
            # dialable ids only: the routing view also carries
            # non-worker instances pushed by name, not endpoint
            host, _, port = iid.rpartition(":")
            if not host or not port.isdigit():
                continue
            depth = row.get("queue_depth") or 0.0
            if best_depth is None or depth < best_depth:
                best_iid, best_depth = iid, depth
        if best_iid is None:
            return None
        peer = self._peers.get(best_iid)
        if peer is None:
            host, _, port = best_iid.rpartition(":")
            peer = PageTransferClient(host, int(port))
            self._peers[best_iid] = peer
        return peer

    def maybe_spill(self) -> int:
        """Returns pages freed locally (0 when below pressure, no
        target is resolvable, or the peer refused everything)."""
        kv = self.kv
        if kv.used_pages() < self.watermark * kv.n_pages:
            return 0
        target = self._pick_target()
        if target is None:
            return 0
        freed = 0
        for nd in kv.coldest(self.max_nodes):
            doc = kv.export_path(nd)
            if doc is None:
                continue
            try:
                target.send_pages(doc)
            except (ConnectionError, OSError, QueryProtocolError) as e:
                _events.record(
                    "disagg.spill",
                    f"spill to {target.endpoint} failed ({e}) — "
                    f"keeping pages local", severity="warning",
                    peer=target.endpoint)
                break
            n = kv.shed(nd)
            freed += n
            _SPILL_PAGES.inc(n)
            _events.record(
                "disagg.spill",
                f"shed {n} cold page(s) to {target.endpoint} "
                f"instead of evicting", severity="debug",
                peer=target.endpoint, pages=n)
        return freed
