"""tensor_query server side: serversrc / serversink elements — port of
nnstreamer_tpu/query/server.py.

Reference: gst/nnstreamer/tensor_query/tensor_query_serversrc.c /
_serversink.c — a server *pipeline* whose source is remote client frames and
whose sink returns results, paired by ``id``. Usage:

    server pipeline:  tensor_query_serversrc id=0 port=5001 !
                      tensor_filter ... ! tensor_query_serversink id=0

The listener accepts N concurrent clients; each DATA message is pushed into
the pipeline (buffer.meta carries the connection id) and the matching
serversink routes the RESULT back on the same connection. The server
pipeline's filter runs on the card; a result on the card is read back once
into the wire bytes (with ``async_depth > 1`` the copy is issued at chain
time on the producing thread and waited for by the drain thread). An
``OBS_PUSH`` frame is ingested when this process aggregates the fleet
(obs/fleet.py) and dropped otherwise; a ``KV_PAGE_XFER`` frame goes to the
page-import target serving/disagg.py registers, and is answered ERROR
without one.
"""

from __future__ import annotations

import socket
import threading
import time
import weakref
from typing import Any, Dict, Optional

from ..core.buffer import Buffer
from ..core.log import logger
from ..core.types import Caps, TensorsConfig, TensorsInfo
from ..graph.element import (
    Element,
    FlowReturn,
    Pad,
    join_or_warn,
    register_element,
)
from ..graph.pipeline import SourceElement
from ..obs import events as _events
from ..obs import fleet as _fleet
from ..obs import health as _health
from ..obs import metrics as _obs
from ..obs import tracing as _tracing
from ..resilience import policy as _rp
from .protocol import (
    Cmd,
    QueryProtocolError,
    buffer_to_payload,
    payload_to_buffer,
    recv_message,
    send_message,
)

log = logger("query")

_pairs_lock = threading.Lock()
_server_pairs: Dict[int, "TensorQueryServerSrc"] = {}

#: disaggregated-serving import point (serving/disagg.py
#: register_import_target installs/clears this): called as
#: ``hook(meta, payload, deadline) -> pages_imported`` for every
#: ``KV_PAGE_XFER`` frame a serversrc receives; ``deadline`` is already
#: re-anchored on this host's clock (like DATA). None — the default —
#: answers the sender with ERROR: a backend that never registered a
#: page-import target must reject transfers loudly, not absorb them.
#: Disabled cost: one module-global load per non-data frame.
KV_IMPORT_HOOK = None


def handle_kv_page_xfer(conn: socket.socket, meta: Dict[str, Any],
                        payload: bytes, hook: Any = None) -> None:
    """One KV_PAGE_XFER frame: re-anchor the wire deadline, hand the
    page document to the import target, and answer RESULT (pages
    spliced) or ERROR (no target / expired / rejected). Shared by the
    serversrc dispatch (which uses the process-global KV_IMPORT_HOOK)
    and the disaggregated worker loop (which binds its own engine's hook) so
    both endpoints speak identical transfer semantics."""
    hook = hook if hook is not None else KV_IMPORT_HOOK
    dl = _rp.Deadline.from_wire(meta.get(_rp.WIRE_KEY))
    if hook is None:
        send_message(conn, Cmd.ERROR,
                     {"error": "no KV page-import target registered"})
        return
    if dl is not None and dl.expired():
        # the transfer outlived its request budget in flight: splicing
        # now would pin pages for a result nobody is waiting for
        send_message(conn, Cmd.ERROR,
                     {"error": "KV page transfer deadline expired"})
        return
    try:
        n = int(hook(meta, payload, dl))
    except (ValueError, RuntimeError) as e:
        send_message(conn, Cmd.ERROR, {"error": f"kv import rejected: {e}"})
        return
    send_message(conn, Cmd.RESULT, {"kv_imported": n})


def wait_bound_port(src: "TensorQueryServerSrc",
                    timeout_s: float = 10.0) -> int:
    """Block until a started serversrc has bound its listener (it binds in
    negotiate() on the src thread) and return the real port. Raises
    RuntimeError — naming the element — on timeout, e.g. when negotiation
    failed, instead of the bare AttributeError a direct ``src.bound_port``
    read would produce."""
    deadline = time.monotonic() + timeout_s
    while not hasattr(src, "bound_port"):
        if time.monotonic() >= deadline:
            raise RuntimeError(
                f"{src.name}: serversrc did not bind within {timeout_s}s "
                "(negotiation failed? check the pipeline bus)")
        time.sleep(0.02)
    return src.bound_port


@register_element
class TensorQueryServerSrc(SourceElement):
    ELEMENT_NAME = "tensor_query_serversrc"

    def __init__(self, name: Optional[str] = None, **props: Any):
        self.host = "0.0.0.0"
        self.port = 5001
        self.id = 0
        self.caps: Optional[Caps] = None   # declared stream type
        self.dims: Optional[str] = None
        self.types: Optional[str] = None
        super().__init__(name, **props)
        self._listener: Optional[socket.socket] = None
        self._conns: Dict[int, socket.socket] = {}  # guarded-by: _lock
        self._conn_seq = 0  # guarded-by: _lock
        self._inbox: "__import__('queue').Queue" = None
        self._threads = []  # guarded-by: _lock
        # server-side offload telemetry (message/byte counts live at the
        # protocol layer): accepted connections, and inbox depth read at
        # collection time
        reg = _obs.registry()
        self._m_conns = reg.counter(
            "nnstpu_query_connections_total",
            "Client connections accepted by the server listener",
            ("element",)).labels(self.name)
        reg.gauge(
            "nnstpu_query_inbox_depth",
            "Frames queued between the server listener and its pipeline",
            ("element",)).labels(self.name).set_function(
                lambda: self._inbox.qsize() if self._inbox is not None
                else 0)
        # health component: connection count + inbox depth, weakref so the
        # registry never pins a retired listener. A no-op while health is
        # off (shared NOOP_COMPONENT, zero per-frame cost).
        ref = weakref.ref(self)
        self._hc = _health.component(
            f"query.server:{self.name}", kind="query",
            probe=lambda: (lambda s: None if s is None else
                           {"connections": len(s._conns),
                            "inbox_depth": s._inbox.qsize()
                            if s._inbox is not None else 0})(ref()),
            attrs={"element": self.name})

    # -- lifecycle ---------------------------------------------------------- #
    def negotiate(self) -> Caps:
        import queue as _q

        if self.caps is None:
            if self.dims and self.types:
                self.caps = Caps.tensors(
                    TensorsConfig(TensorsInfo.from_strings(self.dims, self.types)))
            else:
                raise ValueError("tensor_query_serversrc needs caps or dims/types")
        self._inbox = _q.Queue(maxsize=64)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((self.host, int(self.port)))
        self._listener.listen(16)
        self._listener.settimeout(0.2)
        with _pairs_lock:
            _server_pairs[int(self.id)] = self
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name=f"qsrv-accept:{self.name}")
        # register BEFORE start: stop() snapshots _threads under _lock,
        # so a started-but-unregistered worker would be unjoinable
        with self._lock:
            self._threads.append(t)
        t.start()
        self.bound_port = self._listener.getsockname()[1]
        return self.caps

    def _accept_loop(self) -> None:
        while not self._stop_flag.is_set():
            try:
                conn, addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            # without NODELAY, Nagle + the client's delayed ACK holds each
            # small RESULT write ~40 ms — measured 65 ms/frame round trips
            # on localhost vs sub-ms with it
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._m_conns.inc()
            self._hc.beat()
            self._hc.count("accept")
            with self._lock:
                self._conn_seq += 1
                cid = self._conn_seq
                self._conns[cid] = conn
            _events.record("query.accept",
                           f"{self.name}: accepted client {cid} from "
                           f"{addr[0]}:{addr[1]}",
                           element=self.name, client=cid)
            t = threading.Thread(target=self._client_loop, args=(cid, conn),
                                 daemon=True, name=f"qsrv-conn{cid}")
            with self._lock:
                self._threads.append(t)
            t.start()

    def _client_loop(self, cid: int, conn: socket.socket) -> None:
        try:
            while not self._stop_flag.is_set():
                cmd, meta, payload = recv_message(conn)
                if cmd is Cmd.INFO_REQ:
                    # approve iff declared caps are compatible (REQUEST_INFO/
                    # RESPOND_APPROVE handshake, tensor_query_common.h:42-51).
                    # The fleet instance id joins this endpoint to its
                    # pushed health/queue-depth snapshots, so a router
                    # can place by live load instead of blind rotation.
                    peer_caps = str(meta.get("caps") or "")
                    peer_mt = peer_caps.split("(", 1)[0].strip()
                    if peer_mt and self.caps is not None \
                            and peer_mt != self.caps.media_type:
                        # explicit deny beats letting the first DATA frame
                        # die on a decode error: the client sees the reason
                        # and its router can strike this backend cleanly
                        send_message(conn, Cmd.INFO_DENY,
                                     {"error": f"caps mismatch: server "
                                      f"streams {self.caps.media_type}, "
                                      f"client declared {peer_mt}",
                                      "caps": str(self.caps)})
                        continue
                    send_message(conn, Cmd.INFO_APPROVE,
                                 {"caps": str(self.caps), "client_id": cid,
                                  "instance": _fleet.default_instance()})
                elif cmd is Cmd.PING:
                    send_message(conn, Cmd.PONG, {})
                elif cmd is Cmd.DATA:
                    self._hc.beat()
                    buf = payload_to_buffer(meta, payload)
                    buf.meta["query_client_id"] = cid
                    sess = meta.get("session")
                    if sess is not None:
                        # session affinity key survives the wire so the
                        # serving layer can pin KV/prefix reuse to it
                        buf.meta["session"] = sess
                    dms = meta.get(_rp.WIRE_KEY)
                    if dms is not None:
                        # re-anchor the remaining budget on THIS host's
                        # monotonic clock (never compare peer clocks);
                        # downstream elements/engines shed if it expires
                        dl = _rp.Deadline.from_wire(dms)
                        if dl is not None:
                            _rp.set_deadline(buf, dl)
                    if _tracing.enabled():
                        # adopt the client's context so one trace spans
                        # both halves: the handling span parents every
                        # server-side pipeline.element span and is closed
                        # once the RESULT goes back out (send_result)
                        rctx = _tracing.ctx_from_wire(
                            meta.get(_tracing.TRACE_META_KEY))
                        if rctx is not None:
                            # wire-crossing trace: mark it so fleet push
                            # exports this half of the tree
                            _tracing.store().mark_export(rctx.trace_id)
                            span = _tracing.start_span(
                                "query.server_handle", parent=rctx,
                                attrs={"client": cid, "element": self.name})
                            if span.recording:
                                buf.meta[_tracing.CTX_META_KEY] = span.context
                                buf.meta[_tracing.ROOT_META_KEY] = span
                    self._inbox.put(buf)
                elif cmd is Cmd.OBS_PUSH:
                    # fleet telemetry piggyback: ingest when this process
                    # aggregates, drop otherwise; never a reply frame
                    _fleet.ingest_wire(meta, payload)
                elif cmd is Cmd.KV_PAGE_XFER:
                    # disaggregated serving: splice migrated KV pages
                    # into the registered engine's pool and answer
                    # RESULT/ERROR
                    self._hc.beat()
                    handle_kv_page_xfer(conn, meta, payload)
                else:
                    send_message(conn, Cmd.ERROR,
                                 {"error": f"unexpected cmd {cmd}"})
        except (ConnectionError, QueryProtocolError, OSError) as e:
            log.debug("server conn %d closed: %s", cid, e)
        finally:
            with self._lock:
                self._conns.pop(cid, None)
            _events.record("query.disconnect",
                           f"{self.name}: client {cid} disconnected",
                           element=self.name, client=cid)
            try:
                conn.close()
            except OSError:
                pass

    def create(self) -> Optional[Buffer]:
        import queue as _q

        while not self._stop_flag.is_set():
            try:
                return self._inbox.get(timeout=0.1)
            except _q.Empty:
                continue
        return None

    def send_result(self, cid: int, buf: Buffer) -> bool:
        span = buf.meta.get(_tracing.ROOT_META_KEY, _tracing.NOOP_SPAN)
        with self._lock:
            conn = self._conns.get(cid)
        if conn is None:
            span.end()
            return False
        meta, payload = buffer_to_payload(buf)
        token = None
        if span.recording:
            # make the handling span current so the RESULT frame carries
            # the trace back to the client (send_message injects it);
            # needed explicitly because the async serversink drains from
            # its own thread, outside any instrumented chain
            token = _tracing._set_current(span.context)
        try:
            send_message(conn, Cmd.RESULT, meta, payload)
            return True
        except OSError as e:
            log.warning("result send to client %d failed: %s", cid, e)
            return False
        finally:
            if token is not None:
                _tracing._reset_current(token)
            span.end()

    def stop(self) -> None:
        super().stop()
        with _pairs_lock:
            _server_pairs.pop(int(self.id), None)
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
            self._listener = None
        with self._lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        # join the accept/connection workers: an accept still inside its
        # (timeout-bounded) syscall keeps the kernel LISTEN socket alive
        # past close(), so returning before it exits races an immediate
        # rebind of the same port with EADDRINUSE (server restart)
        cur = threading.current_thread()
        with self._lock:
            workers = list(self._threads)
            self._threads = []
        for t in workers:
            if t is not cur:
                join_or_warn(t, self.name, timeout=2.0)


@register_element
class TensorQueryServerSink(Element):
    """Routes results back to the paired serversrc connection.

    ``async_depth=N`` (default 1 = synchronous): keep up to N result
    buffers in flight between the filter and the wire. Each buffer's
    card→host copy is *prefetched* at chain time (an async copy into
    pinned memory and an event on the producing thread's stream) and
    materialized by the drain thread in order, waiting on that event only,
    so a card-resident filter output costs one overlapped transfer
    instead of one full device round trip per frame — the
    server-side half of pipelined query offload (client half:
    tensor_query_client ``async_depth``).
    """

    ELEMENT_NAME = "tensor_query_serversink"

    def __init__(self, name: Optional[str] = None, **props: Any):
        self.id = 0
        self.async_depth = 1
        super().__init__(name, **props)
        self.add_sink_pad(template=Caps.any_tensors())
        self._dq: "__import__('collections').deque" = None  # guarded-by: _cv
        self._cv = threading.Condition()
        self._worker: Optional[threading.Thread] = None
        self._draining = False  # guarded-by: _cv

    def _route(self, buf: Buffer) -> None:
        with _pairs_lock:
            src = _server_pairs.get(int(self.id))
        if src is None:
            raise RuntimeError(
                f"tensor_query_serversink id={self.id}: no matching serversrc")
        cid = buf.meta.get("query_client_id")
        if cid is None:
            raise RuntimeError("buffer lost its query_client_id")
        src.send_result(cid, buf)

    def start(self) -> None:
        import collections

        # publish the fresh deque/flag under _cv: a chain() racing a
        # restart must never observe the new deque with the old flag
        with self._cv:
            self._dq = collections.deque()
            self._draining = True
        self._worker = threading.Thread(target=self._drain, daemon=True,
                                        name=f"qsink:{self.name}")
        self._worker.start()

    def stop(self) -> None:
        with self._cv:
            self._draining = False
            self._cv.notify_all()
        w = self._worker
        if w is not None and w is not threading.current_thread():
            join_or_warn(w, self.name, timeout=5.0)
        self._worker = None

    def _drain(self) -> None:
        while True:
            with self._cv:
                while not self._dq and self._draining:
                    self._cv.wait(0.1)
                if not self._dq and not self._draining:
                    return
                buf = self._dq[0]
            try:
                self._route(buf)
            except RuntimeError as e:
                self.post_error(str(e), exc=e)
                with self._cv:
                    # release any producer blocked on a full queue so its
                    # chain() returns ERROR promptly instead of spinning
                    # until an external stop() (mirrors TensorBatch's
                    # _quit_worker teardown)
                    self._draining = False
                    self._cv.notify_all()
                return
            finally:
                with self._cv:
                    # pop AFTER the send: the EOS drain (and therefore
                    # pipeline stop, which closes the client connections)
                    # must not race past a result still being written
                    self._dq.popleft()
                    self._cv.notify_all()

    def chain(self, pad: Pad, buf: Buffer) -> Optional[FlowReturn]:
        depth = int(self.async_depth or 1)
        if depth <= 1:
            self._route(buf)
            return FlowReturn.OK
        for m in buf.memories:
            m.prefetch()  # start the D2H now; drain materializes in order
        with self._cv:
            while len(self._dq) >= depth and self._draining:
                self._cv.wait(0.1)
            if not self._draining:
                return FlowReturn.ERROR
            self._dq.append(buf)
            self._cv.notify_all()
        return FlowReturn.OK

    def on_eos(self) -> None:
        deadline = time.monotonic() + 60
        with self._cv:
            while self._dq and self._draining and time.monotonic() < deadline:
                self._cv.wait(0.2)
