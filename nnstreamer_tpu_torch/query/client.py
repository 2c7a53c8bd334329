"""tensor_query_client — per-buffer remote offload element; port of
nnstreamer_tpu/query/client.py.

Reference: gst/nnstreamer/tensor_query/tensor_query_client.c (chain :658:
send frame, receive result, push downstream; retry/reconnect :769-776;
broker-based discovery via tensor_query_hybrid when ``operation`` is set).

Props: host/port (direct), or ``operation=<topic>`` + broker-host/port for
hybrid discovery; ``sparse=true`` compresses request payloads;
``max-request-retry`` is ONE shared retry budget per request (connect
dials + resends draw from the same pool, with full-jitter exponential
backoff between attempts — resilience/policy.py). A circuit breaker
tracks the remote path; with ``fallback=`` set (``passthrough`` or a
local element kind) an open breaker routes buffers to the local path
and health reports DEGRADED instead of erroring the pipeline.
``deadline-ms`` stamps a per-buffer deadline that is shed client-side
when expired and travels on the wire as remaining budget;
``drain-timeout-s`` bounds the EOS drain of pipelined results.

``async_depth=N`` (default 1 = reference-equivalent synchronous
semantics): keep up to N requests in flight on the one TCP stream. A
server whose filter runs on a remote device costs one round trip per
frame; with N>1 those round trips overlap
and offload throughput approaches N/RTT instead of 1/RTT — the query-layer
analog of tensor_decoder's ``async_depth``. Results return in order (the
stream and the server pipeline are serial), so PTS restoration is a FIFO.
Retry/reconnect applies to the synchronous path; in pipelined mode a
connection failure fails the in-flight window (pipeline error) rather than
silently replaying frames.

A ``fallback=`` element (a callable becomes a local ``tensor_filter``) runs
on the device the hosting pipeline offers (``set_default_device``), so a
card pipeline's fallback runs on the card. With the fleet push on
(obs/fleet.py ``--obs-push wire``), an ``OBS_PUSH`` frame rides ahead of a
DATA frame whenever the push interval has elapsed; with it off none is
built.
"""

from __future__ import annotations

import collections
import socket
import threading
import time
import weakref
from typing import Any, Optional

from ..core.buffer import Buffer
from ..core.log import logger
from ..core.types import Caps, TensorFormat
from ..graph.element import (
    Element,
    FlowReturn,
    Pad,
    join_or_warn,
    make_element,
    register_element,
)
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
    pack_message,
    payload_to_buffer,
    recv_message,
    send_message,
)

log = logger("query")


class _FallbackTap(Element):
    """Internal sink for a client's fallback element: whatever the
    fallback produces is forwarded out of the hosting client's src pad,
    so downstream sees one stream whether frames went remote or local.
    Built only by TensorQueryClient — never registered."""

    ELEMENT_NAME = "fallback_tap"

    def __init__(self, owner: "TensorQueryClient"):
        super().__init__(name=f"{owner.name}.fallback_tap")
        self.add_sink_pad(template=Caps.any_tensors())
        self._owner = owner

    def chain(self, pad: Pad, buf: Buffer) -> Optional[FlowReturn]:
        return self._owner.push(buf)


@register_element
class TensorQueryClient(Element):
    ELEMENT_NAME = "tensor_query_client"

    def __init__(self, name: Optional[str] = None, **props: Any):
        self.host = "127.0.0.1"
        self.port = 5001
        self.operation: Optional[str] = None  # hybrid topic
        self.broker_host = "127.0.0.1"
        self.broker_port = 5300
        self.sparse = False
        self.max_request_retry = 3
        self.timeout_s = 10.0
        self.async_depth = 1  # >1: pipelined requests (see module doc)
        # resilience knobs (resilience/policy.py). max_request_retry is
        # a single SHARED RetryBudget per request — connect dials and
        # request resends draw from one pool instead of multiplying.
        self.retry_base_s = 0.05    # backoff: first-retry jitter cap
        self.retry_max_s = 1.0      # backoff: ceiling for later retries
        self.breaker_threshold = 5  # consecutive failures to open
        self.breaker_reset_s = 5.0  # open→half-open cooldown
        #: local degradation when the remote path is down: "passthrough"
        #: forwards input buffers unchanged; any registered element kind
        #: (e.g. a local tensor_filter) processes them instead. Unset →
        #: failures keep today's error semantics.
        self.fallback: Any = None
        #: stamp this per-buffer deadline budget (ms) on ingress when
        #: upstream didn't already attach one; 0 = no deadline
        self.deadline_ms = 0.0
        #: EOS drain patience for pipelined in-flight results
        #: (was a hardcoded 60 s)
        self.drain_timeout_s = 60.0
        #: routed mode: a comma-separated "host:port,host:port" string
        #: (or list) of tensor_query servers. Set, it replaces the
        #: single host/port link with a QueryRouter — per-backend
        #: breakers, two-choice placement, mid-stream failover. Unset
        #: (default), no router object exists and chain() pays one
        #: is-None check — the chaos-hook zero-overhead contract.
        self.backends: Any = None
        #: hedged dispatch delay floor in ms (routed mode only; 0 =
        #: hedging off). The live delay is max(observed P95, hedge_ms).
        self.hedge_ms = 0.0
        super().__init__(name, **props)
        self.add_sink_pad(template=Caps.any_tensors())
        self.add_src_pad(template=Caps.any_tensors())
        self._sock: Optional[socket.socket] = None
        self._caps_out_sent = False
        self._pending: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._reader: Optional[threading.Thread] = None
        self._reader_error: Optional[Exception] = None
        self._pong = False
        # _pending entries are mutable [pts, duration, offset, sent]
        # records; `sent` flips True under _cv once send_message returns.
        # The reader's error path counts only sent entries as lost; a
        # frame whose send raced the connection death is caught by its
        # own chain call via _reader_dead (see _reader_loop / the
        # post-send check in _chain_pipelined) — no silent-loss window.
        self._reader_dead = False
        self._last_activity = 0.0
        #: reused connections idle longer than this get a PING/PONG probe
        #: before the next frame (a peer that died while idle is only
        #: detectable by traffic); short gaps skip the probe so steady
        #: streams never pay the extra round trip
        self.idle_probe_s = 0.5
        # breaker guarding the remote path; it only GATES sends when a
        # fallback is configured (without one, refusing to try would
        # just turn retry errors into faster errors) but it always
        # tracks state for the gauge/events
        self._breaker = _rp.CircuitBreaker(
            f"query:{self.name}",
            failure_threshold=int(self.breaker_threshold),
            reset_s=float(self.breaker_reset_s))
        self._fallback_el: Optional[Element] = None
        self._fallback_tap: Optional[_FallbackTap] = None
        self._fb_active = False      # fallback carried the last buffer
        #: the device a Pipeline constructed with ``device=`` offers; the
        #: fallback element is given it
        self._default_device: Any = None
        self._last_deadline: Optional[_rp.Deadline] = None
        #: multi-backend router (query/router.py); stays None without
        #: ``backends=`` so the routed branch in chain() costs one
        #: attribute load + is-None check
        self._router = None
        #: EOS drain in progress: _connect refuses to dial (the drain
        #: is waiting for RESULTs already owed on the existing link —
        #: a fresh connection can't deliver them, only leak)
        self._draining = False
        # offload telemetry (obs subsystem; message/byte counts live at
        # the protocol layer): dials, request round trips, and the
        # pipelined in-flight window (collection-time read, no hot cost)
        reg = _obs.registry()
        self._m_reconnects = reg.counter(
            "nnstpu_query_reconnects_total",
            "Client connection dials (first connect + reconnects)",
            ("element",)).labels(self.name)
        self._m_rtt = reg.histogram(
            "nnstpu_query_roundtrip_seconds",
            "Request submit to result round-trip latency",
            ("element",)).labels(self.name)
        reg.gauge(
            "nnstpu_query_inflight_depth",
            "Pipelined requests currently in flight",
            ("element",)).labels(self.name).set_function(
                lambda: len(self._pending))
        # health (obs/health.py): connection-liveness component (the
        # watchdog's reconnect-storm rule reads its "reconnect" count)
        # and the "query connected" readiness condition — the shared
        # no-op component / a skipped registration while health is off.
        # Weakref probes: the registry never pins a retired element.
        ref = weakref.ref(self)
        self._hc = _health.component(
            f"query.client:{self.name}", kind="query",
            probe=lambda: (lambda c: None if c is None else
                           {"connected": c._sock is not None,
                            "in_flight": len(c._pending),
                            "routed": c._router is not None})(ref()),
            attrs={"element": self.name})
        # routed mode has no single _sock; ready = any active backend
        _health.add_readiness(
            f"query:{self.name}",
            lambda: (lambda c: None if c is None
                     else (any(b.state == "active"
                               for b in c._router.backends.backends())
                           if c._router is not None
                           else c._sock is not None))(ref()))

    # -- connection ---------------------------------------------------------- #
    def _resolve_endpoints(self) -> list:
        if self.operation:
            from .hybrid import discover

            nodes = discover(self.operation, self.broker_host,
                             int(self.broker_port))
            if not nodes:
                raise ConnectionError(
                    f"hybrid discovery: no servers for {self.operation!r}")
            return nodes  # failover across all advertised nodes
        return [(self.host, int(self.port))]

    def _connect(self) -> socket.socket:
        if self._draining:
            # EOS drain must never dial: a new connection can't carry
            # the in-flight results the drain is waiting for, and the
            # old drain/reconnect race left sockets behind
            raise ConnectionError(
                f"{self.name}: draining — refusing to open a connection")
        last: Optional[Exception] = None
        for host, port in self._resolve_endpoints():
            sock: Optional[socket.socket] = None
            # any failure on this node — TCP connect, a reset mid-handshake,
            # a protocol violation, or a deny — moves on to the next node
            try:
                sock = socket.create_connection((host, port),
                                                timeout=self.timeout_s)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                send_message(sock, Cmd.INFO_REQ,
                             {"caps": str(self.sink_pad.caps or "")})
                cmd, meta, _ = recv_message(sock)
                if cmd is Cmd.INFO_DENY:
                    raise ConnectionError(
                        f"server denied connection: "
                        f"{meta.get('error', meta)}")
                if cmd is not Cmd.INFO_APPROVE:
                    raise ConnectionError(f"unexpected handshake reply "
                                          f"{cmd}: {meta}")
                self._m_reconnects.inc()
                self._hc.count("reconnect")  # watchdog storm-rule input
                self._hc.beat()
                self._hc.set_status(_health.Status.OK,
                                    f"connected to {host}:{port}")
                _events.record("query.connect",
                               f"{self.name}: connected to {host}:{port}",
                               element=self.name)
                return sock
            except (OSError, QueryProtocolError, ConnectionError) as e:
                last = e
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
        raise ConnectionError(f"no reachable server: {last}")

    def _ensure_conn(self) -> socket.socket:
        """Dial once if unconnected. Retry ownership lives with the
        caller's RetryBudget: the nested per-call retry loop that used
        to run here multiplied with chain()'s into retry² dials per
        frame — now both draw from one budget in _chain_sync."""
        if self._sock is None:
            self._sock = self._connect()
        return self._sock

    def _retry_policy(self) -> "_rp.RetryPolicy":
        """Backoff from the current props (full jitter — reconnecting
        clients decorrelate instead of re-arriving in waves)."""
        return _rp.RetryPolicy(base_s=float(self.retry_base_s),
                               max_s=float(self.retry_max_s))

    def start(self) -> None:
        self._caps_out_sent = False
        self._reader_error = None
        self._draining = False
        if self.fallback and self._fallback_el is None \
                and self.fallback != "passthrough":
            self._build_fallback()
        if self.backends and self._router is None:
            self._build_router()

    def _build_router(self) -> None:
        from . import router as _router_mod

        eps = _router_mod.parse_endpoints(self.backends)
        bset = _router_mod.BackendSet(
            eps, owner=self.name, timeout_s=float(self.timeout_s),
            breaker_threshold=int(self.breaker_threshold),
            breaker_reset_s=float(self.breaker_reset_s))
        self._router = _router_mod.QueryRouter(
            bset, name=self.name,
            max_request_retry=int(self.max_request_retry),
            hedge_ms=float(self.hedge_ms or 0.0),
            retry_policy=self._retry_policy())
        ref = weakref.ref(self)
        self._router.set_caps_provider(
            lambda: (lambda c: str(c.sink_pad.caps or "")
                     if c is not None else "")(ref()))

    @property
    def router(self):
        """The live QueryRouter in routed mode (None otherwise) — the
        handle for live backend add/remove/drain."""
        return self._router

    def set_default_device(self, device: Any) -> None:
        self._default_device = device

    def _build_fallback(self) -> None:
        """Materialize the ``fallback=`` property: a callable becomes a
        local tensor_filter wrapping it, a string names a registered
        element kind. Its output feeds a tap that forwards out of this
        client's src pad."""
        fb = self.fallback
        if callable(fb):
            el = make_element("tensor_filter", f"{self.name}.fallback",
                              model=fb)
        else:
            el = make_element(str(fb).strip(), f"{self.name}.fallback")
        if not el.sink_pads or not el.src_pads:
            raise ValueError(
                f"fallback element {fb!r} must have sink and src pads")
        if self._default_device is not None:
            el.set_default_device(self._default_device)
        tap = _FallbackTap(self)
        el.src_pads[0].link(tap.sink_pads[0])
        el.bus = tap.bus = self.bus
        el.start()
        self._fallback_el, self._fallback_tap = el, tap
        caps = self.sink_pad.caps
        if caps is not None:
            el.on_caps(el.sink_pads[0], caps)

    def stop(self) -> None:
        if self._router is not None:
            self._router.close()
            self._router = None
        if self._sock is not None:
            try:
                # shutdown (not just close) unblocks a reader thread
                # parked in recv; bare close can leave it hanging
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        r = self._reader
        if r is not None and r is not threading.current_thread():
            join_or_warn(r, self.name)
        self._reader = None
        with self._cv:
            self._pending.clear()
            self._cv.notify_all()

    # -- negotiation --------------------------------------------------------- #
    def on_caps(self, pad: Pad, caps: Caps) -> None:
        pad.caps = caps
        if self._fallback_el is not None:
            # the local fallback negotiates the same input the remote
            # path would have seen
            self._fallback_el.on_caps(self._fallback_el.sink_pads[0], caps)
        # result stream is shape-dynamic from the client's viewpoint: declare
        # flexible; static caps could be fetched from the server in future
        self.send_caps_all(Caps.tensors(format=TensorFormat.FLEXIBLE))

    # -- pipelined dataflow --------------------------------------------------- #
    def _reader_loop(self, sock: socket.socket) -> None:
        try:
            while True:
                cmd, rmeta, rpayload = recv_message(sock)
                if cmd is Cmd.PONG:
                    with self._cv:
                        self._pong = True
                        self._cv.notify_all()
                    continue
                if cmd is Cmd.ERROR:
                    raise QueryProtocolError(rmeta.get("error", "server error"))
                if cmd is not Cmd.RESULT:
                    raise QueryProtocolError(f"unexpected reply {cmd}")
                with self._cv:
                    if not self._pending:
                        raise QueryProtocolError("unsolicited RESULT")
                    pts, duration, offset = self._pending[0][:3]
                    span, root = self._pending[0][5], self._pending[0][6]
                out = payload_to_buffer(rmeta, rpayload)
                out.pts, out.duration, out.offset = pts, duration, offset
                if span.recording:
                    # downstream elements keep tracing inside this
                    # request's trace (the result is its continuation)
                    out.meta[_tracing.CTX_META_KEY] = span.context
                    if root is not None:
                        out.meta[_tracing.ROOT_META_KEY] = root
                self.push(out)
                with self._cv:
                    # pop only AFTER the push: an EOS drain waiting on the
                    # window must not race past a result still mid-push
                    done = self._pending.popleft()
                    self._cv.notify_all()
                done[5].end()
                self._m_rtt.observe(time.monotonic() - done[4])
        except (ConnectionError, OSError, QueryProtocolError) as e:
            with self._cv:
                # SENT frames (send_message returned) are lost; entries
                # still mid-send are NOT counted — their chain call owns
                # them: either its send raises (it pops and retries) or
                # its send "succeeded" into a dead connection, which it
                # detects via _reader_dead after flipping the sent flag
                # (closing the silent-loss window either way)
                self._reader_dead = True
                lost = sum(1 for entry in self._pending if entry[3])
                if lost > 0 or not isinstance(e, OSError):
                    self._reader_error = e
                    self.post_error(f"query reader failed with "
                                    f"{lost} in flight: {e}", exc=e)
                    self._pending.clear()
                self._cv.notify_all()

    def _remove_entry(self, entry) -> None:
        """Remove a pending record by IDENTITY (value equality would
        delete a different in-flight frame with equal pts/dur/offset —
        e.g. two untimestamped frames); no-op if the reader's error path
        already cleared the deque."""
        for i, e in enumerate(self._pending):
            if e is entry:
                del self._pending[i]
                return

    def _reset_conn(self) -> None:
        """Drop the connection + reader so the next attempt dials fresh.
        Only safe with nothing in flight. stop() joins the old reader
        BEFORE the state reset — an unjoined reader could wake later and
        misread the new connection's pending window."""
        _events.record("query.reconnect",
                       f"{self.name}: dropping connection for redial",
                       element=self.name)
        self.stop()
        self._reader_error = None

    def _probe_idle_conn(self, sock: socket.socket) -> bool:
        """PING/PONG a reused idle connection. A peer that died while we
        were idle is only detectable by traffic — without this, the first
        frame after an idle gap would be entrusted to a dead socket and
        lost to an async RST."""
        with self._cv:
            self._pong = False
        try:
            send_message(sock, Cmd.PING, {})
        except OSError:
            return False
        deadline = time.monotonic() + min(self.timeout_s, 5.0)
        with self._cv:
            while not self._pong and self._reader_error is None \
                    and self._reader is not None \
                    and self._reader.is_alive() \
                    and time.monotonic() < deadline:
                self._cv.wait(0.1)
            return self._pong

    def _chain_pipelined(self, buf: Buffer, depth: int) -> FlowReturn:
        meta, payload = buffer_to_payload(buf, sparse=bool(self.sparse))
        dl = _rp.deadline_of(buf)
        retry = self._retry_policy()
        # per-request span: submit → result popped by the reader (ended
        # there); NOOP when tracing is off, so every span touch below
        # is a no-op method on a shared singleton
        rspan = _tracing.start_span(
            "query.request",
            parent=buf.meta.get(_tracing.CTX_META_KEY),
            attrs={"element": self.name, "pipelined": True})
        for attempt in range(max(int(self.max_request_retry), 1)):
            if dl is not None and dl.expired():
                rspan.end()
                return self._shed(buf, f"deadline expired after "
                                       f"{attempt} attempt(s)")
            with self._cv:
                if self._reader_error is not None:
                    return FlowReturn.ERROR  # in-flight loss, on the bus
                idle = not self._pending
                reader_dead = self._reader is not None \
                    and not self._reader.is_alive()
            if reader_dead:
                if not idle:
                    self.post_error("query reader died with frames queued")
                    return FlowReturn.ERROR
                self._reset_conn()  # clean close between streams: redial
            if self._sock is None:
                try:
                    # single dial per outer attempt (same no-multiply
                    # rule the sync path now gets from its RetryBudget)
                    self._sock = self._connect()
                    self._breaker.record_success()
                except (ConnectionError, OSError):
                    self._breaker.record_failure()
                    retry.sleep(attempt)
                    continue
            sock = self._sock
            fresh = self._reader is None
            if fresh:
                self._reader_dead = False
                # the reader blocks in recv indefinitely (stop() unblocks
                # it via shutdown); the connect timeout must NOT ride
                # along or a >timeout_s gap between results (e.g. a
                # server-side graph capture) would kill the stream
                sock.settimeout(None)
                self._reader = threading.Thread(
                    target=self._reader_loop, args=(sock,), daemon=True,
                    name=f"qclient-reader:{self.name}")
                self._reader.start()
            stale = (idle and not fresh and
                     time.monotonic() - self._last_activity
                     > float(self.idle_probe_s))
            if stale and not self._probe_idle_conn(sock):
                self._reset_conn()
                continue  # dead idle connection: retry on a fresh one
            with self._cv:
                while len(self._pending) >= depth \
                        and self._reader_error is None:
                    self._cv.wait(0.1)
                if self._reader_error is not None:
                    return FlowReturn.ERROR
                # 5th field: submit stamp for the round-trip histogram;
                # 6th/7th: the request span the reader thread will close
                # and the trace root it re-stamps onto the result buffer
                entry = [buf.pts, buf.duration, buf.offset, False,
                         time.monotonic(), rspan,
                         buf.meta.get(_tracing.ROOT_META_KEY)]
                self._pending.append(entry)
            try:
                self._maybe_push_obs(sock)
                if dl is not None:
                    # wire form is REMAINING ms, re-anchored on the
                    # server's own clock — recomputed per attempt so
                    # retries don't resurrect spent budget
                    meta[_rp.WIRE_KEY] = dl.to_wire()
                if rspan.recording:
                    # current-context window around the send so the wire
                    # meta carries this request's context to the server
                    tok = _tracing._set_current(rspan.context)
                    try:
                        send_message(sock, Cmd.DATA, meta, payload)
                    finally:
                        _tracing._reset_current(tok)
                else:
                    send_message(sock, Cmd.DATA, meta, payload)
                with self._cv:
                    entry[3] = True  # on the wire: reader owns its fate
                    if self._reader_error is not None or self._reader_dead:
                        # the connection died around this send and the
                        # reader could not have counted this entry (it
                        # was unsent when the reader examined pending):
                        # report the possible loss here instead of
                        # silently returning OK
                        if self._reader_error is None:
                            self.post_error(
                                "query connection lost with a frame "
                                "just handed to the transport")
                        self._remove_entry(entry)
                        return FlowReturn.ERROR
                self._last_activity = time.monotonic()
                return FlowReturn.OK
            except OSError:
                with self._cv:
                    self._remove_entry(entry)  # never went out
                    others = bool(self._pending)
                if others or self._reader_error is not None:
                    # sent frames are (or already were) reported lost
                    if self._reader_error is None:
                        self.post_error(
                            "query send failed with frames in flight")
                    return FlowReturn.ERROR
                self._reset_conn()  # nothing else at risk: retry fresh
        rspan.end()
        if self.fallback:
            return self._route_fallback(buf, "request failed after retries")
        self._hc.set_status(_health.Status.FAILED,
                            "request failed after retries")
        self.post_error("query: request failed after retries")
        return FlowReturn.ERROR

    def _drain_pending(self, timeout: Optional[float] = None) -> None:
        if timeout is None:
            timeout = float(self.drain_timeout_s)
        dl = self._last_deadline
        if dl is not None:
            # results for past-deadline requests are worthless; don't
            # out-wait the work's own budget
            timeout = min(timeout, max(dl.remaining_s(), 0.0))
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._pending and self._reader_error is None \
                    and time.monotonic() < deadline:
                self._cv.wait(0.2)
            abandoned = len(self._pending)
        if abandoned and self._reader_error is None:
            log.warning("%s: EOS drain gave up with %d result(s) still "
                        "pending after %.1fs", self.name, abandoned, timeout)
            _events.record("query.drain_abandoned",
                           f"{self.name}: EOS drain gave up with "
                           f"{abandoned} result(s) pending",
                           severity="warning", element=self.name,
                           pending=abandoned)

    def on_eos(self) -> None:
        # all in-flight results must be pushed before EOS propagates.
        # The drain window is strictly read-only on connection state:
        # no dialing (see _connect) and, in routed mode, no membership
        # growth — a backend added mid-drain could never owe results.
        self._draining = True
        if self._router is not None:
            self._router.draining = True
        try:
            self._drain_pending()
        finally:
            self._draining = False

    # -- degraded paths -------------------------------------------------------- #
    def _maybe_push_obs(self, sock: socket.socket) -> None:
        """Piggyback one fleet ``OBS_PUSH`` frame ahead of a DATA send
        when the push interval has elapsed (obs/fleet.py). Fleet off →
        one module-global None check, zero wire bytes. Sent raw (no
        tracing wrap, no reply expected) on the caller's socket and
        thread, so it can never interleave with a request frame."""
        frame = _fleet.wire_frame_due()
        if frame is not None:
            pmeta, ppayload = frame
            sock.sendall(pack_message(Cmd.OBS_PUSH, pmeta, ppayload))

    def _shed(self, buf: Buffer, why: str) -> FlowReturn:
        """Drop a past-deadline buffer (the graph's legal drop: return
        OK without pushing) — sending it would spend wire and server
        time on a result nobody can use."""
        self._hc.count("shed")
        _rp.record_shed("query", f"{self.name}: shed buffer ({why})",
                        element=self.name)
        return FlowReturn.OK

    def _route_fallback(self, buf: Buffer, why: str) -> FlowReturn:
        """Degraded mode: hand the buffer to the local fallback element
        (or pass it through) instead of the dead remote path. Health
        goes DEGRADED — visibly impaired, not failed: /healthz stays
        200 and the pipeline keeps flowing."""
        self._fb_active = True
        self._hc.set_status(_health.Status.DEGRADED,
                            f"fallback active: {why}")
        _rp.record_fallback(self.name, f"{self.name}: {why} — buffer "
                                       f"routed to local fallback",
                            reason=why)
        el = self._fallback_el
        if el is None:  # passthrough
            return self.push(buf)
        ret = el._chain_entry(el.sink_pads[0], buf)
        return ret if ret is not None else FlowReturn.OK

    def _remote_restored(self) -> None:
        """A remote round trip succeeded after fallback traffic: the
        breaker probe closed the circuit, so un-degrade."""
        self._fb_active = False
        self._hc.set_status(_health.Status.OK, "remote path restored")
        _events.record("query.remote_restored",
                       f"{self.name}: remote path restored after fallback",
                       element=self.name)

    # -- dataflow ------------------------------------------------------------- #
    def chain(self, pad: Pad, buf: Buffer) -> Optional[FlowReturn]:
        # deadline: adopt upstream's, or stamp this element's budget
        dl = _rp.deadline_of(buf)
        if dl is None and float(self.deadline_ms or 0) > 0:
            dl = _rp.Deadline.after_ms(float(self.deadline_ms))
            _rp.set_deadline(buf, dl)
        if dl is not None:
            self._last_deadline = dl
            if dl.expired():
                return self._shed(buf, "deadline expired before send")
        # routed mode: per-backend breakers + placement live in the
        # router; disabled cost is this one is-None check
        if self._router is not None:
            return self._chain_routed(buf, dl)
        # breaker gate — only with a fallback to route to (without one,
        # refusing to try would just fail faster than trying)
        if self.fallback and not self._breaker.allow():
            return self._route_fallback(buf, "breaker open")
        depth = int(self.async_depth or 1)
        if depth > 1:
            return self._chain_pipelined(buf, depth)
        return self._chain_sync(buf, dl)

    def _chain_routed(self, buf: Buffer,
                      dl: Optional["_rp.Deadline"]) -> Optional[FlowReturn]:
        from .router import RouterError, _ShedSignal

        meta, payload = buffer_to_payload(buf, sparse=bool(self.sparse))
        sess = buf.meta.get("session")
        if sess is not None:
            # affinity key rides the wire so the serving side can pin
            # KV/prefix reuse; the router hashes it for placement
            meta["session"] = str(sess)
        try:
            rmeta, rpayload = self._router.dispatch(
                meta, payload, deadline=dl,
                session=str(sess) if sess is not None else None)
        except _ShedSignal:
            return self._shed(buf, "deadline expired in router")
        except RouterError as e:
            if self.fallback:
                return self._route_fallback(buf, f"all backends down: {e}")
            self._hc.set_status(_health.Status.FAILED,
                                f"all backends down: {e}")
            _events.record("query.connect_failed",
                           f"{self.name}: all backends down: {e}",
                           severity="error", element=self.name)
            raise ConnectionError(
                "tensor_query_client: request failed on every backend")
        self._hc.beat()
        if self._fb_active:
            self._remote_restored()
        out = payload_to_buffer(rmeta, rpayload)
        out.pts, out.duration, out.offset = buf.pts, buf.duration, buf.offset
        ctx = buf.meta.get(_tracing.CTX_META_KEY)
        if ctx is not None:
            out.meta[_tracing.CTX_META_KEY] = ctx
            root = buf.meta.get(_tracing.ROOT_META_KEY)
            if root is not None:
                out.meta[_tracing.ROOT_META_KEY] = root
        return self.push(out)

    def _chain_sync(self, buf: Buffer,
                    dl: Optional["_rp.Deadline"]) -> Optional[FlowReturn]:
        meta, payload = buffer_to_payload(buf, sparse=bool(self.sparse))
        # ONE retry budget for the whole request: connect dials and
        # request resends draw from the same max_request_retry pool
        # (previously chain x _ensure_conn multiplied into retry² dials)
        budget = _rp.RetryBudget(self.max_request_retry, site="query")
        retry = self._retry_policy()
        last: Optional[Exception] = None
        # one span per offload round trip: covers the wire send, the
        # server-side remote-parented spans, and the result receive —
        # NOOP (flag check only) when tracing is off
        with _tracing.start_span(
                "query.request",
                parent=buf.meta.get(_tracing.CTX_META_KEY),
                attrs={"element": self.name}) as rspan:
            while budget.take():
                if dl is not None and dl.expired():
                    return self._shed(
                        buf, f"deadline expired after {budget.used - 1} "
                             f"attempt(s)")
                try:
                    sock = self._ensure_conn()
                    self._maybe_push_obs(sock)
                    if dl is not None:
                        # wire form is REMAINING ms (re-anchored on the
                        # server's clock); recomputed per attempt so a
                        # retry doesn't resurrect spent budget
                        meta[_rp.WIRE_KEY] = dl.to_wire()
                    t_send = time.monotonic()
                    send_message(sock, Cmd.DATA, meta, payload)
                    cmd, rmeta, rpayload = recv_message(sock)
                    if cmd is Cmd.ERROR:
                        raise QueryProtocolError(
                            rmeta.get("error", "server error"))
                    if cmd is not Cmd.RESULT:
                        raise QueryProtocolError(f"unexpected reply {cmd}")
                    self._m_rtt.observe(time.monotonic() - t_send)
                    self._breaker.record_success()
                    if self._fb_active:
                        self._remote_restored()
                    out = payload_to_buffer(rmeta, rpayload)
                    out.pts, out.duration, out.offset = \
                        buf.pts, buf.duration, buf.offset
                    if rspan.recording:
                        out.meta[_tracing.CTX_META_KEY] = rspan.context
                        root = buf.meta.get(_tracing.ROOT_META_KEY)
                        if root is not None:
                            # the result buffer continues the request's
                            # trace; the sink must still close its root
                            out.meta[_tracing.ROOT_META_KEY] = root
                    return self.push(out)
                except (ConnectionError, OSError, QueryProtocolError) as e:
                    last = e
                    self._breaker.record_failure()
                    log.warning("query attempt %d/%d failed: %s",
                                budget.used, budget.attempts, e)
                    self.stop()  # drop connection, retry fresh
                    if not budget.exhausted:
                        retry.sleep(budget.used - 1)
        if self.fallback:
            return self._route_fallback(
                buf, f"request failed after retries: {last}")
        self._hc.set_status(_health.Status.FAILED,
                            f"request failed after retries: {last}")
        _events.record("query.connect_failed",
                       f"{self.name}: request failed after retries: {last}",
                       severity="error", element=self.name)
        raise ConnectionError("tensor_query_client: request failed after retries")
