"""Live session migration — move a session's KV state between backends
with zero stream loss.

Port of nnstreamer_tpu/fleet/migrate.py (stdlib only).

The protocol, per session, is one control round trip plus one page
shipment over wires that already exist:

1. ``lm_ctl: {op: "export_session"}`` to the SOURCE backend: the worker
   freezes the session (new submits are refused, so the router's
   failover lands them on the target under the ORIGINAL deadline),
   exports the session's KV pages for its recorded token path
   (``LMEngine.export_session``), and ships them to the target over the
   existing ``Cmd.KV_PAGE_XFER`` op — the same op and splice path
   disagg's prefill→decode hand-off uses.
2. Re-pin the router's session affinity to the target
   (``BackendSet.pin_session``), so the next buffer dials the target
   directly instead of paying a lazy failover round trip.

Absorb path: if the source dies mid-migration (connection error, or
the page transfer itself fails), the pin still moves — the target
simply re-prefills the session's next prompt from scratch, exactly
disagg's reprefill semantics. The stream never dies; it only loses the
cache warmth the migration would have preserved. Greedy decoding is a
pure function of the token sequence, so outputs stay token-for-token
identical either way (the acceptance test pins this).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

from ..core.log import logger
from ..obs import events as _events
from ..obs import metrics as _obs
from ..obs import tracing as _tracing
from ..query.protocol import QueryProtocolError
from ..resilience import policy as _rp

log = logger("fleet")

#: capability string for the lm_ctl control op — the disagg LM wire
LM_CAPS = "disagg/lm"

_reg = _obs.registry()
_MIGRATED_TOTAL = _reg.counter(
    "nnstpu_fleet_migrated_sessions_total",
    "Sessions re-pinned off a draining backend", ("outcome",))
_MIGRATION_SECONDS = _reg.histogram(
    "nnstpu_fleet_migration_seconds",
    "Per-session migration wall time (export + ship + re-pin)")


class SessionMigrator:
    """Migrates sessions between a router's backends.

    Stateless apart from stats; every decision is driven by the caller
    (the controller picks victims and targets), so migrations are
    exactly as deterministic as the caller's schedule. ``clock`` is
    injectable for tests.
    """

    def __init__(self, router: Any, *,
                 timeout_s: float = 10.0,
                 caps: str = LM_CAPS,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.router = router
        self.timeout_s = float(timeout_s)
        self.caps = caps
        self._clock = clock
        self.stats: Dict[str, int] = {
            "migrated": 0, "absorbed": 0, "pages_moved": 0}

    def migrate(self, session: str, source: Any, target: Any,
                deadline: Optional[_rp.Deadline] = None) -> Dict[str, Any]:
        """Move ``session`` from ``source`` to ``target`` (Backend
        objects). Always re-pins; returns a result doc with ``ok``
        (export+ship landed) and ``absorbed`` (target must re-prefill).
        """
        dl = deadline or _rp.Deadline.after_s(self.timeout_s)
        _events.record("fleet.migrate_start",
                       f"session {session}: {source.endpoint} -> "
                       f"{target.endpoint}",
                       session=session, source=source.endpoint,
                       target=target.endpoint)
        span = _tracing.start_span(
            "fleet.migrate", parent=_tracing.current_context(),
            attrs={"session": session, "source": source.endpoint,
                   "target": target.endpoint})
        t0 = self._clock()
        pages, err = 0, None
        try:
            meta: Dict[str, Any] = {
                "lm_ctl": {"op": "export_session", "session": session,
                           "xfer_to": target.endpoint},
                _rp.WIRE_KEY: dl.to_wire(),
            }
            rmeta, _ = source.request(meta, b"", self.caps)
            pages = int(rmeta.get("pages_sent", 0) or 0)
            if rmeta.get("xfer_error"):
                err = str(rmeta["xfer_error"])
        except (ConnectionError, OSError, QueryProtocolError) as e:
            err = f"{type(e).__name__}: {e}"
        # the pin moves regardless — a dead source must not strand the
        # session on a backend that can no longer serve it
        self.router.backends.pin_session(session, target.endpoint)
        dt = self._clock() - t0
        absorbed = err is not None
        span.set_attribute("pages", pages)
        span.set_attribute("absorbed", absorbed)
        span.end()
        _MIGRATION_SECONDS.observe(dt)
        if absorbed:
            self.stats["absorbed"] += 1
            _MIGRATED_TOTAL.labels("absorbed").inc()
            _events.record("fleet.migrate_abandon",
                           f"session {session}: source export failed, "
                           f"target will re-prefill ({err})",
                           severity="warning", session=session,
                           source=source.endpoint, target=target.endpoint,
                           error=err)
            log.warning("migrate %s: absorb path (%s)", session, err)
        else:
            self.stats["migrated"] += 1
            self.stats["pages_moved"] += pages
            _MIGRATED_TOTAL.labels("migrated").inc()
            _events.record("fleet.migrate_done",
                           f"session {session}: {pages} pages to "
                           f"{target.endpoint} in {dt * 1e3:.1f}ms",
                           session=session, target=target.endpoint,
                           pages=pages, seconds=dt)
        return {"session": session, "ok": not absorbed,
                "absorbed": absorbed, "pages": pages,
                "seconds": dt, "error": err,
                "source": source.endpoint, "target": target.endpoint}
