"""HTTP exposition endpoint: ``/metrics`` + ``/healthz`` + ``/readyz`` +
``/debug``, stdlib only.

Port of nnstreamer_tpu/obs/exporter.py. A daemon-threaded ``http.server``
serving the process-global (or a given) ``MetricsRegistry`` in Prometheus
text format — the scrape target a deployment points its collector at — plus
the health and debug surfaces:

  * ``GET /healthz``                 — liveness: aggregate component status
    from obs/health.py; 200 while ok/degraded, 503 on stalled/failing
    (always 200 "ok" while health is off)
  * ``GET /readyz``                  — readiness: 200 once every registered
    condition (pipeline PLAYING, engine warmed) holds; 503 otherwise (200
    while health is off)
  * ``GET /debug/traces``            — JSON trace summaries, slowest first;
    ``?min_ms=<float>`` keeps only completed traces at least that slow
  * ``GET /debug/traces/<trace_id>`` — the full span tree of one trace
  * ``GET /debug/pipeline``          — live pipeline topology plus
    per-element span stats
  * ``GET /debug/events``            — the flight-recorder event ring
    (obs/events.py), oldest first; ``?n=<int>`` keeps the newest N
  * ``GET /debug/profile``           — Chrome trace_event / Perfetto JSON
    timeline (obs/profile.py)
  * ``GET /debug/profile/samples``   — the profiler's aggregated cost
    samples (the ``dump_samples()`` JSON shape)
  * ``GET /debug``                   — the debug index: every route in the
    dispatch table, as JSON
  * ``GET /debug/version``           — build identity: package version,
    torch version, the CUDA card's name, python (also exported as the
    ``nnstpu_build_info`` gauge)

  * ``GET /debug/slo``               — per-tenant cost attribution,
    goodput, objectives and burn rates (obs/slo.py)
  * ``GET /debug/quality``           — data-plane quality telemetry
    (obs/quality): per-tap tensor stats, drift scores, confidence
    aggregates and anomaly verdicts
  * ``GET /debug/tune``              — the autotuner's store and stats
  * ``GET /debug/diag/critpath``     — per-tenant critical-path latency
    attribution (obs/diag); works from tracing alone, richer when the
    diag engine is enabled; ``?min_ms=<float>`` filters traces
  * ``GET /debug/bundles``           — incident debug bundles captured by
    the diag trigger engine (newest first) plus trigger stats
  * ``GET /debug/bundles/<id>``      — one full bundle document; 503
    while diag is off

The fleet routes (obs/fleet.py, fleet/):

  * ``GET /debug/fleet``             — per-instance fleet state when this
    process aggregates; 503 otherwise
  * ``GET /debug/fleet/actions``     — the fleet controller's action
    journal, plus the fleet rollup when aggregating
  * ``GET /debug/fleet/checkpoints`` — the local checkpoint daemon's
    session watermarks (fleet/checkpoint.py) plus, when aggregating, every
    instance's pushed watermarks and the tombstoned instances whose
    checkpoints still await a restore
  * ``POST /fleet/push``             — snapshot-push ingestion for workers
    without a query wire; 503 unless aggregating

When fleet aggregation is enabled (``--obs-aggregate``), ``/metrics``
serves the merged fleet exposition (every instance's series with
``instance``/``role`` labels) and ``/healthz`` / ``/readyz`` the
worst-of-fleet rollups, checked per request; ``/debug/slo``,
``/debug/quality``, ``/debug/tune`` and ``/debug/bundles`` add the fleet
rollup.

All routes — GET and POST — live in ONE ``(method, path)`` dispatch table;
the 404 hint is derived from it.

    from nnstreamer_tpu_torch.obs import start_exporter
    exp = start_exporter(port=9464)   # also enables collection
    ...
    exp.close()

``port=0`` binds an ephemeral port (tests); the bound port is on
``exp.port`` and the full scrape URL on ``exp.url``. No handler makes a
CUDA call: gauges read host mirrors, so scraping never stalls or breaks a
capture on another thread.
"""

from __future__ import annotations

import errno
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs

from . import events as _events
from . import fleet as _fleet
from . import health as _health
from . import metrics as _metrics
from . import profile as _profile
from . import slo as _slo
from . import tracing as _tracing

__all__ = ["MetricsExporter", "start_exporter", "build_info"]

#: Prometheus text exposition content type (format 0.0.4)
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_BUILD_INFO: Optional[dict] = None


def build_info() -> dict:
    """Code-identity snapshot: package version, torch version, the CUDA
    card's name, python. Served at ``/debug/version`` and exposed as the
    ``nnstpu_build_info`` gauge. Failure-tolerant (no card: "cpu"). Read
    once, on the thread that starts the exporter, so the serving thread
    never asks the card anything."""
    global _BUILD_INFO
    if _BUILD_INFO is None:
        _BUILD_INFO = _read_build_info()
    return dict(_BUILD_INFO)


def _read_build_info() -> dict:
    import platform

    from .. import __version__

    try:
        import torch

        torch_version = str(torch.__version__)
        device_kind = (torch.cuda.get_device_name(0)
                       if torch.cuda.is_available() else "cpu")
    except Exception:
        torch_version = "unavailable"
        device_kind = "unknown"
    return {
        "version": __version__,
        "torch": torch_version,
        "device_kind": device_kind,
        "python": platform.python_version(),
    }


_BUILD_INFO_PUBLISHED = False


def _publish_build_info() -> None:
    """Register the constant-1 ``nnstpu_build_info`` gauge (Prometheus
    build-info idiom: the identity lives in the labels). Deferred to
    exporter start, so no import asks for the card."""
    global _BUILD_INFO_PUBLISHED
    if _BUILD_INFO_PUBLISHED:
        return
    _BUILD_INFO_PUBLISHED = True
    info = build_info()
    _metrics.registry().gauge(
        "nnstpu_build_info",
        "Build identity: constant 1; version/torch/device_kind labels "
        "carry the information",
        ("version", "torch", "device_kind"),
    ).labels(info["version"], info["torch"], info["device_kind"]).set(1.0)


class MetricsExporter:
    """Serves ``registry.exposition()`` at ``/metrics``, the health model
    at ``/healthz`` + ``/readyz``, and the debug surfaces, from a daemon
    thread."""

    def __init__(self, port: int = 9464, host: str = "127.0.0.1",
                 registry: Optional[_metrics.MetricsRegistry] = None):
        reg = registry if registry is not None else _metrics.registry()

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
                self._dispatch("GET")

            def do_POST(self):  # noqa: N802 — BaseHTTPRequestHandler API
                self._dispatch("POST")

            def _dispatch(self, method):
                """One (method, path) table serves every verb."""
                path, _, query = self.path.partition("?")
                handler = self._ROUTES.get((method, path))
                if handler is not None:
                    handler(self, query)
                    return
                for (m, prefix), ph in self._PREFIX_ROUTES:
                    if m == method and path.startswith(prefix):
                        ph(self, path[len(prefix):], query)
                        return
                self._reply(404, "text/plain", self._HINT)

            def _read_body(self):
                """Size-checked request body for POST handlers; replies
                413 and returns None when over MAX_PUSH_BYTES."""
                try:
                    n = int(self.headers.get("Content-Length") or 0)
                except ValueError:
                    n = -1
                if n < 0 or n > _fleet.MAX_PUSH_BYTES:
                    self._json(413, {"error": "push body too large"})
                    return None
                return self.rfile.read(n)

            # -- routes ------------------------------------------------ #
            # /metrics, /healthz, /readyz consult the fleet aggregator per
            # request: the process becomes (or stops being) the fleet
            # scrape target without an exporter restart
            def _get_metrics(self, query):
                agg = _fleet.aggregator()
                text = reg.exposition() if agg is None \
                    else agg.exposition(reg)
                self._reply(200, CONTENT_TYPE, text.encode("utf-8"))

            def _get_healthz(self, query):
                snap = _health.snapshot()
                agg = _fleet.aggregator()
                if agg is not None:
                    snap = agg.health_rollup(snap)
                # liveness: degraded still serves traffic; a stalled or
                # failing component flips the scrape to 503
                self._json(200 if snap["ok"] else 503, {
                    "status": snap["status"],
                    "health_enabled": _health.enabled(),
                    "metrics_enabled": reg.is_enabled,
                    "tracing_enabled": _tracing.enabled(),
                    "events_enabled": _events.enabled(),
                    "families": len(reg.names()),
                    "components": snap["components"],
                    **({"fleet": snap["fleet"]} if "fleet" in snap else {}),
                })

            def _get_readyz(self, query):
                ready, conds = _health.readiness()
                agg = _fleet.aggregator()
                if agg is not None:
                    ready, conds = agg.ready_rollup(ready, conds)
                self._json(200 if ready else 503, {
                    "ready": ready,
                    "health_enabled": _health.enabled(),
                    "conditions": conds,
                })

            def _get_traces(self, query):
                try:
                    min_ms = float(
                        parse_qs(query).get("min_ms", ["0"])[0])
                except ValueError:
                    self._reply(400, "text/plain",
                                b"min_ms must be a number")
                    return
                self._json(200, {
                    "tracing_enabled": _tracing.enabled(),
                    "traces": _tracing.store().summaries(min_ms),
                })

            def _get_trace(self, tid, query):
                tree = _tracing.store().tree(tid)
                if tree is None:
                    self._json(404, {"error": f"unknown trace {tid!r}"})
                else:
                    self._json(200, tree)

            def _get_pipeline(self, query):
                self._json(200, {
                    "pipelines": [_tracing.pipeline_topology(p)
                                  for p in _tracing.live_pipelines()],
                    "element_spans": _tracing.element_stats(),
                })

            def _get_events(self, query):
                try:
                    n = int(parse_qs(query).get("n", ["-1"])[0])
                except ValueError:
                    self._reply(400, "text/plain", b"n must be an int")
                    return
                ring = _events.ring()
                self._json(200, {
                    "events_enabled": _events.enabled(),
                    "dropped": ring.dropped,
                    "events": ring.snapshot(n if n >= 0 else None),
                })

            def _get_profile(self, query):
                # always 200: a valid (possibly sparse) trace with the
                # enable flags in otherData beats a 503 the viewer
                # cannot load
                self._json(200, _profile.perfetto_trace(
                    span_store=_tracing.store()))

            def _get_profile_samples(self, query):
                self._json(200, {
                    "version": 1,
                    "profile_enabled": _profile.enabled(),
                    "samples": _profile.samples(),
                })

            def _get_debug_index(self, query):
                # derived from the dispatch table, like the 404 hint
                self._json(200, {
                    "routes": sorted(
                        f"{m} {p}" for m, p in self._ROUTES),
                    "prefix_routes": sorted(
                        f"{m} {p}<id>"
                        for (m, p), _ in self._PREFIX_ROUTES),
                })

            def _get_version(self, query):
                self._json(200, build_info())

            def _get_slo(self, query):
                snap = _slo.snapshot()
                agg = _fleet.aggregator()
                if agg is not None:
                    snap = {**snap, "fleet": agg.slo_rollup(
                        snap if snap.get("enabled") else None)}
                self._json(200, snap)

            def _get_quality(self, query):
                from . import quality as _quality

                snap = _quality.snapshot()
                agg = _fleet.aggregator()
                if agg is not None:
                    snap = {**snap, "fleet": agg.quality_rollup()}
                self._json(200, snap)

            def _get_tune(self, query):
                from .. import tune as _tune

                agg = _fleet.aggregator()
                self._json(200, {
                    "enabled": _tune.enabled(),
                    "local": _tune.snapshot(),
                    "fleet": agg.tuned_view() if agg is not None
                    else None,
                })

            def _get_diag_critpath(self, query):
                # critpath is pure span-store analysis: it answers with
                # tracing alone even when the full diag engine (bundle
                # capture) is off
                from . import diag as _diag

                try:
                    min_ms = float(
                        parse_qs(query).get("min_ms", ["0"])[0])
                except ValueError:
                    self._reply(400, "text/plain",
                                b"min_ms must be a number")
                    return
                eng = _diag.DIAG_HOOK
                if eng is not None:
                    self._json(200, {"diag_enabled": True,
                                     **eng.critpath(min_ms)})
                else:
                    self._json(200, {
                        "diag_enabled": False,
                        "tracing_enabled": _tracing.enabled(),
                        **_diag.rollup(_tracing.store(), min_ms=min_ms),
                    })

            def _get_bundles(self, query):
                from . import diag as _diag

                eng = _diag.DIAG_HOOK
                agg = _fleet.aggregator()
                self._json(200, {
                    "diag_enabled": eng is not None,
                    "bundles": eng.bundles.list() if eng is not None
                    else [],
                    "triggers": dict(eng.triggers.stats)
                    if eng is not None else None,
                    "fleet": agg.diag_rollup() if agg is not None
                    else None,
                })

            def _get_bundle(self, bid, query):
                from . import diag as _diag

                eng = _diag.DIAG_HOOK
                if eng is None:
                    self._json(503, {"error": "diag is off (enable "
                                     "with --diag or NNSTPU_DIAG=1)"})
                    return
                doc = eng.bundles.get(bid)
                if doc is None:
                    self._json(404, {"error": f"unknown bundle {bid!r}"})
                else:
                    self._json(200, doc)

            # -- the fleet layer's routes ------------------------------ #
            def _get_fleet(self, query):
                agg = _fleet.aggregator()
                if agg is None:
                    self._json(503, {"error": "fleet aggregation is off "
                                     "(enable with --obs-aggregate)"})
                else:
                    self._json(200, agg.snapshot())

            def _get_fleet_actions(self, query):
                # module-level _fleet is obs.fleet; the controller
                # package resolves lazily like _get_tune's import
                from .. import fleet as _fleetpkg

                agg = _fleet.aggregator()
                self._json(200, {
                    "enabled": _fleetpkg.enabled(),
                    "local": _fleetpkg.snapshot(),
                    "fleet": agg.actions_rollup() if agg is not None
                    else None,
                })

            def _get_fleet_checkpoints(self, query):
                # local watermarks ride the same hook the push doc reads;
                # the rollup needs this process to aggregate
                hook = _fleet.CHECKPOINT_HOOK
                agg = _fleet.aggregator()
                self._json(200, {
                    "local": None if hook is None else hook(),
                    "fleet": agg.checkpoints_rollup() if agg is not None
                    else None,
                })

            def _post_fleet_push(self, query):
                body = self._read_body()
                if body is None:
                    return
                agg = _fleet.aggregator()
                if agg is None:
                    self._json(503, {"error": "this process is not a "
                                     "fleet aggregator (--obs-aggregate)"})
                    return
                try:
                    agg.ingest(json.loads(body or b"{}"), via="http")
                except (TypeError, ValueError) as e:
                    self._json(400, {"error": str(e)})
                    return
                # the ack carries the fleet's merged tuned configs so a
                # worker's very first push makes it warm (tune/ adopts
                # through obs/fleet.py TUNE_ADOPT_HOOK); None while no
                # instance has pushed tune data
                self._json(200, {"ok": True, "tune": agg.tuned_view()})

            #: THE route table — GET and POST share it, and the 404 hint
            #: below derives from it
            _ROUTES = {
                ("GET", "/metrics"): _get_metrics,
                ("GET", "/healthz"): _get_healthz,
                ("GET", "/readyz"): _get_readyz,
                ("GET", "/debug/traces"): _get_traces,
                ("GET", "/debug/pipeline"): _get_pipeline,
                ("GET", "/debug/events"): _get_events,
                ("GET", "/debug/fleet"): _get_fleet,
                ("GET", "/debug/fleet/actions"): _get_fleet_actions,
                ("GET", "/debug/fleet/checkpoints"): _get_fleet_checkpoints,
                ("GET", "/debug/profile"): _get_profile,
                ("GET", "/debug/profile/samples"): _get_profile_samples,
                ("GET", "/debug/slo"): _get_slo,
                ("GET", "/debug/quality"): _get_quality,
                ("GET", "/debug"): _get_debug_index,
                ("GET", "/debug/tune"): _get_tune,
                ("GET", "/debug/diag/critpath"): _get_diag_critpath,
                ("GET", "/debug/bundles"): _get_bundles,
                ("GET", "/debug/version"): _get_version,
                ("POST", "/fleet/push"): _post_fleet_push,
            }
            _PREFIX_ROUTES = (
                (("GET", "/debug/traces/"), _get_trace),
                (("GET", "/debug/bundles/"), _get_bundle),
            )
            _HINT = ("not found (try " + ", ".join(sorted(
                [p if m == "GET" else f"{m} {p}" for m, p in _ROUTES]
                + [(p if m == "GET" else f"{m} {p}") + "<id>"
                   for (m, p), _ in _PREFIX_ROUTES]))
                + ")").encode("utf-8")

            def _json(self, code, obj):
                # default=str: span attrs are caller-provided (numpy
                # scalars, enums, ...) — render, never 500 a debug page
                self._reply(code, "application/json",
                            json.dumps(obj, default=str).encode("utf-8"))

            def _reply(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # scrape spam stays off stderr
                pass

        self.registry = reg
        _publish_build_info()
        try:
            self._server = ThreadingHTTPServer((host, int(port)), Handler)
        except OSError as e:
            if e.errno == errno.EADDRINUSE:
                raise RuntimeError(
                    f"metrics exporter: port {port} on {host} is already "
                    f"in use — pick a free port with --metrics-port (or "
                    f"port=0 for an ephemeral one)") from e
            raise
        self._server.daemon_threads = True
        self.host = host
        self.port = self._server.server_address[1]
        self._closed = False
        self._close_lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name=f"metrics-exporter:{self.port}")
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self) -> None:
        """Stop serving, join the thread, release the socket. Idempotent.
        The listening socket is closed only after the serve loop has been
        joined, so the port is free the moment close() returns."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        self._server.shutdown()
        self._thread.join(timeout=5)
        self._server.server_close()

    def __enter__(self) -> "MetricsExporter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def start_exporter(port: int = 9464, host: str = "127.0.0.1",
                   registry: Optional[_metrics.MetricsRegistry] = None,
                   enable: bool = True) -> MetricsExporter:
    """Start the endpoint; by default also enables collection (a scrape
    target serving a disabled registry would be all zeros)."""
    if enable:
        (registry if registry is not None else _metrics.registry()).enable()
    return MetricsExporter(port=port, host=host, registry=registry)
