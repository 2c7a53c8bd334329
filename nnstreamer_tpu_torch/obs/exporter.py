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

The routes of the layers the port has not reached yet answer as the JAX
exporter answers with those layers off: ``/debug/slo``, ``/debug/quality``,
``/debug/tune``, ``/debug/fleet/actions``, ``/debug/fleet/checkpoints`` and
``/debug/bundles`` with their "off" bodies, ``/debug/fleet``,
``/debug/bundles/<id>`` and ``POST /fleet/push`` with 503 (this process is
never a fleet aggregator, and diag is off). ``/debug/diag/critpath``
analyses spans even with diag off in the JAX package, which needs diag's
code: here it answers 404 naming ROADMAP §A7. ``/metrics``, ``/healthz``
and ``/readyz`` serve this process alone (no fleet rollup).

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
from . import health as _health
from . import metrics as _metrics
from . import profile as _profile
from . import tracing as _tracing

__all__ = ["MetricsExporter", "start_exporter", "build_info"]

#: Prometheus text exposition content type (format 0.0.4)
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

#: the JAX exporter's push-body bound (obs/fleet.py MAX_PUSH_BYTES)
MAX_PUSH_BYTES = 8 << 20


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

            # -- routes ------------------------------------------------ #
            def _get_metrics(self, query):
                self._reply(200, CONTENT_TYPE,
                            reg.exposition().encode("utf-8"))

            def _get_healthz(self, query):
                snap = _health.snapshot()
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
                })

            def _get_readyz(self, query):
                ready, conds = _health.readiness()
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

            # -- the unported layers, answering as the JAX exporter does
            #    with them off (ROADMAP §A7 slo/diag/quality/tune, §A9
            #    fleet) ------------------------------------------------- #
            def _get_fleet(self, query):
                self._json(503, {"error": "fleet aggregation is off "
                                 "(enable with --obs-aggregate)"})

            def _get_fleet_actions(self, query):
                self._json(200, {"enabled": False, "local": None,
                                 "fleet": None})

            def _get_fleet_checkpoints(self, query):
                self._json(200, {"local": None, "fleet": None})

            def _get_slo(self, query):
                self._json(200, {"enabled": False, "tenants": {}})

            def _get_quality(self, query):
                self._json(200, {"enabled": False, "taps": {}})

            def _get_tune(self, query):
                self._json(200, {"enabled": False, "local": None,
                                 "fleet": None})

            def _get_bundles(self, query):
                self._json(200, {"diag_enabled": False, "bundles": [],
                                 "triggers": None, "fleet": None})

            def _get_bundle(self, bid, query):
                self._json(503, {"error": "diag is off (enable "
                                 "with --diag or NNSTPU_DIAG=1)"})

            def _get_diag_critpath(self, query):
                self._reply(404, "text/plain", (
                    "/debug/diag/critpath waits for the port of obs/diag "
                    "(ROADMAP §A7)").encode("utf-8"))

            def _post_fleet_push(self, query):
                try:
                    n = int(self.headers.get("Content-Length") or 0)
                except ValueError:
                    n = -1
                if n < 0 or n > MAX_PUSH_BYTES:
                    self._json(413, {"error": "push body too large"})
                    return
                self.rfile.read(n)
                self._json(503, {"error": "this process is not a "
                                 "fleet aggregator (--obs-aggregate)"})

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
