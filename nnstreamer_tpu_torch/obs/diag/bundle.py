"""Debug bundles: one bounded JSON file of *evidence* per incident.

Port of nnstreamer_tpu/obs/diag/bundle.py.

A bundle freezes what the bounded obs rings would otherwise age out —
the slowest span trees (with raw integer-ns spans so the offline
critical-path sweep stays conservation-exact), the event ring, the
profiler's records and samples, sched occupancy/coalesce stats, the
routing view, the fleet action journal, the SLO burn state, and the
data-plane quality stats (per-tap tensor moments + anomaly verdicts,
when obs/quality is on) — plus the build info pinning the code that
produced it.

Collectors are plain callables assembled in :func:`default_collectors`
(lazy imports keep obs package cycles out); a collector that raises
contributes an ``{"error": ...}`` stanza instead of killing the
capture — a diag layer must degrade, never take evidence down with it.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional

BUNDLE_VERSION = 1

_ID_SAFE = re.compile(r"[^a-zA-Z0-9_.-]+")


def _span_to_doc(span: Any) -> Dict[str, Any]:
    """Raw-span dict: integer monotonic ns endpoints so the offline
    critpath sweep reproduces the online one bit-for-bit."""
    return {
        "trace_id": span.context.trace_id,
        "span_id": span.context.span_id,
        "parent_id": span.context.parent_id,
        "name": span.name,
        "start_ns": span.start_ns,
        "end_ns": span.end_ns,
        "wall": span.wall,
        "attrs": span.attrs,
    }


def default_collectors() -> Dict[str, Callable[[], Any]]:
    """The standard evidence set. Keys become bundle stanzas."""
    from .. import events as _events
    from .. import health as _health
    from .. import profile as _profile
    from .. import slo as _slo
    from .. import tracing as _tracing

    def _sched() -> Any:
        from ... import sched as _sched_pkg

        eng = _sched_pkg.installed()
        if eng is None:
            return None
        return {
            "engine": eng.name,
            "pending": eng.pending(),
            "occupancy": eng.occupancy(),
            "busy_seconds": eng.busy_seconds,
            "wait_seconds": eng.wait_seconds,
            "coalesce": eng.coalesce_stats(),
            "stats": dict(eng.stats),
        }

    def _routing() -> Any:
        from ...query import router as _router

        return _router.routing_view()

    def _fleet_actions() -> Any:
        from ... import fleet as _fleet_pkg

        return _fleet_pkg.snapshot() if _fleet_pkg.enabled() else None

    def _events_snap() -> Any:
        ring = _events.ring()
        return {"dropped": ring.dropped, "events": ring.snapshot()}

    def _profile_snap() -> Any:
        return _profile.profiler().diag_snapshot()

    def _build() -> Any:
        from .. import exporter as _exporter

        return _exporter.build_info()

    def _quality_snap() -> Any:
        # raises when quality is off → degrades to an error stanza,
        # which is the documented "quality was not enabled" marker
        from .. import quality as _quality

        return _quality.bundle_data()

    return {
        "events": _events_snap,
        "profile": _profile_snap,
        "sched": _sched,
        "routing": _routing,
        "fleet_actions": _fleet_actions,
        "slo": _slo.snapshot,
        "health": _health.snapshot,
        "quality": _quality_snap,
        "build": _build,
        "_span_store": _tracing.store,  # consumed structurally below
    }


class BundleStore:
    """Disk-backed bounded bundle set: ``capture`` writes one JSON file
    per incident, oldest bundles are evicted past ``max_bundles``, and
    ``list``/``get``/``refs`` serve the HTTP and push-doc views."""

    def __init__(self, directory: str, *, max_bundles: int = 16,
                 slowest_traces: int = 8,
                 collectors: Optional[Dict[str, Callable[[], Any]]] = None
                 ) -> None:
        self.directory = str(directory)
        self.max_bundles = int(max_bundles)
        self.slowest_traces = int(slowest_traces)
        self._collectors = collectors
        self._lock = threading.Lock()
        self._seq = 0
        self.stats: Dict[str, int] = {"captured": 0, "evicted": 0,
                                      "collector_errors": 0}
        os.makedirs(self.directory, exist_ok=True)

    # -- capture -------------------------------------------------------- #
    def capture(self, cause: Dict[str, Any]) -> Optional[str]:
        """Assemble + persist one bundle; returns its id (None only
        when the write itself failed — collectors degrade per-stanza)."""
        collectors = self._collectors or default_collectors()
        store = None
        doc: Dict[str, Any] = {
            "v": BUNDLE_VERSION,
            "cause": dict(cause),
            "wall": time.time(),
            "mono_ns": time.monotonic_ns(),
            "instance": os.environ.get("NNSTPU_INSTANCE") or None,
        }
        for key, fn in collectors.items():
            if key == "_span_store":
                store = fn()
                continue
            try:
                doc[key] = fn()
            except Exception as e:  # evidence degrades, never raises
                self.stats["collector_errors"] += 1
                doc[key] = {"error": f"{type(e).__name__}: {e}"}
        doc["traces"] = self._collect_traces(store)
        doc["critpath"] = self._collect_critpath(store)

        with self._lock:
            self._seq += 1
            kind = _ID_SAFE.sub("-", str(cause.get("kind", "manual")))
            key = _ID_SAFE.sub("-", str(cause.get("key", "")))[:48]
            bundle_id = f"{int(doc['wall'])}-{self._seq:03d}-{kind}" + (
                f"-{key}" if key else "")
            doc["id"] = bundle_id
            path = os.path.join(self.directory, bundle_id + ".json")
            try:
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(doc, f, default=str)
                os.replace(tmp, path)
            except OSError:
                return None
            self.stats["captured"] += 1
            self._evict_locked()
        return bundle_id

    def _collect_traces(self, store: Any) -> Optional[Dict[str, Any]]:
        if store is None:
            return None
        try:
            summaries = store.summaries()
            slowest = []
            for summ in summaries[:self.slowest_traces]:
                spans = store.spans_of(summ["trace_id"]) or []
                slowest.append({
                    "trace_id": summ["trace_id"],
                    "root": summ["root"],
                    "duration_ms": summ["duration_ms"],
                    "spans": [_span_to_doc(s) for s in spans
                              if s.end_ns is not None],
                })
            return {"summaries": summaries[:64], "slowest": slowest}
        except Exception as e:
            self.stats["collector_errors"] += 1
            return {"error": f"{type(e).__name__}: {e}"}

    def _collect_critpath(self, store: Any) -> Optional[Dict[str, Any]]:
        if store is None:
            return None
        try:
            from . import critpath as _critpath

            return _critpath.rollup(store)
        except Exception as e:
            self.stats["collector_errors"] += 1
            return {"error": f"{type(e).__name__}: {e}"}

    def _evict_locked(self) -> None:
        paths = self._paths()
        while len(paths) > self.max_bundles:
            victim = paths.pop(0)  # oldest name sorts first (wall.seq)
            try:
                os.remove(victim)
                self.stats["evicted"] += 1
            except OSError:
                break

    # -- queries -------------------------------------------------------- #
    def _paths(self) -> List[str]:
        try:
            names = sorted(n for n in os.listdir(self.directory)
                           if n.endswith(".json"))
        except OSError:
            return []
        return [os.path.join(self.directory, n) for n in names]

    def list(self) -> List[Dict[str, Any]]:
        """Newest-first light listing for ``GET /debug/bundles``."""
        out = []
        for path in reversed(self._paths()):
            entry: Dict[str, Any] = {
                "id": os.path.basename(path)[:-len(".json")],
                "bytes": 0,
            }
            try:
                entry["bytes"] = os.path.getsize(path)
                with open(path) as f:
                    head = json.load(f)
                entry["cause"] = head.get("cause")
                entry["wall"] = head.get("wall")
                entry["instance"] = head.get("instance")
            except (OSError, ValueError) as e:
                entry["error"] = str(e)
            out.append(entry)
        return out

    def get(self, bundle_id: str) -> Optional[Dict[str, Any]]:
        safe = _ID_SAFE.sub("", str(bundle_id))
        path = os.path.join(self.directory, safe + ".json")
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def refs(self) -> List[Dict[str, Any]]:
        """Minimal per-bundle references riding fleet push docs, so the
        aggregator can enumerate fleet-wide evidence for an incident."""
        return [{"id": e["id"], "cause": e.get("cause"),
                 "wall": e.get("wall")} for e in self.list()]


def load_bundle(path: str) -> Dict[str, Any]:
    """Offline loader for nns-diag: a bundle file OR a bundle id inside
    a directory."""
    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory; pass the bundle file")
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "v" not in doc:
        raise ValueError(f"{path} is not a debug bundle")
    return doc
