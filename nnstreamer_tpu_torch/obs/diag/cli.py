"""``nns-diag-torch`` — offline debug-bundle reader.

Port of nnstreamer_tpu/obs/diag/cli.py. Loads a bundle captured by either
package's ``obs.diag`` (the two write the same format; no live
process needed), prints the critical-path waterfall for the implicated
requests — re-running the exact integer-ns sweep over the bundle's raw
spans, so the offline numbers match what the live endpoint reported —
and optionally emits a Perfetto/Chrome trace of just those requests.

    nns-diag-torch .nnstpu-diag                 # list bundles in a directory
    nns-diag-torch <bundle.json>                # cause + waterfalls
    nns-diag-torch <bundle.json> --trace <tid>  # one request only
    nns-diag-torch <bundle.json> --perfetto out.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

from . import bundle as _bundle
from . import critpath as _critpath


class _SpanView:
    """Duck-typed stand-in for obs.tracing.Span over a bundle's raw
    span docs — exactly the surface the critpath sweep touches."""

    __slots__ = ("name", "context", "start_ns", "end_ns", "attrs", "wall")

    class _Ctx:
        __slots__ = ("trace_id", "span_id", "parent_id")

        def __init__(self, tid: str, sid: str, par: Optional[str]):
            self.trace_id = tid
            self.span_id = sid
            self.parent_id = par

    def __init__(self, doc: Dict[str, Any]) -> None:
        self.name = str(doc["name"])
        self.context = self._Ctx(str(doc["trace_id"]),
                                 str(doc["span_id"]),
                                 doc.get("parent_id") or None)
        self.start_ns = int(doc["start_ns"])
        self.end_ns = int(doc["end_ns"])
        self.attrs = dict(doc.get("attrs") or {})
        self.wall = float(doc.get("wall") or 0.0)


def _trace_spans(doc: Dict[str, Any]) -> Dict[str, List[_SpanView]]:
    """trace_id -> span views, from the bundle's slowest-N capture."""
    traces = (doc.get("traces") or {}).get("slowest") or []
    out: Dict[str, List[_SpanView]] = {}
    for tr in traces:
        views = []
        for s in tr.get("spans") or []:
            try:
                views.append(_SpanView(s))
            except (KeyError, TypeError, ValueError):
                continue
        if views:
            out[str(tr["trace_id"])] = views
    return out


def _perfetto(traces: Dict[str, List[_SpanView]]) -> Dict[str, Any]:
    """Chrome trace_event JSON of just the implicated requests: one
    process lane per trace, spans as complete ('X') events in µs,
    colored by critical-path segment via the category field."""
    events: List[Dict[str, Any]] = []
    t0 = min((s.start_ns for views in traces.values() for s in views),
             default=0)
    for pid, (tid, views) in enumerate(sorted(traces.items()), start=1):
        events.append({"ph": "M", "pid": pid, "name": "process_name",
                       "args": {"name": f"trace {tid}"}})
        for s in views:
            events.append({
                "ph": "X", "pid": pid, "tid": 1,
                "name": s.name,
                "cat": _critpath.segment_of(s.name, s.attrs),
                "ts": (s.start_ns - t0) / 1e3,
                "dur": (s.end_ns - s.start_ns) / 1e3,
                "args": s.attrs,
            })
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"generator": "nns-diag"}}


def _print_header(doc: Dict[str, Any], out) -> None:
    cause = doc.get("cause") or {}
    build = doc.get("build") or {}
    when = doc.get("wall")
    print(f"bundle {doc.get('id', '?')}", file=out)
    print(f"  cause: {cause.get('kind', 'manual')}"
          f"[{cause.get('key', '')}] {cause.get('detail') or ''}",
          file=out)
    if when:
        print("  captured: "
              + time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(when)),
              file=out)
    if doc.get("instance"):
        print(f"  instance: {doc['instance']}", file=out)
    if isinstance(build, dict) and build.get("version"):
        # a bundle of either package: the port's build names torch
        fw = "torch" if "torch" in build else "jax"
        print(f"  build: {build.get('version')} "
              f"({fw} {build.get(fw, '?')}, "
              f"device {build.get('device_kind', '?')})", file=out)


def _list_dir(directory: str, out) -> int:
    store = _bundle.BundleStore(directory)
    entries = store.list()
    if not entries:
        print(f"no bundles in {directory}", file=out)
        return 1
    for e in entries:
        cause = e.get("cause") or {}
        print(f"{e['id']:<48} {cause.get('kind', '?'):<18} "
              f"{e.get('bytes', 0):>9}B", file=out)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="nns-diag-torch",
        description="inspect nnstreamer_tpu debug bundles offline "
        "(the torch port's or the JAX package's)")
    ap.add_argument("target",
                    help="bundle .json file, or a bundle directory to list")
    ap.add_argument("--trace", metavar="TID", default=None,
                    help="restrict to one trace id")
    ap.add_argument("--perfetto", metavar="PATH", default=None,
                    help="write a Perfetto/Chrome trace of the "
                    "implicated requests")
    ap.add_argument("--max-traces", type=int, default=8,
                    help="waterfalls to print (default 8)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable critpath output")
    args = ap.parse_args(argv)
    out = sys.stdout

    if os.path.isdir(args.target):
        return _list_dir(args.target, out)
    try:
        doc = _bundle.load_bundle(args.target)
    except (OSError, ValueError) as e:
        print(f"nns-diag: {e}", file=sys.stderr)
        return 2

    traces = _trace_spans(doc)
    if args.trace is not None:
        traces = {k: v for k, v in traces.items() if k == args.trace}
        if not traces:
            print(f"nns-diag: trace {args.trace!r} not in bundle",
                  file=sys.stderr)
            return 2

    results = []
    for tid, views in traces.items():
        res = _critpath.analyze(views)
        if res is not None:
            results.append(res)
    results.sort(key=lambda r: r["total_ns"], reverse=True)
    results = results[:max(args.max_traces, 0)]

    if args.json:
        json.dump({"id": doc.get("id"), "cause": doc.get("cause"),
                   "critpath": results}, out, indent=2, default=str)
        print(file=out)
    else:
        _print_header(doc, out)
        if not results:
            print("  (no analyzable traces in bundle)", file=out)
        for res in results:
            print(file=out)
            print(_critpath.waterfall(res), file=out)

    if args.perfetto:
        keep = {r["trace_id"] for r in results}
        doc_pf = _perfetto({k: v for k, v in traces.items() if k in keep})
        with open(args.perfetto, "w") as f:
            json.dump(doc_pf, f)
        print(f"wrote {args.perfetto} "
              f"({len(doc_pf['traceEvents'])} events)", file=out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
