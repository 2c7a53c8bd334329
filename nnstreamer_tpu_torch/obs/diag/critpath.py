"""Critical-path latency attribution over one request's span tree.

The contract is *conservation*: every nanosecond of the root span's
duration lands in exactly one segment, so the segment sums equal the
request's measured latency to the integer. The sweep therefore runs on
raw span timestamps (monotonic ns, incl. remote spans already rebased
by ``SpanStore.ingest_remote``), never on the microsecond floats the
``tree()`` view rounds to.

Attribution rule: split the root interval at every span boundary; each
elementary slice belongs to the *deepest* span covering it (ties: the
latest-starting one — the span that most recently took over the thread
of control). The covering span's name maps to a segment; names the
table doesn't know — and the root's own self-time — fall into
``host_other``, whose share defines the coverage ratio the bench lane
tracks.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

#: attribution buckets, waterfall order — where a request's wall-clock
#: latency can go (host_other is the unexplained residual)
SEGMENTS = ("admission_wait", "sched_wait", "device_compute", "wire",
            "kv_transfer", "migration", "re_prefill", "restore",
            "host_other")

#: span name -> segment. serving.prefill is handled specially (its
#: re_prefill/restore attrs promote it); anything absent here is
#: host_other.
_SEGMENT_BY_NAME = {
    "serving.admission_wait": "admission_wait",
    "diag.sched_wait": "sched_wait",
    "diag.sched_run": "device_compute",
    "serving.prefill": "device_compute",
    "serving.decode": "device_compute",
    "serving.compile": "device_compute",
    "device.xprof": "device_compute",
    "query.send": "wire",
    "query.recv": "wire",
    "disagg.xfer": "kv_transfer",
    "fleet.migrate": "migration",
}


def segment_of(name: str, attrs: Optional[Dict[str, Any]] = None) -> str:
    """Segment for one span; unknown names are host_other."""
    if name == "serving.prefill" and attrs:
        if attrs.get("restore"):
            # first prefill after a crash-restore checkpoint splice —
            # warm by construction; kept distinct from re_prefill so
            # the restore-vs-fallback attribution survives aggregation
            return "restore"
        if attrs.get("re_prefill"):
            return "re_prefill"
    return _SEGMENT_BY_NAME.get(name, "host_other")


def _root_of(spans: List[Any]) -> Optional[Any]:
    """The locally-rooted completed span (parent_id None); earliest
    start wins if a trace somehow holds several roots."""
    roots = [s for s in spans
             if s.context.parent_id is None and s.end_ns is not None]
    if not roots:
        return None
    return min(roots, key=lambda s: s.start_ns)


def analyze(spans: List[Any]) -> Optional[Dict[str, Any]]:
    """Exact segment attribution for one trace's raw spans.

    Returns None for an incomplete trace (no ended root). Otherwise a
    dict whose ``segments`` (ns ints) sum to ``total_ns`` exactly.
    """
    if not spans:
        return None
    root = _root_of(spans)
    if root is None:
        return None
    r0, r1 = root.start_ns, root.end_ns

    # depth via parent links; spans with an unrecorded parent (remote
    # half whose peer span never landed here) hang off the root
    by_id = {s.context.span_id: s for s in spans}
    depth_cache: Dict[str, int] = {root.context.span_id: 0}

    def depth(s: Any) -> int:
        sid = s.context.span_id
        hit = depth_cache.get(sid)
        if hit is not None:
            return hit
        chain = []
        cur = s
        while True:
            cid = cur.context.span_id
            if cid in depth_cache:
                d = depth_cache[cid]
                break
            chain.append(cid)
            parent = by_id.get(cur.context.parent_id or "")
            if parent is None or parent is cur:
                d = 0  # orphan: treated as a root-level child below
                break
            cur = parent
        for cid in reversed(chain):
            d += 1
            depth_cache[cid] = d
        return depth_cache[sid]

    # clip every ended span to the root interval; drop empty clips
    clipped: List[Tuple[int, int, int, int, Any]] = []  # (a, b, depth, seq, span)
    for seq, s in enumerate(spans):
        if s.end_ns is None:
            continue
        a, b = max(s.start_ns, r0), min(s.end_ns, r1)
        if b <= a and s is not root:
            continue
        clipped.append((a, b, depth(s), seq, s))

    bounds = sorted({p for a, b, _, _, _ in clipped for p in (a, b)}
                    | {r0, r1})
    segments = {seg: 0 for seg in SEGMENTS}
    by_span: Dict[str, int] = {}
    for lo, hi in zip(bounds, bounds[1:]):
        if hi <= lo or hi <= r0 or lo >= r1:
            continue
        winner = None
        for a, b, d, seq, s in clipped:
            if a <= lo and b >= hi:
                if winner is None or (d, a, seq) > winner[:3]:
                    winner = (d, a, seq, s)
        if winner is None:
            continue  # unreachable: the root always covers
        s = winner[3]
        seg = segment_of(s.name, s.attrs)
        segments[seg] += hi - lo
        by_span[s.name] = by_span.get(s.name, 0) + (hi - lo)

    total = r1 - r0
    covered = total - segments["host_other"]
    return {
        "trace_id": root.context.trace_id,
        "root": root.name,
        "tenant": _tenant_of(spans, root),
        "total_ns": total,
        "segments": segments,
        "coverage_ratio": (covered / total) if total > 0 else 1.0,
        "contributors": sorted(
            ({"name": n, "segment": segment_of(
                n, next((s.attrs for s in spans if s.name == n), None)),
              "ns": v} for n, v in by_span.items()),
            key=lambda c: c["ns"], reverse=True),
    }


def _tenant_of(spans: List[Any], root: Any) -> str:
    """Best-effort tenant identity: an explicit tenant attr anywhere in
    the tree, else the serving session, else the root's source."""
    for key in ("tenant", "session"):
        for s in spans:
            v = s.attrs.get(key)
            if v:
                return str(v)
    return str(root.attrs.get("source", "-"))


def rollup(store: Any, *, min_ms: float = 0.0,
           max_traces: int = 256) -> Dict[str, Any]:
    """Per-tenant "where does my P99 go" over the store's completed
    traces: aggregate segment shares plus the breakdown of each
    tenant's P99 (slowest-at-rank) request."""
    analyses: List[Dict[str, Any]] = []
    for summ in store.summaries(min_ms=min_ms)[:int(max_traces)]:
        if not summ["completed"]:
            continue
        spans = store.spans_of(summ["trace_id"])
        if not spans:
            continue
        res = analyze(spans)
        if res is not None:
            analyses.append(res)

    tenants: Dict[str, Dict[str, Any]] = {}
    for res in analyses:
        t = tenants.setdefault(res["tenant"], {
            "requests": 0, "total_ns": 0,
            "segments_ns": {seg: 0 for seg in SEGMENTS},
            "_durations": []})
        t["requests"] += 1
        t["total_ns"] += res["total_ns"]
        for seg, ns in res["segments"].items():
            t["segments_ns"][seg] += ns
        t["_durations"].append((res["total_ns"], res))

    for name, t in tenants.items():
        durs = sorted(t.pop("_durations"), key=lambda d: d[0])
        idx = min(len(durs) - 1, int(0.99 * len(durs)))
        p99_total, p99 = durs[idx]
        t["p99_ms"] = p99_total / 1e6
        t["p99_trace"] = {
            "trace_id": p99["trace_id"],
            "total_ms": p99["total_ns"] / 1e6,
            "segments_ms": {seg: ns / 1e6
                            for seg, ns in p99["segments"].items()},
        }
        t["segments_share"] = {
            seg: (ns / t["total_ns"] if t["total_ns"] else 0.0)
            for seg, ns in t["segments_ns"].items()}

    return {
        "traces_analyzed": len(analyses),
        "segments": list(SEGMENTS),
        "tenants": tenants,
    }


def waterfall(result: Dict[str, Any], width: int = 48) -> str:
    """Text waterfall for one ``analyze()`` result — the nns-diag
    rendering and the /debug/diag self-check view."""
    total = max(result["total_ns"], 1)
    lines = [f"trace {result['trace_id']}  root={result['root']}  "
             f"tenant={result['tenant']}  "
             f"total={result['total_ns'] / 1e6:.3f}ms",
             f"coverage={result['coverage_ratio'] * 100:.1f}%"]
    for seg in SEGMENTS:
        ns = result["segments"].get(seg, 0)
        bar = "#" * int(round(width * ns / total))
        lines.append(f"  {seg:<16}{ns / 1e6:>10.3f}ms "
                     f"{100.0 * ns / total:>5.1f}% |{bar}")
    check = sum(result["segments"].values())
    lines.append(f"  {'sum':<16}{check / 1e6:>10.3f}ms "
                 f"({'exact' if check == result['total_ns'] else 'DRIFT'})")
    return "\n".join(lines)
