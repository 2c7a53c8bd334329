"""The port's obs.fleet: every case of tests/test_fleet.py, run against
``nnstreamer_tpu_torch`` on the CPU — metric federation (merge, labels,
conflicts, expiry), remote span collection, the fleet health and
readiness rollup, the query-wire OBS_PUSH piggyback, concurrent scrapes
under a push storm, and the zero-overhead-when-disabled contract. Each case
runs under a timeout of its own (SIGALRM) and leaves no pusher, aggregator
or fleet hook behind.

The ``cuda`` cases (skipped without a card; this file imports no JAX) hold
the port's page handling on the card: an import on one thread then an
admission on another prefix-hits the pages and gives the tokens of a local
prefill; a daemon's checkpoint taken while the engine serves equals one
taken quiesced; an export → encode → decode → import round trip leaves the
pool pages bit-equal.
"""


import json
import re
import signal
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from nnstreamer_tpu_torch.graph import Pipeline
from nnstreamer_tpu_torch.obs import events as obs_events
from nnstreamer_tpu_torch.obs import fleet as obs_fleet
from nnstreamer_tpu_torch.obs import health as obs_health
from nnstreamer_tpu_torch.obs import metrics as obs_metrics
from nnstreamer_tpu_torch.obs import tracing as obs_tracing
from nnstreamer_tpu_torch.obs.exporter import start_exporter
from nnstreamer_tpu_torch.obs.fleet import (FleetAggregator, FleetPusher,
                                            build_push)
from nnstreamer_tpu_torch.obs.metrics import MetricsRegistry
from nnstreamer_tpu_torch.obs.tracing import SpanStore
from nnstreamer_tpu_torch.core import Caps, TensorsConfig, TensorsInfo


#: each case's own limit, seconds
CASE_TIMEOUT_S = 60


@pytest.fixture(autouse=True)
def _case_guard():
    """A timeout of the case's own (SIGALRM), and no chaos plan, fleet
    hook, pusher, aggregator, controller or import target left for the
    next case."""
    def expire(signum, frame):
        raise TimeoutError(f"case exceeded {CASE_TIMEOUT_S} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(CASE_TIMEOUT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
        from nnstreamer_tpu_torch import fleet as _fleet_pkg
        from nnstreamer_tpu_torch.obs import fleet as _obs_fleet
        from nnstreamer_tpu_torch.resilience import chaos as _chaos
        from nnstreamer_tpu_torch.serving import disagg as _disagg

        _fleet_pkg.disable()
        _obs_fleet.disable_push()
        _obs_fleet.disable_aggregator()
        _disagg.clear_import_target()
        _chaos.uninstall()



def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def caps_of(dims, types, rate=30):
    return Caps.tensors(
        TensorsConfig(TensorsInfo.from_strings(dims, types), rate))


@pytest.fixture
def events():
    ring = obs_events.ring()
    was = ring.is_enabled
    ring.reset()
    obs_events.enable()
    yield obs_events
    obs_events.disable()
    ring.reset()
    ring._enabled = was


@pytest.fixture
def fleet_off_after():
    """Whatever a test enables on the module globals, put it back."""
    tracing_was = obs_tracing.enabled()
    metrics_was = obs_metrics.enabled()
    yield obs_fleet
    obs_fleet.disable_push()
    obs_fleet.disable_aggregator()
    store = obs_tracing.store()
    store.set_export(False)
    store.reset()
    store._enabled = tracing_was
    (obs_metrics.enable if metrics_was else obs_metrics.disable)()


@pytest.fixture
def global_health():
    reg = obs_health.registry()
    was = reg.is_enabled
    reg.reset()
    yield obs_health
    reg.reset()
    reg._enabled = was


def worker_push(instance, seq=1, interval_s=2.0, counters=(), ready=True,
                status="ok", spans=(), role="worker"):
    """A synthetic worker's push document built through the real
    build_push path (private registries — no global state)."""
    reg = MetricsRegistry(enabled=True)
    for name, labels, value in counters:
        fam = reg.counter(name, "test", tuple(labels))
        (fam.labels(*labels.values()) if labels else fam).inc(value)
    doc = build_push(instance, role, seq, interval_s=interval_s,
                     registry=reg,
                     health_registry=obs_health.HealthRegistry(),
                     span_store=SpanStore())
    doc["ready"] = {"ready": ready, "conditions": {"up": ready}}
    doc["health"]["status"] = status
    doc["spans"] = list(spans)
    return doc


# --------------------------------------------------------------------------- #
# Prometheus text parser (test oracle)
# --------------------------------------------------------------------------- #

_SAMPLE_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>(?:[a-z_][a-z0-9_]*="(?:\\.|[^"\\])*",?)*)\})? '
    r'(?P<value>[0-9.eE+-]+|\+Inf|-Inf|NaN)$')


def parse_prom(text):
    """Strict 0.0.4 parse: returns {family: {"type", "help",
    "samples": [(name, labels_str, float)]}}; raises AssertionError on
    any malformed line, duplicated HELP/TYPE, or samples preceding
    their TYPE line."""
    fams = {}
    current = None
    for ln in text.splitlines():
        if not ln:
            continue
        if ln.startswith("# HELP "):
            name = ln.split(" ", 3)[2]
            assert name not in fams, f"duplicate HELP for {name}"
            fams[name] = {"type": None, "help": ln.split(" ", 3)[3],
                          "samples": []}
            current = name
        elif ln.startswith("# TYPE "):
            _, _, name, mtype = ln.split(" ", 3)
            fam = fams.setdefault(
                name, {"type": None, "help": "", "samples": []})
            assert fam["type"] is None, f"duplicate TYPE for {name}"
            fam["type"] = mtype
            current = name
        else:
            m = _SAMPLE_RE.match(ln)
            assert m, f"malformed sample line: {ln!r}"
            base = m.group("name")
            for suffix in ("_bucket", "_sum", "_count"):
                if base.endswith(suffix) and base[:-len(suffix)] in fams:
                    base = base[:-len(suffix)]
                    break
            assert current == base, f"sample {ln!r} outside its family"
            fams[base]["samples"].append(
                (m.group("name"), m.group("labels") or "",
                 float(m.group("value").replace("+Inf", "inf"))))
    return fams


def check_histograms_consistent(fams):
    """No torn histograms: per series, buckets cumulative
    non-decreasing and +Inf == _count."""
    for name, fam in fams.items():
        if fam["type"] != "histogram":
            continue
        series = {}
        for sname, labels, value in fam["samples"]:
            # (?<![a-z_]) keeps e.g. role="..." from matching as le="..."
            key = re.sub(r'(?<![a-z_])le="[^"]*",?', "",
                         labels).rstrip(",")
            entry = series.setdefault(key, {"buckets": [], "count": None})
            if sname.endswith("_bucket"):
                le = re.search(r'(?<![a-z_])le="([^"]*)"',
                               labels).group(1)
                entry["buckets"].append(
                    (float(le.replace("+Inf", "inf")), value))
            elif sname.endswith("_count"):
                entry["count"] = value
        for key, entry in series.items():
            entry["buckets"].sort()
            values = [v for _, v in entry["buckets"]]
            assert values == sorted(values), \
                f"{name}{{{key}}}: non-monotonic buckets {values}"
            assert entry["buckets"][-1][0] == float("inf")
            assert entry["buckets"][-1][1] == entry["count"], \
                f"{name}{{{key}}}: +Inf {entry['buckets'][-1][1]} " \
                f"!= count {entry['count']}"


# --------------------------------------------------------------------------- #
# Federation: merge + exposition
# --------------------------------------------------------------------------- #

class TestFederation:
    def test_merged_exposition_instance_labels(self):
        agg = FleetAggregator(span_store=SpanStore(), instance="agg:1")
        agg.ingest(worker_push(
            "w1:1", counters=[("nnstpu_query_messages_total",
                               {"direction": "sent"}, 3)]))
        agg.ingest(worker_push(
            "w2:1", counters=[("nnstpu_query_messages_total",
                               {"direction": "sent"}, 7)]))
        local = MetricsRegistry(enabled=True)
        local.counter("nnstpu_query_messages_total", "test",
                      ("direction",)).labels("recv").inc(10)
        text = agg.exposition(local)
        assert ('nnstpu_query_messages_total{direction="sent",'
                'instance="w1:1",role="worker"} 3') in text
        assert ('nnstpu_query_messages_total{direction="sent",'
                'instance="w2:1",role="worker"} 7') in text
        assert ('nnstpu_query_messages_total{direction="recv",'
                'instance="agg:1",role="aggregator"} 10') in text

    def test_help_type_once_per_family(self):
        """Satellite: HELP/TYPE exactly once per family even when the
        same family arrives from several instances — parse_prom raises
        on duplicates."""
        agg = FleetAggregator(span_store=SpanStore())
        for i in range(4):
            agg.ingest(worker_push(
                f"w{i}:1", counters=[("nnstpu_query_messages_total",
                                      {"direction": "sent"}, i)]))
        fams = parse_prom(agg.exposition(MetricsRegistry(enabled=True)))
        fam = fams["nnstpu_query_messages_total"]
        assert fam["type"] == "counter"
        assert len(fam["samples"]) == 4

    def test_histogram_merge_renders_buckets(self):
        reg = MetricsRegistry(enabled=True)
        h = reg.histogram("nnstpu_serving_ttft_seconds", "ttft",
                          buckets=(0.1, 1.0))
        h.observe(0.05)
        h.observe(0.5)
        h.observe(5.0)
        doc = build_push("w1:1", "worker", 1, registry=reg,
                         health_registry=obs_health.HealthRegistry(),
                         span_store=SpanStore())
        # JSON round-trip: bucket keys become strings, like a real push
        doc = json.loads(json.dumps(doc))
        agg = FleetAggregator(span_store=SpanStore())
        agg.ingest(doc)
        fams = parse_prom(agg.exposition(MetricsRegistry(enabled=True)))
        check_histograms_consistent(fams)
        fam = fams["nnstpu_serving_ttft_seconds"]
        values = {(n, l): v for n, l, v in fam["samples"]}
        assert values[("nnstpu_serving_ttft_seconds_bucket",
                       'instance="w1:1",role="worker",le="0.1"')] == 1
        assert values[("nnstpu_serving_ttft_seconds_bucket",
                       'instance="w1:1",role="worker",le="+Inf"')] == 3
        assert values[("nnstpu_serving_ttft_seconds_count",
                       'instance="w1:1",role="worker"')] == 3

    def test_label_values_escaped_in_merge(self):
        """Satellite: backslash/quote/newline in a pushed label value
        stay escaped through the aggregator."""
        agg = FleetAggregator(span_store=SpanStore())
        agg.ingest(worker_push(
            "w1:1", counters=[("nnstpu_query_messages_total",
                               {"cmd": 'we"ird\\x\n'}, 1)]))
        text = agg.exposition(MetricsRegistry(enabled=True))
        assert 'cmd="we\\"ird\\\\x\\n"' in text
        parse_prom(text)  # and the result still parses

    def test_type_conflict_skipped_and_journaled(self, events):
        agg = FleetAggregator(span_store=SpanStore())
        agg.ingest(worker_push(
            "w1:1", counters=[("nnstpu_query_messages_total", {}, 1)]))
        bad = worker_push("w2:1")
        bad["metrics"]["nnstpu_query_messages_total"] = {
            "type": "gauge", "help": "drifted",
            "series": [{"labels": {}, "value": 9}]}
        agg.ingest(bad)
        fams = parse_prom(agg.exposition(MetricsRegistry(enabled=True)))
        fam = fams["nnstpu_query_messages_total"]
        assert fam["type"] == "counter"
        # the conflicting instance's series is skipped, not mangled in
        assert all('instance="w2:1"' not in l for _, l, _ in fam["samples"])
        evs = [e for e in obs_events.ring().snapshot()
               if e["type"] == "fleet.merge_conflict"]
        assert len(evs) == 1
        assert evs[0]["attrs"]["instance"] == "w2:1"
        # deduped: the next scrape does not journal it again
        agg.exposition(MetricsRegistry(enabled=True))
        assert len([e for e in obs_events.ring().snapshot()
                    if e["type"] == "fleet.merge_conflict"]) == 1

    def test_cumulative_replacement_not_double_count(self):
        agg = FleetAggregator(span_store=SpanStore())
        for seq, total in ((1, 5), (2, 9)):
            agg.ingest(worker_push(
                "w1:1", seq=seq,
                counters=[("nnstpu_query_messages_total", {}, total)]))
        fams = parse_prom(agg.exposition(MetricsRegistry(enabled=True)))
        # latest cumulative snapshot wins — 9, not 14
        assert fams["nnstpu_query_messages_total"]["samples"][0][2] == 9

    def test_bad_push_rejected(self):
        agg = FleetAggregator(span_store=SpanStore())
        with pytest.raises(ValueError, match="instance"):
            agg.ingest({"v": 1})
        with pytest.raises(ValueError, match="version"):
            agg.ingest({"v": 99, "instance": "w"})
        assert agg.bad_pushes == 2

    def test_non_scalar_fields_raise_valueerror_no_ghost(self):
        """A push with non-scalar junk in a coerced field raises
        ValueError (never TypeError) and leaves NO half-mutated
        instance behind — a ghost would flip /readyz fleet-wide."""
        agg = FleetAggregator(span_store=SpanStore())
        for field, junk in (("seq", [1]), ("ts", {"t": 1}),
                            ("interval_s", ["0.1"])):
            doc = worker_push("w1:1")
            doc[field] = junk
            with pytest.raises(ValueError, match="malformed push field"):
                agg.ingest(doc)
        assert agg.bad_pushes == 3
        assert agg.snapshot()["instances"] == []
        assert agg.ready_rollup(True, {}) == (True, {})
        # a later bad push must not corrupt an existing record either
        agg.ingest(worker_push("w1:1", seq=3))
        doc = worker_push("w1:1", seq=9)
        doc["seq"] = [9]
        with pytest.raises(ValueError):
            agg.ingest(doc)
        assert agg.snapshot()["instances"][0]["seq"] == 3

    def test_ingest_wire_never_raises(self, fleet_off_after):
        """The wire handler's contract: any junk — undecodable JSON or
        a document whose fields are the wrong shape — is counted and
        journaled, never raised into the server connection loop."""
        obs_fleet.enable_aggregator(ttl_s=30.0)
        obs_fleet.ingest_wire({"instance": "w"}, b"not json")
        bad = worker_push("w1:1")
        bad["seq"] = [1]
        obs_fleet.ingest_wire({"instance": "w1:1"},
                              json.dumps(bad).encode())
        obs_fleet.ingest_wire({}, json.dumps(["not", "a", "dict"]).encode())
        agg = obs_fleet.aggregator()
        assert agg.snapshot()["instances"] == []
        assert agg.bad_pushes >= 2


# --------------------------------------------------------------------------- #
# Expiry + health/readiness rollup
# --------------------------------------------------------------------------- #

class TestFleetHealth:
    def test_stale_instance_flips_rollups_then_expires(self, events):
        agg = FleetAggregator(ttl_s=0.15, expire_after_s=0.6,
                              span_store=SpanStore())
        agg.ingest(worker_push("w1:1", ready=True))
        ready, conds = agg.ready_rollup(True, {})
        assert ready and conds["fleet:w1:1"]
        snap = agg.health_rollup({"status": "ok", "ok": True,
                                  "components": []})
        assert snap["status"] == "ok"
        time.sleep(0.2)  # past ttl, before expiry
        ready, conds = agg.ready_rollup(True, {})
        assert not ready and conds["fleet:w1:1"] is False
        snap = agg.health_rollup({"status": "ok", "ok": True,
                                  "components": []})
        assert snap["status"] == "stalled" and not snap["ok"]
        time.sleep(0.5)  # past expire_after
        assert agg.snapshot()["instances"] == []
        assert agg.ready_rollup(True, {}) == (True, {})
        evs = [e for e in obs_events.ring().snapshot()
               if e["type"] == "fleet.expire"]
        assert len(evs) == 1 and evs[0]["attrs"]["instance"] == "w1:1"

    def test_worst_of_fleet_status(self):
        agg = FleetAggregator(ttl_s=30.0, span_store=SpanStore())
        agg.ingest(worker_push("w1:1", status="ok"))
        agg.ingest(worker_push("w2:1", status="degraded"))
        snap = agg.health_rollup({"status": "ok", "ok": True,
                                  "components": []})
        assert snap["status"] == "degraded" and snap["ok"]
        agg.ingest(worker_push("w3:1", status="failing"))
        snap = agg.health_rollup({"status": "ok", "ok": True,
                                  "components": []})
        assert snap["status"] == "failing" and not snap["ok"]

    def test_not_ready_worker_blocks_fleet_readiness(self):
        agg = FleetAggregator(ttl_s=30.0, span_store=SpanStore())
        agg.ingest(worker_push("w1:1", ready=True))
        agg.ingest(worker_push("w2:1", ready=False))
        ready, conds = agg.ready_rollup(True, {"local": True})
        assert not ready
        assert conds == {"local": True, "fleet:w1:1": True,
                         "fleet:w2:1": False}

    def test_watchdog_missing_heartbeat_rule(self, events, global_health,
                                             fleet_off_after):
        """The kind="fleet" watchdog rule: a silent instance goes
        STALLED on check_now and recovers when pushes resume."""
        obs_health.enable()
        agg = obs_fleet.enable_aggregator(ttl_s=0.1)
        agg.ingest(worker_push("w1:1"))
        obs_health.check_now()
        comp = {c["name"]: c for c in
                obs_health.snapshot()["components"]}["fleet:w1:1"]
        assert comp["status"] == "ok"
        time.sleep(0.15)
        obs_health.check_now()
        comp = {c["name"]: c for c in
                obs_health.snapshot()["components"]}["fleet:w1:1"]
        assert comp["status"] == "stalled"
        assert "no push" in comp["detail"]
        assert any(e["type"] == "fleet.stall"
                   for e in obs_events.ring().snapshot())
        agg.ingest(worker_push("w1:1", seq=2))
        obs_health.check_now()
        comp = {c["name"]: c for c in
                obs_health.snapshot()["components"]}["fleet:w1:1"]
        assert comp["status"] == "ok"
        assert any(e["type"] == "fleet.recover"
                   for e in obs_events.ring().snapshot())

    def test_rollup_components_not_duplicated(self, global_health,
                                              fleet_off_after):
        """/healthz lists each instance once: the rollup's authoritative
        fleet:<iid> entry replaces the kind="fleet" watchdog component
        _register_health put in the local registry — even when the two
        would disagree (watchdog stalled vs rollup fresh)."""
        obs_health.enable()
        agg = obs_fleet.enable_aggregator(ttl_s=30.0)
        agg.ingest(worker_push("w1:1"))
        obs_health.check_now()
        local = obs_health.snapshot()
        # local registry does carry the watchdog component...
        assert [c["name"] for c in local["components"]] == ["fleet:w1:1"]
        # ...but force its status to disagree with the fresh rollup
        local["components"][0]["status"] = "stalled"
        snap = agg.health_rollup(local)
        fleet_comps = [c for c in snap["components"]
                       if c["name"] == "fleet:w1:1"]
        assert len(fleet_comps) == 1
        assert fleet_comps[0]["status"] == "ok"
        assert snap["status"] == "ok" and snap["ok"]

    def test_push_events_carry_instance(self, events):
        agg = FleetAggregator(span_store=SpanStore())
        agg.ingest(worker_push("w1:1"), via="wire")
        evs = [e for e in obs_events.ring().snapshot()
               if e["type"] == "fleet.push"]
        assert evs and evs[0]["attrs"]["instance"] == "w1:1"
        assert evs[0]["attrs"]["via"] == "wire"


# --------------------------------------------------------------------------- #
# Remote span collection
# --------------------------------------------------------------------------- #

class TestRemoteSpans:
    def _worker_spans(self):
        """A worker-side store: tracing on, export on, one marked trace
        with two spans."""
        store = SpanStore()
        store.enable()
        store.set_export(True)
        with store.start_span("query.request") as root:
            store.mark_export(root.context.trace_id)
            with store.start_span("serving.request",
                                  parent=root.context):
                pass
        return store, root.context.trace_id

    def test_drain_and_ingest_builds_cross_host_tree(self):
        wstore, tid = self._worker_spans()
        wire = wstore.drain_export()
        assert len(wire) == 2
        assert wstore.drain_export() == []  # drained
        astore = SpanStore()
        assert astore.ingest_remote(wire, "w1:1") == 2
        tree = astore.tree(tid)
        assert tree is not None and tree["spans"] == 2
        root = tree["tree"][0]
        assert root["name"] == "query.request"
        assert root["attrs"]["instance"] == "w1:1"
        assert [k["name"] for k in root["children"]] \
            == ["serving.request"]

    def test_failed_push_requeues_drained_spans(self):
        """push_now drains the export queue into the doc; a down
        aggregator must not lose that batch — it goes back to the FRONT
        so the next successful push carries it, oldest first."""
        wstore, tid = self._worker_spans()
        psh = FleetPusher(url="http://127.0.0.1:9", interval_s=3600,
                          instance="w1:1", span_store=wstore)
        try:
            assert psh.push_now() is False  # port 9: nothing listens
            requeued = wstore.drain_export()
            assert [s["tid"] for s in requeued] == [tid, tid]
            assert len(requeued) == 2
        finally:
            psh.close()

    def test_requeue_preserves_order_ahead_of_new_spans(self):
        store = SpanStore()
        store.enable()
        store.set_export(True)
        with store.start_span("query.request") as root:
            store.mark_export(root.context.trace_id)
        batch = store.drain_export()
        with store.start_span("serving.request",
                              parent=root.context):
            pass
        store.requeue_export(batch)
        names = [s["name"] for s in store.drain_export()]
        assert names == ["query.request", "serving.request"]

    def test_unmarked_traces_not_exported(self):
        store = SpanStore()
        store.enable()
        store.set_export(True)
        with store.start_span("query.request"):
            pass  # never marked
        assert store.drain_export() == []

    def test_export_off_is_free_and_clears(self):
        store = SpanStore()
        store.enable()
        with store.start_span("query.request") as s:
            store.mark_export(s.context.trace_id)  # no-op while off
        assert store.drain_export() == []
        assert store._export_on is False

    def test_remote_spans_rebased_into_local_clock_domain(self):
        """A trace holding both halves — the aggregator's own local
        (monotonic) spans plus ingested remote (wall-derived) spans —
        must render with one time base: offsets stay request-scale, not
        epoch-scale (~1.7e18 ns) garbage."""
        astore = SpanStore()
        astore.enable()
        with astore.start_span("query.server_handle") as local_span:
            tid = local_span.context.trace_id
        wire = [{"tid": tid, "sid": "remote01", "par": None,
                 "name": "query.request", "wall": time.time() - 0.01,
                 "dur_ns": int(20e6), "attrs": {}}]
        assert astore.ingest_remote(wire, "w1:1") == 1
        tree = astore.tree(tid)
        offsets = [n["start_us"] for n in tree["tree"]]
        # both roots within a minute of each other, not epoch-scale
        assert all(abs(o) < 60e6 for o in offsets), offsets
        tr = astore._traces[tid]
        assert abs(tr.end_ns - tr.start_ns) < int(60e9)

    def test_malformed_remote_spans_skipped(self):
        store = SpanStore()
        ok = {"tid": "t1", "sid": "s1", "par": None,
              "name": "query.request", "wall": 1e9, "dur_ns": 5,
              "attrs": {}}
        assert store.ingest_remote(
            [ok, {"bogus": 1}, "not a dict"], "w") == 1


# --------------------------------------------------------------------------- #
# End-to-end: two instances, one aggregator (ISSUE acceptance)
# --------------------------------------------------------------------------- #

class TestEndToEnd:
    def test_fleet_acceptance(self, events, fleet_off_after):
        """Faked-wire two-instance deployment: worker pushes over HTTP
        to the aggregator's exporter; /metrics shows both instances'
        counters, /debug/traces/<id> has spans from both sides of one
        request, and killing the worker flips /readyz within one
        watchdog interval."""
        agg = obs_fleet.enable_aggregator(ttl_s=0.3, expire_after_s=30.0)
        local_reg = MetricsRegistry(enabled=True)
        local_reg.counter("nnstpu_query_messages_total", "m",
                          ("direction",)).labels("recv").inc(2)
        # the aggregator's own half of the trace (adopted remote parent)
        astore = obs_tracing.store()
        astore.enable()
        with start_exporter(port=0, registry=local_reg) as exp:
            base = f"http://127.0.0.1:{exp.port}"

            # -- worker side (private registries = separate process) --
            wreg = MetricsRegistry(enabled=True)
            wreg.counter("nnstpu_query_messages_total", "m",
                         ("direction",)).labels("sent").inc(5)
            wstore = SpanStore()
            wstore.enable()
            wstore.set_export(True)
            whealth = obs_health.HealthRegistry()
            with wstore.start_span("query.request") as wroot:
                tid = wroot.context.trace_id
                wstore.mark_export(tid)
            # server half adopts the propagated context
            with astore.start_span(
                    "query.server_handle",
                    parent=obs_tracing.SpanContext(tid, "remote01")):
                pass

            def push(seq, ready=True):
                doc = build_push("worker:1", "worker", seq,
                                 interval_s=0.1, registry=wreg,
                                 health_registry=whealth,
                                 span_store=wstore)
                doc["ready"] = {"ready": ready, "conditions": {}}
                req = urllib.request.Request(
                    base + "/fleet/push",
                    data=json.dumps(doc).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=5) as r:
                    assert r.status == 200

            push(1)

            # -- /metrics: both instances, instance labels -----------
            with urllib.request.urlopen(base + "/metrics", timeout=5) as r:
                fams = parse_prom(r.read().decode())
            samples = fams["nnstpu_query_messages_total"]["samples"]
            by_labels = {l: v for _, l, v in samples}
            assert any('instance="worker:1"' in l and v == 5
                       for l, v in by_labels.items())
            assert any('role="aggregator"' in l and v == 2
                       for l, v in by_labels.items())

            # -- /debug/traces/<id>: spans from both sides -----------
            with urllib.request.urlopen(
                    base + f"/debug/traces/{tid}", timeout=5) as r:
                tree = json.loads(r.read())

            def flatten(nodes):
                for n in nodes:
                    yield n
                    yield from flatten(n["children"])

            names = {s["name"]: s for s in flatten(tree["tree"])}
            assert "query.request" in names          # worker side
            assert "query.server_handle" in names    # aggregator side
            assert names["query.request"]["attrs"]["instance"] \
                == "worker:1"

            # -- /debug/fleet ----------------------------------------
            with urllib.request.urlopen(
                    base + "/debug/fleet", timeout=5) as r:
                snap = json.loads(r.read())
            assert [i["instance"] for i in snap["instances"]] \
                == ["worker:1"]
            assert snap["instances"][0]["spans_ingested"] == 1

            # -- killing the worker flips /readyz within one ttl -----
            with urllib.request.urlopen(base + "/readyz", timeout=5) as r:
                assert json.loads(r.read())["ready"] is True
            time.sleep(0.4)  # one watchdog interval past ttl_s=0.3
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(base + "/readyz", timeout=5)
            assert ei.value.code == 503
            body = json.loads(ei.value.read())
            assert body["conditions"]["fleet:worker:1"] is False

    def test_wire_piggyback_real_pipelines(self, fleet_off_after):
        """OBS_PUSH frames ride a real client→server query connection:
        the server-side aggregator learns the client instance without
        any HTTP channel."""
        agg = obs_fleet.enable_aggregator(ttl_s=30.0)
        port = free_port()
        sp = Pipeline("server", device="cpu")
        ssrc = sp.add_new("tensor_query_serversrc", host="127.0.0.1",
                          port=port, id=0, dims="4:1", types="float32")
        filt = sp.add_new("tensor_filter", model=lambda x: x * 10)
        ssink = sp.add_new("tensor_query_serversink", id=0)
        Pipeline.link(ssrc, filt, ssink)
        sp.start()
        try:
            time.sleep(0.2)
            # wire-only pusher: interval 0 → every DATA send carries one
            psh = obs_fleet.enable_push(url=None, interval_s=0.0,
                                        instance="client:wire")
            assert psh._thread is None  # wire-only: no HTTP thread
            cp = Pipeline("client", device="cpu")
            src = cp.add_new("appsrc", caps=caps_of("4:1", "float32"),
                             data=[np.full((1, 4), i, np.float32)
                                   for i in range(3)])
            qc = cp.add_new("tensor_query_client", host="127.0.0.1",
                            port=port)
            sink = cp.add_new("tensor_sink", store=True)
            Pipeline.link(src, qc, sink)
            cp.run(timeout=60)
            assert sink.num_buffers == 3  # data flow unharmed
            insts = [i["instance"] for i in agg.snapshot()["instances"]]
            assert insts == ["client:wire"]
            rec = agg.snapshot()["instances"][0]
            assert rec["via"] == "wire" and rec["pushes"] >= 1
        finally:
            sp.stop()

    def test_http_pusher_thread_end_to_end(self, fleet_off_after):
        """The standalone HTTP pusher (non-query processes) reaches the
        aggregator's exporter and close() stops the thread."""
        obs_fleet.enable_aggregator(ttl_s=30.0)
        with start_exporter(port=0,
                            registry=MetricsRegistry(enabled=True)) as exp:
            psh = obs_fleet.enable_push(
                url=f"http://127.0.0.1:{exp.port}", interval_s=0.05,
                instance="pusher:http", role="serving")
            try:
                deadline = time.monotonic() + 5
                agg = obs_fleet.aggregator()
                while time.monotonic() < deadline:
                    if agg.snapshot()["instances"]:
                        break
                    time.sleep(0.02)
                recs = agg.snapshot()["instances"]
                assert [r["instance"] for r in recs] == ["pusher:http"]
                assert recs[0]["role"] == "serving"
                assert any(t.name.startswith("obs-fleet-push")
                           for t in threading.enumerate())
            finally:
                obs_fleet.disable_push()
            assert not any(t.name.startswith("obs-fleet-push")
                           for t in threading.enumerate())


# --------------------------------------------------------------------------- #
# Concurrent scrapes under a push storm (satellite)
# --------------------------------------------------------------------------- #

class TestConcurrency:
    def test_scrapes_parseable_under_push_storm(self, fleet_off_after):
        agg = obs_fleet.enable_aggregator(ttl_s=30.0)
        stop = threading.Event()
        errors = []

        def storm(wid):
            seq = 0
            while not stop.is_set():
                seq += 1
                reg = MetricsRegistry(enabled=True)
                h = reg.histogram("nnstpu_serving_ttft_seconds", "t",
                                  buckets=(0.1, 1.0))
                for i in range(seq % 7 + 1):
                    h.observe(0.05 * i)
                reg.counter("nnstpu_query_messages_total", "m",
                            ("direction",)).labels("sent").inc(seq)
                doc = build_push(f"w{wid}:1", "worker", seq,
                                 registry=reg,
                                 health_registry=obs_health.HealthRegistry(),
                                 span_store=SpanStore())
                try:
                    agg.ingest(json.loads(json.dumps(doc)))
                except Exception as e:  # noqa: BLE001
                    errors.append(e)
                    return

        threads = [threading.Thread(target=storm, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        local = MetricsRegistry(enabled=True)
        try:
            deadline = time.monotonic() + 2.0
            scrapes = 0
            while time.monotonic() < deadline:
                fams = parse_prom(agg.exposition(local))
                check_histograms_consistent(fams)
                scrapes += 1
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=10)
        assert not errors
        assert scrapes > 10

    def test_expiry_under_concurrent_ingest(self):
        """Lazy expiry racing ingest never corrupts the instance map."""
        agg = FleetAggregator(ttl_s=0.01, expire_after_s=0.02,
                              span_store=SpanStore())
        stop = threading.Event()

        def churn(wid):
            seq = 0
            while not stop.is_set():
                seq += 1
                agg.ingest(worker_push(f"w{wid}:1", seq=seq,
                                       interval_s=0.01))

        threads = [threading.Thread(target=churn, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        try:
            for _ in range(50):
                agg.snapshot()
                agg.exposition(MetricsRegistry(enabled=True))
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=10)
        time.sleep(0.1)
        assert agg.snapshot()["instances"] == []  # all expired clean


# --------------------------------------------------------------------------- #
# Zero-overhead contract (ISSUE acceptance)
# --------------------------------------------------------------------------- #

class TestZeroOverhead:
    def test_disabled_fast_paths(self):
        assert obs_fleet.pusher() is None
        assert not obs_fleet.push_enabled()
        # THE hot-path check the query client makes per send
        assert obs_fleet.wire_frame_due() is None
        assert obs_fleet.aggregator() is None
        # no fleet threads exist
        assert not any(t.name.startswith("obs-fleet-push")
                       for t in threading.enumerate())
        # span export costs one attribute read and is off
        assert obs_tracing.store()._export_on is False

    def test_no_extra_wire_bytes_when_disabled(self, fleet_off_after):
        """With fleet off, a query roundtrip sends zero OBS_PUSH frames
        (counted at the server's protocol layer via the shared message
        counter)."""
        def obs_push_msgs():
            snap = obs_metrics.registry().snapshot()
            series = snap.get("nnstpu_query_messages_total",
                              {"series": []})["series"]
            return sum(s["value"] for s in series
                       if s["labels"].get("cmd") == "OBS_PUSH")

        was = obs_metrics.enabled()
        obs_metrics.enable()
        before = obs_push_msgs()
        try:
            port = free_port()
            sp = Pipeline("server", device="cpu")
            ssrc = sp.add_new("tensor_query_serversrc", host="127.0.0.1",
                              port=port, id=0, dims="4:1",
                              types="float32")
            filt = sp.add_new("tensor_filter", model=lambda x: x + 1)
            ssink = sp.add_new("tensor_query_serversink", id=0)
            Pipeline.link(ssrc, filt, ssink)
            sp.start()
            try:
                time.sleep(0.2)
                cp = Pipeline("client", device="cpu")
                src = cp.add_new("appsrc", caps=caps_of("4:1", "float32"),
                                 data=[np.zeros((1, 4), np.float32)])
                qc = cp.add_new("tensor_query_client", host="127.0.0.1",
                                port=port)
                sink = cp.add_new("tensor_sink", store=True)
                Pipeline.link(src, qc, sink)
                cp.run(timeout=60)
                assert sink.num_buffers == 1
            finally:
                sp.stop()
            # the cumulative registry outlives other tests that DO push:
            # the contract is zero NEW frames during this disabled run
            assert obs_push_msgs() == before
        finally:
            (obs_metrics.enable if was else obs_metrics.disable)()

    def test_ingest_wire_noop_without_aggregator(self):
        # never raises, never allocates an aggregator
        obs_fleet.ingest_wire({"instance": "w"}, b"not json")
        assert obs_fleet.aggregator() is None

    def test_span_record_overhead_disabled(self):
        """_record with export off takes the single-flag branch: the
        pending queue stays untouched even for marked-looking ids."""
        store = SpanStore()
        store.enable()
        with store.start_span("query.request"):
            pass
        assert len(store._export_pending) == 0


class TestIngestNeverRaises:
    """Regression (nnslint contracts/never-raise): ingest_remote's
    docstring promises malformed entries are skipped, never raised —
    including exception types outside the originally enumerated
    (KeyError, TypeError, ValueError) narrow list."""

    def test_entry_raising_arbitrary_exception_is_skipped(self):
        class IndexableNoGet:
            # __getitem__ works, .get() does not -> AttributeError,
            # which the old narrow except list leaked to the caller
            def __getitem__(self, key):
                return {"tid": "t9", "sid": "s9",
                        "wall": 1e9, "dur_ns": 5}[key]

        store = SpanStore()
        ok = {"tid": "t9", "sid": "s1", "par": None,
              "name": "query.request", "wall": 1e9, "dur_ns": 5,
              "attrs": {}}
        assert store.ingest_remote([IndexableNoGet(), ok], "w") == 1


class TestPusherKvDigest:
    """FleetPusher kv-digest wiring: a per-pusher digest source wins;
    without one, build_push defers to the module KV_DIGEST_HOOK that
    serving/disagg.py installs when a worker starts."""

    def test_kv_digest_param_flows_into_doc(self):
        psh = FleetPusher(instance="w:1",
                          kv_digest=lambda: ["h1", "h2", "h3"])
        try:
            doc = psh._next_doc()
            assert doc["kv_prefix"] == ["h1", "h2", "h3"]
        finally:
            psh.close()

    def test_default_defers_to_module_hook(self):
        prior = obs_fleet.KV_DIGEST_HOOK
        obs_fleet.KV_DIGEST_HOOK = lambda: ["m1"]
        psh = FleetPusher(instance="w:2")
        try:
            assert psh._next_doc()["kv_prefix"] == ["m1"]
        finally:
            psh.close()
            obs_fleet.KV_DIGEST_HOOK = prior

    def test_no_source_pushes_none(self):
        assert obs_fleet.KV_DIGEST_HOOK is None
        psh = FleetPusher(instance="w:3")
        try:
            assert psh._next_doc()["kv_prefix"] is None
        finally:
            psh.close()


# --------------------------------------------------------------------------- #
# Page handling on the card
# --------------------------------------------------------------------------- #

CV, CD, CH, CL, CMAX, CPS = 97, 32, 4, 2, 64, 8


def _card_engine():
    """A paged engine on the card over the port's seeded params (skips the
    case without a card)."""
    import torch

    from nnstreamer_tpu_torch.models import causal_lm
    from nnstreamer_tpu_torch.models.convert import causal_lm_params
    from nnstreamer_tpu_torch.serving import LMEngine

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    params = causal_lm_params(
        causal_lm.init_causal_lm(7, CV, CD, CH, CL, CMAX), "cuda")
    return LMEngine(params, CH, CMAX, n_slots=2, chunk=4, kv_page_size=CPS,
                    kv_pages=32, device="cuda")


def _card_prompts(n=1, seed=0):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, CV, 2 * CPS).astype(np.int32)
    return [np.concatenate([shared, rng.integers(
        0, CV, int(rng.integers(1, 10))).astype(np.int32)]) for _ in range(n)]


@pytest.mark.cuda
def test_import_on_one_thread_admission_on_another_on_the_card():
    src, dst, ref = _card_engine(), _card_engine(), _card_engine()
    (p,) = _card_prompts()
    src.submit(p, 1)
    src.run()
    doc = src._kv.export_pages(p)
    t = threading.Thread(target=dst._kv.import_pages, args=(doc,))
    t.start()
    t.join()
    box = {}

    def admit():
        rid = dst.submit(p, 8)
        dst.run()
        box["out"] = dst.results[rid]

    t = threading.Thread(target=admit)
    t.start()
    t.join()
    rid = ref.submit(p, 8)
    ref.run()
    assert dst.kv_stats["hit_tokens"] >= 2 * CPS
    assert box["out"] == ref.results[rid]


@pytest.mark.cuda
def test_checkpoint_while_serving_equals_quiesced_on_the_card():
    from nnstreamer_tpu_torch.fleet import checkpoint as ckpt

    eng = _card_engine()
    (p,) = _card_prompts()
    eng.submit(p, 4, session="cs")
    eng.run()
    lock = threading.Lock()
    busy = ckpt.CheckpointDaemon(eng, ckpt.MemoryStore(), lock=lock,
                                 name="busy")
    stop = threading.Event()

    def serve():
        q = _card_prompts(4, seed=9)
        while not stop.is_set():
            for x in q:
                with lock:
                    eng.submit(x, 4)
                    eng.run()

    t = threading.Thread(target=serve)
    t.start()
    try:
        for _ in range(5):
            assert busy.run_once() in (0, 1)
    finally:
        stop.set()
        t.join()
    quiet = ckpt.CheckpointDaemon(eng, ckpt.MemoryStore(), name="quiet")
    quiet.run_once()
    a, b = busy.store.latest("cs"), quiet.store.latest("cs")
    assert a["seq"] == b["seq"] and list(a["path"]) == list(b["path"])
    for e, r in zip(a["doc"]["entries"], b["doc"]["entries"]):
        assert np.array_equal(e["k"], r["k"])
        assert np.array_equal(e["v"], r["v"])


@pytest.mark.cuda
def test_page_round_trip_is_bit_equal_on_the_card():
    import torch

    from nnstreamer_tpu_torch.serving import disagg

    src, dst = _card_engine(), _card_engine()
    (p,) = _card_prompts()
    src.submit(p, 1)
    src.run()
    doc = src._kv.export_pages(p)
    meta, payload = disagg.encode_pages(doc)
    assert dst._kv.import_pages(disagg.decode_pages(meta, payload)) == 2
    back = dst._kv.export_pages(p)
    for e, r in zip(back["entries"], doc["entries"]):
        assert np.array_equal(e["k"], r["k"])
        assert np.array_equal(e["v"], r["v"])
    a, b = src._kv.root, dst._kv.root
    for k in range(2):
        key = tuple(int(x) for x in p[k * CPS:(k + 1) * CPS])
        a, b = a.children[key], b.children[key]
        assert torch.equal(src._kv.kpool[a.page], dst._kv.kpool[b.page])
        assert torch.equal(src._kv.vpool[a.page], dst._kv.vpool[b.page])
