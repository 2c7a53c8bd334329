"""The port's obs base (metrics, tracing, instrument, exporter, utils/trace)
and the obs CLI flags, against the JAX package's.

Every case of tests/test_obs.py that applies, and the span-store, serving
span, PipelineTracer and device_trace cases of tests/test_tracing.py, run
against ``nnstreamer_tpu_torch``; then parity with the JAX package on the
same seeded inputs: the Prometheus exposition of one registration and
observation sequence byte for byte, the layers' routes answered as the JAX
exporter answers them with those layers off, the fleet flags of the CLI
taken as the JAX CLI takes them, and one ``videotestsrc
! tensor_converter ! tensor_filter ! tensor_decoder mode=bounding_box !
tensor_sink`` run through both packages — metric families and label sets,
the span tree of every frame, the event types in order and the profiler's
dispatch records per frame. Timings are never compared. Every thread test
waits with a deadline; every socket binds port 0.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax

from nnstreamer_tpu.graph import Pipeline as JaxPipeline
from nnstreamer_tpu.obs import events as jax_events
from nnstreamer_tpu.obs import metrics as jax_metrics
from nnstreamer_tpu.obs import profile as jax_profile
from nnstreamer_tpu.obs import tracing as jax_tracing
from nnstreamer_tpu.obs.exporter import start_exporter as jax_start_exporter
from nnstreamer_tpu_torch.graph import Pipeline
from nnstreamer_tpu_torch.obs import events as obs_events
from nnstreamer_tpu_torch.obs import health as obs_health
from nnstreamer_tpu_torch.obs import metrics as obs_metrics
from nnstreamer_tpu_torch.obs import profile as obs_profile
from nnstreamer_tpu_torch.obs import tracing
from nnstreamer_tpu_torch.obs.exporter import MetricsExporter, start_exporter
from nnstreamer_tpu_torch.obs.metrics import MetricsRegistry
from nnstreamer_tpu_torch.obs.tracing import NOOP_SPAN, SpanStore, ctx_from_wire


@pytest.fixture
def global_metrics():
    """Save/restore the process-global enabled flag around a test."""
    was = obs_metrics.enabled()
    yield obs_metrics.registry()
    (obs_metrics.enable if was else obs_metrics.disable)()


@pytest.fixture
def global_health():
    reg = obs_health.registry()
    was = reg.is_enabled
    reg.reset()
    yield obs_health
    reg.reset()
    reg._enabled = was


@pytest.fixture
def tracing_on():
    was = tracing.enabled()
    tracing.store().reset()
    tracing.enable()
    yield tracing.store()
    (tracing.enable if was else tracing.disable)()
    tracing.store().sample_every = 1
    tracing.store().reset()


def _tiny_pipeline():
    p = Pipeline(device="cpu")
    src = p.add_new("videotestsrc", width=8, height=8, num_buffers=2)
    conv = p.add_new("tensor_converter")
    sink = p.add_new("tensor_sink")
    Pipeline.link(src, conv, sink)
    return p, conv


def _get_json(url):
    return json.loads(urllib.request.urlopen(url, timeout=10).read())


# --------------------------------------------------------------------------- #
# Registry
# --------------------------------------------------------------------------- #

def test_counter_basics():
    reg = MetricsRegistry()
    c = reg.counter("nnstpu_query_messages_total", "m", ("direction", "cmd"))
    c.labels("sent", "DATA").inc()
    c.labels("sent", "DATA").inc(2)
    c.labels("recv", "RESULT").inc()
    assert c.labels("sent", "DATA").value == 3
    assert c.labels("recv", "RESULT").value == 1
    with pytest.raises(ValueError, match="only go up"):
        c.labels("sent", "DATA").inc(-1)


def test_labels_by_name_and_arity():
    reg = MetricsRegistry()
    c = reg.counter("nnstpu_query_messages_total", "m", ("direction", "cmd"))
    assert c.labels(direction="sent", cmd="DATA") is c.labels("sent", "DATA")
    with pytest.raises(ValueError, match="expected labels"):
        c.labels("sent")


def test_reregistration_idempotent_and_conflicts():
    reg = MetricsRegistry()
    a = reg.counter("nnstpu_query_messages_total", "m", ("cmd",))
    assert reg.counter("nnstpu_query_messages_total", "m", ("cmd",)) is a
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("nnstpu_query_messages_total", "m", ("cmd",))
    with pytest.raises(ValueError, match="already registered"):
        reg.counter("nnstpu_query_messages_total", "m", ("other",))


def test_gauge_set_inc_and_callback():
    reg = MetricsRegistry()
    g = reg.gauge("nnstpu_pipeline_queue_depth", "d", ("element",))
    g.labels("q0").set(5)
    g.labels("q0").dec(2)
    assert g.labels("q0").value == 3
    state = {"depth": 7}
    g.labels("q1").set_function(lambda: state["depth"])
    assert g.labels("q1").value == 7
    state["depth"] = 9
    assert g.labels("q1").value == 9


def test_histogram_buckets_sum_count_max():
    reg = MetricsRegistry()
    h = reg.histogram("nnstpu_serving_ttft_seconds", "t",
                      buckets=(0.1, 1.0, 5.0))
    for v in (0.05, 0.5, 3.0, 10.0, 1.0):  # 1.0 lands IN le="1"
        h.observe(v)
    child = h.labels()
    assert child.count == 5 and child.max == 10.0
    assert abs(child.sum - 14.55) < 1e-9
    snap = reg.snapshot()["nnstpu_serving_ttft_seconds"]["series"][0]
    assert snap["buckets"] == {0.1: 1, 1.0: 3, 5.0: 4}
    assert snap["count"] == 5


def test_default_buckets_equal_jax():
    b = obs_metrics.DEFAULT_LATENCY_BUCKETS
    assert b == jax_metrics.DEFAULT_LATENCY_BUCKETS
    assert b == tuple(sorted(b)) and b[0] == 1e-5 and b[-1] == 50.0
    assert max(b[i + 1] / b[i] for i in range(len(b) - 1)) <= 4.0


def test_disabled_registry_noop_then_enable():
    reg = MetricsRegistry(enabled=False)
    c = reg.counter("nnstpu_query_messages_total", "m")
    h = reg.histogram("nnstpu_serving_ttft_seconds", "t")
    c.inc()
    h.observe(1.0)
    assert c.labels().value == 0 and h.labels().count == 0
    reg.enable()
    c.inc()
    assert c.labels().value == 1


def test_concurrent_increments_exact():
    reg = MetricsRegistry()
    c = reg.counter("nnstpu_query_messages_total", "m", ("cmd",))
    h = reg.histogram("nnstpu_serving_ttft_seconds", "t", buckets=(1.0,))
    n, per = 8, 2000

    def worker():
        for _ in range(per):
            c.labels("DATA").inc()
            h.observe(0.5)

    threads = [threading.Thread(target=worker) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert c.labels("DATA").value == n * per
    assert h.labels().count == n * per
    assert h.labels()._bucket_counts[0] == n * per


# --------------------------------------------------------------------------- #
# Exposition
# --------------------------------------------------------------------------- #

def test_prometheus_text_golden():
    reg = MetricsRegistry()
    reg.counter("nnstpu_query_messages_total", "Messages",
                ("direction", "cmd")).labels("sent", "DATA").inc(3)
    reg.gauge("nnstpu_pipeline_queue_depth", "Depth",
              ("element",)).labels("q0").set(2)
    h = reg.histogram("nnstpu_serving_ttft_seconds", "TTFT",
                      buckets=(0.1, 1.0, 5.0))
    h.observe(0.05)
    h.observe(3.0)
    assert reg.exposition() == """\
# HELP nnstpu_pipeline_queue_depth Depth
# TYPE nnstpu_pipeline_queue_depth gauge
nnstpu_pipeline_queue_depth{element="q0"} 2
# HELP nnstpu_query_messages_total Messages
# TYPE nnstpu_query_messages_total counter
nnstpu_query_messages_total{direction="sent",cmd="DATA"} 3
# HELP nnstpu_serving_ttft_seconds TTFT
# TYPE nnstpu_serving_ttft_seconds histogram
nnstpu_serving_ttft_seconds_bucket{le="0.1"} 1
nnstpu_serving_ttft_seconds_bucket{le="1"} 1
nnstpu_serving_ttft_seconds_bucket{le="5"} 2
nnstpu_serving_ttft_seconds_bucket{le="+Inf"} 2
nnstpu_serving_ttft_seconds_sum 3.05
nnstpu_serving_ttft_seconds_count 2
"""


def test_label_and_help_escaping():
    reg = MetricsRegistry()
    reg.counter("nnstpu_query_messages_total",
                'messages\nby "cmd" and \\ direction',
                ("cmd",)).labels('we"ird\\x\n').inc()
    text = reg.exposition()
    assert 'cmd="we\\"ird\\\\x\\n"' in text
    assert ("# HELP nnstpu_query_messages_total "
            'messages\\nby "cmd" and \\\\ direction') in text
    assert all(ln.startswith(("#", "nnstpu_"))
               for ln in text.strip().splitlines())
    assert MetricsRegistry().exposition() == ""


def _sequence(reg, seed: int) -> None:
    """A seeded sequence of registrations and observations: counters,
    gauges (set/inc/dec, callbacks), histograms on default and custom
    buckets, odd label values and help text, values across magnitudes."""
    rng = np.random.default_rng(seed)
    fams = [
        reg.counter("nnstpu_pipeline_buffers_total", "Buffers", ("element",)),
        reg.counter("nnstpu_serving_streams_total", 'Streams "in"\nslots',
                    ("engine", "event")),
        reg.gauge("nnstpu_pipeline_queue_depth", "Depth", ("element",)),
        reg.gauge("nnstpu_serving_kv_used_pages", "Pages", ("engine",)),
        reg.histogram("nnstpu_pipeline_proctime_seconds", "Proc",
                      ("element",)),
        reg.histogram("nnstpu_serving_ttft_seconds", "TTFT", ("engine",),
                      buckets=(0.001, 0.5, 2.0, 7.25)),
        reg.counter("nnstpu_sched_batches_total", "", ()),
    ]
    names = ["q0", 'we"ird', "a\\b", "line\nbreak", "lm"]
    for _ in range(200):
        k = int(rng.integers(len(fams)))
        fam = fams[k]
        labels = [names[int(rng.integers(len(names)))]
                  for _ in fam.labelnames]
        child = fam.labels(*labels)
        v = float(rng.choice([0.0, 1.0, 2.5, 1e-6, 3.14159265, 1e16,
                              float(rng.exponential(0.3))]))
        if fam.type == "counter":
            child.inc(v)
        elif fam.type == "gauge":
            if rng.random() < 0.1:
                child.set_function(lambda v=v: v * 2)
            else:
                (child.set, child.inc, child.dec)[int(rng.integers(3))](v)
        else:
            child.observe(v)


@pytest.mark.parametrize("seed", range(4))
def test_exposition_byte_equal_to_jax(seed):
    mine, ref = MetricsRegistry(), jax_metrics.MetricsRegistry()
    _sequence(mine, seed)
    _sequence(ref, seed)
    assert mine.exposition() == ref.exposition()
    assert mine.snapshot() == ref.snapshot()


# --------------------------------------------------------------------------- #
# The structural no-op fast path
# --------------------------------------------------------------------------- #

def test_disabled_leaves_chain_entry_untouched(global_metrics):
    obs_metrics.disable()
    p, conv = _tiny_pipeline()
    p.run(timeout=30)
    assert "_chain_entry" not in conv.__dict__
    assert "_obs_registries" not in conv.__dict__


def test_enabled_wraps_and_records(global_metrics):
    obs_metrics.enable()
    p, conv = _tiny_pipeline()
    p.run(timeout=30)
    assert "_chain_entry" in conv.__dict__
    series = obs_metrics.registry().snapshot()[
        "nnstpu_pipeline_buffers_total"]["series"]
    assert {s["labels"]["element"]: s["value"]
            for s in series}[conv.name] >= 2


def test_restart_does_not_double_wrap(global_metrics):
    obs_metrics.enable()
    p, conv = _tiny_pipeline()
    p.run(timeout=30)
    wrapped = conv.__dict__["_chain_entry"]
    p.run(timeout=30)
    assert conv.__dict__["_chain_entry"] is wrapped


def test_every_hook_is_none_when_obs_is_off():
    from nnstreamer_tpu_torch.graph import element as gel
    from nnstreamer_tpu_torch.ops import epilogue

    assert obs_profile.DISPATCH_HOOK is None
    assert obs_profile.ENGINE_HOOK is None
    assert obs_profile.KERNEL_HOOK is None
    assert obs_profile.SCHED_HOOK is None
    assert gel.PROFILE_CHAIN_HOOK is None
    assert epilogue.EPILOGUE_SELECT_HOOK is None
    assert not (obs_metrics.enabled() or tracing.enabled()
                or obs_health.enabled() or obs_events.enabled())


# --------------------------------------------------------------------------- #
# Exporter
# --------------------------------------------------------------------------- #

def test_scrape_and_healthz(global_metrics):
    reg = MetricsRegistry()
    reg.counter("nnstpu_query_messages_total", "m", ("cmd",)) \
        .labels("DATA").inc(4)
    with start_exporter(port=0, registry=reg) as exp:
        text = urllib.request.urlopen(exp.url, timeout=5).read().decode()
        assert 'nnstpu_query_messages_total{cmd="DATA"} 4' in text
        health = _get_json(f"http://127.0.0.1:{exp.port}/healthz")
        assert health["status"] == "ok" and health["families"] == 1
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{exp.port}/nope",
                                   timeout=5)


def test_healthz_failing_component(global_metrics, global_health):
    global_health.enable()
    global_health.component("test:unit").set_status(
        global_health.Status.FAILED, "boom")
    with start_exporter(port=0, registry=MetricsRegistry()) as exp:
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"http://127.0.0.1:{exp.port}/healthz",
                                   timeout=5)
        assert ei.value.code == 503
        body = json.loads(ei.value.read().decode())
        assert body["status"] == "failing"
        comp = {c["name"]: c for c in body["components"]}["test:unit"]
        assert comp["status"] == "failing" and comp["detail"] == "boom"


def test_readyz_transitions(global_metrics, global_health):
    global_health.enable()
    with start_exporter(port=0) as exp:
        url = f"http://127.0.0.1:{exp.port}/readyz"
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(url, timeout=5)
        assert ei.value.code == 503
        assert json.loads(ei.value.read().decode())["ready"] is False
        p, _conv = _tiny_pipeline()
        p.start()
        try:
            body = _get_json(url)
            assert body["ready"] is True
            assert body["conditions"][f"pipeline:{p.name}"] is True
        finally:
            p.stop()
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(url, timeout=5)
        assert ei.value.code == 503
        body = json.loads(ei.value.read().decode())
        assert body["conditions"][f"pipeline:{p.name}"] is False


def test_404_hint_lists_routes(global_metrics):
    with start_exporter(port=0, registry=MetricsRegistry()) as exp:
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"http://127.0.0.1:{exp.port}/nope",
                                   timeout=5)
        assert ei.value.code == 404
        hint = ei.value.read().decode()
    for route in ("/metrics", "/healthz", "/readyz", "/debug/events",
                  "/debug/traces", "/debug/profile", "POST /fleet/push"):
        assert route in hint


def test_start_exporter_enables_collection(global_metrics):
    obs_metrics.disable()
    exp = start_exporter(port=0)
    try:
        assert obs_metrics.enabled()
    finally:
        exp.close()


def test_close_joins_thread_releases_port_and_is_idempotent(global_metrics):
    exp = start_exporter(port=0, registry=MetricsRegistry())
    port = exp.port
    exp.close()
    exp.close()
    assert not exp._thread.is_alive()
    exp2 = MetricsExporter(port=port, registry=MetricsRegistry())
    try:
        assert exp2.port == port
    finally:
        exp2.close()


def test_bind_conflict_names_port_and_flag(global_metrics):
    with start_exporter(port=0, registry=MetricsRegistry()) as exp:
        with pytest.raises(RuntimeError, match="--metrics-port") as ei:
            MetricsExporter(port=exp.port, registry=MetricsRegistry())
        assert str(exp.port) in str(ei.value)


def test_version_and_debug_index(global_metrics):
    import torch

    with start_exporter(port=0, registry=MetricsRegistry()) as exp:
        base = f"http://127.0.0.1:{exp.port}"
        ver = _get_json(f"{base}/debug/version")
        index = _get_json(f"{base}/debug")
    assert ver["torch"] == torch.__version__
    assert ver["device_kind"] == "cpu"
    assert "GET /debug/profile" in index["routes"]
    assert "GET /debug/traces/<id>" in index["prefix_routes"]
    snap = obs_metrics.registry().snapshot()
    assert snap["nnstpu_build_info"]["series"][0]["labels"]["torch"] == \
        torch.__version__


#: the routes of the obs layers and the fleet, asked with each layer off:
#: (method, path, body)
_OFF_ROUTES = [
    ("GET", "/debug/slo", None), ("GET", "/debug/quality", None),
    ("GET", "/debug/tune", None), ("GET", "/debug/fleet", None),
    ("GET", "/debug/fleet/actions", None),
    ("GET", "/debug/fleet/checkpoints", None),
    ("GET", "/debug/bundles", None), ("GET", "/debug/bundles/b1", None),
    ("POST", "/fleet/push", b"{}"),
]


def _answer(port, method, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, method=method)
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize("method,path,body", _OFF_ROUTES,
                         ids=[r[1] for r in _OFF_ROUTES])
def test_unported_layer_routes_answer_as_jax_off(global_metrics, method,
                                                 path, body):
    was = jax_metrics.enabled()
    try:
        with start_exporter(port=0, registry=MetricsRegistry()) as mine, \
                jax_start_exporter(
                    port=0, registry=jax_metrics.MetricsRegistry()) as ref:
            assert _answer(mine.port, method, path, body) == \
                _answer(ref.port, method, path, body)
    finally:
        (jax_metrics.enable if was else jax_metrics.disable)()


def test_diag_critpath_names_its_roadmap_item(global_metrics):
    """The route no longer waits for its ROADMAP item (§A7, obs/diag is
    ported): with diag off it answers from the span store alone, as the
    JAX exporter does."""
    with start_exporter(port=0, registry=MetricsRegistry()) as exp:
        body = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{exp.port}/debug/diag/critpath",
            timeout=5).read())
    assert body["diag_enabled"] is False
    assert body["segments"] and "tenants" in body


# --------------------------------------------------------------------------- #
# Span store, serving spans, the debug pages
# --------------------------------------------------------------------------- #

def test_disabled_store_returns_shared_noop():
    store = SpanStore(enabled=False)
    s = store.start_span("pipeline.buffer")
    assert s is NOOP_SPAN and s.context is None and not s.recording
    s.set_attribute("k", 1)
    s.end()
    assert store.summaries() == []


def test_tree_nests_children_under_local_parents():
    store = SpanStore(enabled=True)
    root = store.start_span("pipeline.buffer", attrs={"source": "src"})
    child = store.start_span("pipeline.element", parent=root.context,
                             attrs={"element": "conv"})
    grand = store.start_span("query.request", parent=child.context)
    grand.end()
    child.end()
    root.end()
    tid = root.context.trace_id
    tree = store.tree(tid)
    assert tree["spans"] == 3
    (r,) = tree["tree"]
    assert r["name"] == "pipeline.buffer" and r["parent_id"] is None
    (c,) = r["children"]
    assert c["name"] == "pipeline.element"
    assert c["children"][0]["name"] == "query.request"
    (summ,) = store.summaries()
    assert summ["trace_id"] == tid and summ["completed"]


def test_remote_parented_spans_surface_as_tree_roots():
    store = SpanStore(enabled=True)
    s = store.start_span("query.server_handle",
                         parent=ctx_from_wire({"tid": "aa" * 8,
                                               "sid": "bb" * 8}))
    s.end()
    tree = store.tree("aa" * 8)
    assert tree["tree"][0]["parent_id"] == "bb" * 8
    assert store.summaries()[0]["completed"] is False
    assert ctx_from_wire({"tid": 1}) is None and ctx_from_wire("x") is None


def test_min_ms_filter_and_head_sampling():
    store = SpanStore(enabled=True)
    slow = store.start_span("query.request")
    slow.start_ns -= int(50e6)
    slow.end()
    store.start_span("query.request").end()
    assert len(store.summaries()) == 2
    assert [t["trace_id"] for t in store.summaries(min_ms=25.0)] == \
        [slow.context.trace_id]
    sampled = SpanStore(enabled=True, sample_every=4)
    assert sum(sampled.should_sample() for _ in range(40)) == 10


def test_slowest_retention_survives_wraparound_concurrent():
    store = SpanStore(max_traces=32, keep_slowest=4, enabled=True)
    slow_ids = []
    for i in range(4):
        s = store.start_span("query.request", attrs={"i": i})
        s.start_ns -= int((i + 1) * 1e9)
        s.end()
        slow_ids.append(s.context.trace_id)

    def hammer(n):
        for _ in range(n):
            s = store.start_span("pipeline.buffer")
            store.start_span("pipeline.element", parent=s.context).end()
            s.end()

    threads = [threading.Thread(target=hammer, args=(200,))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    summ = store.summaries()
    assert len(summ) <= store.max_traces + store.keep_slowest
    assert set(slow_ids) <= {t["trace_id"] for t in summ}
    assert [t["trace_id"] for t in summ[:4]] == slow_ids[::-1]
    assert all(t["slowest_retained"] for t in summ[:4])


def test_span_context_manager_sets_current_and_flags_error():
    store = SpanStore(enabled=True)
    assert tracing.current_context() is None
    with pytest.raises(RuntimeError):
        with store.start_span("serving.request") as s:
            assert tracing.current_context() is s.context
            raise RuntimeError("boom")
    assert tracing.current_context() is None
    assert s.attrs.get("error") is True and s.end_ns is not None


def test_wire_helpers_and_export_queue():
    store = SpanStore(enabled=True)
    store.set_export(True)
    s = store.start_span("query.request")
    store.mark_export(s.context.trace_id)
    s.end()
    (wire,) = store.drain_export()
    assert wire["tid"] == s.context.trace_id and wire["name"] == \
        "query.request"
    assert s.context.to_wire() == {"tid": s.context.trace_id,
                                   "sid": s.context.span_id}
    assert ctx_from_wire(s.context.to_wire()).span_id == s.context.span_id
    store.set_export(False)
    store.mark_export("other")
    assert store.drain_export() == []


def _lm_engine():
    from nnstreamer_tpu_torch.models import causal_lm
    from nnstreamer_tpu_torch.models.convert import causal_lm_params
    from nnstreamer_tpu_torch.serving.lm_engine import LMEngine

    params = causal_lm_params(causal_lm.init_causal_lm(0, 61, 32, 4, 2, 64),
                              "cpu")
    return LMEngine(params, 4, 64, n_slots=2, chunk=4, device="cpu")


def test_request_span_tree_covers_lifecycle(tracing_on):
    eng = _lm_engine()
    eng.submit(np.arange(1, 5, dtype=np.int32), max_new=4)
    eng.run()
    completed = [t for t in tracing_on.summaries() if t["completed"]]
    assert len(completed) == 1 and completed[0]["root"] == "serving.request"
    (root,) = tracing_on.tree(completed[0]["trace_id"])["tree"]
    assert {"serving.admission_wait", "serving.prefill", "serving.compile",
            "serving.decode"} <= {c["name"] for c in root["children"]}
    assert root["attrs"]["tokens"] == 4


def test_submit_joins_callers_current_trace(tracing_on):
    eng = _lm_engine()
    with tracing.start_span("query.request") as outer:
        eng.submit(np.arange(1, 5, dtype=np.int32), max_new=2)
    eng.run()
    req = [s for s in tracing_on.spans_of(outer.context.trace_id)
           if s.name == "serving.request"]
    assert len(req) == 1 and req[0].context.parent_id == outer.context.span_id


def test_disabled_requests_carry_no_spans():
    assert not tracing.enabled()
    eng = _lm_engine()
    eng.submit(np.arange(1, 5, dtype=np.int32), max_new=2)
    req = eng._queue[0]
    assert req.span is None and req.wait_span is None
    eng.run()
    assert tracing.store().summaries() == []


def test_traces_and_pipeline_endpoints(tracing_on):
    p, conv = _tiny_pipeline()
    p.name = "obs_endpoints"  # other tests' live pipelines share default names
    p.run(timeout=30)
    with start_exporter(port=0, enable=False) as exp:
        base = f"http://{exp.host}:{exp.port}"
        listing = _get_json(f"{base}/debug/traces")
        assert listing["tracing_enabled"] is True
        traces = [t for t in listing["traces"] if t["completed"]]
        assert len(traces) == 2
        tree = _get_json(f"{base}/debug/traces/{traces[0]['trace_id']}")
        assert tree["tree"][0]["name"] == "pipeline.buffer"
        assert _get_json(f"{base}/debug/traces?min_ms=1e9")["traces"] == []
        for bad, code in (("/debug/traces/nope", 404),
                          ("/debug/traces?min_ms=abc", 400)):
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(base + bad, timeout=5)
            assert ei.value.code == code
        dbg = _get_json(f"{base}/debug/pipeline")
        mine = next(x for x in dbg["pipelines"] if x["name"] == p.name)
        assert {e["kind"] for e in mine["elements"]} >= {"tensor_converter"}
        assert dbg["element_spans"][conv.name]["n"] == 2


# --------------------------------------------------------------------------- #
# utils/trace.py
# --------------------------------------------------------------------------- #

def _traced_run(spans=False):
    from nnstreamer_tpu_torch.utils.trace import PipelineTracer

    p = Pipeline(device="cpu")
    src = p.add_new("videotestsrc", width=8, height=8, num_buffers=3)
    conv = p.add_new("tensor_converter")
    slow = p.add_new("tensor_filter",
                     model=lambda x: (time.sleep(0.01), x)[1])
    sink = p.add_new("tensor_sink")
    Pipeline.link(src, conv, slow, sink)
    tracer = PipelineTracer.attach(p, spans=spans)
    p.run(timeout=60)
    return tracer


def test_report_rows_sorted_by_mean_proctime_desc():
    lines = _traced_run().report().splitlines()
    assert len(lines) >= 4
    proctimes = [float(ln.split()[2]) for ln in lines[1:]]
    assert proctimes == sorted(proctimes, reverse=True)
    names = [ln.split()[0] for ln in lines[1:]]
    filt = next(i for i, n in enumerate(names) if n.startswith("tensor_filter"))
    sink = next(i for i, n in enumerate(names) if n.startswith("tensor_sink"))
    assert filt < sink and proctimes[filt] >= 1_000


def test_span_consumer_uses_private_store():
    assert not tracing.enabled()
    tracer = _traced_run(spans=True)
    assert "tensor_filter" in tracer.span_report()
    assert tracing.store().summaries() == []
    with pytest.raises(RuntimeError, match="spans=True"):
        _traced_run(spans=False).span_report()


def test_device_trace_writes_a_chrome_trace_and_joins_the_trace(
        tmp_path, tracing_on):
    import torch

    from nnstreamer_tpu_torch.utils.trace import device_trace

    with tracing.start_span("query.request") as outer:
        with device_trace(str(tmp_path)) as dt:
            torch.ones(64).mul_(2.0)
    assert dt.trace_id == outer.context.trace_id
    assert json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    (dev,) = [s for s in tracing_on.spans_of(outer.context.trace_id)
              if s.name == "device.xprof"]
    assert dev.attrs["logdir"] == str(tmp_path)
    assert dev.context.parent_id == outer.context.span_id


# --------------------------------------------------------------------------- #
# One detection pipeline through both packages with obs on
# --------------------------------------------------------------------------- #

def _obs_on(metrics, tracing_mod, events_mod, profile_mod):
    metrics.enable()
    tracing_mod.store().reset()
    tracing_mod.enable()
    events_mod.ring().reset()
    events_mod.enable()
    profile_mod.profiler().reset()
    profile_mod.enable(sample_every=1)


def _obs_off(metrics, tracing_mod, events_mod, profile_mod):
    profile_mod.disable()
    profile_mod.profiler().reset()
    profile_mod.profiler().sample_every = profile_mod.DEFAULT_SAMPLE_EVERY
    events_mod.disable()
    events_mod.ring().reset()
    tracing_mod.disable()
    tracing_mod.store().reset()
    metrics.disable()


def _span_shape(store):
    """Each completed trace as its spans' (depth, name, element) in tree
    order, sorted."""
    out = []
    for summ in store.summaries():
        rows = []

        def walk(nodes, depth):
            for n in nodes:
                rows.append((depth, n["name"], n["attrs"].get("element")))
                walk(n["children"], depth + 1)

        walk(store.tree(summ["trace_id"])["tree"], 0)
        out.append(tuple(rows))
    return sorted(out)


#: the detection run's element names (unique in the process, so the global
#: registries' series of other tests stay out of the comparison)
_DET = ("det_src", "det_conv", "det_filt", "det_dec", "det_sink")


def _families(snap, prefix):
    return {name: sorted(tuple(sorted(s["labels"].items()))
                         for s in fam["series"]
                         if s["labels"].get("element") in _DET)
            for name, fam in snap.items() if name.startswith(prefix)}


def _buffers(snap):
    fam = snap.get("nnstpu_pipeline_buffers_total", {"series": []})
    return {s["labels"]["element"]: s["value"] for s in fam["series"]
            if s["labels"]["element"] in _DET}


def _run_detection(pipeline_cls, model, tmp, frames, **pkw):
    from test_torch_ssd_slice import SLICE_CLASSES, SLICE_SIZE
    from nnstreamer_tpu_torch.models.ssd_mobilenet import write_box_priors

    priors = tmp / "priors.txt"
    write_box_priors(str(priors), size=SLICE_SIZE)
    labels = tmp / "labels.txt"
    labels.write_text("\n".join(f"c{i}" for i in range(SLICE_CLASSES)))
    p = pipeline_cls(name="obsdet", **pkw)
    src = p.add_new("videotestsrc", name="det_src", width=SLICE_SIZE,
                    height=SLICE_SIZE, pattern="random", num_buffers=frames)
    conv = p.add_new("tensor_converter", name="det_conv")
    filt = p.add_new("tensor_filter", name="det_filt", framework="xla-tpu",
                     model=model)
    dec = p.add_new("tensor_decoder", name="det_dec", mode="bounding_box",
                    option1="mobilenet-ssd", option2=str(labels),
                    option3=str(priors), option4=f"{SLICE_SIZE}:{SLICE_SIZE}",
                    option5=f"{SLICE_SIZE}:{SLICE_SIZE}")
    sink = p.add_new("tensor_sink", name="det_sink", store=True)
    pipeline_cls.link(src, conv, filt, dec, sink)
    p.run(timeout=300)
    return [b.meta["detections"] for b in sink.buffers]


def test_detection_pipeline_telemetry_equals_jax(tmp_path):
    """Metric families and label sets, span trees, event types in order and
    the profiler's dispatch records (count and label per frame) of one
    detection run equal the JAX package's; detections equal with obs on
    and off."""
    from test_torch_ssd_slice import _jax_ssd, _numpy_vars, _port_ssd
    from test_torch_ssd_slice import SLICE_CLASSES, SLICE_SIZE

    frames = 3
    jb = _jax_ssd(SLICE_SIZE, "float32", SLICE_CLASSES)
    pb = _port_ssd(SLICE_SIZE, "float32", SLICE_CLASSES, _numpy_vars(jb))
    off = _run_detection(Pipeline, pb, tmp_path, frames, device="cpu")
    got = {}
    for name, cls, model, mods, kw in (
            ("jax", JaxPipeline, jb,
             (jax_metrics, jax_tracing, jax_events, jax_profile), {}),
            ("torch", Pipeline, pb,
             (obs_metrics, tracing, obs_events, obs_profile),
             {"device": "cpu"})):
        was = mods[0].enabled()
        _obs_on(*mods)
        try:
            before = _buffers(mods[0].registry().snapshot())
            dets = _run_detection(cls, model, tmp_path, frames, **kw)
            snap = mods[0].registry().snapshot()
            recs = mods[3].profiler().records("dispatch")
            got[name] = dict(
                dets=dets,
                families=_families(snap, "nnstpu_pipeline_"),
                buffers={el: n - before.get(el, 0)
                         for el, n in _buffers(snap).items()},
                spans=_span_shape(mods[1].store()),
                events=[e["type"] for e in mods[2].ring().snapshot()],
                dispatch=[r["label"] for r in recs],
                sampled=[r["device_ns"] is not None for r in recs])
        finally:
            _obs_off(*mods)
            (mods[0].enable if was else mods[0].disable)()
    mine, ref = got["torch"], got["jax"]
    assert mine["families"] == ref["families"]
    assert mine["buffers"] == ref["buffers"] == {
        el: frames for el in _DET[1:]}
    assert mine["spans"] == ref["spans"]
    assert len(mine["spans"]) == frames
    assert [r[1:] for r in mine["spans"][0]] == [
        ("pipeline.buffer", None)] + [("pipeline.element", el)
                                      for el in _DET[1:]]
    assert mine["events"] == ref["events"]
    assert mine["events"][-1] == "pipeline.state"
    assert mine["dispatch"] == ref["dispatch"]
    assert len(mine["dispatch"]) == frames and all(mine["sampled"])
    assert "+post[decode[" in mine["dispatch"][0]
    assert [[(d["class"], d["box"]) for d in f] for f in mine["dets"]] == \
        [[(d["class"], d["box"]) for d in f] for f in off]


# --------------------------------------------------------------------------- #
# CLI
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("argv", [
    ["--profile", "videotestsrc ! tensor_sink"],
    ["--watchdog", "src ! sink"],
    ["--profile", "16", "pipe"],
    ["--profile", "--trace", "pipe"],
    ["--watchdog", "2.5", "pipe"],
    ["--profile"],
    ["--sched", "--profile", "videotestsrc ! tensor_sink"],
], ids=lambda a: " ".join(a))
def test_obs_flags_normalize_as_jax(argv):
    from nnstreamer_tpu.cli import _normalize_argv as jax_normalize
    from nnstreamer_tpu_torch.cli import _normalize_argv

    assert _normalize_argv(list(argv)) == jax_normalize(list(argv))


#: the fleet flags on a CPU pipeline, each as the JAX CLI takes it: a
#: combination it refuses (exit 2 and its message), or one it accepts and
#: wires (exit 0, the environment it exports)
_FLEET_FLAG_CASES = {
    "--obs-push": ["--obs-push", "ftp://nowhere"],
    "--obs-aggregate": ["--obs-aggregate"],
    "--autoscale": ["--autoscale", "1:2"],
    "--checkpoint-dir": ["--checkpoint-dir", "ckpt"],
    "--checkpoint-interval": ["--checkpoint-dir", "ckpt",
                              "--checkpoint-interval", "0"],
    "--role": ["--role", "decode"],
    "--disagg": ["--disagg", "127.0.0.1:1"],
    "--role-unified": ["--role", "unified", "--disagg",
                       "127.0.0.1:1;127.0.0.1:2"],
}

_FLEET_ENV = ("NNS_LM_ROLE", "NNS_LM_DISAGG", "NNS_FLEET_CKPT_DIR",
              "NNS_FLEET_CKPT_INTERVAL")


def _run_cli(main, argv, capsys):
    try:
        code = main(argv)
    except SystemExit as e:
        code = e.code
    err = capsys.readouterr().err
    env = {k: os.environ.get(k) for k in _FLEET_ENV}
    for k in _FLEET_ENV:
        os.environ.pop(k, None)
    return code, err, env


@pytest.mark.parametrize("flag", sorted(_FLEET_FLAG_CASES))
def test_unported_flags_are_refused_naming_their_roadmap_item(
        flag, capsys, monkeypatch, tmp_path):
    """Each fleet flag as the JAX CLI takes it (the flags were refused
    before the fleet layer was ported; the name is kept): the same exit
    code, the same refusal message or ``fleet:`` line, and the same
    ``NNS_LM_*``/``NNS_FLEET_CKPT_*`` environment exported for the engines
    and workers the run builds."""
    from nnstreamer_tpu.cli import main as jax_main
    from nnstreamer_tpu_torch.cli import main

    monkeypatch.chdir(tmp_path)
    for k in _FLEET_ENV:
        monkeypatch.delenv(k, raising=False)
    pipe = "videotestsrc num-buffers=1 ! tensor_sink"
    argv = _FLEET_FLAG_CASES[flag]
    mine = _run_cli(main, ["--device", "cpu"] + argv + [pipe], capsys)
    ref = _run_cli(jax_main, argv + [pipe], capsys)
    assert mine[0] == ref[0]
    assert mine[2] == ref[2]
    want = [ln for ln in ref[1].splitlines()
            if ln.startswith(("fleet:", "ERROR:")) or "error:" in ln]
    got = [ln for ln in mine[1].splitlines()
           if ln.startswith(("fleet:", "ERROR:")) or "error:" in ln]
    assert [ln.replace("nns-launch-torch", "nns-launch") for ln in got] \
        == want


def test_profile_dump_needs_profile(capsys):
    from nnstreamer_tpu_torch.cli import main

    with pytest.raises(SystemExit):
        main(["--profile-dump", "x.json", "videotestsrc ! tensor_sink"])
    assert "needs --profile" in capsys.readouterr().err


def test_cli_obs_run(tmp_path, capsys, global_metrics, global_health):
    """--metrics-port 0 --trace --watchdog --profile --events-dump on a CPU
    pipeline: exit 0, the exporter's URL, the span and profile reports, the
    cost samples and the event journal."""
    from nnstreamer_tpu_torch.cli import main

    evpath, dump = tmp_path / "events.jsonl", tmp_path / "samples.json"
    was_t = tracing.enabled()
    try:
        rc = main(["--device", "cpu", "--metrics-port", "0", "--trace",
                   "--watchdog", "--profile", "--profile-dump", str(dump),
                   "--events-dump", str(evpath),
                   "videotestsrc num-buffers=3 width=16 height=16 ! "
                   "tensor_converter ! tensor_sink"])
    finally:
        obs_profile.disable()
        obs_profile.profiler().reset()
        obs_events.disable()
        obs_events.ring().reset()
        (tracing.enable if was_t else tracing.disable)()
        tracing.store().reset()
    err = capsys.readouterr().err
    assert rc == 0
    assert "metrics: http://127.0.0.1:" in err
    assert "mean(us)" in err and "profile: " in err
    assert json.loads(dump.read_text())["version"] == 1
    types = [json.loads(ln)["type"] for ln in evpath.read_text().splitlines()]
    assert types[0] == "pipeline.state" and types.count("pipeline.state") == 2
