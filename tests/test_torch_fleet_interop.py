"""The fleet layer across the two packages, on localhost.

The port's disaggregated serving, fleet federation, checkpoints, migration
and autoscale policies speak the JAX package's wire, push documents and
blobs, so either package's process joins the other's fleet:

- a JAX prefill worker ships its pages to a port decode worker and a port
  prefill worker to a JAX decode worker: the greedy tokens equal the JAX
  unified engine's, the imported K/V is within the window prefill's
  tolerance (rtol 1e-4, atol 1e-5, PR 14) of the receiving package's own
  prefill, and ``encode_pages``/``pack_message`` give the same
  ``KV_PAGE_XFER`` meta and bytes for the same document;
- a port ``FleetPusher`` feeds a JAX ``FleetAggregator`` and a JAX pusher a
  port aggregator, over the query wire (an ``OBS_PUSH`` frame to the other
  package's worker) and over HTTP (``POST /fleet/push``): the push documents
  are equal key for key but timestamps, and the federated ``/metrics``
  text is equal for the same snapshots;
- a checkpoint blob built by one package parses in the other with the same
  digest, and a ``LocalDirStore`` written by one package's daemon is
  restored by the other's ``SessionRestorer`` into a warm session;
- one session migrates from a JAX worker to a port worker and back, its
  turns token-equal to the same turns without migration;
- ``AutoscalePolicy`` and ``PricedPolicy`` decide as JAX's do over a
  seeded fake-clock signal sequence;
- the CLI with every fleet flag on a CPU pipeline prints the JAX CLI's
  ``fleet:`` lines.

Every socket binds port 0; each case runs under a timeout of its
own (SIGALRM) and stops its workers, pushers, aggregators and controllers.
"""

import json
import os
import signal
import socket
import urllib.request

import numpy as np
import pytest

import jax  # noqa: E402

from nnstreamer_tpu import fleet as jfleet  # noqa: E402
from nnstreamer_tpu.fleet import autoscale as jautoscale  # noqa: E402
from nnstreamer_tpu.fleet import checkpoint as jckpt  # noqa: E402
from nnstreamer_tpu.models import causal_lm as jlm  # noqa: E402
from nnstreamer_tpu.obs import fleet as jobs_fleet  # noqa: E402
from nnstreamer_tpu.obs import health as jhealth  # noqa: E402
from nnstreamer_tpu.obs import metrics as jmetrics  # noqa: E402
from nnstreamer_tpu.obs import tracing as jtracing  # noqa: E402
from nnstreamer_tpu.obs.exporter import start_exporter as jstart_exporter  # noqa: E402
from nnstreamer_tpu.query import protocol as jprotocol  # noqa: E402
from nnstreamer_tpu.serving import LMEngine as JaxEngine  # noqa: E402
from nnstreamer_tpu.serving import disagg as jdisagg  # noqa: E402
from nnstreamer_tpu_torch import fleet as tfleet  # noqa: E402
from nnstreamer_tpu_torch.fleet import autoscale as tautoscale  # noqa: E402
from nnstreamer_tpu_torch.fleet import checkpoint as tckpt  # noqa: E402
from nnstreamer_tpu_torch.fleet.migrate import SessionMigrator  # noqa: E402
from nnstreamer_tpu_torch.models.convert import causal_lm_params  # noqa: E402
from nnstreamer_tpu_torch.obs import fleet as tobs_fleet  # noqa: E402
from nnstreamer_tpu_torch.obs import health as thealth  # noqa: E402
from nnstreamer_tpu_torch.obs import metrics as tmetrics  # noqa: E402
from nnstreamer_tpu_torch.obs import tracing as ttracing  # noqa: E402
from nnstreamer_tpu_torch.obs.exporter import start_exporter  # noqa: E402
from nnstreamer_tpu_torch.query import protocol as tprotocol  # noqa: E402
from nnstreamer_tpu_torch.query.router import BackendSet, QueryRouter  # noqa: E402
from nnstreamer_tpu_torch.serving import LMEngine  # noqa: E402
from nnstreamer_tpu_torch.serving import disagg as tdisagg  # noqa: E402

V, D, H, L, MAXLEN = 97, 32, 4, 2, 64
PS = 8
CPU = "cpu"

#: each case's own limit, seconds
CASE_TIMEOUT_S = 60


@pytest.fixture(autouse=True)
def _case_guard():
    """A timeout of the case's own, and no fleet hook, pusher, aggregator,
    controller or import target of either package left behind."""
    def expire(signum, frame):
        raise TimeoutError(f"case exceeded {CASE_TIMEOUT_S} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(CASE_TIMEOUT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
        for fl, ofl, dg in ((tfleet, tobs_fleet, tdisagg),
                            (jfleet, jobs_fleet, jdisagg)):
            fl.disable()
            ofl.disable_push()
            ofl.disable_aggregator()
            dg.clear_import_target()


@pytest.fixture(autouse=True)
def _no_lm_env(monkeypatch):
    for k in ("NNS_LM_KV_PAGE_SIZE", "NNS_LM_KV_PAGES", "NNS_LM_ROLE",
              "NNS_FLEET_CKPT_DIR", "NNS_FLEET_CKPT_INTERVAL"):
        monkeypatch.delenv(k, raising=False)


@pytest.fixture(scope="module")
def jparams():
    return jlm.init_causal_lm(jax.random.PRNGKey(7), V, D, H, L, MAXLEN)


@pytest.fixture(scope="module")
def tparams(jparams):
    return causal_lm_params(jax.tree_util.tree_map(np.asarray, jparams), CPU)


def mk(pkg, jparams, tparams, role="unified", pages=32):
    """A paged engine of either package (``pkg`` "jax" or "torch")."""
    if pkg == "jax":
        return JaxEngine(jparams, H, MAXLEN, n_slots=2, chunk=4,
                         kv_page_size=PS, kv_pages=pages, role=role)
    return LMEngine(tparams, H, MAXLEN, n_slots=2, chunk=4, kv_page_size=PS,
                    kv_pages=pages, role=role, device=CPU)


def worker(pkg, engine):
    return (jdisagg if pkg == "jax" else tdisagg).DisaggWorker(engine)


def prompts(n=4, seed=0):
    """``n`` prompts sharing a two-page prefix, suffixes of 1-9 tokens."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, V, 2 * PS).astype(np.int32)
    return [np.concatenate([shared, rng.integers(
        0, V, int(rng.integers(1, 10))).astype(np.int32)]) for _ in range(n)]


def unified_tokens(jparams, ps, max_new):
    """The JAX unified engine's greedy tokens, one request at a time."""
    eng = JaxEngine(jparams, H, MAXLEN, n_slots=2, chunk=4,
                    kv_page_size=PS, kv_pages=32)
    out = []
    for p in ps:
        rid = eng.submit(p, max_new)
        eng.run()
        out.append([int(t) for t in eng.results[rid]])
    return out


def paths_close(doc, ref):
    assert [e["key"] for e in doc["entries"]] == \
        [e["key"] for e in ref["entries"]]
    for e, r in zip(doc["entries"], ref["entries"]):
        for side in ("k", "v"):
            np.testing.assert_allclose(np.asarray(e[side]),
                                       np.asarray(r[side]),
                                       rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------- #
# Disaggregated serving across packages
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("prefill_pkg,decode_pkg",
                         [("jax", "torch"), ("torch", "jax")])
def test_cross_package_disagg_gives_jax_unified_tokens(
        jparams, tparams, prefill_pkg, decode_pkg):
    ps = prompts()
    want = unified_tokens(jparams, ps, 6)
    pre = worker(prefill_pkg, mk(prefill_pkg, jparams, tparams, "prefill"))
    dec = worker(decode_pkg, mk(decode_pkg, jparams, tparams, "decode"))
    client = tdisagg.DisaggClient([pre.endpoint], [dec.endpoint],
                                  page_size=PS, name="xpkg")
    try:
        got = [client.generate(p, 6) for p in ps]
        assert got == want
        assert client.stats["reprefills"] == 0
        # every shipped page was taken; a shared page already spliced by
        # an earlier request is skipped, not uploaded again
        assert client.stats["pages_sent"] >= \
            dec.engine.kv_stats["imported_pages"] > 0
        # the decode worker prefix-hit what it imported
        assert dec.engine.kv_stats["hit_tokens"] > 0
        # imported K/V within the window prefill's tolerance of the
        # receiving package's own prefill of the same prompt
        own = mk(decode_pkg, jparams, tparams)
        rid = own.submit(ps[0], 1)
        own.run()
        assert own.results[rid] == want[0][:1]
        with dec._elock:
            imported = dec.engine._kv.export_pages(ps[0])
        paths_close(imported, own._kv.export_pages(ps[0]))
    finally:
        client.close()
        pre.stop()
        dec.stop()


def test_page_frames_are_byte_equal(jparams, tparams):
    """The same page document encodes to the same KV_PAGE_XFER meta and
    payload in both packages, and the framed message bytes are equal; each
    package decodes the other's frame back to the same bits."""
    eng = mk("torch", jparams, tparams)
    p = prompts(1)[0]
    eng.submit(p, 1)
    eng.run()
    doc = eng._kv.export_pages(p)
    tmeta, tpay = tdisagg.encode_pages(doc)
    jmeta, jpay = jdisagg.encode_pages(doc)
    assert tmeta == jmeta and tpay == jpay
    assert tprotocol.pack_message(tprotocol.Cmd.KV_PAGE_XFER, tmeta, tpay) \
        == jprotocol.pack_message(jprotocol.Cmd.KV_PAGE_XFER, jmeta, jpay)
    for dec in (tdisagg.decode_pages(jmeta, jpay),
                jdisagg.decode_pages(tmeta, tpay)):
        assert dec["entries"] and [e["key"] for e in dec["entries"]] == \
            [e["key"] for e in doc["entries"]]
        for e, r in zip(dec["entries"], doc["entries"]):
            assert np.array_equal(e["k"], r["k"])
            assert np.array_equal(e["v"], r["v"])


# --------------------------------------------------------------------------- #
# Federation across packages
# --------------------------------------------------------------------------- #

_VOLATILE = ("ts",)


def _registries(met, hl, tr):
    reg = met.MetricsRegistry(enabled=True)
    reg.counter("nnstpu_query_requests_total", "Requests",
                ("element",)).labels("qc").inc(3)
    reg.gauge("nnstpu_serving_queue_depth", "Queued",
              ("engine",)).labels("lm").set(2.0)
    reg.histogram("nnstpu_serving_ttft_seconds", "TTFT",
                  ("engine",)).labels("lm").observe(0.012)
    return reg, hl.HealthRegistry(), tr.SpanStore()


def _push_doc(pkg, instance, seq=1):
    met, hl, tr, ofl = ((jmetrics, jhealth, jtracing, jobs_fleet)
                        if pkg == "jax" else
                        (tmetrics, thealth, ttracing, tobs_fleet))
    reg, hreg, store = _registries(met, hl, tr)
    return ofl.build_push(instance, "worker", seq, interval_s=2.0,
                          registry=reg, health_registry=hreg,
                          span_store=store, kv_prefix=["ab", "cd"],
                          checkpoints={"s1": 5}, endpoint="h:1")


def test_push_documents_equal_key_for_key():
    mine, ref = _push_doc("torch", "w:1"), _push_doc("jax", "w:1")
    assert sorted(mine) == sorted(ref)
    for k in ref:
        if k not in _VOLATILE:
            assert mine[k] == ref[k], k


def test_federated_metrics_text_equal_for_the_same_snapshots():
    """Each package's aggregator, fed both packages' documents, serves the
    same federated exposition."""
    docs = [_push_doc("torch", "w-port:1"), _push_doc("jax", "w-jax:1")]
    texts = []
    for ofl, met in ((tobs_fleet, tmetrics), (jobs_fleet, jmetrics)):
        agg = ofl.FleetAggregator(ttl_s=30.0, instance="agg:1")
        for d in docs:
            agg.ingest(json.loads(json.dumps(d)), via="wire")
        texts.append(agg.exposition(met.MetricsRegistry(enabled=True)))
    assert texts[0] == texts[1]
    assert 'instance="w-port:1"' in texts[0]
    assert 'instance="w-jax:1"' in texts[0]


@pytest.mark.parametrize("pusher_pkg", ["torch", "jax"])
def test_pushes_cross_packages_over_http(pusher_pkg):
    agg_pkg = "jax" if pusher_pkg == "torch" else "torch"
    aofl, astart, amet = ((jobs_fleet, jstart_exporter, jmetrics)
                          if agg_pkg == "jax" else
                          (tobs_fleet, start_exporter, tmetrics))
    pofl, pmet, phl, ptr = ((tobs_fleet, tmetrics, thealth, ttracing)
                            if pusher_pkg == "torch" else
                            (jobs_fleet, jmetrics, jhealth, jtracing))
    agg = aofl.enable_aggregator(ttl_s=30.0)
    with astart(port=0, registry=amet.MetricsRegistry(enabled=True)) as exp:
        reg, hreg, store = _registries(pmet, phl, ptr)
        psh = pofl.FleetPusher(url=f"http://127.0.0.1:{exp.port}",
                               interval_s=3600, instance="w-http:1",
                               registry=reg, health_registry=hreg,
                               span_store=store)
        try:
            assert psh.push_now() is True
        finally:
            psh.close()
        text = urllib.request.urlopen(exp.url, timeout=5).read().decode()
    snap = agg.snapshot()
    assert "w-http:1" in [i["instance"] for i in snap["instances"]]
    assert 'nnstpu_query_requests_total{element="qc",instance="w-http:1"' \
        in text


@pytest.mark.parametrize("pusher_pkg", ["torch", "jax"])
def test_pushes_cross_packages_over_the_wire(jparams, tparams, pusher_pkg):
    """An OBS_PUSH frame from one package's pusher, sent on the query wire
    to the other package's worker, lands in that process's aggregator."""
    agg_pkg = "jax" if pusher_pkg == "torch" else "torch"
    aofl = jobs_fleet if agg_pkg == "jax" else tobs_fleet
    pofl, pmet, phl, ptr, proto = (
        (tobs_fleet, tmetrics, thealth, ttracing, tprotocol)
        if pusher_pkg == "torch" else
        (jobs_fleet, jmetrics, jhealth, jtracing, jprotocol))
    agg = aofl.enable_aggregator(ttl_s=30.0)
    w = worker(agg_pkg, mk(agg_pkg, jparams, tparams))
    reg, hreg, store = _registries(pmet, phl, ptr)
    psh = pofl.FleetPusher(url=None, interval_s=0.05, instance="w-wire:1",
                           registry=reg, health_registry=hreg,
                           span_store=store)
    try:
        meta, payload = psh.wire_frame()
        with socket.create_connection(("127.0.0.1", w.port), timeout=5) \
                as sock:
            proto.send_message(sock, proto.Cmd.OBS_PUSH, meta, payload)
            proto.send_message(sock, proto.Cmd.PING, {})
            cmd, _, _ = proto.recv_message(sock)
            assert cmd.name == "PONG"
        snap = agg.snapshot()
        assert "w-wire:1" in [i["instance"] for i in snap["instances"]]
        assert agg.routing_view()["w-wire:1"]["queue_depth"] == 2.0
    finally:
        psh.close()
        w.stop()


# --------------------------------------------------------------------------- #
# Checkpoints across packages
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("builder", ["torch", "jax"])
def test_checkpoint_blob_crosses_packages(jparams, tparams, builder):
    eng = mk(builder, jparams, tparams)
    p = prompts(1)[0]
    rid = eng.submit(p, 3, session="s-x")
    eng.run()
    path, doc = eng.checkpoint_session("s-x")
    build = (jckpt if builder == "jax" else tckpt).build_blob
    blob = build("s-x", int(path.size), path, doc)
    other = tckpt if builder == "jax" else jckpt
    assert blob == (other.build_blob("s-x", int(path.size), path, doc))
    got = other.parse_blob(blob)
    own = (jckpt if builder == "jax" else tckpt).parse_blob(blob)
    assert got["session"] == own["session"] == "s-x"
    assert got["seq"] == own["seq"] == int(path.size)
    assert list(got["path"]) == list(own["path"])
    head = json.loads(blob.partition(b"\n")[0])
    assert head["digest"] == other._digest(
        {k: v for k, v in head.items() if k != "digest"},
        blob.partition(b"\n")[2])
    for e, r in zip(got["doc"]["entries"], own["doc"]["entries"]):
        assert e["key"] == r["key"]
        assert np.array_equal(e["k"], r["k"])
        assert np.array_equal(e["v"], r["v"])
    assert eng.results[rid]
    # a corrupted byte is refused by both parsers
    bad = blob[:-1] + bytes([blob[-1] ^ 1])
    for mod in (tckpt, jckpt):
        with pytest.raises(ValueError):
            mod.parse_blob(bad)


def _lm_dispatch(router, prompt, session, max_new=6):
    rmeta, _ = router.dispatch(
        {"lm": {"prompt": [int(x) for x in prompt], "max_new": max_new,
                "session": session}}, b"", session=session)
    return [int(t) for t in rmeta.get("tokens", [])]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_local_dir_store_restores_across_packages(jparams, tparams, tmp_path,
                                                  writer):
    """One package's daemon checkpoints into a LocalDirStore; its worker
    dies; the other package's SessionRestorer re-homes the session on its
    own worker, which reads the same directory, and the next turn rides the
    spliced pages with the uninterrupted run's tokens."""
    reader = "torch" if writer == "jax" else "jax"
    ck_w = jckpt if writer == "jax" else tckpt
    ck_r = jckpt if reader == "jax" else tckpt
    w0 = worker(writer, mk(writer, jparams, tparams))
    w1 = worker(reader, mk(reader, jparams, tparams))
    w1.attach_checkpoint_store(ck_r.LocalDirStore(str(tmp_path)))
    qr = QueryRouter(BackendSet([(w0.host, w0.port), (w1.host, w1.port)],
                                "xrs"), "xrs")
    qr.set_caps_provider(lambda: tdisagg.LM_CAPS)
    try:
        p = prompts(1)[0]
        qr.backends.pin_session("rs-x", w0.endpoint)
        toks = _lm_dispatch(qr, p, "rs-x")
        daemon = ck_w.CheckpointDaemon(
            w0.engine, ck_w.LocalDirStore(str(tmp_path)), lock=w0._elock,
            name="xrs")
        assert daemon.run_once() == 1
        w0.kill()
        restorer = (jckpt if reader == "jax" else tckpt).SessionRestorer(qr)
        report = restorer.restore_instance(w0.instance, w0.endpoint,
                                           daemon.watermarks())
        assert report["restored"] == 1 and report["re_prefilled"] == 0
        assert "rs-x" in w1.engine._restored_sessions
        hit0 = w1.engine.kv_stats["hit_tokens"]
        assert _lm_dispatch(qr, p, "rs-x") == toks
        assert w1.engine.kv_stats["hit_tokens"] > hit0
    finally:
        qr.close()
        w0.stop()
        w1.stop()


# --------------------------------------------------------------------------- #
# Migration across packages
# --------------------------------------------------------------------------- #

def test_session_migrates_jax_to_port_and_back(jparams, tparams):
    """JAX worker → port worker → another JAX worker (a migrated-away
    session stays frozen on its source, as in the JAX fleet, where the
    source is drained): every turn equals the JAX unified engine's."""
    wj = worker("jax", mk("jax", jparams, tparams))
    wt = worker("torch", mk("torch", jparams, tparams))
    wj2 = worker("jax", mk("jax", jparams, tparams))
    ws = (wj, wt, wj2)
    qr = QueryRouter(BackendSet([(w.host, w.port) for w in ws], "xmig"),
                     "xmig")
    qr.set_caps_provider(lambda: tdisagg.LM_CAPS)
    rng = np.random.default_rng(3)
    try:
        turns, p = [], prompts(1)[0]
        qr.backends.pin_session("mx", wj.endpoint)
        mig = SessionMigrator(qr)
        homes = []
        for turn, w in enumerate(ws):
            out = _lm_dispatch(qr, p, "mx", max_new=4)
            turns.append((p, out))
            homes.append(qr.backends.pick(session="mx").endpoint)
            if turn + 1 < len(ws):
                res = mig.migrate("mx", qr.backends.get(w.endpoint),
                                  qr.backends.get(ws[turn + 1].endpoint))
                assert res["ok"] and not res["absorbed"] and res["pages"]
            p = np.concatenate([p, np.asarray(out, np.int32),
                                rng.integers(0, V, 3).astype(np.int32)])
        assert homes == [w.endpoint for w in ws]
        want = unified_tokens(jparams, [t[0] for t in turns], 4)
        assert [t[1] for t in turns] == want
        assert mig.stats["migrated"] == 2
        # the migrated pages carried each turn's prefix: both targets hit
        assert wt.engine.kv_stats["hit_tokens"] > 0
        assert wj2.engine.kv_stats["hit_tokens"] > 0
    finally:
        qr.close()
        for w in ws:
            w.stop()


# --------------------------------------------------------------------------- #
# Autoscale policies
# --------------------------------------------------------------------------- #

class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _signals(rng, n):
    out = []
    for _ in range(n):
        out.append({
            "replicas": int(rng.integers(1, 5)),
            "queue_depth": float(rng.choice([0.0, 1.0, 6.0, 40.0])),
            "occupancy": float(rng.choice([0.05, 0.5, 0.95])),
            "breached": ["rt"] if rng.random() < 0.2 else [],
            "victim_sessions": int(rng.choice([0, 10, 100])),
        })
    return out


@pytest.mark.parametrize("policy", ["default", "priced"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_policy_decisions_equal_jax(policy, seed):
    rng = np.random.default_rng(seed)
    sigs = _signals(rng, 60)
    steps = rng.uniform(0.0, 20.0, len(sigs))
    decisions = []
    for mod in (tautoscale, jautoscale):
        clk = _Clock()
        pol = mod.POLICIES[policy](1, 4, clock=clk)
        seq = []
        for s, dt in zip(sigs, steps):
            clk.t += float(dt)
            d = pol.decide(dict(s))
            seq.append((d.action, d.count, d.reason))
        decisions.append(seq)
    assert decisions[0] == decisions[1]
    assert {a for a, _, _ in decisions[0]} - {"hold"}
    assert tautoscale.parse_autoscale_spec("1:3:priced") == \
        jautoscale.parse_autoscale_spec("1:3:priced")


# --------------------------------------------------------------------------- #
# The CLI with every fleet flag
# --------------------------------------------------------------------------- #

def test_cli_fleet_flags_run_as_jax(tmp_path, capsys, monkeypatch):
    """--role decode --kv-page-size, --obs-push wire, --obs-aggregate with
    --metrics-port and --checkpoint-dir on a CPU pipeline: exit 0 in both
    CLIs, the same ``fleet:`` lines but the instance ids and ports, and the
    same environment for the engines the run would build."""
    from nnstreamer_tpu.cli import main as jax_main
    from nnstreamer_tpu_torch.cli import main

    monkeypatch.chdir(tmp_path)
    argv = ["--role", "decode", "--kv-page-size", "32", "--obs-push", "wire",
            "--obs-aggregate", "--metrics-port", "0", "--checkpoint-dir",
            str(tmp_path / "ck"), "--checkpoint-interval", "2",
            "videotestsrc num-buffers=2 ! tensor_sink"]
    runs = []
    for m, pre in ((main, ["--device", "cpu"]), (jax_main, [])):
        code = m(pre + argv)
        err = capsys.readouterr().err
        env = {k: os.environ.pop(k, None) for k in (
            "NNS_LM_ROLE", "NNS_LM_KV_PAGE_SIZE", "NNS_FLEET_CKPT_DIR",
            "NNS_FLEET_CKPT_INTERVAL")}
        lines = [ln.split(" as ")[0] for ln in err.splitlines()
                 if ln.startswith("fleet:")]
        runs.append((code, lines, env))
    assert runs[0] == runs[1]
    assert runs[0][0] == 0
    assert runs[0][1] == ["fleet: aggregating", "fleet: pushing"]
    assert tobs_fleet.aggregator() is None and tobs_fleet.pusher() is None


# --------------------------------------------------------------------------- #
# The Perfetto fleet group
# --------------------------------------------------------------------------- #

def test_perfetto_fleet_group_as_jax():
    """fleet.* spans (a migration, a restore) land in the timeline's pid 6
    group, one lane an operation, as in the JAX profiler's timeline."""
    from nnstreamer_tpu.obs import profile as jprofile
    from nnstreamer_tpu_torch.obs import profile as tprofile

    spans = [{"tid": "t1", "sid": f"s{i}", "par": None, "name": name,
              "wall": 1000.0 + i, "dur_ns": 5000 * (i + 1),
              "attrs": {"session": f"x{i}"}}
             for i, name in enumerate(("fleet.migrate", "fleet.restore",
                                       "fleet.migrate"))]
    groups = []
    for tr, prof in ((ttracing, tprofile), (jtracing, jprofile)):
        store = tr.SpanStore()
        assert store.ingest_remote(spans, "w:1") == 3
        doc = prof.perfetto_trace(span_store=store)
        groups.append(sorted(
            (e["ph"], e["name"], e.get("tid"), e.get("dur"),
             json.dumps(e.get("args"), sort_keys=True))
            for e in doc["traceEvents"] if e.get("pid") == 6))
    assert groups[0] == groups[1]
    assert ("M", "process_name", 0, None, '{"name": "fleet"}') in groups[0]
    assert sum(1 for g in groups[0] if g[0] == "X") == 3
