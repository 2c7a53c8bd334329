"""The port's tune/ against the JAX package's.

Every case of tests/test_tune.py, run against ``nnstreamer_tpu_torch``
(store roundtrip and merge semantics, cost-model determinism, the tuner's
resolution order store → model → bounded sweep → default, the
zero-overhead-when-off contract, the fleet federation: the store in push
docs, the aggregator's lowest-cost tuned view, adoption on a push-ack over
HTTP; /debug/tune); then the port's knob sites (flash's launch configuration
with its capture rule, the LM engine's chunk, page size and draft length,
the filter's bucket rung) and parity: a store written by one package
loads in the other and gives the same picks. The ``cuda`` cases hold each
flash launch configuration against the plain version and a tuner pick
made during a CUDA-graph capture; they skip without a card.
"""

import json
import urllib.request

import numpy as np
import pytest
import torch

from nnstreamer_tpu_torch import tune
from nnstreamer_tpu_torch.core import graphs
from nnstreamer_tpu_torch.ops.kernels import flash_attention as fa
from nnstreamer_tpu_torch.obs import fleet as obs_fleet
from nnstreamer_tpu_torch.obs import health as obs_health
from nnstreamer_tpu_torch.obs.exporter import start_exporter
from nnstreamer_tpu_torch.obs.fleet import (FleetAggregator, FleetPusher,
                                            build_push)
from nnstreamer_tpu_torch.obs.metrics import MetricsRegistry
from nnstreamer_tpu_torch.obs.tracing import SpanStore
from nnstreamer_tpu_torch.tune.model import CostModel
from nnstreamer_tpu_torch.tune.store import MAX_PUSH_ENTRIES, TuneStore
from nnstreamer_tpu_torch.tune.tuner import Tuner, shape_sig


@pytest.fixture
def tune_off_after():
    """Whatever a test installs on the module hooks, put it back."""
    yield tune
    tune.disable(save=False)
    obs_fleet.TUNE_PUSH_HOOK = None
    obs_fleet.TUNE_ADOPT_HOOK = None


def worker_push(instance, seq=1, tune_doc=None):
    """A synthetic worker push built through the real build_push path
    (private registries), with an optional tune slice attached."""
    doc = build_push(instance, "worker", seq, interval_s=2.0,
                     registry=MetricsRegistry(enabled=True),
                     health_registry=obs_health.HealthRegistry(),
                     span_store=SpanStore())
    if tune_doc is not None:
        doc["tune"] = tune_doc
    return doc


def _samples(device="cpu", label="f", rows=((1e6, 1e4, 50.0),
                                            (2e6, 2e4, 95.0),
                                            (4e6, 4e4, 190.0))):
    """Profiler-shaped sample rows: cost grows with flops+bytes so the
    fit is well-posed (positive coefficients)."""
    return [{"label": label, "device": device, "flops": f, "bytes": b,
             "mean_device_us": c} for f, b, c in rows]


# --------------------------------------------------------------------------- #
# Store
# --------------------------------------------------------------------------- #

class TestStore:
    def test_roundtrip(self, tmp_path):
        p = str(tmp_path / "t.json")
        s = TuneStore(p)
        s.put("cpu", "flash", "b8.l2048", "flash_blocks",
              [512, 1024], "sweep", cost_us=42.5)
        s.put("cpu", "lm", "s4.l256", "lm_chunk", 16, "model")
        assert s.dirty
        assert s.save() == p
        assert not s.dirty

        s2 = TuneStore(p)
        rec = s2.get("cpu", "flash", "b8.l2048", "flash_blocks")
        assert rec["value"] == [512, 1024]
        assert rec["source"] == "sweep"
        assert rec["cost_us"] == 42.5
        assert s2.get("cpu", "lm", "s4.l256", "lm_chunk")["value"] == 16
        assert not s2.dirty

    def test_unsupported_version_raises(self, tmp_path):
        p = tmp_path / "bad.json"
        p.write_text(json.dumps({"version": 99, "entries": {}}))
        with pytest.raises(ValueError, match="version"):
            TuneStore(str(p))

    def test_merge_adopts_absent_and_lower_cost_only(self):
        s = TuneStore()
        s.put("cpu", "flash", "sig", "k", 512, "sweep", cost_us=10.0)
        doc = {"version": 1, "entries": {
            # absent locally -> adopted
            "cpu|lm|sig|chunk": {"value": 16, "source": "sweep",
                                 "cost_us": 5.0, "ts": 1.0},
            # worse measured cost -> kept out
            "cpu|flash|sig|k": {"value": 128, "source": "sweep",
                                "cost_us": 50.0, "ts": 2.0}}}
        assert s.merge_doc(doc) == 1
        assert s.get("cpu", "lm", "sig", "chunk")["source"] == "fleet"
        assert s.get("cpu", "flash", "sig", "k")["value"] == 512

        # strictly lower measured cost -> replaces the local sweep
        better = {"version": 1, "entries": {
            "cpu|flash|sig|k": {"value": 256, "cost_us": 4.0, "ts": 3.0}}}
        assert s.merge_doc(better) == 1
        rec = s.get("cpu", "flash", "sig", "k")
        assert rec["value"] == 256 and rec["source"] == "fleet"

        # unmeasured remote never displaces a measured local
        unmeasured = {"version": 1, "entries": {
            "cpu|flash|sig|k": {"value": 64, "ts": 9.0}}}
        assert s.merge_doc(unmeasured) == 0
        assert s.merge_doc("junk") == 0
        assert s.merge_doc({"entries": "junk"}) == 0

    def test_push_doc_caps_entries_newest_first(self):
        s = TuneStore()
        for i in range(MAX_PUSH_ENTRIES + 10):
            rec = s.put("cpu", "l", f"s{i}", "k", i, "sweep")
            rec["ts"] = float(i)  # deterministic ordering
        doc = s.to_doc()
        assert len(doc["entries"]) == MAX_PUSH_ENTRIES
        # the oldest 10 fell off, the newest survived
        assert "cpu|l|s0|k" not in doc["entries"]
        assert f"cpu|l|s{MAX_PUSH_ENTRIES + 9}|k" in doc["entries"]


def test_shape_sig():
    assert shape_sig(("b", 8), ("l", 2048)) == "b8.l2048"
    assert shape_sig(("rung", 64)) == "rung64"


# --------------------------------------------------------------------------- #
# Cost model
# --------------------------------------------------------------------------- #

class TestCostModel:
    def test_fit_is_deterministic(self):
        rows = _samples()
        m1, m2 = CostModel(), CostModel()
        assert m1.fit(rows) == 1
        assert m2.fit(list(rows)) == 1
        assert m1.covers("cpu", "f")
        for fl, by in ((1e6, 1e4), (3e6, 3e4), (8e6, 8e4)):
            assert m1.predict("cpu", "f", fl, by) \
                == m2.predict("cpu", "f", fl, by)

    def test_negative_coefficient_means_no_coverage(self):
        # more work measured as FASTER: samples do not span the
        # feature — ranking on this fit would invert candidate order
        rows = _samples(rows=((1e6, 0.0, 100.0), (2e6, 0.0, 50.0),
                              (4e6, 0.0, 25.0)))
        m = CostModel()
        assert m.fit(rows) == 0
        assert not m.covers("cpu", "f")
        assert m.predict("cpu", "f", 1e6, 0.0) is None

    def test_too_few_samples_means_no_coverage(self):
        m = CostModel()
        assert m.fit(_samples(rows=((1e6, 1e4, 50.0),))) == 0
        assert not m.covers("cpu", "f")


# --------------------------------------------------------------------------- #
# Tuner resolution order
# --------------------------------------------------------------------------- #

class TestTunerResolution:
    def test_model_pick_deterministic_across_instances(self):
        """Same samples + same candidates → same config across two
        independent tuners — and the second ask on either is a store
        hit."""
        rows = _samples()

        def features(cand):
            # candidate = multiplier on traffic; flops fixed
            return (1e6, 1e4 * cand)

        picks = []
        for _ in range(2):
            tn = Tuner(store=TuneStore())
            tn.fit(rows)
            v = tn.pick("k", "cpu", "f", "sig", candidates=(4, 2, 1, 8),
                        default=4, features=features)
            picks.append(v)
            assert tn.stats["model_picks"] == 1
            # second ask: resolved from the store, model not consulted
            assert tn.pick("k", "cpu", "f", "sig", candidates=(4, 2, 1, 8),
                           default=4, features=features) == v
            assert tn.stats["store_hits"] == 1
        assert picks[0] == picks[1] == 1  # least traffic wins

    def test_sweep_is_bounded_and_cached(self):
        calls = []

        def measure(cand):
            calls.append(cand)
            return float(cand)  # smaller candidate = faster

        tn = Tuner(store=TuneStore(), max_trials=4, measure_repeats=1)
        v = tn.pick("k", "cpu", "f", "sig",
                    candidates=(9, 3, 7, 5, 2, 1, 8, 6, 4, 10),
                    default=9, measure=measure)
        assert v == 3  # best of the FIRST max_trials candidates only
        assert len(calls) == 4
        assert tn.stats["trials"] == 4
        rec = tn.store.get("cpu", "f", "sig", "k")
        assert rec["source"] == "sweep" and rec["cost_us"] == 3e6

        # warm ask: store hit, zero further measurement
        assert tn.pick("k", "cpu", "f", "sig", candidates=(9, 3),
                       default=9, measure=measure) == 3
        assert len(calls) == 4
        assert tn.stats["sweeps"] == 1

    def test_sweep_total_failure_falls_back_to_default(self):
        def broken(cand):
            raise RuntimeError("no device")

        tn = Tuner(store=TuneStore(), measure_repeats=1)
        assert tn.pick("k", "cpu", "f", "sig", candidates=(1, 2),
                       default=7, measure=broken) == 7
        assert tn.stats["defaults"] == 1
        assert tn.store.get("cpu", "f", "sig", "k") is None  # may retry

    def test_measured_tie_breaks_by_candidate_order(self):
        tn = Tuner(store=TuneStore(), measure_repeats=1)
        v = tn.pick("k", "cpu", "f", "sig", candidates=(5, 3, 8),
                    default=8, measure=lambda c: 1.0)
        assert v == 5

    def test_observe_persists_like_a_sweep(self):
        tn = Tuner(store=TuneStore())
        tn.observe("lm_spec_draft", "cpu", "serving.lm", "s4", 6)
        assert tn.pick("lm_spec_draft", "cpu", "serving.lm", "s4",
                       candidates=(), default=4) == 6
        assert tn.stats["store_hits"] == 1


# --------------------------------------------------------------------------- #
# Zero overhead when off
# --------------------------------------------------------------------------- #

class TestTuneOff:
    def test_flash_blocks_default_without_hook(self, tune_off_after):
        """TUNE_HOOK is None → the flash call site takes its default
        launch configuration (0) without measuring, building tensors, or
        touching a store."""
        from nnstreamer_tpu_torch.ops.kernels import flash_attention as fa

        assert tune.TUNE_HOOK is None
        # a None operand proves the gate short-circuits before any shape
        # inspection — the hook check is the FIRST thing in the helper
        assert fa._tuned_config(None, False, "wgmma", (128, 64)) == 0

    def test_push_doc_unchanged_without_hook(self, tune_off_after):
        assert obs_fleet.TUNE_PUSH_HOOK is None
        assert worker_push("w1:1").get("tune") is None

    def test_enable_disable_lifecycle(self, tmp_path, tune_off_after):
        p = str(tmp_path / "store.json")
        tn = tune.enable(p, fit_from_profiler=False)
        assert tune.enabled() and tune.tuner() is tn
        assert tune.enable(p) is tn  # idempotent
        assert obs_fleet.TUNE_PUSH_HOOK == tn.push_doc
        assert obs_fleet.TUNE_ADOPT_HOOK == tn.adopt
        tn.store.put("cpu", "f", "sig", "k", 1, "sweep")
        tune.disable()
        assert not tune.enabled()
        assert obs_fleet.TUNE_PUSH_HOOK is None
        assert obs_fleet.TUNE_ADOPT_HOOK is None
        # disable persisted the dirty store
        assert TuneStore(p).get("cpu", "f", "sig", "k")["value"] == 1


# --------------------------------------------------------------------------- #
# Fleet federation
# --------------------------------------------------------------------------- #

class TestFleetFederation:
    def test_push_doc_carries_store(self, tune_off_after):
        tn = Tuner(store=TuneStore())
        tn.store.put("cpu", "flash", "sig", "k", [512, 1024], "sweep",
                     cost_us=10.0)
        obs_fleet.TUNE_PUSH_HOOK = tn.push_doc
        doc = worker_push("w1:1")
        assert doc["tune"]["entries"]["cpu|flash|sig|k"]["value"] \
            == [512, 1024]

    def test_tuned_view_merges_lowest_cost(self):
        agg = FleetAggregator(span_store=SpanStore())
        agg.ingest(worker_push("w1:1", tune_doc={"version": 1, "entries": {
            "cpu|f|s|k": {"value": 512, "cost_us": 20.0, "ts": 1.0},
            "cpu|f|s|k2": {"value": 1, "ts": 1.0}}}))
        agg.ingest(worker_push("w2:1", tune_doc={"version": 1, "entries": {
            "cpu|f|s|k": {"value": 256, "cost_us": 5.0, "ts": 0.5},
            "cpu|f|s|k2": {"value": 2, "ts": 2.0}}}))
        view = agg.tuned_view()
        # measured: lowest cost wins regardless of age
        assert view["entries"]["cpu|f|s|k"]["value"] == 256
        # both unmeasured: newest ts wins
        assert view["entries"]["cpu|f|s|k2"]["value"] == 2

    def test_tuned_view_none_before_any_tune_push(self):
        agg = FleetAggregator(span_store=SpanStore())
        agg.ingest(worker_push("w1:1"))
        assert agg.tuned_view() is None

    def test_adoption_skips_the_sweep(self, tune_off_after):
        """A fresh instance that adopted the fleet's config must answer
        from the store — its measure closure never runs."""
        agg = FleetAggregator(span_store=SpanStore())
        agg.ingest(worker_push("w1:1", tune_doc={"version": 1, "entries": {
            "cpu|f|sig|k": {"value": 3, "cost_us": 2.0, "ts": 1.0}}}))
        fresh = Tuner(store=TuneStore())
        assert fresh.adopt(agg.tuned_view()) == 1
        assert fresh.stats["adopted"] == 1

        def never(cand):
            raise AssertionError("sweep ran despite fleet adoption")

        assert fresh.pick("k", "cpu", "f", "sig", candidates=(1, 2, 3),
                          default=1, measure=never) == 3

    def test_push_ack_adoption_over_http(self, tune_off_after):
        """The real loop: aggregator already knows a tuned config, a
        fresh worker's FIRST push-ack delivers it into the worker's
        store via TUNE_ADOPT_HOOK."""
        agg = obs_fleet.enable_aggregator(ttl_s=30.0)
        try:
            agg.ingest(worker_push("w1:1", tune_doc={
                "version": 1, "entries": {
                    "cpu|flash|sig|k": {"value": [512, 1024],
                                        "cost_us": 7.0, "ts": 1.0}}}))
            fresh = Tuner(store=TuneStore())
            obs_fleet.TUNE_PUSH_HOOK = fresh.push_doc
            obs_fleet.TUNE_ADOPT_HOOK = fresh.adopt
            with start_exporter(port=0,
                                registry=MetricsRegistry(enabled=True)) as exp:
                psh = FleetPusher(
                    url=f"http://127.0.0.1:{exp.port}", interval_s=3600,
                    instance="w2:1",
                    registry=MetricsRegistry(enabled=True),
                    health_registry=obs_health.HealthRegistry(),
                    span_store=SpanStore())
                try:
                    assert psh.push_now() is True
                finally:
                    psh.close()
            rec = fresh.store.get("cpu", "flash", "sig", "k")
            assert rec is not None
            assert rec["value"] == [512, 1024] and rec["source"] == "fleet"
        finally:
            obs_fleet.disable_aggregator()

    def test_debug_tune_route(self, tune_off_after, tmp_path):
        tn = tune.enable(str(tmp_path / "s.json"), fit_from_profiler=False)
        tn.store.put("cpu", "f", "sig", "k", 1, "sweep", cost_us=3.0)
        with start_exporter(port=0,
                            registry=MetricsRegistry(enabled=True)) as exp:
            url = f"http://127.0.0.1:{exp.port}/debug/tune"
            with urllib.request.urlopen(url, timeout=5) as r:
                body = json.loads(r.read())
        assert body["enabled"] is True
        assert "cpu|f|sig|k" in body["local"]["entries"]


# --------------------------------------------------------------------------- #
# The port's knob sites
# --------------------------------------------------------------------------- #

def test_device_kind_names_the_card_or_cpu():
    want = torch.cuda.get_device_name() if torch.cuda.is_available() \
        else "cpu"
    assert tune.device_kind() == want


@pytest.mark.parametrize("route,d,want", [
    ("wgmma", 64, (128, 64)), ("wgmma", 128, (64,)),
    ("tf32x3", 16, (2, 1)), ("tf32x3", 64, (2, 1)),
    ("tf32x3", 100, (1,)), ("tf32x3", 300, (1,))])
def test_flash_launch_configs_default_first(route, d, want):
    assert fa.launch_configs(route, d) == want


def _q(dtype=torch.bfloat16):
    return torch.zeros((2, 4, 256, 64), dtype=dtype)


def test_flash_pick_inside_a_capture_never_sweeps(tune_off_after,
                                                  monkeypatch):
    """While a capture records, the flash site's pick reads the store alone:
    a miss takes the default and is counted, no trial runs, nothing raises,
    nothing is stored (a later eager call may still sweep)."""
    tn = tune.enable(None, fit_from_profiler=False)
    tn.store = TuneStore()
    trials = []
    monkeypatch.setattr(fa, "_trial_s", lambda *a: trials.append(a) or 1.0)
    monkeypatch.setattr(graphs, "capturing", lambda: True)
    before = fa.flash_attention.tune_capture_defaults
    assert fa._tuned_config(_q(), True, "wgmma", (128, 64)) == 128
    assert fa.flash_attention.tune_capture_defaults == before + 1
    assert trials == [] and len(tn.store) == 0
    assert tn.stats["sweeps"] == 0 and tn.stats["defaults"] == 1


def test_flash_sweeps_outside_a_capture_then_reads_the_store(
        tune_off_after, monkeypatch):
    """Eagerly (a CapturedFn's warm-up) the site sweeps every configuration
    through the measure closure and stores the fastest; the capture that
    follows finds it in the store and counts no default."""
    tn = tune.enable(None, fit_from_profiler=False)
    tn.store = TuneStore()
    times = {128: 3e-5, 64: 2e-5}
    trials = []

    def trial(q, causal, route, cfg):
        assert not graphs.capturing()
        trials.append(cfg)
        return times[cfg]

    monkeypatch.setattr(fa, "_trial_s", trial)
    assert fa._tuned_config(_q(), True, "wgmma", (128, 64)) == 64
    assert sorted(set(trials)) == [64, 128]
    assert len(trials) == 2 * tn.measure_repeats
    key = tune.device_kind(), "cuda.flash_attention.wgmma"
    sig = shape_sig(("b", 2), ("h", 4), ("l", 256), ("d", 64), ("c", 1),
                    ("t", "bfloat16"))
    assert tn.store.get(*key, sig, "flash_launch")["value"] == 64
    monkeypatch.setattr(graphs, "capturing", lambda: True)
    before = fa.flash_attention.tune_capture_defaults
    assert fa._tuned_config(_q(), True, "wgmma", (128, 64)) == 64
    assert fa.flash_attention.tune_capture_defaults == before
    assert len(trials) == 2 * tn.measure_repeats


def test_flash_single_config_never_asks(tune_off_after, monkeypatch):
    tn = tune.enable(None, fit_from_profiler=False)
    monkeypatch.setattr(fa, "_trial_s", lambda *a: pytest.fail("swept"))
    assert fa._tuned_config(_q(), True, "wgmma", (64,)) == 0
    assert tn.stats["picks"] == 0


def test_flash_on_cpu_tensors_is_the_plain_version_with_the_tuner_on(
        tune_off_after):
    tn = tune.enable(None, fit_from_profiler=False)
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 70, 16))
                                .astype(np.float32)) for _ in range(3))
    torch.testing.assert_close(fa.flash_attention(q, k, v),
                               fa.flash_attention_plain(q, k, v))
    assert tn.stats["picks"] == 0


def _lm_params():
    import jax

    from nnstreamer_tpu.models import causal_lm as jax_lm
    from nnstreamer_tpu_torch.models import convert

    return convert.causal_lm_params(jax.tree_util.tree_map(
        np.asarray, jax_lm.init_causal_lm(jax.random.PRNGKey(3), 61, 32, 4,
                                          2, 64)), "cpu")


def test_lm_engine_construction_picks_from_the_store_and_never_sweeps(
        tune_off_after, monkeypatch):
    """Building an engine with the tuner on runs nothing: the chunk (and,
    given a page budget without a page size, the page size) come from the
    store, or the hand-set defaults on a miss."""
    from nnstreamer_tpu_torch.serving import LMEngine

    params = _lm_params()
    tn = tune.enable(None, fit_from_profiler=False)
    tn.store = TuneStore()
    monkeypatch.delenv("NNS_LM_KV_PAGE_SIZE", raising=False)
    eng = LMEngine(params, 4, 64, n_slots=2, kv_pages=16, device="cpu")
    assert eng.chunk == 8 and eng._kv.page_size == 64
    assert tn.stats["defaults"] == 2 and tn.stats["sweeps"] == 0
    dev = tune.device_kind()
    tn.store.put(dev, "serving.lm", shape_sig(("slots", 2), ("len", 64),
                                              ("heads", 4)),
                 "lm_chunk", 16, "sweep")
    tn.store.put(dev, "serving.lm", shape_sig(("len", 64), ("heads", 4)),
                 "lm_kv_page_size", 16, "sweep")
    eng = LMEngine(params, 4, 64, n_slots=2, kv_pages=16, device="cpu")
    assert eng.chunk == 16 and eng._kv.page_size == 16
    assert tn.stats["store_hits"] == 2 and tn.stats["trials"] == 0
    # explicit arguments win and ask nothing
    picks = tn.stats["picks"]
    LMEngine(params, 4, 64, n_slots=2, chunk=4, kv_page_size=0,
             device="cpu")
    assert tn.stats["picks"] == picks


def test_spec_draft_retune_observes_the_accept_rate(tune_off_after):
    from nnstreamer_tpu_torch.serving import LMEngine

    tn = tune.enable(None, fit_from_profiler=False)
    tn.store = TuneStore()
    eng = LMEngine(_lm_params(), 4, 64, n_slots=1, chunk=4, spec_draft=3,
                   device="cpu")
    eng.stats.update(spec_iterations=32, spec_drafted=96, spec_accepted=90)
    eng._retune_spec_draft()
    assert eng.spec_draft != 3
    rec = tn.store.get(tune.device_kind(), "serving.lm",
                       shape_sig(("len", 64)), "lm_spec_draft")
    assert rec["value"] == eng.spec_draft and rec["source"] == "observed"


def test_bucket_rung_pick_from_the_store(tune_off_after):
    """The filter's bucket ladder asks the tuner for the rung (store or
    model only): a miss keeps the minimal rung, a stored rung one up pads
    to it; outputs are the same rows either way."""
    from nnstreamer_tpu_torch.core.buffer import TensorMemory
    from nnstreamer_tpu_torch.filters.base import FilterProps
    from nnstreamer_tpu_torch.filters.torch_cuda import TorchCudaFilter

    sizes = []

    def model(x):
        sizes.append(x.shape[0])
        return x + 1.0

    f = TorchCudaFilter()
    f.open(FilterProps(model=model, custom="bucket=2,bucket_max=8",
                       device=torch.device("cpu")))
    inputs = [TensorMemory(np.full((3,), i, np.float32)) for i in range(3)]
    want = np.stack([np.full((3,), i + 1.0, np.float32) for i in range(3)])
    tn = tune.enable(None, fit_from_profiler=False)
    tn.store = TuneStore()
    np.testing.assert_array_equal(f.invoke(inputs)[0].host(), want)
    label = f._bundle.name if f._bundle else "xla"
    tn.store.put(tune.device_kind(), label, shape_sig(("rung", 4)),
                 "xla_bucket_rung", 8, "sweep")
    np.testing.assert_array_equal(f.invoke(inputs)[0].host(), want)
    assert sizes == [4, 8]
    assert tn.stats["defaults"] == 1 and tn.stats["store_hits"] == 1


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_store_crosses_packages_with_equal_picks(writer, tmp_path):
    """A store written by one package loads in the other, and both tuners
    pick the same values from it (sweep, model and observed records), the
    warm store making no trial."""
    from nnstreamer_tpu.tune.store import TuneStore as JaxStore
    from nnstreamer_tpu.tune.tuner import Tuner as JaxTuner

    stores = {"jax": (JaxStore, JaxTuner), "torch": (TuneStore, Tuner)}
    path = str(tmp_path / "store.json")
    store_cls, tuner_cls = stores[writer]
    tn = tuner_cls(store=store_cls(path), measure_repeats=1)
    tn.fit(_samples())
    tn.pick("k", "cpu", "f", "s1", candidates=(4, 2, 1), default=4,
            features=lambda c: (1e6, 1e4 * c))
    tn.pick("flash_launch", "NVIDIA H100", "cuda.flash_attention.wgmma",
            "b8.l1024", candidates=(128, 64), default=128,
            measure=lambda c: c * 1e-6)
    tn.observe("lm_spec_draft", "cpu", "serving.lm", "len64", 5)
    tn.store.save()

    def never(c):
        raise AssertionError("warm store swept")

    picks = {}
    for name, (scls, tcls) in stores.items():
        t = tcls(store=scls(path))
        picks[name] = [
            t.pick("k", "cpu", "f", "s1", candidates=(4, 2, 1), default=4),
            t.pick("flash_launch", "NVIDIA H100",
                   "cuda.flash_attention.wgmma", "b8.l1024",
                   candidates=(128, 64), default=128, measure=never),
            t.pick("lm_spec_draft", "cpu", "serving.lm", "len64",
                   candidates=(), default=4)]
        assert t.stats["trials"] == 0 and t.stats["store_hits"] == 3
    assert picks["torch"] == picks["jax"] == [1, 64, 5]


# --------------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------------- #

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


_CASES = [((8, 16, 1024, 64), torch.bfloat16, True),
          ((8, 16, 1024, 64), torch.float32, True),
          ((2, 3, 200, 16), torch.float32, False),
          ((1, 2, 130, 128), torch.bfloat16, True),
          ((2, 2, 333, 100), torch.bfloat16, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,causal", _CASES,
                         ids=["prefill_bf16", "prefill_f32", "D16_full",
                              "D128_bf16", "D100_bf16_tf32x3"])
@pytest.mark.parametrize("residual", [False, True],
                         ids=["normalised", "residual"])
def test_every_launch_config_matches_plain(cuda_device, shape, dtype, causal,
                                           residual):
    """Each launch configuration the route offers at this D, held against
    the plain version within the flash tolerance; a configuration outside
    the grid raises."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(dtype).to(cuda_device) for _ in range(3))
    route = fa._route(q, k, v)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 \
        else dict(rtol=5e-2, atol=3e-2)
    want = fa.flash_attention_plain(q, k, v, causal,
                                    return_residuals=residual)
    for cfg in fa.launch_configs(route, shape[3]):
        got = fa.flash_attention(q, k, v, causal, return_residuals=residual,
                                 config=cfg)
        torch.cuda.synchronize()
        if residual:
            # the accumulator scales with l: held as acc / l, m and l
            # within float32 summation order (tests/test_torch_flash.py)
            (acc, m, l_sum), (racc, rm, rl) = got, want
            torch.testing.assert_close(acc / l_sum[..., None],
                                       racc / rl[..., None], **tol)
            torch.testing.assert_close(m, rm, rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(l_sum, rl, rtol=1e-5, atol=1e-5)
        else:
            torch.testing.assert_close(got.float(), want.float(), **tol)
    with pytest.raises(ValueError, match="launch configurations"):
        fa.flash_attention(q, k, v, causal, config=3)


@pytest.mark.cuda
def test_pick_during_a_capture_neither_sweeps_nor_fails(cuda_device,
                                                        tune_off_after):
    """The tuner on, an empty store: the first call of a CapturedFn runs
    flash eagerly (its warm-up sweeps), then captures it reading the store;
    replays equal the eager output with the picked configuration named."""
    tn = tune.enable(None, fit_from_profiler=False)
    tn.store = TuneStore()
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 4, 512, 64))
                                .astype(np.float32)).to(torch.bfloat16)
               .to(cuda_device) for _ in range(3))
    prog = graphs.CapturedFn(lambda a, b, c: fa.flash_attention(a, b, c),
                             "tuned flash")
    defaults = fa.flash_attention.tune_capture_defaults
    in_capture = fa.flash_attention.tune_sweeps_in_capture
    first = prog(q, k, v)
    again = prog(q, k, v)
    torch.cuda.synchronize()
    assert len(prog) == 1 and tn.stats["sweeps"] == 1
    assert fa.flash_attention.tune_capture_defaults == defaults
    assert fa.flash_attention.tune_sweeps_in_capture == in_capture
    picked = tn.store.entries()
    (rec,) = picked.values()
    named = fa.flash_attention(q, k, v, config=rec["value"])
    torch.cuda.synchronize()
    assert torch.equal(again, named) and torch.equal(first, named)
