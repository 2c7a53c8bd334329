"""The port's obs.quality against the JAX package's.

Every case of tests/test_quality.py, run against ``nnstreamer_tpu_torch``
(the zero-overhead hook contract, the streaming
statistics against numpy, sketches and PSI, drift baselines and the
fake-clock multi-window burn, the NaN-storm / dead-output rules, sampling,
cardinality, the spec grammar, LM confidence on the port's engine, a NaN
storm bundling itself through the watchdog, the push document's
``quality`` field and the fleet rollup, the exporter routes and the
Perfetto lane); then parity: the spec grammar, a baseline written by one
package scored by the other, the drift verdicts, the confidence triple
against the JAX engine's ``_conf_from_row``, and the confidence admission's
first tokens against the plain admission's. The NaN-storm case injects its
poison with resilience/chaos.py's ``corrupt`` fault, as the JAX case does.
Every socket binds port 0.
"""

import inspect
import json
import math
import urllib.request

import numpy as np
import pytest

from nnstreamer_tpu_torch.core import Buffer
from nnstreamer_tpu_torch.core.buffer import TensorMemory
from nnstreamer_tpu_torch.graph import Pipeline
from nnstreamer_tpu_torch.graph.element import Pad
from nnstreamer_tpu_torch.obs import diag
from nnstreamer_tpu_torch.obs import events as obs_events
from nnstreamer_tpu_torch.obs import fleet as obs_fleet
from nnstreamer_tpu_torch.obs import health as obs_health
from nnstreamer_tpu_torch.obs import quality
from nnstreamer_tpu_torch.obs.exporter import start_exporter
from nnstreamer_tpu_torch.obs.quality.drift import Baseline, DriftWindows
from nnstreamer_tpu_torch.obs.quality.stats import (LogBucketSketch, TapStats,
                                              Welford, psi)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _buf(arr):
    return Buffer.of(np.asarray(arr))


def _frames(n, fill=1.0, shape=(4, 4)):
    return [np.full(shape, fill, np.float32) for _ in range(n)]


_HEALTH_THRESHOLDS = (
    "stall_after_s", "queue_dwell_s", "reconnect_storm",
    "reconnect_window_s", "admission_deadline_s", "interval_s",
    "starvation_storm", "starvation_window_s")


@pytest.fixture
def quality_off():
    """Quality off and fresh around every test in this file."""
    quality.disable()
    yield quality
    quality.disable()


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
def health():
    reg = obs_health.registry()
    was = reg.is_enabled
    saved = {k: getattr(reg, k) for k in _HEALTH_THRESHOLDS}
    reg.reset()
    yield obs_health
    reg.reset()
    for k, v in saved.items():
        setattr(reg, k, v)
    reg._enabled = was


@pytest.fixture
def diag_off():
    diag.disable()
    yield diag
    diag.disable()


def _enable_diag(tmp_path, **kw):
    kw.setdefault("min_interval_s", 0.0)
    kw.setdefault("dedup_window_s", 0.0)
    return diag.enable(str(tmp_path / "bundles"), **kw)


# --------------------------------------------------------------------------- #
# Hook contract: zero overhead when off
# --------------------------------------------------------------------------- #

class TestHookContract:
    def test_hook_defaults_off(self):
        assert quality.QUALITY_HOOK is None
        assert quality.enabled() is False
        assert quality.engine() is None
        assert quality.snapshot() == {"enabled": False, "taps": {}}
        assert quality.push_data() is None
        assert quality.trace_points() == []
        assert quality.save_baseline("/nonexistent/nope.json") is None
        assert quality.report() == "quality: off"

    def test_enable_installs_and_disable_clears(self, quality_off):
        eng = quality.enable()
        assert quality.QUALITY_HOOK is eng
        assert quality.engine() is eng
        assert quality.enabled() is True
        quality.disable()
        assert quality.QUALITY_HOOK is None
        assert quality.engine() is None

    def test_hot_paths_pay_exactly_one_none_check(self):
        """The acceptance pin: with quality disabled each data-plane
        tap is ONE additional QUALITY_HOOK attribute load + None test —
        counted in the source of the five tap sites so a second load
        can't sneak in."""
        from nnstreamer_tpu_torch.elements.decoder import TensorDecoder
        from nnstreamer_tpu_torch.elements.filter import TensorFilter
        from nnstreamer_tpu_torch.serving.lm_engine import LMEngine

        for fn in (Pad.push, TensorFilter.chain, TensorDecoder._emit,
                   LMEngine._admit, LMEngine._retire_if_done):
            src = inspect.getsource(fn)
            assert src.count("QUALITY_HOOK") == 1, fn.__qualname__

    def test_disabled_run_records_nothing(self, quality_off):
        """Quality off: a full pipeline run leaves the hook None and no
        tap state anywhere to collect."""
        p = Pipeline(device="cpu")
        src = p.add_new("appsrc", caps=self._caps(), data=_frames(3))
        sink = p.add_new("tensor_sink", store=True)
        Pipeline.link(src, sink)
        p.run(timeout=30)
        assert sink.num_buffers == 3
        assert quality.QUALITY_HOOK is None
        assert quality.snapshot() == {"enabled": False, "taps": {}}
        assert quality.trace_points() == []

    @staticmethod
    def _caps():
        from nnstreamer_tpu_torch.core import Caps, TensorsConfig, TensorsInfo
        return Caps.tensors(TensorsConfig(
            TensorsInfo.from_strings("4:4", "float32"), 30))

    def test_env_enable(self, tmp_path):
        import subprocess
        import sys

        out = subprocess.run(
            [sys.executable, "-c",
             "from nnstreamer_tpu_torch.obs import quality; "
             "eng = quality.engine(); "
             "print(quality.enabled(), sorted(eng.taps_enabled), "
             "eng.nan_storm)"],
            capture_output=True, text=True,
            env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
                 "NNSTPU_QUALITY": "taps=chain+lm,nan_storm=2"})
        assert out.returncode == 0, out.stderr
        assert out.stdout.split() == ["True", "['chain',", "'lm']", "2"]


# --------------------------------------------------------------------------- #
# Streaming statistics: exactness against numpy
# --------------------------------------------------------------------------- #

class TestWelford:
    def test_bulk_merge_matches_numpy_exactly(self):
        rng = np.random.default_rng(7)
        chunks = [rng.normal(100.0, 5.0, size=n)
                  for n in (1, 17, 256, 3, 1000)]
        w = Welford()
        for c in chunks:
            w.add_array(c)
        ref = np.concatenate(chunks)
        assert w.n == ref.size
        assert math.isclose(w.mean, float(ref.mean()), rel_tol=1e-12)
        assert math.isclose(w.variance, float(ref.var()), rel_tol=1e-9)
        assert math.isclose(w.std, float(ref.std()), rel_tol=1e-9)

    def test_scalar_adds_match_numpy(self):
        xs = [3.0, -1.5, 0.0, 8.25, 3.0]
        w = Welford()
        for x in xs:
            w.add(x)
        assert math.isclose(w.mean, float(np.mean(xs)), rel_tol=1e-12)
        assert math.isclose(w.variance, float(np.var(xs)), rel_tol=1e-12)

    def test_empty_chunk_is_noop(self):
        w = Welford()
        w.add_array(np.empty(0))
        assert w.n == 0 and w.variance == 0.0


class TestSketchAndPsi:
    def test_buckets_zeros_and_nonfinite(self):
        x = np.array([0.0, 0.0, 1.0, 1.5, 4.0, -4.0, np.nan, np.inf])
        sk = LogBucketSketch.of(x)
        assert sk.zeros == 2
        assert sk.nonfinite == 2
        # 1.0, 1.5 -> e0; 4.0, -4.0 -> e2
        assert sk.counts == {0: 2, 2: 2}
        assert sk.total == x.size
        rt = LogBucketSketch.from_dict(sk.as_dict())
        assert rt.as_dict() == sk.as_dict()

    def test_psi_matches_numpy_formula(self):
        ref = {"e0": 50, "e1": 30, "e2": 20, "zero": 0, "nonfinite": 0}
        live = {"e0": 20, "e1": 30, "e2": 50, "zero": 0, "nonfinite": 0}
        keys = sorted(set(ref) | set(live))
        q = np.maximum(np.array([ref.get(k, 0) for k in keys]) / 100.0,
                       1e-6)
        p = np.maximum(np.array([live.get(k, 0) for k in keys]) / 100.0,
                       1e-6)
        expect = float(((p - q) * np.log(p / q)).sum())
        assert math.isclose(psi(ref, live), expect, rel_tol=1e-12)

    def test_psi_identical_is_zero_and_shift_positive(self):
        a = {"e0": 10, "e3": 5, "zero": 1, "nonfinite": 0}
        assert psi(a, a) == 0.0
        shifted = {"e7": 10, "e8": 5, "zero": 1, "nonfinite": 0}
        assert psi(a, shifted) > 0.2


class TestTapStats:
    def test_counts_and_moments(self):
        ts = TapStats()
        info = ts.observe(np.array([1.0, 2.0, 0.0, np.nan, np.inf]))
        assert info["nan_frame"] is True and info["dead"] is False
        assert ts.nan_count == 1 and ts.inf_count == 1
        assert ts.zero_count == 1
        assert ts.min == 0.0 and ts.max == 2.0
        # moments accumulate finite values only
        assert math.isclose(ts.welford.mean, 1.0, rel_tol=1e-12)

    def test_dead_frame_is_constant_finite(self):
        ts = TapStats()
        assert ts.observe(np.full(8, 3.25))["dead"] is True
        assert ts.observe(np.zeros(8))["dead"] is True
        assert ts.observe(np.arange(8.0))["dead"] is False

    def test_interframe_delta(self):
        ts = TapStats()
        assert ts.observe(np.ones(4))["delta"] is None
        info = ts.observe(np.full(4, 3.0))
        assert math.isclose(info["delta"], 2.0, rel_tol=1e-12)
        # shape change resets the delta stream
        assert ts.observe(np.ones(8))["delta"] is None

    def test_sample_cap_strides(self):
        ts = TapStats(sample_cap=16)
        ts.observe(np.ones(1000))
        assert ts.elements <= 16


# --------------------------------------------------------------------------- #
# Drift: baseline roundtrip + fake-clock multi-window burn
# --------------------------------------------------------------------------- #

class TestDrift:
    def test_baseline_roundtrip(self, tmp_path):
        base = Baseline({"chain:c0": {"e0": 5, "zero": 1}},
                        meta={"frames": 5})
        path = str(tmp_path / "base.json")
        base.save(path)
        got = Baseline.load(path)
        assert got.taps == {"chain:c0": {"e0": 5, "zero": 1}}
        assert got.meta["frames"] == 5
        assert got.sketch_for("chain:c0") == {"e0": 5, "zero": 1}
        assert got.sketch_for("chain:other") is None

    def test_baseline_rejects_junk(self, tmp_path):
        bad = tmp_path / "bad.json"
        bad.write_text(json.dumps({"version": 99, "taps": {}}))
        with pytest.raises(ValueError, match="version"):
            Baseline.load(str(bad))
        bad.write_text(json.dumps({"version": 1, "taps": "nope"}))
        with pytest.raises(ValueError, match="taps"):
            Baseline.load(str(bad))

    def test_breach_requires_both_windows(self):
        """Fake clock, no sleeping: a PSI spike breaches the fast
        window immediately but the slow window only once the healthy
        history has aged out — the multi-window burn contract."""
        fc = FakeClock()
        dw = DriftWindows(fast_window_s=10.0, slow_window_s=100.0,
                          psi_threshold=0.2, clock=fc)
        for i in range(45):
            dw.add(0.0, now=float(i))
        fc.t = 100.0
        for i in range(5):
            dw.add(1.0, now=96.0 + i)
        ev = dw.evaluate()
        assert ev["windows"]["fast"]["mean_psi"] == 1.0
        assert ev["windows"]["slow"]["mean_psi"] < 0.2
        assert ev["breached"] is False  # fast alone never pages
        # healthy history ages out of the slow horizon
        fc.t = 200.0
        for i in range(5):
            dw.add(1.0, now=196.0 + i)
        ev = dw.evaluate()
        assert ev["windows"]["fast"]["mean_psi"] == 1.0
        assert ev["windows"]["slow"]["mean_psi"] == 1.0
        assert ev["breached"] is True

    def test_empty_window_never_breaches(self):
        fc = FakeClock()
        dw = DriftWindows(fast_window_s=1.0, slow_window_s=10.0,
                          psi_threshold=0.2, clock=fc)
        assert dw.evaluate()["breached"] is False
        dw.add(5.0, now=0.0)
        fc.t = 5.0  # score still in slow, aged out of fast
        ev = dw.evaluate()
        assert ev["windows"]["fast"]["n"] == 0
        assert ev["breached"] is False

    def test_engine_drift_anomaly_is_deterministic(self, quality_off):
        """Record-then-compare: the live distribution lands eight
        octaves away from the frozen baseline, so PSI clears the
        threshold on both (fake-clock) windows and the tap's verdict
        is a drift anomaly."""
        fc = FakeClock()
        ref = LogBucketSketch.of(
            np.ones(64, np.float64)).as_dict()
        base = Baseline({"chain:cam0": ref})
        eng = quality.enable(baseline=base, psi_threshold=0.2,
                             fast_window_s=10.0, slow_window_s=100.0,
                             clock=fc)
        for _ in range(4):
            eng.observe_chain("cam0", _buf(np.full((4, 4), 300.0)))
        ev = eng.evaluate("chain:cam0", now=fc.t)
        assert ev["anomaly"] == "drift"
        assert "PSI" in ev["detail"]
        assert ev["drift"]["breached"] is True
        assert ev["psi"] > 0.2


# --------------------------------------------------------------------------- #
# Engine rules: NaN storm, dead output, sampling, cardinality
# --------------------------------------------------------------------------- #

class TestEngineRules:
    def test_nan_storm_fires_after_consecutive_frames(self, quality_off):
        eng = quality.enable(nan_storm=3, dead_frames=100)
        bad = np.full((2, 2), np.nan, np.float32)
        eng.observe_chain("s0", _buf(bad))
        eng.observe_chain("s0", _buf(bad))
        assert eng.evaluate("chain:s0")["anomaly"] is None
        eng.observe_chain("s0", _buf(bad))
        ev = eng.evaluate("chain:s0")
        assert ev["anomaly"] == "nan_storm"
        assert "3 consecutive" in ev["detail"]

    def test_clean_frame_resets_the_storm(self, quality_off):
        eng = quality.enable(nan_storm=2)
        bad = np.array([np.nan, 1.0], np.float32)
        eng.observe_chain("s0", _buf(bad))
        eng.observe_chain("s0", _buf(np.arange(2.0)))
        eng.observe_chain("s0", _buf(bad))
        assert eng.evaluate("chain:s0")["anomaly"] is None

    def test_dead_output_fires_and_recovers(self, quality_off):
        eng = quality.enable(dead_frames=3)
        for _ in range(3):
            eng.observe_chain("s0", _buf(np.zeros(4)))
        assert eng.evaluate("chain:s0")["anomaly"] == "dead_output"
        eng.observe_chain("s0", _buf(np.arange(4.0)))
        assert eng.evaluate("chain:s0")["anomaly"] is None

    def test_every_subsamples_frames(self, quality_off):
        eng = quality.enable(every=3)
        for _ in range(9):
            eng.observe_chain("s0", _buf(np.ones(4)))
        row = eng.snapshot()["taps"]["chain:s0"]
        assert row["seen"] == 9
        assert row["frames"] == 3

    def test_device_resident_frames_are_skipped_not_copied(
            self, quality_off):
        import torch

        eng = quality.enable()
        mem = TensorMemory(torch.ones((2, 2), dtype=torch.float32))
        assert mem._host is None
        eng.observe_chain("dev0", Buffer([mem]))
        row = eng.snapshot()["taps"]["chain:dev0"]
        assert row["seen"] == 1
        assert row["skipped_device"] == 1
        assert row["frames"] == 0
        assert mem._host is None  # the tap never forced a D2H copy

    def test_tap_cardinality_folds_into_overflow(self, quality_off):
        eng = quality.enable(max_taps=2)
        for i in range(5):
            eng.observe_chain(f"e{i}", _buf(np.ones(2)))
        taps = eng.snapshot()["taps"]
        assert set(taps) == {"chain:e0", "chain:e1", "_overflow"}
        assert taps["_overflow"]["seen"] == 3

    def test_taps_disabled_by_spec_are_ignored(self, quality_off):
        eng = quality.enable("taps=filter")
        eng.observe_chain("s0", _buf(np.ones(2)))
        eng.observe_decoder("d0", _buf(np.ones(2)))
        eng.observe_filter("f0", _buf(np.ones(2)))
        assert set(eng.snapshot()["taps"]) == {"filter:f0"}


class TestSpecGrammar:
    def test_full_spec_parses(self):
        kw = quality.parse_quality_spec(
            "taps=chain+lm, every=4, psi=0.3, fast=5, slow=50, "
            "nan_storm=2, dead_frames=9, sample_cap=128, baseline=/b.json")
        assert kw == {"taps": ("chain", "lm"), "every": 4,
                      "psi_threshold": 0.3, "fast_window_s": 5.0,
                      "slow_window_s": 50.0, "nan_storm": 2,
                      "dead_frames": 9, "sample_cap": 128,
                      "baseline": "/b.json"}

    def test_empty_spec_is_defaults(self):
        assert quality.parse_quality_spec("") == {}

    @pytest.mark.parametrize("spec", [
        "bogus=1",                 # unknown key
        "taps",                    # not key=value
        "taps=chain+warp",         # unknown tap kind
        "every=0",                 # out of range
        "nan_storm=soon",          # not an int
        "psi=-1",                  # out of range
        "baseline=",               # missing path
    ])
    def test_bad_specs_raise(self, spec):
        with pytest.raises(ValueError):
            quality.parse_quality_spec(spec)

    def test_enable_kwargs_override_spec(self, quality_off):
        eng = quality.enable("nan_storm=5", nan_storm=2)
        assert eng.nan_storm == 2


# --------------------------------------------------------------------------- #
# Model confidence: the LM retire tap
# --------------------------------------------------------------------------- #

class TestConfidence:
    @pytest.fixture(scope="class")
    def params(self):
        import jax

        from nnstreamer_tpu.models import causal_lm
        from nnstreamer_tpu_torch.models import convert

        return convert.causal_lm_params(jax.tree_util.tree_map(
            np.asarray, causal_lm.init_causal_lm(
                jax.random.PRNGKey(7), 97, 32, 4, 2, 64)), "cpu")

    def test_record_confidence_aggregates(self, quality_off):
        eng = quality.enable()
        eng.record_confidence("lm", "acme", "s1", 2.0, 0.5, 0.1)
        eng.record_confidence("lm", "acme", "s1", 4.0, 0.7, 0.3)
        eng.record_confidence("lm", "bulk", None, 1.0, 0.9, 0.8)
        conf = eng.snapshot()["confidence"]
        assert conf["tenants"]["acme"]["n"] == 2
        assert math.isclose(conf["tenants"]["acme"]["entropy"]["mean"],
                            3.0, rel_tol=1e-12)
        assert conf["tenants"]["bulk"]["n"] == 1
        assert conf["sessions"]["s1"]["n"] == 2
        assert "bulk" not in conf["sessions"]
        # the lm tap shows in the trace ring for the Perfetto lane
        assert any(pt["tap"] == "lm:lm" for pt in eng.trace_points())

    def test_lm_tap_respects_spec(self, quality_off):
        eng = quality.enable("taps=chain")
        eng.record_confidence("lm", "acme", "s1", 2.0, 0.5, 0.1)
        assert eng.snapshot()["confidence"]["tenants"] == {}

    def test_retire_path_records_per_session(self, quality_off, params):
        """E2E on a real engine: the conf-variant prefill computes the
        first-token (entropy, top1, margin) on device and the retire
        tap lands them under the request's tenant AND session."""
        from nnstreamer_tpu_torch.serving import LMEngine

        quality.enable()
        eng = LMEngine(params, 4, 64, n_slots=2, chunk=4,
                       kv_page_size=8, kv_pages=32, device="cpu")
        p = np.arange(12, dtype=np.int32) % 97
        rid = eng.submit(p, 4, session="sess-q")
        rid2 = eng.submit((p + 5) % 97, 4, session="sess-r")
        eng.run()
        assert len(eng.results[rid]) == 4
        assert len(eng.results[rid2]) == 4
        conf = quality.snapshot()["confidence"]
        assert conf["tenants"]["lm"]["n"] == 2
        for sess in ("sess-q", "sess-r"):
            agg = conf["sessions"][sess]
            assert agg["n"] == 1
            assert agg["entropy"]["mean"] >= 0.0
            assert 0.0 < agg["top1"]["mean"] <= 1.0
            assert 0.0 <= agg["margin"]["mean"] <= 1.0

    def test_quality_off_requests_skip_conf(self, quality_off, params):
        """The conf triple is only materialized for requests admitted
        with quality on — an off run never allocates it."""
        from nnstreamer_tpu_torch.serving import LMEngine

        eng = LMEngine(params, 4, 64, n_slots=2, chunk=4,
                       kv_page_size=8, kv_pages=32, device="cpu")
        p = np.arange(12, dtype=np.int32) % 97
        rid = eng.submit(p, 4, session="sess-off")
        eng.run()
        assert len(eng.results[rid]) == 4
        assert quality.snapshot() == {"enabled": False, "taps": {}}


# --------------------------------------------------------------------------- #
# E2E: seeded NaN storm -> DEGRADED component -> automatic bundle
# --------------------------------------------------------------------------- #

class TestNanStormE2E:
    def _caps(self):
        from nnstreamer_tpu_torch.core import Caps, TensorsConfig, TensorsInfo
        return Caps.tensors(TensorsConfig(
            TensorsInfo.from_strings("4:4", "float32"), 30))

    def test_nan_storm_auto_bundles_offending_tap(
            self, quality_off, diag_off, health, events, tmp_path):
        """The acceptance scenario: a seeded chaos corrupt fault
        NaN-poisons consecutive frames entering the sink. Nobody calls
        capture — the watchdog's quality rule does. The bundle names
        the offending tap and freezes its stats in the quality
        stanza."""
        from nnstreamer_tpu_torch.resilience import chaos

        deng = _enable_diag(tmp_path)
        health.enable(interval_s=3600.0)
        quality.enable(nan_storm=2)
        plan = chaos.FaultPlan(
            [chaos.Fault(kind="corrupt", target="chain:qsink",
                         nth=(3, 4, 5))], seed=11)
        chaos.install(plan)
        try:
            p = Pipeline(device="cpu")
            src = p.add_new("appsrc", caps=self._caps(), data=_frames(5))
            sink = p.add_new("tensor_sink", "qsink", store=True)
            Pipeline.link(src, sink)
            p.run(timeout=30)
        finally:
            chaos.uninstall()
        assert sink.num_buffers == 5  # corrupt flows on, never drops
        assert [f["kind"] for f in plan.fired] == ["corrupt"] * 3

        # the tap saw the poison the sink actually received
        row = quality.snapshot()["taps"]["chain:qsink"]
        assert row["nan"] > 0
        assert deng.bundles.list() == []  # nothing manual so far
        health.check_now()

        comp = obs_health.registry().component("quality:chain:qsink")
        assert comp.status is obs_health.Status.DEGRADED
        assert "nan_storm" in comp.detail

        bundles = [b for b in deng.bundles.list()
                   if b["cause"]["kind"] == "quality_anomaly"]
        assert len(bundles) == 1
        cause = bundles[0]["cause"]
        assert cause["key"] == "quality:chain:qsink"
        assert cause["detail"]["anomaly"] == "nan_storm"
        doc = deng.bundles.get(bundles[0]["id"])
        # the quality stanza freezes the offending tap's stats
        stanza = doc["quality"]
        assert stanza["anomalies"]["chain:qsink"]["kind"] \
            == "nan_storm"
        assert stanza["taps"]["chain:qsink"]["nan"] > 0
        # and the flight recorder holds the alert
        evs = [e for e in obs_events.ring().snapshot()
               if e["type"] == "quality.anomaly"]
        assert evs and evs[-1]["severity"] == "warning"
        assert evs[-1]["attrs"]["tap"] == "chain:qsink"

    def test_recovery_flips_component_back(self, quality_off, diag_off,
                                           health, events):
        health.enable(interval_s=3600.0)
        eng = quality.enable(nan_storm=2)
        bad = np.full(4, np.nan, np.float32)
        for _ in range(2):
            eng.observe_chain("s0", _buf(bad))
        health.check_now()
        comp = obs_health.registry().component("quality:chain:s0")
        assert comp.status is obs_health.Status.DEGRADED
        # clean traffic clears the storm; the next tick recovers
        for _ in range(2):
            eng.observe_chain("s0", _buf(np.arange(4.0)))
        health.check_now()
        assert comp.status is obs_health.Status.OK
        assert any(e["type"] == "quality.recover"
                   for e in obs_events.ring().snapshot())

    def test_disabled_engine_retires_its_components(
            self, quality_off, health):
        """The probe is weakref-backed: after disable() the next
        watchdog pass retires quality components instead of reporting
        stale verdicts."""
        health.enable(interval_s=3600.0)
        eng = quality.enable(nan_storm=1)
        eng.observe_chain("s0", _buf(np.full(4, np.nan, np.float32)))
        reg = obs_health.registry()

        def names():
            return [c["name"] for c in reg.snapshot()["components"]]

        assert "quality:chain:s0" in names()
        quality.disable()
        health.check_now()
        assert "quality:chain:s0" not in names()


# --------------------------------------------------------------------------- #
# Surfaces: bundle stanza, fleet push, exporter routes, Perfetto lane
# --------------------------------------------------------------------------- #

class TestSurfaces:
    def test_bundle_stanza_is_error_when_off(self, quality_off,
                                             diag_off, tmp_path):
        deng = _enable_diag(tmp_path)
        bid = deng.on_burn_alert("tenant:acme", {"burn": 2.0})
        doc = deng.bundles.get(bid)
        assert "quality is not enabled" in doc["quality"]["error"]

    def test_push_doc_quality_field(self, quality_off):
        assert obs_fleet.build_push("w-off", "worker", 1)["quality"] \
            is None
        eng = quality.enable(nan_storm=1)
        eng.observe_chain("s0", _buf(np.full(2, np.nan, np.float32)))
        doc = obs_fleet.build_push("w-q", "worker", 1)
        assert doc["quality"]["taps"]["chain:s0"]["nan"] == 2
        assert doc["quality"]["anomalies"]["chain:s0"]["kind"] \
            == "nan_storm"
        agg = obs_fleet.enable_aggregator(ttl_s=30.0)
        try:
            agg.ingest(doc)
            rolled = agg.quality_rollup()
            assert rolled["instances"]["w-q"]["taps"]["chain:s0"]["nan"] \
                == 2
            assert rolled["anomalous"] == ["w-q/chain:s0"]
        finally:
            obs_fleet.disable_aggregator()

    def _get(self, port, path):
        return json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=5).read().decode())

    def test_debug_quality_route(self, quality_off):
        eng = quality.enable()
        eng.observe_chain("s0", _buf(np.ones(4)))
        with start_exporter(port=0) as exp:
            doc = self._get(exp.port, "/debug/quality")
            text = urllib.request.urlopen(exp.url, timeout=5).read()
        assert doc["enabled"] is True
        assert doc["taps"]["chain:s0"]["frames"] == 1
        assert b"nnstpu_quality_frames_total" in text

    def test_debug_quality_route_when_off(self, quality_off):
        with start_exporter(port=0) as exp:
            doc = self._get(exp.port, "/debug/quality")
        assert doc == {"enabled": False, "taps": {}}

    def test_debug_index_derives_from_route_table(self, quality_off):
        """The satellite pin: GET /debug lists every registered route,
        so an endpoint added to the dispatch table shows up for free."""
        with start_exporter(port=0) as exp:
            doc = self._get(exp.port, "/debug")
        for route in ("GET /metrics", "GET /debug/quality",
                      "GET /debug/slo", "GET /debug/bundles",
                      "POST /fleet/push"):
            assert route in doc["routes"]
        assert "GET /debug/bundles/<id>" in doc["prefix_routes"]

    def test_perfetto_quality_lane(self, quality_off):
        from nnstreamer_tpu_torch.obs import profile

        eng = quality.enable()
        eng.observe_chain("s0", _buf(np.ones(4)))
        doc = profile.perfetto_trace()
        assert doc["otherData"]["quality_enabled"] is True
        metas = [e for e in doc["traceEvents"]
                 if e["ph"] == "M" and e["pid"] == 7]
        assert any(e["args"]["name"] == "quality" for e in metas)
        counters = [e for e in doc["traceEvents"]
                    if e["ph"] == "C" and e["pid"] == 7]
        assert counters and counters[0]["name"] == "chain:s0.quality"
        assert set(counters[0]["args"]) == {"mean", "psi", "nan"}

    def test_perfetto_lane_absent_when_off(self, quality_off):
        from nnstreamer_tpu_torch.obs import profile

        doc = profile.perfetto_trace()
        assert doc["otherData"]["quality_enabled"] is False
        assert not any(e.get("pid") == 7 for e in doc["traceEvents"])

    def test_report_lists_taps_and_anomalies(self, quality_off):
        eng = quality.enable(nan_storm=1)
        eng.observe_chain("s0", _buf(np.full(4, np.nan, np.float32)))
        eng.record_confidence("lm", "acme", None, 2.0, 0.5, 0.1)
        rep = quality.report()
        assert rep.startswith("quality: data-plane observation")
        assert "chain:s0" in rep
        assert "ANOMALY nan_storm" in rep
        assert "lm[acme]" in rep


# --------------------------------------------------------------------------- #
# Parity with the JAX package
# --------------------------------------------------------------------------- #

_QSPECS = ["taps=chain+lm, every=4, psi=0.3, fast=5, slow=50, nan_storm=2, "
           "dead_frames=9, sample_cap=128, baseline=/b.json", "", "every=2",
           "bogus=1", "taps", "taps=chain+warp", "every=0", "nan_storm=soon",
           "psi=-1", "baseline=", "taps=", "fast=0"]


def _qparsed(mod, spec):
    try:
        return mod.parse_quality_spec(spec)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("spec", _QSPECS)
def test_parse_quality_spec_equals_jax(spec):
    from nnstreamer_tpu.obs import quality as jax_quality

    assert _qparsed(quality, spec) == _qparsed(jax_quality, spec)


def _seeded_frames(seed, n, scale):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((8, 8)) * scale).astype(np.float32)
            for _ in range(n)]


def _drift_run(mod, buffer_mod, baseline_path, frames):
    """One package's engine scoring ``frames`` on tap chain:cam against the
    baseline at ``baseline_path`` under a fake clock; every verdict."""
    fc = FakeClock()
    eng = mod.enable(baseline=baseline_path, psi_threshold=0.2,
                     fast_window_s=10.0, slow_window_s=100.0, clock=fc)
    try:
        out = []
        for x in frames:
            eng.observe_chain("cam", buffer_mod.Buffer.of(x))
            fc.advance(1.0)
            ev = eng.evaluate("chain:cam", now=fc.t)
            out.append((ev["anomaly"], ev["psi"], ev["drift"]))
        return out
    finally:
        mod.disable()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_baseline_crosses_packages_with_equal_drift(writer, quality_off,
                                                   tmp_path):
    """A baseline recorded by one package loads in the other, and both
    score the same live frames to the same PSI and drift verdicts."""
    from nnstreamer_tpu.core import buffer as jax_buffer
    from nnstreamer_tpu.obs import quality as jax_quality
    from nnstreamer_tpu_torch.core import buffer as torch_buffer

    mods = {"jax": (jax_quality, jax_buffer),
            "torch": (quality, torch_buffer)}
    mod, bmod = mods[writer]
    path = str(tmp_path / "base.json")
    eng = mod.enable()
    try:
        for x in _seeded_frames(1, 6, 1.0):
            eng.observe_chain("cam", bmod.Buffer.of(x))
        mod.save_baseline(path)
    finally:
        mod.disable()
    live = _seeded_frames(2, 4, 1.0) + _seeded_frames(3, 8, 300.0)
    got = _drift_run(quality, torch_buffer, path, live)
    want = _drift_run(jax_quality, jax_buffer, path, live)
    assert got == want
    assert got[-1][0] == "drift" and got[0][1] < got[-1][1]


def _conf_rows():
    rng = np.random.default_rng(4)
    rows = [rng.standard_normal(v).astype(np.float32) * s
            for v in (2, 61, 97, 8192) for s in (0.1, 1.0, 30.0)]
    tied = np.zeros(16, np.float32)
    tied[3] = tied[9] = 5.0  # a tie at the top: margin 0
    peaked = np.full(64, -1e4, np.float32)
    peaked[7] = 50.0  # p underflows to 0 off the peak: the where() branch
    return rows + [tied, peaked]


@pytest.mark.parametrize("i", range(14))
def test_conf_triple_equals_jax_conf_from_row(i):
    import jax.numpy as jnp
    import torch

    from nnstreamer_tpu.serving.lm_engine import _conf_from_row as jax_conf
    from nnstreamer_tpu_torch.serving.lm_engine import _conf_from_row

    row = _conf_rows()[i]
    got = _conf_from_row(torch.from_numpy(row)).numpy()
    want = np.asarray(jax_conf(jnp.asarray(row)))
    assert got.dtype == np.float32 and got.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("paged", [False, True])
def test_conf_admission_first_tokens_equal_plain(paged, quality_off):
    """The confidence admission (a program of its own, keyed by conf=True)
    gives every request the plain admission's tokens, contiguous and paged,
    prefix hits included; only quality-on admissions carry a triple."""
    import jax

    from nnstreamer_tpu.models import causal_lm as jax_lm
    from nnstreamer_tpu_torch.models import convert
    from nnstreamer_tpu_torch.serving import LMEngine

    params = convert.causal_lm_params(jax.tree_util.tree_map(
        np.asarray, jax_lm.init_causal_lm(jax.random.PRNGKey(9), 61, 32, 4,
                                          2, 64)), "cpu")
    kw = dict(kv_page_size=8, kv_pages=16) if paged else {}
    rng = np.random.default_rng(5)
    prefix = rng.integers(1, 61, 16)
    prompts = [np.concatenate([prefix, rng.integers(1, 61, int(n))])
               for n in rng.integers(1, 9, 6)]
    runs = {}
    for on in (False, True):
        if on:
            quality.enable()
        eng = LMEngine(params, 4, 64, n_slots=2, chunk=4, device="cpu", **kw)
        calls = []
        prog = eng._paged_prefill_prog if paged else eng._prefill_prog
        fn = prog.fn
        prog.fn = lambda *a, **k: calls.append(k.get("conf", False)) \
            or fn(*a, **k)
        for p in prompts:
            eng.submit(p, max_new=3, session="s")
        runs[on] = (eng.run(), calls)
        quality.disable()
    assert runs[True][0] == runs[False][0]
    assert runs[False][1] == [False] * 6 and runs[True][1] == [True] * 6
