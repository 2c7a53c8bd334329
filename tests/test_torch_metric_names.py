"""The naming lint over the port's tree (``nnstreamer_tpu_torch/``).

tests/test_metric_names.py runs scripts/check_metric_names.py over the JAX
package; this file runs the same checks (scripts/nnslint/naming_compat.py,
through the script's module API) over the port: metric names
``nnstpu_<layer>_<name>_<unit>``, label schemas, literal span names
``<layer>.<operation>`` and event types ``<layer>.<event>``, and every
placement rule (kv, resilience, router, profile, sched, slo, quality,
diag, tune, fleet, checkpoint, disagg). The rules match paths by their
last parts, so they apply to the port's tree as they stand. One does not:
``check_epilogue``'s kernel-label rule wants ``pallas.<kernel>`` labels
emitted from ``ops/pallas/``; the port's hand kernels are labelled
``cuda.<kernel>`` from ``ops/kernels/``, held here by the same call-site
pattern. The names themselves are the JAX package's: a dashboard built on
one package reads the other.
"""

import re
import sys
from pathlib import Path

import pytest

pytestmark = pytest.mark.lint

REPO_ROOT = Path(__file__).resolve().parents[1]
PORT = REPO_ROOT / "nnstreamer_tpu_torch"
JAX = REPO_ROOT / "nnstreamer_tpu"


@pytest.fixture(scope="module")
def lint():
    sys.path.insert(0, str(REPO_ROOT / "scripts"))
    try:
        import check_metric_names
    finally:
        sys.path.pop(0)
    return check_metric_names


def test_lint_passes_on_port_tree(lint):
    assert lint.check(PORT) == []
    # the tree registers metrics and names spans and events literally
    assert list(lint.iter_registrations(PORT))
    assert list(lint.iter_span_sites(PORT))
    assert list(lint.iter_event_sites(PORT))


@pytest.mark.parametrize("rule", ["check_names", "check_labels",
                                  "check_spans", "check_events",
                                  "check_resilience", "check_kv",
                                  "check_router", "check_profile",
                                  "check_sched", "check_slo",
                                  "check_quality", "check_diag",
                                  "check_tune", "check_fleet",
                                  "check_checkpoint", "check_disagg"])
def test_each_rule_passes_on_port_tree(lint, rule):
    assert getattr(lint, rule)(PORT) == []


def test_epilogue_rule_but_the_pallas_label_vocabulary(lint):
    """check_epilogue over the port: only its Pallas-label findings, one
    per hand kernel; the EPILOGUE_SELECT_HOOK placement half passes. The
    port's labels are ``cuda.<snake_case>`` and live in ops/kernels/."""
    problems = lint.check_epilogue(PORT)
    assert len(problems) == 7
    assert all("Pallas kernel label 'cuda." in p for p in problems)
    from scripts.nnslint.naming_compat import _KERNEL_LABEL_RE

    labels = []
    for path in sorted(PORT.rglob("*.py")):
        text = path.read_text(encoding="utf-8")
        for m in _KERNEL_LABEL_RE.finditer(text):
            labels.append(m.group(1))
            assert tuple(path.parts[-3:-1]) == ("ops", "kernels"), path
    assert all(re.match(r"^cuda\.[a-z][a-z0-9_]*$", lb) for lb in labels)
    jax_kernels = set()
    for path in sorted(JAX.rglob("*.py")):
        jax_kernels |= {m.group(1).split(".", 1)[1] for m in
                        _KERNEL_LABEL_RE.finditer(path.read_text())}
    assert {lb.split(".", 1)[1] for lb in labels} == jax_kernels


def test_lint_catches_violations_in_a_port_layout(lint, tmp_path):
    """The rules bite on the port's module layout too (a registration in
    the wrong package, a bad event literal)."""
    (tmp_path / "filters").mkdir()
    (tmp_path / "filters" / "torch_cuda.py").write_text(
        'reg.counter("nnstpu_sched_bucket_total", "h", ("event",))\n'
        '_events.record("sched.bucket_miss", "m")\n'
        '_events.record("NotDotted", "m")\n')
    assert lint.check_sched(tmp_path)
    assert lint.check_events(tmp_path)


def _names(lint, root):
    return ({n for _, _, _, n in lint.iter_registrations(root)},
            {n for _, _, n in lint.iter_span_sites(root)},
            {n for _, _, n in lint.iter_event_sites(root)})


def test_port_names_are_the_jax_packages(lint):
    """Every metric family, span name and event type the port emits is one
    the JAX package emits too."""
    mine, ref = _names(lint, PORT), _names(lint, JAX)
    for got, want in zip(mine, ref):
        assert got and got <= want, sorted(got - want)


def test_layer_rules_see_the_ported_obs_layers(lint):
    """The slo, quality, diag and tune ownership rules find the port's
    modules: each layer's metric families, event types and (diag) spans
    are registered, and only, inside the module the rule reserves."""
    regs = {}
    for path, _, _, name in lint.iter_registrations(PORT):
        regs.setdefault(name.split("_")[1], set()).add(
            path.relative_to(PORT).as_posix())
    assert regs["slo"] == {"obs/slo.py"}
    assert regs["quality"] == {"obs/quality/__init__.py"}
    assert regs["tune"] == {"tune/tuner.py"}
    events = {}
    for path, _, name in lint.iter_event_sites(PORT):
        events.setdefault(name.split(".")[0], set()).add(
            path.relative_to(PORT).as_posix())
    assert events["slo"] == {"obs/slo.py"}
    assert events["quality"] == {"obs/quality/__init__.py"}
    assert events["tune"] == {"tune/tuner.py"}
    spans = {path.relative_to(PORT).as_posix()
             for path, _, name in lint.iter_span_sites(PORT)
             if name.startswith("diag.")}
    assert spans == {"obs/diag/__init__.py"}


def test_lint_catches_an_slo_name_minted_outside_obs_slo(lint, tmp_path):
    """A violation in the port's layout: the serving engine registering an
    nnstpu_slo_* family and recording an slo.* event itself, instead of
    going through ENGINE_SLO_HOOK."""
    (tmp_path / "serving").mkdir()
    (tmp_path / "serving" / "lm_engine.py").write_text(
        'reg.counter("nnstpu_slo_shed_total", "h", ("engine",))\n'
        '_events.record("slo.burn_alert", "m")\n')
    problems = lint.check_slo(tmp_path)
    assert len(problems) == 2
    assert all("lm_engine.py" in p for p in problems)
    assert lint.check_tune(tmp_path) == []


@pytest.mark.parametrize("layer", ["query", "router", "resilience", "chaos"])
def test_query_layers_register_where_the_jax_package_does(lint, layer):
    """The query and resilience layers' metric families, event types and
    span names are each minted in the same module of both trees (the
    router's prefix-aware placement event too, now that the fleet
    aggregator it reads is ported)."""
    def where(root):
        regs, events, spans = set(), set(), set()
        for path, _, _, name in lint.iter_registrations(root):
            if name.split("_")[1] == layer:
                regs.add((path.relative_to(root).as_posix(), name))
        for path, _, name in lint.iter_event_sites(root):
            if name.split(".")[0] == layer:
                events.add((path.relative_to(root).as_posix(), name))
        for path, _, name in lint.iter_span_sites(root):
            if name.split(".")[0] == layer:
                spans.add((path.relative_to(root).as_posix(), name))
        return regs, events, spans

    mine, ref = where(PORT), where(JAX)
    assert mine[0], f"no {layer} metric family registered in the port"
    assert mine == ref


@pytest.mark.parametrize("layer", ["disagg", "fleet"])
def test_fleet_layers_register_where_the_jax_package_does(lint, layer):
    """The disaggregated-serving and fleet (obs/fleet.py federation, fleet/
    migration, autoscaling and checkpoints) layers' metric families, event
    types and span names are minted in the same modules of both trees."""
    def where(root):
        regs, events, spans = set(), set(), set()
        for path, _, _, name in lint.iter_registrations(root):
            if name.split("_")[1] == layer:
                regs.add((path.relative_to(root).as_posix(), name))
        for path, _, name in lint.iter_event_sites(root):
            if name.split(".")[0] == layer:
                events.add((path.relative_to(root).as_posix(), name))
        for path, _, name in lint.iter_span_sites(root):
            if name.split(".")[0] == layer:
                spans.add((path.relative_to(root).as_posix(), name))
        return regs, events, spans

    mine, ref = where(PORT), where(JAX)
    assert mine[0] or mine[1], f"no {layer} name minted in the port"
    assert mine == ref
