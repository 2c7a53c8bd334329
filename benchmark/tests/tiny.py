"""Tiny forms of the configurations, for runs of the harness on the CPU."""

from benchmark.harness.manifest import Manifest

from conftest import ROOT


def manifest() -> Manifest:
    return Manifest(ROOT)


def config(workload: str) -> dict:
    m = manifest()
    cfg = m.config(m.workload(workload)["config"])
    if "depth_multiplier" in cfg:
        return dict(cfg, input_size=96, depth_multiplier=0.35, anchors=204)
    return dict(cfg, input_size=65)
