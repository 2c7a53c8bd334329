"""A cell, a configuration, a mix and a metric are found by name from
files; one more of each is new files and new entries only."""

import json
import os
import shutil

import pytest

from benchmark.harness.manifest import Manifest, read_metrics

from conftest import ROOT


def test_every_name_in_the_manifest_has_its_files():
    m = Manifest(ROOT)
    for w in m.bench["workloads"]:
        spec = m.workload(w["name"])
        assert spec["config"] == w["config"] and spec["traffic"] == w["traffic"]
        m.traffic(w["traffic"])
        assert hasattr(m.maker(w["config"]), "build")
    for kind in ("end_to_end", "per_layer"):
        for metric in m.bench[kind]:
            assert callable(m.reader(metric["name"]).read)


def test_per_layer_metrics_only_in_cells_that_report_what_they_move():
    m = Manifest(ROOT)
    e2e = {x["name"] for x in m.bench["end_to_end"]}
    cells = {w["name"] for w in m.bench["workloads"]}
    for metric in m.bench["per_layer"]:
        assert metric["moves"] in e2e
        assert set(metric["workloads"]) <= cells
    for cell in cells:
        assert m.metrics(cell, True), cell
        assert {x["name"] for x in m.metrics(cell, False)} == e2e


def test_an_added_cell_config_mix_and_metric_need_no_edit(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    before = {p: (root / p).read_bytes() for p in ["BENCHMARK.json"]}
    bench = json.loads(before["BENCHMARK.json"])
    # new files
    b = root / "benchmark"
    shutil.copy(b / "configs" / "ssd_mobilenet_v2_coco.json", b / "configs" / "ssd_copy.json")
    shutil.copy(b / "configs" / "ssd_mobilenet_v2_coco.py", b / "configs" / "ssd_copy.py")
    (b / "traffic" / "burst.json").write_text(json.dumps(
        {"loop": "open", "fps": 30, "frame": [480, 640], "warm_s": 1.0}))
    (b / "workloads" / "ssd_copy.burst.json").write_text(json.dumps(
        {"config": "ssd_copy", "traffic": "burst", "streams": 2, "engine": False,
         "sample": 8, "sample_min": 2}))
    (b / "metrics" / "frames_total.py").write_text(
        "def read(ctx):\n    return ctx['records']['done']\n")
    # new entries
    bench["configs"].append({"name": "ssd_copy", "source": "x", "file": "benchmark/configs/ssd_copy.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "ssd_copy.burst", "config": "ssd_copy", "traffic": "burst",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "frames_total", "unit": "frames", "better": "higher",
                               "source": "host_clock", "layer": "x", "moves": "frames_per_s",
                               "workloads": ["ssd_copy.burst"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    m = Manifest(str(root))
    spec = m.workload("ssd_copy.burst")
    assert spec["streams"] == 2 and m.traffic("burst")["fps"] == 30
    assert m.maker("ssd_copy").__file__.endswith("ssd_copy.py")
    got = read_metrics(m, "ssd_copy.burst", True, {"records": {"done": 7}})
    assert got == {"frames_total": {"value": 7.0, "unit": "frames"}}
    # the existing files are as they were
    for rel in ("harness/manifest.py", "harness/cell.py", "harness/driver.py",
                "configs/ssd_mobilenet_v2_coco.json"):
        assert (b / rel).read_bytes() == open(os.path.join(ROOT, "benchmark", rel), "rb").read()
    with pytest.raises(KeyError):
        m.workload("nope")
