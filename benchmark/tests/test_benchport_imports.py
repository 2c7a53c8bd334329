"""No module the benchmark runs loads JAX or the JAX package, compared by
whole top-level names; the reference loads nothing of the program."""

import subprocess
import sys

from benchmark.harness import guard

from conftest import ROOT

RUN = r"""
import sys, json, torch
sys.path.insert(0, {root!r})
sys.path.insert(0, {root!r} + "/benchmark/tests")
import tiny
from benchmark.harness.cell import Cell, decide
from benchmark.harness import guard
m = tiny.manifest()
cell = Cell(m, "ssd_coco.file1", 3, torch.device("cpu"), config=tiny.config("ssd_coco.file1"))
cell.build(); cell.warm(300); cell.measure(1.0, True); rec = cell.records(); cell.stop()
cell.free(); checked = cell.check(); cell.cleanup()
for w in m.bench["workloads"]:
    m.maker(w["config"])
for x in m.bench["end_to_end"] + m.bench["per_layer"]:
    m.reader(x["name"])
print(json.dumps(guard.loaded()))
"""

REF = r"""
import sys, json
sys.path.insert(0, {root!r})
import benchmark.reference.deeplab, benchmark.reference.detect
import benchmark.reference.resize, benchmark.reference.tflite_net
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _run(code):
    out = subprocess.run([sys.executable, "-c", code.format(root=ROOT)], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_names_compare_whole():
    mods = ["nnstreamer_tpu_torch", "nnstreamer_tpu_torch.graph", "jaxtyping", "flaxen.x"]
    assert guard.loaded(modules=mods) == []
    assert guard.loaded(modules=mods + ["nnstreamer_tpu.ops"]) == ["nnstreamer_tpu"]
    assert guard.loaded(modules=["jax.numpy", "jaxlib"]) == ["jax", "jaxlib"]


def test_a_run_loads_no_jax_nor_the_jax_package():
    assert _run(RUN) == "[]"


def test_the_reference_loads_nothing_of_the_program():
    import json

    tops = json.loads(_run(REF))
    assert "nnstreamer_tpu_torch" not in tops
    assert not set(tops) & set(guard.FORBIDDEN)
