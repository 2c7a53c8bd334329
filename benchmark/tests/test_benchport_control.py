"""The control on the card at each cell's own size: the reference in the
precision below the configuration's, put in the program's place, fails a
compared number on three seeds, while the program on the same seeds does
not. Run on the card with ``python -m pytest benchmark/tests -m cuda``."""

import pytest

CELLS = ["ssd_coco.file1"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_and_the_program_holds(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's own size on the card")
    from benchmark import calibrate
    from benchmark.harness.manifest import Manifest

    from conftest import ROOT

    limits = Manifest(ROOT).config(Manifest(ROOT).workload(workload)["config"])["limits"]
    for seed in (9001, 9002, 9003):
        r = calibrate.readings(workload, seed, 3.0, torch.device("cuda", 0))
        assert all(r["program"][k] <= limits[k] for k in limits), r
        assert any(r["control"][k] > limits[k] for k in limits), r
