"""A run with its timed path broken underneath comes out not correct: a
detection or a pixel altered where the decoder makes it, a detection
dropped or added there, the greedy NMS switched off, and half of the
frames left out. The run is the harness's own on the CPU at a tiny size
(only the look for a card is skipped). The training faults (a state left
unchanged) and the exchange between cards have no counterpart in these
one-card serving cells."""

import numpy as np
import pytest
import torch

from benchmark.harness import cell as cellmod

import tiny


def _run(workload, seed=21, seconds=1.5, config=None):
    m = tiny.manifest()
    c = cellmod.Cell(m, workload, seed, torch.device("cpu"), streams=2,
                     config=config or tiny.config(workload))
    try:
        c.build()
        c.warm(300)
        c.measure(seconds, False)
        rec = c.records()
        c.stop()
        c.free()
        checked = c.check()
    finally:
        c.cleanup()
    return cellmod.decide(c.cfg["limits"], checked, rec, 4)


@pytest.fixture
def short_drain(monkeypatch):
    monkeypatch.setattr(cellmod, "DRAIN_S", 2.0)


def _anchors_1917():
    # the full 1917 anchors with narrow layers, for the CPU's time: the top
    # boxes overlap often enough there for the greedy sweep to matter
    return dict(tiny.manifest().config("ssd_mobilenet_v2_coco"), depth_multiplier=0.35)


@pytest.mark.parametrize("workload,full", [("ssd_coco.file1", False), ("ssd_coco.file1", True),
                                           ("deeplab257.files8", False)])
def test_a_sound_run_is_correct(workload, full):
    checks, correct = _run(workload, config=_anchors_1917() if full else None)
    assert correct, checks


def test_a_detection_altered_where_it_is_made(monkeypatch):
    from nnstreamer_tpu_torch.decoders import bounding_box

    orig = bounding_box.BoundingBox._finish

    def finish(self, objs, buf, suppressed=False):
        objs = np.array(objs, copy=True)
        if len(objs):
            objs[0, 0] += 0.05  # the first box's left edge, 32 pixels
        return orig(self, objs, buf, suppressed)

    monkeypatch.setattr(bounding_box.BoundingBox, "_finish", finish)
    checks, correct = _run("ssd_coco.file1")
    assert not correct
    assert checks["box_px"]["value"] > checks["box_px"]["limit"]


def _rows_changed(monkeypatch, change):
    from nnstreamer_tpu_torch.decoders import bounding_box

    orig = bounding_box.BoundingBox._finish

    def finish(self, objs, buf, suppressed=False):
        return orig(self, change(np.array(objs, copy=True)), buf, suppressed)

    monkeypatch.setattr(bounding_box.BoundingBox, "_finish", finish)


@pytest.mark.parametrize("change", ["dropped", "added"])
def test_a_detection_dropped_or_added_where_it_is_made(monkeypatch, change):
    # the canvas is drawn from the changed rows, so only the sets disagree
    if change == "dropped":
        _rows_changed(monkeypatch, lambda objs: objs[1:])
    else:
        _rows_changed(monkeypatch, lambda objs: np.concatenate([objs, objs[:1]]))
    checks, correct = _run("ssd_coco.file1")
    assert not correct
    assert checks["det_mismatch"]["value"] > checks["det_mismatch"]["limit"]


def test_nms_switched_off(monkeypatch):
    from nnstreamer_tpu_torch.ops.kernels import epilogue

    def no_suppression(x0, y0, x1, y1, scores, *, iou_threshold, threshold):
        return torch.where(scores >= threshold, scores, -1.0)

    monkeypatch.setattr(epilogue, "nms_sweep", no_suppression)
    # a longer window: the sweep changes a certain detection in a few frames of a hundred
    checks, correct = _run("ssd_coco.file1", config=_anchors_1917(), seconds=6.0)
    assert not correct
    assert checks["det_mismatch"]["value"] > checks["det_mismatch"]["limit"]


def test_a_class_altered_where_it_is_made(monkeypatch):
    from nnstreamer_tpu_torch.decoders import bounding_box

    orig = bounding_box.BoundingBox._finish

    def finish(self, objs, buf, suppressed=False):
        objs = np.array(objs, copy=True)
        if len(objs):
            objs[0, 5] = (objs[0, 5] + 1) % 90
        return orig(self, objs, buf, suppressed)

    monkeypatch.setattr(bounding_box.BoundingBox, "_finish", finish)
    checks, correct = _run("ssd_coco.file1")
    assert not correct
    assert checks["logit_gap"]["value"] > checks["logit_gap"]["limit"]


def test_pixels_altered_where_they_are_made(monkeypatch):
    from nnstreamer_tpu_torch.decoders import image_segment

    orig = image_segment.ImageSegment.decode

    def decode(self, buf, config):
        out = orig(self, buf, config)
        canvas = np.array(out.memories[0].host(), copy=True)
        canvas[:8] = canvas[8:16][:, ::-1]  # a band of pixels of other classes
        from nnstreamer_tpu_torch.core.buffer import TensorMemory
        return out.with_memories([TensorMemory(canvas)])

    monkeypatch.setattr(image_segment.ImageSegment, "decode", decode)
    checks, correct = _run("deeplab257.files8")
    assert not correct
    assert checks["logit_gap"]["value"] > checks["logit_gap"]["limit"]


@pytest.mark.parametrize("workload", ["ssd_coco.file1", "deeplab257.files8"])
def test_half_the_frames_left_out(monkeypatch, short_drain, workload):
    from nnstreamer_tpu_torch.elements.decoder import TensorDecoder

    orig, measure = TensorDecoder._emit, cellmod.Cell.measure
    window = []

    def emit(self, out):
        if window and int(out.offset) % 2:
            return None  # dropped where it is made, once the window is open
        return orig(self, out)

    def measure_dropping(self, seconds, trace):
        window.append(True)
        return measure(self, seconds, trace)

    monkeypatch.setattr(TensorDecoder, "_emit", emit)
    monkeypatch.setattr(cellmod.Cell, "measure", measure_dropping)
    checks, correct = _run(workload)
    assert not correct
    assert checks["frames_without_result"]["value"] > 0
