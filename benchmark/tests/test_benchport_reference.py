"""The plain references against the program at tiny sizes on the CPU, and
the resize against Pillow."""

import numpy as np
import pytest
import torch

import tiny


def test_resize_is_pillows_bilinear():
    Image = pytest.importorskip("PIL.Image")
    from benchmark.reference.resize import resize_rgb

    rng = np.random.default_rng(3)
    for h, w, oh, ow in ((480, 640, 300, 300), (480, 640, 257, 257), (30, 40, 60, 80)):
        frame = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        want = np.asarray(Image.fromarray(frame).resize((ow, oh), Image.BILINEAR))
        assert np.array_equal(resize_rgb(frame, ow, oh), want)


def test_resize_is_the_programs_videoscale():
    from benchmark.reference.resize import resize_rgb
    from nnstreamer_tpu_torch.ops import resample

    frame = np.random.default_rng(4).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    got = resample.resize(torch.from_numpy(frame), 30, 30).numpy()
    assert np.array_equal(resize_rgb(frame, 30, 30), got)


def _tflite_outputs(state, frames):
    from nnstreamer_tpu_torch.models.tflite_import import load_tflite

    bundle = load_tflite(state["vars"]["model"], device="cpu")
    x = (torch.from_numpy(frames).float() + -127.5) / 127.5
    with torch.inference_mode():
        return [bundle.fn()(x[i:i + 1]) for i in range(len(frames))]


def test_ssd_reference_is_the_programs_post_process(tmp_path):
    from benchmark.configs import ssd_mobilenet_v2_coco as ssd

    torch.backends.cudnn.allow_tf32 = False
    cfg = tiny.config("ssd_coco.file1")
    state = ssd.build(cfg, 2 ** 33 + 5, str(tmp_path), "cpu")
    frames = np.random.default_rng(1).integers(0, 256, (3, 96, 96, 3), dtype=np.uint8)
    refs = ssd.reference(state, frames, "cpu")
    for ref, (boxes, classes, scores, num) in zip(refs, _tflite_outputs(state, frames)):
        kept = [a for a, _, _ in ref["final"]]
        assert int(num[0]) == 10
        # every decoder-stage detection is one of the program's ten rows
        b = boxes[0].numpy().astype(np.float64)
        for a, c, s in ref["final"]:
            yx = ref["boxes"][a][[1, 0, 3, 2]]
            i = int(np.argmin(np.abs(b - yx).max(axis=1)))
            assert np.abs(b[i] - yx).max() < 1e-5
            assert int(classes[0, i]) == c
            assert abs(float(scores[0, i]) - s) < 1e-5
        assert len(kept) == len(set(kept))


def test_deeplab_reference_is_the_programs_model(tmp_path):
    from benchmark.configs import deeplabv3_mnv2_257 as dl
    from nnstreamer_tpu_torch.models import deploy

    cfg = tiny.config("deeplab257.files8")
    state = dl.build(cfg, 11, str(tmp_path), "cpu")
    bundle = deploy.load_checkpointed(state["vars"]["model"], "zoo://deeplab_v3", "cpu",
                                      size="65", num_classes="21", dtype="float32")
    frames = np.random.default_rng(2).integers(0, 256, (2, 65, 65, 3), dtype=np.uint8)
    ref = dl.reference(state, frames, "cpu")
    with torch.inference_mode():
        got = bundle.fn()(torch.from_numpy(frames)).numpy()
    for g, r in zip(got, ref):
        assert np.abs(g - r["logits"]).max() < 1e-4
    # the judge reads its own argmax as no gap, and a wrong class as one
    out = dl.as_output(state, ref[0])
    assert dl.judge(state, [(out, ref[0])]) == {"logit_gap": 0.0, "bad_px": 0.0}
    out["canvas"] = out["canvas"].copy()
    out["canvas"][0, 0] = (1, 2, 3, 4)
    assert dl.judge(state, [(out, ref[0])])["bad_px"] == 1.0


def test_ssd_judge_reads_its_own_answer_as_exact(tmp_path):
    from benchmark.configs import ssd_mobilenet_v2_coco as ssd

    cfg = tiny.config("ssd_coco.file1")
    state = ssd.build(cfg, 9, str(tmp_path), "cpu")
    frames = np.random.default_rng(5).integers(0, 256, (2, 96, 96, 3), dtype=np.uint8)
    refs = ssd.reference(state, frames, "cpu")
    pairs = [(ssd.as_output(state, r), r) for r in refs]
    got = ssd.judge(state, pairs)
    assert got["canvas_px"] == 0.0
    assert got["logit_gap"] < 1e-5 and got["box_px"] < 1e-3
    # a box moved by 3 pixels reads 3
    d = pairs[0][0]["detections"][0]
    x0, y0, x1, y1 = d["box"]
    d["box"] = (x0 + 3 / 640, y0, x1 + 3 / 640, y1)
    pairs[0][0]["canvas"] = ssd.detect.render(pairs[0][0]["detections"], cfg["labels"], 640, 480)
    assert ssd.judge(state, pairs)["box_px"] == pytest.approx(3.0, abs=1e-3)


def _frame(boxes, logits):
    return {"boxes": np.array(boxes, np.float64),
            "cls_logits": np.array(logits, np.float64)[:, None]}


POST = {"nms_score_threshold": 1e-8, "nms_iou_threshold": 0.6, "max_detections": 2}


def test_bounded_final_leaves_open_only_what_an_allowed_error_could_flip():
    from benchmark.reference.detect import bounded_final

    a, a2, far = [0.1, 0.1, 0.5, 0.5], [0.1, 0.1, 0.5, 0.52], [0.6, 0.6, 0.9, 0.9]
    # a clear score gap over a clear overlap: the lower box is certainly gone
    sure, may = bounded_final(_frame([a, a2, far], [3.0, 2.0, 1.0]), POST, 0.5, 0.5,
                              0.045, 1e-3, 1e-3)
    assert sure == may == {0, 2}
    # two overlapping boxes whose scores could swap: either may stay (and,
    # the bounds being loose, both may count against the cut)
    sure, may = bounded_final(_frame([a, a2, far], [2.0, 1.95, 1.0]),
                              dict(POST, max_detections=3), 0.5, 0.5, 0.045, 1e-3, 1e-3)
    assert sure == {2} and may == {0, 1, 2}
    # a score that could fall either side of the decoder's 0.5
    sure, may = bounded_final(_frame([a, far], [3.0, 0.01]), POST, 0.5, 0.5, 0.045, 1e-3, 1e-3)
    assert sure == {0} and may == {0, 1}
    # the max_detections cut between two near-equal scores
    third = [0.0, 0.6, 0.3, 0.9]
    sure, may = bounded_final(_frame([a, far, third], [3.0, 1.0, 0.98]), POST, 0.5, 0.5,
                              0.045, 1e-3, 1e-3)
    assert sure == {0} and may == {0, 1, 2}


def test_bounded_final_brackets_the_references_own_detections(tmp_path):
    from benchmark.configs import ssd_mobilenet_v2_coco as ssd
    from benchmark.reference.detect import bounded_final

    cfg = tiny.config("ssd_coco.file1")
    state = ssd.build(cfg, 7, str(tmp_path), "cpu")
    frames = np.random.default_rng(2).integers(0, 256, (4, 96, 96, 3), dtype=np.uint8)
    dec = cfg["decoder"]
    for ref in ssd.reference(state, frames, "cpu"):
        final = {a for a, _, _ in ref["final"]}
        sure, may = bounded_final(ref, cfg["postprocess"], dec["threshold"], dec["iou"],
                                  0.045, 0.7 / 640, 0.7 / 480)
        assert sure <= final <= may and sure
        # with no error allowed, nothing is left open
        assert bounded_final(ref, cfg["postprocess"], dec["threshold"], dec["iou"],
                             0.0, 0.0, 0.0) == (final, final)
