"""The torch port's detection slice against the JAX package, on the CPU.

The same inputs, made from a seed with numpy, go through both packages:
the SSD-MobileNet-v2 model (the port's weights converted from the JAX
bundle's variables), the bounding-box decoder's device reduce, and the
whole ``videotestsrc ! tensor_converter ! tensor_filter ! tensor_decoder
mode=bounding_box ! tensor_sink`` pipeline through each package's
``Pipeline``/``add_new`` API. Then: the port imports no JAX, and its entry
points refuse to run without a card unless the CPU was asked for.

Numeric policy of the comparisons: TF32 is off for cuDNN convolutions and
matmuls (no effect on the CPU, stated for runs on a card); float32 models
compare at rtol 1e-4 with an absolute floor of 1e-4 of the output's scale
(the random-weight outputs are ~0.07, so a bare 1e-4 would be loose).
"""

import dataclasses
import functools
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from nnstreamer_tpu.decoders.bounding_box import BoundingBox as JaxBox  # noqa: E402
from nnstreamer_tpu.graph import Pipeline as JaxPipeline  # noqa: E402
from nnstreamer_tpu.models.zoo import get_model as jax_get_model  # noqa: E402
from nnstreamer_tpu_torch.decoders.bounding_box import BoundingBox  # noqa: E402
from nnstreamer_tpu_torch.graph import Pipeline  # noqa: E402
from nnstreamer_tpu_torch.models.convert import from_flax_variables  # noqa: E402
from nnstreamer_tpu_torch.models.layers import same_padding  # noqa: E402
from nnstreamer_tpu_torch.models.ssd_mobilenet import (  # noqa: E402
    make_ssd_mobilenet_v2, write_box_priors)

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.lru_cache(maxsize=None)
def _jax_ssd(size: int, dtype: str, num_classes: int = 4):
    return jax_get_model(
        f"zoo://ssd_mobilenet_v2?width=0.35&size={size}"
        f"&num_classes={num_classes}&dtype={dtype}")


def _numpy_vars(bundle):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                  bundle.params)


def _port_ssd(size: int, dtype: str, num_classes: int, variables):
    pb = make_ssd_mobilenet_v2(device=CPU, width="0.35", size=str(size),
                               num_classes=str(num_classes), dtype=dtype)
    from_flax_variables(variables, pb.module)
    return pb


def _frame(size: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 256, (1, size, size, 3), dtype=np.uint8)


def _run_both(size, dtype):
    jb = _jax_ssd(size, dtype)
    pb = _port_ssd(size, dtype, 4, _numpy_vars(jb))
    x = _frame(size)
    jo = [np.asarray(o) for o in jb.fn()(x)]
    with torch.inference_mode():
        po = [o.numpy() for o in pb.fn()(torch.from_numpy(x))]
    return jo, po


# --------------------------------------------------------------------------- #
# model
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("size", [64, 66], ids=["size64", "size66_odd_after_stride"])
def test_ssd_float32_matches_jax(size):
    # 66 → 33 → 17: odd after one stride, so the stride-2 SAME pads are
    # (0, 1) then (1, 1) — the asymmetric and symmetric helper branches
    jo, po = _run_both(size, "float32")
    n_anchors = sum(6 * (-(-size // s)) ** 2 for s in (16, 32, 64))
    assert jo[0].shape == po[0].shape == (1, n_anchors, 4)
    assert jo[1].shape == po[1].shape == (1, n_anchors, 4)
    for j, p in zip(jo, po):
        np.testing.assert_allclose(p, j, rtol=1e-4,
                                   atol=1e-4 * np.abs(j).max())


def test_ssd_bfloat16_matches_jax():
    # bf16 keeps 8 significant bits (one ulp is 2^-8 ≈ 3.9e-3 relative);
    # XLA and torch round the convolutions' and BatchNorm's results at
    # different places, so allow 1e-2 of the output scale (about 2.5 ulp)
    jo, po = _run_both(64, "bfloat16")
    for j, p in zip(jo, po):
        np.testing.assert_allclose(p, j, rtol=1e-2,
                                   atol=1e-2 * np.abs(j).max())


@pytest.mark.parametrize("size,kernel,stride,pads", [
    (300, 3, 2, (0, 1)), (150, 3, 2, (0, 1)), (75, 3, 2, (1, 1)),
    (19, 3, 2, (1, 1)), (38, 3, 1, (1, 1)), (10, 1, 1, (0, 0))])
def test_same_padding_matches_xla(size, kernel, stride, pads):
    assert same_padding(size, kernel, stride) == pads
    assert tuple(jax.lax.padtype_to_pads((size,), (kernel,), (stride,),
                                         "SAME")[0]) == pads


def test_converter_rejects_a_mismatched_tree():
    jb = _jax_ssd(64, "float32")
    variables = _numpy_vars(jb)
    pb = make_ssd_mobilenet_v2(device=CPU, width="0.35", size="64",
                               num_classes="5", dtype="float32")
    with pytest.raises(ValueError, match="cls_head_0"):
        from_flax_variables(variables, pb.module)  # 4 vs 5 classes


# --------------------------------------------------------------------------- #
# decoder device reduce
# --------------------------------------------------------------------------- #

def _reduce_inputs(n: int, classes: int = 6):
    """(locs, raw) whose best class scores are well apart (logits spaced
    ≥ 0.03, i.e. sigmoid gaps far above an ulp), with groups of exactly
    tied anchors so the top-K order of ties is exercised too."""
    rng = np.random.default_rng(21)
    raw = rng.uniform(-9.0, -5.0, (1, n, classes)).astype(np.float32)
    best = rng.permutation(np.linspace(-3.0, 6.0, n)).astype(np.float32)
    best[10:14] = best[10]
    best[40:43] = best[40]
    cls = rng.integers(1, classes, n)
    raw[0, np.arange(n), cls] = best
    locs = (rng.normal(size=(1, n, 4)) * 0.5).astype(np.float32)
    return locs, raw


@pytest.mark.parametrize("size", [66, 96], ids=["k_all", "k_capped_256"])
def test_reduce_matches_jax_decoder(tmp_path, size):
    priors = tmp_path / "priors.txt"
    n = write_box_priors(str(priors), size=size)
    opts = {1: "mobilenet-ssd", 3: str(priors), 4: f"{size}:{size}",
            5: f"{size}:{size}"}
    jd, pd = JaxBox(), BoundingBox()
    jd.init(opts)
    pd.init(opts)
    locs, raw = _reduce_inputs(n)
    jax_reduce, _ = jd._make_reduce()
    want = np.asarray(jax.jit(jax_reduce)(locs, raw))
    port_reduce, _ = pd._make_reduce()
    got = port_reduce(torch.from_numpy(locs), torch.from_numpy(raw)).numpy()
    assert got.shape == want.shape == (min(256, n), 6)
    np.testing.assert_array_equal(got[:, 5], want[:, 5])  # classes
    np.testing.assert_array_equal(got[:, 4] < 0, want[:, 4] < 0)  # kept rows
    np.testing.assert_allclose(got[:, :5], want[:, :5], rtol=1e-4, atol=1e-6)
    assert (got[:, 4] >= pd.threshold).sum() > 10


def _post_inputs(m: int, seed: int):
    """tflite detection-postprocess tensors: boxes [ymin, xmin, ymax, xmax],
    class ids, scores with tied groups, and a valid-row count below m."""
    rng = np.random.default_rng(seed)
    y0, x0 = rng.uniform(0, 0.7, (2, m)).astype(np.float32)
    h, w = rng.uniform(0.05, 0.3, (2, m)).astype(np.float32)
    boxes = np.stack([y0, x0, y0 + h, x0 + w], axis=1)[None]
    classes = rng.integers(0, 9, (1, m)).astype(np.float32)
    scores = rng.uniform(0.2, 1.0, (1, m)).astype(np.float32)
    scores[0, 5:9] = scores[0, 5]
    boxes[0, 20:23] = boxes[0, 19]  # duplicates: NMS keeps the first
    scores[0, 19:23] = 0.9
    return boxes, classes, scores, np.array([m - 7], np.float32)


def _ov_rows(m: int, seed: int):
    """OpenVINO rows [image_id, label, conf, x0, y0, x1, y1]; negative
    image ids end the list."""
    rng = np.random.default_rng(seed)
    x0, y0 = rng.uniform(0, 0.7, (2, m)).astype(np.float32)
    w, h = rng.uniform(0.05, 0.3, (2, m)).astype(np.float32)
    rows = np.stack([np.zeros(m, np.float32),
                     rng.integers(1, 4, m).astype(np.float32),
                     rng.uniform(0.2, 1.0, m).astype(np.float32),
                     x0, y0, x0 + w, y0 + h], axis=1)
    rows[m - 5:, 0] = -1.0
    rows[10:14, 2] = rows[10, 2]
    return (rows[None, None],)


POST_CASES = [
    ("mobilenet-ssd-postprocess", lambda: _post_inputs(100, 1)),
    ("mobilenet-ssd-postprocess_no_count", lambda: _post_inputs(100, 2)[:3]),
    ("tf-ssd", lambda: _post_inputs(300, 3)),  # more rows than the top-256
    ("tflite-ssd-postprocess", lambda: _post_inputs(40, 4)),
    ("ov-person-detection", lambda: _ov_rows(200, 5)),
    ("ov-face-detection", lambda: _ov_rows(300, 6)),
]


@pytest.mark.parametrize("case,make", POST_CASES, ids=[c[0] for c in POST_CASES])
def test_post_and_ov_reduce_match_jax_decoder(case, make):
    mode = case.removesuffix("_no_count")
    opts = {1: mode, 3: "0.45:0.4", 4: "300:300", 5: "300:300"}
    jd, pd = JaxBox(), BoundingBox()
    jd.init(opts)
    pd.init(opts)
    inputs = make()
    jax_reduce, jax_arity = jd._make_reduce()
    port_reduce, port_arity = pd._make_reduce()
    assert port_arity == jax_arity
    want = np.asarray(jax.jit(jax_reduce)(*inputs))
    got = port_reduce(*(torch.from_numpy(a) for a in inputs)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)  # gathers and copies: exact
    assert (got[:, 4] >= pd.threshold).sum() > 5
    # the device rows, kept, equal the host decode path's NMS'd objects
    from nnstreamer_tpu_torch.core.buffer import Buffer as PortBuffer
    from nnstreamer_tpu_torch.decoders.util import nms
    cands = pd._objects_ov(PortBuffer.of(*inputs)) if mode.startswith("ov-") \
        else pd._objects_postprocess(PortBuffer.of(*inputs))
    assert len(cands) <= pd.PRE_NMS_TOPK  # so the top-K cap drops none
    host = nms(cands, pd.iou_threshold)
    kept = got[got[:, 4] >= pd.threshold]
    np.testing.assert_array_equal(kept[:, 4], host[:, 4])
    np.testing.assert_array_equal(kept[:, 5], host[:, 5])


def test_ov_pipeline_fuses_and_matches_jax(tmp_path):
    """appsrc ! tensor_filter (identity) ! tensor_decoder mode=bounding_box
    option1=ov-person-detection: the reduce is fused into the invoke in both
    packages and the detections are equal."""
    import nnstreamer_tpu.core.types as jt
    import nnstreamer_tpu_torch.core.types as tt

    frames = [_ov_rows(50, s)[0][0] for s in (7, 8)]  # (1, 50, 7) each
    results = {}
    for name, pipeline_cls, types, kw in (
            ("jax", JaxPipeline, jt, {}), ("port", Pipeline, tt,
                                           {"device": "cpu"})):
        caps = types.Caps.tensors(types.TensorsConfig(
            types.TensorsInfo.from_strings("7:50:1", "float32")))
        p = pipeline_cls(**kw)
        src = p.add_new("appsrc", caps=caps, data=frames)
        filt = p.add_new("tensor_filter", framework="xla-tpu",
                         model=lambda x: x)
        dec = p.add_new("tensor_decoder", mode="bounding_box",
                        option1="ov-person-detection", option3="0.5:0.4")
        sink = p.add_new("tensor_sink", store=True)
        pipeline_cls.link(src, filt, dec, sink)
        p.run(timeout=120)
        assert p._epilogue_count == 1
        results[name] = [b.meta["detections"] for b in sink.buffers]
    assert all(len(d) > 3 for d in results["jax"])
    _assert_same_detections(results["port"], results["jax"])


# --------------------------------------------------------------------------- #
# the whole detection pipeline
# --------------------------------------------------------------------------- #

SLICE_SIZE, SLICE_CLASSES = 66, 5


@pytest.fixture(scope="module")
def slice_models():
    """The JAX bundle with its class heads' kernels scaled ×64, and the port
    bundle converted from those variables. The scale spreads the sigmoid
    scores over (0, 1): random-weight logits are otherwise within ~0.1 of
    0, every score sits near the 0.5 threshold, and an exp/sigmoid that
    differs by an ulp between XLA and torch could flip a threshold test or
    a ranking. Spread, the kept scores are far apart."""
    jb = _jax_ssd(SLICE_SIZE, "float32", SLICE_CLASSES)
    variables = _numpy_vars(jb)
    for name, leaf in variables["params"].items():
        if name.startswith("cls_head_"):
            leaf["kernel"] = leaf["kernel"] * 64.0
    jax_bundle = dataclasses.replace(
        jb, params=jax.tree_util.tree_map(jax.numpy.asarray, variables),
        metadata={})
    port_bundle = _port_ssd(SLICE_SIZE, "float32", SLICE_CLASSES, variables)
    return jax_bundle, port_bundle


def _detect(pipeline_cls, model, tmp_path, frames=2, auto_fuse=True,
            async_depth=0, **pkw):
    priors = tmp_path / "priors.txt"
    write_box_priors(str(priors), size=SLICE_SIZE)
    labels = tmp_path / "labels.txt"
    labels.write_text("\n".join(f"c{i}" for i in range(SLICE_CLASSES)))
    p = pipeline_cls(**pkw)
    p.auto_fuse = auto_fuse
    src = p.add_new("videotestsrc", width=SLICE_SIZE, height=SLICE_SIZE,
                    pattern="random", num_buffers=frames)
    conv = p.add_new("tensor_converter")
    filt = p.add_new("tensor_filter", framework="xla-tpu", model=model)
    dec = p.add_new("tensor_decoder", mode="bounding_box",
                    option1="mobilenet-ssd", option2=str(labels),
                    option3=str(priors), option4=f"{SLICE_SIZE}:{SLICE_SIZE}",
                    option5=f"{SLICE_SIZE}:{SLICE_SIZE}",
                    async_depth=async_depth)
    sink = p.add_new("tensor_sink", store=True)
    pipeline_cls.link(src, conv, filt, dec, sink)
    p.run(timeout=300)
    assert sink.num_buffers == frames
    return p, [b.meta["detections"] for b in sink.buffers]


def _assert_same_detections(got, want):
    assert [len(d) for d in got] == [len(d) for d in want]
    for dg, dw in zip(got, want):
        for a, b in zip(dg, dw):
            assert a["class"] == b["class"] and a["label"] == b["label"]
            np.testing.assert_allclose(a["box"], b["box"], rtol=1e-4,
                                       atol=1e-5)
            np.testing.assert_allclose(a["score"], b["score"], rtol=1e-4)


def test_detection_pipeline_matches_jax(slice_models, tmp_path):
    jax_bundle, port_bundle = slice_models
    jp, want = _detect(JaxPipeline, jax_bundle, tmp_path)
    tp, got = _detect(Pipeline, port_bundle, tmp_path, device="cpu")
    assert jp._epilogue_count == tp._epilogue_count == 1
    assert all(len(d) > 3 for d in want)
    # precondition of the exact class/count comparison: kept scores lie
    # apart, and off the 0.5 threshold, by far more than the two packages'
    # score difference (~1e-7 here)
    for d in want:
        s = np.sort([x["score"] for x in d])
        assert np.diff(s).min() > 2e-6 and s.min() - 0.5 > 2e-6
    _assert_same_detections(got, want)


@pytest.mark.parametrize("auto_fuse,async_depth", [
    (False, 0),  # host decode + host NMS
    (True, 2),  # fused reduce, readback through the async submit path
    (False, 2),  # decoder runs the device reduce itself on submit
], ids=["unfused", "fused_async", "unfused_async"])
def test_port_decode_paths_agree(slice_models, tmp_path, auto_fuse,
                                 async_depth):
    _, port_bundle = slice_models
    fp, fused = _detect(Pipeline, port_bundle, tmp_path, device="cpu")
    op, other = _detect(Pipeline, port_bundle, tmp_path, auto_fuse=auto_fuse,
                        async_depth=async_depth, device="cpu")
    assert fp._epilogue_count == 1 and op._epilogue_count == int(auto_fuse)
    _assert_same_detections(other, fused)


# --------------------------------------------------------------------------- #
# isolation and device default
# --------------------------------------------------------------------------- #

def test_port_runs_the_slice_without_jax(tmp_path):
    script = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["flax"] = None
        sys.modules["nnstreamer_tpu"] = None
        from nnstreamer_tpu_torch.graph import Pipeline
        from nnstreamer_tpu_torch.models.ssd_mobilenet import write_box_priors
        write_box_priors({str(tmp_path / 'p.txt')!r}, size=64)
        p = Pipeline(device="cpu")
        src = p.add_new("videotestsrc", width=64, height=64,
                        pattern="random", num_buffers=2)
        conv = p.add_new("tensor_converter")
        filt = p.add_new("tensor_filter", framework="xla-tpu",
                         model="zoo://ssd_mobilenet_v2?size=64&num_classes=4"
                               "&width=0.35&dtype=float32")
        dec = p.add_new("tensor_decoder", mode="bounding_box",
                        option1="mobilenet-ssd",
                        option3={str(tmp_path / 'p.txt')!r},
                        option4="64:64", option5="64:64")
        sink = p.add_new("tensor_sink", store=True)
        Pipeline.link(src, conv, filt, dec, sink)
        p.run(timeout=120)
        assert sink.num_buffers == 2 and p._epilogue_count == 1
        loaded = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "flax", "nnstreamer_tpu")
                  and sys.modules[m] is not None]
        assert not loaded, loaded
        print("ok", sum(len(b.meta["detections"]) for b in sink.buffers))
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("ok")


def test_port_sources_import_no_jax():
    import re

    pattern = re.compile(
        r"^\s*(from|import)\s+(jax|flax|nnstreamer_tpu)(\.|\s|$)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "nnstreamer_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    offenders = [f for f in files if pattern.search(open(f).read())]
    assert len(files) > 20 and not offenders, offenders


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch, tmp_path):
    from nnstreamer_tpu_torch.models.zoo import get_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_model("zoo://ssd_mobilenet_v2?size=64&width=0.35")
    p = Pipeline()  # neither the pipeline nor the filter names a device
    src = p.add_new("videotestsrc", width=64, height=64, num_buffers=1)
    filt = p.add_new("tensor_filter", framework="xla-tpu",
                     model=lambda x: x)
    sink = p.add_new("tensor_sink")
    Pipeline.link(src, p.add_new("tensor_converter"), filt, sink)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p.run(timeout=30)
    assert not p.running
