"""The torch port's segmentation slice against the JAX package, on the CPU.

The same inputs, made from a seed with numpy, go through both packages: the
dilated SAME convolution and the bilinear upsample DeepLab-v3 is built
from, the DeepLab-v3 model (the port's weights converted from the JAX
bundle's variables), and whole ``appsrc ! tensor_converter ! tensor_filter
! tensor_decoder mode=image_segment ! tensor_sink`` pipelines through each
package's ``Pipeline``/``add_new`` API, for all three schemes. The port's
fused, unfused-device and host decode paths must give the same canvases.

Tolerances: float32 convolutions compare at rtol 1e-5 with an absolute
floor of 1e-6 of the output's scale (sums in another order, a few ulp);
the bilinear upsample at 2e-6 absolute on values of order 1 (measured
difference 4.8e-7); DeepLab logits as the SSD slice's: float32 at rtol
1e-4 and bfloat16 at rtol 1e-2 of the output scale. Canvases are compared
bit for bit, after checking that every pixel's two best logits lie far
further apart than the two packages' logits do. TF32 is off (no effect on
the CPU, stated for runs on a card).
"""

import dataclasses
import functools
import os
import subprocess
import sys
import textwrap
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from nnstreamer_tpu.core.types import Caps as JaxCaps  # noqa: E402
from nnstreamer_tpu.decoders.image_segment import _PALETTE as JAX_PALETTE  # noqa: E402
from nnstreamer_tpu.graph import Pipeline as JaxPipeline  # noqa: E402
from nnstreamer_tpu.models.zoo import get_model as jax_get_model  # noqa: E402
from nnstreamer_tpu_torch.core.types import Caps  # noqa: E402
from nnstreamer_tpu_torch.decoders.image_segment import _PALETTE  # noqa: E402
from nnstreamer_tpu_torch.graph import Pipeline  # noqa: E402
from nnstreamer_tpu_torch.models.convert import from_flax_variables  # noqa: E402
from nnstreamer_tpu_torch.models.deeplab import make_deeplab_v3  # noqa: E402
from nnstreamer_tpu_torch.models.layers import conv2d_same, same_padding  # noqa: E402

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, CLASSES = 33, 5


# --------------------------------------------------------------------------- #
# building blocks
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("size", [17, 33])
@pytest.mark.parametrize("rate", [1, 6, 12, 18])
def test_dilated_same_conv_matches_flax(size, rate):
    rng = np.random.default_rng(rate * 100 + size)
    x = rng.normal(size=(1, size, size, 4)).astype(np.float32)
    conv = fnn.Conv(8, (3, 3), padding="SAME", kernel_dilation=(rate, rate),
                    use_bias=False, dtype=jnp.float32)
    params = conv.init(jax.random.PRNGKey(rate), jnp.asarray(x))
    want = np.asarray(conv.apply(params, jnp.asarray(x)))
    tconv = torch.nn.Conv2d(4, 8, 3, padding=0, dilation=rate, bias=False)
    kernel = np.asarray(params["params"]["kernel"])
    tconv.weight.data = torch.from_numpy(
        np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
    with torch.inference_mode():
        got = conv2d_same(tconv, torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (1, size, size, 8)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("size,rate,pads", [
    (17, 18, (18, 18)), (17, 6, (6, 6)), (33, 12, (12, 12)), (3, 18, (18, 18)),
    (10, 2, (2, 2))])
def test_dilated_same_padding_matches_xla(size, rate, pads):
    assert same_padding(size, 3, 1, rate) == pads
    assert tuple(jax.lax.padtype_to_pads(
        (size,), ((3 - 1) * rate + 1,), (1,), "SAME")[0]) == pads


@pytest.mark.parametrize("src,dst", [(17, 257), (3, 33)])
def test_bilinear_upsample_matches_jax_resize(src, dst):
    x = np.random.default_rng(src).normal(size=(1, src, src, 21)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, dst, dst, 21),
                                       method="bilinear"))
    got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=(dst, dst),
                        mode="bilinear", align_corners=False, antialias=False)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=2e-6)


# --------------------------------------------------------------------------- #
# model
# --------------------------------------------------------------------------- #

@functools.lru_cache(maxsize=None)
def _jax_deeplab(dtype: str):
    return jax_get_model(f"zoo://deeplab_v3?size={SIZE}&width=0.25"
                         f"&num_classes={CLASSES}&dtype={dtype}")


def _numpy_vars(bundle):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                  bundle.params)


def _port_deeplab(dtype: str, variables):
    pb = make_deeplab_v3(device=CPU, width="0.25", size=str(SIZE),
                         num_classes=str(CLASSES), dtype=dtype)
    from_flax_variables(variables, pb.module)
    return pb


def _frames(n: int, seed: int = 2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
            for _ in range(n)]


def _logits_both(dtype: str, frame: np.ndarray):
    jb = _jax_deeplab(dtype)
    pb = _port_deeplab(dtype, _numpy_vars(jb))
    jo = np.asarray(jb.fn()(frame[None]))
    with torch.inference_mode():
        po = pb.fn()(torch.from_numpy(frame[None]))
    return jo, po


def test_deeplab_float32_matches_jax():
    jo, po = _logits_both("float32", _frames(1)[0])
    assert jo.shape == tuple(po.shape) == (1, SIZE, SIZE, CLASSES)
    assert po.dtype == torch.float32 and po.is_contiguous()
    np.testing.assert_allclose(po.numpy(), jo, rtol=1e-4,
                               atol=1e-4 * np.abs(jo).max())


def test_deeplab_bfloat16_matches_jax():
    # bf16 keeps 8 significant bits; XLA and torch round convolutions and
    # BatchNorm at different places (the SSD slice's reasoning)
    jo, po = _logits_both("bfloat16", _frames(1)[0])
    assert po.dtype == torch.float32  # the upsample runs after the cast
    np.testing.assert_allclose(po.numpy(), jo, rtol=1e-2,
                               atol=1e-2 * np.abs(jo).max())


def test_deeplab_bundle_io_matches_jax():
    jb = _jax_deeplab("float32")
    pb = _port_deeplab("float32", _numpy_vars(jb))
    assert str(pb.in_info) == str(jb.in_info)
    assert str(pb.out_info) == str(jb.out_info)
    assert pb.out_info[0].dim_string == f"{CLASSES}:{SIZE}:{SIZE}:1"


# --------------------------------------------------------------------------- #
# whole pipelines
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def seg_models():
    """The JAX bundle and the port bundle converted from its variables,
    float32 (the canvas comparison needs the logits' order, not bf16's)."""
    jb = _jax_deeplab("float32")
    variables = _numpy_vars(jb)
    jax_bundle = dataclasses.replace(
        jb, params=jax.tree_util.tree_map(jnp.asarray, variables), metadata={})
    return jax_bundle, _port_deeplab("float32", variables)


def _video_caps(caps_cls, size=SIZE):
    return caps_cls("video/x-raw", {"format": "RGB", "width": size,
                                    "height": size, "framerate": Fraction(30)})


def _segment(pipeline_cls, caps, model, frames, *, scheme="tflite-deeplab",
             converter=True, auto_fuse=True, async_depth=0, **pkw):
    p = pipeline_cls(**pkw)
    p.auto_fuse = auto_fuse
    chain = [p.add_new("appsrc", caps=caps, data=frames)]
    if converter:
        chain.append(p.add_new("tensor_converter"))
    if model is not None:
        chain.append(p.add_new("tensor_filter", framework="xla-tpu",
                               model=model))
    chain.append(p.add_new("tensor_decoder", mode="image_segment",
                           option1=scheme, async_depth=async_depth))
    sink = p.add_new("tensor_sink", store=True)
    chain.append(sink)
    pipeline_cls.link(*chain)
    p.run(timeout=300)
    assert sink.num_buffers == len(frames)
    return p, [np.asarray(b.memories[0].host()) for b in sink.buffers]


def _assert_margins(jax_bundle, port_bundle, frames):
    """Precondition of the bit-exact canvas comparison: at every pixel the
    best logit leads the second by far more than the packages differ."""
    for f in frames:
        jo = np.asarray(jax_bundle.fn()(f[None]))[0]
        with torch.inference_mode():
            po = port_bundle.fn()(torch.from_numpy(f[None]))[0].numpy()
        top2 = np.sort(jo, axis=-1)[..., -2:]
        gap = (top2[..., 1] - top2[..., 0]).min()
        assert gap > 10 * np.abs(jo - po).max(), (gap, np.abs(jo - po).max())


def test_palette_is_the_jax_packages():
    np.testing.assert_array_equal(_PALETTE, JAX_PALETTE)


def test_tflite_deeplab_pipeline_matches_jax(seg_models):
    jax_bundle, port_bundle = seg_models
    frames = _frames(3)
    _assert_margins(jax_bundle, port_bundle, frames)
    jp, want = _segment(JaxPipeline, _video_caps(JaxCaps), jax_bundle, frames)
    tp, got = _segment(Pipeline, _video_caps(Caps), port_bundle, frames,
                       device="cpu")
    assert jp._epilogue_count == tp._epilogue_count == 1
    for g, w in zip(got, want):
        assert g.shape == w.shape == (SIZE, SIZE, 4) and g.dtype == np.uint8
        np.testing.assert_array_equal(g, w)
    # several classes show, so the palette lookup is exercised
    assert len(np.unique(got[0].reshape(-1, 4), axis=0)) > 1


@pytest.mark.parametrize("auto_fuse,async_depth", [
    (False, 0),  # unfused at depth 0: decode() colorizes the device logits
    (True, 2),  # fused colorize, readback through the async submit path
    (False, 2),  # the decoder colorizes device-resident logits on submit
], ids=["unfused_host", "fused_async", "unfused_device"])
def test_port_segment_paths_agree(seg_models, auto_fuse, async_depth):
    _, port_bundle = seg_models
    frames = _frames(2, seed=5)
    fp, fused = _segment(Pipeline, _video_caps(Caps), port_bundle, frames,
                         device="cpu")
    op, other = _segment(Pipeline, _video_caps(Caps), port_bundle, frames,
                         auto_fuse=auto_fuse, async_depth=async_depth,
                         device="cpu")
    assert fp._epilogue_count == 1 and op._epilogue_count == int(auto_fuse)
    for a, b in zip(other, fused):
        np.testing.assert_array_equal(a, b)


def _tensor_caps(types_mod, dims: str, dtypes: str):
    return types_mod.Caps.tensors(types_mod.TensorsConfig(
        types_mod.TensorsInfo.from_strings(dims, dtypes), Fraction(30)))


@pytest.mark.parametrize("scheme,through_filter", [
    ("snpe-deeplab", True), ("snpe-deeplab", False),
    ("snpe-depth", True), ("tflite-deeplab", False)])
def test_schemes_match_jax(scheme, through_filter):
    """Tensors straight from appsrc (host decode), or through an identity
    filter (device-resident: fused colorize for the deeplab schemes)."""
    import nnstreamer_tpu.core.types as jt
    import nnstreamer_tpu_torch.core.types as tt

    rng = np.random.default_rng(9)
    if scheme == "snpe-deeplab":
        frames = [rng.integers(0, 21, (1, 12, 10, 1)).astype(np.float32)
                  for _ in range(2)]
        dims = "1:10:12:1"
    elif scheme == "snpe-depth":
        frames = [rng.uniform(0.5, 9.0, (1, 12, 10, 1)).astype(np.float32)
                  for _ in range(2)]
        dims = "1:10:12:1"
    else:
        frames = [rng.normal(size=(1, 12, 10, 21)).astype(np.float32)
                  for _ in range(2)]
        dims = "21:10:12:1"
    model = (lambda x: x) if through_filter else None
    _, want = _segment(JaxPipeline, _tensor_caps(jt, dims, "float32"), model,
                       frames, scheme=scheme, converter=False)
    tp, got = _segment(Pipeline, _tensor_caps(tt, dims, "float32"), model,
                       frames, scheme=scheme, converter=False, device="cpu")
    assert tp._epilogue_count == int(through_filter
                                     and scheme != "snpe-depth")
    for g, w in zip(got, want):
        assert g.shape == (12, 10, 4)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("scheme", ["tflite-deeplab", "snpe-deeplab"])
@pytest.mark.parametrize("through_filter", [True, False],
                         ids=["device_logits", "host_tensors"])
def test_unfused_depth0_decode_colorizes_device_tensors_only(
        monkeypatch, scheme, through_filter):
    """Unfused, at the default async_depth=0: tensors the filter left on
    the device go through segment_colorize once per frame; tensors that
    arrive on the host decode there. Both give the JAX package's canvas."""
    import nnstreamer_tpu.core.types as jt
    import nnstreamer_tpu_torch.core.types as tt
    from nnstreamer_tpu_torch.ops.kernels import epilogue as tep

    rng = np.random.default_rng(21)
    if scheme == "snpe-deeplab":
        frames = [rng.integers(0, 21, (1, 12, 10, 1)).astype(np.float32)
                  for _ in range(3)]
        dims = "1:10:12:1"
    else:
        frames = [rng.normal(size=(1, 12, 10, 21)).astype(np.float32)
                  for _ in range(3)]
        dims = "21:10:12:1"
    calls = []
    colorize = tep.segment_colorize

    def counting(x, palette, pre_argmaxed=False):
        calls.append(pre_argmaxed)
        return colorize(x, palette, pre_argmaxed)

    monkeypatch.setattr(tep, "segment_colorize", counting)
    model = (lambda x: x) if through_filter else None
    _, want = _segment(JaxPipeline, _tensor_caps(jt, dims, "float32"), model,
                       frames, scheme=scheme, converter=False,
                       auto_fuse=False)
    tp, got = _segment(Pipeline, _tensor_caps(tt, dims, "float32"), model,
                       frames, scheme=scheme, converter=False,
                       auto_fuse=False, device="cpu")
    assert tp._epilogue_count == 0
    pre = scheme == "snpe-deeplab"
    assert calls == ([pre] * len(frames) if through_filter else [])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(np.unique(got[0].reshape(-1, 4), axis=0)) > 1


# --------------------------------------------------------------------------- #
# the family's host decoders: direct_video and font
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("mode,dims,dtype,options", [
    ("direct_video", "3:10:6:1", "uint8", {}),
    ("direct_video", "4:10:6:1", "uint8", {}),
    ("direct_video", "1:10:6:1", "uint8", {}),
    ("font", "12:1", "uint8", {"option1": "96:24"}),
    ("font", "5:1", "float32", {"option1": "128:16"}),
], ids=["video_rgb", "video_rgba", "video_gray", "font_text", "font_numbers"])
def test_host_decoders_match_jax(mode, dims, dtype, options):
    import nnstreamer_tpu.core.types as jt
    import nnstreamer_tpu_torch.core.types as tt

    rng = np.random.default_rng(len(dims))
    info = tt.TensorsInfo.from_strings(dims, dtype)
    if mode == "font" and dtype == "uint8":
        frames = [np.frombuffer(b"cat 7\ndog\x00zz", np.uint8)[None].copy()]
    elif dtype == "uint8":
        frames = [rng.integers(0, 256, info[0].shape, dtype=np.uint8)
                  for _ in range(2)]
    else:
        frames = [rng.normal(size=info[0].shape).astype(np.float32)]
    out = {}
    for name, pipeline_cls, types, kw in (
            ("jax", JaxPipeline, jt, {}), ("port", Pipeline, tt,
                                           {"device": "cpu"})):
        p = pipeline_cls(**kw)
        src = p.add_new("appsrc", caps=_tensor_caps(types, dims, dtype),
                        data=frames)
        dec = p.add_new("tensor_decoder", mode=mode, **options)
        sink = p.add_new("tensor_sink", store=True)
        pipeline_cls.link(src, dec, sink)
        p.run(timeout=60)
        out[name] = sink
    assert out["port"].num_buffers == out["jax"].num_buffers == len(frames)
    assert str(out["port"].sink_pad.caps) == str(out["jax"].sink_pad.caps)
    for g, w in zip(out["port"].buffers, out["jax"].buffers):
        np.testing.assert_array_equal(g.memories[0].host(), w.memories[0].host())
        assert g.meta.get("text") == w.meta.get("text")


# --------------------------------------------------------------------------- #
# isolation
# --------------------------------------------------------------------------- #

SLICE2_MODULES = ("decoders/image_segment.py", "decoders/pose.py",
                  "decoders/font.py", "elements/batch.py", "models/deeplab.py",
                  "models/posenet.py")


def test_slice2_modules_are_in_the_import_guards_walk():
    # test_torch_ssd_slice.test_port_sources_import_no_jax walks every .py
    # under nnstreamer_tpu_torch/; the slice's modules must be among them
    for rel in SLICE2_MODULES:
        assert os.path.isfile(os.path.join(REPO, "nnstreamer_tpu_torch", rel))


def test_port_runs_segmentation_pose_and_batching_without_jax():
    script = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["flax"] = None
        sys.modules["nnstreamer_tpu"] = None
        from nnstreamer_tpu_torch.graph import Pipeline
        n = 0
        for chain in (
            [("tensor_filter", dict(framework="xla-tpu",
              model="zoo://deeplab_v3?size={SIZE}&width=0.25&num_classes=5"
                    "&dtype=float32")),
             ("tensor_decoder", dict(mode="image_segment",
                                     option1="tflite-deeplab"))],
            [("tensor_batch", dict(max_batch=2, budget_ms=1000.0)),
             ("tensor_filter", dict(framework="xla-tpu",
              model="zoo://deeplab_v3?size={SIZE}&width=0.25&num_classes=5"
                    "&dtype=float32&batch=2")),
             ("tensor_unbatch", {{}}),
             ("tensor_decoder", dict(mode="image_segment", async_depth=2))],
            [("tensor_filter", dict(framework="xla-tpu",
              model="zoo://posenet?size={SIZE}&width=0.25&dtype=float32")),
             ("tensor_decoder", dict(mode="pose_estimation",
                                     option2="{SIZE}:{SIZE}",
                                     option4="heatmap-offset",
                                     async_depth=2))]):
            p = Pipeline(device="cpu")
            els = [p.add_new("videotestsrc", width={SIZE}, height={SIZE},
                             pattern="random", num_buffers=3),
                   p.add_new("tensor_converter")]
            els += [p.add_new(kind, **props) for kind, props in chain]
            sink = p.add_new("tensor_sink", store=True)
            Pipeline.link(*els, sink)
            p.run(timeout=120)
            assert sink.num_buffers == 3
            n += sink.num_buffers
        loaded = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "flax", "nnstreamer_tpu")
                  and sys.modules[m] is not None]
        assert not loaded, loaded
        print("ok", n)
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("ok 9")
