"""The torch port's pose slice against the JAX package, on the CPU.

The same seeded numpy inputs go through both packages: the PoseNet model
(the port's weights converted from the JAX bundle's variables), the pose
decoder's device reduce, and whole ``appsrc ! tensor_converter !
tensor_filter model=zoo://posenet ! tensor_decoder mode=pose_estimation !
tensor_sink`` pipelines in both modes (default and heatmap-offset).

Tolerances: PoseNet outputs as the SSD slice's, float32 at rtol 1e-4 and
bfloat16 at rtol 1e-2 of the output scale. Keypoints: the grid cell each
keypoint lands on must be the same (the heatmaps' best cell leads the
second by far more than the packages differ); positions and scores then
agree to rtol 1e-5, the float32 model difference carried through the
offsets and the sigmoid. Within the port, the device reduce and the host
decode agree bit for bit. TF32 is off (no effect on the CPU).
"""

import dataclasses
import functools
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nnstreamer_tpu.core.types import Caps as JaxCaps  # noqa: E402
from nnstreamer_tpu.decoders.pose import PoseEstimation as JaxPose  # noqa: E402
from nnstreamer_tpu.graph import Pipeline as JaxPipeline  # noqa: E402
from nnstreamer_tpu.models.zoo import get_model as jax_get_model  # noqa: E402
from nnstreamer_tpu_torch.core.buffer import Buffer  # noqa: E402
from nnstreamer_tpu_torch.core.types import Caps  # noqa: E402
from nnstreamer_tpu_torch.decoders.pose import (PoseEstimation,  # noqa: E402
                                                keypoint_rows)
from nnstreamer_tpu_torch.graph import Pipeline  # noqa: E402
from nnstreamer_tpu_torch.models.convert import from_flax_variables  # noqa: E402
from nnstreamer_tpu_torch.models.posenet import make_posenet  # noqa: E402

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

CPU = torch.device("cpu")
SIZE = 65  # a 5×5 keypoint grid


@functools.lru_cache(maxsize=None)
def _jax_posenet(dtype: str):
    return jax_get_model(f"zoo://posenet?size={SIZE}&width=0.25&dtype={dtype}")


def _numpy_vars(bundle):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                  bundle.params)


def _port_posenet(dtype: str, variables):
    pb = make_posenet(device=CPU, width="0.25", size=str(SIZE), dtype=dtype)
    from_flax_variables(variables, pb.module)
    return pb


def _frames(n: int, seed: int = 3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
            for _ in range(n)]


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-4), ("bfloat16", 1e-2)])
def test_posenet_matches_jax(dtype, rtol):
    jb = _jax_posenet(dtype)
    pb = _port_posenet(dtype, _numpy_vars(jb))
    x = _frames(1)[0][None]
    jo = [np.asarray(o) for o in jb.fn()(x)]
    with torch.inference_mode():
        po = pb.fn()(torch.from_numpy(x))
    assert str(pb.out_info) == str(jb.out_info)
    assert [tuple(o.shape) for o in po] == [(1, 5, 5, 17), (1, 5, 5, 34)]
    for j, p in zip(jo, po):
        assert p.dtype == torch.float32 and p.is_contiguous()
        np.testing.assert_allclose(p.numpy(), j, rtol=rtol,
                                   atol=rtol * np.abs(j).max())


# --------------------------------------------------------------------------- #
# decoder device reduce
# --------------------------------------------------------------------------- #

def _heatmaps(seed: int = 4, ties: bool = False):
    rng = np.random.default_rng(seed)
    hm = rng.normal(size=(1, 6, 7, 17)).astype(np.float32)
    off = rng.normal(scale=4.0, size=(1, 6, 7, 34)).astype(np.float32)
    if ties:
        hm[0, :, :, 3] = 1.0  # all cells tie: the first (0, 0) wins
        hm[0, 2, [1, 5], 8] = 9.0  # two cells tie: (2, 1) wins
    return hm, off


def _jax_rows(hm, off):
    """The JAX decoder's own device reduce, through its submit path."""
    from nnstreamer_tpu.core.buffer import Buffer as JaxBuffer

    dec = JaxPose()
    dec.init({4: "heatmap-offset"})
    buf = JaxBuffer.of(jnp.asarray(hm), jnp.asarray(off))
    _, rows, _ = dec.submit(buf, None)
    return np.asarray(rows.host())


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_keypoint_rows_match_jax_reduce(ties):
    hm, off = _heatmaps(ties=ties)
    got = keypoint_rows(torch.from_numpy(hm), torch.from_numpy(off)).numpy()
    np.testing.assert_array_equal(got, _jax_rows(hm, off))
    if ties:  # first maximal index: torch.argmax as jnp.argmax
        assert tuple(got[3, :2]) == (0.0, 0.0)
        assert tuple(got[8, :2]) == (1.0, 2.0)


@pytest.mark.cuda
def test_keypoint_rows_first_max_on_the_card():
    # torch.argmax on CUDA must also return the first maximal index
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    hm, off = _heatmaps(ties=True)
    got = keypoint_rows(torch.from_numpy(hm).cuda(),
                        torch.from_numpy(off).cuda()).cpu().numpy()
    want = keypoint_rows(torch.from_numpy(hm), torch.from_numpy(off)).numpy()
    np.testing.assert_array_equal(got, want)
    assert tuple(got[3, :2]) == (0.0, 0.0) and tuple(got[8, :2]) == (1.0, 2.0)


@pytest.mark.parametrize("mode", ["", "heatmap-offset"])
def test_port_device_reduce_equals_host_decode(mode):
    hm, off = _heatmaps(seed=6)
    dec = PoseEstimation()
    dec.init({2: "65:65", 4: mode})
    buf = Buffer.of(torch.from_numpy(hm), torch.from_numpy(off))
    token = dec.submit(buf, None)
    assert isinstance(token, tuple)  # the device reduce ran
    device_pts = dec.complete(token, None).meta["keypoints"]
    host_pts = dec.keypoints(Buffer.of(hm, off))
    assert device_pts == host_pts  # bit for bit


# --------------------------------------------------------------------------- #
# whole pipelines
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def pose_models():
    jb = _jax_posenet("float32")
    variables = _numpy_vars(jb)
    jax_bundle = dataclasses.replace(
        jb, params=jax.tree_util.tree_map(jnp.asarray, variables), metadata={})
    return jax_bundle, _port_posenet("float32", variables)


def _pose(pipeline_cls, caps_cls, model, frames, mode, async_depth=0, **pkw):
    p = pipeline_cls(**pkw)
    caps = caps_cls("video/x-raw", {"format": "RGB", "width": SIZE,
                                    "height": SIZE, "framerate": Fraction(30)})
    src = p.add_new("appsrc", caps=caps, data=frames)
    conv = p.add_new("tensor_converter")
    filt = p.add_new("tensor_filter", framework="xla-tpu", model=model)
    dec = p.add_new("tensor_decoder", mode="pose_estimation",
                    option1="320:240", option2=f"{SIZE}:{SIZE}",
                    option4=mode, async_depth=async_depth)
    sink = p.add_new("tensor_sink", store=True)
    pipeline_cls.link(src, conv, filt, dec, sink)
    p.run(timeout=300)
    assert sink.num_buffers == len(frames)
    return sink.buffers


def _assert_heatmap_margins(jax_bundle, port_bundle, frames):
    for f in frames:
        jh = np.asarray(jax_bundle.fn()(f[None])[0])[0].reshape(-1, 17)
        with torch.inference_mode():
            ph = port_bundle.fn()(torch.from_numpy(f[None]))[0][0].numpy()
        top2 = np.sort(jh, axis=0)[-2:]
        gap = (top2[1] - top2[0]).min()
        assert gap > 10 * np.abs(jh - ph.reshape(-1, 17)).max()


@pytest.mark.parametrize("mode", ["", "heatmap-offset"],
                         ids=["default", "heatmap_offset"])
def test_pose_pipeline_matches_jax(pose_models, mode):
    jax_bundle, port_bundle = pose_models
    frames = _frames(3, seed=8)
    _assert_heatmap_margins(jax_bundle, port_bundle, frames)
    want = _pose(JaxPipeline, JaxCaps, jax_bundle, frames, mode)
    # the port's submit path runs the device reduce (async_depth > 0)
    got = _pose(Pipeline, Caps, port_bundle, frames, mode, async_depth=2,
                device="cpu")
    host = _pose(Pipeline, Caps, port_bundle, frames, mode, device="cpu")
    for g, h, w in zip(got, host, want):
        gk, wk = np.asarray(g.meta["keypoints"]), np.asarray(w.meta["keypoints"])
        assert gk.shape == wk.shape == (17, 3)
        assert g.meta["keypoints"] == h.meta["keypoints"]
        np.testing.assert_allclose(gk, wk, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(g.memories[0].host(),
                                      h.memories[0].host())
