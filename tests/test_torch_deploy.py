"""The port's model files (models/deploy.py, the zoo's ``checkpoint=``, the
filter's model-file routing) against the JAX package, on the CPU.

* The five cases of ``tests/test_filter.py::TestSerializedDeployment`` and
  ``tests/test_model_pipelines.py::test_lenet_exports_and_redeploys`` on the
  port, names kept.
* Checkpoints the JAX package writes (``utils.checkpoints.save_variables``)
  from a tree seeded with seed 1 — the zoo's default is seed 0, so a
  restore that does nothing fails — restored by both packages, for every
  family the port restores, through each route the family has: the zoo's
  ``checkpoint=`` option (LeNet, MobileNet-v1 and v2, as in JAX),
  ``load_checkpointed``, and the filter's ``model=<ckpt> custom="arch=..."``.
  Outputs against JAX's ``load_checkpointed`` within the tolerances the
  families' own tests state (LeNet rtol 1e-5 / atol 1e-6; MobileNet-v1 and
  v2 rtol 1e-4 / atol 1e-9, their logits ~1e-7 at flax's initial weights;
  SSD, DeepLab and PoseNet rtol 1e-4 with an absolute floor of 1e-4 of the
  output's scale; the LSTM cell rtol 1e-5 / atol 1e-6; the stream
  transformer rtol 1e-5 / atol 1e-5; the MoE transformer rtol 2e-4 / atol
  2e-5; the causal LM rtol 1e-4 / atol 1e-5), labels exact; the memoized zoo bundle serves its
  seed-0 outputs after every restore.
* The dtype case: a float32 file restored into a ``dtype=bfloat16`` arch.
  JAX keeps the file's float32 leaves and its bf16 modules cast each kernel
  to bf16 at the call; the port copies the file into the module's bf16
  kernels at load (its BatchNorm parameters and statistics stay float32,
  as JAX's). The test pins that the port's bf16 kernels are the file's
  float32 leaves rounded to bf16 bit for bit — what JAX's convolutions
  compute with — and the outputs within the bf16 tolerance of the SSD
  slice (1e-2 of the output scale).
* Chosen divergence: the port's ``.jaxexport`` holds a ``torch.export``
  program archive (a zip), not JAX's StableHLO; a StableHLO artifact the
  JAX package wrote is refused with a ``ValueError`` naming the format.
"""

import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from nnstreamer_tpu.models import deploy as jdeploy  # noqa: E402
from nnstreamer_tpu.models.zoo import get_model as jget  # noqa: E402
from nnstreamer_tpu.utils.checkpoints import save_variables as jsave  # noqa: E402
from nnstreamer_tpu_torch.core.buffer import TensorMemory  # noqa: E402
from nnstreamer_tpu_torch.filters.base import FilterProps, detect_framework  # noqa: E402
from nnstreamer_tpu_torch.filters.torch_cuda import (TorchCudaFilter,  # noqa: E402
                                                     resolve_model)
from nnstreamer_tpu_torch.models import (export_model, get_model,  # noqa: E402
                                         load_checkpointed, load_exported)
from nnstreamer_tpu_torch.models.convert import to_flax_variables  # noqa: E402
from nnstreamer_tpu_torch.utils.checkpoints import save_variables  # noqa: E402

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _to_torch(x):
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


def _port_out(bundle, xs):
    with torch.inference_mode():
        out = bundle.fn()(*[_to_torch(x) for x in xs])
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return [o.float().numpy() for o in outs]


def _jax_out(bundle, xs, jit=True):
    # the tree as an argument: a restored tree's leaves are numpy arrays,
    # which the causal LM would index with a tracer if jit closed over them
    params = jax.tree_util.tree_map(jax.numpy.asarray, bundle.params)
    out = (jax.jit(bundle.apply) if jit else bundle.apply)(params, *xs)
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return [np.asarray(o, np.float32) for o in outs]


# --------------------------------------------------------------------------- #
# tests/test_filter.py::TestSerializedDeployment on the port
# --------------------------------------------------------------------------- #

class TestSerializedDeployment:
    def test_export_load_roundtrip_exact(self, tmp_path):
        """Deterministic fn: exported artifact reproduces exact outputs."""
        path = str(tmp_path / "double.jaxexport")
        export_model(path, lambda x: x * 2.0 + 1.0,
                     example_args=[np.zeros((2, 3), np.float32)])
        bundle = load_exported(path, device="cpu")
        out = bundle.fn()(torch.ones((2, 3)))[0]
        np.testing.assert_allclose(out.numpy(), np.full((2, 3), 3.0))
        assert bundle.in_info[0].shape == (2, 3)
        assert bundle.out_info[0].shape == (2, 3)
        assert "cpu" in bundle.metadata["platforms"]
        assert "cuda" in bundle.metadata["platforms"]

    def test_cross_process_export_then_pipeline_deploy(self, tmp_path):
        """Export in ONE process, load and invoke end to end in ANOTHER via
        a pipeline — no Python model source in the consumer; the served
        program computes the zoo bundle's function."""
        spec = "zoo://mobilenet_v2?width=0.25&size=32&num_classes=7&dtype=float32"
        path = str(tmp_path / "model.jaxexport")
        code = (
            "from nnstreamer_tpu_torch.models import export_model, get_model\n"
            f"export_model({path!r}, get_model({spec!r}, device='cpu'))\n")
        r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, timeout=300, cwd=REPO)
        assert r.returncode == 0, r.stderr[-2000:]

        from nnstreamer_tpu_torch.graph import Pipeline

        p = Pipeline(device="cpu")
        src = p.add_new("videotestsrc", width=32, height=32, num_buffers=2,
                        pattern="random")
        conv = p.add_new("tensor_converter")
        filt = p.add_new("tensor_filter", model=path)  # framework=auto
        sink = p.add_new("tensor_sink", store=True)
        Pipeline.link(src, conv, filt, sink)
        p.run(timeout=180)
        assert filt.resolved_framework == "xla-tpu"
        assert sink.num_buffers == 2
        assert sink.buffers[0].memories[0].host().shape == (1, 7)
        x = np.random.default_rng(2).integers(0, 256, (1, 32, 32, 3), dtype=np.uint8)
        np.testing.assert_array_equal(
            _port_out(load_exported(path, device="cpu"), [x])[0],
            _port_out(get_model(spec, device="cpu"), [x])[0])

    def test_checkpoint_plus_arch_deploy(self, tmp_path):
        """Trained-weights deployment: params checkpoint + arch= glue."""
        arch = "zoo://mobilenet_v2?width=0.25&size=32&num_classes=5&dtype=float32"
        bundle = get_model(arch, device="cpu")
        ckpt = str(tmp_path / "params.msgpack")
        save_variables(ckpt, to_flax_variables(bundle.module))
        restored = load_checkpointed(
            ckpt, "zoo://mobilenet_v2", device="cpu", width="0.25", size="32",
            num_classes="5", dtype="float32")
        x = np.random.default_rng(0).normal(size=(1, 32, 32, 3)).astype(np.float32)
        np.testing.assert_allclose(_port_out(bundle, [x])[0],
                                   _port_out(restored, [x])[0], rtol=1e-6)
        assert restored.module is not bundle.module
        assert restored.metadata["deployed_from"] == ckpt
        assert restored.metadata["arch"] == "zoo://mobilenet_v2"

    def test_checkpoint_via_filter_custom_arch(self, tmp_path):
        """Pipeline-string form: model=<ckpt> custom="arch=...;arch_*"."""
        assert detect_framework("foo.jaxexport") == "xla-tpu"
        assert detect_framework("foo.msgpack") == "xla-tpu"

        bundle = get_model("zoo://lstm_cell?features=4&input_size=3", device="cpu")
        ckpt = str(tmp_path / "cell.msgpack")
        save_variables(ckpt, to_flax_variables(bundle.module))
        f = TorchCudaFilter()
        f.open(FilterProps(
            model=ckpt, device=CPU,
            custom="sync=true,arch=zoo://lstm_cell,arch_features=4,"
                   "arch_input_size=3"))
        x = np.zeros((1, 3), np.float32)
        h = np.zeros((1, 4), np.float32)
        c = np.zeros((1, 4), np.float32)
        outs = f.invoke([TensorMemory(x), TensorMemory(h), TensorMemory(c)])
        ref = _port_out(bundle, [x, h, c])
        for o, r in zip(outs, ref):
            np.testing.assert_allclose(o.host(), r, rtol=1e-6)
        # a second filter over the same checkpoint gets a bundle of its own,
        # as in JAX, and neither coalesces with the seeded zoo bundle
        g, z = TorchCudaFilter(), TorchCudaFilter()
        g.open(FilterProps(model=ckpt, device=CPU, custom=f.props.custom))
        z.open(FilterProps(model="zoo://lstm_cell?features=4&input_size=3",
                           device=CPU, custom="sync=true"))
        assert g._bundle is not f._bundle
        assert len({f.coalesce_token, g.coalesce_token, z.coalesce_token}) == 3

    def test_missing_arch_rejected(self, tmp_path):
        ckpt = tmp_path / "w.msgpack"
        ckpt.write_bytes(b"x")
        with pytest.raises(ValueError, match="arch"):
            resolve_model(str(ckpt), device=CPU)


def test_lenet_exports_and_redeploys(tmp_path):
    bundle = get_model("zoo://mnist", device="cpu")
    assert bundle is get_model("zoo://lenet", device="cpu")  # alias, one memo entry
    path = str(tmp_path / "mnist.jaxexport")
    export_model(path, bundle)
    back = load_exported(path, device="cpu")
    x = np.random.default_rng(0).integers(0, 255, (1, 28, 28, 1)).astype(np.uint8)
    np.testing.assert_allclose(_port_out(bundle, [x])[0], _port_out(back, [x])[0],
                               rtol=1e-5, atol=1e-6)
    assert back.in_info[0].shape == (1, 28, 28, 1)
    assert str(back.in_info[0].dtype) == "uint8"
    assert back.out_info[0].shape == (1, 10)


# --------------------------------------------------------------------------- #
# the exported artifact: the port's own (a chosen divergence)
# --------------------------------------------------------------------------- #

def test_artifact_is_a_torch_export_archive_and_stablehlo_is_refused(tmp_path):
    """The port writes a torch.export archive under the JAX extensions; a
    JAX-written StableHLO artifact is refused naming its format (never a
    zip error)."""
    ours = str(tmp_path / "ours.jaxexport")
    export_model(ours, lambda x: x + 1.0, example_args=[np.zeros(3, np.float32)])
    assert zipfile.is_zipfile(ours)
    theirs = str(tmp_path / "theirs.jaxexport")
    jdeploy.export_model(theirs, lambda x: x + 1.0,
                         example_args=[np.zeros(3, np.float32)])
    assert not zipfile.is_zipfile(theirs)
    with pytest.raises(ValueError, match="StableHLO"):
        load_exported(theirs, device="cpu")
    with pytest.raises(ValueError, match="StableHLO"):
        resolve_model(theirs, device=CPU)
    # .pt2 stays the torch filter's, as the JAX config routes it
    assert detect_framework("m.pt2") == "torch"


def test_export_keeps_multiple_outputs_and_the_device_argument(tmp_path):
    """A multi-output bundle (SSD) exports with every output's shape, and a
    program whose graph makes a tensor on its device (the uint8 preprocess's
    ``torch.full(..., device=x.device)``) loads onto the caller's device."""
    spec = "zoo://ssd_mobilenet_v2?width=0.35&size=64&num_classes=4&dtype=float32"
    bundle = get_model(spec, device="cpu")
    path = str(tmp_path / "ssd.jaxexport")
    export_model(path, bundle)
    back = load_exported(path, device="cpu")
    assert [i.shape for i in back.out_info] == [i.shape for i in bundle.out_info]
    x = np.random.default_rng(3).integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)
    for a, b in zip(_port_out(bundle, [x]), _port_out(back, [x])):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="platforms"):
        export_model(path, bundle, platforms=("cpu", "tpu"))


def test_export_with_no_in_info_needs_example_args(tmp_path):
    with pytest.raises(ValueError, match="example_args"):
        export_model(str(tmp_path / "f.jaxexport"), lambda x: x)


def test_filter_routes_model_files_as_jax(tmp_path):
    """The routing of the JAX filter (xla.py:88-110): bare names to the
    zoo, ``.tflite`` refused (not ported), exported programs to
    load_exported, checkpoints to load_checkpointed."""
    assert resolve_model("lenet", device=CPU) is get_model("zoo://lenet", device="cpu")
    with pytest.raises(ValueError, match="tflite_import"):
        resolve_model(str(tmp_path / "m.tflite"), device=CPU)
    with pytest.raises(FileNotFoundError):
        resolve_model(str(tmp_path / "missing.jaxexport"), device=CPU)
    with pytest.raises(ValueError, match="orbax"):
        resolve_model(str(tmp_path), {"arch": "zoo://lenet"}, device=CPU)


# --------------------------------------------------------------------------- #
# checkpoints written by JAX from a seed-1 tree, restored by both packages
# --------------------------------------------------------------------------- #

def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _lm_inputs(b):
    m = b.metadata
    flat, M, hd = m["layers"] * m["batch"] * m["heads"], m["max_len"], m["head_dim"]
    rng = np.random.default_rng(5)
    return [np.array([[17]], np.int32),
            rng.normal(size=(flat, M, hd)).astype(np.float32) * 0.1,
            rng.normal(size=(flat, M, hd)).astype(np.float32) * 0.1,
            np.array([9], np.int32)]


def _lstm_inputs(_):
    rng = np.random.default_rng(6)
    return [rng.normal(size=(1, 3)).astype(np.float32),
            rng.normal(size=(1, 4)).astype(np.float32),
            rng.normal(size=(1, 4)).astype(np.float32)]


def _scaled(rtol):
    return lambda want: dict(rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-30))


#: family → (zoo name, arch options, inputs, tolerance of an output, the
#: zoo's checkpoint= option exists in both packages, labels to compare)
FAMILIES = {
    "lenet": ("lenet", {}, lambda b: [_u8((1, 28, 28, 1), 1)],
              lambda w: dict(rtol=1e-5, atol=1e-6), True, True),
    "mobilenet_v1": ("mobilenet_v1", dict(width="0.25", size="32",
                                          num_classes="16", dtype="float32"),
                     lambda b: [_u8((2, 32, 32, 3), 2)],
                     lambda w: dict(rtol=1e-4, atol=1e-9), True, True),
    "mobilenet_v2": ("mobilenet_v2", dict(width="0.25", size="32",
                                          num_classes="16", dtype="float32"),
                     lambda b: [_u8((1, 32, 32, 3), 3)],
                     lambda w: dict(rtol=1e-4, atol=1e-9), True, True),
    "ssd_mobilenet_v2": ("ssd_mobilenet_v2", dict(width="0.35", size="64",
                                                  num_classes="4", dtype="float32"),
                         lambda b: [_u8((1, 64, 64, 3), 4)], _scaled(1e-4),
                         False, False),
    "deeplab_v3": ("deeplab_v3", dict(width="0.25", size="33", num_classes="5",
                                      dtype="float32"),
                   lambda b: [_u8((1, 33, 33, 3), 7)], _scaled(1e-4), False, False),
    "posenet": ("posenet", dict(width="0.25", size="33", dtype="float32"),
                lambda b: [_u8((1, 33, 33, 3), 8)], _scaled(1e-4), False, False),
    "lstm_cell": ("lstm_cell", dict(features="4", input_size="3"), _lstm_inputs,
                  lambda w: dict(rtol=1e-5, atol=1e-6), False, False),
    "stream_transformer": ("stream_transformer", dict(layers="1", dim="32", heads="4",
                                                      seq="16", dtype="float32"),
                           lambda b: [_normal((1, 16, 32), 11)],
                           lambda w: dict(rtol=1e-5, atol=1e-5), False, False),
    "moe_transformer": ("moe_transformer", dict(layers="2", dim="32", heads="4",
                                                experts="4", seq="16", dtype="float32"),
                        lambda b: [_normal((1, 16, 32), 12)],
                        lambda w: dict(rtol=2e-4, atol=2e-5), False, False),
    "causal_lm": ("causal_lm", dict(vocab="64", dim="32", heads="4", layers="2",
                                    max_len="16"), _lm_inputs,
                  lambda w: dict(rtol=1e-4, atol=1e-5), False, False),
}


def _jax_checkpoint(tmp_path, name, opts):
    """A .msgpack JAX writes from its zoo tree at seed 1."""
    qs = "&".join(f"{k}={v}" for k, v in {**opts, "seed": "1"}.items())
    path = str(tmp_path / f"{name}.msgpack")
    jsave(path, jget(f"zoo://{name}?{qs}").params)
    return path


def _spec(name, opts, **more):
    qs = "&".join(f"{k}={v}" for k, v in {**opts, **more}.items())
    return f"zoo://{name}" + (f"?{qs}" if qs else "")


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_jax_checkpoint_restores_in_both_packages(tmp_path, family):
    name, opts, inputs, tol, zoo_option, labels = FAMILIES[family]
    ckpt = _jax_checkpoint(tmp_path, name, opts)
    jb = jdeploy.load_checkpointed(ckpt, f"zoo://{name}", **opts)
    xs = inputs(jb)
    want = _jax_out(jb, xs)
    memo = get_model(_spec(name, opts), device="cpu")
    before = _port_out(memo, xs)

    routes = {"load_checkpointed": load_checkpointed(
        ckpt, f"zoo://{name}", device="cpu", **opts)}
    f = TorchCudaFilter()
    f.open(FilterProps(model=ckpt, device=CPU, custom=",".join(
        [f"arch=zoo://{name}"] + [f"arch_{k}={v}" for k, v in opts.items()])))
    routes["filter"] = f._bundle
    if zoo_option:
        routes["zoo checkpoint="] = get_model(_spec(name, opts, checkpoint=ckpt),
                                              device="cpu")
    for route, bundle in routes.items():
        got = _port_out(bundle, xs)
        assert len(got) == len(want), route
        for g, w in zip(got, want):
            assert g.shape == w.shape, route
            np.testing.assert_allclose(g, w, err_msg=route, **tol(w))
            if labels:
                np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1), err_msg=route)
        assert bundle is not memo and bundle.module is not memo.module or \
            bundle.module is None, route
        # a restore that did nothing would serve the seed-0 weights
        assert any(not np.array_equal(g, b) for g, b in zip(got, before)), route
    # the memoized zoo bundle (other filters' weights) is untouched
    assert get_model(_spec(name, opts), device="cpu") is memo
    for a, b in zip(_port_out(memo, xs), before):
        np.testing.assert_array_equal(a, b)
    f.close()


def test_checkpoint_option_is_not_memoized(tmp_path):
    """A spec naming a checkpoint path builds anew each time (the file may
    change between loads), as the JAX zoo skips its memo."""
    opts = FAMILIES["lenet"][1]
    ckpt = _jax_checkpoint(tmp_path, "lenet", opts)
    spec = _spec("lenet", opts, checkpoint=ckpt)
    assert get_model(spec, device="cpu") is not get_model(spec, device="cpu")
    assert jget(spec) is not jget(spec)


def test_float32_file_into_a_bfloat16_arch(tmp_path):
    """JAX keeps the file's float32 leaves and casts each kernel to bf16 at
    the call; the port rounds them into its bf16 kernels at load. The same
    bf16 kernels either way, and the outputs within the bf16 tolerance."""
    opts = dict(width="0.25", size="32", num_classes="16", dtype="float32")
    ckpt = _jax_checkpoint(tmp_path, "mobilenet_v2", opts)
    bf = {**opts, "dtype": "bfloat16"}
    jb = jdeploy.load_checkpointed(ckpt, "zoo://mobilenet_v2", **bf)
    pb = load_checkpointed(ckpt, "zoo://mobilenet_v2", device="cpu", **bf)
    jleaves = dict(jax.tree_util.tree_leaves_with_path(jb.params))
    assert {np.asarray(v).dtype for v in jleaves.values()} == {np.dtype(np.float32)}
    conv = pb.module.stem.conv.weight
    assert conv.dtype == torch.bfloat16
    assert pb.module.stem.bn.running_var.dtype == torch.float32
    file_kernel = np.asarray(jb.params["params"]["ConvBNReLU_0"]["Conv_0"]["kernel"])
    rounded = torch.from_numpy(file_kernel.copy()).to(torch.bfloat16).permute(3, 2, 0, 1)
    assert torch.equal(conv.view(torch.int16), rounded.contiguous().view(torch.int16))
    x = _u8((1, 32, 32, 3), 9)
    # op by op, as the slices' bf16 comparisons run JAX: under jit XLA
    # keeps a fusion's bf16 intermediates in float32
    want = _jax_out(jb, [x], jit=False)[0]
    got = _port_out(pb, [x])[0]
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2 * np.abs(want).max())


def test_arch_py_file_restores_its_parameter_tree(tmp_path):
    """``arch=<file>.py``: a make_model bundle written as a function of a
    parameter tree gets the file's tree, in the file's dtypes."""
    src = ("import numpy as np\n"
           "def make_model(device=None, **_):\n"
           "    import torch\n"
           "    return {'name': 'affine', 'apply': lambda p, x: x * p['w'] + p['b'],\n"
           "            'params': {'w': torch.ones(3, device=device),\n"
           "                       'b': torch.zeros(3, device=device)}}\n")
    py = tmp_path / "affine.py"
    py.write_text(src)
    ckpt = str(tmp_path / "affine.msgpack")
    jsave(ckpt, {"w": np.arange(3, dtype=np.float32), "b": np.full(3, 2.0, np.float32)})
    b = load_checkpointed(ckpt, str(py), device="cpu")
    np.testing.assert_array_equal(b.fn()(torch.ones(3)).numpy(), [2.0, 3.0, 4.0])
    assert b.metadata["arch"] == str(py)
    with pytest.raises(ValueError, match="no parameters"):
        load_checkpointed(ckpt, "zoo://passthrough", device="cpu")
