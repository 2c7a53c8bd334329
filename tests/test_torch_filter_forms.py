"""The filter's ``(fn, params)`` and ``.py`` model forms
(nnstreamer_tpu_torch/filters/torch_cuda.py) against the JAX filter's
(nnstreamer_tpu/filters/xla.py ``resolve_model``, ``_bundle_from_pyfile``).

A ``.py`` model file exports ``make_model(**options)``: the JAX filter
calls it with the filter's model options, the port with those options and
``device=`` (its model is torch code on the filter's device). Each test
writes a JAX file and its torch twin to ``tmp_path`` and sends the same
numpy inputs through ``XLAFilter`` and ``TorchCudaFilter``, through
``appsrc ! tensor_filter ! tensor_sink`` in both packages and through both
``SingleShot``s. The models are elementwise operations on float32
values (a product and a maximum, no sum XLA could contract into an
FMA), which both packages round alike: outputs are held bit for bit;
the one matrix product within rtol/atol 1e-6 (XLA and torch sum its four
terms in other orders). The dict form's string infos negotiate the same
caps. The errors are the JAX filter's: a missing file raises
``FileNotFoundError``, a file without ``make_model`` ``ValueError``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from nnstreamer_tpu.core import Caps as JCaps  # noqa: E402
from nnstreamer_tpu.core import TensorsConfig as JConfig  # noqa: E402
from nnstreamer_tpu.core import TensorsInfo as JInfo  # noqa: E402
from nnstreamer_tpu.core.buffer import TensorMemory as JMem  # noqa: E402
from nnstreamer_tpu.filters.base import FilterProps as JProps  # noqa: E402
from nnstreamer_tpu.filters.xla import XLAFilter  # noqa: E402
from nnstreamer_tpu.filters.xla import resolve_model as jresolve  # noqa: E402
from nnstreamer_tpu.graph import Pipeline as JPipeline  # noqa: E402
from nnstreamer_tpu.single import SingleShot as JSingle  # noqa: E402
from nnstreamer_tpu_torch.core.buffer import TensorMemory as TMem  # noqa: E402
from nnstreamer_tpu_torch.core.types import (Caps, TensorsConfig,  # noqa: E402
                                             TensorsInfo)
from nnstreamer_tpu_torch.filters.base import FilterProps as TProps  # noqa: E402
from nnstreamer_tpu_torch.filters.torch_cuda import (  # noqa: E402
    TorchCudaFilter, resolve_model)
from nnstreamer_tpu_torch.graph import Pipeline  # noqa: E402
from nnstreamer_tpu_torch.models.zoo import ModelBundle  # noqa: E402
from nnstreamer_tpu_torch.single import SingleShot  # noqa: E402

CPU = torch.device("cpu")

#: make_model files, (JAX, torch): the dict form with params and string
#: infos, the dict form without params, and a ModelBundle
FILES = {
    "dict": ("""
import jax.numpy as jnp


def make_model(scale="2", shift="0.5"):
    p = {"w": jnp.full((4,), float(scale), jnp.float32),
         "b": jnp.full((4,), float(shift), jnp.float32)}
    return {"name": "affine",
            "apply": lambda p, x: jnp.maximum(x * p["w"], p["b"]),
            "params": p, "in_info": ("4:2", "float32"),
            "out_info": ("4:2", "float32")}
""", """
import torch


def make_model(device=None, scale="2", shift="0.5"):
    p = {"w": torch.full((4,), float(scale), device=device),
         "b": torch.full((4,), float(shift), device=device)}
    return {"name": "affine",
            "apply": lambda p, x: torch.maximum(x * p["w"], p["b"]),
            "params": p, "in_info": ("4:2", "float32"),
            "out_info": ("4:2", "float32")}
"""),
    "plain": ("""
def make_model(scale="3"):
    s = float(scale)
    return {"apply": lambda x: x * s}
""", """
import torch


def make_model(device=None, scale="3"):
    s = float(scale)
    return {"apply": lambda x: x * torch.full((), s, device=device)}
"""),
    "bundle": ("""
import jax.numpy as jnp
from nnstreamer_tpu.core.types import TensorsInfo
from nnstreamer_tpu.models.zoo import ModelBundle


def make_model(scale="2"):
    info = TensorsInfo.from_strings("4:2", "float32")
    return ModelBundle("scaled", lambda p, x: x * p,
                       params=jnp.full((), float(scale), jnp.float32),
                       in_info=info, out_info=info)
""", """
import torch
from nnstreamer_tpu_torch.core.types import TensorsInfo
from nnstreamer_tpu_torch.models.zoo import ModelBundle


def make_model(device=None, scale="2"):
    info = TensorsInfo.from_strings("4:2", "float32")
    w = torch.full((), float(scale), device=device)
    return ModelBundle("scaled", lambda x: x * w, device=device,
                       in_info=info, out_info=info)
"""),
}


def _files(tmp_path, kind):
    jsrc, tsrc = FILES[kind]
    jpath, tpath = tmp_path / f"j_{kind}.py", tmp_path / f"t_{kind}.py"
    jpath.write_text(jsrc)
    tpath.write_text(tsrc)
    return str(jpath), str(tpath)


def _x(seed=0, shape=(2, 4)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _pair_fns():
    def jfn(p, x):
        return jnp.maximum(x * p["w"], p["b"])

    def tfn(p, x):
        return torch.maximum(x * p["w"], p["b"])

    w = np.linspace(-2.0, 3.0, 4).astype(np.float32)
    b = np.float32(0.25) * np.arange(4, dtype=np.float32)
    return ((jfn, {"w": jnp.asarray(w), "b": jnp.asarray(b)}),
            (tfn, {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}))


def _filters(jmodel, tmodel, custom=""):
    j = XLAFilter()
    j.open(JProps(model=jmodel, custom=custom))
    t = TorchCudaFilter()
    t.open(TProps(model=tmodel, custom=custom, device=CPU))
    return j, t


def _both(j, t, x):
    want = np.asarray(j.invoke([JMem(x)])[0].host())
    got = t.invoke([TMem(x)])[0].host()
    return got, want


# --------------------------------------------------------------------------- #
# the filters
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("kind,custom,scale", [
    ("dict", "", None), ("dict", "scale=3,shift=-1.25", None),
    ("plain", "", 3.0), ("plain", "scale=0.5", 0.5),
    ("bundle", "", None), ("bundle", "scale=-4", None)])
def test_py_model_files_match_jax(tmp_path, kind, custom, scale):
    jpath, tpath = _files(tmp_path, kind)
    j, t = _filters(jpath, tpath, custom)
    assert str(t.get_model_info()[0]) == str(j.get_model_info()[0])
    assert str(t.get_model_info()[1]) == str(j.get_model_info()[1])
    for seed in range(3):
        x = _x(seed)
        got, want = _both(j, t, x)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
        if scale is not None:
            assert got.tobytes() == (x * np.float32(scale)).tobytes()
    t.close()


def test_dict_form_string_infos_are_tensors_infos(tmp_path):
    jpath, tpath = _files(tmp_path, "dict")
    jb, tb = jresolve(jpath), resolve_model(tpath, device=CPU)
    assert isinstance(tb, ModelBundle) and tb.name == jb.name == "affine"
    assert isinstance(tb.in_info, TensorsInfo)
    assert str(tb.in_info) == str(jb.in_info) == str(
        TensorsInfo.from_strings("4:2", "float32"))
    assert str(tb.out_info) == str(jb.out_info)
    # the params ride along, as the JAX bundle's do
    assert set(tb.params) == {"w", "b"} and tb.apply_params is not None
    assert torch.equal(tb.apply(torch.ones(2, 4)),
                       tb.apply_params(tb.params, torch.ones(2, 4)))


def test_make_model_gets_the_filters_device(tmp_path):
    path = tmp_path / "dev.py"
    path.write_text("""
seen = []


def make_model(device=None, **options):
    seen.append((device, options))
    return {"apply": lambda x: x}
""")
    t = TorchCudaFilter()
    t.open(TProps(model=str(path), custom="a=1,bucket=4,sync=true", device=CPU))
    mod = t._bundle.apply.__globals__
    # the filter's own options never reach the model's
    assert mod["seen"] == [(CPU, {"a": "1"})]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pair_form_matches_jax(seed):
    jpair, tpair = _pair_fns()
    j, t = _filters(jpair, tpair)
    got, want = _both(j, t, _x(seed))
    assert got.tobytes() == want.tobytes()
    tb = resolve_model(tpair, device=CPU)
    assert tb.name == "tfn" and tb.params is tpair[1]
    assert tb.apply_params is tpair[0]


def test_pair_form_of_a_matrix_product_matches_jax_within_rounding():
    w = np.random.default_rng(5).standard_normal((4, 3)).astype(np.float32)
    j, t = _filters((lambda p, x: x @ p, jnp.asarray(w)),
                    (lambda p, x: x @ p, torch.from_numpy(w)))
    got, want = _both(j, t, _x(4))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------- #
# through tensor_filter and SingleShot
# --------------------------------------------------------------------------- #

def _pipeline(pipe_cls, caps, model, custom, frames, **kw):
    p = pipe_cls(**kw)
    src = p.add_new("appsrc", caps=caps, data=list(frames))
    filt = p.add_new("tensor_filter", framework="xla-tpu", model=model,
                     custom=custom)
    sink = p.add_new("tensor_sink", store=True)
    pipe_cls.link(src, filt, sink)
    p.run(timeout=60)
    return ([np.asarray(b.memories[0].host()) for b in sink.buffers],
            str(filt.src_pads[0].caps), str(filt.sink_pads[0].caps))


@pytest.mark.parametrize("form", ["dict", "plain", "bundle", "pair"])
def test_forms_through_tensor_filter_and_single_shot_match_jax(tmp_path, form):
    if form == "pair":
        jmodel, tmodel = _pair_fns()
        custom = ""
    else:
        jmodel, tmodel = _files(tmp_path, form)
        custom = "scale=1.5"
    frames = [_x(seed) for seed in range(4)]
    jcaps = JCaps.tensors(JConfig(JInfo.from_strings("4:2", "float32"), 30))
    tcaps = Caps.tensors(TensorsConfig(TensorsInfo.from_strings("4:2", "float32"), 30))
    want, jsrc_caps, jsink_caps = _pipeline(JPipeline, jcaps, jmodel, custom, frames)
    got, tsrc_caps, tsink_caps = _pipeline(Pipeline, tcaps, tmodel, custom, frames,
                                           device="cpu")
    assert (tsrc_caps, tsink_caps) == (jsrc_caps, jsink_caps)
    assert len(got) == len(want) == len(frames)
    assert all(g.tobytes() == w.tobytes() for g, w in zip(got, want))
    js = JSingle(model=jmodel, framework="xla-tpu", custom=custom)
    with SingleShot(model=tmodel, framework="torch-cuda", custom=custom,
                    device="cpu") as ts:
        for x, w in zip(frames, want):
            got1 = ts.invoke(x)[0]
            want1 = np.asarray(js.invoke(x)[0])
            assert np.asarray(got1).tobytes() == want1.tobytes() == w.tobytes()
    js.close()


# --------------------------------------------------------------------------- #
# errors
# --------------------------------------------------------------------------- #

def test_missing_py_file_raises_like_jax(tmp_path):
    missing = str(tmp_path / "nope.py")
    with pytest.raises(FileNotFoundError):
        jresolve(missing)
    with pytest.raises(FileNotFoundError):
        resolve_model(missing, device=CPU)


def test_py_file_without_make_model_raises_like_jax(tmp_path):
    path = tmp_path / "empty_model.py"
    path.write_text("x = 1\n")
    with pytest.raises(ValueError, match="must export make_model"):
        jresolve(str(path))
    with pytest.raises(ValueError, match="must export make_model"):
        resolve_model(str(path), device=CPU)


def test_bad_info_spec_raises_like_jax(tmp_path):
    src = 'def make_model(**_):\n    return {"apply": abs, "in_info": 5}\n'
    path = tmp_path / "bad_info.py"
    path.write_text(src)
    with pytest.raises(ValueError, match="bad tensor info spec"):
        jresolve(str(path))
    with pytest.raises(ValueError, match="bad tensor info spec"):
        resolve_model(str(path), device=CPU)


@pytest.mark.parametrize("path", ["/m/model.tflite", "/m/MODEL.TFLITE",
                                  "/m/ckpt.orbax"])
def test_unported_model_files_are_refused_naming_what_they_wait_for(
        path, tmp_path):
    """Model files the JAX filter takes and the port once refused. An orbax
    checkpoint (``ckpt.orbax``, a directory the JAX package writes) restores
    into its ``arch=`` as in the JAX filter, and a missing one raises
    FileNotFoundError as there. ``.tflite`` files, in either spelling,
    resolve to a tflite bundle (models/tflite_import.py) as in the JAX
    filter, the ``arch=`` option ignored."""
    if not path.lower().endswith(".tflite"):
        from nnstreamer_tpu.models.zoo import get_model as jget_model
        from nnstreamer_tpu.utils.checkpoints import save_variables as jsave

        with pytest.raises(FileNotFoundError):
            jresolve(path, {"arch": "zoo://lenet"})
        with pytest.raises(FileNotFoundError):
            resolve_model(path, {"arch": "zoo://lenet"}, device=CPU)
        model = str(tmp_path / path.rsplit("/", 1)[1])
        jsave(model, jget_model("zoo://lenet?seed=4").params)
        bundle = resolve_model(model, {"arch": "zoo://lenet"}, device=CPU)
        want = jresolve(model, {"arch": "zoo://lenet"})
        x = np.random.default_rng(4).integers(0, 256, (1, 28, 28, 1), dtype=np.uint8)
        with torch.inference_mode():
            got = bundle.fn()(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want.fn()(x)),
                                   rtol=1e-5, atol=1e-6)
        return
    from test_tflite_ops import F32, build_tflite

    model = tmp_path / path.rsplit("/", 1)[1]
    model.write_bytes(build_tflite(
        tensors=[{"shape": (1, 2), "type": F32, "data": None},
                 {"shape": (1, 2), "type": F32, "data": None}],
        operators=[{"code": 19, "inputs": [0], "outputs": [1]}],  # RELU
        inputs=[0], outputs=[1]))
    bundle = resolve_model(str(model), {"arch": "zoo://lenet"}, device=CPU)
    want = jresolve(str(model), {"arch": "zoo://lenet"})
    assert bundle.metadata["format"] == want.metadata["format"] == "tflite"
    assert bundle.metadata["tflite_ops"] == want.metadata["tflite_ops"]
    (out,) = bundle.fn()(torch.tensor([[-1.0, 2.0]]))
    assert torch.equal(out, torch.tensor([[0.0, 2.0]]))
