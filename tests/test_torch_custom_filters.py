"""The port's custom filters and nns-new-filter-torch against the JAX package.

``nnstreamer_tpu_torch/filters`` ports ``custom.py`` (``custom-easy`` and
``python3``), ``c_custom.py`` with ``gst_custom_abi.py`` (``framework=custom``)
and ``nns_python_compat.py``, and ``codegen.py`` ports ``nns-new-filter``.
Each case runs the same seeded inputs through the JAX pipeline and the
port's ``Pipeline(device="cpu")`` and compares what reaches the sinks byte
for byte:

  * python3 scripts in both contracts (written here: the reference's own
    passthrough.py / scaler.py are not in the repository): the native one
    with ``make_filter(options)`` and the reference one
    (``getInputDim``/``setInputDim``, flat arrays in and out, ``custom=``
    split on spaces into constructor arguments, a no-arg constructor
    ignoring it), and ``setInputDim`` rejecting the input;
  * custom-easy callables, whose torch tensors stay tensors;
  * ``framework=custom`` on native/examples/scaler_filter.c and on a filter
    built here that drops a frame (``ret > 0``) or fails (``ret < 0``),
    each compiled with gcc (skipped without it);
  * ``framework=auto`` on ``.py`` and ``.so`` models;
  * the generated python and C filters serving, overwrite and bad names
    refused, a second C filter sharing the Makefile;
  * the ``nnstreamer_python`` shim shared by both packages in one process,
    in either order of installation;
  * neither fusion pass touching a serialising decoder, a custom-script
    decoder or a python3 filter.

The reference-ABI .so cases need the reference's headers and stay with
tests/test_gst_custom_abi.py (skipped here as there).
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import nnstreamer_tpu.core as jcore  # noqa: E402
import nnstreamer_tpu.filters as jfilters  # noqa: E402
import nnstreamer_tpu.filters.nns_python_compat as jshim  # noqa: E402
import nnstreamer_tpu.graph as jgraph  # noqa: E402
import nnstreamer_tpu_torch.core as tcore  # noqa: E402
import nnstreamer_tpu_torch.filters as tfilters  # noqa: E402
import nnstreamer_tpu_torch.filters.nns_python_compat as tshim  # noqa: E402
import nnstreamer_tpu_torch.graph as tgraph  # noqa: E402
from nnstreamer_tpu_torch.codegen import generate, main  # noqa: E402
from nnstreamer_tpu_torch.filters.base import FilterProps  # noqa: E402
from nnstreamer_tpu_torch.filters.custom import Python3Filter  # noqa: E402

TIMEOUT = 60
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": (jcore, jgraph, {}), "torch": (tcore, tgraph, {"device": "cpu"})}

needs_gcc = pytest.mark.skipif(shutil.which("gcc") is None, reason="no gcc")


def caps_of(core, dims, types, rate=30):
    return core.Caps.tensors(core.TensorsConfig(
        core.TensorsInfo.from_strings(dims, types), rate))


def run(pkg, dims, types, frames, **filter_props):
    """appsrc → tensor_filter → tensor_sink in one package; the sink."""
    core, graph, kw = PACKAGES[pkg]
    p = graph.Pipeline(**kw)
    src = p.add_new("appsrc", caps=caps_of(core, dims, types), data=list(frames))
    filt = p.add_new("tensor_filter", **filter_props)
    sink = p.add_new("tensor_sink", store=True)
    graph.Pipeline.link(src, filt, sink)
    p.run(timeout=TIMEOUT)
    return sink


def outputs(sink):
    return [[(m.host().shape, m.host().dtype, m.host().tobytes()) for m in b.memories]
            for b in sink.buffers]


def run_both(dims, types, frames, **filter_props):
    js = run("jax", dims, types, frames, **filter_props)
    ts = run("torch", dims, types, frames, **filter_props)
    assert ts.num_buffers == js.num_buffers
    assert outputs(ts) == outputs(js)
    assert str(ts.sink_pad.caps) == str(js.sink_pad.caps)
    return ts


def frames_f32(n, shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


# ---------------------------------------------------------------------------- #
# python3
# ---------------------------------------------------------------------------- #

NATIVE_SCRIPT = '''
import numpy as np


class Scale:
    def __init__(self, k):
        self.k = k

    def getInputDimension(self):
        return "4:1", "float32"

    def getOutputDimension(self):
        return "4:1,4:1", "float32,int32"

    def invoke(self, x):
        return x * self.k, (x > 0.5).astype(np.int32)


def make_filter(options):
    return Scale(float(options.get("k", "1")))
'''

REFERENCE_SCRIPT = '''
import numpy as np
import nnstreamer_python as nns


class CustomFilter:
    def __init__(self, *args):
        self.scale = float(args[0]) if args else 1.0

    def getInputDim(self):
        return [nns.TensorShape([5, 2, 1, 1], np.float32)]

    def getOutputDim(self):
        return [nns.TensorShape([5, 2, 1, 1], np.float32)]

    def invoke(self, input_array):
        x = input_array[0] * np.float32(self.scale)
        e = np.exp(x - x.max())
        return [(e / e.sum()).astype(np.float32)]
'''

SET_DIM_SCRIPT = '''
import numpy as np
import nnstreamer_python as nns


class CustomFilter:
    def __init__(self, *args):
        self.reject = bool(args)

    def setInputDim(self, input_dims):
        if self.reject:
            return None
        dims = input_dims[0].getDims()
        dims[0] = dims[0] * 2            # edits the list in place
        return [nns.TensorShape(dims, input_dims[0].getType())]

    def invoke(self, input_array):
        return [np.repeat(input_array[0], 2)]
'''


def _script(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def test_python3_native_contract_with_make_filter(tmp_path):
    path = _script(tmp_path, "native.py", NATIVE_SCRIPT)
    ts = run_both("4:1", "float32", frames_f32(3, (1, 4)), framework="python3",
                  model=path, custom="k=3")
    assert [str(m.info.dtype) for m in ts.buffers[0].memories] == ["float32", "int32"]


@pytest.mark.parametrize("custom", ["", "2.5"])
def test_python3_reference_contract(tmp_path, custom):
    path = _script(tmp_path, f"ref_{bool(custom)}.py", REFERENCE_SCRIPT)
    ts = run_both("5:2", "float32", frames_f32(3, (2, 5), seed=1),
                  framework="python", model=path, custom=custom)
    assert ts.buffers[0].memories[0].host().shape == (2, 5)


def test_python3_set_input_dim_reshapes_to_declared_dims(tmp_path):
    path = _script(tmp_path, "setdim.py", SET_DIM_SCRIPT)
    ts = run_both("3:2", "int16", [np.arange(6, dtype=np.int16).reshape(2, 3)],
                  framework="python3", model=path)
    assert ts.buffers[0].memories[0].host().shape == (2, 6)


def test_python3_set_input_dim_rejecting_the_input_raises(tmp_path):
    path = _script(tmp_path, "reject.py", SET_DIM_SCRIPT)
    f = Python3Filter()
    f.open(FilterProps(model=path, custom="reject"))
    with pytest.raises(ValueError, match="setInputDim rejected the input dims"):
        f.set_input_info(tcore.TensorsInfo.from_strings("3:2", "int16"))


def test_custom_args_split_on_spaces_and_noarg_fallback(tmp_path):
    """custom= splits into separate constructor args (reference
    g_strsplit semantics); native no-arg constructors ignore custom=."""
    multi = _script(tmp_path, "multi.py", (
        "import numpy as np\n"
        "import nnstreamer_python as nns\n"
        "class CustomFilter:\n"
        "    def __init__(self, *args):\n"
        "        assert args == ('a', 'b'), args\n"
        "        self.d = [nns.TensorShape([4, 1], np.float32)]\n"
        "    def getInputDim(self): return self.d\n"
        "    def getOutputDim(self): return self.d\n"
        "    def invoke(self, xs): return [xs[0]]\n"))
    noarg = _script(tmp_path, "noarg.py", (
        "class CustomFilter:\n"
        "    def __init__(self):\n"
        "        pass\n"
        "    def getInputDimension(self): return '4:1', 'float32'\n"
        "    def getOutputDimension(self): return '4:1', 'float32'\n"
        "    def invoke(self, x): return x\n"))
    f1 = Python3Filter()
    f1.open(FilterProps(model=multi, custom="a b"))
    f2 = Python3Filter()
    f2.open(FilterProps(model=noarg, custom="ignored"))
    assert f1.get_model_info()[1][0].dims == (4,)   # rank padding trimmed
    assert f2.get_model_info()[1][0].dims == (4, 1)
    broken = _script(tmp_path, "broken.py", (
        "class CustomFilter:\n"
        "    def __init__(self, *args):\n"
        "        raise TypeError('inside the constructor')\n"))
    with pytest.raises(TypeError, match="inside the constructor"):
        Python3Filter().open(FilterProps(model=broken, custom="x"))


def test_python3_tensor_outputs_are_copied_to_the_host(tmp_path):
    path = _script(tmp_path, "tensor_out.py", (
        "import torch\n"
        "class CustomFilter:\n"
        "    def getInputDimension(self): return '4:1', 'float32'\n"
        "    def getOutputDimension(self): return '4:1', 'float32'\n"
        "    def invoke(self, x): return torch.from_numpy(x) * 2\n"))
    x = frames_f32(1, (1, 4))
    sink = run("torch", "4:1", "float32", x, framework="python3", model=path)
    m = sink.buffers[0].memories[0]
    assert not m.is_device
    np.testing.assert_array_equal(m.host(), x[0] * 2)


def test_python3_missing_script_raises():
    with pytest.raises(FileNotFoundError):
        Python3Filter().open(FilterProps(model="/nonexistent/filter.py"))


# ---------------------------------------------------------------------------- #
# custom-easy
# ---------------------------------------------------------------------------- #

def test_custom_easy_matches_jax():
    def fn(x):
        return x * 2 + 1, np.argmax(x, axis=-1).astype(np.int32)

    spec = (("4:1", "float32"), ("4:1,1", "float32,int32"))
    jfilters.register_custom_easy("easy_parity", fn, *spec)
    tfilters.register_custom_easy("easy_parity", fn, *spec)
    try:
        run_both("4:1", "float32", frames_f32(3, (1, 4), seed=2),
                 framework="custom-easy", model="easy_parity")
    finally:
        jfilters.unregister_custom_easy("easy_parity")
        tfilters.unregister_custom_easy("easy_parity")
    with pytest.raises(Exception, match="not registered"):
        run("torch", "4:1", "float32", frames_f32(1, (1, 4)),
            framework="custom-easy", model="easy_parity")


def test_custom_easy_tensor_outputs_stay_tensors():
    tfilters.register_custom_easy(
        "easy_tensor", lambda x: torch.from_numpy(x) * 3,
        ("4:1", "float32"), ("4:1", "float32"))
    try:
        x = frames_f32(2, (1, 4), seed=3)
        sink = run("torch", "4:1", "float32", x, framework="custom-easy",
                   model="easy_tensor")
    finally:
        tfilters.unregister_custom_easy("easy_tensor")
    for frame, b in zip(x, sink.buffers):
        m = b.memories[0]
        assert m.is_device and isinstance(m.device(), torch.Tensor)
        np.testing.assert_array_equal(m.host(), frame * 3)


# ---------------------------------------------------------------------------- #
# framework=custom (C .so)
# ---------------------------------------------------------------------------- #

DROP_FILTER_C = r"""
#include <stdint.h>
#include <string.h>

typedef struct { void *data; uint64_t size; } NnsTensor;

int nns_custom_get_input_info(char *dims, char *types, int cap) {
  strncpy(dims, "4:1", cap);
  strncpy(types, "float32", cap);
  return 0;
}

int nns_custom_get_output_info(char *dims, char *types, int cap) {
  return nns_custom_get_input_info(dims, types, cap);
}

int nns_custom_invoke(int num_in, const NnsTensor *in, int num_out,
                      NnsTensor *out) {
  const float *src = (const float *) in[0].data;
  float *dst = (float *) out[0].data;
  int i;
  if (src[0] < 0.0f) return 1;     /* soft drop */
  if (src[0] > 100.0f) return -2;  /* failure */
  for (i = 0; i < 4; i++) dst[i] = src[i] + 1.0f;
  return 0;
}
"""


def _gcc(out, *args):
    subprocess.run(["gcc", "-O2", "-shared", "-fPIC", *args, "-o", str(out)],
                   check=True, capture_output=True, cwd=ROOT)
    return str(out)


@pytest.fixture(scope="module")
def scaler_so(tmp_path_factory):
    if shutil.which("gcc") is None:
        pytest.skip("no gcc")
    out = tmp_path_factory.mktemp("cfilter") / "libscaler_filter.so"
    return _gcc(out, "-I", "native", "native/examples/scaler_filter.c")


@pytest.fixture(scope="module")
def drop_so(tmp_path_factory):
    if shutil.which("gcc") is None:
        pytest.skip("no gcc")
    d = tmp_path_factory.mktemp("dropfilter")
    (d / "drop_filter.c").write_text(DROP_FILTER_C)
    return _gcc(d / "libdrop_filter.so", str(d / "drop_filter.c"))


@pytest.mark.parametrize("custom", ["", "factor=5", "factor=0.25"])
def test_c_scaler_filter_matches_jax(scaler_so, custom):
    x = frames_f32(3, (1, 4), seed=4)
    ts = run_both("4:1", "float32", x, framework="custom", model=scaler_so,
                  custom=custom)
    factor = float(custom.split("=")[1]) if custom else 2.0
    for frame, b in zip(x, ts.buffers):
        np.testing.assert_array_equal(b.memories[0].host(),
                                      frame * np.float32(factor))


def test_c_filter_soft_drop_matches_jax(drop_so):
    x = [np.array([[1, 2, 3, 4]], np.float32), np.array([[-1, 0, 0, 0]], np.float32),
         np.array([[5, 6, 7, 8]], np.float32)]
    ts = run_both("4:1", "float32", x, framework="custom", model=drop_so)
    assert ts.num_buffers == 2
    np.testing.assert_array_equal(ts.buffers[1].memories[0].host(), x[2] + 1)


def test_c_filter_failure_raises_as_jax(drop_so):
    x = [np.array([[101, 0, 0, 0]], np.float32)]
    errors = []
    for pkg in PACKAGES:
        with pytest.raises(Exception) as e:
            run(pkg, "4:1", "float32", x, framework="custom", model=drop_so)
        errors.append(str(e.value))
    assert all("custom filter invoke failed (-2)" in m for m in errors), errors


def test_c_filter_missing_so_raises():
    from nnstreamer_tpu_torch.filters.c_custom import CCustomFilter

    with pytest.raises(FileNotFoundError):
        CCustomFilter().open(FilterProps(model="/nonexistent/lib.so"))


def test_auto_detect_py_and_so(tmp_path, scaler_so):
    path = _script(tmp_path, "auto.py", NATIVE_SCRIPT)
    assert tfilters.detect_framework(path) == jfilters.detect_framework(path) == "python3"
    assert tfilters.detect_framework(scaler_so) == "custom"
    run_both("4:1", "float32", frames_f32(2, (1, 4), seed=5), model=path, custom="k=2")
    run_both("4:1", "float32", frames_f32(2, (1, 4), seed=6), model=scaler_so)


# ---------------------------------------------------------------------------- #
# nns-new-filter-torch
# ---------------------------------------------------------------------------- #

@pytest.mark.parametrize("kind", ["py", "python"])
def test_generated_python_filter_serves(tmp_path, kind):
    (path,) = generate("myscaler", kind, str(tmp_path))
    assert os.path.basename(path) == "myscaler.py"
    text = open(path).read()
    assert "jax" not in text.lower() and "xla" not in text.lower()
    assert "nns-launch-torch" in text
    x = frames_f32(2, (1, 4), seed=7)
    ts = run("torch", "4:1", "float32", x, framework="python3", model=path)
    for frame, b in zip(x, ts.buffers):
        np.testing.assert_array_equal(b.memories[0].host(), frame)


@needs_gcc
def test_generated_c_filter_compiles_and_serves(tmp_path):
    src_c, makefile = generate("cscale", "c", str(tmp_path))
    subprocess.run(["make", "-C", str(tmp_path)], check=True, capture_output=True)
    so = tmp_path / "libcscale.so"
    x = frames_f32(2, (1, 4), seed=8)
    ts = run("torch", "4:1", "float32", x, framework="custom", model=str(so))
    for frame, b in zip(x, ts.buffers):
        np.testing.assert_array_equal(b.memories[0].host(), frame * 2)


def test_refuses_overwrite_and_bad_names(tmp_path):
    generate("dup", "py", str(tmp_path))
    with pytest.raises(FileExistsError):
        generate("dup", "python", str(tmp_path))
    with pytest.raises(ValueError, match="identifier"):
        generate("bad-name", "py", str(tmp_path))
    with pytest.raises(ValueError, match="unknown kind"):
        generate("ok", "rust", str(tmp_path))


def test_cli_entry(tmp_path, capsys):
    assert main(["gencli", "--dir", str(tmp_path)]) == 0
    assert str(tmp_path / "gencli.py") in capsys.readouterr().out
    assert main(["gencli", "--dir", str(tmp_path)]) == 1  # exists
    assert main(["genc", "--kind", "c", "--dir", str(tmp_path)]) == 0


@needs_gcc
def test_second_c_filter_shares_makefile(tmp_path):
    generate("f_one", "c", str(tmp_path))
    generate("f_two", "c", str(tmp_path))  # Makefile reused, no collision
    subprocess.run(["make", "-C", str(tmp_path)], check=True, capture_output=True)
    assert (tmp_path / "libf_one.so").exists()
    assert (tmp_path / "libf_two.so").exists()


def test_generated_templates_differ_from_jax_only_in_their_contract(tmp_path):
    """The C source is the same flat ABI; the python template is the
    port's (numpy in, arrays or tensors out)."""
    from nnstreamer_tpu.codegen import generate as jgenerate

    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jc, _ = jgenerate("same", "c", str(jdir))
    tc, _ = generate("same", "c", str(tdir))
    strip = lambda p: open(p).read().replace("nns-new-filter-torch", "nns-new-filter")
    assert strip(tc) == strip(jc)
    assert open(tdir / "Makefile").read() == open(jdir / "Makefile").read()


# ---------------------------------------------------------------------------- #
# the shared nnstreamer_python shim
# ---------------------------------------------------------------------------- #

@pytest.mark.parametrize("first", ["jax", "torch"])
def test_shim_shared_between_packages_in_either_order(tmp_path, monkeypatch, first):
    """Whichever package installs ``nnstreamer_python`` first, a
    reference-contract script loaded by both serves equal outputs."""
    monkeypatch.delitem(sys.modules, "nnstreamer_python", raising=False)
    scripts = {pkg: _script(tmp_path, f"shim_{first}_{pkg}.py", REFERENCE_SCRIPT
                            + SET_DIM_SCRIPT.replace("CustomFilter", "Unused"))
               for pkg in PACKAGES}
    order = [first] + [p for p in PACKAGES if p != first]
    x = frames_f32(2, (2, 5), seed=9)
    sinks = {pkg: run(pkg, "5:2", "float32", x, framework="python3",
                      model=scripts[pkg], custom="1.5") for pkg in order}
    assert sys.modules["nnstreamer_python"] is {"jax": jshim, "torch": tshim}[first]
    assert outputs(sinks["torch"]) == outputs(sinks["jax"])
    # each package's info_to_shapes builds the installed module's class
    shapes = tshim.info_to_shapes(tcore.TensorsInfo.from_strings("5:2", "float32"))
    assert type(shapes[0]) is sys.modules["nnstreamer_python"].TensorShape
    info = tshim.shapes_to_info(jshim.info_to_shapes(
        jcore.TensorsInfo.from_strings("3:4:5", "uint8")))
    assert (info[0].dims, str(info[0].dtype)) == ((3, 4, 5), "uint8")


def test_port_shim_is_a_complete_stand_in():
    public = lambda m: {n for n in dir(m) if not n.startswith("_")
                        and callable(getattr(m, n)) and n not in ("Any", "List",
                                                                   "Optional", "Sequence")}
    assert public(jshim) - {"TensorDType", "TensorInfo", "TensorsInfo"} <= public(tshim)
    j, t = jshim.TensorShape([3, 2], np.int16), tshim.TensorShape([3, 2], np.int16)
    t.getDims().append(1)
    j.getDims().append(1)
    assert (t.getDims(), t.getType(), repr(t)) == (j.getDims(), j.getType(), repr(j))


# ---------------------------------------------------------------------------- #
# fusion passes leave the new pieces alone
# ---------------------------------------------------------------------------- #

@pytest.mark.parametrize("mode", ["flexbuf", "flatbuf", "protobuf", "custom-script"])
def test_epilogue_fusion_skips_serialising_and_script_decoders(tmp_path, mode):
    if mode == "custom-script":
        path = _script(tmp_path, "dec.py", (
            "class CustomDecoder:\n"
            "    def getOutCaps(self): return b'application/octet-stream'\n"
            "    def decode(self, raw, info, rn, rd):\n"
            "        return b''.join(r.tobytes() for r in raw)\n"))
        mode = f"custom-script:{path}"
    p = tgraph.Pipeline(device="cpu")
    x = frames_f32(2, (1, 6), seed=10)
    src = p.add_new("appsrc", caps=caps_of(tcore, "6:1", "float32"), data=x)
    filt = p.add_new("tensor_filter", model=lambda t: t * 3 - 1)
    dec = p.add_new("tensor_decoder", mode=mode)
    sink = p.add_new("tensor_sink", store=True)
    tgraph.Pipeline.link(src, filt, dec, sink)
    p.run(timeout=TIMEOUT)
    assert p._epilogue_count == 0 and not dec._decoder._fused_epilogue
    assert sink.num_buffers == 2


def test_prologue_fusion_skips_a_python3_filter(tmp_path):
    path = _script(tmp_path, "after_transform.py", (
        "class CustomFilter:\n"
        "    def getInputDimension(self): return '6:1', 'float32'\n"
        "    def getOutputDimension(self): return '6:1', 'float32'\n"
        "    def invoke(self, x): return x + 1\n"))

    def chain(model, **kw):
        p = tgraph.Pipeline(device="cpu")
        src = p.add_new("appsrc", caps=caps_of(tcore, "6:1", "uint8"),
                        data=[np.arange(6, dtype=np.uint8).reshape(1, 6)])
        tr = p.add_new("tensor_transform", mode="typecast", option="float32")
        filt = p.add_new("tensor_filter", model=model, **kw)
        sink = p.add_new("tensor_sink", store=True)
        tgraph.Pipeline.link(src, tr, filt, sink)
        p.run(timeout=TIMEOUT)
        return p, sink

    p, sink = chain(path, framework="python3")
    assert p._fused_count == 0
    np.testing.assert_array_equal(sink.buffers[0].memories[0].host(),
                                  np.arange(1, 7, dtype=np.float32).reshape(1, 6))
    control, _ = chain(lambda t: t + 1, input="6:1", inputtype="uint8")
    assert control._fused_count == 1
