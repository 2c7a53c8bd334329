"""Shared by the port's TFLite parity tests (``tests/test_torch_tflite_*.py``).

One ``.tflite`` file goes through the JAX package's ``load_tflite`` under
``jax.jit`` (as its own tests run it) and through the port's
``load_tflite(device="cpu")``:

  * ``params``: the same keys, each value bit-equal (dtype, shape, bytes);
  * float outputs within ``FLOAT_RTOL`` / ``FLOAT_ATOL``;
  * integer outputs equal (ARG_MAX, SHAPE, CAST, GATHER indices, ...);
  * 8-bit outputs of quantized graphs at most ``QUANT_MAX_STEP`` code apart,
    on at most ``QUANT_MAX_SHARE`` of the codes, with the top-1 equal. The
    two packages run the same dequantized-float graph, one ulp of a
    convolution apart, and ``_fake_quant`` rounds each intermediate onto
    its grid, so a value at a rounding boundary can land one code over.

``jax_cases`` lists a JAX test module's cases (its parametrized ones
expanded, its skip marks kept) so a port test can run each JAX case's own
body with the module's loader helpers pointed at ``run_both``: the body's
oracle, or its comparison against ``tf.lite.Interpreter``, then holds the
port's outputs, and ``run_both`` holds them against JAX's.
"""

import inspect
import os

import numpy as np
import pytest
import torch

from nnstreamer_tpu.models.tflite_import import load_tflite as jax_load_tflite
from nnstreamer_tpu_torch.models.tflite_import import load_tflite

FLOAT_RTOL, FLOAT_ATOL = 1e-5, 1e-6
QUANT_MAX_STEP = 1
QUANT_MAX_SHARE = 0.02


def assert_params_equal(jb, tb) -> None:
    """Port ``params`` equal JAX ``params`` bit for bit, key by key."""
    assert sorted(tb.params) == sorted(jb.params)
    for key, want in jb.params.items():
        want = np.asarray(want)
        got = tb.params[key].detach().cpu().numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, key
        assert got.tobytes() == want.tobytes(), key


def run_port(tb, *inputs):
    with torch.inference_mode():
        outs = tb.fn()(*(torch.from_numpy(np.ascontiguousarray(x))
                         for x in inputs))
    return [o.numpy() for o in outs]


def run_jax(jb, *inputs):
    import jax

    return [np.asarray(o) for o in jax.jit(jb.fn())(*inputs)]


def assert_outputs_match(port, ref) -> None:
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        assert p.shape == r.shape, (p.shape, r.shape)
        if np.issubdtype(r.dtype, np.floating):
            assert p.dtype == r.dtype
            np.testing.assert_allclose(p, r, rtol=FLOAT_RTOL, atol=FLOAT_ATOL)
        elif r.dtype in (np.uint8, np.int8):
            assert p.dtype == r.dtype
            diff = np.abs(p.astype(np.int32) - r.astype(np.int32))
            assert int(diff.max(initial=0)) <= QUANT_MAX_STEP
            assert float((diff > 0).mean()) <= QUANT_MAX_SHARE
            if p.size > 1:
                assert int(p.reshape(-1).argmax()) == int(r.reshape(-1).argmax())
        else:
            np.testing.assert_array_equal(p, r)


def write(blob_or_path, tmp_path, name: str = "m.tflite") -> str:
    if isinstance(blob_or_path, (bytes, bytearray)):
        path = tmp_path / name
        path.write_bytes(bytes(blob_or_path))
        return str(path)
    return str(blob_or_path)


def load_both(path: str):
    jb, tb = jax_load_tflite(path), load_tflite(path, device="cpu")
    assert_params_equal(jb, tb)
    return jb, tb


def run_both(blob_or_path, tmp_path, *inputs):
    """Both packages on one file; returns the port's outputs (numpy)."""
    jb, tb = load_both(write(blob_or_path, tmp_path))
    port = run_port(tb, *inputs)
    assert_outputs_match(port, run_jax(jb, *inputs))
    return port


def port_load(path):
    return load_tflite(str(path), device="cpu")


def jax_cases(module, skip=()):
    """``pytest.param(name, kwargs)`` for each test function of ``module``
    (each parametrized case on its own, the other marks kept), leaving out
    the names in ``skip``."""
    cases = []
    for name, fn in vars(module).items():
        if not name.startswith("test_") or not inspect.isfunction(fn) \
                or name in skip:
            continue
        marks = list(getattr(fn, "pytestmark", []))
        params = [m for m in marks if m.name == "parametrize"]
        others = [m for m in marks if m.name != "parametrize"]
        if not params:
            cases.append(pytest.param(name, {}, id=name, marks=others))
            continue
        (pm,) = params
        argnames = pm.args[0]
        if isinstance(argnames, str):
            argnames = [a.strip() for a in argnames.split(",")]
        for i, values in enumerate(pm.args[1]):
            values = tuple(values) if len(argnames) > 1 else (values,)
            cases.append(pytest.param(name, dict(zip(argnames, values)),
                                      id=f"{name}[{i}]", marks=others))
    return cases


def call_case(module, name, kwargs, tmp_path):
    fn = getattr(module, name)
    if "tmp_path" in inspect.signature(fn).parameters:
        kwargs = {**kwargs, "tmp_path": tmp_path}
    fn(**kwargs)


def here() -> str:
    return os.path.dirname(os.path.abspath(__file__))
