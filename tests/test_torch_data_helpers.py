"""core/data.py's helpers against the JAX package's, on the CPU.

The same seeded numpy inputs go through ``nnstreamer_tpu.core.data`` and
``nnstreamer_tpu_torch.core.data``. A numpy input must give bit-equal
results (the port runs the JAX package's numpy arithmetic). A tensor input
is cast or reduced by torch: casts of in-range values must be equal bit
for bit, statistics within 1e-12 of numpy's float64 result relative to
the input's largest magnitude (the summation order differs, and a mean
of int64 values near both ends of the range cancels). Where the C cast
of an out-of-range float is undefined, the CPU difference between torch
and numpy is pinned.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nnstreamer_tpu.core import data as jdata  # noqa: E402
from nnstreamer_tpu.core.types import TensorDType as JDType  # noqa: E402
from nnstreamer_tpu_torch.core import data as tdata  # noqa: E402
from nnstreamer_tpu_torch.core.types import TensorDType  # noqa: E402

RTOL = 1e-12
DTYPES = [d.value for d in TensorDType]
rng = np.random.default_rng(25)


def _bits(x):
    a = np.asarray(x)
    return a.dtype.str, a.shape, a.tobytes()


def _inputs(dtype):
    """Seeded values of ``dtype`` with both signs (where it has them) and
    the range ends."""
    dt = TensorDType(dtype).np_dtype
    if TensorDType(dtype).is_float:
        v = rng.standard_normal((3, 4, 5)) * 300
        return v.astype(dt)
    info = np.iinfo(dt)
    v = rng.integers(max(info.min, -2**40), min(info.max, 2**40), (3, 4, 5),
                     dtype=np.int64 if info.min < 0 else np.uint64)
    v = v.astype(dt)
    v.flat[0], v.flat[1] = info.min, info.max
    return v


SCALARS = [0, 1, -1, 127, 128, -128, -129, 255, 256, 300, 65535, 65536,
           -32769, 2**31 - 1, 2**31, -2**31, 2**32 + 7, -7.5, 3.7, 0.5,
           -0.0, 1e3, 255.9, -1.0]


@pytest.mark.parametrize("dtype", DTYPES)
def test_typecast_value_equals_jax(dtype):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # numpy's overflow warnings
        for v in SCALARS:
            want = jdata.typecast_value(v, JDType(dtype))
            got = tdata.typecast_value(v, TensorDType(dtype))
            assert type(got) is type(want)
            assert _bits(got) == _bits(want) or (want != want and got != got)


@pytest.mark.parametrize("dst", DTYPES)
@pytest.mark.parametrize("src", DTYPES)
def test_typecast_array_equals_jax(src, dst):
    x = _inputs(src)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jdata.typecast_array(x, JDType(dst))
        got = tdata.typecast_array(x, TensorDType(dst))
    assert _bits(got) == _bits(want)
    in_range = True
    if TensorDType(src).is_float and TensorDType(dst).is_integer:
        info = np.iinfo(TensorDType(dst).np_dtype)
        xd = x.astype(np.float64)
        in_range = bool(((xd >= info.min) & (xd <= info.max)).all())
    if in_range and src != "bfloat16" and dst != "bfloat16":
        t = tdata.typecast_array(torch.from_numpy(x), TensorDType(dst))
        assert t.dtype == getattr(torch, dst)
        assert _bits(t.numpy()) == _bits(want)
        assert _bits(tdata.typecast_value(torch.from_numpy(x[:1, :1, :1]),
                                          TensorDType(dst))) == \
            _bits(want.flat[0].item())


def test_tensor_typecast_of_in_range_floats_wraps_like_c():
    """Integer narrowing wraps; float → int truncates toward zero; a
    negative float in an unsigned type's wrapped range follows C too."""
    x = torch.tensor([300.0, -1.0, -3.7, 3.7, 255.9, 70000.0, -129.0],
                     dtype=torch.float64)
    for dst in ("int8", "uint8", "int16", "uint16", "int32", "uint32",
                "int64"):
        want = x.numpy().astype(dst)
        got = tdata.typecast_array(x, TensorDType(dst))
        np.testing.assert_array_equal(got.numpy(), want)
    i = torch.tensor([300, -1, 65536 + 3, -129], dtype=torch.int64)
    assert tdata.typecast_array(i, TensorDType.UINT8).tolist() == [44, 255, 3, 127]
    assert tdata.typecast_array(i, TensorDType.INT8).tolist() == [44, -1, 3, 127]


def test_out_of_range_float_to_uint8_differs_from_numpy_on_the_cpu():
    """The documented divergence: a float64 at or above 2**32 keeps its low
    byte in torch's uint8 cast, numpy's gives 0 (both are a C cast with no
    defined result)."""
    x = np.array([2.0**32 + 5, 2.0**33 + 200], np.float64)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jdata.typecast_array(x, JDType.UINT8)
        port_np = tdata.typecast_array(x, TensorDType.UINT8)
    assert want.tolist() == port_np.tolist() == [0, 0]
    got = tdata.typecast_array(torch.from_numpy(x), TensorDType.UINT8)
    assert got.tolist() == [5, 200]


@pytest.mark.parametrize("dtype", DTYPES)
def test_statistics_equal_jax(dtype):
    x = _inputs(dtype)
    assert _bits(tdata.tensor_average(x)) == _bits(jdata.tensor_average(x))
    assert _bits(tdata.tensor_std(x)) == _bits(jdata.tensor_std(x))
    for axis in (-1, 0, 1, 2, -3, 5):
        assert _bits(tdata.per_channel_average(x, axis)) == \
            _bits(jdata.per_channel_average(x, axis))
        assert _bits(tdata.per_channel_std(x, axis)) == \
            _bits(jdata.per_channel_std(x, axis))
    if dtype == "bfloat16":
        t = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(x)
    tol = {"rtol": RTOL, "atol": RTOL * float(np.abs(x.astype(np.float64)).max())}
    np.testing.assert_allclose(tdata.tensor_average(t), jdata.tensor_average(x),
                               **tol)
    np.testing.assert_allclose(tdata.tensor_std(t), jdata.tensor_std(x), **tol)
    for axis in (-1, 0, 1, 2, -3, 5):
        got = tdata.per_channel_average(t, axis)
        assert isinstance(got, np.ndarray) and got.dtype == np.float64
        np.testing.assert_allclose(got, jdata.per_channel_average(x, axis),
                                   **tol)
        np.testing.assert_allclose(tdata.per_channel_std(t, axis),
                                   jdata.per_channel_std(x, axis), **tol)


@pytest.mark.parametrize("shape", [(7,), (1, 1), (5, 1), (1, 6)])
def test_statistics_edge_shapes_equal_jax(shape):
    """One-dimensional inputs leave no axis to reduce (numpy returns the
    values and zeros; torch would read ``dim=()`` as every dim)."""
    x = (rng.standard_normal(shape) * 10 - 3).astype(np.float32)
    t = torch.from_numpy(x)
    for axis in (-1, 0):
        want_m = jdata.per_channel_average(x, axis)
        want_s = jdata.per_channel_std(x, axis)
        assert _bits(tdata.per_channel_average(x, axis)) == _bits(want_m)
        assert _bits(tdata.per_channel_std(x, axis)) == _bits(want_s)
        got_m = tdata.per_channel_average(t, axis)
        got_s = tdata.per_channel_std(t, axis)
        assert got_m.shape == want_m.shape and got_s.shape == want_s.shape
        np.testing.assert_allclose(got_m, want_m, rtol=RTOL)
        np.testing.assert_allclose(got_s, want_s, rtol=RTOL, atol=1e-12)


def test_a_zero_dim_input_is_its_own_channel_in_both_packages():
    x = np.asarray(np.float32(3.5))
    for fn in ("per_channel_average", "per_channel_std"):
        want = getattr(jdata, fn)(x)
        assert _bits(getattr(tdata, fn)(x)) == _bits(want)
        assert _bits(getattr(tdata, fn)(torch.from_numpy(x))) == _bits(want)


@pytest.mark.parametrize("x", [
    np.asarray([1.5, np.nan, np.inf, -np.inf, -2.0], np.float32),
    np.asarray(np.float32(np.inf))], ids=["1d", "0d"])
def test_non_finite_values_with_no_axis_to_reduce_equal_jax(x):
    """With no other axis numpy's std of a channel is |x - x|: zero for a
    finite value, NaN for NaN and for either infinity, on both paths."""
    for fn in ("per_channel_average", "per_channel_std"):
        want = getattr(jdata, fn)(x)
        for got in (getattr(tdata, fn)(x),
                    getattr(tdata, fn)(torch.from_numpy(x))):
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)  # NaN where numpy's is


def test_every_public_name_of_the_jax_module_is_ported():
    names = {n for n in vars(jdata) if not n.startswith("_")
             and callable(getattr(jdata, n))
             and getattr(getattr(jdata, n), "__module__", "") == jdata.__name__}
    assert names == {"typecast_value", "typecast_array", "tensor_average",
                     "tensor_std", "per_channel_average", "per_channel_std"}
    assert all(callable(getattr(tdata, n, None)) for n in names)
