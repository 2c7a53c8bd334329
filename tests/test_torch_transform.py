"""The torch port's tensor_transform against the JAX package, on the CPU.

Every mode and option of tests/test_transform.py and
tests/test_transform_sweep.py runs through ``nnstreamer_tpu.ops.
transform_ops.build(...).fn`` (op by op on jax arrays) and the port's
``build(...).fn`` (on torch tensors) over the same seeded numpy inputs.
Results are bit-exact with the JAX package's, dtype included, except
``stand``: its mean and deviation sum in another order than XLA's, so it
holds within rtol 1e-5 / atol 1e-6. The parity hazards are pinned one by
one: saturating float→integer casts, 64-bit typecasts under x64-off,
weakly typed scalars and per-channel vectors in type promotion, IEEE
division, integer clamp bounds and reference-order permutations.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from nnstreamer_tpu.core import TensorInfo as JInfo  # noqa: E402
from nnstreamer_tpu.ops import transform_ops as J  # noqa: E402
from nnstreamer_tpu_torch.core import TensorInfo as PInfo  # noqa: E402
from nnstreamer_tpu_torch.ops import transform_ops as P  # noqa: E402

#: the reference's ten tensor types plus the two float extensions
DTYPES = ["uint8", "int8", "uint16", "int16", "uint32", "int32", "float32",
          "float64", "int64", "uint64", "float16", "bfloat16"]
#: the stream types the port's pipelines carry into a transform
STREAMS = ["uint8", "int16", "int32", "float32", "bfloat16"]


def _np_dtype(name: str):
    return ml_dtypes.bfloat16 if name == "bfloat16" else np.dtype(name)


def _inputs(src: str, shape=(3, 4, 5), seed: int = 0) -> np.ndarray:
    """Seeded values of ``src``; floats carry NaN, ±inf, values beyond
    every integer range and halves, integers their extremes."""
    rng = np.random.default_rng(seed)
    n = math.prod(shape)
    dt = _np_dtype(src)
    if src in ("float32", "float64", "float16", "bfloat16"):
        special = np.array([np.nan, np.inf, -np.inf, 1e9, -1e9, 3e9, 70000.0,
                            300.0, -1.5, 2.5, -2.5, 255.5, -0.0, 1e-30],
                           np.float64)
        vals = np.concatenate([special, rng.uniform(-300, 300, n)])[:n]
        return vals.astype(np.float32).astype(dt).reshape(shape)
    info = np.iinfo(dt)
    lo, hi = max(info.min, -(2 ** 31)), min(info.max, 2 ** 31 - 1)
    vals = np.concatenate([[info.min, info.max, 0, 1],
                           rng.integers(lo, hi, n, dtype=np.int64, endpoint=True)])[:n]
    return vals.astype(dt).reshape(shape)


def _torch(x: np.ndarray) -> torch.Tensor:
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.contiguous().numpy()


def _run(mode: str, option: str, x: np.ndarray):
    want = np.asarray(J.build(mode, option).fn(jnp.asarray(x)))
    got = _np(P.build(mode, option).fn(_torch(x)))
    return got, want


def _same(got: np.ndarray, want: np.ndarray) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.astype(np.float64), want.astype(np.float64)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_array_equal(g[~np.isnan(g)], w[~np.isnan(w)])


# --------------------------------------------------------------------------- #
# typecast: every (src, dst) pair, saturation and 64-bit under x64-off
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("src", DTYPES)
@pytest.mark.parametrize("dst", DTYPES)
def test_typecast_all_dtype_pairs_match_jax(src, dst):
    _same(*_run("typecast", dst, _inputs(src)))


def test_float_to_integer_typecast_saturates():
    x = np.array([np.nan, np.inf, -np.inf, 1e9, -1e9, 300.0, -1.5, 2.7, -2.7],
                 np.float32)
    got, want = _run("typecast", "uint8", x)
    _same(got, want)
    assert got.tolist() == [0, 255, 0, 255, 0, 255, 0, 2, 0]
    # a bare cast does not: torch wraps 300 → 44 and -1.5 → 255
    assert torch.tensor([300.0]).to(torch.uint8).item() != 255


@pytest.mark.parametrize("dst,data", [("float64", "float32"), ("int64", "int32"),
                                      ("uint64", "uint32")])
def test_64bit_typecast_yields_32bit_data_under_caps_of_64(dst, data):
    tr = P.build("typecast", dst)
    got, want = _run("typecast", dst, _inputs("float32"))
    _same(got, want)
    assert str(got.dtype) == data
    # the caps still name the 64-bit type, as the JAX package's do
    info = tr.out_info(PInfo.from_strings("5:4:3", "float32"))
    jinfo = J.build("typecast", dst).out_info(JInfo.from_strings("5:4:3", "float32"))
    assert str(info.dtype) == str(jinfo.dtype) == dst


# --------------------------------------------------------------------------- #
# arithmetic: chains, promotion, per-channel vectors, IEEE division
# --------------------------------------------------------------------------- #

CHAINS = [
    "typecast:float32,add:-127.5,div:127.5",  # the README's normalize
    "typecast:float32,mul:2,add:1,div:3",
    "typecast:float64,sub:1,mul:-1",
    "typecast:float32,div:255.0",
    "add:7", "add:-3.5", "add:0.1", "mul:2", "mul:0.5", "mul:0.7", "div:4",
    "div:3", "div:127.5", "sub:10",
    "add:1;2;3;4;5", "mul:0.5;1.5;2.5;3.5;4.5", "div:1;3;7;9;127.5",
    "typecast:float32,add:1;10;100;1000;-1",
    "mul:0.7,add:0.3", "typecast:int32,add:1",
    "typecast:uint8,mul:3,typecast:uint8",
]


@pytest.mark.parametrize("src", STREAMS)
@pytest.mark.parametrize("chain", CHAINS)
def test_arithmetic_chains_match_jax(chain, src):
    x = _inputs(src, seed=1)
    if src != "bfloat16" and np.issubdtype(x.dtype, np.floating):
        x = np.where(np.isfinite(x), x, 1.0).astype(x.dtype)
    _same(*_run("arithmetic", chain, x))


def test_division_is_ieee_not_a_reciprocal():
    # x / 127.5 and x * float32(1/127.5) differ on 126 of the 256 bytes;
    # the port divides (by a tensor, on every device)
    x = np.arange(256, dtype=np.uint8)
    got, want = _run("arithmetic", "typecast:float32,div:127.5", x)
    _same(got, want)
    np.testing.assert_array_equal(got, x.astype(np.float32) / np.float32(127.5))
    recip = x.astype(np.float32) * np.float32(1 / 127.5)
    assert int((got != recip).sum()) == 126


def test_jax_jit_rewrites_the_division_and_the_port_does_not():
    # a divergence inside the JAX package: under jit (the JAX element's
    # path) XLA multiplies by the reciprocal, so the README transform's
    # jitted output differs from its op-by-op output on 126 of 256 bytes
    tr = J.build("arithmetic", "typecast:float32,add:-127.5,div:127.5")
    x = np.arange(256, dtype=np.uint8)
    eager = np.asarray(tr.fn(jnp.asarray(x)))
    jitted = np.asarray(jax.jit(tr.fn)(jnp.asarray(x)))
    assert int((eager != jitted).sum()) == 126
    assert np.abs(eager - jitted).max() == np.float32(2.0 ** -24)
    got = _np(P.build("arithmetic", "typecast:float32,add:-127.5,div:127.5")
              .fn(_torch(x)))
    np.testing.assert_array_equal(got, eager)


@pytest.mark.parametrize("src,value,dtype", [
    ("uint8", "add:1.5", "float32"), ("int16", "add:1.5", "float32"),
    ("int32", "mul:2", "float32"), ("float32", "add:1.5", "float32"),
    ("bfloat16", "add:0.1", "bfloat16"), ("bfloat16", "add:1;2;3;4;5", "float32"),
    ("uint8", "div:1;2;3;4;5", "float32"), ("float16", "mul:0.1", "float16"),
])
def test_promotion_follows_jax(src, value, dtype):
    got, want = _run("arithmetic", value, _inputs(src, seed=2))
    _same(got, want)
    assert str(got.dtype) == dtype


def test_arithmetic_errors_match_jax():
    for opt in ("pow:2", "add", ""):
        with pytest.raises(ValueError):
            J.build("arithmetic", opt)
        with pytest.raises(ValueError):
            P.build("arithmetic", opt)


# --------------------------------------------------------------------------- #
# transpose / dimchg (reference dim order, innermost first)
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("perm", ["0:1:2", "1:0:2", "2:1:0", "0:2:1", "2:0:1",
                                  "1:2:0", "1:2:0:3", "1:0:2:3", "3:2:1:0"])
def test_transpose_matches_jax(perm):
    rank = len(perm.split(":"))
    x = _inputs("float32", shape=(2, 3, 4, 5)[:rank], seed=3)
    _same(*_run("transpose", perm, x))
    dims = "5:4:3:2" if rank == 4 else "5:4:3"
    p_info = P.build("transpose", perm).out_info(PInfo.from_strings(dims, "uint8"))
    j_info = J.build("transpose", perm).out_info(JInfo.from_strings(dims, "uint8"))
    assert p_info.dims == j_info.dims


@pytest.mark.parametrize("a,b", [(0, 1), (0, 2), (1, 0), (2, 0), (1, 2), (2, 1),
                                 (0, 0), (0, 3), (3, 1)])
def test_dimchg_matches_jax(a, b):
    x = _inputs("int16", shape=(2, 3, 4, 5), seed=4)
    _same(*_run("dimchg", f"{a}:{b}", x))
    p_info = P.build("dimchg", f"{a}:{b}").out_info(PInfo.from_strings("5:4:3:2", "int16"))
    j_info = J.build("dimchg", f"{a}:{b}").out_info(JInfo.from_strings("5:4:3:2", "int16"))
    assert p_info.dims == j_info.dims


def test_transpose_rejects_what_jax_rejects():
    for bad in ("0:0:1:2", "1:2"):
        with pytest.raises(ValueError):
            J.build("transpose", bad).fn(jnp.zeros((2, 3, 4)))
        with pytest.raises(ValueError):
            P.build("transpose", bad).fn(torch.zeros((2, 3, 4)))


# --------------------------------------------------------------------------- #
# stand: population deviation, within summation order
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("src", STREAMS)
@pytest.mark.parametrize("option", ["default", "dc-average", "default:per-channel",
                                    "dc-average:per-channel", ""])
def test_stand_matches_jax_within_tolerance(option, src):
    x = _inputs(src, shape=(4, 6, 3), seed=5)
    if np.issubdtype(x.dtype, np.floating) or src == "bfloat16":
        x = np.where(np.isfinite(x.astype(np.float32)), x, 1.0).astype(x.dtype)
    got, want = _run("stand", option, x)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_stand_zero_variance_and_rank1_per_channel():
    for x, option in ((np.full((4, 4), 3.0, np.float32), "default"),
                      (np.arange(5, dtype=np.float32), "default:per-channel")):
        got, want = _run("stand", option, x)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------- #
# clamp: bounds in the stream's type, integer bounds clipped first
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("src", ["uint8", "int8", "uint16", "int16", "int32",
                                 "uint32", "float32", "bfloat16", "float16"])
@pytest.mark.parametrize("option", ["0:1", "-1:1", "10:200", "-50:100", "0.5:2.7",
                                    "-1e10:1e10"])
def test_clamp_matches_jax(option, src):
    _same(*_run("clamp", option, _inputs(src, seed=6)))


def test_clamp_errors_match_jax():
    with pytest.raises(ValueError):
        J.build("clamp", "1:0")
    with pytest.raises(ValueError):
        P.build("clamp", "1:0")


def test_unknown_mode_raises():
    with pytest.raises(ValueError):
        P.build("nope", "1")


# --------------------------------------------------------------------------- #
# compose and the element
# --------------------------------------------------------------------------- #

def test_compose_matches_jax():
    stages = [("typecast", "float32"), ("arithmetic", "mul:3.0"), ("clamp", "0:100"),
              ("transpose", "1:0:2")]
    jc = J.compose([J.build(m, o) for m, o in stages])
    pc = P.compose([P.build(m, o) for m, o in stages])
    x = _inputs("uint8", shape=(2, 3, 4), seed=7)
    _same(_np(pc.fn(_torch(x))), np.asarray(jc.fn(jnp.asarray(x))))
    assert pc.descr == jc.descr
    info = PInfo.from_strings("4:3:2", "uint8")
    assert pc.out_info(info).dims == jc.out_info(JInfo.from_strings("4:3:2", "uint8")).dims


def _element_run(pipeline_cls, caps_cls, config_cls, info_cls, x, props, **pkw):
    p = pipeline_cls(**pkw)
    src = p.add_new("appsrc", caps=caps_cls.tensors(config_cls(
        info_cls.from_strings("5:4:3", "uint8"), 30)), data=[x])
    t = p.add_new("tensor_transform", **props)
    sink = p.add_new("tensor_sink", store=True)
    pipeline_cls.link(src, t, sink)
    p.run(timeout=60)
    return sink.buffers[0]


@pytest.mark.parametrize("props", [
    {"mode": "arithmetic", "option": "typecast:float32,add:-127.5,div:127.5"},
    {"transform_chain": [("arithmetic", "mul:4.0"), ("transpose", "1:0:2"),
                         ("clamp", "0:300")]},
    {"mode": "typecast", "option": "int8"},
], ids=["arithmetic", "chain", "typecast"])
def test_element_matches_jax_and_stays_on_device(props):
    from nnstreamer_tpu.core import Caps as JCaps, TensorsConfig as JConfig
    from nnstreamer_tpu.core import TensorsInfo as JInfos
    from nnstreamer_tpu.graph import Pipeline as JPipeline
    from nnstreamer_tpu_torch.core import Caps, TensorsConfig, TensorsInfo
    from nnstreamer_tpu_torch.graph import Pipeline

    x = _inputs("uint8", shape=(3, 4, 5), seed=8)
    want = _element_run(JPipeline, JCaps, JConfig, JInfos, x, props)
    got = _element_run(Pipeline, Caps, TensorsConfig, TensorsInfo, x, props,
                       device="cpu")
    assert got.memories[0].is_device  # stayed a torch tensor
    assert got.config.info[0].dims == want.config.info[0].dims
    assert str(got.config.info[0].dtype) == str(want.config.info[0].dtype)
    # the JAX element jits its transform (XLA then multiplies by the
    # reciprocal, see above): equal within one float32 ulp
    np.testing.assert_allclose(got.memories[0].host().astype(np.float64),
                               np.asarray(want.memories[0].host()).astype(np.float64),
                               rtol=2 ** -23, atol=0)


def test_transform_normalize_is_not_normalize_u8():
    # (x - 127.5) / 127.5 and normalize_u8's x * (1/127.5) - 1 differ, so
    # tensor_transform never routes to the kernel (the JAX package does not)
    from nnstreamer_tpu_torch.ops.kernels.preprocess import normalize_u8_plain

    x = torch.arange(256, dtype=torch.uint8)
    t = P.build("arithmetic", "typecast:float32,add:-127.5,div:127.5").fn(x)
    n = normalize_u8_plain(x, 1 / 127.5, -1.0, torch.float32)
    assert int((t != n).sum()) == 207
