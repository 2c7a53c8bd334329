"""The torch port's prologue kernels against the JAX package, on the CPU.

``normalize_u8`` and ``quantize_affine`` (``nnstreamer_tpu_torch.ops.kernels
.preprocess``): on the CPU the wrappers run their plain PyTorch versions,
held bit for bit against ``nnstreamer_tpu.ops.pallas.preprocess``'s
``*_reference`` functions on the same numpy inputs. The JAX package's
Pallas bodies differ from those references (an FMA in ``normalize_u8``, a
reciprocal in ``quantize_affine``); the port follows the references, and
the divergences are pinned here on the reference's side. The CUDA kernels
are held against the plain versions on the card (``cuda`` marker), and
their source's index arithmetic on the CPU: built for the host with g++
against the stub headers in ``tests/cuda_host``, every thread run in turn.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from nnstreamer_tpu.ops.pallas import preprocess as jpp  # noqa: E402
from nnstreamer_tpu_torch.ops.kernels import preprocess as tpp  # noqa: E402

U8 = np.arange(256, dtype=np.uint8)
OUT = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
SCALE_BIAS = [(1 / 127.5, -1.0), (1 / 255.0, 0.0), (0.0171, -2.1179), (3.0, 0.25)]


def _bits(a) -> np.ndarray:
    """Exact bit patterns of a torch tensor or a jax/numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        return a.numpy().view(np.uint8)
    a = np.asarray(a)
    return a.view(np.uint8)


def _special_floats() -> np.ndarray:
    rng = np.random.default_rng(3)
    vals = [np.nan, np.inf, -np.inf, 1e9, -1e9, 3e38, -3e38, 0.0, -0.0,
            1e-40, 0.5, 1.5, 2.5, -0.5, -2.5, 0.9686274528503418]
    return np.concatenate([np.array(vals, np.float32),
                           rng.uniform(-300, 300, 500).astype(np.float32)])


@pytest.mark.parametrize("out", list(OUT))
@pytest.mark.parametrize("scale,bias", SCALE_BIAS)
def test_normalize_plain_bit_exact_with_reference_on_all_uint8(scale, bias, out):
    t_dt, j_dt = OUT[out]
    want = jpp.normalize_u8_reference(jnp.asarray(U8), scale, bias, j_dt)
    got = tpp.normalize_u8_plain(torch.from_numpy(U8), scale, bias, t_dt)
    assert got.dtype == t_dt and got.shape == (256,)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("src", ["float32", "bfloat16"])
@pytest.mark.parametrize("out", list(OUT))
def test_normalize_plain_bit_exact_with_reference_on_floats(src, out):
    t_dt, j_dt = OUT[out]
    x = _special_floats()
    jx = jnp.asarray(x).astype(jnp.bfloat16 if src == "bfloat16" else jnp.float32)
    tx = torch.from_numpy(x).to(getattr(torch, src))
    want = np.asarray(jpp.normalize_u8_reference(jx, 1 / 127.5, -1.0, j_dt))
    got = tpp.normalize_u8_plain(tx, 1 / 127.5, -1.0, t_dt)
    g = got.to(torch.float32).numpy()
    w = want.astype(np.float32)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_array_equal(g[~np.isnan(g)], w[~np.isnan(w)])


@pytest.mark.parametrize("zero_point", [0, 128])
@pytest.mark.parametrize("scale", [1 / 127.5, 1 / 255.0, 0.02])
def test_quantize_plain_bit_exact_with_reference(scale, zero_point):
    x = np.concatenate([_special_floats(), np.random.default_rng(4).uniform(
        -1, 1, 200_000).astype(np.float32)])
    # exact ties of round half to even: x / scale lands on k + 0.5
    ties = (np.arange(-20, 20, dtype=np.float32) + np.float32(0.5)) * np.float32(scale)
    x = np.concatenate([x, ties])
    want = np.asarray(jpp.quantize_affine_reference(jnp.asarray(x), scale, zero_point))
    got = tpp.quantize_affine_plain(torch.from_numpy(x), scale, zero_point)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] == 0  # NaN → 0
    assert got[1] == 255 and got[2] == 0  # ±inf saturate


def test_quantize_plain_bfloat16_input_matches_reference():
    x = _special_floats()
    want = np.asarray(jpp.quantize_affine_reference(
        jnp.asarray(x).astype(jnp.bfloat16), 1 / 127.5, 128))
    got = tpp.quantize_affine_plain(torch.from_numpy(x).to(torch.bfloat16), 1 / 127.5, 128)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(1,), (7, 13), (129,), (2, 16, 16, 3)])
def test_wrappers_on_cpu_run_plain_at_any_shape(shape):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))
    f = torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32))
    n0, q0 = tpp.normalize_u8.launches, tpp.quantize_affine.launches
    got = tpp.normalize_u8(x)
    q = tpp.quantize_affine(f, 1 / 127.5, 128)
    assert (tpp.normalize_u8.launches, tpp.quantize_affine.launches) == (n0, q0)
    assert got.shape == shape and got.dtype == torch.bfloat16
    assert torch.equal(got, tpp.normalize_u8_plain(x))
    assert torch.equal(q, tpp.quantize_affine_plain(f, 1 / 127.5, 128))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    meta = torch.empty(4, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tpp.normalize_u8(meta)
    with pytest.raises(ValueError, match="unsupported device"):
        tpp.quantize_affine(meta.to(torch.float32), 0.1)


# --------------------------------------------------------------------------- #
# divergences inside the JAX package, pinned on the reference's side
# --------------------------------------------------------------------------- #

def test_jax_normalize_pallas_body_differs_from_its_reference_by_fma():
    x = jnp.asarray(U8.reshape(2, 128))
    ref = np.asarray(jpp.normalize_u8_reference(x, 1 / 127.5, -1.0, jnp.float32))
    body = np.asarray(jpp.normalize_u8(x, 1 / 127.5, -1.0, jnp.float32,
                                       interpret=True))
    assert int((ref != body).sum()) == 158
    # 106 values by 1 ulp, 52 (near 0) by 2; at most 2^-23 in absolute terms
    ulp = np.abs(ref.view(np.int32).astype(np.int64) - body.view(np.int32).astype(np.int64))
    assert np.bincount(ulp.ravel()).tolist() == [98, 106, 52]
    assert np.abs(ref - body).max() == np.float32(2.0 ** -23)
    # the Pallas body is the FMA form: exact product, one rounding
    fma = (U8.astype(np.float64) * np.float64(np.float32(1 / 127.5))
           + np.float64(-1.0)).astype(np.float32).reshape(2, 128)
    np.testing.assert_array_equal(body, fma)
    # the port follows the reference
    got = tpp.normalize_u8_plain(torch.from_numpy(U8.reshape(2, 128)), 1 / 127.5,
                                 -1.0, torch.float32)
    np.testing.assert_array_equal(got.numpy(), ref)
    # at 1/255 with no bias the two agree everywhere
    ref255 = np.asarray(jpp.normalize_u8_reference(x, 1 / 255.0, 0.0, jnp.float32))
    body255 = np.asarray(jpp.normalize_u8(x, 1 / 255.0, 0.0, jnp.float32,
                                          interpret=True))
    np.testing.assert_array_equal(ref255, body255)


def test_jax_quantize_pallas_body_multiplies_by_the_reciprocal():
    x = np.full((8, 128), 0.9686274528503418, np.float32)
    ref = np.asarray(jpp.quantize_affine_reference(jnp.asarray(x), 1 / 127.5, 128))
    body = np.asarray(jpp.quantize_affine(jnp.asarray(x), 1 / 127.5, 128,
                                          interpret=True))
    assert (ref == 251).all() and (body == 252).all()
    got = tpp.quantize_affine_plain(torch.from_numpy(x), 1 / 127.5, 128)
    assert (got.numpy() == 251).all()


# --------------------------------------------------------------------------- #
# on the card: kernels against their plain versions
# --------------------------------------------------------------------------- #

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("out", list(OUT))
@pytest.mark.parametrize("shape", [(256,), (1,), (7, 13), (129,), (224, 224, 3)])
def test_normalize_kernel_matches_plain(cuda_device, shape, out):
    n = int(np.prod(shape))
    x = torch.from_numpy(np.resize(U8, n).reshape(shape)).to(cuda_device)
    for scale, bias in SCALE_BIAS:
        before = tpp.normalize_u8.launches
        got = tpp.normalize_u8(x, scale, bias, OUT[out][0])
        want = tpp.normalize_u8_plain(x, scale, bias, OUT[out][0])
        torch.cuda.synchronize()
        assert tpp.normalize_u8.launches == before + 1
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("zero_point", [0, 128])
def test_quantize_kernel_matches_plain(cuda_device, zero_point):
    x = torch.from_numpy(_special_floats()).to(cuda_device)
    strided = torch.from_numpy(np.random.default_rng(6).uniform(
        -1, 1, (64, 130)).astype(np.float32)).to(cuda_device)[:, 1:128]
    for t in (x, strided, x.to(torch.bfloat16)):
        before = tpp.quantize_affine.launches
        got = tpp.quantize_affine(t, 1 / 127.5, zero_point)
        want = tpp.quantize_affine_plain(t, 1 / 127.5, zero_point)
        torch.cuda.synchronize()
        assert tpp.quantize_affine.launches == before + 1
        assert torch.equal(got, want)


# --------------------------------------------------------------------------- #
# on the card: every boundary of the kernels' tiling
# --------------------------------------------------------------------------- #

NORM_PAIRS = [(i, o) for i in ("uint8", "float32", "bfloat16") for o in ("float32", "bfloat16")]
QUANT_INPUTS = ["float32", "bfloat16"]


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Bit for bit, but any NaN for a NaN (the card's bf16 conversion and
    torch's give NaNs other payloads)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    if got.dtype == torch.uint8:
        return torch.equal(got, want)
    gn, wn = got.float().isnan(), want.float().isnan()
    bits = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    return torch.equal(gn, wn) and torch.equal(got.view(bits)[~gn], want.view(bits)[~wn])


def _prologue_input(dtype: str, n: int, dev, seed: int = 7) -> torch.Tensor:
    """n elements: uint8 codes, or floats in (-300, 300) led by NaN, +-inf,
    +-1e9 and halfway values."""
    rng = np.random.default_rng(seed)
    if dtype == "uint8":
        return torch.from_numpy(rng.integers(0, 256, n, dtype=np.uint8)).to(dev)
    v = rng.uniform(-300, 300, n).astype(np.float32)
    lead = np.array([np.nan, np.inf, -np.inf, 1e9, -1e9, -0.0, 0.5, 2.5], np.float32)
    v[:min(n, lead.size)] = lead[:min(n, lead.size)]
    return torch.from_numpy(v).to(dev).to(getattr(torch, dtype))


def _tiling_sizes(tiling: dict) -> list:
    """1, 15, 16, 17, a tile +-1, the persistent grid's tiles +-1."""
    tile, full = tiling["tile"], tiling["blocks"] * tiling["tile"]
    return sorted({1, 15, 16, 17, tile - 1, tile, tile + 1, full - 1, full, full + 1})


def _check_normalize(x: torch.Tensor, out: torch.dtype, name: str) -> None:
    before = tpp.normalize_u8.launches
    got = tpp.normalize_u8(x, 1 / 127.5, -1.0, out)
    want = tpp.normalize_u8_plain(x, 1 / 127.5, -1.0, out)
    torch.cuda.synchronize()
    assert tpp.normalize_u8.launches == before + 1, name
    assert _same_bits(got, want), name


def _check_quantize(x: torch.Tensor, name: str) -> None:
    before = tpp.quantize_affine.launches
    got = tpp.quantize_affine(x, 1 / 127.5, 128)
    want = tpp.quantize_affine_plain(x, 1 / 127.5, 128)
    torch.cuda.synchronize()
    assert tpp.quantize_affine.launches == before + 1, name
    assert torch.equal(got, want), name


def test_tiling_refuses_a_cpu_device():
    with pytest.raises(ValueError, match="a CUDA device"):
        tpp.tiling(torch.uint8, torch.float32, torch.device("cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("src,out", NORM_PAIRS)
def test_normalize_kernel_at_tiling_boundaries(cuda_device, src, out):
    od = getattr(torch, out)
    t = tpp.tiling(getattr(torch, src), od, cuda_device)
    assert t["vector"] * max(getattr(torch, src).itemsize, od.itemsize) == 16
    for n in _tiling_sizes(t) + [224 * 224 * 3, 1080 * 1920 * 3]:
        _check_normalize(_prologue_input(src, n, cuda_device), od, f"{src}->{out} n={n}")


@pytest.mark.cuda
@pytest.mark.parametrize("src", QUANT_INPUTS)
def test_quantize_kernel_at_tiling_boundaries(cuda_device, src):
    t = tpp.tiling(getattr(torch, src), torch.uint8, cuda_device)
    for n in _tiling_sizes(t) + [224 * 224 * 3, 1080 * 1920 * 3]:
        _check_quantize(_prologue_input(src, n, cuda_device), f"{src} n={n}")


@pytest.mark.cuda
@pytest.mark.parametrize("src", ["uint8", "float32", "bfloat16"])
def test_prologue_kernels_on_views_off_alignment(cuda_device, src):
    """Views 1-15 bytes off 16-byte alignment (in whole elements), at a size
    with a ragged end: the vector path where the offset keeps a lane's
    access aligned, an element an access where it does not."""
    size = torch.tensor([], dtype=getattr(torch, src)).element_size()
    buf = _prologue_input(src, 100_003 + 16, cuda_device)
    for off in range(1, 16 // size):
        x = buf[off:off + 100_003]
        assert x.data_ptr() % 16 == off * size
        for out in (torch.float32, torch.bfloat16):
            _check_normalize(x, out, f"{src} {off * size} bytes off, to {out}")
        if src != "uint8":
            _check_quantize(x, f"{src} {off * size} bytes off")


@pytest.mark.cuda
@pytest.mark.parametrize("src,out", NORM_PAIRS + [(s, "uint8") for s in QUANT_INPUTS])
def test_prologue_head_path_when_both_sides_share_an_offset(cuda_device, src, out):
    """The kernels on an input and an output at the same element
    offset from their vector alignment: the elements before the aligned
    body go by plain loads (the wrappers' outputs are always aligned, so
    the launches are made directly)."""
    sd, od = getattr(torch, src), getattr(torch, out)
    t = tpp.tiling(sd, od, cuda_device)
    v, n = t["vector"], 3 * t["tile"] + 5
    buf = _prologue_input(src, n + v, cuda_device)
    for off in range(1, v):
        x = buf[off:off + n]
        ybuf = torch.full((n + v + 1,), 7, dtype=od, device=cuda_device)
        y = ybuf[off:off + n]
        if out == "uint8":
            before = tpp.quantize_affine.launches
            tpp._launch_quantize(x, y, 1 / 127.5, 128)
            want = tpp.quantize_affine_plain(x, 1 / 127.5, 128)
            launches = tpp.quantize_affine.launches - before
        else:
            before = tpp.normalize_u8.launches
            tpp._launch_normalize(x, y, 1 / 127.5, -1.0)
            want = tpp.normalize_u8_plain(x, 1 / 127.5, -1.0, od)
            launches = tpp.normalize_u8.launches - before
        torch.cuda.synchronize()
        assert launches == 1
        assert _same_bits(y, want), f"{src}->{out} offset {off}"
        untouched = torch.cat([ybuf[:off], ybuf[off + n:]])
        assert (untouched == 7).all(), f"{src}->{out} offset {off}: wrote outside"


# --------------------------------------------------------------------------- #
# on the CPU: the kernel source's tiling, thread by thread
# --------------------------------------------------------------------------- #

HOST_SMS, HOST_BLOCKS_PER_SM = 4, 2
CSRC = os.path.join(os.path.dirname(tpp.__file__), "csrc", "preprocess.cu")


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """``csrc/preprocess.cu`` built for the host with g++ against the stub
    headers in ``tests/cuda_host`` (a card of HOST_SMS SMs holding
    HOST_BLOCKS_PER_SM blocks each; a launch runs its threads one after
    another), loaded with ctypes: the card's C entry points."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    with open(CSRC) as f:
        src = f.read()
    src, launches = re.subn(r"(\w+<[^;{}]*?>)\s*<<<([^;]*?),\s*(kThreads),\s*[^;]*?>>>\(",
                            r"host_launch(\1, \2, \3)(", src)
    assert launches == 1
    out = tmp_path_factory.mktemp("host_kernels")
    cpp, lib = out / "preprocess.cpp", out / "libpreprocess.so"
    cpp.write_text(src)
    stubs = os.path.join(os.path.dirname(__file__), "cuda_host")
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                    "-I", stubs, f"-DHOST_SMS={HOST_SMS}",
                    f"-DHOST_BLOCKS_PER_SM={HOST_BLOCKS_PER_SM}", "-o", str(lib), str(cpp)],
                   check=True, capture_output=True, timeout=300)
    dll = ctypes.CDLL(str(lib))
    P, i64, i32, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    dll.nns_normalize_u8.argtypes = [P, P, i64, i32, i32, f32, f32, P]
    dll.nns_quantize_affine.argtypes = [P, P, i64, i32, f32, f32, P]
    dll.nns_preprocess_tiling.argtypes = [i32, i32, ctypes.POINTER(i64)]
    return dll


@pytest.mark.parametrize("src,out", NORM_PAIRS + [(s, "uint8") for s in QUANT_INPUTS])
def test_kernel_source_on_the_host_at_tiling_boundaries(host_kernels, src, out):
    """Every boundary of the tiling (n 1, 15, 16, 17, a tile +-1, the
    persistent grid's tiles +-1 and past two rounds of it), each with
    input and output aligned, the input one element off (the element
    path), both one element off and both V - 1 off (the head by plain
    loads): bit for bit with the plain versions, nothing written outside."""
    sd, od = getattr(torch, src), getattr(torch, out)
    t = (ctypes.c_longlong * 3)()
    assert host_kernels.nns_preprocess_tiling(tpp._IN_TYPES[sd], tpp._IN_TYPES[od], t) == 0
    v, tile, blocks = t
    assert v * max(sd.itemsize, od.itemsize) == 16
    assert blocks == HOST_SMS * HOST_BLOCKS_PER_SM
    sizes = _tiling_sizes({"tile": tile, "blocks": blocks}) + [2 * blocks * tile + 33]
    for n in sizes:
        for xoff, yoff in ((0, 0), (1, 0), (1, 1), (v - 1, v - 1)):
            x = _prologue_input(src, n + xoff, "cpu")[xoff:]
            ybuf = torch.full((n + yoff + 1,), 7, dtype=od)
            y = ybuf[yoff:yoff + n]
            if out == "uint8":
                rc = host_kernels.nns_quantize_affine(x.data_ptr(), y.data_ptr(), n,
                                                      tpp._IN_TYPES[sd], 1 / 127.5, 128.0, None)
                want = tpp.quantize_affine_plain(x, 1 / 127.5, 128)
            else:
                rc = host_kernels.nns_normalize_u8(x.data_ptr(), y.data_ptr(), n,
                                                   tpp._IN_TYPES[sd], int(od == torch.bfloat16),
                                                   1 / 127.5, -1.0, None)
                want = tpp.normalize_u8_plain(x, 1 / 127.5, -1.0, od)
            name = f"{src}->{out} n={n} offsets {xoff}, {yoff}"
            assert rc == 0, name
            assert _same_bits(y, want), name
            untouched = torch.cat([ybuf[:yoff], ybuf[yoff + n:]])
            assert (untouched == 7).all(), f"{name}: wrote outside"
