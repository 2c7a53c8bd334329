"""The port's ``.msgpack`` checkpoints against flax's, on the CPU.

``nnstreamer_tpu_torch/utils/checkpoints.py`` carries its own codec of the
msgpack subset ``flax.serialization`` writes (the card's machine has neither
flax nor msgpack). Here the same trees go through both: the port's bytes
must equal ``flax.serialization.to_bytes``'s, a file either side writes must
load on the other bit for bit, and the JAX package's own
``utils/checkpoints.py`` and the port's read each other's files, in both of
the JAX package's forms: ``.msgpack`` files and orbax directories (the
latter at length in tests/test_torch_orbax.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
serialization = pytest.importorskip("flax.serialization")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from nnstreamer_tpu.utils import checkpoints as jck  # noqa: E402
from nnstreamer_tpu_torch.utils import checkpoints as ck  # noqa: E402


def _np(tree):
    """A JAX tree's state dict with numpy leaves, in the tree's own order."""
    sd = serialization.to_state_dict(tree)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return np.asarray(x) if isinstance(x, jax.Array) else x
    return conv(sd)


def _same(a, b):
    """Equal structure, key order, dtypes and bytes."""
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) \
            and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (np.ndarray, np.generic)):
        return isinstance(b, (np.ndarray, np.generic)) and a.dtype == b.dtype \
            and np.shape(a) == np.shape(b) and a.tobytes() == b.tobytes()
    return type(a) is type(b) and a == b


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"Dense_0": {"kernel": rng.normal(size=(8, 4)).astype(np.float32),
                        "bias": np.zeros(4, np.float32)},
            "BatchNorm_0": {"scale": np.ones(4, np.float32),
                            "bias": rng.normal(size=4).astype(np.float32)}}


def _trees():
    p = _params()
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    return {
        "params": p,
        "bare array": np.arange(32, dtype=np.float32).reshape(8, 4),
        "bf16": {"w": np.asarray(jnp.linspace(-3, 3, 17, dtype=jnp.bfloat16))},
        "scalars": {"x": 1.5, "n": None, "t": True, "f": False, "s": "hi" * 40,
                    "ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 40,
                             -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31 - 1],
                    "np": np.int8(-3), "f32": np.float32(0.25)},
        "many keys": {f"k{i}": np.full((i,), i, np.uint8) for i in range(40)},
        "dtypes": {dt: np.arange(5).astype(dt) for dt in
                   ("int8", "uint8", "int16", "uint16", "int32", "uint32", "int64",
                    "uint64", "float16", "float32", "float64", "bool")},
        "shapes": {"empty": np.zeros((0, 3), np.float32), "0d": np.array(7, np.int32),
                   "big": np.arange(70000, dtype=np.int32)},
        "tuple and list": (np.zeros(2, np.float32), [1, 2, (3, "x")]),
        "sgd state": optax.sgd(0.1, momentum=0.9).init(jp),
        "adam resume blob": {"params": p, "opt_state": optax.adam(1e-3).init(jp),
                             "frames": 24},
        "adamw state": optax.adamw(1e-3).init(jp),
    }


@pytest.mark.parametrize("name", list(_trees()))
def test_bytes_equal_flax_to_bytes(name):
    tree = _trees()[name]
    want = serialization.to_bytes(tree)
    assert ck.to_bytes(_np(tree)) == want
    assert _same(ck.from_bytes(want), serialization.msgpack_restore(want))


@pytest.mark.parametrize("name", list(_trees()))
def test_port_file_restores_in_flax_bit_for_bit(tmp_path, name):
    tree = _trees()[name]
    path = str(tmp_path / "t.msgpack")
    ck.save_variables(path, _np(tree))
    with open(path, "rb") as f:
        back = serialization.from_bytes(tree, f.read())
    a, b = jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(back)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(back)
    assert all(np.asarray(x).tobytes() == np.asarray(y).tobytes()
               and np.asarray(x).dtype == np.asarray(y).dtype for x, y in zip(a, b))


def test_tensors_are_written_from_their_host_bytes():
    w = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    tree = {"w": w.t(), "h": torch.linspace(-2, 2, 9).to(torch.bfloat16),
            "i": torch.tensor(5, dtype=torch.int32)}
    want = serialization.to_bytes({"w": np.arange(12, dtype=np.float32).reshape(3, 4).T,
                                   "h": jnp.linspace(-2, 2, 9).astype(jnp.bfloat16),
                                   "i": jnp.asarray(5, jnp.int32)})
    assert ck.to_bytes(tree) == want


def test_arrays_flax_would_chunk_are_refused(monkeypatch):
    """flax writes an array above MAX_CHUNK_SIZE bytes in chunks
    (``__msgpack_chunked_array__``); so does the port, byte for byte (both
    limits shrunk here to 64 bytes), and each side joins the other's chunks
    again. The name predates chunking: such arrays were once refused."""
    monkeypatch.setattr(ck, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(7)
    tree = {"fits": np.arange(16, dtype=np.float32),
            "a": np.arange(17, dtype=np.float32),
            "m": {"w": rng.normal(size=(5, 9)).astype(np.float32),
                  "h": np.asarray(jnp.linspace(-2, 2, 70).astype(jnp.bfloat16)),
                  "b": rng.integers(0, 2, 200).astype(bool)},
            "s": np.float64(1.5)}
    want = serialization.to_bytes(tree)
    got = ck.to_bytes(tree)
    assert got == want
    assert b"__msgpack_chunked_array__" in got
    back = ck.from_bytes(want)
    assert _same(back, _np(tree))
    flax_back = serialization.msgpack_restore(got)
    assert all(np.asarray(flax_back["m"][k]).tobytes() == tree["m"][k].tobytes()
               for k in ("w", "h", "b"))
    assert ck.to_bytes({"one": np.arange(64, dtype=np.int8)}) == \
        serialization.to_bytes({"one": np.arange(64, dtype=np.int8)})


def test_msgpack_roundtrip(tmp_path):
    """tests/test_trainer.py's TestCheckpoints case on the port."""
    params = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
              "b": np.zeros(3, np.float32)}
    path = str(tmp_path / "p.msgpack")
    ck.save_variables(path, params)
    loaded = ck.load_variables(path, {"w": np.zeros((2, 3), np.float32),
                                      "b": np.ones(3, np.float32)})
    np.testing.assert_array_equal(loaded["w"], params["w"])
    assert list(loaded) == ["w", "b"]


def test_jax_package_files_load_in_the_port_and_back(tmp_path):
    tree = _params(1)
    jpath, tpath = str(tmp_path / "jax.msgpack"), str(tmp_path / "port.msgpack")
    jck.save_variables(jpath, tree)
    got = ck.load_variables(jpath)
    assert _same(got, tree)
    ck.save_variables(tpath, got)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    back = jck.load_variables(tpath, jax.tree_util.tree_map(np.zeros_like, tree))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    assert all(np.asarray(a).tobytes() == b.tobytes() for a, b in
               zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)))


def test_template_restores_structure_and_refuses_missing_keys(tmp_path):
    path = str(tmp_path / "t.msgpack")
    ck.save_variables(path, {"a": [np.zeros(2), np.ones(2)], "b": 3})
    got = ck.load_variables(path, {"b": 0, "a": (None, None)})
    assert list(got) == ["b", "a"] and isinstance(got["a"], tuple)
    with pytest.raises(ValueError, match="lacks keys"):
        ck.load_variables(path, {"a": None, "z": None})
    with pytest.raises(ValueError, match="expected a dict"):
        ck.restore({"a": None}, np.zeros(2))


def test_corrupt_files_raise(tmp_path):
    data = ck.to_bytes(_params())
    with pytest.raises(ValueError, match="truncated"):
        ck.from_bytes(data[:-3])
    with pytest.raises(ValueError, match="trailing"):
        ck.from_bytes(data + b"\x00")
    with pytest.raises(ValueError, match="ext type"):
        ck.from_bytes(b"\xd4\x09\x00")


@pytest.mark.parametrize("op", ["save", "load"])
def test_orbax_directories_are_refused(tmp_path, op):
    """A path without ``.msgpack`` is an orbax directory on both sides: the
    port's ("save") restores through the JAX package's load_variables, and
    the JAX package's ("load") loads in the port, bit for bit. The name
    predates the port's orbax support: directories were once refused."""
    path = str(tmp_path / "ckpt")
    tree = {"n": {"b": np.ones(2, np.int8)},
            "w": np.arange(6, dtype=np.float32).reshape(2, 3)}
    template = {"n": {"b": np.zeros(2, np.int8)}, "w": np.zeros((2, 3), np.float32)}
    if op == "save":
        ck.save_variables(path, tree)
        got = jck.load_variables(path, template)
    else:
        jck.save_variables(path, tree)
        got = ck.load_variables(path)
    assert _same(got, tree)
