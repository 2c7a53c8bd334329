"""The port's orbax checkpoint directories against orbax itself, on the CPU.

``nnstreamer_tpu_torch/utils/`` reads and writes the directories orbax's
``StandardCheckpointer`` writes (the JAX package's checkpoints for every
path that does not end in ``.msgpack``) with no orbax, tensorstore or
zstandard: ``zstd.py`` (the system's libzstd through ctypes), ``ocdbt.py``
(the OCDBT key-value store) and ``orbax_dir.py`` (zarr v2 arrays and the
tree's metadata). Here orbax 0.11.32, tensorstore and zstandard are the
oracles:

  * directories the JAX package writes load in the port leaf for leaf,
    bit-equal to orbax's own restore, with and without a template;
  * directories the port writes restore through orbax and through the JAX
    package's ``load_variables`` bit-equal, and tensorstore's ``ocdbt``
    kvstore lists the port's keys and values;
  * the codecs alone: zstd frames with and without a content size against
    zstandard, OCDBT stores in both directions against tensorstore
    (hypothesis), crc32c, zarr edge chunks and absent chunks;
  * the JAX package's own orbax tests (tests/test_trainer.py,
    tests/test_filter.py's checkpoint cases) in directory form;
  * the committed fixture tests/data/orbax_lenet_seed1 (written by
    scripts/make_orbax_fixture.py) equal to its ``.msgpack`` twin.
"""

import json
import os
import shutil
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ocp = pytest.importorskip("orbax.checkpoint")
ts = pytest.importorskip("tensorstore")
zstandard = pytest.importorskip("zstandard")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from nnstreamer_tpu.utils import checkpoints as jck  # noqa: E402
from nnstreamer_tpu_torch.utils import checkpoints as ck  # noqa: E402
from nnstreamer_tpu_torch.utils import ocdbt, orbax_dir, zstd  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FIXTURE_DIR = os.path.join(DATA, "orbax_lenet_seed1")
FIXTURE_MSGPACK = os.path.join(DATA, "lenet_seed1.msgpack")
CPU = torch.device("cpu")
MNV2 = "zoo://mobilenet_v2?width=0.25&size=32&num_classes=5&dtype=float32"


def _orbax_restore(path, target=None):
    return ocp.StandardCheckpointer().restore(os.path.abspath(path), target=target)


def _leaves(tree):
    """(structure, leaves) with None and empty containers kept as leaves."""
    def is_leaf(x):
        return x is None or (isinstance(x, (dict, list, tuple)) and not x)
    return jax.tree_util.tree_flatten(tree, is_leaf=is_leaf)


def _same(a, b):
    """Equal trees: structure, sequence types, dtypes, shapes and bytes (a
    Python scalar equal in type and value)."""
    (la, ta), (lb, tb) = _leaves(a), _leaves(b)
    assert ta == tb, (ta, tb)
    for x, y in zip(la, lb):
        if isinstance(x, (bool, int, float)) or x is None:
            assert type(x) is type(y) and x == y, (x, y)
        elif isinstance(x, (dict, list, tuple)):
            assert type(x) is type(y) and not y
        else:
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape, (x.dtype, y.dtype)
            assert x.tobytes() == y.tobytes()
    return True


def _to_numpy(tree):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) if isinstance(x, jax.Array) else x, tree)


def _sharded():
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("a", "b"))
    x = jnp.arange(8 * 6, dtype=jnp.float32).reshape(8, 6) / 7
    y = jnp.arange(8, dtype=jnp.int32)
    return {"x": jax.device_put(x, NamedSharding(mesh, P("a", "b"))),
            "y": jax.device_put(y, NamedSharding(mesh, P(None)))}


def _jax_tree(case):
    """The JAX package's trees of each kind the port must read."""
    rng = np.random.default_rng(0)
    if case == "nested":
        return {"params": {"Dense_0": {"kernel": jnp.asarray(rng.normal(size=(3, 2)),
                                                             jnp.float32),
                                       "bias": jnp.zeros(2)}},
                "lst": [np.ones(2, np.float32), (np.arange(3, dtype=np.int8), 7)],
                "tup": (np.float32(2.5), [True, 1.5])}
    if case == "dtypes":
        return {"f32": rng.normal(size=(4, 3)).astype(np.float32),
                "bf16": jnp.linspace(-3, 3, 11).astype(jnp.bfloat16),
                "f16": rng.normal(size=5).astype(np.float16),
                "f64": rng.normal(size=2),
                "i8": np.array([-128, -1, 0, 127], np.int8),
                "u8": np.arange(250, 256).astype(np.uint8),
                "i32": jnp.arange(-3, 3, dtype=jnp.int32),
                "u32": np.array([1, 2 ** 32 - 1], np.uint32),
                "b": np.array([True, False, True])}
    if case == "zero_d":
        return {"np0": np.float32(-0.5), "jax0": jnp.asarray(3, jnp.int32),
                "bf0": jnp.asarray(1.25, jnp.bfloat16), "i": 7, "f": 0.1,
                "t": False}
    if case == "out_of_line":
        return {"big": rng.normal(size=(300, 300)).astype(np.float32),
                "small": np.ones(3, np.float32)}
    if case == "multi_chunk":
        return _sharded()
    if case == "empty":
        return {"a": {}, "l": [], "t": (), "n": None, "b": np.ones(1)}
    if case == "top_list":
        return [np.ones(2, np.float32), (np.zeros(1, np.int32), 3)]
    if case == "lenet":
        from nnstreamer_tpu.models.zoo import get_model

        return get_model("zoo://lenet?seed=1").params
    if case == "mobilenet_v2":
        from nnstreamer_tpu.models.zoo import get_model

        return get_model(MNV2).params
    raise KeyError(case)


CASES = ["nested", "dtypes", "zero_d", "out_of_line", "multi_chunk", "empty",
         "top_list", "lenet", "mobilenet_v2"]


def _template(tree):
    """A template of the tree: zeros of each array's dtype, scalars'
    types, None and empty containers kept."""
    return jax.tree_util.tree_map(
        lambda x: np.zeros(np.shape(x), np.asarray(x).dtype)
        if isinstance(x, (np.ndarray, np.generic, jax.Array)) else type(x)(0),
        tree)


# --------------------------------------------------------------------------- #
# the port reads what orbax writes
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("case", CASES)
def test_jax_written_dirs_load_bit_equal(tmp_path, case):
    tree = _jax_tree(case)
    path = str(tmp_path / "ckpt")
    jck.save_variables(path, tree)
    _same(ck.load_variables(path), _to_numpy(_orbax_restore(path)))
    template = _template(tree)
    _same(ck.load_variables(path, template),
          _to_numpy(jck.load_variables(path, template)))


def test_multi_chunk_arrays_are_stored_in_chunks(tmp_path):
    """The sharded case really is chunked (4 x 2 chunks, and 8 chunks of
    one element for the replicated vector) and joins to the logical array."""
    path = str(tmp_path / "ckpt")
    tree = _sharded()
    jck.save_variables(path, tree)
    keys = ocdbt.Reader(path).list()
    assert sum(k.startswith(b"x/") and not k.endswith(b".zarray") for k in keys) == 8
    assert sum(k.startswith(b"y/") and not k.endswith(b".zarray") for k in keys) == 8
    got = ck.load_variables(path)
    np.testing.assert_array_equal(got["x"], np.asarray(tree["x"]))
    np.testing.assert_array_equal(got["y"], np.asarray(tree["y"]))


def test_out_of_line_values_sit_in_data_files(tmp_path):
    """orbax's config keeps values above 1 KiB out of the b-tree node; the
    reader follows them into the process's data files."""
    path = str(tmp_path / "ckpt")
    jck.save_variables(path, _jax_tree("out_of_line"))
    r = ocdbt.Reader(path)
    assert r.max_inline_value_bytes == 1024
    assert isinstance(r._refs[b"big/0.0"], tuple)
    assert r._refs[b"big/0.0"][0].startswith("ocdbt.process_0/d/")
    assert isinstance(r._refs[b"small/0"], bytes)


@pytest.mark.parametrize("cast", ["float16", "bfloat16", "int32", "float64"])
def test_template_dtypes_cast_as_orbax_does(tmp_path, cast):
    """A template leaf of another dtype than the file's: orbax casts to the
    template's; the port gives the same bytes. Scalars take the template's
    Python type."""
    path = str(tmp_path / "ckpt")
    rng = np.random.default_rng(1)
    jck.save_variables(path, {"w": rng.normal(size=(4, 5)).astype(np.float32) * 3,
                              "i": np.arange(-4, 4, dtype=np.int8), "n": 3, "x": 1.75})
    dt = jnp.bfloat16 if cast == "bfloat16" else np.dtype(cast)
    template = {"w": np.zeros((4, 5), dt), "i": np.zeros(8, dt), "n": 0.0, "x": 0}
    want = _to_numpy(jck.load_variables(path, template))
    got = ck.load_variables(path, template)
    _same(got, want)
    assert got["n"] == 3.0 and got["x"] == 1
    torch_template = {"w": torch.zeros(4, 5, dtype=getattr(torch, cast)),
                      "i": torch.zeros(8, dtype=getattr(torch, cast)), "n": 0.0, "x": 0}
    _same(ck.load_variables(path, torch_template), want)


def test_template_structure_mismatch_raises_as_orbax(tmp_path):
    path = str(tmp_path / "ckpt")
    jck.save_variables(path, {"a": np.ones(2), "b": np.zeros(3)})
    for template in ({"a": np.zeros(2)},
                     {"a": np.zeros(2), "b": np.zeros(3), "c": np.zeros(1)},
                     {"a": [0, 0], "b": np.zeros(3)}):
        with pytest.raises(ValueError):
            jck.load_variables(path, template)
        with pytest.raises(ValueError, match="do not match"):
            ck.load_variables(path, template)
    with pytest.raises(ValueError):
        jck.load_variables(path, {"a": 1.0, "b": np.zeros(3)})
    with pytest.raises(ValueError, match="not a scalar"):
        ck.load_variables(path, {"a": 1.0, "b": np.zeros(3)})
    none_template = {"a": None, "b": np.zeros(3)}
    assert ck.load_variables(path, none_template)["a"] is None
    assert jck.load_variables(path, none_template)["a"] is None


def test_a_bare_array_or_scalar_is_no_tree_on_either_side(tmp_path):
    """StandardCheckpointer refuses a single array; so does the port."""
    for value in (np.ones((8, 4), np.float32), 3):
        with pytest.raises(ValueError):
            jck.save_variables(str(tmp_path / "j"), value)
        with pytest.raises(ValueError, match="single array"):
            ck.save_variables(str(tmp_path / "p"), value)
    with pytest.raises(ValueError, match="zero size"):
        ck.save_variables(str(tmp_path / "z"), {"z": np.zeros((0, 3))})


# --------------------------------------------------------------------------- #
# orbax reads what the port writes
# --------------------------------------------------------------------------- #

def _port_tree(case):
    """The JAX case as the port holds it: tensors for jax arrays (bfloat16
    included), numpy and Python leaves as they are."""
    def conv(x):
        if isinstance(x, jax.Array):
            a = np.asarray(x)
            if a.dtype.name == "bfloat16":
                return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
            return torch.from_numpy(a.copy())
        return x
    return jax.tree_util.tree_map(conv, _jax_tree(case))


def _kv_items(path):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": "file://" + os.path.abspath(path)}
                         ).result()
    return {bytes(k): bytes(kv.read(k).result().value) for k in kv.list().result()}


@pytest.mark.parametrize("case", CASES)
def test_port_written_dirs_restore_through_orbax(tmp_path, case):
    tree = _port_tree(case)
    path = str(tmp_path / "ckpt")
    ck.save_variables(path, tree)
    want = _to_numpy(_orbax_restore(path))
    _same(ck.load_variables(path), want)
    _same(want, _to_numpy(_orbax_restore(str(_jax_dir(tmp_path, case)))))
    template = _template(_jax_tree(case))
    _same(_to_numpy(jck.load_variables(path, template)),
          ck.load_variables(path, template))
    assert _kv_items(path) == dict(ocdbt.Reader(path).items())


def _jax_dir(tmp_path, case):
    path = tmp_path / "jax"
    jck.save_variables(str(path), _jax_tree(case))
    return path


def test_port_directory_layout(tmp_path):
    """What the port writes: the metadata orbax reads and one OCDBT store
    at the root (no per-process store, no sharding file: every array is an
    np.ndarray leaf)."""
    path = tmp_path / "ckpt"
    ck.save_variables(str(path), {"params": {"w": np.ones((2, 3), np.float32)},
                                  "frames": 4, "opt": (None, {})})
    assert sorted(os.listdir(path)) == ["_CHECKPOINT_METADATA", "_METADATA", "d",
                                        "manifest.ocdbt"]
    meta = json.loads((path / "_METADATA").read_text())
    assert meta["use_ocdbt"] is True and meta["use_zarr3"] is False
    tm = meta["tree_metadata"]
    assert list(tm) == ["('frames',)", "('opt', '0')", "('opt', '1')", "('params', 'w')"]
    assert tm["('opt', '0')"]["key_metadata"][1] == {"key": "0", "key_type": 1}
    assert tm["('opt', '0')"]["value_metadata"] == {"value_type": "None",
                                                    "skip_deserialize": True}
    assert tm["('frames',)"]["value_metadata"]["value_type"] == "scalar"
    zarray = json.loads(ocdbt.Reader(str(path)).read("params.w/.zarray"))
    assert zarray == {"chunks": [2, 3], "compressor": {"id": "zstd", "level": 1},
                      "dimension_separator": ".", "dtype": "<f4", "fill_value": None,
                      "filters": None, "order": "C", "shape": [2, 3], "zarr_format": 2}


def test_overwrite_replaces_the_directory_while_readers_read(tmp_path):
    """save on an existing checkpoint replaces it (orbax's force=True), the
    new directory written beside it and renamed into place: a reader in
    another thread always sees one whole version."""
    path = str(tmp_path / "ckpt")
    versions = [{"w": np.full((64, 64), i, np.float32), "i": i} for i in range(6)]
    ck.save_variables(path, versions[0])
    seen, errors, done = set(), [], threading.Event()

    def read():
        while not done.is_set():
            try:
                got = ck.load_variables(path)
                assert (got["w"] == got["i"]).all()
                seen.add(got["i"])
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)
    reader = threading.Thread(target=read)
    reader.start()
    for v in versions[1:]:
        ck.save_variables(path, v)
    done.set()
    reader.join()
    assert not errors, errors[:3]
    assert ck.load_variables(path)["i"] == 5
    assert sorted(os.listdir(tmp_path)) == ["ckpt"]
    _same(_orbax_restore(path), {"i": 5, "w": versions[5]["w"]})


def test_missing_and_empty_directories_raise_file_not_found(tmp_path):
    (tmp_path / "empty").mkdir()
    for p in (tmp_path / "empty", tmp_path / "none.orbax"):
        with pytest.raises(FileNotFoundError):
            jck.load_variables(str(p), {"a": np.zeros(1)})
        with pytest.raises(FileNotFoundError):
            ck.load_variables(str(p))


# --------------------------------------------------------------------------- #
# the codecs alone
# --------------------------------------------------------------------------- #

def test_crc32c_check_value():
    assert ocdbt.crc32c(b"123456789") == 0xE3069283
    assert ocdbt.crc32c(b"") == 0
    assert ocdbt.crc32c(bytes(32)) == 0x8A9136AA
    assert ocdbt.crc32c(b"6789", ocdbt.crc32c(b"12345")) == 0xE3069283


_SLOW = settings(max_examples=25, deadline=None,
                 suppress_health_check=[HealthCheck.function_scoped_fixture,
                                        HealthCheck.too_slow])


@_SLOW
@given(data=st.binary(max_size=20000) | st.builds(lambda n, b: b * n,
                                                  st.integers(0, 30000),
                                                  st.binary(min_size=1, max_size=3)),
       level=st.integers(1, 9), content_size=st.booleans())
def test_zstd_against_zstandard(data, level, content_size):
    frame = zstandard.ZstdCompressor(level=level,
                                     write_content_size=content_size).compress(data)
    assert zstd.decompress(frame) == data
    assert zstd.decompress(frame, size_hint=max(1, len(data) // 7)) == data
    assert zstandard.ZstdDecompressor().decompress(zstd.compress(data, level)) == data


def test_zstd_streamed_frames_and_errors():
    import io

    data = os.urandom(200000) + bytes(600000)
    out = io.BytesIO()
    with zstandard.ZstdCompressor(level=3).stream_writer(out, closefd=False) as w:
        for i in range(0, len(data), 65536):
            w.write(data[i:i + 65536])
    frame = out.getvalue()
    assert zstandard.get_frame_parameters(frame).content_size == \
        zstandard.CONTENTSIZE_UNKNOWN
    assert zstd.decompress(frame) == data
    with pytest.raises(ValueError, match="truncated"):
        zstd.decompress(frame[:-20])
    with pytest.raises(ValueError, match="not a zstd frame"):
        zstd.decompress(b"not zstd at all")


_KEYS = st.binary(min_size=1, max_size=24) | st.text(
    alphabet="ab./0_", min_size=1, max_size=16).map(str.encode)


@_SLOW
@given(items=st.dictionaries(_KEYS, st.binary(max_size=2500), max_size=40))
def test_port_stores_read_in_tensorstore(tmp_path_factory, items):
    path = str(tmp_path_factory.mktemp("store"))
    ocdbt.write_store(path, items)
    assert _kv_items(path) == items
    assert dict(ocdbt.Reader(path).items()) == items


@_SLOW
@given(items=st.dictionaries(_KEYS, st.binary(max_size=600), min_size=1, max_size=60),
       node_bytes=st.sampled_from([200, 400, 8 << 20]),
       inline=st.sampled_from([0, 20, 100, 1024]),
       batches=st.integers(1, 3))
def test_tensorstore_stores_read_in_the_port(tmp_path_factory, items, node_bytes,
                                             inline, batches):
    """Interior nodes (small max_decoded_node_bytes), inline and
    out-of-line values, several versions (one commit per batch)."""
    path = str(tmp_path_factory.mktemp("store"))
    kv = ts.KvStore.open({"driver": "ocdbt", "base": "file://" + path,
                          "config": {"max_decoded_node_bytes": node_bytes,
                                     "max_inline_value_bytes": inline}}).result()
    keys = sorted(items)
    for b in range(batches):
        with ts.Transaction() as txn:
            for k in keys[b::batches]:
                kv.with_transaction(txn)[k] = items[k]
    r = ocdbt.Reader(path)
    assert r.list() == keys
    assert dict(r.items()) == items


def test_corruption_and_unsupported_stores_raise_naming_it(tmp_path):
    path = tmp_path / "s"
    ocdbt.write_store(str(path), {b"k": b"v" * 2000})
    man = path / "manifest.ocdbt"
    raw = bytearray(man.read_bytes())
    raw[20] ^= 0xFF
    man.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="crc32c"):
        ocdbt.Reader(str(path))
    numbered = tmp_path / "n"
    kv = ts.KvStore.open({"driver": "ocdbt", "base": "file://" + str(numbered),
                          "config": {"manifest_kind": "numbered"}}).result()
    kv[b"a"] = b"1"
    with pytest.raises(ValueError, match="numbered"):
        ocdbt.Reader(str(numbered))


def _zarr_store(path, meta, region, values):
    spec = {"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": "file://" + path,
                                          "path": "arr/"},
            "metadata": meta, "create": True}
    arr = ts.open(spec).result()
    arr[region] = values
    return arr


@pytest.mark.parametrize("dtype,compressor,fill", [
    ("<f4", {"id": "zstd", "level": 1}, 1.5), ("bfloat16", None, None),
    ("|b1", {"id": "zstd", "level": 3}, True), ("<i2", None, -7),
    ("<f8", {"id": "zstd", "level": 1}, "NaN")])
def test_zarr_edge_chunks_and_absent_chunks(tmp_path, dtype, compressor, fill):
    """A (7, 10) array in (3, 4) chunks: the edge chunks are cut, chunks
    never written read as fill_value."""
    path = str(tmp_path / "z")
    meta = {"shape": [7, 10], "chunks": [3, 4], "dtype": dtype,
            "compressor": compressor, "fill_value": fill, "order": "C"}
    np_dtype = orbax_dir.numpy_dtype(dtype)
    values = (np.arange(30).reshape(5, 6) % 3).astype(np_dtype)
    arr = _zarr_store(path, meta, (slice(1, 6), slice(0, 6)), values)
    want = arr.read().result()
    r = ocdbt.Reader(path)
    assert len([k for k in r.list() if not k.endswith(b".zarray")]) < 9
    got = orbax_dir.read_array("arr", lambda k: r.read("arr/" + k[len("arr") + 1:]))
    assert got.dtype == np_dtype and got.shape == (7, 10)
    assert got.tobytes() == np.asarray(want).astype(np_dtype).tobytes()


@pytest.mark.parametrize("field,value,match", [
    ("order", "F", "order"), ("filters", [{"id": "delta", "dtype": "<f4"}], "filters"),
    ("compressor", {"id": "blosc"}, "compressor"), ("dimension_separator", "/",
                                                    "dimension_separator"),
    ("zarr_format", 3, "zarr_format"), ("dtype", [["a", "<f4"]], "structured")])
def test_zarr_features_the_port_does_not_take_raise_naming_them(field, value, match):
    meta = {"chunks": [2], "compressor": None, "dimension_separator": ".",
            "dtype": "<f4", "fill_value": None, "filters": None, "order": "C",
            "shape": [2], "zarr_format": 2, field: value}
    store = {"a/.zarray": json.dumps(meta).encode(), "a/0": bytes(8)}
    with pytest.raises(ValueError, match=match):
        orbax_dir.read_array("a", store.get)


def test_zarr3_and_non_ocdbt_checkpoints_raise_naming_them(tmp_path):
    path = tmp_path / "ckpt"
    ck.save_variables(str(path), {"a": np.ones(2)})
    meta = json.loads((path / "_METADATA").read_text())
    for key, value, match in (("use_zarr3", True, "zarr3"),
                              ("use_ocdbt", False, "use_ocdbt")):
        (path / "_METADATA").write_text(json.dumps({**meta, key: value}))
        with pytest.raises(ValueError, match=match):
            ck.load_variables(str(path))


# --------------------------------------------------------------------------- #
# the JAX package's orbax tests, on the port
# --------------------------------------------------------------------------- #

def test_orbax_roundtrip(tmp_path):
    """tests/test_trainer.py's TestCheckpoints.test_orbax_roundtrip."""
    params = {"w": np.ones((4, 4), np.float32)}
    path = str(tmp_path / "ckpt")
    ck.save_variables(path, params)
    loaded = ck.load_variables(path, {"w": np.zeros((4, 4), np.float32)})
    np.testing.assert_array_equal(loaded["w"], params["w"])


def test_resume_cycle_with_orbax_dir(tmp_path):
    """tests/test_trainer.py's test_resume_cycle_with_orbax_dir on the port:
    save -> load -> save with a directory checkpoint overwrites cleanly."""
    import test_torch_trainer as tt

    ckpt = tmp_path / "orbax_ckpt"
    rng = np.random.default_rng(2)

    def run():
        data = [(rng.normal(size=(2, 8)).astype(np.float32), np.zeros(2, np.int32))
                for _ in range(3)]
        return tt.train(tt.PORT, tt.linear_model(tt.PORT), data, dims="8:2,2",
                        checkpoint_path=str(ckpt), resume=True)[0]

    run()
    t2 = run()
    assert t2._n == 6
    assert sorted(os.listdir(tmp_path)) == ["orbax_ckpt"]


@pytest.mark.parametrize("opt", ["sgd", "adam", "adamw"])
@pytest.mark.parametrize("writer", ["jax", "torch"], ids=["jax-writes", "port-writes"])
def test_trainer_resume_dirs_cross_bit_for_bit(tmp_path, writer, opt):
    """One package's trainer trains 5 frames and writes a resume directory
    ({params, opt_state, frames}); the other resumes it (masters and moments
    bit-equal, frame counter 5), and the port reads both packages' payloads
    leaf for leaf as orbax restores them."""
    import test_torch_trainer as tt

    ns = {"jax": tt.JAX, "torch": tt.PORT}
    w, r = ns[writer], ns["torch" if writer == "jax" else "jax"]
    ckpt = str(tmp_path / "resume")
    tw, _, _ = tt.train(w, tt.linear_model(w), tt.linear_data(5), learning_rate=0.05,
                        optimizer=opt, checkpoint_path=ckpt, resume=True)
    saved = ck.load_variables(ckpt)
    _same(saved, _to_numpy(_orbax_restore(ckpt)))
    assert saved["frames"] == 5 and saved["opt_state"][1] is None
    tr, _, _ = tt.train(r, tt.linear_model(r), [], learning_rate=0.05, optimizer=opt,
                        checkpoint_path=ckpt, resume=True)
    assert tr._n == 5
    assert tt._leaves_bytes(tr.params) == tt._leaves_bytes(tw.params)
    _same(ck.load_variables(ckpt), saved)


def test_jax_mobilenet_resume_dir_resumes_in_the_port(tmp_path):
    """A flax model's resume payload (params and batch_stats, adam's
    moments) written by the JAX trainer: the port's masters equal it."""
    import test_torch_trainer as tt

    ckpt = str(tmp_path / "m")
    tt.train(tt.JAX, tt._jax_mnv2(), tt._mnv2_data(2), dims="3:32:32:2,2",
             types="uint8,int32", optimizer="adam", checkpoint_path=ckpt, resume=True)
    tr, _, _ = tt.train(tt.PORT, tt._port_mnv2(), [], dims="3:32:32:2,2",
                        types="uint8,int32", optimizer="adam", checkpoint_path=ckpt,
                        resume=True)
    assert tr._n == 2
    saved = _to_numpy(_orbax_restore(ckpt))
    assert tt._leaves_bytes(tr.params) == tt._leaves_bytes(saved["params"])


def test_checkpoint_plus_arch_deploy(tmp_path):
    """tests/test_filter.py's test_checkpoint_plus_arch_deploy with an orbax
    directory the JAX package wrote."""
    from nnstreamer_tpu.models import get_model as jget_model
    from nnstreamer_tpu_torch.models import load_checkpointed

    bundle = jget_model(MNV2)
    path = str(tmp_path / "params")
    jck.save_variables(path, bundle.params)
    restored = load_checkpointed(path, "zoo://mobilenet_v2", device="cpu", width="0.25",
                                 size="32", num_classes="5", dtype="float32")
    x = np.random.default_rng(0).normal(size=(1, 32, 32, 3)).astype(np.float32)
    with torch.inference_mode():
        got = restored.fn()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(bundle.fn()(x)),
                               rtol=1e-5, atol=1e-6)


def test_checkpoint_via_filter_custom_arch(tmp_path):
    """tests/test_filter.py's test_checkpoint_via_filter_custom_arch: an
    orbax directory + custom="arch=...,arch_*" through the filter."""
    from nnstreamer_tpu.models import get_model as jget_model
    from nnstreamer_tpu_torch.core.buffer import TensorMemory
    from nnstreamer_tpu_torch.filters.base import FilterProps
    from nnstreamer_tpu_torch.filters.torch_cuda import TorchCudaFilter

    bundle = jget_model("zoo://lstm_cell?features=4&input_size=3")
    path = str(tmp_path / "cell.orbax")
    jck.save_variables(path, bundle.params)
    f = TorchCudaFilter()
    f.open(FilterProps(model=path, device=CPU,
                       custom="sync=true,arch=zoo://lstm_cell,arch_features=4,"
                              "arch_input_size=3"))
    rng = np.random.default_rng(3)
    xs = [rng.normal(size=s).astype(np.float32) for s in ((1, 3), (1, 4), (1, 4))]
    outs = f.invoke([TensorMemory(x) for x in xs])
    ref = bundle.fn()(*xs)
    for o, r in zip(outs, ref):
        np.testing.assert_allclose(o.host(), np.asarray(r), rtol=1e-5, atol=1e-6)
    f.close()


@pytest.mark.parametrize("path_kind", ["dir", "msgpack"])
def test_zoo_checkpoint_option_restores_as_jax(tmp_path, path_kind):
    """The zoo's checkpoint= (models/lenet.py) with a directory or a file
    the JAX package wrote: the port's logits equal the JAX bundle's."""
    from nnstreamer_tpu.models import get_model as jget_model
    from nnstreamer_tpu_torch.models import get_model

    params = jget_model("zoo://lenet?seed=3").params
    path = str(tmp_path / ("ck" if path_kind == "dir" else "ck.msgpack"))
    jck.save_variables(path, params)
    port = get_model(f"zoo://lenet?checkpoint={path}", device="cpu", fresh=True)
    ref = jget_model(f"zoo://lenet?checkpoint={path}")
    x = np.random.default_rng(4).integers(0, 256, (1, 28, 28, 1), dtype=np.uint8)
    with torch.inference_mode():
        got = port.fn()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.fn()(x)), rtol=1e-5, atol=1e-6)


def test_sharded_state_from_a_jax_orbax_dir_restores_on_the_host(tmp_path):
    """parallel/checkpoint.restore_sharded_state without a mesh on the JAX
    package's save_sharded_state directory: params, and adam's moments and
    count mapped onto the port's per-leaf state."""
    import optax

    from nnstreamer_tpu.parallel import save_sharded_state as jsave
    from nnstreamer_tpu_torch.parallel import restore_sharded_state

    rng = np.random.default_rng(5)
    params = {"w1": jnp.asarray(rng.normal(size=(8, 16)), jnp.float32),
              "w2": jnp.asarray(rng.normal(size=(16, 4)), jnp.float32)}
    opt = optax.adam(1e-2)
    state = opt.init(params)
    grads = jax.tree_util.tree_map(jnp.ones_like, params)
    _, state = opt.update(grads, state, params)
    jsave(str(tmp_path / "s"), params, state)
    like = {k: np.zeros(v.shape, np.float32) for k, v in params.items()}
    opt_like = {k: {"0": {"count": np.zeros((), np.int32), "mu": v, "nu": v}, "1": {}}
                for k, v in like.items()}
    got, got_opt = restore_sharded_state(str(tmp_path / "s"), like,
                                         opt_state_like=opt_like)
    for k in params:
        assert got[k].tobytes() == np.asarray(params[k]).tobytes()
        assert got_opt[k]["0"]["mu"].tobytes() == np.asarray(state[0].mu[k]).tobytes()
        assert got_opt[k]["0"]["nu"].tobytes() == np.asarray(state[0].nu[k]).tobytes()
        assert int(got_opt[k]["0"]["count"]) == int(state[0].count) == 1
    only, none = restore_sharded_state(str(tmp_path / "s"), like)
    assert none is None and all(only[k].tobytes() == got[k].tobytes() for k in like)


# --------------------------------------------------------------------------- #
# the committed fixture
# --------------------------------------------------------------------------- #

def test_fixture_dir_equals_its_msgpack_and_orbax():
    """tests/data/orbax_lenet_seed1 (orbax 0.11.32, jax.Array leaves, a
    per-process store merged under the root manifest) loads bit-equal to
    lenet_seed1.msgpack and to orbax's restore of it."""
    got = ck.load_variables(FIXTURE_DIR)
    flat = ck.load_variables(FIXTURE_MSGPACK)
    _same(got, {"params": {k: flat["params"][k] for k in sorted(flat["params"])}})
    _same(got, _to_numpy(_orbax_restore(FIXTURE_DIR)))
    assert os.path.isdir(os.path.join(FIXTURE_DIR, "ocdbt.process_0"))


def test_fixture_serves_the_labels_of_its_msgpack():
    from nnstreamer_tpu_torch.filters.torch_cuda import resolve_model

    x = np.random.default_rng(6).integers(0, 256, (1, 28, 28, 1), dtype=np.uint8)
    out = {}
    for path in (FIXTURE_DIR, FIXTURE_MSGPACK):
        b = resolve_model(path, {"arch": "zoo://lenet"}, device=CPU)
        with torch.inference_mode():
            out[path] = b.fn()(torch.from_numpy(x))
    assert torch.equal(out[FIXTURE_DIR], out[FIXTURE_MSGPACK])


def test_fixture_is_the_script_output(tmp_path):
    """scripts/make_orbax_fixture.py writes the committed trees (the
    directory's uuids and timestamps aside)."""
    import subprocess
    import sys

    root = os.path.dirname(DATA)
    subprocess.run([sys.executable, os.path.join(os.path.dirname(root), "scripts",
                                                 "make_orbax_fixture.py"),
                    "--out", str(tmp_path)], check=True, capture_output=True,
                   timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert (tmp_path / "lenet_seed1.msgpack").read_bytes() == \
        open(FIXTURE_MSGPACK, "rb").read()
    _same(ck.load_variables(str(tmp_path / "orbax_lenet_seed1")),
          ck.load_variables(FIXTURE_DIR))
    shutil.rmtree(tmp_path)
