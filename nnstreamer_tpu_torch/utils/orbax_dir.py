"""Orbax checkpoint directories, read and written without orbax.

The JAX package saves every checkpoint path that does not end in
``.msgpack`` with orbax's ``StandardCheckpointer`` (``force=True``). Such a
directory, as orbax 0.11.32 writes it, holds:

* ``_METADATA``: JSON; ``tree_metadata`` maps each leaf's key path (the
  ``repr`` of a tuple of strings) to its keys (``key_type`` 2 for a dict
  key or a named field, 1 for a sequence index) and its value metadata
  (``value_type`` ``np.ndarray``, ``jax.Array`` or ``scalar`` for a stored
  leaf; ``None``, ``Dict``, ``List`` or ``Tuple`` for a leaf of nothing,
  with ``skip_deserialize``), then ``use_ocdbt: true`` and ``use_zarr3:
  false``;
* ``_CHECKPOINT_METADATA``: JSON naming the handler, with timestamps;
* ``manifest.ocdbt`` and data files: an OCDBT store (utils/ocdbt.py)
  holding, for each stored leaf named by its keys joined with ``.``, a zarr
  v2 array: ``<name>/.zarray`` (JSON) and its chunks ``<name>/0.0``...
  (``0`` for a 0-d array), each one zstd frame of the chunk's C-order
  bytes;
* for ``jax.Array`` leaves also ``_sharding`` and
  ``array_metadatas/process_0``, which restoring a host array does not
  read; per-process stores under ``ocdbt.process_<N>/``, whose data files
  the root manifest references.

``save`` writes the numpy form of that layout (every array leaf an
``np.ndarray`` leaf, one chunk each; Python scalars ``scalar`` leaves)
into a new directory beside ``path`` and renames it into place, replacing
what was there; ``load`` reads a directory orbax or ``save`` wrote, with
orbax's restore semantics for a template (below). zarr arrays of several
chunks (a sharded ``jax.Array`` is stored one chunk per shard) are
assembled with their edge chunks cut. What this module does not read
raises a ``ValueError`` naming it: zarr3, a store without OCDBT, zarr
filters, Fortran order, another compressor than zstd or none, a
dimension separator other than ``.``.
"""

from __future__ import annotations

import itertools
import json
import os
import shutil
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import ocdbt
from .checkpoints import host_array

METADATA = "_METADATA"
CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
           "StandardCheckpointHandler")
#: zarr's zstd compressor as orbax configures it
COMPRESSOR = {"id": "zstd", "level": 1}
#: key_type of _METADATA's key_metadata
SEQUENCE_KEY, DICT_KEY = 1, 2
_EMPTY = {"Dict": dict, "List": list, "Tuple": tuple}


def is_orbax_dir(path: str) -> bool:
    """True for a directory that holds an orbax checkpoint's metadata."""
    return os.path.isfile(os.path.join(path, METADATA))


# --------------------------------------------------------------------------- #
# zarr v2 arrays
# --------------------------------------------------------------------------- #

def _bf16() -> np.dtype:
    from ..core.types import TensorDType

    return TensorDType.BFLOAT16.np_dtype


def zarr_dtype(dtype: np.dtype) -> str:
    """zarr v2's name of ``dtype`` as tensorstore writes it."""
    if dtype == _bf16():
        return "bfloat16"
    if dtype.kind not in "biufc":
        raise ValueError(f"zarr: dtype {dtype} is not supported")
    return dtype.newbyteorder("<").str if dtype.itemsize > 1 else dtype.str


def numpy_dtype(name: Any) -> np.dtype:
    """The numpy dtype of a zarr v2 ``dtype`` field."""
    if name == "bfloat16":
        return _bf16()
    if not isinstance(name, str):
        raise ValueError(f"zarr: structured dtype {name!r} is not supported")
    dt = np.dtype(name)
    if dt.kind not in "biufc":
        raise ValueError(f"zarr: dtype {name!r} is not supported")
    return dt


def _chunk_key(index: Tuple[int, ...]) -> str:
    return ".".join(map(str, index)) if index else "0"


def array_entries(name: str, arr: np.ndarray) -> Dict[str, bytes]:
    """The store entries of ``arr`` as one-chunk zarr v2 array ``name``."""
    from . import zstd

    meta = {"chunks": list(arr.shape), "compressor": COMPRESSOR,
            "dimension_separator": ".", "dtype": zarr_dtype(arr.dtype),
            "fill_value": None, "filters": None, "order": "C",
            "shape": list(arr.shape), "zarr_format": 2}
    raw = arr.tobytes("C")
    return {f"{name}/.zarray": json.dumps(meta, sort_keys=True,
                                          separators=(",", ":")).encode(),
            f"{name}/{_chunk_key((0,) * arr.ndim)}":
                zstd.compress(raw, COMPRESSOR["level"])}


def _fill(value: Any) -> Any:
    if value is None:
        return 0
    if isinstance(value, str):
        named = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}
        if value not in named:
            raise ValueError(f"zarr: fill_value {value!r} is not supported")
        return named[value]
    return value


def read_array(name: str, get: Callable[[str], Optional[bytes]]) -> np.ndarray:
    """zarr v2 array ``name`` from ``get(key) -> bytes or None``."""
    from . import zstd

    raw_meta = get(f"{name}/.zarray")
    if raw_meta is None:
        raise ValueError(f"zarr: the checkpoint holds no array {name!r}")
    meta = json.loads(raw_meta)
    if meta.get("zarr_format") != 2:
        raise ValueError(f"zarr: {name}: zarr_format {meta.get('zarr_format')}"
                         " is not supported (only 2)")
    if meta.get("filters"):
        raise ValueError(f"zarr: {name}: filters {meta['filters']} are not "
                         "supported")
    if meta.get("order", "C") != "C":
        raise ValueError(f"zarr: {name}: order {meta['order']!r} is not "
                         "supported (only C)")
    if meta.get("dimension_separator", ".") != ".":
        raise ValueError(f"zarr: {name}: dimension_separator "
                         f"{meta['dimension_separator']!r} is not supported")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"zarr: {name}: compressor {comp.get('id')!r} is not "
                         "supported (zstd or none)")
    dtype = numpy_dtype(meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks) or any(c < 1 for c in chunks):
        raise ValueError(f"zarr: {name}: chunks {list(chunks)} do not fit "
                         f"shape {list(shape)}")
    nbytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    fill = _fill(meta.get("fill_value"))
    if 0 in shape:
        return np.empty(shape, dtype)
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    out: Optional[np.ndarray] = None
    for index in itertools.product(*grid):
        data = get(f"{name}/{_chunk_key(index)}")
        if data is None:
            chunk = np.full(chunks, fill, dtype)
        else:
            if comp is not None:
                data = zstd.decompress(data, nbytes)
            if len(data) != nbytes:
                raise ValueError(f"zarr: {name}/{_chunk_key(index)}: "
                                 f"{len(data)} bytes, a chunk has {nbytes}")
            chunk = np.frombuffer(data, dtype).reshape(chunks)
        if chunks == shape:
            out = chunk
            break
        if out is None:
            out = np.empty(shape, dtype)
        dst = tuple(slice(i * c, min((i + 1) * c, s))
                    for i, c, s in zip(index, chunks, shape))
        out[dst] = chunk[tuple(slice(0, d.stop - d.start) for d in dst)]
    assert out is not None
    if not dtype.isnative:
        out = out.astype(dtype.newbyteorder("="))
    return out.copy() if not out.flags.writeable else out


# --------------------------------------------------------------------------- #
# the tree
# --------------------------------------------------------------------------- #

def _flatten(tree: Any, keys: Tuple[Tuple[str, int], ...] = ()
             ) -> List[Tuple[Tuple[Tuple[str, int], ...], Any]]:
    """(keys, leaf) pairs in orbax's order (a dict's keys sorted, as
    jax's tree flattening has them); an empty container is a leaf."""
    if isinstance(tree, dict) and tree:
        out = []
        for k in sorted(tree, key=str):
            out += _flatten(tree[k], keys + ((str(k), DICT_KEY),))
        return out
    if isinstance(tree, (list, tuple)) and tree:
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, keys + ((str(i), SEQUENCE_KEY),))
        return out
    return [(keys, tree)]


def _leaf_value(leaf: Any) -> Tuple[str, Optional[np.ndarray]]:
    """(value_type, array to store or None) of one leaf."""
    if leaf is None:
        return "None", None
    for type_name, cls in _EMPTY.items():
        if isinstance(leaf, cls):  # an empty container
            return type_name, None
    if isinstance(leaf, (bool, int, float)):
        return "scalar", np.asarray(leaf, np.bool_ if isinstance(leaf, bool)
                                    else np.int64 if isinstance(leaf, int)
                                    else np.float64)
    if isinstance(leaf, torch.Tensor):
        return "np.ndarray", host_array(leaf)
    if isinstance(leaf, (np.ndarray, np.generic)):
        return "np.ndarray", np.asarray(leaf)
    raise TypeError(f"orbax checkpoint: cannot store a leaf of type "
                    f"{type(leaf).__name__}")


def save(path: str, tree: Any) -> None:
    """Write ``tree`` (nested dicts, lists and tuples of tensors, numpy
    arrays and Python scalars) as an orbax checkpoint directory at
    ``path``, replacing one that is there."""
    if not isinstance(tree, (dict, list, tuple)):
        raise ValueError("orbax checkpoint: a single array or scalar is not "
                         "a tree; StandardCheckpointer does not save one "
                         "either (wrap it in a dict)")
    items: Dict[str, bytes] = {}
    tree_metadata: Dict[str, Any] = {}
    for keys, leaf in _flatten(tree):
        value_type, arr = _leaf_value(leaf)
        entry: Dict[str, Any] = {"value_type": value_type,
                                 "skip_deserialize": arr is None}
        name = ".".join(k for k, _ in keys)
        if arr is not None:
            if arr.size == 0:
                raise ValueError(f"orbax checkpoint: {name}: cannot save "
                                 "arrays with zero size")
            items.update(array_entries(name, arr))
        tree_metadata[repr(tuple(k for k, _ in keys))] = {
            "key_metadata": [{"key": k, "key_type": t} for k, t in keys],
            "value_metadata": entry}
    init_ns = time.time_ns()
    path = os.path.abspath(path)
    tmp = f"{path}.orbax-checkpoint-tmp-{uuid.uuid4().hex[:12]}"
    try:
        ocdbt.write_store(tmp, items)
        _write_json(os.path.join(tmp, METADATA), {
            "tree_metadata": tree_metadata, "use_ocdbt": True,
            "use_zarr3": False, "store_array_data_equal_to_fill_value": True,
            "custom_metadata": None})
        _write_json(os.path.join(tmp, CHECKPOINT_METADATA), {
            "item_handlers": HANDLER, "metrics": {},
            "performance_metrics": {}, "init_timestamp_nsecs": init_ns,
            "commit_timestamp_nsecs": time.time_ns(), "custom_metadata": {}})
        _replace(tmp, path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _write_json(path: str, obj: Any) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)


def _replace(new: str, path: str) -> None:
    """Move directory ``new`` to ``path``; what was at ``path`` is moved
    aside first and removed after, so a reader sees the old checkpoint or
    the new one whole (``load`` retries a read that loses its files)."""
    if not os.path.lexists(path):
        os.rename(new, path)
        return
    old = f"{path}.orbax-checkpoint-old-{uuid.uuid4().hex[:12]}"
    os.rename(path, old)
    os.rename(new, path)
    if os.path.isdir(old) and not os.path.islink(old):
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.remove(old)


class _Tree:
    """A container of the stored tree: its kind and children by key."""

    def __init__(self, kind: int) -> None:
        self.kind = kind
        self.children: Dict[str, Any] = {}


class _Leaf:
    def __init__(self, name: str, value_type: str) -> None:
        self.name, self.value_type = name, value_type


def _read_tree(meta: Dict[str, Any]) -> Any:
    root: Optional[_Tree] = None
    for entry in meta["tree_metadata"].values():
        keys = [(str(k["key"]), int(k["key_type"])) for k in entry["key_metadata"]]
        if not keys:
            raise ValueError("orbax checkpoint: a leaf with no key path")
        if root is None:
            root = _Tree(keys[0][1])
        node = root
        for (k, _), (_, child_kind) in zip(keys, keys[1:]):
            child = node.children.get(k)
            if child is None:
                child = node.children[k] = _Tree(child_kind)
            node = child
        node.children[keys[-1][0]] = _Leaf(
            ".".join(k for k, _ in keys), entry["value_metadata"]["value_type"])
    if root is None:
        raise ValueError("orbax checkpoint: _METADATA holds no leaf")
    return root


def _value(leaf: _Leaf, reader: ocdbt.Reader) -> Any:
    vt = leaf.value_type
    if vt == "None":
        return None
    if vt in _EMPTY:
        return _EMPTY[vt]()
    if vt not in ("np.ndarray", "jax.Array", "scalar"):
        raise ValueError(f"orbax checkpoint: {leaf.name}: value type {vt!r} "
                         "is not supported")
    arr = read_array(leaf.name, reader.read)
    return arr.item() if vt == "scalar" else arr


def _plain(node: Any, reader: ocdbt.Reader) -> Any:
    """The stored tree as orbax restores it without a target."""
    if isinstance(node, _Leaf):
        return _value(node, reader)
    items = {k: _plain(v, reader) for k, v in node.children.items()}
    if node.kind == SEQUENCE_KEY:
        return [items[k] for k in sorted(items, key=int)]
    return items


def _mismatch(path: str, what: str) -> ValueError:
    return ValueError("orbax checkpoint: the template's tree and the "
                      f"checkpoint's do not match at {path or '/'}: {what}")


def _template_dtype(t: Any) -> Optional[np.dtype]:
    if isinstance(t, torch.Tensor):
        from ..core.types import TensorDType

        return TensorDType.parse(str(t.dtype).removeprefix("torch.")).np_dtype
    dt = getattr(t, "dtype", None)
    return np.dtype(dt) if dt is not None else None


def _restore(tmpl: Any, node: Any, reader: ocdbt.Reader, path: str) -> Any:
    """``node`` restored into ``tmpl`` as orbax's restore with a target:
    the template's structure (its key order, its sequence types), each
    array cast to the template leaf's dtype, each scalar to the template's
    Python type; a None template leaf, and a None stored leaf, give None."""
    if isinstance(tmpl, (dict, list, tuple)) and tmpl:
        if isinstance(node, _Leaf):
            raise _mismatch(path, f"a container in the template, a "
                                  f"{node.value_type} leaf in the checkpoint")
        want = [str(k) for k in tmpl] if isinstance(tmpl, dict) \
            else [str(i) for i in range(len(tmpl))]
        missing = sorted(set(node.children) - set(want))
        extra = sorted(set(want) - set(node.children))
        if missing or extra:
            raise _mismatch(path, f"keys only in the checkpoint {missing}, "
                                  f"only in the template {extra}")
        if isinstance(tmpl, dict):
            return {k: _restore(v, node.children[str(k)], reader, f"{path}/{k}")
                    for k, v in tmpl.items()}
        return type(tmpl)(_restore(v, node.children[str(i)], reader, f"{path}/{i}")
                          for i, v in enumerate(tmpl))
    if not isinstance(node, _Leaf):
        raise _mismatch(path, f"a leaf in the template, a container in the "
                              "checkpoint")
    if tmpl is None:
        return None
    value = _value(node, reader)
    if value is None:
        return None
    if isinstance(tmpl, (dict, list, tuple)):  # an empty container
        return type(tmpl)()
    if isinstance(tmpl, (bool, int, float)):
        if isinstance(value, np.ndarray):
            if value.ndim:
                raise ValueError(f"orbax checkpoint: {node.name}: the "
                                 "restored result is not a scalar")
            value = value.item()
        return type(tmpl)(value)
    dtype = _template_dtype(tmpl)
    arr = np.asarray(value)
    return arr if dtype is None or arr.dtype == dtype else arr.astype(dtype)


def load(path: str, template: Any = None) -> Any:
    """The tree of the orbax checkpoint directory at ``path``: without a
    template as orbax restores it without a target (dicts, lists, numpy
    arrays, Python scalars), with one into the template (``_restore``). A
    read that loses its files to a concurrent ``save`` is made again."""
    for attempt in range(4):  # a save renames the old directory away first
        try:
            return _load_once(path, template)
        except FileNotFoundError:
            time.sleep(0.02 * (attempt + 1))
    return _load_once(path, template)


def _load_once(path: str, template: Any) -> Any:
    if not os.path.isdir(path):
        raise FileNotFoundError(f"orbax checkpoint at {path} not found")
    try:
        with open(os.path.join(path, METADATA)) as f:
            meta = json.load(f)
    except FileNotFoundError as e:
        raise FileNotFoundError(f"{path}: no orbax checkpoint here (no "
                                f"{METADATA})") from e
    if meta.get("use_zarr3"):
        raise ValueError(f"orbax checkpoint {path}: use_zarr3 (zarr v3 "
                         "arrays) is not supported, only zarr v2")
    if not meta.get("use_ocdbt", False):
        raise ValueError(f"orbax checkpoint {path}: arrays outside an OCDBT "
                         "store (use_ocdbt false) are not supported")
    tree = _read_tree(meta)
    reader = ocdbt.Reader(path)
    if template is None:
        return _plain(tree, reader)
    return _restore(template, tree, reader, "")
