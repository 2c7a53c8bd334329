"""Model parameter (de)serialization: flax's ``.msgpack`` bytes and orbax
checkpoint directories.

Port of nnstreamer_tpu/utils/checkpoints.py. The JAX package writes a
parameter tree to a path ending in ``.msgpack`` with
``flax.serialization.to_bytes``, and to any other path as an orbax
``StandardCheckpointer`` directory (``force=True``). Neither flax, msgpack
nor orbax is a dependency of the port: ``.msgpack`` files go through this
module's own codec of the subset flax emits, directories through
utils/orbax_dir.py (its own OCDBT store and zarr arrays; zstd from the
system's ``libzstd.so.1``, which only directories need).

The ``.msgpack`` form:

  * the tree is flax's state dict of the value: dicts keep their insertion
    order with ``str`` keys, a list or tuple becomes ``{"0": ..., "1": ...}``;
  * an array (numpy or ``torch.Tensor``, read from its host bytes) is
    msgpack ext type 1 holding the msgpack array ``(shape, dtype name, raw C
    bytes)``; a numpy scalar is ext type 3 of the same payload. An array
    above ``MAX_CHUNK_SIZE`` bytes becomes flax's chunked form, the map
    ``{"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks":
    {"0": ..., ...}}`` of its flattened pieces of ``MAX_CHUNK_SIZE //
    itemsize`` items each, and is joined again on reading;
  * the rest is plain msgpack: maps, str, bin, int, float (as float64),
    bool, nil and arrays, each in the smallest form msgpack-python picks.

A file written here is byte-identical to flax's for the same tree with the
same key order, and a file flax wrote loads here. ``load_variables``
returns numpy leaves; given a ``template`` it restores the template's
structure as ``flax.serialization.from_state_dict`` does (every key of a
template dict must be in the file, lists and tuples come back from their
``"0"``, ``"1"``, ... maps; leaves are not checked against the template).
A directory restores with orbax's semantics instead (utils/orbax_dir.py):
the template's tree must match the checkpoint's, and each leaf is cast to
the template leaf's dtype or Python type.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

#: msgpack ext type codes of flax.serialization
EXT_NDARRAY, EXT_NPSCALAR = 1, 3
#: flax's MAX_CHUNK_SIZE: larger arrays are written in chunks of this size
MAX_CHUNK_SIZE = 2 ** 30


def save_variables(path: str, variables: Any) -> None:
    """Write ``variables`` (nested dicts, lists and tuples of tensors, numpy
    arrays and Python scalars): a ``.msgpack`` path as flax would, any
    other as an orbax checkpoint directory, replacing what is there."""
    if not str(path).endswith(".msgpack"):
        from . import orbax_dir

        orbax_dir.save(path, variables)
        return
    with open(path, "wb") as f:
        f.write(to_bytes(variables))


def load_variables(path: str, template: Any = None) -> Any:
    """Read a ``.msgpack`` file or an orbax checkpoint directory; restored
    into ``template``'s structure when one is given (see the module
    docstring)."""
    if not str(path).endswith(".msgpack"):
        from . import orbax_dir

        return orbax_dir.load(path, template)
    with open(path, "rb") as f:
        state = from_bytes(f.read())
    return state if template is None else restore(template, state)


# --------------------------------------------------------------------------- #
# state dicts
# --------------------------------------------------------------------------- #

def host_array(x: Any) -> np.ndarray:
    """A tensor's or array's C-contiguous host copy (bfloat16 through its
    bit pattern, under ml_dtypes' dtype as the JAX package has it)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            from ..core.types import TensorDType

            return t.view(torch.int16).numpy().view(TensorDType.BFLOAT16.np_dtype)
        return t.numpy()
    return np.ascontiguousarray(x)


def to_state_dict(x: Any) -> Any:
    """flax's state dict of ``x``: str-keyed dicts in insertion order, lists
    and tuples as index-keyed dicts, tensors as host numpy arrays."""
    if isinstance(x, dict):
        keys = [str(k) for k in x]
        if len(set(keys)) != len(keys):
            raise ValueError(f"dict keys have no unique string form: {list(x)}")
        return {str(k): to_state_dict(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(x)}
    if isinstance(x, torch.Tensor):
        return host_array(x)
    return x


def restore(template: Any, state: Any, path: str = "") -> Any:
    """``state`` in ``template``'s structure (flax ``from_state_dict``)."""
    if isinstance(template, dict):
        if not isinstance(state, dict):
            raise ValueError(f"expected a dict at {path or '/'}, the file holds "
                             f"{type(state).__name__}")
        missing = {str(k) for k in template} - set(state)
        if missing:
            raise ValueError(f"the file lacks keys {sorted(missing)} at "
                             f"{path or '/'}")
        return {k: restore(v, state[str(k)], f"{path}/{k}")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if not isinstance(state, dict) or len(state) != len(template):
            raise ValueError(f"expected {len(template)} items at {path or '/'}")
        items = [restore(v, state[str(i)], f"{path}/{i}")
                 for i, v in enumerate(template)]
        return type(template)(items)
    return state


def _chunk_leaves(state: Any) -> Any:
    """flax's ``_chunk_array_leaves_in_place``: each array above
    ``MAX_CHUNK_SIZE`` bytes as the chunked map of its flat pieces."""
    if isinstance(state, dict):
        return {k: _chunk_leaves(v) for k, v in state.items()}
    if isinstance(state, np.ndarray) and state.nbytes > MAX_CHUNK_SIZE:
        step = max(1, int(MAX_CHUNK_SIZE / state.dtype.itemsize))
        flat = state.reshape(-1)
        return {"__msgpack_chunked_array__": True,
                "shape": {str(i): d for i, d in enumerate(state.shape)},
                "chunks": {str(i): flat[j:j + step] for i, j in
                           enumerate(range(0, flat.size, step))}}
    return state


def _unchunk_leaves(state: Any) -> Any:
    """flax's ``_unchunk_array_leaves_in_place``."""
    if not isinstance(state, dict):
        return state
    if "__msgpack_chunked_array__" in state:
        shape = tuple(state["shape"][str(i)] for i in range(len(state["shape"])))
        chunks = [state["chunks"][str(i)] for i in range(len(state["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk_leaves(v) for k, v in state.items()}


def to_bytes(variables: Any) -> bytes:
    """``flax.serialization.to_bytes`` of ``variables``."""
    out = bytearray()
    _pack(_chunk_leaves(to_state_dict(variables)), out)
    return bytes(out)


def from_bytes(data: bytes) -> Any:
    """``flax.serialization.msgpack_restore``: the state dict in ``data``."""
    reader = _Reader(memoryview(data))
    obj = reader.read()
    if reader.pos != len(data):
        raise ValueError(f"{len(data) - reader.pos} trailing bytes after the "
                         "msgpack object")
    return _unchunk_leaves(obj)


# --------------------------------------------------------------------------- #
# msgpack: the encoder
# --------------------------------------------------------------------------- #

def _pack_len(n: int, out: bytearray, fix: int, fix_max: int,
              codes: Tuple[int, ...], widths: Tuple[str, ...]) -> None:
    if fix >= 0 and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt in zip(codes, widths):
        if n < 1 << (8 * struct.calcsize(fmt)):
            out.append(code)
            out += struct.pack(">" + fmt, n)
            return
    raise ValueError(f"msgpack object too large ({n})")


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v > 0:
        for code, fmt in ((0xCC, "B"), (0xCD, "H"), (0xCE, "I"), (0xCF, "Q")):
            if v < 1 << (8 * struct.calcsize(fmt)):
                out.append(code)
                out += struct.pack(">" + fmt, v)
                return
        raise OverflowError(f"int {v} too large for msgpack")
    else:
        for code, fmt in ((0xD0, "b"), (0xD1, "h"), (0xD2, "i"), (0xD3, "q")):
            bits = 8 * struct.calcsize(fmt)
            if v >= -(1 << (bits - 1)):
                out.append(code)
                out += struct.pack(">" + fmt, v)
                return
        raise OverflowError(f"int {v} too small for msgpack")


def _ndarray_payload(arr: np.ndarray) -> bytes:
    """flax ``_ndarray_to_bytes``: msgpack of (shape, dtype name, bytes)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serializable")
    body = bytearray()
    _pack((list(arr.shape), arr.dtype.name, arr.tobytes("C")), body)
    return bytes(body)


def _pack_ext(code: int, payload: bytes, out: bytearray) -> None:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    elif n < 1 << 8:
        out += bytes((0xC7, n))
    elif n < 1 << 16:
        out.append(0xC8)
        out += struct.pack(">H", n)
    else:
        out.append(0xC9)
        out += struct.pack(">I", n)
    out.append(code)
    out += payload


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int) and not isinstance(obj, np.generic):
        _pack_int(int(obj), out)
    elif isinstance(obj, float) and not isinstance(obj, np.generic):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(len(raw), out, 0xA0, 32, (0xD9, 0xDA, 0xDB), ("B", "H", "I"))
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _pack_len(len(raw), out, -1, 0, (0xC4, 0xC5, 0xC6), ("B", "H", "I"))
        out += raw
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), out, 0x90, 16, (0xDC, 0xDD), ("H", "I"))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), out, 0x80, 16, (0xDE, 0xDF), ("H", "I"))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, np.ndarray):
        _pack_ext(EXT_NDARRAY, _ndarray_payload(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)), out)
    elif isinstance(obj, torch.Tensor):
        _pack_ext(EXT_NDARRAY, _ndarray_payload(host_array(obj)), out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


# --------------------------------------------------------------------------- #
# msgpack: the decoder
# --------------------------------------------------------------------------- #

def _dtype_from_name(name: str) -> np.dtype:
    if name == "bfloat16":
        from ..core.types import TensorDType

        return TensorDType.BFLOAT16.np_dtype
    return np.dtype(name)


def _ndarray_from_payload(payload: bytes) -> np.ndarray:
    shape, name, raw = _Reader(memoryview(payload)).read()
    if isinstance(name, bytes):
        name = name.decode()
    arr = np.frombuffer(bytes(raw), dtype=_dtype_from_name(name))
    return arr.reshape(shape).copy()


class _Reader:
    """One msgpack object at a time from ``buf``."""

    def __init__(self, buf: memoryview) -> None:
        self.buf = buf
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        view = self.buf[self.pos:self.pos + n]
        self.pos += n
        return view

    def _unpack(self, fmt: str) -> Any:
        return struct.unpack(">" + fmt, self._take(struct.calcsize(fmt)))[0]

    def _items(self, n: int) -> List[Any]:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> Dict[Any, Any]:
        out: Dict[Any, Any] = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _ext(self, n: int) -> Any:
        code = self._unpack("b")
        payload = bytes(self._take(n))
        if code == EXT_NDARRAY:
            return _ndarray_from_payload(payload)
        if code == EXT_NPSCALAR:
            return _ndarray_from_payload(payload)[()]
        raise ValueError(f"unknown msgpack ext type {code}")

    def read(self) -> Any:
        b = self._unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._items(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return bytes(self._take(b & 0x1F)).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
                0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q",
                0xCA: "f", 0xCB: "d"}
        if b in ints:
            return self._unpack(ints[b])
        sized = {0xC4: ("B", "bin"), 0xC5: ("H", "bin"), 0xC6: ("I", "bin"),
                 0xD9: ("B", "str"), 0xDA: ("H", "str"), 0xDB: ("I", "str"),
                 0xDC: ("H", "array"), 0xDD: ("I", "array"),
                 0xDE: ("H", "map"), 0xDF: ("I", "map"),
                 0xC7: ("B", "ext"), 0xC8: ("H", "ext"), 0xC9: ("I", "ext")}
        if b in sized:
            fmt, kind = sized[b]
            n = self._unpack(fmt)
            if kind == "bin":
                return bytes(self._take(n))
            if kind == "str":
                return bytes(self._take(n)).decode("utf-8")
            if kind == "array":
                return self._items(n)
            if kind == "map":
                return self._map(n)
            return self._ext(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self._ext(fixext[b])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")
