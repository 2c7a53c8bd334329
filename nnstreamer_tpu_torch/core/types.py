"""Tensor type system — the L1 core of the framework.

Re-designed equivalent of the reference's tensor type system
(``gst/nnstreamer/include/tensor_typedef.h``, ``tensor_common.c``):

* 10 reference dtypes (tensor_typedef.h:153-167) plus TPU-native ``float16``/``bfloat16``
  extensions (the MXU's preferred compute dtype).
* dimension strings in the reference's column-major convention
  ("3:224:224:1" = innermost-first; tensor_typedef.h:72-148), with helpers to
  convert to/from row-major numpy/JAX shapes.
* ``NNS_TENSOR_SIZE_LIMIT = 16`` tensors per frame (tensor_typedef.h:35).
* tensor formats static / flexible / sparse (tensor_typedef.h:192-199).
* ``TensorInfo`` / ``TensorsInfo`` / ``TensorsConfig`` mirroring
  ``GstTensorInfo/GstTensorsInfo/GstTensorsConfig`` (tensor_typedef.h:233-261),
  but as frozen dataclasses validated at construction.
* ``Caps`` — structural stream-type descriptions used for pad negotiation
  (GStreamer caps equivalent, reduced to what tensor pipelines need).

Everything here is pure Python + numpy dtype objects; no JAX import so that
host-only tools can use it without pulling in a device runtime.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field, replace
from enum import Enum
from fractions import Fraction
from typing import Any, Iterable, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

# --------------------------------------------------------------------------- #
# Limits (tensor_typedef.h:34-35)
# --------------------------------------------------------------------------- #

#: Maximum rank of a static tensor dimension string. The reference caps at 4
#: (extended to 16 in flex-meta); we support 8 everywhere which covers every
#: reference pipeline and typical ML shapes.
RANK_LIMIT = 8

#: Maximum number of tensors in one frame/buffer (tensor_typedef.h:35).
TENSOR_COUNT_LIMIT = 16


# --------------------------------------------------------------------------- #
# Dtypes (tensor_typedef.h:153-167)
# --------------------------------------------------------------------------- #

class TensorDType(Enum):
    """Element types. Values are the canonical wire/display names."""

    INT32 = "int32"
    UINT32 = "uint32"
    INT16 = "int16"
    UINT16 = "uint16"
    INT8 = "int8"
    UINT8 = "uint8"
    FLOAT64 = "float64"
    FLOAT32 = "float32"
    INT64 = "int64"
    UINT64 = "uint64"
    # TPU-native extensions (not in the reference's 10; MXU-preferred)
    FLOAT16 = "float16"
    BFLOAT16 = "bfloat16"

    def __str__(self) -> str:  # "uint8" in caps strings and props
        return self.value

    @property
    def np_dtype(self) -> np.dtype:
        if self is TensorDType.BFLOAT16:
            import ml_dtypes  # ships with jax

            return np.dtype(ml_dtypes.bfloat16)
        return np.dtype(self.value)

    @property
    def itemsize(self) -> int:
        if self is TensorDType.BFLOAT16:
            return 2
        return self.np_dtype.itemsize

    @property
    def is_float(self) -> bool:
        return self in (
            TensorDType.FLOAT64,
            TensorDType.FLOAT32,
            TensorDType.FLOAT16,
            TensorDType.BFLOAT16,
        )

    @property
    def is_integer(self) -> bool:
        return not self.is_float

    @classmethod
    def parse(cls, name: Union[str, "TensorDType", np.dtype, type]) -> "TensorDType":
        """Parse a dtype from string / numpy dtype / python type."""
        if isinstance(name, TensorDType):
            return name
        if isinstance(name, np.dtype) or isinstance(name, type):
            s = np.dtype(name).name
        else:
            s = str(name).strip().lower()
        try:
            return _DTYPE_BY_NAME[s]
        except KeyError:
            raise ValueError(f"unknown tensor dtype: {name!r}") from None


_DTYPE_BY_NAME = {d.value: d for d in TensorDType}
# aliases
_DTYPE_BY_NAME.update({"float": "float32", "double": "float64"})
_DTYPE_BY_NAME = {
    k: (v if isinstance(v, TensorDType) else _DTYPE_BY_NAME[v])
    for k, v in _DTYPE_BY_NAME.items()
}


# --------------------------------------------------------------------------- #
# Formats (tensor_typedef.h:192-199)
# --------------------------------------------------------------------------- #

class TensorFormat(Enum):
    STATIC = "static"
    FLEXIBLE = "flexible"
    SPARSE = "sparse"

    def __str__(self) -> str:
        return self.value

    @classmethod
    def parse(cls, name: Union[str, "TensorFormat"]) -> "TensorFormat":
        if isinstance(name, TensorFormat):
            return name
        try:
            return cls(str(name).strip().lower())
        except ValueError:
            raise ValueError(f"unknown tensor format: {name!r}") from None


# --------------------------------------------------------------------------- #
# Dimensions — reference column-major convention
# --------------------------------------------------------------------------- #

def parse_dimension(dim_str: str) -> Tuple[int, ...]:
    """Parse "3:224:224:1" (innermost-first, tensor_typedef.h:72-148).

    Trailing 1s are preserved as given; empty/0 entries are invalid.
    """
    s = str(dim_str).strip()
    if not s:
        raise ValueError("empty dimension string")
    parts = s.split(":")
    if len(parts) > RANK_LIMIT:
        raise ValueError(f"rank {len(parts)} exceeds limit {RANK_LIMIT}: {dim_str!r}")
    dims = []
    for p in parts:
        p = p.strip()
        if not p:
            raise ValueError(f"bad dimension string: {dim_str!r}")
        v = int(p)
        if v <= 0:
            raise ValueError(f"dimension entries must be positive: {dim_str!r}")
        dims.append(v)
    return tuple(dims)


def dimension_string(dims: Sequence[int]) -> str:
    return ":".join(str(int(d)) for d in dims)


def dims_to_shape(dims: Sequence[int]) -> Tuple[int, ...]:
    """Reference column-major dims → row-major numpy/JAX shape (reverse order)."""
    return tuple(reversed([int(d) for d in dims]))


def shape_to_dims(shape: Sequence[int]) -> Tuple[int, ...]:
    """Row-major numpy/JAX shape → reference column-major dims."""
    return tuple(reversed([int(d) for d in shape]))


def _squeeze_trailing(dims: Tuple[int, ...]) -> Tuple[int, ...]:
    """Drop trailing 1s (outermost axes) for equivalence compare; keep >=1 dim."""
    out = list(dims)
    while len(out) > 1 and out[-1] == 1:
        out.pop()
    return tuple(out)


# --------------------------------------------------------------------------- #
# TensorInfo / TensorsInfo  (GstTensorInfo/GstTensorsInfo tensor_typedef.h:233-250)
# --------------------------------------------------------------------------- #

@dataclass(frozen=True)
class TensorInfo:
    """Type + shape of one tensor. ``dims`` use the reference's innermost-first
    ordering; use ``.shape`` for the numpy/JAX row-major view."""

    dims: Tuple[int, ...]
    dtype: TensorDType = TensorDType.FLOAT32
    name: Optional[str] = None

    def __post_init__(self):
        object.__setattr__(self, "dims", tuple(int(d) for d in self.dims))
        if len(self.dims) == 0 or len(self.dims) > RANK_LIMIT:
            raise ValueError(f"invalid rank {len(self.dims)} (limit {RANK_LIMIT})")
        if any(d <= 0 for d in self.dims):
            raise ValueError(f"dims must be positive: {self.dims}")
        object.__setattr__(self, "dtype", TensorDType.parse(self.dtype))

    # -- constructors ------------------------------------------------------- #
    @classmethod
    def from_strings(cls, dim_str: str, type_str: str, name: Optional[str] = None) -> "TensorInfo":
        return cls(parse_dimension(dim_str), TensorDType.parse(type_str), name)

    @classmethod
    def from_shape(cls, shape: Sequence[int], dtype: Any = TensorDType.FLOAT32,
                   name: Optional[str] = None) -> "TensorInfo":
        return cls(shape_to_dims(shape), TensorDType.parse(dtype), name)

    @classmethod
    def from_array(cls, arr: Any, name: Optional[str] = None) -> "TensorInfo":
        return cls.from_shape(arr.shape if arr.ndim else (1,), np.dtype(str(arr.dtype)), name)

    # -- views -------------------------------------------------------------- #
    @property
    def shape(self) -> Tuple[int, ...]:
        return dims_to_shape(self.dims)

    @property
    def rank(self) -> int:
        return len(self.dims)

    @property
    def num_elements(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    @property
    def size_bytes(self) -> int:
        """Byte size (gst_tensor_info_get_size equivalent)."""
        return self.num_elements * self.dtype.itemsize

    @property
    def dim_string(self) -> str:
        return dimension_string(self.dims)

    def is_compatible(self, other: "TensorInfo") -> bool:
        """Same dtype and same dims modulo trailing 1s (reference's
        gst_tensor_info_is_equal semantics)."""
        return (
            self.dtype is other.dtype
            and _squeeze_trailing(self.dims) == _squeeze_trailing(other.dims)
        )

    def __str__(self) -> str:
        n = f" name={self.name}" if self.name else ""
        return f"TensorInfo({self.dim_string}, {self.dtype}{n})"


@dataclass(frozen=True)
class TensorsInfo:
    """Metadata of 1..16 tensors in a frame (GstTensorsInfo)."""

    infos: Tuple[TensorInfo, ...]
    format: TensorFormat = TensorFormat.STATIC

    def __post_init__(self):
        infos = tuple(self.infos)
        if self.format is TensorFormat.STATIC:
            if not (1 <= len(infos) <= TENSOR_COUNT_LIMIT):
                raise ValueError(
                    f"static frames hold 1..{TENSOR_COUNT_LIMIT} tensors, got {len(infos)}"
                )
        object.__setattr__(self, "infos", infos)
        object.__setattr__(self, "format", TensorFormat.parse(self.format))

    @classmethod
    def from_strings(
        cls,
        dims: str,
        types: str,
        names: Optional[str] = None,
        format: Union[str, TensorFormat] = TensorFormat.STATIC,
    ) -> "TensorsInfo":
        """Parse comma-separated multi-tensor strings, e.g.
        dims="3:224:224:1,1001:1", types="uint8,float32"."""
        dim_parts = [p for p in str(dims).split(",") if p.strip()]
        type_parts = [p for p in str(types).split(",") if p.strip()]
        if len(type_parts) == 1 and len(dim_parts) > 1:
            type_parts = type_parts * len(dim_parts)
        if len(dim_parts) != len(type_parts):
            raise ValueError(f"dims/types count mismatch: {dims!r} vs {types!r}")
        name_parts: Sequence[Optional[str]]
        if names:
            name_parts = [p.strip() or None for p in str(names).split(",")]
            if len(name_parts) != len(dim_parts):
                raise ValueError("names count mismatch")
        else:
            name_parts = [None] * len(dim_parts)
        return cls(
            tuple(
                TensorInfo.from_strings(d, t, n)
                for d, t, n in zip(dim_parts, type_parts, name_parts)
            ),
            TensorFormat.parse(format),
        )

    @classmethod
    def of(cls, *infos: TensorInfo, format: Union[str, TensorFormat] = TensorFormat.STATIC) -> "TensorsInfo":
        return cls(tuple(infos), TensorFormat.parse(format))

    @property
    def num_tensors(self) -> int:
        return len(self.infos)

    @property
    def total_size_bytes(self) -> int:
        return sum(i.size_bytes for i in self.infos)

    @property
    def dim_string(self) -> str:
        return ",".join(i.dim_string for i in self.infos)

    @property
    def type_string(self) -> str:
        return ",".join(str(i.dtype) for i in self.infos)

    def __iter__(self):
        return iter(self.infos)

    def __len__(self) -> int:
        return len(self.infos)

    def __getitem__(self, i: int) -> TensorInfo:
        return self.infos[i]

    def is_compatible(self, other: "TensorsInfo") -> bool:
        if self.format is not other.format:
            return False
        if self.format is not TensorFormat.STATIC:
            return True  # flexible/sparse negotiate per-buffer via meta
        return len(self.infos) == len(other.infos) and all(
            a.is_compatible(b) for a, b in zip(self.infos, other.infos)
        )

    def __str__(self) -> str:
        return f"TensorsInfo[{self.format}]({', '.join(map(str, self.infos))})"


# --------------------------------------------------------------------------- #
# TensorsConfig (GstTensorsConfig tensor_typedef.h:252-261): info + rate
# --------------------------------------------------------------------------- #

@dataclass(frozen=True)
class TensorsConfig:
    """Stream configuration: tensor metadata + frame rate."""

    info: TensorsInfo
    rate: Fraction = Fraction(0, 1)  # 0/1 = unknown/variable

    def __post_init__(self):
        if not isinstance(self.rate, Fraction):
            object.__setattr__(self, "rate", _parse_rate(self.rate))

    @property
    def rate_n(self) -> int:
        return self.rate.numerator

    @property
    def rate_d(self) -> int:
        return self.rate.denominator

    @property
    def frame_duration_ns(self) -> Optional[int]:
        if self.rate.numerator <= 0:
            return None
        return int(1_000_000_000 * self.rate.denominator / self.rate.numerator)

    def is_compatible(self, other: "TensorsConfig") -> bool:
        return self.info.is_compatible(other.info)

    def with_rate(self, rate: Any) -> "TensorsConfig":
        return replace(self, rate=_parse_rate(rate))


def _parse_rate(rate: Any) -> Fraction:
    if isinstance(rate, Fraction):
        return rate
    if isinstance(rate, (tuple, list)) and len(rate) == 2:
        n, d = int(rate[0]), int(rate[1])
        return Fraction(n, d) if n > 0 and d > 0 else Fraction(0, 1)
    if isinstance(rate, str) and "/" in rate:
        n, d = rate.split("/")
        return _parse_rate((int(n), int(d)))
    r = Fraction(rate)
    return r if r > 0 else Fraction(0, 1)


# --------------------------------------------------------------------------- #
# Caps — negotiation descriptors (GStreamer caps equivalent)
# --------------------------------------------------------------------------- #

ANY = object()  # wildcard field value


@dataclass(frozen=True)
class Caps:
    """A structural stream-type description used in pad negotiation.

    ``media_type`` examples (mirroring the reference's caps strings,
    tensor_typedef.h:72-148):
      * ``other/tensors``   — tensor streams (fields: format, num, dims, types,
        framerate)
      * ``video/x-raw``     — fields: format(RGB/BGR/RGBx/BGRx/GRAY8), width,
        height, framerate
      * ``audio/x-raw``     — fields: format(S8/S16LE/F32LE/...), channels, rate
      * ``text/x-raw``      — field: format=utf8
      * ``application/octet-stream``
    A field value may be ``ANY`` meaning unconstrained; intersection fixes it.
    """

    media_type: str
    fields: Mapping[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "fields", dict(self.fields))

    # -- convenience constructors ------------------------------------------ #
    @classmethod
    def tensors(cls, config: Optional[TensorsConfig] = None,
                format: Union[str, TensorFormat, None] = None) -> "Caps":
        f: dict = {}
        if config is not None:
            f["format"] = config.info.format
            if config.info.format is TensorFormat.STATIC:
                f["num"] = config.info.num_tensors
                f["dims"] = config.info.dim_string
                f["types"] = config.info.type_string
            f["framerate"] = config.rate
        elif format is not None:
            f["format"] = TensorFormat.parse(format)
        return cls("other/tensors", f)

    @classmethod
    def any_tensors(cls) -> "Caps":
        return cls("other/tensors")

    def get(self, key: str, default: Any = None) -> Any:
        v = self.fields.get(key, default)
        return default if v is ANY else v

    @property
    def is_fixed(self) -> bool:
        return all(v is not ANY for v in self.fields.values())

    def intersect(self, other: "Caps") -> Optional["Caps"]:
        """Structural intersection; None if disjoint."""
        if self.media_type != other.media_type:
            return None
        merged: dict = dict(self.fields)
        for k, v in other.fields.items():
            if k not in merged or merged[k] is ANY:
                merged[k] = v
            elif v is ANY:
                pass
            elif merged[k] != v:
                return None
        return Caps(self.media_type, merged)

    def with_fields(self, **kw: Any) -> "Caps":
        f = dict(self.fields)
        f.update(kw)
        return Caps(self.media_type, f)

    def to_config(self) -> TensorsConfig:
        """Build a TensorsConfig from fixed other/tensors caps."""
        if self.media_type != "other/tensors":
            raise ValueError(f"not tensor caps: {self.media_type}")
        fmt = TensorFormat.parse(self.get("format", TensorFormat.STATIC))
        if fmt is TensorFormat.STATIC:
            dims = self.get("dims")
            types = self.get("types")
            if dims is None or types is None:
                raise ValueError("static tensor caps missing dims/types")
            info = TensorsInfo.from_strings(dims, types, format=fmt)
        else:
            info = TensorsInfo((), fmt)
        rate = self.get("framerate", Fraction(0, 1))
        return TensorsConfig(info, _parse_rate(rate))

    def __str__(self) -> str:
        fs = ",".join(
            f"{k}={'ANY' if v is ANY else v}" for k, v in sorted(self.fields.items(), key=lambda kv: kv[0])
        )
        return f"{self.media_type}({fs})" if fs else self.media_type


def config_to_caps(config: TensorsConfig) -> Caps:
    return Caps.tensors(config)


# --------------------------------------------------------------------------- #
# Video/audio helpers used by converter/decoder (tensor_converter.c:1385-1634)
# --------------------------------------------------------------------------- #

#: video format → (channels, numpy dtype)
VIDEO_FORMATS = {
    "RGB": (3, np.uint8),
    "BGR": (3, np.uint8),
    "RGBx": (4, np.uint8),
    "BGRx": (4, np.uint8),
    "xRGB": (4, np.uint8),
    "xBGR": (4, np.uint8),
    "RGBA": (4, np.uint8),
    "BGRA": (4, np.uint8),
    "GRAY8": (1, np.uint8),
    "GRAY16_LE": (1, np.uint16),
}

#: audio format → numpy dtype
AUDIO_FORMATS = {
    "S8": np.int8,
    "U8": np.uint8,
    "S16LE": np.int16,
    "U16LE": np.uint16,
    "S32LE": np.int32,
    "U32LE": np.uint32,
    "F32LE": np.float32,
    "F64LE": np.float64,
}
