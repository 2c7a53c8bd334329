"""Stream buffers: N tensor memories + timestamps.

Equivalent of GstBuffer carrying N GstMemory chunks of tensors
(``GstTensorMemory`` tensor_typedef.h:223-227): a tensor memory may be
**host** (numpy) or **device** (a ``torch.Tensor``, on the CUDA card in a
real run). Device residency is preserved as buffers flow element-to-element
so a converter→filter→decoder chain does exactly one H2D copy (the
reference pays a CPU<->accelerator copy per filter; cf. tensorrt.cc:212,390
cudaMallocManaged). Conversion happens lazily via ``.host()`` /
``.device()``.

Timestamps are nanoseconds (GStreamer clock-time convention).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .types import TensorDType, TensorFormat, TensorInfo, TensorsConfig, TensorsInfo

NS_PER_SEC = 1_000_000_000
CLOCK_NONE: Optional[int] = None


def _info_of_tensor(t: torch.Tensor) -> TensorInfo:
    shape = tuple(t.shape) if t.dim() else (1,)
    return TensorInfo.from_shape(shape, str(t.dtype).removeprefix("torch."))


def _tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """CPU tensor → numpy (bfloat16 through its bit pattern, as numpy has
    no native bfloat16)."""
    if t.dtype == torch.bfloat16:
        bits = t.contiguous().view(torch.int16).numpy()
        return bits.view(TensorDType.BFLOAT16.np_dtype)
    return t.numpy()


class TensorMemory:
    """One tensor's storage; host numpy array and/or device torch.Tensor.

    Exactly one of the two is authoritative at creation; the other view is
    materialized lazily and cached. Mutation is not supported — streaming
    buffers are value-semantic (matches GstBuffer writability rules without
    the refcount dance).
    """

    __slots__ = ("_host", "_device", "_pinned", "_event", "info")

    def __init__(self, array: Any, info: Optional[TensorInfo] = None):
        self._pinned: Optional[torch.Tensor] = None
        self._event: Any = None
        if isinstance(array, torch.Tensor):
            self._device: Optional[torch.Tensor] = array
            self._host: Optional[np.ndarray] = None
            if info is None:
                info = _info_of_tensor(array)
        else:
            arr = np.asarray(array)
            self._host = arr
            self._device = None
            if info is None:
                shape = arr.shape if arr.ndim else (1,)
                info = TensorInfo.from_shape(shape, arr.dtype)
        self.info = info

    # -- views -------------------------------------------------------------- #
    def host(self) -> np.ndarray:
        """Host numpy view (D2H copy on first access for device tensors)."""
        if self._host is None:
            if self._event is not None:
                self._event.synchronize()
                self._host = _tensor_to_numpy(self._pinned)
            else:
                self._host = _tensor_to_numpy(self._device.detach().cpu())
        return self._host

    def prefetch(self) -> None:
        """Start an async D2H copy into pinned memory so a later
        ``host()`` only waits for the copy's event.

        Issuing the copy at dispatch time and materializing a few frames
        later keeps transfers in flight behind the compute (see
        tensor_decoder ``async_depth``). No-op for host tensors, tensors
        already on the CPU, or if already issued.
        """
        t = self._device
        if self._host is not None or t is None or self._event is not None \
                or t.device.type != "cuda":
            return
        pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        pinned.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(t.device))
        self._pinned, self._event = pinned, event

    @property
    def prefetched(self) -> bool:
        return self._event is not None

    def is_ready(self) -> bool:
        """Non-blocking: True when ``host()`` is expected not to block.
        Exact for host tensors and prefetched device tensors (the copy's
        event is queried); a device tensor with no copy issued reports
        ready, and ``host()`` then pays the synchronous copy."""
        if self._host is not None or self._event is None:
            return True
        return bool(self._event.query())

    def device(self, device: Any = None) -> torch.Tensor:
        """The tensor on ``device`` (H2D copy on first access for host
        tensors; None keeps a resident tensor where it is, and places a
        host tensor on the CPU)."""
        if self._device is None:
            arr = self._host if self._host.flags.writeable else self._host.copy()
            if arr.dtype.name == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            self._device = t if device is None else t.to(device)
        t = self._device
        if device is not None and t.device != torch.device(device):
            return t.to(device)
        return t

    @property
    def is_device(self) -> bool:
        return self._device is not None

    @property
    def nbytes(self) -> int:
        return self.info.size_bytes

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.info.shape

    @property
    def dtype(self) -> TensorDType:
        return self.info.dtype

    def tobytes(self) -> bytes:
        return np.ascontiguousarray(self.host()).tobytes()

    @classmethod
    def from_bytes(cls, data: bytes, info: TensorInfo) -> "TensorMemory":
        arr = np.frombuffer(bytearray(data), dtype=info.dtype.np_dtype).reshape(info.shape)
        return cls(arr, info)

    def __repr__(self) -> str:
        loc = f"device:{self._device.device}" if self.is_device else "host"
        return f"TensorMemory({self.info.dim_string}:{self.info.dtype}@{loc})"


@dataclass
class Buffer:
    """A frame flowing through the pipeline: up to 16 tensor memories with
    PTS/DTS/duration in ns. ``config`` snapshots negotiated stream config."""

    memories: List[TensorMemory]
    pts: Optional[int] = None
    dts: Optional[int] = None
    duration: Optional[int] = None
    offset: Optional[int] = None  # frame counter
    config: Optional[TensorsConfig] = None
    meta: dict = field(default_factory=dict)  # extensible per-buffer metadata

    # -- construction ------------------------------------------------------- #
    @classmethod
    def from_arrays(cls, arrays: Sequence[Any], pts: Optional[int] = None,
                    duration: Optional[int] = None, **kw: Any) -> "Buffer":
        return cls([a if isinstance(a, TensorMemory) else TensorMemory(a) for a in arrays],
                   pts=pts, duration=duration, **kw)

    @classmethod
    def of(cls, *arrays: Any, **kw: Any) -> "Buffer":
        return cls.from_arrays(arrays, **kw)

    # -- access ------------------------------------------------------------- #
    @property
    def num_tensors(self) -> int:
        return len(self.memories)

    def __len__(self) -> int:
        return len(self.memories)

    def __getitem__(self, i: int) -> TensorMemory:
        return self.memories[i]

    def arrays_host(self) -> List[np.ndarray]:
        return [m.host() for m in self.memories]

    def arrays_device(self, device: Any = None) -> List[torch.Tensor]:
        return [m.device(device) for m in self.memories]

    @property
    def tensors_info(self) -> TensorsInfo:
        if self.config is not None and self.config.info.format is TensorFormat.STATIC \
                and len(self.config.info) == len(self.memories):
            return self.config.info
        return TensorsInfo(tuple(m.info for m in self.memories)) if self.memories else \
            TensorsInfo((), TensorFormat.FLEXIBLE)

    def with_memories(self, memories: Sequence[TensorMemory],
                      config: Optional[TensorsConfig] = None) -> "Buffer":
        """New buffer with same timestamps but different payload."""
        return Buffer(list(memories), pts=self.pts, dts=self.dts,
                      duration=self.duration, offset=self.offset,
                      config=config, meta=dict(self.meta))

    def copy_meta_from(self, other: "Buffer") -> "Buffer":
        self.pts, self.dts = other.pts, other.dts
        self.duration, self.offset = other.duration, other.offset
        self.meta.update(other.meta)
        return self

    def __repr__(self) -> str:
        t = "none" if self.pts is None else f"{self.pts/1e9:.6f}s"
        return f"Buffer(pts={t}, {self.memories!r})"


def concat_arrays(arrays: Sequence[Any], axis: int) -> Any:
    """Concatenate host arrays and tensors along ``axis``: ``np.concatenate``
    when all are host arrays, else ``torch.cat`` on the device of the first
    tensor, host arrays copied there (the JAX package's switch to
    ``jnp.concatenate`` when any input is on the device)."""
    dev = next((a.device for a in arrays if isinstance(a, torch.Tensor)), None)
    if dev is None:
        return np.concatenate(arrays, axis=axis)
    return torch.cat([a.to(dev) if isinstance(a, torch.Tensor)
                      else TensorMemory(a).device(dev) for a in arrays], dim=axis)


def now_ns() -> int:
    return time.monotonic_ns()
