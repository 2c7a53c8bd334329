"""tensor_merge / tensor_split — tensor concatenation and slicing.

References: gst/nnstreamer/elements/gsttensormerge.c (mode=linear,
option=first..fourth = concat axis in reference dim order,
gsttensormerge.h:45-58, same sync policies as mux) and gsttensorsplit.c
(``tensorseg`` = per-output slice sizes along an axis).

Port of nnstreamer_tpu/elements/merge_split.py: merge concatenates with
``torch.cat`` on the card when any input is a tensor there (host inputs are
copied to it), split slices tensors where they lie.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..core.buffer import Buffer, TensorMemory, concat_arrays
from ..core.types import Caps, TensorInfo, TensorsConfig, TensorsInfo
from ..graph.element import Element, FlowReturn, Pad, register_element
from ..graph.sync import SyncPolicy
from .collect_base import CollectingElement

_AXIS_NAMES = {"first": 0, "second": 1, "third": 2, "fourth": 3}


@register_element
class TensorMerge(CollectingElement):
    """N tensors → one bigger tensor, concatenated along a reference-order
    dim (0=innermost). Device-resident concat via torch.cat when inputs are
    on the device."""

    ELEMENT_NAME = "tensor_merge"

    def __init__(self, name: Optional[str] = None, **props: Any):
        self.mode = "linear"
        self.option: str = "third"
        self.sync_mode: str = "slowest"
        self.sync_option: str = ""
        super().__init__(name, **props)
        self.add_src_pad(template=Caps.any_tensors())
        self._pad_caps: Dict[str, Caps] = {}
        self._caps_sent = False
        self._out_config: Optional[TensorsConfig] = None

    @property
    def _nns_axis(self) -> int:
        if self.option in _AXIS_NAMES:
            return _AXIS_NAMES[self.option]
        return int(self.option)

    def start(self) -> None:
        if self.mode != "linear":
            raise ValueError(f"tensor_merge: unsupported mode {self.mode!r}")
        self._make_collect(SyncPolicy.parse(self.sync_mode))
        self._pad_caps.clear()
        self._caps_sent = False

    def on_caps(self, pad: Pad, caps: Caps) -> None:
        pad.caps = caps
        with self._lock:
            self._pad_caps[pad.name] = caps
            if self._caps_sent or len(self._pad_caps) < len(self.sink_pads):
                return
            self._caps_sent = True
            infos = [self._pad_caps[p.name].to_config().info[0]
                     for p in self.sink_pads]
            ax = self._nns_axis
            base = infos[0]
            out_dims = list(base.dims)
            while len(out_dims) <= ax:
                out_dims.append(1)
            total = 0
            for inf in infos:
                if inf.dtype is not base.dtype:
                    raise ValueError("tensor_merge: dtype mismatch")
                dims = list(inf.dims) + [1] * (len(out_dims) - inf.rank)
                for d in range(len(out_dims)):
                    if d != ax and dims[d] != out_dims[d]:
                        raise ValueError(
                            f"tensor_merge: dim {d} mismatch {dims} vs {out_dims}")
                total += dims[ax]
            out_dims[ax] = total
            rate = self._pad_caps[self.sink_pads[0].name].to_config().rate
            self._out_config = TensorsConfig(
                TensorsInfo.of(TensorInfo(tuple(out_dims), base.dtype)), rate)
            self.send_caps_all(Caps.tensors(self._out_config))

    def _emit(self, sets) -> FlowReturn:
        ret = FlowReturn.OK
        for frame, pts in sets:
            arrays = [m.device() if m.is_device else m.host()
                      for m in (frame[p.name].memories[0] for p in self.sink_pads)]
            np_axis = max(a.ndim for a in arrays) - 1 - self._nns_axis
            out = concat_arrays(arrays, np_axis)
            meta: dict = {}
            for p in self.sink_pads:  # first pad wins on conflicts
                for k, v in frame[p.name].meta.items():
                    meta.setdefault(k, v)
            r = self.push(Buffer([TensorMemory(out)], pts=pts, meta=meta,
                                 config=self._out_config))
            if r is FlowReturn.ERROR:
                ret = r
        return ret


@register_element
class TensorSplit(Element):
    """One tensor → N tensors sliced along a reference dim.

    ``tensorseg`` = comma-separated slice sizes (e.g. "1,2" over axis
    ``option`` default 0=innermost). Reference gsttensorsplit.c semantics.
    """

    ELEMENT_NAME = "tensor_split"

    def __init__(self, name: Optional[str] = None, **props: Any):
        self.tensorseg: Optional[str] = None
        self.option: str = "0"  # nns axis to slice
        super().__init__(name, **props)
        self.add_sink_pad(template=Caps.any_tensors())
        self._sizes: Optional[List[int]] = None
        self._ref_segs = None  # reference dim-spec grammar (flat regions)

    @property
    def _nns_axis(self) -> int:
        return int(self.option)

    def on_caps(self, pad: Pad, caps: Caps) -> None:
        pad.caps = caps
        cfg = caps.to_config()
        info = cfg.info[0]
        if not self.tensorseg:
            raise ValueError("tensor_split requires tensorseg")
        segs = str(self.tensorseg).split(",")
        self._ref_segs = None
        if ":" in segs[0]:
            # reference grammar: each segment is a FULL dims spec
            # ("1:100:100,2:100:100") and the output is a CONTIGUOUS
            # region of the flat raster — offset/size are element counts
            # (gst_tensor_split_get_splited, gsttensorsplit.c:414-445:
            # memcpy from src + sum(prev counts)), NOT a strided slice
            seg_infos = []
            total = 0
            for s in segs:
                dims = [int(d) for d in s.split(":")]
                while len(dims) > 1 and dims[-1] == 1:
                    dims.pop()
                ti = TensorInfo(tuple(dims), info.dtype)
                seg_infos.append(ti)
                total += ti.num_elements
            if total != info.num_elements:
                raise ValueError(
                    f"tensorseg {segs} covers {total} elements, input "
                    f"has {info.num_elements}")
            self._ref_segs = seg_infos
            self._sizes = [t.num_elements for t in seg_infos]
            if len(self.src_pads) != len(seg_infos):
                raise ValueError(
                    f"tensor_split: {len(seg_infos)} segments but "
                    f"{len(self.src_pads)} pads linked")
            for i, ti in enumerate(seg_infos):
                self.send_caps(Caps.tensors(TensorsConfig(
                    TensorsInfo.of(ti), cfg.rate)), i)
            return
        self._sizes = [int(s) for s in segs]
        ax = self._nns_axis
        if sum(self._sizes) != info.dims[ax]:
            raise ValueError(
                f"tensorseg {self._sizes} does not sum to dim {info.dims[ax]}")
        if len(self.src_pads) != len(self._sizes):
            raise ValueError(
                f"tensor_split: {len(self._sizes)} segments but "
                f"{len(self.src_pads)} pads linked")
        for i, s in enumerate(self._sizes):
            dims = list(info.dims)
            dims[ax] = s
            out = TensorsConfig(
                TensorsInfo.of(TensorInfo(tuple(dims), info.dtype)), cfg.rate)
            self.send_caps(Caps.tensors(out), i)

    def chain(self, pad: Pad, buf: Buffer) -> Optional[FlowReturn]:
        m = buf.memories[0]
        arr = m.device() if m.is_device else m.host()
        ret = FlowReturn.OK
        if self._ref_segs is not None:
            # reference semantics: contiguous element ranges of the raster
            # (reshape copies a non-contiguous view, in raster order)
            flat = arr.reshape(-1)
            off = 0
            for i, ti in enumerate(self._ref_segs):
                n = ti.num_elements
                out = flat[off:off + n].reshape(ti.shape)
                off += n
                r = self.push(
                    buf.with_memories([TensorMemory(out, ti)]), i)
                if r is FlowReturn.ERROR:
                    ret = r
            return ret
        np_axis = arr.ndim - 1 - self._nns_axis
        off = 0
        for i, s in enumerate(self._sizes):
            sl = [slice(None)] * arr.ndim
            sl[np_axis] = slice(off, off + s)
            off += s
            r = self.push(buf.with_memories([TensorMemory(arr[tuple(sl)])]), i)
            if r is FlowReturn.ERROR:
                ret = r
        return ret
