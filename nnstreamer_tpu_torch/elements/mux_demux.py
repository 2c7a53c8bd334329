"""tensor_mux / tensor_demux — frame composition and decomposition.

References: gst/nnstreamer/elements/gsttensormux.c (CollectPads + time-sync
:120,204-211; sync-mode/sync-option props) and gsttensordemux.c
(``tensorpick`` selection).

mux: N single-tensor (or multi-tensor) streams → one frame carrying all
tensors, synchronized per SyncPolicy. demux: one multi-tensor frame → N src
pads, optionally picking a subset (``tensorpick="0,2"``; entries may also be
grouped "0:1,2" to emit multi-tensor buffers per pad).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..core.buffer import Buffer
from ..core.types import Caps, TensorsConfig, TensorsInfo
from ..graph.element import Element, FlowReturn, Pad, register_element
from ..graph.sync import SyncPolicy
from .collect_base import CollectingElement


@register_element
class TensorMux(CollectingElement):
    ELEMENT_NAME = "tensor_mux"

    def __init__(self, name: Optional[str] = None, **props: Any):
        self.sync_mode: str = "slowest"
        self.sync_option: str = ""
        super().__init__(name, **props)
        self.add_src_pad(template=Caps.any_tensors())
        self._pad_caps: Dict[str, Caps] = {}
        self._caps_sent = False

    def start(self) -> None:
        policy = SyncPolicy.parse(self.sync_mode)
        base_key = None
        base_dur = 0
        if policy is SyncPolicy.BASEPAD and self.sync_option:
            parts = str(self.sync_option).split(":")
            base_key = f"sink_{int(parts[0])}"
            if len(parts) > 1:
                base_dur = int(parts[1])
        self._make_collect(policy, base_key=base_key, base_duration_ns=base_dur)
        self._pad_caps.clear()
        self._caps_sent = False

    def on_caps(self, pad: Pad, caps: Caps) -> None:
        pad.caps = caps
        with self._lock:
            self._pad_caps[pad.name] = caps
            if not self._caps_sent and len(self._pad_caps) == len(self.sink_pads):
                self._caps_sent = True
                infos = []
                rate = None
                for p in self.sink_pads:
                    cfg = self._pad_caps[p.name].to_config()
                    infos.extend(cfg.info.infos)
                    rate = rate or (cfg.rate if cfg.rate > 0 else None)
                out = TensorsConfig(TensorsInfo(tuple(infos)), rate or 0)
                self._out_config = out
                self.send_caps_all(Caps.tensors(out))

    def _emit(self, sets) -> FlowReturn:
        ret = FlowReturn.OK
        for frame, pts in sets:
            mems: List = []
            meta: dict = {}
            offset = None
            for p in self.sink_pads:
                b = frame[p.name]
                mems.extend(b.memories)
                # union constituent metadata, first pad wins on conflicts
                # (e.g. query_client_id must survive a mux in a server
                # pipeline loop, reference serversink pairing semantics)
                for k, v in b.meta.items():
                    meta.setdefault(k, v)
                if offset is None:
                    offset = b.offset
            out = Buffer(mems, pts=pts, offset=offset, meta=meta,
                         config=getattr(self, "_out_config", None))
            r = self.push(out)
            if r is FlowReturn.ERROR:
                ret = r
        return ret


@register_element
class TensorDemux(Element):
    ELEMENT_NAME = "tensor_demux"

    def __init__(self, name: Optional[str] = None, **props: Any):
        self.tensorpick: Optional[str] = None
        super().__init__(name, **props)
        self.add_sink_pad(template=Caps.any_tensors())
        self._groups: Optional[List[List[int]]] = None

    def _parse_pick(self, num_tensors: int) -> List[List[int]]:
        if not self.tensorpick:
            return [[i] for i in range(num_tensors)]
        groups = []
        for part in str(self.tensorpick).split(","):
            part = part.strip()
            idxs = [int(x) for x in part.split(":")] if part else []
            groups.append(idxs)
        return groups

    def on_caps(self, pad: Pad, caps: Caps) -> None:
        pad.caps = caps
        cfg = caps.to_config()
        self._groups = self._parse_pick(cfg.info.num_tensors)
        if len(self.src_pads) != len(self._groups):
            raise ValueError(
                f"tensor_demux: {len(self._groups)} outputs configured but "
                f"{len(self.src_pads)} pads linked")
        for i, grp in enumerate(self._groups):
            infos = tuple(cfg.info[j] for j in grp)
            out = TensorsConfig(TensorsInfo(infos), cfg.rate)
            self.send_caps(Caps.tensors(out), i)

    def chain(self, pad: Pad, buf: Buffer) -> Optional[FlowReturn]:
        ret = FlowReturn.OK
        for i, grp in enumerate(self._groups):
            mems = [buf.memories[j] for j in grp]
            r = self.push(buf.with_memories(mems), i)
            if r is FlowReturn.ERROR:
                ret = r
        return ret
