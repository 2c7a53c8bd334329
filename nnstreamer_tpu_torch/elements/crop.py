"""tensor_crop — crop regions of a raw tensor stream by a coords stream.

Reference: gst/nnstreamer/elements/gsttensor_crop.c (:48-109): two sink pads
``raw`` (data) and ``info`` (crop boxes); output is **flexible**-format
tensors (one per region — region count is dynamic per frame).

info tensor rows: [x, y, w, h] (pixels in the innermost-two spatial dims of
the raw tensor, reference convention x=dim1, y=dim2). Raw frames are assumed
(..., H, W, C) row-major.

Port of nnstreamer_tpu/elements/crop.py. The crop runs on the host, as
there: each region is a contiguous host copy, which the filter's
``custom="bucket=N,resize=H:W"`` resizes and stacks on its device.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from ..core.buffer import Buffer, TensorMemory
from ..core.types import Caps, TensorFormat
from ..graph.element import FlowReturn, Pad, register_element
from ..graph.sync import SyncPolicy
from .collect_base import CollectingElement


@register_element
class TensorCrop(CollectingElement):
    ELEMENT_NAME = "tensor_crop"

    def __init__(self, name: Optional[str] = None, **props: Any):
        self.lateness_ns = 0
        super().__init__(name, **props)
        self.raw_pad = self.add_sink_pad("raw", template=Caps.any_tensors())
        self.info_pad = self.add_sink_pad("info", template=Caps.any_tensors())
        self.add_src_pad(template=Caps("other/tensors",
                                       {"format": TensorFormat.FLEXIBLE}))
        self._caps_sent = False

    def start(self) -> None:
        self._make_collect(SyncPolicy.SLOWEST)
        self._caps_sent = False

    def on_caps(self, pad: Pad, caps: Caps) -> None:
        pad.caps = caps
        with self._lock:
            if not self._caps_sent:
                self._caps_sent = True
                self.send_caps_all(Caps.tensors(format=TensorFormat.FLEXIBLE))

    def _emit(self, sets) -> FlowReturn:
        ret = FlowReturn.OK
        for frame, pts in sets:
            raw = frame["raw"].memories[0].host()
            boxes = frame["info"].memories[0].host().reshape(-1, 4).astype(np.int64)
            img = raw[0] if raw.ndim == 4 else raw  # (H,W,C)
            mems = []
            for x, y, w, h in boxes:
                x0 = int(np.clip(x, 0, img.shape[1]))
                y0 = int(np.clip(y, 0, img.shape[0]))
                x1 = int(np.clip(x + w, x0, img.shape[1]))
                y1 = int(np.clip(y + h, y0, img.shape[0]))
                if x1 <= x0 or y1 <= y0:
                    continue
                mems.append(TensorMemory(np.ascontiguousarray(img[y0:y1, x0:x1])))
            if not mems:
                continue
            r = self.push(Buffer(mems, pts=pts))
            if r is FlowReturn.ERROR:
                ret = r
        return ret
