"""tensor_aggregator — temporal batching / sliding windows.

Reference: gst/nnstreamer/elements/gsttensoraggregator.c (props
frames-in/frames-out/frames-flush/frames-dim, concat :178-234). Collects
``frames_out`` frames along reference dim ``frames_dim``, advancing by
``frames_flush`` (sliding window when flush < out; default flush=out). Each
incoming buffer is treated as ``frames_in`` frames along that dim.

This is the streaming sequence-axis machinery (RNN/LSTM window feeds,
SURVEY §5 long-context note): windows are assembled host-side as views and
concatenated on device so downstream consumers see one contiguous window
tensor.

Port of nnstreamer_tpu/elements/aggregator.py: a window holding any tensor
is concatenated with ``torch.cat`` on that tensor's device.
"""

from __future__ import annotations

import collections
from typing import Any, Deque, Optional

from ..core.buffer import Buffer, TensorMemory, concat_arrays
from ..core.types import Caps, TensorInfo, TensorsConfig, TensorsInfo
from ..graph.element import Element, FlowReturn, Pad, register_element


@register_element
class TensorAggregator(Element):
    ELEMENT_NAME = "tensor_aggregator"

    def __init__(self, name: Optional[str] = None, **props: Any):
        self.frames_in = 1
        self.frames_out = 1
        self.frames_flush = 0  # 0 → = frames_out (no overlap)
        self.frames_dim = 3    # reference default: outermost of rank-4
        self.concat = True
        super().__init__(name, **props)
        self.add_sink_pad(template=Caps.any_tensors())
        self.add_src_pad(template=Caps.any_tensors())
        self._window: Deque = collections.deque()
        self._out_config: Optional[TensorsConfig] = None

    def start(self) -> None:
        if int(self.frames_out) < 1 or int(self.frames_in) < 1:
            raise ValueError(
                f"tensor_aggregator: frames_in/frames_out must be >= 1 "
                f"(got {self.frames_in}/{self.frames_out})")
        if int(self.frames_flush) < 0:
            raise ValueError("tensor_aggregator: frames_flush must be >= 0")
        self._window.clear()

    def on_caps(self, pad: Pad, caps: Caps) -> None:
        pad.caps = caps
        cfg = caps.to_config()
        info = cfg.info[0]
        fin, fout = int(self.frames_in), int(self.frames_out)
        ax = int(self.frames_dim)
        dims = list(info.dims)
        while len(dims) <= ax:
            dims.append(1)
        if self.concat and fout != fin:
            per_frame = dims[ax] // fin
            dims[ax] = per_frame * fout
        self._out_config = TensorsConfig(
            TensorsInfo.of(TensorInfo(tuple(dims), info.dtype)), cfg.rate)
        self.send_caps_all(Caps.tensors(self._out_config))

    def chain(self, pad: Pad, buf: Buffer) -> Optional[FlowReturn]:
        fin, fout = int(self.frames_in), int(self.frames_out)
        flush = int(self.frames_flush) or fout
        m = buf.memories[0]
        arr = m.device() if m.is_device else m.host()
        ax_np = arr.ndim - 1 - int(self.frames_dim) if int(self.frames_dim) < arr.ndim \
            else 0
        # split the incoming buffer into its frames_in single frames
        if fin > 1:
            size = arr.shape[ax_np] // fin
            frames = [_slice_axis(arr, ax_np, i * size, (i + 1) * size)
                      for i in range(fin)]
        else:
            frames = [arr]
        ret = FlowReturn.OK
        for fr in frames:
            self._window.append((fr, buf.pts))
            if len(self._window) >= fout:
                items = [self._window[i][0] for i in range(fout)]
                first_pts = self._window[0][1]
                out = concat_arrays(items, ax_np)
                for _ in range(min(flush, len(self._window))):
                    self._window.popleft()
                ob = Buffer([TensorMemory(out)], pts=first_pts,
                            duration=buf.duration, config=self._out_config)
                r = self.push(ob)
                if r is FlowReturn.ERROR:
                    ret = r
        return ret


def _slice_axis(arr, axis: int, start: int, stop: int):
    sl = [slice(None)] * arr.ndim
    sl[axis] = slice(start, stop)
    return arr[tuple(sl)]
