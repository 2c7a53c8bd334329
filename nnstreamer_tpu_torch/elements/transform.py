"""tensor_transform — elementwise stream math on the tensors' device.

Port of nnstreamer_tpu/elements/transform.py (reference:
gst/nnstreamer/elements/gsttensortransform.c). Modes dimchg/typecast/
arithmetic/transpose/stand/clamp (ops/transform_ops.py), applied to each
tensor in the frame where it lives: a host tensor moves to the element's
device first (the pipeline's device, else cuda), and device-resident
buffers stay on the device through it. ``acceleration`` is a parity
property with no effect.

Multiple stages can be chained in one element with "mode option" lists via
``transform_chain``, or by linking several tensor_transform elements.
Next to a torch-cuda filter the math runs inside the filter's invoke
instead (ops/fusion.py upstream, ops/epilogue.py downstream): the element
stays for caps negotiation and forwards buffers untouched.
"""

from __future__ import annotations

from typing import Any, List, Optional

import torch

from ..core.buffer import Buffer, TensorMemory
from ..core.hw import resolve_device
from ..core.types import Caps, TensorsConfig, TensorsInfo
from ..graph.element import Element, FlowReturn, Pad, register_element
from ..ops import transform_ops


@register_element
class TensorTransform(Element):
    ELEMENT_NAME = "tensor_transform"

    def __init__(self, name: Optional[str] = None, **props: Any):
        self.mode: Optional[str] = None
        self.option: str = ""
        self.transform_chain: Optional[List] = None  # [(mode, option), ...]
        self.acceleration = True  # parity prop
        super().__init__(name, **props)
        self.add_sink_pad(template=Caps.any_tensors())
        self.add_src_pad(template=Caps.any_tensors())
        self._transform: Optional[transform_ops.Transform] = None
        self._device: Any = None  # the pipeline's device; None → cuda
        self._dev: Optional[torch.device] = None  # resolved at start
        self._out_config: Optional[TensorsConfig] = None
        self._fused = False  # set by ops.fusion: math runs inside the filter
        # set by ops.epilogue: math runs inside the UPSTREAM filter
        self._fused_post = False

    def _build(self) -> transform_ops.Transform:
        if self.transform_chain:
            stages = [transform_ops.build(m, o) for m, o in self.transform_chain]
            return transform_ops.compose(stages)
        if not self.mode:
            raise ValueError("tensor_transform requires mode= (or transform_chain)")
        return transform_ops.build(self.mode, self.option)

    def set_default_device(self, device: Any) -> None:
        self._device = device

    def start(self) -> None:
        self._transform = self._build()
        self._dev = resolve_device(self._device)

    def on_caps(self, pad: Pad, caps: Caps) -> None:
        if caps.media_type != "other/tensors":
            raise ValueError("tensor_transform accepts other/tensors only")
        if self._transform is None:
            self.start()
        cfg = caps.to_config()
        out_infos = tuple(self._transform.out_info(i) for i in cfg.info)
        self._out_config = TensorsConfig(
            TensorsInfo(out_infos, cfg.info.format), cfg.rate)
        pad.caps = caps
        self.send_caps_all(Caps.tensors(self._out_config))

    def chain(self, pad: Pad, buf: Buffer) -> Optional[FlowReturn]:
        if self._fused or self._fused_post:
            # math happens inside the adjacent filter's invoke (ops.fusion
            # upstream / ops.epilogue downstream)
            return self.push(buf.with_memories(buf.memories,
                                               config=self._out_config))
        fn = self._transform.fn
        with torch.inference_mode():
            outs = [TensorMemory(fn(m.device(self._dev))) for m in buf.memories]
        return self.push(buf.with_memories(outs, config=self._out_config))

    def as_torch_fn(self):
        """The composed function, for cross-element fusion (the pipeline
        optimizer runs transform→filter chains inside the filter)."""
        if self._transform is None:
            self._transform = self._build()
        return self._transform.fn
