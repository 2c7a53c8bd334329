"""Single-shot invoke API — run a model without building a pipeline.

Port of nnstreamer_tpu/single.py (reference: gst/nnstreamer/tensor_filter/
tensor_filter_single.c/.h, which backs the ML C-API "SingleShot",
Documentation/component-description.md:108-124).

    single = SingleShot(model="zoo://mobilenet_v2")   # device="cuda"
    logits, = single.invoke(frame)      # numpy arrays or torch tensors in
    single.close()

Outputs are the backend's tensors, resident on ``device`` (``.cpu()`` to
fetch). ``device`` is cuda unless the caller asks for another; without a
card the default raises. ``accelerator=`` takes the filter property's
spelling ("true:gpu", "false", "true:cpu") and resolves as the filter
element resolves it: ``AcceleratorSpec.pick_device``, where an explicit
``device=`` wins over it. ``timeout_s`` is accepted and kept
as ``self.timeout_s``; like the JAX package's, nothing reads it. Each
invoke goes through the filter, so on the card the first call of an
input signature is captured into a CUDA graph and later calls replay it
(core/graphs.py).
"""

from __future__ import annotations

import time
from typing import Any, List, Optional

from .core.buffer import TensorMemory
from .core.hw import AcceleratorSpec
from .core.types import TensorsInfo
from .filters.base import FilterProps, InvokeStats, detect_framework, find_filter


class SingleShot:
    def __init__(self, model: Any = None, framework: str = "auto",
                 custom: str = "", device: Any = None,
                 input_info: Optional[TensorsInfo] = None,
                 output_info: Optional[TensorsInfo] = None,
                 accelerator: str = "", timeout_s: float = 0.0):
        fw_name = framework
        if fw_name in ("auto", "", None):
            fw_name = detect_framework(model)
            if fw_name is None:
                raise ValueError(f"cannot auto-detect framework for {model!r}")
        cls = find_filter(fw_name)
        if cls is None:
            raise ValueError(f"unknown framework {fw_name!r}")
        self.framework = fw_name
        self.fw = cls()
        accel = AcceleratorSpec.parse(accelerator)
        self.device = accel.pick_device(device)
        self.timeout_s = timeout_s
        self.fw.open(FilterProps(
            model=model, custom=custom, accelerator=accel, device=self.device,
            input_info=input_info, output_info=output_info))
        self.stats = InvokeStats()

    # -- metadata ------------------------------------------------------------ #
    @property
    def input_info(self) -> Optional[TensorsInfo]:
        return self.fw.get_model_info()[0]

    @property
    def output_info(self) -> Optional[TensorsInfo]:
        return self.fw.get_model_info()[1]

    def set_input_info(self, info: TensorsInfo) -> TensorsInfo:
        return self.fw.set_input_info(info)

    # -- execution ----------------------------------------------------------- #
    def invoke(self, *arrays: Any) -> List[Any]:
        mems = [a if isinstance(a, TensorMemory) else TensorMemory(a)
                for a in arrays]
        t0 = time.monotonic_ns()
        outs = self.fw.invoke(mems)
        self.stats.record(time.monotonic_ns() - t0)
        return [m.device() if m.is_device else m.host() for m in outs]

    def update_model(self, model: Any) -> None:
        self.fw.reload_model(model)

    @property
    def latency_us(self) -> int:
        return self.stats.latency_us

    def close(self) -> None:
        if self.fw is not None:
            self.fw.close()
            self.fw = None

    def __enter__(self) -> "SingleShot":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
