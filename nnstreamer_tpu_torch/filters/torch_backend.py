"""framework=torch — TorchScript/nn.Module execution on the filter's device.

Port of nnstreamer_tpu/filters/torch_backend.py (reference equivalent:
tensor_filter_pytorch.cc, libtorch script modules), registered as ``torch``
with the alias ``pytorch``, so the reference's pipeline strings run
unchanged. The model runs on the filter's device (cuda unless the pipeline
or the element asks for the CPU):

  * a path opens as the legacy (torch-1.0 era) zip (models/torch_legacy.py,
    its tensors loaded onto the device), or else with ``torch.jit.load(...,
    map_location=<device>)``; an ``nn.Module`` is moved to the device;
  * ``set_input_info`` runs one forward on zeros on the device to learn
    the outputs;
  * ``invoke`` hands the model the input tensors on the device and wraps
    its outputs as they come, on the device (no host copy a frame); the
    declared-output checks read each output's element count and dtype from
    the tensor's metadata, which needs no sync.

Eager, as in the JAX package: a TorchScript forward is not captured.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.buffer import TensorMemory
from ..core.types import TensorInfo, TensorsInfo
from .base import FilterFramework, FilterProps, register_filter


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


@register_filter
class TorchFilter(FilterFramework):
    NAME = "torch"
    ALIASES = ("pytorch",)
    #: torch convnets consume channel-first data natively, so declaring
    #: inputlayout/outputlayout=NCHW is a correct no-op (the data already
    #: matches the model) — accept it rather than reject at open
    SUPPORTS_LAYOUT = True
    ALLOCATE_IN_INVOKE = True

    def __init__(self) -> None:
        super().__init__()
        self._module: Any = None
        self._device: Optional[torch.device] = None
        self._in_info: Optional[TensorsInfo] = None
        self._out_info: Optional[TensorsInfo] = None
        #: (element count, dtype name, torch dtype) of each declared output
        self._out_expect: Optional[List[Tuple[int, str, torch.dtype]]] = None

    def open(self, props: FilterProps) -> None:
        super().open(props)
        self._device = props.device if props.device is not None \
            else props.accelerator.pick_device()
        model = props.model
        if isinstance(model, str):
            if not os.path.isfile(model):
                raise FileNotFoundError(model)
            from ..models.torch_legacy import (is_legacy_torchscript,
                                               load_legacy_torchscript)

            if is_legacy_torchscript(model):
                # torch-1.0-era zip (model.json + arena code) that modern
                # torch.jit.load rejects; executed as code, same trust
                # model as torch.jit.load itself
                self._module = load_legacy_torchscript(model, self._device)
            else:
                try:
                    self._module = torch.jit.load(model,
                                                  map_location=self._device)
                except RuntimeError as e:
                    raise RuntimeError(
                        f"torch: failed to load {model!r} as TorchScript "
                        f"(not a legacy-format zip either): {e}") from e
        elif isinstance(model, torch.nn.Module):
            self._module = model.to(self._device)
        else:
            raise ValueError(f"torch: unsupported model {model!r}")
        self._module.eval()
        self._in_info = props.input_info
        self._out_info = props.output_info
        self._refresh_out_expect()

    def close(self) -> None:
        self._module = None
        super().close()

    def _refresh_out_expect(self) -> None:
        if self._out_info is None:
            self._out_expect = None
        else:
            self._out_expect = [
                (int(np.prod(i.shape)), i.dtype.np_dtype.name,
                 getattr(torch, str(i.dtype)))
                for i in self._out_info]

    def get_model_info(self) -> Tuple[Optional[TensorsInfo], Optional[TensorsInfo]]:
        return self._in_info, self._out_info

    def set_input_info(self, in_info: TensorsInfo) -> TensorsInfo:
        self._in_info = in_info
        with torch.no_grad():
            dummies = [torch.zeros(*i.shape, dtype=getattr(torch, str(i.dtype)),
                                   device=self._device)
                       for i in in_info]
            out = self._module(*dummies)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        actual = TensorsInfo(tuple(
            TensorInfo.from_shape(tuple(o.shape) or (1,), _dtype_name(o.dtype))
            for o in outs))
        if self._out_info is not None:
            # declared output props must agree with what the module produces
            # (reference rejects mismatched output= at negotiation,
            # tensor_filter_pytorch.cc getOutputDim/validation)
            for i, (a, d) in enumerate(zip(actual, self._out_info)):
                if (int(np.prod(a.shape)) != int(np.prod(d.shape))
                        or a.dtype.np_dtype != d.dtype.np_dtype):
                    raise RuntimeError(
                        f"torch: declared output {i} {d.shape} {d.dtype.name} "
                        f"!= model output {a.shape} {a.dtype.name}")
            if len(actual) != len(self._out_info):
                raise RuntimeError(
                    f"torch: model produces {len(actual)} outputs, "
                    f"props declare {len(self._out_info)}")
        else:
            self._out_info = actual
        self._refresh_out_expect()
        return self._out_info

    def invoke(self, inputs: Sequence[TensorMemory]) -> Sequence[TensorMemory]:
        with torch.no_grad():
            tensors = [m.device(self._device) for m in inputs]
            out = self._module(*tensors)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        if self._out_expect is not None:
            # reference pytorch filter rejects an invoke whose produced
            # tensors disagree with the declared output properties
            # (tensor_filter_pytorch.cc processIFs/validation path)
            if len(outs) != len(self._out_expect):
                raise RuntimeError(
                    f"torch: model produced {len(outs)} tensors, "
                    f"props declare {len(self._out_expect)}")
            for i, (o, (count, name, dt)) in enumerate(zip(outs, self._out_expect)):
                if o.numel() != count or o.dtype != dt:
                    raise RuntimeError(
                        f"torch: output {i} is {tuple(o.shape)} "
                        f"{_dtype_name(o.dtype)}, props declare {count} "
                        f"elements of {name}")
        return [TensorMemory(o) for o in outs]
