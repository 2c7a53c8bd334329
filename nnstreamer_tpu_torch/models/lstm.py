"""Streaming LSTM cell — the tensor_repo loop workload (BASELINE config 5).

Port of nnstreamer_tpu/models/lstm.py. Reference analog:
tests/nnstreamer_example/custom_example_LSTM (a C LSTM cell custom filter
driven through a tensor_repo cycle). A multi-input/multi-output ModelBundle
``(x, h, c) -> (y, h', c')`` with ``y = h'``, so the repo-loop pipeline
carries recurrent state as ordinary stream tensors.

``LSTMCell`` is flax's ``nn.LSTMCell`` in torch, in its parameter layout
(``models.convert`` carries a flax cell's params across): input kernels
``ii/if/ig/io`` (in, F) without bias, recurrent kernels ``hi/hf/hg/ho``
(F, F) with bias; each gate is ``act(x @ W_i* + (h @ W_h* + b_h*))``, the
eight products kept separate in flax's order; ``c' = f·c + i·g``,
``h' = o·tanh(c')``. Float32 products run at full precision (TF32 off), as
the JAX package's float32 dots do.
"""

from __future__ import annotations

import functools
from typing import Any, List, Tuple

import torch
from torch import nn

from ..core.types import TensorsInfo
from .causal_lm import _full_f32
from .mobilenet_v2 import build_seeded
from .zoo import ModelBundle, register_model

#: flax's gate names, in its order: input, forget, cell, output
GATES = ("i", "f", "g", "o")


class LSTMCell(nn.Module):
    def __init__(self, input_size: int, features: int):
        super().__init__()
        for g in GATES:
            # "if" is a Python keyword: the children are reached by name
            self.add_module(f"i{g}", nn.Linear(input_size, features, bias=False))
            self.add_module(f"h{g}", nn.Linear(features, features))

    def flax_children(self) -> List[Tuple[str, nn.Module]]:
        return [(n, self._modules[n]) for n in sorted(self._modules)]

    def forward(self, x: torch.Tensor, h: torch.Tensor,
                c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        def pre(g: str) -> torch.Tensor:
            return self._modules[f"i{g}"](x) + self._modules[f"h{g}"](h)

        i = torch.sigmoid(pre("i"))
        f = torch.sigmoid(pre("f"))
        g = torch.tanh(pre("g"))
        o = torch.sigmoid(pre("o"))
        new_c = f * c + i * g
        new_h = o * torch.tanh(new_c)
        return new_h, new_h, new_c


def _forward(cell: LSTMCell, x: torch.Tensor, h: torch.Tensor,
             c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    with _full_f32():
        return cell(x, h, c)


def cell_bundle(cell: LSTMCell, batch: int = 1, device: Any = None) -> ModelBundle:
    """``cell`` as the zoo's bundle ``(x, h, c) -> (y, h', c')`` for frames of
    ``batch`` rows (a cell carrying a JAX bundle's params, models.convert)."""
    f, inp = cell.hi.in_features, cell.ii.in_features
    io = TensorsInfo.from_strings(
        f"{inp}:{batch},{f}:{batch},{f}:{batch}", "float32,float32,float32")
    out = TensorsInfo.from_strings(
        f"{f}:{batch},{f}:{batch},{f}:{batch}", "float32,float32,float32")
    return ModelBundle("lstm_cell", functools.partial(_forward, cell),
                       module=cell, device=device, forward=_forward,
                       in_info=io, out_info=out,
                       metadata={"features": f, "input": inp})


def make_lstm_cell(device: Any = None, features: str = "32",
                   input_size: str = "32", batch: str = "1", seed: str = "0",
                   **_: Any) -> ModelBundle:
    cell = build_seeded(LSTMCell, device, int(seed), input_size=int(input_size),
                        features=int(features))
    return cell_bundle(cell, int(batch), device)


register_model("lstm_cell", make_lstm_cell)
