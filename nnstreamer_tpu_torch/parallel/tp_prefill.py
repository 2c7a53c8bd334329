"""Tensor-parallel prompt prefill over the TP mesh — port of
nnstreamer_tpu/parallel/tp_prefill.py.

Each rank computes q, k and v for its own heads only, attends over them and
joins the Megatron pair of sums per layer (parallel/tp_decode.py): the
decode step stretched from one token row to T rows, writing the local-head
cache straight in the TP layout (no relayout, 1/n of the attention work a
rank).

The prompt runs as one verify window at position 0 over an empty cache,
as the port's engines admit a prompt (models/causal_lm.py
``lm_prefill_window``): row j attends columns <= j, so the logits of row
``true_len`` − 1 of a right-padded prompt see the prompt alone, and the
padded rows' K/V are overwritten before a step can attend to them. Every
row then has the bits a TP decode step would give it. Against JAX's dense
TP prefill (``tp_prefill_seq``) the logits agree within the tolerance the
tests state; a w8a8 tree's K/V codes are the single-card codes.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import numpy as np
import torch

from ..models.causal_lm import _full_f32, attend_cols
from ..ops.int8 import stack_shape
from .mesh import axis_size, mesh_device
from .tp_decode import _tp_window

__all__ = ["make_tp_prefill", "tp_prefill_window"]


def tp_prefill_window(tp: Dict[str, Any], tokens: torch.Tensor,
                      true_len: Union[int, torch.Tensor], n_heads: int,
                      max_len: int, mesh: Any, axis: str = "model"
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """The TP admit prefill: tokens (B, Tb) right-padded, ``true_len`` an
    int or a device scalar (unchecked: a CUDA graph replays it for every
    prompt length). Returns (logits (B, vocab) of row true_len − 1, kc, vc
    (this rank's L·B·hn, max_len, hd), pos = [true_len])."""
    with _full_f32():
        n_layers = stack_shape(tp["wq"])[0]
        n = axis_size(mesh, axis)
        hn = n_heads // n
        dev = tp["embed"].device
        b, t = tokens.shape
        hd = tp["embed"].shape[1] // n_heads
        shape = (1, n_layers, b, hn, max_len, hd)
        kc = torch.zeros(shape, dtype=torch.float32, device=dev)
        vc = torch.zeros(shape, dtype=torch.float32, device=dev)
        logits, _ = _tp_window(tp, tokens[None].to(dev), kc, vc,
                               torch.zeros(1, dtype=torch.int64, device=dev),
                               n_heads, mesh, axis, attend_cols(t, max_len))
        tl = true_len.to(dev, torch.int64).reshape(()) \
            if isinstance(true_len, torch.Tensor) \
            else torch.full((), int(true_len), dtype=torch.int64, device=dev)
        flat = (n_layers * b * hn, max_len, hd)
        return (logits[0].index_select(1, (tl - 1).reshape(1))[:, 0],
                kc.view(flat), vc.view(flat), tl.reshape(1).to(torch.int32))


def make_tp_prefill(n_heads: int, max_len: int, mesh: Any,
                    axis: str = "model"):
    """The TP prefill: (tp_params, tokens (B, T) int, true_len=None) →
    (logits (B, vocab), kc, vc (this rank's slice of the head-major TP
    layout, L·B·hn, max_len, hd), pos (1,)). The caches feed
    ``make_tp_generate`` directly. The prompt length and ``true_len`` are
    checked on the host."""
    n = axis_size(mesh, axis)
    if n_heads % n:
        raise ValueError(f"n_heads={n_heads} not divisible by {n}")
    dev = mesh_device(mesh)

    def prefill(tp_params, tokens, true_len=None):
        toks = torch.as_tensor(np.asarray(tokens) if not isinstance(
            tokens, torch.Tensor) else tokens)
        t = toks.shape[1]
        if t > max_len:
            raise ValueError(f"tp_prefill: prompt length {t} exceeds "
                             f"max_len={max_len}")
        tl = t if true_len is None else true_len
        if not isinstance(tl, torch.Tensor):
            tl = int(tl)
            if not 1 <= tl <= t:
                raise ValueError(f"tp_prefill: true_len={tl} outside "
                                 f"[1, {t}] (padded prompt length)")
        return tp_prefill_window(tp_params, toks.to(dev), tl, n_heads,
                                 max_len, mesh, axis)

    return prefill
