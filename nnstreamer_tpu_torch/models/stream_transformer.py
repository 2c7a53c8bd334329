"""Streaming transformer encoder — port of
nnstreamer_tpu/models/stream_transformer.py.

A transformer filter for token or feature streams (``tensor_aggregator``
windows of per-frame embeddings) whose attention can run
sequence-parallel across ranks through parallel/ring.py: ring attention
(K/V rotations) or Ulysses all-to-all, plain or through the flash kernel
(``ring-flash``, ``a2a-flash``).

Zoo entry: ``zoo://stream_transformer?layers=2&dim=128&heads=8&seq=256``;
``make_sp_apply(bundle, mesh, mode)`` rebuilds it in float32 with
sequence-parallel attention.

The modules compute what the flax ones compute: parameters are float32
(flax's ``param_dtype``) and cast to the model's dtype where flax casts
them (``Dense(dtype=...)``); LayerNorm is flax's (models/layers.py); the
MLP's GELU is ``jax.nn.gelu``'s tanh form; attention on one device is
``reference_attention`` (no kernel runs there, as in the JAX model). Their
children carry flax's names (``block_0``, ``Dense_2``, ``pos_embed``...),
so ``models.convert`` loads a JAX bundle's variables.

Under sequence parallelism a rank runs its own shard of the sequence (the
port's ring and a2a take and return the rank's shard): its rows of
``pos_embed`` are those at its own positions (``offset``).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.types import TensorsInfo
from ..ops.kernels.epilogue import gelu_tanh
from .layers import LayerNorm
from .mobilenet_v2 import DTYPES, build_seeded
from .zoo import ModelBundle, register_model

__all__ = ["Dense", "Block", "StreamTransformer", "make_stream_transformer",
           "make_sp_apply", "sp_forward"]


class Dense(nn.Linear):
    """flax ``nn.Dense(dtype=dtype)``: float32 parameters, the input, kernel
    and bias cast to ``dtype`` for the product."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt))


class Block(nn.Module):
    """Transformer block. The MLP half is its own method (``_mlp_residual``,
    with its children in ``_mlp_children``) so the MoE block
    (models/moe_transformer.py) shares the attention half."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4,
                 dtype: torch.dtype = torch.bfloat16,
                 attention_fn: Optional[Callable] = None, **mlp: Any):
        super().__init__()
        self.dim, self.heads, self.mlp_ratio = dim, heads, mlp_ratio
        self.dtype = dtype
        self.attention_fn = attention_fn  # (q, k, v) -> o, [B, H, L, hd]
        self.norm0 = LayerNorm(dim, dtype=dtype)
        self.qkv = Dense(dim, 3 * dim, bias=False, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)
        self._build_mlp(**mlp)

    def _build_mlp(self) -> None:
        d = self.dim
        self.norm1 = LayerNorm(d, dtype=self.dtype)
        self.fc1 = Dense(d, d * self.mlp_ratio, dtype=self.dtype)
        self.fc2 = Dense(d * self.mlp_ratio, d, dtype=self.dtype)

    def _mlp_children(self) -> List[Tuple[str, nn.Module]]:
        return [("LayerNorm_1", self.norm1), ("Dense_2", self.fc1),
                ("Dense_3", self.fc2)]

    def flax_children(self) -> List[Tuple[str, nn.Module]]:
        return [("LayerNorm_0", self.norm0), ("Dense_0", self.qkv),
                ("Dense_1", self.proj)] + self._mlp_children()

    def forward(self, x: torch.Tensor,
                metrics: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        from ..parallel.ring import reference_attention

        h = self.norm0(x)
        b, length, d = h.shape
        hd = d // self.heads
        q, k, v = (t.reshape(b, length, self.heads, hd).transpose(1, 2)
                   for t in self.qkv(h).split(d, dim=-1))
        attn = self.attention_fn or reference_attention
        o = attn(q, k, v).transpose(1, 2).reshape(b, length, d).to(self.dtype)
        return self._mlp_residual(x + self.proj(o), metrics)

    def _mlp_residual(self, x: torch.Tensor,
                      metrics: Optional[Dict[str, Any]]) -> torch.Tensor:
        h = gelu_tanh(self.fc1(self.norm1(x)))
        return x + self.fc2(h)


class StreamTransformer(nn.Module):
    """``layers`` blocks over a (B, L, D) stream; ``in_dim`` ≠ ``dim`` adds
    the ``embed`` projection. ``pos_embed`` is (1, seq, dim) float32."""

    def __init__(self, layers: int = 2, dim: int = 128, heads: int = 8,
                 seq: int = 256, in_dim: Optional[int] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 attention_fn: Optional[Callable] = None, **block_kw: Any):
        super().__init__()
        self.dim, self.seq, self.dtype = dim, seq, dtype
        in_dim = in_dim or dim
        self.embed = Dense(in_dim, dim, dtype=dtype) if in_dim != dim else None
        self.pos_embed = nn.Parameter(torch.zeros(1, seq, dim))
        self.blocks = nn.ModuleDict(
            (name, self._block(i, dim, heads, dtype, attention_fn, **block_kw))
            for i, name in enumerate(self.block_names(layers)))
        self.norm = LayerNorm(dim, dtype=dtype)

    @staticmethod
    def block_names(layers: int) -> List[str]:
        return [f"block_{i}" for i in range(layers)]

    def _block(self, i: int, dim: int, heads: int, dtype: torch.dtype,
               attention_fn: Optional[Callable], **_: Any) -> nn.Module:
        return Block(dim, heads, dtype=dtype, attention_fn=attention_fn)

    def flax_params(self) -> List[Tuple[str, str]]:
        return [("pos_embed", "pos_embed")]

    def flax_children(self) -> List[Tuple[str, nn.Module]]:
        return ([("embed", self.embed)] if self.embed is not None else []) \
            + list(self.blocks.items()) + [("LayerNorm_0", self.norm)]

    def forward(self, x: torch.Tensor, offset: int = 0,
                total: Optional[int] = None,
                metrics: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        """(B, L, in_dim) → (B, L, dim) float32. Under sequence parallelism
        ``x`` is a rank's rows ``offset … offset + L`` of a ``total``-long
        sequence; ``metrics`` (a dict) collects each MoE block's router
        metrics by block name."""
        length = x.shape[1]
        total = length if total is None else total
        if total != self.seq or offset + length > total:
            raise ValueError(f"stream transformer: rows {offset}..{offset + length} "
                             f"of a {total}-long sequence; the model takes {self.seq}")
        x = x.to(self.dtype)
        if self.embed is not None:
            x = self.embed(x)
        x = x + self.pos_embed[:, offset:offset + length].to(self.dtype)
        for name, block in self.blocks.items():
            sub = None if metrics is None else metrics.setdefault(name, {})
            x = block(x, sub)
        if metrics is not None:
            for name in [n for n, v in metrics.items() if not v]:
                del metrics[name]
        return self.norm(x).to(torch.float32)


def _forward(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return module(x)


def make_stream_transformer(device: torch.device, layers: str = "2",
                            dim: str = "128", heads: str = "8",
                            seq: str = "256", in_dim: str = "",
                            batch: str = "1", seed: str = "0",
                            dtype: str = "bfloat16", **_: Any) -> ModelBundle:
    length, d, b = int(seq), int(dim), int(batch)
    d_in = int(in_dim) if in_dim else d
    model = build_seeded(StreamTransformer, device, int(seed),
                         layers=int(layers), dim=d, heads=int(heads),
                         seq=length, in_dim=d_in, dtype=DTYPES[dtype])
    return ModelBundle(
        "stream_transformer", functools.partial(_forward, model), module=model,
        device=device,
        in_info=TensorsInfo.from_strings(f"{d_in}:{length}:{b}", "float32"),
        out_info=TensorsInfo.from_strings(f"{d}:{length}:{b}", "float32"),
        metadata={"layers": int(layers), "dim": d, "heads": int(heads),
                  "seq": length, "in_dim": d_in},
        forward=_forward)


def sp_forward(model: nn.Module, params: Dict[str, Any], x: Any, mesh: Any,
               axis_name: str, what: str,
               metrics: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """``model`` with ``params`` on this rank's rows of the sequence axis of
    the whole ``x`` (the sequence must divide by the axis size), at their
    offset; the whole output, gathered over ``axis_name``."""
    from ..parallel.mesh import all_gather, axis_index, axis_size, mesh_device
    from ..parallel.sharding import as_tensor

    x = as_tensor(x, mesh_device(mesh))
    n = axis_size(mesh, axis_name)
    if x.shape[1] % n:
        raise ValueError(f"{what}: sequence {x.shape[1]} not divisible by "
                         f"the {axis_name!r} axis size {n}")
    rows = x.shape[1] // n
    offset = axis_index(mesh, axis_name) * rows
    with torch.no_grad():
        y = torch.func.functional_call(
            model, params, (x[:, offset:offset + rows],),
            {"offset": offset, "total": x.shape[1], "metrics": metrics})
    return all_gather(y, mesh, axis_name, 1)


def make_sp_apply(bundle: ModelBundle, mesh: Any, mode: str = "ring",
                  axis_name: str = "sp", causal: bool = False):
    """Rebuild the bundle's model in float32 with sequence-parallel
    attention over ``mesh``: returns (apply_fn, params). ``apply_fn(params,
    x)`` takes the whole (B, L, in_dim) input on every rank (the JAX
    function's global view), runs the rank's L/n rows and returns the whole
    output on every rank."""
    from ..parallel.mesh import mesh_device
    from ..parallel.ring import sp_attention_fn

    meta = bundle.metadata
    attn = sp_attention_fn(mode, mesh, axis_name, causal=causal)
    model = StreamTransformer(layers=meta["layers"], dim=meta["dim"],
                              heads=meta["heads"], seq=meta["seq"],
                              in_dim=meta.get("in_dim"), dtype=torch.float32,
                              attention_fn=attn).to(mesh_device(mesh))
    model.load_state_dict(bundle.module.state_dict())
    params = {k: v.detach() for k, v in model.state_dict().items()}
    return (lambda p, x: sp_forward(model, p, x, mesh, axis_name,
                                    "sp apply")), params


register_model("stream_transformer", make_stream_transformer)
