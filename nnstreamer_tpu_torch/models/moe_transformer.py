"""MoE streaming transformer — port of nnstreamer_tpu/models/moe_transformer.py.

A streaming transformer whose odd blocks' MLPs are switch-routed
mixture-of-experts layers (parallel/moe.py, Switch-Transformer style).
Serving shards the expert stacks over an ``expert`` mesh axis
(``make_ep_infer``, and ``ep_bundle`` through ``tensor_filter``), while
attention can also run sequence-parallel over ``sp`` (``make_sp_ep_infer``),
so both the context length and the parameter count scale with ranks.

Zoo entry: ``zoo://moe_transformer?layers=2&dim=128&heads=8&experts=8``.

Router metrics (load-balance loss, per-expert counts, dropped tokens),
which the JAX model sows into its ``moe_metrics`` collection, are returned
when asked: ``model(x, metrics={})`` fills the dict by block name
(``{"moe_block_1": {"load_balance_loss": ..., "expert_counts": ...,
"dropped": ...}}``), and the sharded infers take ``metrics=True``.

Placement: ``ep_param_shardings`` keys on the parameter's state_dict path:
``w1``/``w2`` under a ``moe_block_*`` with the expert count as leading dim
shard on it over the expert axis; everything else replicates. A rank holds
its E/EP experts; ``functional_call`` runs the model on them.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from ..core.types import TensorsInfo
from ..parallel.moe import dp_guard, moe_apply, moe_apply_sharded
from .layers import LayerNorm
from .mobilenet_v2 import DTYPES, build_seeded
from .stream_transformer import Block, StreamTransformer, sp_forward
from .zoo import ModelBundle, register_model

__all__ = ["MoEBlock", "MoEStreamTransformer", "make_moe_transformer",
           "ep_param_shardings", "make_ep_infer", "make_sp_ep_infer",
           "ep_bundle"]


class MoEBlock(Block):
    """Transformer block with a switch-MoE MLP: Block's attention half, its
    own MLP. ``moe_fn(params, h, capacity_factor=)`` → (y, aux) is
    ``moe_apply`` on one device, a sharded one under a mesh."""

    def _build_mlp(self, n_experts: int = 8, capacity_factor: float = 1.25,
                   moe_fn: Optional[Callable] = None) -> None:
        d, e = self.dim, n_experts
        hidden = d * self.mlp_ratio
        self.n_experts, self.capacity_factor = e, capacity_factor
        self.moe_fn = moe_fn
        self.norm1 = LayerNorm(d, dtype=self.dtype)
        self.router = nn.Parameter(torch.zeros(d, e))
        self.w1 = nn.Parameter(torch.zeros(e, d, hidden))
        self.w2 = nn.Parameter(torch.zeros(e, hidden, d))

    def flax_params(self) -> List[Tuple[str, str]]:
        return [("router", "router"), ("w1", "w1"), ("w2", "w2")]

    def _mlp_children(self) -> List[Tuple[str, nn.Module]]:
        return [("LayerNorm_1", self.norm1)]

    def _mlp_residual(self, x: torch.Tensor,
                      metrics: Optional[Dict[str, Any]]) -> torch.Tensor:
        h = self.norm1(x)
        params = {"router": self.router, "w1": self.w1.to(self.dtype),
                  "w2": self.w2.to(self.dtype)}
        y, aux = (self.moe_fn or moe_apply)(
            params, h.to(self.dtype), capacity_factor=self.capacity_factor)
        if metrics is not None:
            metrics.update(aux)
        return x + y.to(self.dtype)


class MoEStreamTransformer(StreamTransformer):
    """Alternating dense and MoE blocks (odd blocks are MoE)."""

    def __init__(self, layers: int = 2, dim: int = 128, heads: int = 8,
                 seq: int = 256, in_dim: Optional[int] = None,
                 n_experts: int = 8, capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.bfloat16,
                 attention_fn: Optional[Callable] = None,
                 moe_fn: Optional[Callable] = None):
        super().__init__(layers, dim, heads, seq, in_dim, dtype, attention_fn,
                         n_experts=n_experts, capacity_factor=capacity_factor,
                         moe_fn=moe_fn)

    @staticmethod
    def block_names(layers: int) -> List[str]:
        return [f"moe_block_{i}" if i % 2 else f"block_{i}"
                for i in range(layers)]

    def _block(self, i: int, dim: int, heads: int, dtype: torch.dtype,
               attention_fn: Optional[Callable], **moe: Any) -> nn.Module:
        if i % 2 == 1:
            return MoEBlock(dim, heads, dtype=dtype, attention_fn=attention_fn,
                            **moe)
        return Block(dim, heads, dtype=dtype, attention_fn=attention_fn)


def _forward(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return module(x)


def _model_kw(meta: Dict[str, Any]) -> Dict[str, Any]:
    return {"layers": meta["layers"], "dim": meta["dim"],
            "heads": meta["heads"], "seq": meta["seq"],
            "in_dim": meta.get("in_dim"), "n_experts": meta["experts"],
            "capacity_factor": meta.get("capacity_factor", 1.25),
            "dtype": DTYPES[meta.get("dtype", "float32")]}


def make_moe_transformer(device: torch.device, layers: str = "2",
                         dim: str = "128", heads: str = "8",
                         experts: str = "8", seq: str = "256",
                         in_dim: str = "", batch: str = "1", seed: str = "0",
                         capacity_factor: str = "1.25",
                         dtype: str = "bfloat16", **_: Any) -> ModelBundle:
    length, d, b, e = int(seq), int(dim), int(batch), int(experts)
    d_in = int(in_dim) if in_dim else d
    meta = {"layers": int(layers), "dim": d, "heads": int(heads),
            "experts": e, "seq": length, "in_dim": d_in,
            "capacity_factor": float(capacity_factor), "dtype": dtype}
    model = build_seeded(MoEStreamTransformer, device, int(seed),
                         **_model_kw(meta))
    return ModelBundle(
        "moe_transformer", functools.partial(_forward, model), module=model,
        device=device,
        in_info=TensorsInfo.from_strings(f"{d_in}:{length}:{b}", "float32"),
        out_info=TensorsInfo.from_strings(f"{d}:{length}:{b}", "float32"),
        metadata=meta, forward=_forward)


def _is_expert_stack(path: str, shape: Tuple[int, ...], n_experts: int) -> bool:
    segs = path.split(".")
    return (segs[-1] in ("w1", "w2") and any(s.startswith("moe") for s in segs)
            and bool(shape) and shape[0] == n_experts)


def ep_param_shardings(params: Dict[str, Any], mesh: Any, n_experts: int,
                       ep_axis: str = "expert") -> Dict[str, list]:
    """Placements by state_dict path, one per mesh dimension: expert weight
    stacks (``w1``/``w2`` under a MoE block, leading dim the expert count)
    shard that dim over ``ep_axis``; everything else replicates. Keyed on
    the path, not the shape alone, so an unrelated leaf whose leading dim
    happens to match is never expert-sharded."""
    from ..parallel.mesh import mesh_shape

    names = list(mesh_shape(mesh))
    out = {}
    for path, leaf in params.items():
        shard = ep_axis in names and _is_expert_stack(
            path, tuple(leaf.shape), n_experts)
        out[path] = [Shard(0) if shard and a == ep_axis else Replicate()
                     for a in names]
    return out


def _placed(bundle: ModelBundle, mesh: Any, ep_axis: str) -> Dict[str, Any]:
    from ..parallel.mesh import mesh_device
    from ..parallel.sharding import as_tensor

    state = bundle.module.state_dict()
    shardings = ep_param_shardings(state, mesh, bundle.metadata["experts"],
                                   ep_axis)
    dev = mesh_device(mesh)
    return {k: distribute_tensor(as_tensor(v, dev), mesh, shardings[k],
                                 src_data_rank=None)
            for k, v in state.items()}


def _sharded_model(bundle: ModelBundle, mesh: Any, moe_fn: Callable,
                   attention_fn: Optional[Callable] = None) -> nn.Module:
    """The bundle's architecture on this rank's device with a sharded
    MoE (and attention); ``functional_call`` supplies its parameters."""
    from ..parallel.mesh import mesh_device

    with torch.device("meta"):
        model = MoEStreamTransformer(**_model_kw(bundle.metadata),
                                     attention_fn=attention_fn, moe_fn=moe_fn)
    return model.to_empty(device=mesh_device(mesh)).eval()


def _local(p: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    return {k: v.to_local() for k, v in p.items()}


def _metrics_out(y: torch.Tensor, metrics: Optional[Dict[str, Any]]) -> Any:
    return y if metrics is None else (y, metrics)


def make_ep_infer(bundle: ModelBundle, mesh: Any, ep_axis: str = "expert",
                  dp_axis: Optional[str] = "data"):
    """(infer_fn, placed_params) with the expert stacks sharded over
    ``ep_axis`` and the batch over ``dp_axis`` (when the mesh has it).
    ``infer_fn(placed, x, metrics=False)`` takes the whole batch on every
    rank and returns the whole output (and the router metrics when
    asked); the batch must divide by the data axis."""
    from ..parallel.mesh import all_gather, axis_index, mesh_device, mesh_shape
    from ..parallel.sharding import as_tensor

    dp = mesh_shape(mesh).get(dp_axis, 1) if dp_axis else 1
    block_axis = dp_axis if dp > 1 else None

    def moe_fn(params, h, capacity_factor):
        return moe_apply_sharded(params, h, mesh, ep_axis, block_axis,
                                 capacity_factor=capacity_factor)

    model = _sharded_model(bundle, mesh, moe_fn)
    placed = _placed(bundle, mesh, ep_axis)
    dev = mesh_device(mesh)

    def infer(p: Dict[str, Any], x: Any, metrics: bool = False) -> Any:
        x = as_tensor(x, dev)
        if dp > 1:
            x = x.chunk(dp, dim=0)[axis_index(mesh, dp_axis)]
        got: Optional[Dict[str, Any]] = {} if metrics else None
        with torch.no_grad():
            y = torch.func.functional_call(model, _local(p), (x,),
                                           {"metrics": got})
        if dp > 1:
            y = all_gather(y, mesh, dp_axis, 0)
        return _metrics_out(y, got)

    return dp_guard(infer, dp, dp_axis, what="ep infer"), placed


def make_sp_ep_infer(bundle: ModelBundle, mesh: Any, sp_axis: str = "sp",
                     ep_axis: str = "expert", sp_mode: str = "ring"):
    """(infer_fn, placed_params) composing long-context and expert scaling
    on one 2-D mesh: attention runs sequence-parallel over ``sp_axis``
    (parallel/ring.py's ``sp_mode``) while the expert stacks shard over
    ``ep_axis``; each MoE layer routes the rank's sequence shard with
    capacity positions in the global (b, s) token order. ``infer_fn(placed,
    x, metrics=False)`` takes the whole (B, L, D) input on every rank and
    returns the whole output; L must divide by the ``sp_axis`` size."""
    from ..parallel.ring import sp_attention_fn

    def moe_fn(params, h, capacity_factor):
        return moe_apply_sharded(params, h, mesh, ep_axis, sp_axis,
                                 seq_blocks=True,
                                 capacity_factor=capacity_factor)

    model = _sharded_model(bundle, mesh, moe_fn,
                           sp_attention_fn(sp_mode, mesh, sp_axis))
    placed = _placed(bundle, mesh, ep_axis)

    def infer(p: Dict[str, Any], x: Any, metrics: bool = False) -> Any:
        got: Optional[Dict[str, Any]] = {} if metrics else None
        y = sp_forward(model, _local(p), x, mesh, sp_axis, "sp×ep infer", got)
        return _metrics_out(y, got)

    return infer, placed


def ep_bundle(bundle: ModelBundle, mesh: Any, ep_axis: str = "expert",
              dp_axis: Optional[str] = "data") -> ModelBundle:
    """Wrap for pipeline serving: ``tensor_filter model=ep_bundle(b, mesh)``
    on rank 0 fans each request over the mesh with the expert weights
    sharded, the other ranks following (parallel/leader.py) — the MoE
    analog of ``parallel.sharded_bundle``. Pre-built (``jit: False``), with
    its input placement and ``base``'s public metadata only."""
    from ..parallel.leader import served_bundle
    from ..parallel.mesh import mesh_shape

    infer, placed = make_ep_infer(bundle, mesh, ep_axis, dp_axis)
    return served_bundle(bundle, lambda x: infer(placed, x), mesh,
                         f"{bundle.name}@ep{mesh_shape(mesh).get(ep_axis, 1)}")


register_model("moe_transformer", make_moe_transformer)
