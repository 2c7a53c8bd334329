"""Int8 quantization for serving bundles — port of
nnstreamer_tpu/models/quantize.py.

Two modes, chosen at the filter with ``custom="quant=w8|int8|w8a8"``:

* **w8 (weight-only)**: every float leaf of rank >= 2 becomes int8 codes
  with per-output-channel (last axis) absmax scales, dequantized back to
  the leaf's own dtype on every call, inside the call (so inside the
  filter's CUDA graph). A bundle written as a function of a parameter tree
  (``apply_params``, the causal LM) quantizes that tree. A module bundle
  (the zoo's networks) quantizes its flax variables tree
  (``convert.flax_tree``): the grid is computed in the flax layout, where a
  convolution's output channels are the last axis (HWIO) and a dense's
  too (in, out), so the codes and scales are the JAX package's
  ``quantize_params`` of the same tree, leaf for leaf. The codes are kept
  in the module's layout (OIHW, (out, in)) as static device tensors; the
  bundle's ``params`` is the flax-layout tree of views of them, and each
  call runs the bundle's ``forward(module, *xs)`` through
  ``torch.func.functional_call`` on a parameterless copy of the module,
  with the dequantized leaves for its state.
* **w8a8**: int8 weights and dynamically quantized int8 activations with
  exact int32 GEMMs (ops/int8.py), for param trees whose GEMMs run through
  ``matmul_any`` — the causal-LM family. The apply is unchanged: the GEMM
  sites dispatch on the quantized leaves.
"""

from __future__ import annotations

import copy
import threading
from dataclasses import replace
from typing import Any, Optional

import torch
from torch import nn

from .zoo import ForwardModule, ModelBundle

#: tag key marking a weight-only quantized leaf container
_QTAG = "__w8__"


def _quantize_leaf(w: Any) -> Any:
    if not isinstance(w, torch.Tensor) or w.dim() < 2 \
            or not w.is_floating_point():
        return w
    absmax = w.abs().amax(dim=tuple(range(w.dim() - 1)))
    scale = (absmax / torch.full_like(absmax, 127.0)).to(torch.float32)
    safe = torch.where(scale == 0.0, 1.0, scale)
    q = torch.clamp(torch.round(w / safe), -127, 127).to(torch.int8)
    # the original dtype, so the dequant restores it
    return {_QTAG: q, "scale": scale, "orig": w.new_empty((0,))}


def _is_quant(leaf: Any) -> bool:
    return isinstance(leaf, dict) and _QTAG in leaf


def _dequantize_leaf(leaf: Any, dtype: Optional[torch.dtype]) -> Any:
    dt = leaf["orig"].dtype if dtype is None else dtype
    return leaf[_QTAG].to(dt) * leaf["scale"].to(dt)


def _map(tree: Any, fn, is_leaf) -> Any:
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn, is_leaf) for v in tree)
    return fn(tree)


def quantize_params(params: Any) -> Any:
    """float leaves (rank >= 2) → {int8 codes, per-channel scales}."""
    return _map(params, _quantize_leaf, lambda x: isinstance(x, torch.Tensor))


def dequantize_params(params: Any,
                      dtype: Optional[torch.dtype] = torch.bfloat16) -> Any:
    """``dtype=None`` restores each leaf's recorded original dtype."""
    return _map(params, lambda leaf: _dequantize_leaf(leaf, dtype)
                if _is_quant(leaf) else leaf, _is_quant)


def params_nbytes(params: Any) -> int:
    total = 0

    def count(leaf):
        nonlocal total
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        return leaf

    _map(params, count, lambda x: isinstance(x, torch.Tensor))
    return total


def quantize_bundle(bundle: ModelBundle,
                    compute_dtype: Optional[torch.dtype] = None) -> ModelBundle:
    """Serving bundle with weight-only int8 parameters, dequantized on every
    call (to each leaf's original dtype unless ``compute_dtype`` says
    otherwise)."""
    if bundle.params is None or bundle.apply_params is None:
        if bundle.module is not None and bundle.forward is not None:
            return _quantize_module_bundle(bundle, compute_dtype)
        raise ValueError("quantize_bundle: bundle has no params "
                         "(in-process callable models cannot be quantized)")
    qparams = quantize_params(bundle.params)
    base = bundle.apply_params

    def apply_params(p, *xs):
        return base(dequantize_params(p, compute_dtype), *xs)

    return replace(
        bundle, name=f"{bundle.name}:w8",
        apply=lambda *xs: apply_params(qparams, *xs),
        params=qparams, apply_params=apply_params,
        metadata={**bundle.metadata, "quantized": "w8",
                  "params_nbytes": params_nbytes(qparams),
                  "params_nbytes_f32": params_nbytes(bundle.params)})


def _meta_copy(module: nn.Module) -> nn.Module:
    """``module``'s structure with every parameter and buffer on the meta
    device (no storage): a shell that ``functional_call`` fills."""
    memo = {}
    for t in module.parameters():
        memo[id(t)] = nn.Parameter(torch.empty_like(t, device="meta"),
                                   requires_grad=False)
    for t in module.buffers():
        memo[id(t)] = torch.empty_like(t, device="meta")
    return copy.deepcopy(module, memo)


def _lookup(tree: Any, path: Any) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def _quantize_module_bundle(bundle: ModelBundle,
                            compute_dtype: Optional[torch.dtype]) -> ModelBundle:
    """quant=w8 of a module bundle (see the module docstring)."""
    from .convert import flax_layout, flax_leaves, flax_tree, torch_layout

    module = bundle.module
    entries = flax_leaves(module)
    state = {k: v.detach() for k, v in module.state_dict().items()}
    tree = flax_tree(module, state)
    qtree: dict = {}
    for coll, path, key, kind in entries:
        src = _lookup(tree, (coll,) + path)
        # the grid in float32, as JAX computes it from its float32 leaves
        leaf = _quantize_leaf(src.float() if src.is_floating_point() else src)
        if _is_quant(leaf):
            # the codes in the module's layout, the tree's leaf a view;
            # ``orig`` the module's own dtype
            codes = torch_layout(kind, leaf[_QTAG]).contiguous()
            leaf = {**leaf, _QTAG: flax_layout(kind, codes),
                    "orig": src.new_empty((0,))}
        else:
            leaf = src
        node = qtree.setdefault(coll, {})
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    runner = ForwardModule(_meta_copy(module), bundle.forward)
    # functional_call swaps the shell's tensors for the call's duration:
    # one call at a time (a replayed CUDA graph does not come here)
    lock = threading.Lock()

    def apply_params(p, *xs):
        tensors = {}
        for coll, path, key, kind in entries:
            leaf = _lookup(p, (coll,) + path)
            if _is_quant(leaf):
                # in float32, then to the leaf's dtype: what a JAX module of
                # that dtype computes with from its float32 dequant
                dt = leaf["orig"].dtype if compute_dtype is None else compute_dtype
                leaf = (leaf[_QTAG].to(torch.float32) * leaf["scale"]).to(dt)
            tensors[f"inner.{key}"] = torch_layout(kind, leaf)
        with lock:
            return torch.func.functional_call(runner, tensors, xs)

    meta = {k: v for k, v in bundle.metadata.items() if not k.startswith("_")}
    return replace(
        bundle, name=f"{bundle.name}:w8",
        apply=lambda *xs: apply_params(qtree, *xs),
        module=None, forward=None, params=qtree, apply_params=apply_params,
        metadata={**meta, "quantized": "w8",
                  "params_nbytes": params_nbytes(qtree),
                  "params_nbytes_f32": params_nbytes(tree)})


def quantize_bundle_w8a8(bundle: ModelBundle) -> ModelBundle:
    """Serving bundle on the int8 GEMM path (w8a8): int8 weights and
    dynamically quantized activations, exact int32 accumulation. Needs the
    model's GEMM sites to run through ops/int8.matmul_any, which the
    causal-LM family's do."""
    p = bundle.params
    if not isinstance(p, dict) or bundle.apply_params is None or \
            not all(k in p for k in ("wqkv", "wo", "w1", "w2")):
        raise ValueError(
            "quant=w8a8 serves models whose GEMMs run through "
            "ops/int8.matmul_any (the causal-LM family: zoo://causal_lm "
            "param trees)")
    from .causal_lm import quantize_lm_params

    qparams = quantize_lm_params(p)
    base = bundle.apply_params
    return replace(
        bundle, name=f"{bundle.name}:w8a8",
        apply=lambda *xs: base(qparams, *xs), params=qparams,
        metadata={**bundle.metadata, "quantized": "w8a8",
                  "params_nbytes": params_nbytes(qparams),
                  "params_nbytes_f32": params_nbytes(p)})
