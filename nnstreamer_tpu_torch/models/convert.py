"""Carry flax variables into the port's torch modules.

``from_flax_variables`` loads a JAX bundle's ``{"params": ..., "batch_stats":
...}`` tree, turned into numpy, into the matching port module, so both
packages compute the same function. The port's modules name their children
as flax auto-names its submodules (``flax_children``: "ConvBNReLU_0",
"InvertedResidual_3", "Conv_0", "loc_head_1", ...), and the leaves map as:

  * ``nn.Conv2d``: flax HWIO kernel ``(kh, kw, in/groups, out)`` → torch OIHW
    ``(out, in/groups, kh, kw)`` (a depthwise ``(3, 3, 1, C)`` becomes
    ``(C, 1, 3, 3)``); ``bias`` as is;
  * ``BatchNorm``: params ``scale``/``bias`` → ``weight``/``bias``,
    batch_stats ``mean``/``var`` → ``running_mean``/``running_var``;
  * ``nn.Linear``: flax ``(in, out)`` kernel → torch ``(out, in)``; a
    ``Dense(use_bias=False)`` (the input kernels of flax's ``LSTMCell``,
    ``models/lstm.py``) is a ``Linear`` without bias.

``flax_shapes`` gives the same tree's shapes, from which the zoo synthesizes
seeded placeholder weights.

``causal_lm_params`` carries the JAX package's causal-LM parameter tree
(``init_causal_lm`` or ``quantize_lm_params`` output, numpy leaves) onto a
device unchanged in layout: the LM is written as a function of that tree
(models/causal_lm.py), so no leaf is transposed.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .layers import BatchNorm


def _leaves(module: nn.Module, prefix: str = "",
            path: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Tuple[str, ...], str, str]]:
    """(collection, flax path, torch state_dict key, leaf kind) for every
    leaf tensor of ``module``."""
    if isinstance(module, nn.Conv2d):
        yield "params", path + ("kernel",), prefix + "weight", "conv"
        if module.bias is not None:
            yield "params", path + ("bias",), prefix + "bias", "same"
    elif isinstance(module, nn.Linear):
        yield "params", path + ("kernel",), prefix + "weight", "dense"
        if module.bias is not None:
            yield "params", path + ("bias",), prefix + "bias", "same"
    elif isinstance(module, BatchNorm):
        yield "params", path + ("scale",), prefix + "weight", "same"
        yield "params", path + ("bias",), prefix + "bias", "same"
        yield "batch_stats", path + ("mean",), prefix + "running_mean", "same"
        yield "batch_stats", path + ("var",), prefix + "running_var", "same"
    else:
        # dotted state_dict path of each descendant (ModuleList members
        # sit one level further down, e.g. "blocks.3")
        names = {id(m): n for n, m in module.named_modules() if n}
        for flax_name, child in module.flax_children():
            yield from _leaves(child, f"{prefix}{names[id(child)]}.",
                               path + (flax_name,))


def _to_torch(kind: str, arr: np.ndarray) -> np.ndarray:
    if kind == "conv":
        return np.transpose(arr, (3, 2, 0, 1))
    if kind == "dense":
        return arr.T
    return arr


def _from_torch_shape(kind: str, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    if kind == "conv":
        o, i, kh, kw = shape
        return (kh, kw, i, o)
    if kind == "dense":
        return tuple(reversed(shape))
    return tuple(shape)


def flax_shapes(module: nn.Module) -> Dict[str, Any]:
    """The flax variables tree of ``module`` as nested dicts of shapes."""
    state = module.state_dict()
    tree: Dict[str, Any] = {}
    for coll, path, key, kind in _leaves(module):
        node = tree.setdefault(coll, {})
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = _from_torch_shape(kind, tuple(state[key].shape))
    return tree


def from_flax_variables(variables: Dict[str, Any],
                        module: nn.Module) -> Dict[str, torch.Tensor]:
    """Load flax ``variables`` (nested dicts of numpy arrays) into
    ``module`` in place; returns the state_dict that was loaded. Every
    parameter and buffer of the module must be covered."""
    state = module.state_dict()
    new_state: Dict[str, torch.Tensor] = {}
    for coll, path, key, kind in _leaves(module):
        node = variables[coll]
        for k in path:
            node = node[k]
        arr = _to_torch(kind, np.asarray(node, np.float32))
        want = tuple(state[key].shape)
        if arr.shape != want:
            raise ValueError(f"{coll}/{'/'.join(path)}: flax shape "
                             f"{np.shape(node)} does not fit {key} {want}")
        new_state[key] = torch.from_numpy(np.ascontiguousarray(arr))
    module.load_state_dict(new_state, strict=True)
    return new_state


def causal_lm_params(tree: Dict[str, Any], device: Any,
                     dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """The JAX package's causal-LM param tree (array leaves; a w8a8 GEMM
    stack is ``{"__w8a8__": int8, "s": float32}``) → the same tree of
    tensors on ``device``. ``dtype`` casts the float leaves (embeddings,
    norms, float GEMM stacks); int8 payloads and their float32 scales keep
    their dtypes, as ``quantize_lm_params`` made them."""
    def tensor(a: Any) -> torch.Tensor:
        arr = np.array(a)
        if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16: numpy has none
            return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(arr)

    def leaf(a: Any) -> torch.Tensor:
        t = tensor(a)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    return {k: ({kk: tensor(vv).to(device) for kk, vv in v.items()}
                if isinstance(v, dict) else leaf(v))
            for k, v in tree.items()}
