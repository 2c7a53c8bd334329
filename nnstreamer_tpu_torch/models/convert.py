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
    ``models/lstm.py``) is a ``Linear`` without bias;
  * ``LayerNorm``: ``scale``/``bias`` → ``weight``/``bias``;
  * a module's own raw parameters, listed by its ``flax_params()`` as
    (flax name, attribute) pairs (``pos_embed``, the MoE ``router``,
    ``w1``, ``w2``), as they are.

These cover LeNet-5 and MobileNet-v1 (convolutions, batch norms,
denses) and the stream and MoE transformers (denses, layer norms, raw
parameters) too; ``load_flax`` loads a JAX bundle's variables into a
port bundle.

``flax_shapes`` gives the same tree's shapes, from which the zoo synthesizes
seeded placeholder weights; ``restore_flax`` loads a checkpoint of that
tree (a flax ``.msgpack`` or an orbax directory) into the module (the zoo's ``checkpoint=``,
models/deploy.py). ``to_flax_variables`` is the inverse of
``from_flax_variables``: a module's state as the flax variables tree, numpy
in flax's layout, with the batch statistics split out under
``batch_stats``; ``flax_tree`` gives the same tree of tensors for any
state_dict-keyed tensors in the module's layout (a trainer's masters), and
``flax_leaves`` lists the mapping leaf by leaf.

``tensor_tree`` carries any nested dict/list/tuple of arrays (a ``(fn,
params)`` bundle's parameters) onto a device as tensors, unchanged in
layout.

``moe_params`` and ``stage_params`` carry the parallel layer's MoE and
stacked pipeline-stage trees (parallel/moe.py, parallel/stages.py).

``causal_lm_params`` carries the JAX package's causal-LM parameter tree
(``init_causal_lm`` or ``quantize_lm_params`` output, numpy leaves) onto a
device unchanged in layout: the LM is written as a function of that tree
(models/causal_lm.py), so no leaf is transposed.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .layers import BatchNorm, LayerNorm


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
    elif isinstance(module, LayerNorm):
        yield "params", path + ("scale",), prefix + "weight", "same"
        yield "params", path + ("bias",), prefix + "bias", "same"
    else:
        # a module's own raw parameters (``self.param`` in flax: pos_embed,
        # the MoE router and expert stacks), in flax's layout
        for flax_name, attr in getattr(module, "flax_params", lambda: [])():
            yield "params", path + (flax_name,), prefix + attr, "same"
        # dotted state_dict path of each descendant (ModuleList members
        # sit one level further down, e.g. "blocks.3")
        names = {id(m): n for n, m in module.named_modules() if n}
        for flax_name, child in module.flax_children():
            yield from _leaves(child, f"{prefix}{names[id(child)]}.",
                               path + (flax_name,))


def flax_leaves(module: nn.Module) -> List[Tuple[str, Tuple[str, ...], str, str]]:
    """(collection, flax path, state_dict key, leaf kind) of every leaf of
    ``module``, in the module's order; the kind is "conv", "dense" or
    "same" (see ``flax_layout``)."""
    return list(_leaves(module))


def flax_layout(kind: str, t: torch.Tensor) -> torch.Tensor:
    """A leaf in torch layout → the same leaf in flax layout (a view)."""
    if kind == "conv":
        return t.permute(2, 3, 1, 0)
    if kind == "dense":
        return t.t()
    return t


def torch_layout(kind: str, t: torch.Tensor) -> torch.Tensor:
    """A leaf in flax layout → the same leaf in torch layout (a view)."""
    if kind == "conv":
        return t.permute(3, 2, 0, 1)
    if kind == "dense":
        return t.t()
    return t


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


def restore_flax(module: nn.Module, path: str) -> nn.Module:
    """Load the flax checkpoint at ``path`` (a ``.msgpack`` file or an
    orbax directory) into ``module`` in place, as the JAX package restores
    a bundle's variables (utils/checkpoints.load_variables with the
    module's flax tree as the template); returns the module. The file's
    leaves are copied into the module's dtypes (``from_flax_variables``)."""
    from ..utils.checkpoints import load_variables

    def template(node: Any) -> Any:
        # float32 leaves of the flax shapes (a directory casts to them, as
        # orbax does to the float32 variables the JAX zoo passes)
        return {k: template(v) for k, v in node.items()} \
            if isinstance(node, dict) \
            else np.broadcast_to(np.zeros((), np.float32), node)

    from_flax_variables(load_variables(path, template(flax_shapes(module))),
                        module)
    return module


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
        t = torch_layout(kind, torch.from_numpy(np.array(node, np.float32)))
        want = tuple(state[key].shape)
        if tuple(t.shape) != want:
            raise ValueError(f"{coll}/{'/'.join(path)}: flax shape "
                             f"{np.shape(node)} does not fit {key} {want}")
        new_state[key] = t.contiguous()
    module.load_state_dict(new_state, strict=True)
    return new_state


def load_flax(bundle: Any, variables: Dict[str, Any]) -> Any:
    """Load a JAX bundle's flax ``variables`` (any array leaves, turned to
    numpy) into the port ``bundle``'s module in place; returns the bundle.
    Module bundles only (the zoo's networks)."""
    if bundle.module is None:
        raise ValueError(f"load_flax: bundle {bundle.name!r} has no module")
    from_flax_variables(variables, bundle.module)
    return bundle


def flax_tree(module: nn.Module, state: Dict[str, torch.Tensor],
              sort_keys: bool = False) -> Dict[str, Any]:
    """``state`` (state_dict keys → tensors in ``module``'s layout) as the
    flax variables tree of tensors in flax's layout (views). Keys follow
    the module's order (flax's own at ``init``), or are sorted at every
    level with ``sort_keys`` (the order of a tree that went through
    ``jax.tree_util``, such as a trained one)."""
    tree: Dict[str, Any] = {}
    for coll, path, key, kind in _leaves(module):
        node = tree.setdefault(coll, {})
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = flax_layout(kind, state[key])
    return sort_tree(tree) if sort_keys else tree


def to_flax_variables(module: nn.Module, sort_keys: bool = False) -> Dict[str, Any]:
    """The inverse of ``from_flax_variables``: the flax variables tree of
    ``module``'s state as float32 numpy arrays in flax's layout
    (``flax_tree``)."""
    def host(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: host(v) for k, v in node.items()}
        return node.detach().to(torch.float32).cpu().contiguous().numpy()

    return host(flax_tree(module, module.state_dict(), sort_keys))


def sort_tree(tree: Any) -> Any:
    """``tree`` with the keys of every dict sorted, as jax.tree_util
    rebuilds a dict."""
    if isinstance(tree, dict):
        return {k: sort_tree(tree[k]) for k in sorted(tree)}
    return tree


def tensor_tree(tree: Any, device: Any) -> Any:
    """Nested dicts, lists and tuples of arrays (numpy, ml_dtypes bfloat16,
    tensors, scalars) → the same structure of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: tensor_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tensor_tree(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
    else:
        arr = np.array(tree)
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
    return t.to(device)


def causal_lm_params(tree: Dict[str, Any], device: Any,
                     dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """The JAX package's causal-LM param tree (array leaves; a w8a8 GEMM
    stack is ``{"__w8a8__": int8, "s": float32}``) → the same tree of
    tensors on ``device``. ``dtype`` casts the float leaves (embeddings,
    norms, float GEMM stacks); int8 payloads and their float32 scales keep
    their dtypes, as ``quantize_lm_params`` made them."""
    def leaf(a: Any) -> torch.Tensor:
        t = tensor_tree(a, "cpu")
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    return {k: (tensor_tree(v, device) if isinstance(v, dict) else leaf(v))
            for k, v in tree.items()}


def moe_params(tree: Dict[str, Any], device: Any) -> Dict[str, torch.Tensor]:
    """The JAX package's MoE param tree (parallel/moe.py
    ``init_moe_params``: ``router`` (D, E), ``w1`` (E, D, H), ``w2`` (E, H,
    D)) → the same tree of tensors on ``device``; both packages' ``x @ w``
    layout, so nothing is transposed."""
    missing = {"router", "w1", "w2"} - set(tree)
    if missing:
        raise ValueError(f"moe_params: missing leaves {sorted(missing)}")
    return {k: tensor_tree(tree[k], device) for k in ("router", "w1", "w2")}


def stage_params(stacked: Any, device: Any) -> Any:
    """Stacked pipeline-stage params (parallel/stages.py
    ``stack_stage_params``: every leaf with a leading stage axis S) → the
    same tree of tensors on ``device``, each leaf's leading axis checked
    to be the same S."""
    out = tensor_tree(stacked, device)
    sizes = set()

    def walk(t: Any) -> None:
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        else:
            sizes.add(int(t.shape[0]) if t.dim() else -1)
    walk(out)
    if len(sizes) != 1 or -1 in sizes:
        raise ValueError(f"stage_params: leaves disagree on the stage axis "
                         f"({sorted(sizes)})")
    return out
