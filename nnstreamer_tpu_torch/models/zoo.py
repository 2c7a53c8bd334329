"""Model zoo registry + the ModelBundle contract used by the torch-cuda backend.

The JAX package's bundle is a pure function + params pair compiled by XLA;
here it is a ``torch.nn.Module`` placed on one device plus the callable
that runs it. Sources:

 * zoo models registered here ("zoo://mobilenet_v2?width=0.25"),
 * ModelBundles or in-process torch callables handed directly to ``model=``.

Zoo weights are seeded placeholders: they are synthesized with numpy in the
JAX package's (flax) parameter layout, with the statistics of its
``synthesize_variables``, and loaded through ``models.convert`` — the same
converter that carries a JAX bundle's real variables across. Streaming
smoke runs and benchmarks exercise compute, not trained weights.
"""

from __future__ import annotations

import threading
import urllib.parse
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..core.hw import resolve_device
from ..core.types import TensorsInfo

_lock = threading.Lock()
_factories: Dict[str, Callable[..., "ModelBundle"]] = {}


@dataclass
class ModelBundle:
    """A torch-callable model: ``apply(*inputs) -> output(s)``.

    ``module`` is the ``nn.Module`` behind ``apply`` (None for plain
    callables); its parameters live on ``device``. ``in_info``/``out_info``
    describe per-frame I/O (batch dim included). ``preprocess`` is the
    model's own input stage, which ``apply`` already runs for uint8 input.
    A model written as a function of a parameter tree (the causal LM) also
    carries ``params`` and ``apply_params(params, *inputs)``, with
    ``apply(*xs) == apply_params(params, *xs)``: the quantizing passes
    (models/quantize.py) rebind it to a transformed tree. A module bundle
    may carry ``forward(module, *inputs)``, its ``apply`` as a function of
    a module of ``module``'s class (``apply(*xs) == forward(module, *xs)``):
    ``tensor_trainer`` runs it on a copy of its own.
    """

    name: str
    apply: Callable[..., Any]
    module: Any = None
    device: Any = None
    in_info: Optional[TensorsInfo] = None
    out_info: Optional[TensorsInfo] = None
    preprocess: Optional[Callable[..., Any]] = None
    metadata: Dict[str, Any] = field(default_factory=dict)
    params: Any = None
    apply_params: Optional[Callable[..., Any]] = None
    forward: Optional[Callable[..., Any]] = None

    def fn(self) -> Callable[..., Any]:
        """The function over input tensors."""
        return self.apply


def _flatten_sorted(tree: Dict[str, Any], prefix=()):
    """(path, leaf) pairs in the order jax.tree_util flattens a dict tree:
    keys sorted at every level."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flatten_sorted(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def synthesize_variables(shape_tree: Dict[str, Any], seed: int) -> Dict[str, Any]:
    """Nested dict of shapes (flax layout) → nested dict of float32 numpy
    arrays with flax-like statistics, deterministically from ``seed``, in
    the leaf order of the JAX package's ``synthesize_variables``
    (models/zoo.py:80-117): lecun-normal kernels, ones for scales/vars,
    zeros for biases/means and vectors, and a fan-in normal for any other
    matrix-like leaf."""
    rng = np.random.default_rng(seed)
    out: Dict[str, Any] = {}
    for path, shape in _flatten_sorted(shape_tree):
        shape = tuple(shape)
        name = path[-1].lower()
        if "kernel" in name or "embedding" in name:
            fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else \
                max(shape[0] if shape else 1, 1)
            arr = rng.normal(0.0, 1.0 / np.sqrt(max(fan_in, 1)),
                             shape).astype(np.float32)
        elif "scale" in name or "var" in name:
            arr = np.ones(shape, np.float32)
        elif "bias" in name or "mean" in name or len(shape) < 2:
            arr = np.zeros(shape, np.float32)
        else:
            # a matrix-like leaf of no known kind (the MoE router and
            # expert stacks, pos_embed): fan-in normal, as JAX does
            fan_in = int(np.prod(shape[:-1]))
            arr = rng.normal(0.0, 1.0 / np.sqrt(max(fan_in, 1)),
                             shape).astype(np.float32)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = arr
    return out


_aliases: Dict[str, str] = {}


def register_model(name: str, factory: Callable[..., ModelBundle]) -> None:
    """Register a zoo factory ``factory(device=..., **options)``. A direct
    registration always wins: it drops any alias installed under the same
    name (a user factory is never shadowed by a built-in alias)."""
    with _lock:
        _factories[name.lower()] = factory
        _aliases.pop(name.lower(), None)


def register_alias(alias: str, canonical: str) -> None:
    """Map ``alias`` onto an existing canonical model name, so both resolve
    to the same memoized bundle (one set of weights). The target is
    validated at once; a direct factory under ``alias`` keeps precedence."""
    with _lock:
        target = _aliases.get(canonical.lower(), canonical.lower())
        if target not in _factories:
            raise ValueError(
                f"register_alias: unknown canonical model {canonical!r}")
        _aliases[alias.lower()] = target


def model_names() -> List[str]:
    _ensure_builtin_models()
    with _lock:
        return sorted(set(_factories) | set(_aliases))


#: resolved-bundle memo: repeated ``zoo://`` specs on one device share one
#: bundle (one set of weights on the card)
_bundle_memo: Dict[Any, ModelBundle] = {}


def get_model(spec: str, device: Any = None, fresh: bool = False,
              **overrides: Any) -> ModelBundle:
    """Resolve "zoo://name?opt=val" or bare "name" on ``device`` (None →
    cuda, raising without a card). ``fresh`` builds a new bundle, outside
    the memo (one whose weights the caller replaces)."""
    _ensure_builtin_models()
    dev = resolve_device(device)
    s = spec
    if s.startswith("zoo://"):
        s = s[len("zoo://"):]
    if "?" in s:
        s, qs = s.split("?", 1)
        opts = {k: v[0] for k, v in urllib.parse.parse_qs(qs).items()}
    else:
        opts = {}
    opts.update(overrides)
    s = s.lower()
    with _lock:
        if s not in _factories:  # direct registrations beat aliases
            s = _aliases.get(s, s)
        factory = _factories.get(s)
    if factory is None:
        raise ValueError(f"unknown zoo model {spec!r}; known: {model_names()}")
    if fresh:
        return factory(device=dev, **opts)
    key = (s, str(dev), tuple(sorted((k, str(v)) for k, v in opts.items())))
    with _lock:
        hit = _bundle_memo.get(key)
    if hit is not None:
        return hit
    bundle = factory(device=dev, **opts)
    with _lock:
        if len(_bundle_memo) > 64:
            _bundle_memo.clear()
        _bundle_memo[key] = bundle
    return bundle


_builtins_loaded = False


def _ensure_builtin_models() -> None:
    # NOTE: flag is set AFTER the imports: a failing builtin module must
    # surface its ImportError on every call, not leave an empty catalog
    global _builtins_loaded
    if _builtins_loaded:
        return
    from . import causal_lm  # noqa: F401
    from . import deeplab  # noqa: F401
    from . import lenet  # noqa: F401
    from . import lstm  # noqa: F401
    from . import mobilenet_v1  # noqa: F401
    from . import mobilenet_v2  # noqa: F401
    from . import moe_transformer  # noqa: F401
    from . import posenet  # noqa: F401
    from . import simple  # noqa: F401
    from . import ssd_mobilenet  # noqa: F401
    from . import stream_transformer  # noqa: F401
    _builtins_loaded = True
