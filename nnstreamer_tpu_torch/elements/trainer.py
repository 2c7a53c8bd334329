"""tensor_trainer — online fine-tuning as a stream element.

Port of nnstreamer_tpu/elements/trainer.py. Buffers carry (x, y) tensor
pairs; each frame runs one optimizer step on the pipeline's device, and the
trained parameters are handed to a serving filter (``trained_bundle()`` →
``tensor_filter.update_model``), so a deployed stream adapts in place.

Props as in the JAX element: ``model`` (zoo:// spec, ModelBundle or ``(fn,
params)`` pair), ``learning_rate``, ``optimizer`` (sgd/adam/adamw, optax's
arithmetic: ops/optim.py), ``loss`` (xent/mse), ``checkpoint_path``
(written on EOS), ``report_every`` (bus messages with the running loss),
``resume`` and ``mesh``; the step runs on the pipeline's device (cuda
unless the pipeline says otherwise). Output: the input frame passed
through with ``loss`` in its meta.

What is trained is the bundle's whole tree, in float32 master copies,
whatever dtype the model computes in:

  * a ``(fn, params)`` bundle: every leaf of ``params``; the step calls
    ``fn(cast(masters), x)``;
  * a module bundle with a ``forward(module, *xs)`` form (the zoo's
    MobileNet-v2): every parameter and buffer of the module, which for a
    flax-layout model is the JAX bundle's ``{"params", "batch_stats"}``
    tree (``jax.value_and_grad`` differentiates the batch statistics too,
    and optax updates them). The step runs ``torch.func.functional_call``
    on the trainer's own copy of the module: the bundle's module, which the
    zoo shares with every filter resolving the same spec, is never written.

Each step casts every master to its leaf's dtype (bf16 convolutions take
bf16 weights, as flax casts its float32 params to the compute dtype),
differentiates the loss outside ``inference_mode``, and updates masters
and moments under ``no_grad``. The masters of all leaves live in one flat
float32 tensor, so the optimizer is a handful of elementwise launches.

Checkpoints use the JAX package's layout (utils/checkpoints.py): a module
bundle's masters as the flax variables tree (models/convert.py), keys
sorted as a trained JAX tree has them; ``resume=false`` writes that tree,
``resume=true`` ``{"params", "opt_state", "frames"}`` with the optax state
in flax's state-dict form, and a JAX-written file resumes here with its
count, moments and frame counter.

``mesh=`` ("axis:size[,axis:size...]", a dict, or a parallel.mesh mesh)
trains data-parallel over the ``data`` axis: the pipeline runs on every rank
(parallel/launch.py starts them), every rank is fed the same frames, the
trainer takes its rank's rows of each batch (the batch must divide by the
data axis size), and the gradients and the loss are averaged over ``data``
(with equal shards, the whole batch's). The masters and moments stay whole
on every rank, which all take the same step; the JAX trainer's GSPMD step
also lays them out over ``model`` (parallel/train.py shards them so).
"""

from __future__ import annotations

import collections
import copy
import functools
import os
from typing import Any, Callable, List, Optional, Tuple

import torch
from torch import nn

from ..core.buffer import Buffer
from ..core.hw import resolve_device
from ..core.types import Caps
from ..graph.element import Element, FlowReturn, Pad, register_element
from ..graph.events import MessageType
from ..models import convert
from ..models.zoo import ForwardModule, ModelBundle
from ..ops.optim import Optimizer


def _xent(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    yi = y.to(torch.int64).reshape(-1)
    return -torch.gather(logp, -1, yi[:, None]).mean()


def _mse(pred: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return ((pred.to(torch.float32) - y.to(torch.float32)) ** 2).mean()


LOSSES = {"xent": _xent, "mse": _mse}


def _flatten(tree: Any, path: Tuple[Any, ...] = ()
             ) -> Tuple[List[Tuple[Any, ...]], List[Any], Callable[[List[Any]], Any]]:
    """(paths, leaves, rebuild): a nested dict/list/tuple's leaves in its
    own order with their key paths, and the function that puts a list of
    leaves back into its structure."""
    if isinstance(tree, dict):
        items = list(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return [path], [tree], lambda leaves: leaves[0]
    parts = [(k, *_flatten(v, path + (k,))) for k, v in items]
    paths = [p for _, ps, _, _ in parts for p in ps]
    leaves = [leaf for _, _, ls, _ in parts for leaf in ls]
    sizes = [len(ls) for _, _, ls, _ in parts]

    def rebuild(new: List[Any]) -> Any:
        out, at = [], 0
        for (k, _, _, rb), n in zip(parts, sizes):
            out.append((k, rb(new[at:at + n])))
            at += n
        if isinstance(tree, dict):
            return dict(out)
        return type(tree)(v for _, v in out)

    return paths, leaves, rebuild


def _lookup(tree: Any, path: Tuple[Any, ...]) -> Any:
    for k in path:
        tree = tree[k]
    return tree


class _Masters:
    """The trained tree: float32 masters of every leaf in one flat tensor,
    each leaf a view of it in the model's layout; the apply that takes the
    masters, the bundle that serves them, and the mapping to and from the
    checkpoint layout."""

    def __init__(self, bundle: ModelBundle, device: torch.device) -> None:
        self.bundle = bundle
        if bundle.params is not None and bundle.apply_params is not None:
            self._paths, tensors, self._rebuild = _flatten(
                convert.tensor_tree(bundle.params, device))
            self._own: Optional[nn.Module] = None
            self._kinds = ["same"] * len(tensors)
        elif bundle.module is not None and bundle.forward is not None:
            self._own = copy.deepcopy(bundle.module).to(device)
            state = self._own.state_dict()
            self._entries = convert.flax_leaves(self._own)
            tensors = [state[key] for _, _, key, _ in self._entries]
            self._kinds = [kind for *_, kind in self._entries]
            self._paths = [(coll,) + path for coll, path, _, _ in self._entries]
            self._call = ForwardModule(self._own, bundle.forward)
        else:
            raise ValueError(
                f"tensor_trainer: model {bundle.name!r} has nothing to train "
                "(a (fn, params) pair, a bundle with params and apply_params, "
                "or a module bundle with a forward(module, *inputs) form)")
        if not tensors:
            raise ValueError(f"tensor_trainer: {bundle.name!r} has no leaves to train")
        bad = [t.dtype for t in tensors if not t.is_floating_point()]
        if bad:
            raise ValueError(f"tensor_trainer: {bundle.name!r} has non-float "
                             f"leaves ({bad[0]}); every leaf is trained")
        self.dtypes = [t.dtype for t in tensors]
        self.shapes = [tuple(t.shape) for t in tensors]
        sizes = [t.numel() for t in tensors]
        self.flat = torch.cat([t.detach().reshape(-1).to(torch.float32)
                               for t in tensors])
        offsets = [0]
        for n in sizes:
            offsets.append(offsets[-1] + n)
        self._spans = list(zip(offsets[:-1], offsets[1:]))
        self.leaves = [v.detach().requires_grad_(True) for v in self.views(self.flat)]

    def views(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """``flat`` cut into the leaves' shapes (views)."""
        return [flat[a:b].view(shape) for (a, b), shape in zip(self._spans, self.shapes)]

    def cast(self, leaves: List[torch.Tensor]) -> List[torch.Tensor]:
        """``leaves`` in the model's dtypes (differentiable)."""
        return [t.to(dt) for t, dt in zip(leaves, self.dtypes)]

    def run(self, cast: List[torch.Tensor], *xs: torch.Tensor) -> Any:
        """The model's output with ``cast`` for its tensors."""
        if self._own is None:
            return self.bundle.apply_params(self._rebuild(cast), *xs)
        tensors = {f"inner.{key}": t for (_, _, key, _), t in zip(self._entries, cast)}
        return torch.func.functional_call(self._call, tensors, xs)

    # -- the checkpoint layout ------------------------------------------------ #
    def tree(self, flat: torch.Tensor) -> Any:
        """``flat`` (masters or a moment) as the JAX package's tree: the
        params tree, or the flax variables tree, keys sorted."""
        views = self.views(flat)
        if self._own is None:
            return convert.sort_tree(self._rebuild(views))
        return convert.flax_tree(
            self._own, {key: v for (_, _, key, _), v in zip(self._entries, views)},
            sort_keys=True)

    def load(self, flat: torch.Tensor, tree: Any) -> None:
        """Write ``tree`` (the ``tree`` layout, numpy leaves) into ``flat``."""
        for view, path, kind in zip(self.views(flat), self._paths, self._kinds):
            arr = _lookup(tree, path)
            t = convert.torch_layout(kind, convert.tensor_tree(arr, flat.device))
            if tuple(t.shape) != tuple(view.shape):
                raise ValueError(f"checkpoint leaf {'/'.join(map(str, path))} of "
                                 f"shape {tuple(t.shape)} does not fit "
                                 f"{tuple(view.shape)}")
            view.copy_(t)

    def served_bundle(self) -> ModelBundle:
        """A new bundle serving the current masters."""
        b = self.bundle
        meta = {k: v for k, v in b.metadata.items() if not k.startswith("_")}
        cast = [t.detach().to(dt).clone() for t, dt in zip(self.views(self.flat),
                                                           self.dtypes)]
        if self._own is None:
            params = self._rebuild(cast)
            return ModelBundle(b.name, functools.partial(b.apply_params, params),
                               device=b.device, in_info=b.in_info,
                               out_info=b.out_info, preprocess=b.preprocess,
                               metadata=meta, params=params,
                               apply_params=b.apply_params)
        module = copy.deepcopy(self._own)
        module.load_state_dict({key: t for (_, _, key, _), t in zip(self._entries, cast)})
        module.eval()
        return ModelBundle(b.name, functools.partial(b.forward, module),
                           module=module, device=b.device, in_info=b.in_info,
                           out_info=b.out_info, preprocess=b.preprocess,
                           metadata=meta, forward=b.forward)


@register_element
class TensorTrainer(Element):
    ELEMENT_NAME = "tensor_trainer"

    def __init__(self, name: Optional[str] = None, **props: Any):
        self.model: Any = None
        self.learning_rate = 1e-3
        self.optimizer = "adam"
        self.loss = "xent"
        self.checkpoint_path: Optional[str] = None
        self.report_every = 0  # frames; 0 = no bus reports
        self.mesh: Any = None
        #: True: checkpoint_path stores {params, opt_state, frames} and a
        #: restart resumes training (optimizer moments intact). False
        #: (default): params only.
        self.resume = False
        super().__init__(name, **props)
        self.add_sink_pad(template=Caps.any_tensors())
        self.add_src_pad(template=Caps.any_tensors())
        self._device: Any = None  # the pipeline's device; None → cuda
        self._masters: Optional[_Masters] = None
        self._mesh: Any = None  # the resolved mesh= (None: unsharded)
        self._opt: Optional[Optimizer] = None
        self._opt_state: Any = None
        self._loss_fn: Optional[Callable[..., torch.Tensor]] = None
        self._n = 0
        self.last_loss: Optional[float] = None
        # bounded: perpetual online-training streams must not grow memory
        self.losses: "collections.deque[float]" = collections.deque(maxlen=1024)

    def set_default_device(self, device: Any) -> None:
        self._device = device

    def start(self) -> None:
        # None/""/{} all mean unsharded; parse before any other work
        self._mesh = self._resolve_mesh() if self.mesh else None
        from ..filters.torch_cuda import resolve_model

        if self.checkpoint_path:
            from ..utils.checkpoints import check_path

            check_path(self.checkpoint_path)
        device = resolve_device(self._device)
        self._loss_fn = LOSSES.get(self.loss)
        if self._loss_fn is None:
            raise ValueError(f"tensor_trainer: unknown loss {self.loss!r}")
        try:
            self._opt = Optimizer(self.optimizer, self.learning_rate)
        except ValueError as e:
            raise ValueError(f"tensor_trainer: {e}") from e
        bundle = resolve_model(self.model, {}, device)
        self._masters = _Masters(bundle, device)
        self._opt_state = self._opt.init(self._masters.flat)
        self._n = 0
        self.losses.clear()
        if self.resume and self.checkpoint_path \
                and os.path.exists(self.checkpoint_path):
            self._restore()

    def _resolve_mesh(self) -> Any:
        """The mesh of ``mesh=``: a mesh as is, a dict or an
        "axis:size[,axis:size...]" string built over the ranks."""
        import torch.distributed as dist

        from ..parallel.mesh import make_mesh

        if isinstance(self.mesh, dict):
            axes = {k: int(v) for k, v in self.mesh.items()}
        elif isinstance(self.mesh, str):
            axes = {}
            for part in self.mesh.split(","):
                k, _, v = part.partition(":")
                if not k.strip() or not v.strip().isdigit():
                    raise ValueError(
                        f"tensor_trainer {self.name}: mesh= wants "
                        f"\"axis:size[,axis:size...]\", got {self.mesh!r}")
                axes[k.strip()] = int(v)
        else:
            return self.mesh
        if not dist.is_initialized():
            raise ValueError(
                f"tensor_trainer {self.name}: mesh={self.mesh!r} needs ranks: "
                "run the pipeline on every rank started by parallel/launch.py "
                "(RankGroup, run_ranks)")
        return make_mesh(axes)

    def _data_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a batch along the mesh's ``data`` axis."""
        from ..parallel.train import data_shard

        return data_shard(t, self._mesh)

    def _state_tree(self, flat_fn: Callable[[torch.Tensor], Any]) -> Any:
        """The optimizer state with each moment mapped by ``flat_fn``."""
        return {k: {kk: (vv if kk == "count" else flat_fn(vv)) for kk, vv in v.items()}
                for k, v in self._opt_state.items()}

    def _restore(self) -> None:
        from ..utils import checkpoints

        m = self._masters
        template = {"params": m.tree(m.flat),
                    "opt_state": self._state_tree(m.tree), "frames": 0}
        try:
            blob = checkpoints.load_variables(self.checkpoint_path, template)
        except Exception as e:  # noqa: BLE001 — format mismatch
            raise ValueError(
                f"tensor_trainer {self.name}: {self.checkpoint_path}"
                " is not a resume checkpoint (params+opt_state) — "
                "it looks like a params-only file written with "
                "resume=false; delete it or point resume at a "
                f"fresh path ({type(e).__name__}: {e})") from e
        with torch.no_grad():
            m.load(m.flat, blob["params"])
            for k, v in self._opt_state.items():
                for kk, vv in v.items():
                    saved = blob["opt_state"][k][kk]
                    if kk == "count":
                        vv.copy_(torch.as_tensor(saved, dtype=vv.dtype))
                    else:
                        m.load(vv, saved)
        self._n = int(blob.get("frames", 0))

    def chain(self, pad: Pad, buf: Buffer) -> Optional[FlowReturn]:
        if buf.num_tensors < 2:
            raise ValueError("tensor_trainer expects (x, y) tensor frames "
                             "(use tensor_mux)")
        dev = self._masters.flat.device
        x, y = (mem.device(dev) for mem in buf.memories[:2])
        if self._mesh is not None:
            x, y = self._data_rows(x), self._data_rows(y)
        loss = self.step(x, y)
        self._n += 1
        self.last_loss = float(loss)
        self.losses.append(self.last_loss)
        if self.report_every and self._n % int(self.report_every) == 0:
            self.post_message(MessageType.ELEMENT,
                              {"trainer": self.name, "frames": self._n,
                               "loss": self.last_loss})
        out = buf.with_memories(buf.memories, config=buf.config)
        out.meta["loss"] = self.last_loss
        return self.push(out)

    def gradient(self, x: torch.Tensor, y: torch.Tensor,
                 mark: Callable[[str], None] = lambda part: None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(loss, gradient): the loss on (x, y) at the current masters
        and its gradient with respect to them, flat as the masters are.
        ``mark(part)`` is called as each part has been issued: "cast",
        "forward", "backward"."""
        m = self._masters
        with torch.inference_mode(False), torch.enable_grad():
            # a tensor made under inference mode (an upstream filter's
            # output) cannot be saved for backward: take a plain copy
            x = x.clone() if x.is_inference() else x
            cast = m.cast(m.leaves)
            mark("cast")
            loss = self._loss_fn(m.run(cast, x), y)
            mark("forward")
            grads = torch.autograd.grad(loss, m.leaves)
            flat = torch.cat([g.reshape(-1) for g in grads])
            mark("backward")
        return loss.detach(), flat

    def step(self, x: torch.Tensor, y: torch.Tensor,
             mark: Callable[[str], None] = lambda part: None) -> torch.Tensor:
        """One optimizer step on (x, y); returns the loss before it.
        ``mark`` as in ``gradient``, and "optimizer" after the update."""
        loss, grad = self.gradient(x, y, mark)
        if self._mesh is not None:
            from ..parallel.train import mean_over_data

            loss = mean_over_data(loss, self._mesh)
            grad = mean_over_data(grad, self._mesh)
        self._opt.update(self._masters.flat, grad, self._opt_state)
        mark("optimizer")
        return loss

    @property
    def params(self) -> Any:
        """The current float32 masters, copied, in the checkpoint layout
        (the params tree, or a module's flax variables tree); None before
        the first start."""
        if self._masters is None:
            return None
        m = self._masters
        return m.tree(m.flat.detach().clone())

    def trained_bundle(self) -> ModelBundle:
        """A new bundle serving the current weights (cast to the model's
        dtypes), for ``tensor_filter.update_model``."""
        return self._masters.served_bundle()

    def on_eos(self) -> None:
        if self.checkpoint_path and self._masters is not None:
            from ..utils import checkpoints

            m = self._masters
            params = m.tree(m.flat)
            payload = ({"params": params, "opt_state": self._state_tree(m.tree),
                        "frames": self._n}
                       if self.resume else params)
            checkpoints.save_variables(self.checkpoint_path, payload)
            self.post_message(MessageType.ELEMENT,
                              {"trainer": self.name,
                               "checkpoint": self.checkpoint_path})
