"""Serialized model deployment: exported programs and checkpoint params.

Port of nnstreamer_tpu/models/deploy.py. A model produced elsewhere — in
another process or on another host, with no access to its defining Python
source — deploys in a pipeline string by its file. Two forms:

* ``foo.jaxexport`` (also ``.stablehlo``/``.jax``, the JAX package's
  extensions, so the same pipeline strings and ``framework=auto`` routing
  hold) — ``export_model()`` output. In the JAX package the file holds a
  serialized ``jax.export`` StableHLO program; here it holds a
  ``torch.export`` program archive (``torch.export.save``), the port's own
  artifact: shape-specialized, parameters inside, self-describing (its
  input and output shapes and dtypes ride along), runnable on the CPU and
  on the card. ``load_exported`` moves the loaded program to the caller's
  device (``torch.export.passes.move_to_device_pass``: constants and the
  ``device=`` arguments a program traced on another device carries). A
  JAX-written StableHLO artifact is refused with a ``ValueError`` naming
  its format.
* checkpoint params (a flax ``.msgpack`` file, as the JAX package writes
  it) + ``custom="arch=zoo://..."`` — weights produced by a training job,
  glued to a zoo or ``.py`` architecture at load time
  (utils/checkpoints). Orbax checkpoint directories stay refused by
  ``utils.checkpoints``.
"""

from __future__ import annotations

import os
import zipfile
from dataclasses import replace
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..core.hw import resolve_device
from ..core.types import TensorInfo, TensorsInfo
from .zoo import ModelBundle

#: extensions treated as serialized exported programs
EXPORT_EXTS = (".jaxexport", ".stablehlo", ".jax")
#: extensions treated as parameter checkpoints needing custom="arch=..."
CKPT_EXTS = (".msgpack", ".ckpt", ".orbax")
#: the archive entry naming the platforms an artifact was exported for
_PLATFORMS_ENTRY = "nns_platforms"
PLATFORMS = ("cpu", "cuda")


class _Program(nn.Module):
    """``fn(*xs)`` as a module with a tuple output; ``owner`` registers the
    module whose parameters ``fn`` reads, so the export lifts them as
    parameters."""

    def __init__(self, fn: Any, owner: Optional[nn.Module]) -> None:
        super().__init__()
        self.owner = owner
        self._fn = fn

    def forward(self, *xs: Any) -> Tuple[torch.Tensor, ...]:
        out = self._fn(*xs)
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _as_tensor(a: Any, device: Any) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def export_model(path: str, model: Any, example_args: Optional[Sequence] = None,
                 platforms: Tuple[str, ...] = PLATFORMS) -> None:
    """Serialize ``model`` (ModelBundle or callable over tensors) to
    ``path`` as a ``torch.export`` program archive.

    ``example_args`` fixes the input shapes and dtypes (the program is
    shape-specialized); defaults to zeros of the bundle's ``in_info`` on
    the bundle's device. ``platforms`` is recorded in the archive."""
    bad = [p for p in platforms if p not in PLATFORMS]
    if bad:
        raise ValueError(f"export_model: unknown platforms {bad} "
                         f"(supported: {', '.join(PLATFORMS)})")
    if isinstance(model, ModelBundle):
        fn, owner = model.fn(), model.module
        device = model.device if model.device is not None else "cpu"
        if example_args is None:
            if model.in_info is None:
                raise ValueError(
                    "export_model: bundle has no in_info; pass example_args")
            example_args = [np.zeros(i.shape, i.dtype.np_dtype)
                            for i in model.in_info]
    else:
        fn, owner, device = model, None, "cpu"
        if example_args is None:
            raise ValueError("export_model: callables need example_args")
    args = tuple(_as_tensor(a, device) for a in example_args)
    with torch.no_grad():
        program = torch.export.export(_Program(fn, owner).eval(), args,
                                      strict=False)
    with open(path, "wb") as f:
        torch.export.save(program, f,
                          extra_files={_PLATFORMS_ENTRY: ",".join(platforms)})


def _info_from_values(values: Sequence[Any]) -> TensorsInfo:
    return TensorsInfo(tuple(
        TensorInfo.from_shape(tuple(int(d) for d in v.shape) or (1,),
                              str(v.dtype).removeprefix("torch."))
        for v in values))


def load_exported(path: str, device: Any = None) -> ModelBundle:
    """An exported program file → ModelBundle on ``device`` (None → cuda,
    raising without a card); I/O metadata from the archive, no defining
    Python source needed."""
    from torch.export.passes import move_to_device_pass

    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    dev = resolve_device(device)
    if not zipfile.is_zipfile(path):
        raise ValueError(
            f"{path}: not a torch.export program archive. A .jaxexport the "
            "JAX package wrote holds a serialized jax.export StableHLO "
            "program, which this package cannot run; export the model with "
            "nnstreamer_tpu_torch.models.export_model")
    extra = {_PLATFORMS_ENTRY: ""}
    with open(path, "rb") as f:
        program = torch.export.load(f, extra_files=extra)
    program = move_to_device_pass(program, dev)
    sig = program.graph_signature
    nodes = {n.name: n for n in program.graph.nodes}
    ins = [nodes[name].meta["val"] for name in sig.user_inputs]
    outs = [nodes[name].meta["val"] for name in sig.user_outputs]
    fn = program.module()

    def apply(*xs):
        out = fn(*xs)
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)

    name = os.path.splitext(os.path.basename(path))[0]
    platforms = tuple(p for p in extra[_PLATFORMS_ENTRY].split(",") if p)
    return ModelBundle(
        name, apply, device=dev, in_info=_info_from_values(ins),
        out_info=_info_from_values(outs),
        metadata={"deployed_from": path, "platforms": platforms})


def load_checkpointed(path: str, arch: str, device: Any = None,
                      **arch_opts: Any) -> ModelBundle:
    """Checkpoint params (a flax ``.msgpack``) + ``arch=`` spec → ModelBundle
    on ``device`` with the trained weights swapped in.

    ``arch`` is any model spec the zoo resolves (``zoo://...``) or a ``.py``
    file exporting ``make_model`` — the same forms ``model=`` accepts. The
    zoo bundle is built anew (``get_model(fresh=True)``): the memoized one
    that other filters serve is never touched. A module bundle's module
    takes the file's flax variables (``convert.restore_flax``, into the
    module's dtypes); a bundle written as a function of a parameter tree
    (the causal LM) gets the file's tree on the device, in the file's
    dtypes, as the JAX package keeps them."""
    from ..utils.checkpoints import load_variables
    from .convert import restore_flax, tensor_tree
    from .zoo import get_model

    dev = resolve_device(device)
    if arch.endswith(".py"):
        from ..filters.torch_cuda import _bundle_from_pyfile

        bundle = _bundle_from_pyfile(arch, arch_opts, dev)
    else:
        bundle = get_model(arch, device=dev, fresh=True, **arch_opts)
    if bundle.module is not None:
        restore_flax(bundle.module, path)
    elif bundle.params is not None and bundle.apply_params is not None:
        params = tensor_tree(load_variables(path, bundle.params), dev)
        apply_params = bundle.apply_params
        bundle = replace(bundle, params=params,
                         apply=lambda *xs: apply_params(params, *xs))
    else:
        raise ValueError(f"arch {arch!r} has no parameters to restore into")
    return replace(bundle, metadata={**bundle.metadata, "deployed_from": path,
                                     "arch": arch})


def is_deployable_path(path: str) -> bool:
    """True for model= values the deploy loader owns (serialized artifact
    or checkpoint params)."""
    lower = path.lower()
    if lower.endswith(EXPORT_EXTS) or lower.endswith(CKPT_EXTS):
        return True
    return os.path.isdir(path)  # orbax checkpoint directory
