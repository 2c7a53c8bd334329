"""Pipeline graph fusion: run transform chains INSIDE the filter's invoke.

Port of nnstreamer_tpu/ops/fusion.py. The reference executes each element's
math separately (Orc kernels per tensor_transform, then the NN backend's
own runtime). This pass rewrites linear ``tensor_transform* →
tensor_filter(torch-cuda)`` chains so the composed transform functions
become a preprocessing stage of the filter's invoke: the raw frame moves
to the card once, and the per-frame element hops and their launches on
the transform's own path go away. The math is the same, so the result is
bit-identical to the unfused chain.

Applied automatically in ``Pipeline.start()`` (disable with
``pipeline.auto_fuse = False``). Fused transforms stay in the graph for
caps negotiation but forward buffers untouched.
"""

from __future__ import annotations

from typing import Any, List

from ..core.log import logger

log = logger("fusion")


def _transform_signature(t: Any) -> str:
    """Structural identity of a transform stage (a coalesce-token part:
    same mode and options, same function)."""
    if t.transform_chain:
        return ";".join(f"{m}:{o}" for m, o in t.transform_chain)
    return f"{t.mode}:{t.option}"


def fuse_chains(pipeline: Any) -> int:
    """Fuse eligible chains; returns number of transforms fused away."""
    from ..elements.filter import TensorFilter
    from ..elements.transform import TensorTransform
    from ..filters.torch_cuda import TorchCudaFilter

    fused = 0
    for el in pipeline.elements.values():
        if not isinstance(el, TensorFilter):
            continue
        # only the torch-cuda backend runs a preprocessing stage
        try:
            el._open_fw()
        except Exception:  # noqa: BLE001 — config errors surface at start()
            continue
        if not isinstance(el.fw, TorchCudaFilter):
            continue
        chain: List[TensorTransform] = []
        pad = el.sink_pad
        while pad.peer is not None:
            up = pad.peer.element
            if isinstance(up, TensorTransform) and len(up.sink_pads) == 1 \
                    and len(up.src_pads) == 1 and not up._fused:
                chain.append(up)
                pad = up.sink_pad
            else:
                break
        if not chain:
            continue
        chain.reverse()  # upstream → downstream order
        fns = []
        for t in chain:
            fns.append(t.as_torch_fn())
            t._fused = True

        def pre(x, _fns=tuple(fns)):
            for f in _fns:
                x = f(x)
            return x

        # structural token: filters sharing a bundle coalesce only when
        # their fused chains compute the same function (sched engine)
        el.fw.set_fused_preprocess(
            pre, token="|".join(_transform_signature(t) for t in chain))
        fused += len(chain)
        log.info("fused %d transform(s) into %s's invoke", len(chain), el.name)
    return fused
