"""Epilogue fusion: run post-filter chains INSIDE the filter's invoke.

The downstream mirror of ops.fusion: rewrites linear
``tensor_filter(torch-cuda) → tensor_transform*/tensor_converter*/
tensor_decoder`` tails so the composed post-processing runs as an epilogue
stage of the filter's invoke — for SSD box decode + NMS the device→host
readback shrinks from the full model output (anchors × (4 + classes)
floats) to the reduced (K, 6) rows, and no host decode waits on the raw
logits.

Enrolled elements stay in the graph for caps negotiation but forward
buffers untouched (transforms, converters) or consume the pre-reduced
tensor (decoders). Fused output is bit-identical to the unfused chain: the
epilogue applies exactly the functions the elements would have applied.
Applied automatically in ``Pipeline.start()`` after elements are started
(disable with ``pipeline.auto_fuse = False``).
"""

from __future__ import annotations

from typing import Any, Callable, List

from ..core.log import logger
from .fusion import _transform_signature

log = logger("epilogue")


def fuse_epilogues(pipeline: Any) -> int:
    """Fuse eligible downstream chains; returns stages fused away.

    Runs after ``Element.start()`` (decoder instances must exist) and
    before scheduler attach (the filters' ``coalesce_token`` must be final
    when the engine starts keying batches).
    """
    from ..elements.converter import TensorConverter
    from ..elements.decoder import TensorDecoder
    from ..elements.filter import TensorFilter
    from ..elements.transform import TensorTransform
    from ..filters.torch_cuda import TorchCudaFilter

    fused = 0
    for el in pipeline.elements.values():
        if not isinstance(el, TensorFilter) or len(el.src_pads) != 1:
            continue
        el._open_fw()
        fw = el.fw
        if not isinstance(fw, TorchCudaFilter):
            continue
        if getattr(fw, "flexible_output", False):
            continue  # bucket ladder emits variable rows; caps won't pin
        if el._out_spec is not None:
            continue  # output combination reorders memories downstream

        fns: List[Callable] = []
        sig_parts: List[str] = []
        reduces_frame = False
        pad = el.src_pads[0]
        while pad.peer is not None:
            down = pad.peer.element
            if isinstance(down, TensorTransform) and len(down.sink_pads) == 1 \
                    and len(down.src_pads) == 1 and not down._fused \
                    and not down._fused_post:
                f = down.as_torch_fn()
                fns.append(lambda outs, _f=f: tuple(_f(y) for y in outs))
                down._fused_post = True
                sig_parts.append(f"transform[{_transform_signature(down)}]")
                pad = down.src_pads[0]
                continue
            if isinstance(down, TensorConverter) and len(down.sink_pads) == 1 \
                    and len(down.src_pads) == 1 \
                    and down.mode in (None, "auto") \
                    and int(down.frames_per_tensor) == 1 \
                    and not down._fused_passthrough:
                # static tensors→tensors passthrough: identity math, but
                # enrolling skips the per-frame host round trip
                down._fused_passthrough = True
                sig_parts.append("converter[passthrough]")
                pad = down.src_pads[0]
                continue
            if isinstance(down, TensorDecoder) and len(down.sink_pads) == 1:
                dec = down._decoder
                red = dec.epilogue_reduce() if dec is not None else None
                if red is not None and not dec._fused_epilogue:
                    fns.append(lambda outs, _r=red: (_r(outs),))
                    dec._fused_epilogue = True
                    sig_parts.append(f"decode[{dec.fusion_signature()}]")
                    reduces_frame = True
            break
        if fns:
            def post(outs, _fns=tuple(fns)):
                for f in _fns:
                    outs = f(outs)
                return outs

            # structural token (filters sharing a bundle coalesce only when
            # their fused chains match); a decoder's reduce consumes one
            # frame, so the fused output is not batch-led
            fw.set_fused_epilogue(post, token="|".join(sig_parts),
                                  batch_led=not reduces_frame)
        if sig_parts:
            log.info("fused %d epilogue stage(s) into %s (%s)", len(sig_parts),
                     el.name, "|".join(sig_parts))
        fused += len(sig_parts)
    return fused
