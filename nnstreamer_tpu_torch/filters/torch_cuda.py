"""The ``torch-cuda`` backend — NN execution with PyTorch on the CUDA card.

Port of nnstreamer_tpu/filters/xla.py. Registered as ``torch-cuda`` with
``xla-tpu`` (and ``xla``, ``jax``) as aliases, so the JAX package's
reference pipeline strings run unchanged.

Model forms accepted by ``model=``:
  * ``zoo://<name>?opt=val`` — the torch model zoo (models/zoo.py), built on
    the filter's device;
  * a ModelBundle;
  * an in-process callable ``fn(*tensors)``.

Design notes:
  * inputs are moved to the device once (``TensorMemory.device()``);
    outputs stay device-resident and are wrapped zero-copy downstream;
  * invoke is asynchronous: PyTorch enqueues the CUDA work and returns,
    and the pipeline blocks only where a host boundary demands it
    (sink/decoder readback);
  * ``custom="quant=w8|int8|w8a8"`` quantizes the resolved bundle once
    (models/quantize.py; memoized on the base bundle, so filters sharing a
    spec share one pass);
  * the invoke composes, in the JAX backend's order: a fused preprocess
    (ops.fusion), stream→model layout (``inputlayout=NCHW``), precision
    cast (``custom="precision=bf16"``), the model, model→stream layout
    (``outputlayout=NCHW``), then a fused epilogue (ops.epilogue). No jit
    and no CUDA graph yet: every frame is eager PyTorch.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..core.buffer import TensorMemory
from ..core.log import logger
from ..core.types import TensorInfo, TensorsInfo
from ..models.zoo import ModelBundle, get_model
from .base import FilterFramework, FilterProps, register_filter

log = logger("torch_cuda")

#: custom= keys consumed by the filter itself, not by model factories;
#: stripped before model resolution so identical model specs memoize to one
#: bundle regardless of filter-level settings
_FILTER_ONLY_OPTS = frozenset({"precision", "quant"})


def _model_options(options: Dict[str, str]) -> Dict[str, str]:
    return {k: v for k, v in options.items() if k not in _FILTER_ONLY_OPTS}


def resolve_model(model: Any, options: Optional[Dict[str, str]] = None,
                  device: Any = None) -> ModelBundle:
    """Normalize any accepted model form into a ModelBundle on ``device``."""
    options = _model_options(options or {})
    if isinstance(model, ModelBundle):
        return model
    if callable(model) and not isinstance(model, type):
        return ModelBundle(getattr(model, "__name__", "model"), model,
                           device=device)
    if isinstance(model, str) and (model.startswith("zoo://")
                                   or "/" not in model and "." not in model):
        return get_model(model, device=device, **options)
    raise ValueError(f"torch-cuda: cannot interpret model {model!r} (use "
                     "zoo://, a ModelBundle or an in-process callable)")


def _as_tuple(out: Any) -> Tuple[Any, ...]:
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _active_layouts(layouts: Optional[Sequence[str]]) -> Tuple[str, ...]:
    """Layout tuple → itself if any entry permutes (nchw), else ()."""
    layouts = tuple(layouts or ())
    return layouts if any(v == "nchw" for v in layouts) else ()


def _layout_infos(infos: Optional[TensorsInfo],
                  layouts: Sequence[str]) -> Optional[TensorsInfo]:
    """Model-layout (NHWC) TensorsInfo → stream-layout: tensors declared
    NCHW report channel-first dims so caps negotiation matches the wire."""
    if infos is None or not layouts:
        return infos
    out = []
    for i, t in enumerate(infos):
        shape = t.shape
        if i < len(layouts) and layouts[i] == "nchw" and len(shape) == 4:
            n, h, w, c = shape
            out.append(TensorInfo.from_shape((n, c, h, w), t.dtype, t.name))
        else:
            out.append(t)
    return TensorsInfo(tuple(out))


@register_filter
class TorchCudaFilter(FilterFramework):
    """framework=torch-cuda (aliases: xla-tpu, xla, jax)."""

    NAME = "torch-cuda"
    ALIASES = ("xla-tpu", "xla", "jax")
    ALLOCATE_IN_INVOKE = True
    SUPPORTS_LAYOUT = True  # NCHW permutes run inside the invoke

    def __init__(self) -> None:
        super().__init__()
        self._bundle: Optional[ModelBundle] = None
        self._fn: Optional[Callable] = None
        self._infer_fn: Optional[Callable] = None
        self._fused_pre: Optional[Callable] = None
        self._fused_post: Optional[Callable] = None
        self._device: Optional[torch.device] = None
        self._in_info: Optional[TensorsInfo] = None
        self._out_info: Optional[TensorsInfo] = None
        self._lock = threading.Lock()

    # -- lifecycle ---------------------------------------------------------- #
    def open(self, props: FilterProps) -> None:
        super().open(props)
        opts = props.custom_dict()
        self._device = props.device if props.device is not None \
            else props.accelerator.pick_device()
        self._bundle = self._maybe_quantize(
            resolve_model(props.model, opts, self._device), opts)
        self._precision = opts.get("precision", "")
        # inputlayout/outputlayout=NCHW: the stream is channel-first while
        # zoo models take channel-last — the permutes run inside the
        # invoke. Normalized to () unless something actually permutes.
        self._in_layout = _active_layouts(props.input_layout)
        self._out_layout = _active_layouts(props.output_layout)
        self._build()
        self._in_info = props.input_info or _layout_infos(
            self._bundle.in_info, self._in_layout)
        self._out_info = props.output_info or _layout_infos(
            self._bundle.out_info, self._out_layout)
        if self._in_info is not None and self._out_info is None:
            self._out_info = self._infer_out_info(self._in_info)
        log.info("torch-cuda opened model=%s device=%s",
                 self._bundle.name, self._device)

    @staticmethod
    def _maybe_quantize(bundle: ModelBundle, opts: Dict[str, str]) -> ModelBundle:
        """Apply custom="quant=..." (no-op without it). The quantized bundle
        memoizes on the base bundle, so filters sharing one resolved spec
        share one quantization pass."""
        quant = opts.get("quant", "")
        if not quant:
            return bundle
        if quant not in ("w8", "int8", "w8a8"):
            raise ValueError(f"torch-cuda: unknown quant mode {quant!r} "
                             "(supported: w8, int8, w8a8)")
        key = "_w8a8_bundle" if quant == "w8a8" else "_w8_bundle"
        cached = bundle.metadata.get(key)
        if cached is None:
            from ..models.quantize import quantize_bundle, quantize_bundle_w8a8

            cached = (quantize_bundle_w8a8(bundle) if quant == "w8a8"
                      else quantize_bundle(bundle))
            bundle.metadata[key] = cached
        return cached

    def set_fused_preprocess(self, pre: Callable) -> None:
        """Install a per-tensor preprocessing stage run inside the invoke
        before the input-layout permute (ops.fusion pass): ``inputlayout``
        describes the stream entering the filter, which is the fused
        transform's output, while the invoke receives the raw upstream
        tensors. Caps inference still runs the model alone on the
        negotiated (transformed) stream."""
        self._fused_pre = pre
        self._build()

    def set_fused_epilogue(self, post: Callable) -> None:
        """Install a post-processing stage run inside the invoke after the
        stream-layout restore (ops.epilogue pass), so a filter→decoder tail
        runs as one call per frame. Caps inference still reports the
        model's own (unreduced) outputs — downstream fused elements
        negotiate the unreduced stream and consume the fused result."""
        self._fused_post = post
        self._build()

    def _build(self) -> None:
        """Compose the invoke: preprocess → layout → precision → model →
        layout → epilogue, the order of the JAX backend's ``_build_jit``."""
        fn = self._bundle.fn()
        precision = self._precision
        in_layout, out_layout = self._in_layout, self._out_layout
        pre, post = self._fused_pre, self._fused_post

        def base(*xs):
            xs = tuple(x.permute(0, 2, 3, 1)
                       if i < len(in_layout) and in_layout[i] == "nchw"
                       and x.dim() == 4 else x
                       for i, x in enumerate(xs))
            if precision in ("bf16", "bfloat16"):
                xs = tuple(x.to(torch.bfloat16) if x.is_floating_point() else x
                           for x in xs)
            return tuple(y.permute(0, 3, 1, 2)
                         if j < len(out_layout) and out_layout[j] == "nchw"
                         and y.dim() == 4 else y
                         for j, y in enumerate(_as_tuple(fn(*xs))))

        def full(*xs):
            if pre is not None:
                xs = tuple(pre(x) for x in xs)
            ys = base(*xs)
            return tuple(post(ys)) if post is not None else ys

        self._infer_fn = base
        self._fn = full

    def reload_model(self, model: Any) -> None:
        """Hot swap: same I/O contract required (reference RELOAD
        semantics); the old model stays when the new one's outputs
        differ."""
        opts = self.props.custom_dict() if self.props else {}
        old = self._bundle
        self._bundle = self._maybe_quantize(
            resolve_model(model, opts, self._device), opts)
        self._build()
        if self._in_info is not None:
            new_out = self._infer_out_info(self._in_info)
            if self._out_info is not None and not new_out.is_compatible(self._out_info):
                self._bundle = old
                self._build()
                raise ValueError(f"reload rejected: output info changed "
                                 f"{self._out_info} -> {new_out}")
            self._out_info = new_out
        log.info("torch-cuda reloaded model=%s", self._bundle.name)

    def close(self) -> None:
        self._fn = None
        self._infer_fn = None
        self._bundle = None
        super().close()

    # -- model metadata ------------------------------------------------------ #
    def get_model_info(self) -> Tuple[Optional[TensorsInfo], Optional[TensorsInfo]]:
        return self._in_info, self._out_info

    def set_input_info(self, in_info: TensorsInfo) -> TensorsInfo:
        self._in_info = in_info
        self._out_info = self._infer_out_info(in_info)
        return self._out_info

    def _infer_out_info(self, in_info: TensorsInfo) -> TensorsInfo:
        """Output shapes from one dry run of the unfused model on zeros
        (the JAX backend traces with jax.eval_shape; eager torch has no
        shape-only trace for arbitrary callables)."""
        zeros = [torch.zeros(i.shape, dtype=getattr(torch, str(i.dtype)),
                             device=self._device) for i in in_info]
        with torch.inference_mode():
            out = self._infer_fn(*zeros)
        return TensorsInfo(tuple(
            TensorInfo.from_shape(tuple(o.shape) or (1,),
                                  str(o.dtype).removeprefix("torch."))
            for o in out))

    # -- execution ----------------------------------------------------------- #
    def invoke(self, inputs: Sequence[TensorMemory]) -> List[TensorMemory]:
        arrays = [m.device(self._device) for m in inputs]
        with self._lock, torch.inference_mode():
            outs = self._fn(*arrays)
        return [TensorMemory(o) for o in outs]
