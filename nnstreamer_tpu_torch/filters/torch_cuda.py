"""The ``torch-cuda`` backend — NN execution with PyTorch on the CUDA card.

Port of nnstreamer_tpu/filters/xla.py. Registered as ``torch-cuda`` with
``xla-tpu`` (and ``xla``, ``jax``) as aliases, so the JAX package's
reference pipeline strings run unchanged.

Model forms accepted by ``model=``:
  * ``zoo://<name>?opt=val`` — the torch model zoo (models/zoo.py), built on
    the filter's device;
  * a ModelBundle;
  * an in-process callable ``fn(*tensors)``;
  * a ``(fn, params)`` pair, run as ``fn(params, *tensors)``;
  * a ``.py`` file exporting ``make_model(device=..., **options)``, which
    returns a ModelBundle or a dict ``{name, apply, params, in_info,
    out_info}`` (``apply(params, *tensors)`` when params are given; infos
    as TensorsInfo or ``("3:224:224:1", "uint8")`` string pairs);
  * an exported program (``.jaxexport``/``.stablehlo``/``.jax``, written
    by ``models.export_model``: a ``torch.export`` archive, models/deploy.py)
    loaded onto the filter's device;
  * checkpoint params (a flax ``.msgpack``) with ``custom="arch=<zoo://
    spec or .py>"`` and ``arch_<opt>=<value>`` options for the arch,
    restored into a bundle of its own (``deploy.load_checkpointed``).
  ``.tflite`` files wait for the port of ``models/tflite_import.py``, and
  orbax checkpoint directories are refused (utils/checkpoints.py); the JAX
  filter's flax-module form has no torch counterpart.

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
    (``outputlayout=NCHW``), then a fused epilogue (ops.epilogue). On the
    card the composed invoke runs as one CUDA graph per static input
    signature (core/graphs.py, the counterpart of the JAX filter's
    ``_build_jit``): the first frame of a shape runs eagerly and is
    captured, later frames replay. The graphs live with the composition:
    ``open``, ``set_fused_preprocess``, ``set_fused_epilogue`` and
    ``reload_model`` recompose and drop them, as the JAX cache dies with
    its bundle, and ``close`` drops them. Caps inference runs eagerly;
  * ``custom="sync=true"`` blocks on the outputs before ``invoke`` returns
    (synchronous per-invoke latency accounting);
  * ``custom="donate=true"`` is accepted and changes nothing: torch has no
    buffer donation, and the outputs are the same either way;
  * multi-tenant dispatch (sched/): ``coalesce_token`` names the function
    the filter computes (bundle identity, device, precision, donate,
    bucket, bucket_max, layouts, resize, and the fused prologue's and
    epilogue's structural tokens), so filters of several pipelines over one
    zoo spec coalesce; ``invoke_coalesced`` runs several tenants' items as
    one device batch: under ``bucket=`` through the bucket ladder's graphs,
    otherwise concatenated along axis 0 into one CUDA graph per batch width
    (2 … the engine's ``max_coalesce``: a bounded capture set, shared by
    every filter of one token), its batch-led outputs scattered back;
  * dynamic-count streams (tensor_crop regions): ``custom="bucket=N"``
    stacks a frame's n same-shape tensors into one batch, zero-pads it to
    the next multiple of N, invokes once and emits the first n rows of
    each output (``flexible_output``); the padded sizes stop at
    ``bucket_max`` (default 8·N), and a frame with more tensors is chunked
    into invokes of that size whose outputs are concatenated: one graph
    per padded size.
    ``resize=H:W`` first conforms each region to H×W by the JAX filter's
    bilinear region resize, in float32;
  * ``arch``/``arch_*`` are kept out of the model options, as in the JAX
    filter: only a checkpoint's restore reads them.
  * pre-built bundles (``metadata["jit"] is False``: a sharded bundle,
    parallel/leader.py, whose every call issues collectives on all ranks)
    run their function once an invoke, eagerly: never captured (a capture
    runs a signature eagerly first, which would issue the collectives
    twice on the leader alone) and never coalesced. The fused preprocess,
    layouts and precision cast still apply around it, as the JAX filter
    stages them around its pjit program. The input placement is re-derived
    from the bundle's ``input_sharding`` on ``open`` and ``reload_model``;
    a batch that the bundle's ``batch_multiple`` does not divide is
    zero-padded on the device to the next multiple and the batch-led
    outputs trimmed back; ``close`` stops the bundle's session (its
    followers return).
  * obs: with the profiler on, every program call goes through
    ``obs.profile.DISPATCH_HOOK`` (host time, a sampled CUDA-event device
    time, the cost once per shape), and ``_build`` counts a composition of
    a bundle and configuration already composed as a ``bundle`` hit; the
    bucket ladder records its hits, pad rows and misses through
    sched/telemetry.py, as the JAX filter does.
  * tune: with the autotuner on (``tune.TUNE_HOOK``), the bucket ladder
    asks it for the rung (the minimal one or one up), from its store or
    cost model only — a per-frame path never sweeps.
"""

from __future__ import annotations

import importlib.util
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import tune as _tune
from ..core import graphs
from ..core.buffer import TensorMemory
from ..core.log import logger
from ..core.types import TensorInfo, TensorsInfo
from ..models.zoo import ModelBundle, get_model
from ..obs import profile as _profile
from ..sched import telemetry as _sched_tel
from .base import FilterFramework, FilterProps, register_filter

log = logger("torch_cuda")

#: guards the coalesced programs kept on a bundle (``_coalesced_fn``)
_coalesce_lock = threading.Lock()

#: custom= keys consumed by the filter itself, not by model factories;
#: stripped before model resolution so identical model specs memoize to one
#: bundle regardless of filter-level settings
_FILTER_ONLY_OPTS = frozenset(
    {"sync", "precision", "donate", "bucket", "bucket_max", "resize",
     "arch", "quant"})


def _model_options(options: Dict[str, str]) -> Dict[str, str]:
    return {k: v for k, v in options.items()
            if k not in _FILTER_ONLY_OPTS and not k.startswith("arch_")}


def _flag(options: Dict[str, str], key: str) -> bool:
    return options.get(key, "false").lower() in ("1", "true", "yes")


def _div(x: torch.Tensor, n: int) -> torch.Tensor:
    """x / n in float32 with an IEEE division on every device (the card
    turns a division by a Python scalar into a reciprocal multiply)."""
    return x / torch.full((), n, dtype=torch.float32, device=x.device)


def resize_region(region: np.ndarray, size: Tuple[int, int],
                  device: Any) -> torch.Tensor:
    """Bilinear-resize an (h, w, ...) region to ``size`` = (H, W) in
    float32: the JAX filter's ``_resize_region`` (half-pixel centres,
    sample coordinates clamped to the region, the four taps weighted in
    its op order; jax.image.resize(antialias=False) semantics). The region
    is zero-padded on the host to power-of-two extents as there; the
    padding is never sampled."""
    th, tw = size
    h, w = region.shape[0], region.shape[1]
    hp = 1 << max(3, (h - 1).bit_length())
    wp = 1 << max(3, (w - 1).bit_length())
    padded = np.zeros((hp, wp) + region.shape[2:], region.dtype)
    padded[:h, :w] = region
    trailing = region.shape[2:]
    p = torch.from_numpy(padded).to(device).reshape(hp, wp, -1) \
        .to(torch.float32)

    def coords(n_out: int, n_in: int) -> Tuple[torch.Tensor, ...]:
        nf = torch.full((), n_in, dtype=torch.float32, device=p.device)
        c = _div((torch.arange(n_out, device=p.device, dtype=torch.float32)
                  + 0.5) * nf, n_out) - 0.5
        c = torch.minimum(torch.maximum(c, torch.zeros_like(nf)), nf - 1.0)
        i0 = torch.floor(c).to(torch.int64)
        i1 = torch.clamp(i0 + 1, max=n_in - 1)
        return c - i0.to(torch.float32), i0, i1

    wy, y0, y1 = coords(th, h)
    wx, x0, x1 = coords(tw, w)
    wy, wx = wy[:, None, None], wx[None, :, None]
    a = p[y0[:, None], x0[None, :]]
    b = p[y0[:, None], x1[None, :]]
    c = p[y1[:, None], x0[None, :]]
    d = p[y1[:, None], x1[None, :]]
    out = (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
           + c * wy * (1 - wx) + d * wy * wx)
    return out.reshape((th, tw) + trailing)


def resolve_model(model: Any, options: Optional[Dict[str, str]] = None,
                  device: Any = None) -> ModelBundle:
    """Normalize any accepted model form into a ModelBundle on ``device``
    (the JAX filter's routing)."""
    raw_options = options or {}
    options = _model_options(raw_options)
    if isinstance(model, ModelBundle):
        return model
    if isinstance(model, (list, tuple)) and len(model) == 2 \
            and callable(model[0]):
        fn, params = model
        return _bundle_from_pair(getattr(fn, "__name__", "model"), fn, params,
                                 device)
    if callable(model) and not isinstance(model, type):
        return ModelBundle(getattr(model, "__name__", "model"), model,
                           device=device)
    if isinstance(model, str):
        from ..models import deploy

        if model.startswith("zoo://") or os.path.sep not in model \
                and not os.path.exists(model) \
                and not model.endswith((".py", ".tflite")) \
                and not deploy.is_deployable_path(model):
            return get_model(model, device=device, **options)
        if model.endswith(".py"):
            return _bundle_from_pyfile(model, options, device)
        if model.lower().endswith(".tflite"):
            raise ValueError(
                f"torch-cuda: {model!r}: .tflite models wait for the port of "
                "models/tflite_import.py (ROADMAP.md §A 11c)")
        if model.lower().endswith(deploy.EXPORT_EXTS):
            return deploy.load_exported(model, device)
        if model.lower().endswith(deploy.CKPT_EXTS) or os.path.isdir(model):
            arch = raw_options.get("arch")
            if not arch:
                raise ValueError(
                    f"checkpoint model {model!r} needs custom=\"arch=...\" "
                    "(a zoo:// spec or make_model .py) to restore into")
            arch_opts = {k[5:]: v for k, v in raw_options.items()
                         if k.startswith("arch_")}
            return deploy.load_checkpointed(model, arch, device, **arch_opts)
        raise ValueError(
            f"torch-cuda: unsupported model file {model!r} (use zoo://, an "
            "exported .jaxexport program, checkpoint params + "
            "custom=\"arch=...\", a .py exporting make_model, or an "
            "in-process callable; .tflite files and orbax checkpoint "
            "directories are not ported)")
    raise ValueError(f"torch-cuda: cannot interpret model {model!r}")


def _bundle_from_pair(name: str, fn: Callable, params: Any,
                      device: Any) -> ModelBundle:
    """A function of a parameter tree as a bundle: ``fn(params, *xs)``."""
    return ModelBundle(name, lambda *xs: fn(params, *xs), device=device,
                       params=params, apply_params=fn)


def _bundle_from_pyfile(path: str, options: Dict[str, str],
                        device: Any) -> ModelBundle:
    """Load ``path`` and call its ``make_model(device=..., **options)``
    (the JAX filter's ``_bundle_from_pyfile``, with the filter's device)."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(f"nns_torch_model_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not hasattr(mod, "make_model"):
        raise ValueError(f"{path}: must export make_model(**options)")
    bundle = mod.make_model(device=device, **options)
    if isinstance(bundle, dict):
        name = bundle.get("name", os.path.basename(path))
        params = bundle.get("params")
        made = ModelBundle(name, bundle["apply"], device=device) \
            if params is None \
            else _bundle_from_pair(name, bundle["apply"], params, device)
        made.in_info = _coerce_info(bundle.get("in_info"))
        made.out_info = _coerce_info(bundle.get("out_info"))
        bundle = made
    return bundle


def _coerce_info(v: Any) -> Optional[TensorsInfo]:
    if v is None or isinstance(v, TensorsInfo):
        return v
    if isinstance(v, (tuple, list)) and len(v) == 2:
        return TensorsInfo.from_strings(v[0], v[1])
    raise ValueError(f"bad tensor info spec {v!r}")


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
        #: structural tokens of the fused stages (coalesce_token) and
        #: whether the fused epilogue keeps each output's rows per frame
        self._pre_token: Optional[str] = None
        self._post_token: Optional[str] = None
        self._post_batch_led = True
        #: the profiler's label of a fused invoke (the JAX filter's)
        self._epilogue_label: Optional[str] = None
        self._full: Optional[Callable] = None
        self._device: Optional[torch.device] = None
        self._in_info: Optional[TensorsInfo] = None
        self._out_info: Optional[TensorsInfo] = None
        self._lock = threading.Lock()
        #: the sharded sessions this filter served (parallel/leader.py),
        #: stopped when it closes
        self._sessions: List[Any] = []

    # -- lifecycle ---------------------------------------------------------- #
    def open(self, props: FilterProps) -> None:
        super().open(props)
        opts = props.custom_dict()
        self._device = self._home_device()
        self._bundle = self._maybe_quantize(
            resolve_model(props.model, opts, self._device), opts)
        self._refresh_device()
        self._precision = opts.get("precision", "")
        self._sync = _flag(opts, "sync")
        self._donate = _flag(opts, "donate")
        self._bucket = int(opts.get("bucket", "0") or 0)
        # bounded bucket ladder: padded sizes are bucket, 2*bucket, ... up
        # to bucket_max (default 8*bucket); a frame with more tensors is
        # chunked into cap-sized invokes (_invoke_bucketed)
        bmax = int(opts.get("bucket_max", "0") or 0)
        self._bucket_max = max(bmax, self._bucket) if bmax > 0 \
            else self._bucket * 8
        resize = opts.get("resize", "")
        if resize:
            parts = tuple(int(v) for v in resize.split(":"))
            if len(parts) != 2:
                raise ValueError(f"torch-cuda: resize wants H:W, got {resize!r}")
            self._resize: Optional[Tuple[int, int]] = parts
        else:
            self._resize = None
        self.flexible_output = self._bucket > 0
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

    def _home_device(self) -> Any:
        props = self.props
        return props.device if props.device is not None \
            else props.accelerator.pick_device()

    def _refresh_device(self) -> None:
        """The input placement: a sharded bundle's ``input_sharding`` (the
        leader's device), else the filter's own device. Re-derived on open
        and on reload, so a hot swap to or from a sharded bundle leaves no
        stale placement (the JAX filter's ``_refresh_device``). A sharded
        bundle's session is stopped when the filter closes."""
        placed = self._bundle.metadata.get("input_sharding")
        self._device = placed if placed is not None else self._home_device()
        sess = self._bundle.metadata.get("session")
        if sess is not None and all(sess is not s for s in self._sessions):
            self._sessions.append(sess)

    @property
    def _prebuilt(self) -> bool:
        return self._bundle is not None \
            and self._bundle.metadata.get("jit") is False

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

    def set_fused_preprocess(self, pre: Callable,
                             token: Optional[str] = None) -> None:
        """Install a per-tensor preprocessing stage run inside the invoke
        before the input-layout permute (ops.fusion pass): ``inputlayout``
        describes the stream entering the filter, which is the fused
        transform's output, while the invoke receives the raw upstream
        tensors. Caps inference still runs the model alone on the
        negotiated (transformed) stream. ``token`` is the chain's
        structural signature (``coalesce_token``)."""
        self._fused_pre = pre
        self._pre_token = token
        self._build()

    def set_fused_epilogue(self, post: Callable, token: Optional[str] = None,
                           batch_led: bool = True) -> None:
        """Install a post-processing stage run inside the invoke after the
        stream-layout restore (ops.epilogue pass), so a filter→decoder tail
        runs as one call per frame. Caps inference still reports the
        model's own (unreduced) outputs — downstream fused elements
        negotiate the unreduced stream and consume the fused result.
        ``token`` is the chain's structural signature
        (``coalesce_token``); ``batch_led=False`` declares that the stage
        reduces a whole frame (a decoder's reduce), so ``invoke_coalesced``
        refuses before any device work."""
        self._fused_post = post
        self._post_token = token
        self._post_batch_led = batch_led
        self._epilogue_label = (f"{self._bundle.name}+post[{token}]"
                                if self._bundle is not None and token
                                else None)
        self._build()

    @property
    def coalesce_token(self) -> Optional[Tuple]:
        """Cross-filter coalesce anchor (sched.DeviceEngine): two filter
        instances sharing one resolved bundle (the zoo memoizes equal specs)
        and identical result-affecting config compute the same function, so
        the engine may batch their work together. Fused stages extend it by
        their structural tokens (a stage installed without one anchors on
        its identity), so filters fused with different chains never
        coalesce. None while the filter is closed."""
        if self._bundle is None:
            return None
        token = ("torch-cuda", id(self._bundle), str(self._device),
                 self._precision, self._donate, self._bucket,
                 self._bucket_max, self._in_layout, self._out_layout,
                 self._resize)
        for kind, fn, tok in (("pre", self._fused_pre, self._pre_token),
                              ("post", self._fused_post, self._post_token)):
            if fn is not None:
                token += ((kind, tok if tok is not None else id(fn)),)
        return token

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
        self._full = full
        # a new composition drops the old one's graphs; a pre-built bundle
        # runs eagerly, its function once a call
        self._fn = full if self._prebuilt else graphs.CapturedFn(
            full, f"torch-cuda invoke of {self._bundle.name}")
        prof = _profile.DISPATCH_HOOK
        if prof is not None and pre is None and post is None:
            # the JAX filter's bundle-level jit cache, as telemetry: the
            # same bundle and configuration composed before is a hit
            seen = self._bundle.metadata.setdefault("_composed", set())
            key = (precision, self._donate, in_layout, out_layout)
            prof.on_jit_cache("bundle", key in seen)
            seen.add(key)

    def reload_model(self, model: Any) -> None:
        """Hot swap: same I/O contract required (reference RELOAD
        semantics); the old model stays when the new one's outputs
        differ."""
        opts = self.props.custom_dict() if self.props else {}
        old = self._bundle
        self._bundle = self._maybe_quantize(
            resolve_model(model, opts, self._home_device()), opts)
        self._refresh_device()
        self._build()
        if self._in_info is not None:
            new_out = self._infer_out_info(self._in_info)
            if self._out_info is not None and not new_out.is_compatible(self._out_info):
                self._bundle = old
                self._refresh_device()
                self._build()
                raise ValueError(f"reload rejected: output info changed "
                                 f"{self._out_info} -> {new_out}")
            self._out_info = new_out
        log.info("torch-cuda reloaded model=%s", self._bundle.name)

    def close(self) -> None:
        self._fn = None
        self._full = None
        self._infer_fn = None
        self._bundle = None
        for sess in self._sessions:
            sess.stop()  # the followers return
        self._sessions = []
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
        if self._bucket > 0:
            return self._invoke_bucketed(inputs)
        arrays = self._model_shaped(inputs, [m.device(self._device) for m in inputs])
        mult = int(self._bundle.metadata.get("batch_multiple", 0) or 0)
        batch = int(arrays[0].shape[0]) if arrays and arrays[0].dim() else 0
        pad = (-batch) % mult if mult > 1 else 0
        if pad:
            # an uneven final batch: zero rows up to the next multiple of
            # the data axis, on the device; only batch-led outputs trimmed
            arrays = [torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
                      for a in arrays]
        outs = self._run(arrays)
        if pad:
            outs = tuple(o[:batch] if o.dim() and o.shape[0] == batch + pad else o
                         for o in outs)
        return [TensorMemory(o) for o in outs]

    def _model_shaped(self, inputs: Sequence[TensorMemory],
                      arrays: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each input viewed in the model's declared shape. Negotiation
        accepts a stream whose dims equal the model's up to trailing 1s
        (the reference's gst_tensor_info_is_equal), and such a stream may
        arrive with them dropped: a FlexBuffers or FlatBuffers hop trims
        3:300:300:1 to 3:300:300. The bytes are the same, so the view is
        exact; the JAX filter hands the model the trimmed array and fails."""
        info = self._in_info
        if info is None or len(info) != len(arrays) or self._fused_pre is not None:
            return arrays
        return [a.reshape(i.shape) if tuple(a.shape) != i.shape and m.info.is_compatible(i)
                else a for a, m, i in zip(arrays, inputs, info)]

    def _run(self, arrays: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        with self._lock, torch.inference_mode():
            # profiled dispatch: one module load + None check when off
            prof = _profile.DISPATCH_HOOK
            if prof is not None:
                outs = prof.dispatch(self, list(arrays), fn=self._fn)
            else:
                outs = self._fn(*arrays)
        if self._sync and torch.device(self._device).type == "cuda":
            torch.cuda.current_stream(self._device).synchronize()
        return outs

    def _invoke_bucketed(self, inputs: Sequence[TensorMemory]
                         ) -> List[TensorMemory]:
        """n tensors → one invoke on their stack, zero-padded to the next
        multiple of ``bucket`` → one (n, ...) result per model output;
        frames of more than ``bucket_max`` tensors are chunked and the
        chunks' outputs concatenated."""
        n = len(inputs)
        if n == 0:
            return []
        cap = self._bucket_max
        if n > cap:
            _sched_tel.record_bucket_miss(
                n, cap, label=self._bundle.name if self._bundle else "")
            chunks = [self._invoke_bucketed(inputs[i:i + cap])
                      for i in range(0, n, cap)]
            return [TensorMemory(torch.cat(
                        [c[j].device(self._device) for c in chunks]))
                    for j in range(len(chunks[0]))]
        if self._resize is not None:
            arrays = [resize_region(m.host(), self._resize, self._device)
                      for m in inputs]
        else:
            arrays = [m.device(self._device) for m in inputs]
        shapes = {tuple(a.shape) for a in arrays}
        if len(shapes) != 1:
            raise ValueError(
                f"bucketed invoke needs same-shape tensors, got {shapes} "
                "(add custom=\"resize=H:W\" for image regions)")
        bucket = -(-n // self._bucket) * self._bucket
        tn = _tune.TUNE_HOOK
        if tn is not None and bucket * 2 <= cap:
            # rung choice: the minimal rung pads least but one rung up
            # halves the distinct captured sizes under jittery arrival
            # counts — store/model resolution only (never a sweep: this
            # is a per-frame path)
            rowbytes = float(arrays[0].nbytes)
            rung = tn.pick(
                "xla_bucket_rung", _tune.device_kind(),
                self._bundle.name if self._bundle else "xla",
                _tune.shape_sig(("rung", bucket)),
                candidates=(bucket, bucket * 2), default=bucket,
                features=lambda r: (0.0, r * rowbytes * 2.0))
            if isinstance(rung, (int, float)) \
                    and bucket <= int(rung) <= cap:
                bucket = int(rung)
        _sched_tel.record_bucket_hit(bucket - n)
        x = arrays[0]
        batch = torch.cat([torch.stack(arrays), x.new_zeros(
            (bucket - n,) + tuple(x.shape))])
        return [TensorMemory(o[:n]) for o in self._run([batch])]

    # -- multi-tenant dispatch (sched/engine.py) ------------------------------ #
    #: sched/engine.py gates its ``donate=True`` on this attribute so a
    #: filter without it never sees an unexpected kwarg (which would demote
    #: it to serial fallback forever)
    supports_donate_coalesce = True

    def _coalesced_fn(self) -> graphs.CapturedFn:
        """The coalesced invoke of this filter's function: one CUDA graph
        per batch width, kept on the bundle under the coalesce token, so
        every filter computing the same function shares one capture set
        (the JAX filter's jit cache lives on its bundle the same way) and
        the graphs die with the bundle."""
        token = self.coalesce_token
        with _coalesce_lock:
            programs = self._bundle.metadata.setdefault("_coalesced_fns", {})
            fn = programs.get(token)
            if fn is None:
                fn = programs[token] = graphs.CapturedFn(
                    self._full,
                    f"torch-cuda coalesced invoke of {self._bundle.name}")
        return fn

    def invoke_coalesced(self, groups: Sequence[Sequence[TensorMemory]],
                         donate: bool = False
                         ) -> List[Sequence[TensorMemory]]:
        """Sched-engine coalesced dispatch: several tenants' work items with
        identical input signatures execute as ONE device batch and scatter
        back per item (sched/engine.py ``_dispatch``).

        The engine coalesces only items whose (shape, dtype) signatures
        match, so every group here is uniform. One group is a plain
        ``invoke``. Bucketed filters flatten every group through
        ``_invoke_bucketed``, landing on the bucket ladder's own graphs (no
        capture for a group width). Otherwise each input position
        concatenates along axis 0 and runs as one CUDA graph per batch
        width (``_coalesced_fn``). Raises — and the engine falls back to
        serial invokes — on an arity mismatch, on an output that is not
        batch-led, and, before any device work, when the fused epilogue
        reduces a whole frame (``set_fused_epilogue(batch_led=False)``, a
        decoder's reduce: its (K, 6) rows belong to one frame).

        ``donate=True``: the concatenated batch is engine-owned scratch;
        once the graph's static input holds a copy of it, the filter drops
        its reference, so the allocator may reuse the memory for the next
        batch. The callers' own inputs are never touched and the outputs
        are the same bits either way. Ignored on the bucketed and
        single-group paths."""
        if len(groups) == 1:
            return [self.invoke(groups[0])]
        if self._prebuilt:
            raise ValueError(
                f"coalesce: {self._bundle.name} is pre-built (a sharded "
                "bundle's collectives run once an invoke); serve it serially")
        if self._bucket > 0:
            counts = [len(g) for g in groups]
            stacked = self._invoke_bucketed([m for g in groups for m in g])
            results: List[Sequence[TensorMemory]] = []
            off = 0
            for cnt in counts:
                results.append([TensorMemory(o.device(self._device)[off:off + cnt])
                                for o in stacked])
                off += cnt
            return results
        if self._fused_post is not None and not self._post_batch_led:
            raise ValueError(
                f"coalesce: the fused epilogue ({self._post_token}) reduces "
                "one frame; its output is not batch-led")
        npos = len(groups[0])
        if any(len(g) != npos for g in groups):
            raise ValueError("coalesce: input arity mismatch across items")
        per_group = [self._model_shaped(g, [m.device(self._device) for m in g])
                     for g in groups]
        rows = [int(a[0].shape[0]) for a in per_group]
        total = sum(rows)
        arrays = [torch.cat([a[j] for a in per_group]) for j in range(npos)]
        del per_group
        fn = self._coalesced_fn()
        with self._lock, torch.inference_mode():
            prof = _profile.DISPATCH_HOOK
            if prof is not None:
                outs = prof.dispatch(self, arrays, fn=fn)
            else:
                outs = fn(*arrays)
        if donate:
            # the graph's static input holds the batch now: release the
            # scratch so nothing downstream can observe it
            del arrays
        if self._sync and torch.device(self._device).type == "cuda":
            torch.cuda.current_stream(self._device).synchronize()
        scattered: List[List[TensorMemory]] = [[] for _ in groups]
        for o in outs:
            if o.dim() == 0 or o.shape[0] != total:
                raise ValueError(
                    "coalesce: output not batch-led; cannot scatter "
                    f"(shape {tuple(o.shape)}, rows {total})")
            off = 0
            for i, cnt in enumerate(rows):
                scattered[i].append(TensorMemory(o[off:off + cnt]))
                off += cnt
        return scattered
