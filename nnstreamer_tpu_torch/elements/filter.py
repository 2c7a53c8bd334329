"""tensor_filter — THE core element: wraps any NN backend as a stream filter.

Reference: gst/nnstreamer/tensor_filter/tensor_filter.c (+ _common.c).
Responsibilities mirrored here:
  * framework resolution incl. ``framework=auto`` detection from the model
    (tensor_filter_common.c:1153-1416) and lazy backend open
    (gst_tensor_filter_common_open_fw, :2394-2429);
  * caps negotiation driven by model I/O metadata (transform_caps/set_caps,
    tensor_filter.c:113-123 — model info decides stream types);
  * input-combination / output-combination tensor picking
    (tensor_filter.c:607-646, 709-766);
  * invoke with rolling latency/throughput statistics
    (tensor_filter.c:321-420; props latency/throughput);
  * QoS throttling driven by tensor_rate's upstream QOS events
    (tensor_filter.c:425-480,526);
  * model hot-reload via RELOAD_MODEL event / ``update_model()``
    (is-updatable, evt_update_model tensor_filter.c:76);
  * shared backend instances via ``shared-tensor-filter-key``
    (tensor_filter_common.c:570-602);
  * invoke soft-failure = drop buffer (tensor_filter.c:702-705).
"""

from __future__ import annotations

import time
from typing import Any, List, Optional, Sequence

from ..core.buffer import Buffer, TensorMemory
from ..core.hw import AcceleratorSpec
from ..core.log import logger
from ..core.types import Caps, TensorFormat, TensorsConfig, TensorsInfo
from ..filters.base import (
    FilterFramework,
    FilterProps,
    InvokeStats,
    detect_framework,
    find_filter,
    shared_model_get_or_create,
    shared_model_release,
)
from ..graph.element import Element, FlowReturn, Pad, register_element
from ..graph.events import Event, EventType
from ..obs import quality as _quality
from ..resilience.policy import deadline_of

log = logger("tensor_filter")


@register_element
class TensorFilter(Element):
    ELEMENT_NAME = "tensor_filter"

    def __init__(self, name: Optional[str] = None, **props: Any):
        self.framework = "auto"
        self.model: Any = None
        self.custom = ""
        self.accelerator = ""
        self.is_updatable = False
        self.input: Optional[str] = None        # dims override, e.g. "3:224:224:1"
        self.inputtype: Optional[str] = None
        self.inputname: Optional[str] = None    # graph op names (tensorflow)
        self.output: Optional[str] = None
        self.outputtype: Optional[str] = None
        self.outputname: Optional[str] = None
        # data layouts, comma-separated per tensor: none/any/NHWC/NCHW
        # (tensor_filter_common.c:913-940). NCHW on the torch-cuda backend
        # runs the channel-first<->channel-last permute inside the invoke.
        self.inputlayout: Optional[str] = None
        self.outputlayout: Optional[str] = None
        self.input_combination: Optional[str] = None   # e.g. "0,2"
        self.output_combination: Optional[str] = None  # e.g. "i0,o0"
        self.shared_tensor_filter_key: Optional[str] = None
        #: torch device the backend runs on ("cuda", "cuda:1", "cpu", or a
        #: torch.device); None → the pipeline's device, else cuda
        self.device: Any = None
        super().__init__(name, **props)
        self.add_sink_pad(template=Caps.any_tensors())
        self.add_src_pad(template=Caps.any_tensors())
        self.fw: Optional[FilterFramework] = None
        self.stats = InvokeStats()
        self._shared_key_used: Optional[str] = None
        self._throttle_interval_ns = 0
        self._last_pushed_pts: Optional[int] = None
        self._out_config: Optional[TensorsConfig] = None
        self._in_pick: Optional[List[int]] = None
        self._out_spec: Optional[List[tuple]] = None
        self._parse_combinations()

    # -- properties ---------------------------------------------------------- #
    @property
    def latency(self) -> int:
        """Average invoke latency µs over last 10 invokes (reference prop)."""
        return self.stats.latency_us

    @property
    def throughput(self) -> int:
        """FPS×1000 since first invoke (reference prop)."""
        return self.stats.throughput

    @property
    def inputranks(self) -> str:
        """Comma-separated ranks of the model's input tensors (readable
        prop, PROP_INPUTRANKS)."""
        return self._ranks_of(0)

    @property
    def outputranks(self) -> str:
        """Comma-separated ranks of the model's output tensors (readable
        prop, PROP_OUTPUTRANKS)."""
        return self._ranks_of(1)

    def _ranks_of(self, which: int) -> str:
        if self.fw is None:
            return ""
        info = self.fw.get_model_info()[which]
        if info is None:
            return ""
        return ",".join(str(t.rank) for t in info)

    _LAYOUTS = ("", "none", "any", "nhwc", "nchw")

    @classmethod
    def _parse_layout(cls, spec: Optional[str]) -> tuple:
        if not spec:
            return ()
        vals = tuple(p.strip().lower() for p in str(spec).split(","))
        for v in vals:
            if v not in cls._LAYOUTS:
                raise ValueError(
                    f"tensor_filter: unknown layout {v!r} "
                    "(allowed: none/any/NHWC/NCHW)")
        return vals

    def _parse_combinations(self) -> None:
        if self.input_combination:
            self._in_pick = [int(x) for x in str(self.input_combination).split(",")]
        if self.output_combination:
            spec = []
            for part in str(self.output_combination).split(","):
                part = part.strip().lower()
                if part.startswith("i"):
                    spec.append(("i", int(part[1:])))
                elif part.startswith("o"):
                    spec.append(("o", int(part[1:])))
                else:
                    raise ValueError(
                        f"output-combination entries must be iN/oN: {part!r}")
            self._out_spec = spec

    def set_default_device(self, device: Any) -> None:
        if self.device is None:
            self.device = device

    # -- lifecycle ----------------------------------------------------------- #
    def _open_fw(self) -> None:
        if self.fw is not None:
            return
        fw_name = self.framework
        if fw_name in ("auto", "", None):
            fw_name = detect_framework(self.model)
            if fw_name is None:
                raise ValueError(
                    f"tensor_filter {self.name}: cannot auto-detect framework "
                    f"for model {self.model!r}")
        cls = find_filter(fw_name)
        if cls is None:
            raise ValueError(f"tensor_filter: unknown framework {fw_name!r}")
        in_layout = self._parse_layout(self.inputlayout)
        out_layout = self._parse_layout(self.outputlayout)
        if "nchw" in in_layout + out_layout and not cls.SUPPORTS_LAYOUT:
            # a backend that ignores the declared layout would run
            # unpermuted data and return silently wrong results
            raise ValueError(
                f"tensor_filter {self.name}: framework {fw_name!r} does "
                "not implement NCHW layout conversion (the torch-cuda "
                "backend does)")
        accelerator = AcceleratorSpec.parse(self.accelerator)
        device = accelerator.pick_device(self.device)
        props = FilterProps(
            model=self.model,
            custom=self.custom,
            accelerator=accelerator,
            device=device,
            input_info=self._override_info(self.input, self.inputtype, self.inputname),
            output_info=self._override_info(self.output, self.outputtype, self.outputname),
            is_updatable=self.is_updatable,
            input_layout=in_layout,
            output_layout=out_layout,
        )
        if self.shared_tensor_filter_key:
            key = self.shared_tensor_filter_key
            self._shared_key_used = key

            def factory() -> FilterFramework:
                fw = cls()
                fw.open(props)
                return fw

            self.fw = shared_model_get_or_create(key, factory)
        else:
            fw = cls()
            fw.open(props)  # only adopt a successfully opened backend
            self.fw = fw
        self.resolved_framework = fw_name

    @staticmethod
    def _override_info(dims: Optional[str], types: Optional[str],
                       names: Optional[str] = None) -> Optional[TensorsInfo]:
        if dims and types:
            return TensorsInfo.from_strings(dims, types, names)
        return None

    def start(self) -> None:
        self._open_fw()
        self._last_pushed_pts = None

    def sched_enroll(self, engine: Any, tenant: Any) -> None:
        """Route this filter's invokes through a sched.DeviceEngine:
        same-model/same-shape work from OTHER tenants coalesces with ours
        into one device batch. Installed by
        ``DeviceEngine.attach_pipeline``; ``sched_detach`` (base class)
        restores direct dispatch. chain() pays one attribute None check
        either way."""
        self._open_fw()
        self._sched_exec = engine.executor(tenant, self.fw, label=self.name)

    def stop(self) -> None:
        self._sched_exec = None  # closing fw invalidates the executor
        if self.fw is not None:
            if self._shared_key_used:
                if shared_model_release(self._shared_key_used):
                    self.fw.close()
            else:
                self.fw.close()
            self.fw = None

    # -- negotiation ---------------------------------------------------------- #
    def on_caps(self, pad: Pad, caps: Caps) -> None:
        if caps.media_type != "other/tensors":
            raise ValueError(
                f"tensor_filter accepts other/tensors, got {caps.media_type} "
                "(insert tensor_converter upstream)")
        self._open_fw()
        in_config = caps.to_config()
        in_info, out_info = self.fw.get_model_info()
        stream_info = in_config.info
        model_sees = self._picked_info(stream_info)
        # with a fused preprocessing stage the wire caps describe the
        # *transformed* stream while the raw tensors reach the invoke
        fused = getattr(self.fw, "_fused_pre", None) is not None
        if getattr(self.fw, "flexible_output", False):
            # bucketed dynamic-count invoke: the region count varies per
            # frame, so both ends of the element stay flexible-format
            pad.caps = caps
            self._out_config = TensorsConfig(
                TensorsInfo((), TensorFormat.FLEXIBLE), in_config.rate)
            self.send_caps_all(Caps.tensors(self._out_config))
            return
        if in_info is None:
            out_info = self.fw.set_input_info(model_sees)
        elif not fused and stream_info.format is TensorFormat.STATIC and \
                not in_info.is_compatible(model_sees):
            raise ValueError(
                f"tensor_filter {self.name}: stream {model_sees} incompatible "
                f"with model input {in_info}")
        if out_info is None:
            out_info = self.fw.set_input_info(model_sees)
        pad.caps = caps
        final_out = self._combined_out_info(stream_info, out_info)
        self._out_config = TensorsConfig(final_out, in_config.rate)
        self.send_caps_all(Caps.tensors(self._out_config))

    def _picked_info(self, stream_info: TensorsInfo) -> TensorsInfo:
        if self._in_pick is None:
            return stream_info
        return TensorsInfo(tuple(stream_info[i] for i in self._in_pick))

    def _combined_out_info(self, in_info: TensorsInfo, out_info: TensorsInfo) -> TensorsInfo:
        if self._out_spec is None:
            return out_info
        infos = []
        for kind, idx in self._out_spec:
            infos.append(in_info[idx] if kind == "i" else out_info[idx])
        return TensorsInfo(tuple(infos))

    # -- dataflow -------------------------------------------------------------- #
    def chain(self, pad: Pad, buf: Buffer) -> Optional[FlowReturn]:
        if self.fw is None:
            raise RuntimeError("tensor_filter: backend not opened")
        # QoS throttling (tensor_rate contract)
        if self._throttle_interval_ns > 0 and buf.pts is not None \
                and self._last_pushed_pts is not None \
                and buf.pts < self._last_pushed_pts + self._throttle_interval_ns:
            return FlowReturn.OK  # drop
        inputs = buf.memories
        if self._in_pick is not None:
            model_inputs = [inputs[i] for i in self._in_pick]
        else:
            model_inputs = inputs
        t0 = time.monotonic_ns()
        if self._sched_exec is not None:
            # scheduled path: the engine coalesces this invoke with
            # same-shape work from other tenants; a deadline-shed result
            # comes back as None and rides the soft-drop below
            outputs = self._sched_exec(model_inputs, deadline_of(buf))
        else:
            outputs = self.fw.invoke(model_inputs)
        self.stats.record(time.monotonic_ns() - t0)
        if outputs is None:
            return FlowReturn.OK  # backend soft-drop
        if self._out_spec is not None:
            mems: List[TensorMemory] = []
            for kind, idx in self._out_spec:
                mems.append(inputs[idx] if kind == "i" else outputs[idx])
        else:
            mems = list(outputs)
        out = buf.with_memories(mems, config=self._out_config)
        # data-plane quality tap (obs/quality): the model's raw output
        # buffer; host-only observation, so a card-resident output is
        # counted as skipped rather than copied back
        qhook = _quality.QUALITY_HOOK
        if qhook is not None:
            qhook.observe_filter(self.name, out)
        self._last_pushed_pts = buf.pts
        return self.push(out)

    # -- events ---------------------------------------------------------------- #
    def handle_upstream_event(self, pad: Pad, event: Event) -> None:
        if event.type is EventType.QOS:
            self._throttle_interval_ns = int(event.data.get("interval_ns", 0))
            return  # consumed (reference: filter is the throttle point)
        if event.type is EventType.RELOAD_MODEL:
            self.update_model(event.data["model"])
            return
        super().handle_upstream_event(pad, event)

    def update_model(self, model: Any) -> None:
        """Hot model swap without pipeline restart (is-updatable)."""
        if not self.is_updatable:
            raise RuntimeError(f"tensor_filter {self.name}: not is-updatable")
        if self.fw is None:
            self.model = model
            return
        self.fw.reload_model(model)
        self.model = model
