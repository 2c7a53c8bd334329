"""tensor_converter — the media→tensor boundary.

Reference: gst/nnstreamer/elements/gsttensor_converter.c (chain :1006,
per-media parsers :1385 video, :1480 audio, :1564 text, :1634 octet).
Accepted media types and their tensor mappings (reference dim conventions,
innermost-first):

  * video/x-raw (RGB/BGR/xRGB/.../GRAY8)  → [C:W:H:1] uint8/uint16
    (the reference strips stride-4 row padding via memcpy,
    tensor_converter.c:1050-1095; our in-memory frames are tight arrays so
    the conversion is layout-true without copies)
  * audio/x-raw                            → [C:S:1] per buffer of S samples
  * text/x-raw                             → [input-dim bytes:1] uint8, padded
  * application/octet-stream               → reinterpreted to input-dim/type
  * other/tensors,format=flexible          → static (per-buffer meta must match)

``frames-per-tensor`` batches N media frames into the outermost dimension
(tensor_converter.c frames_per_tensor regrouping).

Custom converters (registry ``SubpluginType.CONVERTER``; reference
NNStreamerExternalConverter, nnstreamer_plugin_api_converter.h:41-85)
handle any other media type: register a callable
``convert(bytes_or_array, props) -> (arrays, TensorsConfig)``.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Any, List, Optional, Tuple

import numpy as np

from ..core.buffer import Buffer, TensorMemory, concat_arrays
from ..core.meta import unwrap_flex
from ..core.registry import SubpluginType, get_subplugin
from ..core.types import (
    AUDIO_FORMATS,
    Caps,
    TensorDType,
    TensorFormat,
    TensorInfo,
    TensorsConfig,
    TensorsInfo,
    VIDEO_FORMATS,
)
from ..graph.element import Element, FlowReturn, Pad, register_element


@register_element
class TensorConverter(Element):
    ELEMENT_NAME = "tensor_converter"

    def __init__(self, name: Optional[str] = None, **props: Any):
        self.frames_per_tensor = 1
        self.input_dim: Optional[str] = None   # octet/text reinterpretation
        self.input_type: Optional[str] = None
        self.mode: Optional[str] = None        # "custom-code:<name>" etc.
        super().__init__(name, **props)
        self.add_sink_pad()
        self.add_src_pad(template=Caps.any_tensors())
        self._media: Optional[str] = None
        self._out_config: Optional[TensorsConfig] = None
        self._pending: List[Tuple[Buffer, Any]] = []
        self._custom = None
        # set by ops.epilogue: static passthrough skips the host round trip
        self._fused_passthrough = False

    # -- negotiation --------------------------------------------------------- #
    def on_caps(self, pad: Pad, caps: Caps) -> None:
        pad.caps = caps
        self._media = caps.media_type
        self._pending.clear()
        fpt = int(self.frames_per_tensor)
        if self.mode and self.mode not in ("auto",):
            # "custom:<name>", "custom-script:<path.py>" (the reference's
            # python CustomConverter contract), or a registered converter
            # subplugin name (protobuf/flexbuf/flatbuf/...)
            name = self.mode.split(":", 1)[1] if ":" in self.mode else self.mode
            if self.mode.startswith("custom-script"):
                from ..converters.pyscript import load_script_converter

                self._custom = load_script_converter(name)
            else:
                self._custom = get_subplugin(SubpluginType.CONVERTER, name)
            if self._custom is None:
                raise ValueError(f"tensor_converter: no converter subplugin "
                                 f"{name!r} (mode={self.mode!r})")
            self._out_config = None  # subplugin decides per-buffer
            return
        if self._media.startswith("other/") and self._media != "other/tensors":
            # reference auto-dispatch: other/<name> caps route to the
            # registered converter subplugin of that name (flexbuf/
            # flatbuf/protobuf boundary media)
            sub = get_subplugin(SubpluginType.CONVERTER,
                                self._media.split("/", 1)[1])
            if sub is not None:
                self._custom = sub
                self._out_config = None
                return

        rate = caps.get("framerate", Fraction(0, 1))
        if self._media == "video/x-raw":
            fmt = caps.get("format", "RGB")
            if fmt not in VIDEO_FORMATS:
                raise ValueError(f"unsupported video format {fmt!r}")
            ch, dt = VIDEO_FORMATS[fmt]
            w, h = int(caps.get("width")), int(caps.get("height"))
            info = TensorInfo.from_shape((fpt, h, w, ch), np.dtype(dt))
        elif self._media == "audio/x-raw":
            fmt = caps.get("format", "S16LE")
            if fmt not in AUDIO_FORMATS:
                raise ValueError(f"unsupported audio format {fmt!r}")
            ch = int(caps.get("channels", 1))
            # per-buffer sample count is data-driven; declared lazily on the
            # first buffer (reference: audio frames_in from buffer size)
            self._audio_meta = (np.dtype(AUDIO_FORMATS[fmt]), ch, rate)
            self._out_config = None
            return
        elif self._media == "text/x-raw":
            if not self.input_dim:
                raise ValueError("text converter requires input-dim (max bytes)")
            n = int(self.input_dim.split(":")[0])
            info = TensorInfo.from_shape((fpt, n), np.uint8)
        elif self._media == "application/octet-stream":
            if not (self.input_dim and self.input_type):
                raise ValueError("octet converter requires input-dim and input-type")
            info = TensorsInfo.from_strings(self.input_dim, self.input_type)[0]
        elif self._media == "other/tensors":
            fmt = TensorFormat.parse(caps.get("format", "flexible"))
            if fmt is TensorFormat.STATIC:
                self.send_caps_all(caps)  # passthrough
                self._out_config = caps.to_config()
                return
            self._out_config = None  # flexible: declared on first buffer
            return
        else:
            raise ValueError(f"tensor_converter: unsupported media {self._media!r}")
        self._out_config = TensorsConfig(TensorsInfo.of(info), rate)
        self._declare_rate_scaled(rate, fpt)

    def _declare_rate_scaled(self, rate: Fraction, fpt: int) -> None:
        cfg = self._out_config
        if fpt > 1 and rate and rate > 0:
            cfg = TensorsConfig(cfg.info, Fraction(rate, fpt))
            self._out_config = cfg
        self.send_caps_all(Caps.tensors(cfg))

    # -- dataflow ------------------------------------------------------------- #
    def chain(self, pad: Pad, buf: Buffer) -> Optional[FlowReturn]:
        if self._custom is not None:
            return self._chain_custom(buf)
        media = self._media
        if media == "video/x-raw":
            return self._chain_video(buf)
        if media == "audio/x-raw":
            return self._chain_audio(buf)
        if media == "text/x-raw":
            return self._chain_text(buf)
        if media == "application/octet-stream":
            return self._chain_octet(buf)
        if media == "other/tensors":
            return self._chain_tensors(buf)
        raise RuntimeError(f"converter: no caps negotiated ({media})")

    def _chain_video(self, buf: Buffer) -> Optional[FlowReturn]:
        # a frame resident on the card (videoscale's output) stays there
        m = buf.memories[0]
        frame = m.device() if m.is_device and m.device().device.type == "cuda" \
            else m.host()
        if frame.ndim == 3:
            frame = frame[None]  # (1,H,W,C): batch dim = frames-per-tensor
        fpt = int(self.frames_per_tensor)
        if fpt > 1:
            self._pending.append((buf, frame))
            if len(self._pending) < fpt:
                return FlowReturn.OK
            frames = concat_arrays([f for _, f in self._pending], axis=0)
            first = self._pending[0][0]
            self._pending.clear()
            out = first.with_memories([TensorMemory(frames)], config=self._out_config)
            return self.push(out)
        return self.push(buf.with_memories([TensorMemory(frame)],
                                           config=self._out_config))

    def _chain_audio(self, buf: Buffer) -> Optional[FlowReturn]:
        dt, ch, rate = self._audio_meta
        samples = buf.memories[0].host()
        if samples.ndim == 1:
            samples = samples.reshape(-1, ch)
        if self._out_config is None:
            info = TensorInfo.from_shape(samples.shape, dt)
            self._out_config = TensorsConfig(TensorsInfo.of(info), rate)
            self.send_caps_all(Caps.tensors(self._out_config))
        return self.push(buf.with_memories([TensorMemory(samples.astype(dt))],
                                           config=self._out_config))

    def _chain_text(self, buf: Buffer) -> Optional[FlowReturn]:
        n = int(self.input_dim.split(":")[0])
        raw = buf.memories[0].host().astype(np.uint8).reshape(-1)[:n]
        padded = np.zeros((1, n), np.uint8)
        padded[0, :raw.size] = raw
        return self.push(buf.with_memories([TensorMemory(padded)],
                                           config=self._out_config))

    def _chain_octet(self, buf: Buffer) -> Optional[FlowReturn]:
        info = self._out_config.info[0]
        raw = b"".join(m.tobytes() for m in buf.memories)
        want = info.size_bytes
        if len(raw) < want:
            return FlowReturn.OK  # partial chunk: drop (reference errors/accumulates)
        arr = np.frombuffer(raw[:want], dtype=info.dtype.np_dtype).reshape(info.shape)
        return self.push(buf.with_memories([TensorMemory(arr)],
                                           config=self._out_config))

    def _chain_tensors(self, buf: Buffer) -> Optional[FlowReturn]:
        if self._fused_passthrough and self._out_config is not None:
            # ops.epilogue enrolled this static tensors→tensors identity:
            # forward without the per-memory host round trip (the upstream
            # torch filter emits static device tensors matching caps, so
            # the flex-unwrap probe below can never apply)
            return self.push(buf.with_memories(buf.memories,
                                               config=self._out_config))
        # flexible → static: strip per-buffer flex headers if payload is raw,
        # else trust memory shapes; declare static caps from the first buffer
        mems = []
        for m in buf.memories:
            arr = m.host()
            if arr.dtype == np.uint8 and arr.ndim == 1:
                try:
                    meta, payload = unwrap_flex(arr.tobytes())
                    mems.append(TensorMemory.from_bytes(payload[:meta.info.size_bytes],
                                                        meta.info))
                    continue
                except ValueError:
                    pass
            mems.append(m)
        if self._out_config is None:
            infos = tuple(m.info for m in mems)
            self._out_config = TensorsConfig(TensorsInfo(infos))
            self.send_caps_all(Caps.tensors(self._out_config))
        else:
            want = self._out_config.info
            got = TensorsInfo(tuple(m.info for m in mems))
            if not want.is_compatible(got):
                raise ValueError(
                    f"flexible stream changed shape: {got} vs declared {want}")
        return self.push(buf.with_memories(mems, config=self._out_config))

    def _chain_custom(self, buf: Buffer) -> Optional[FlowReturn]:
        arrays, config = self._custom(buf, {"input_dim": self.input_dim,
                                            "input_type": self.input_type})
        if self._out_config is None:
            self._out_config = config
            self.send_caps_all(Caps.tensors(config))
        mems = [a if isinstance(a, TensorMemory) else TensorMemory(a) for a in arrays]
        return self.push(buf.with_memories(mems, config=self._out_config))
