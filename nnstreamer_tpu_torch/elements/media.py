"""Media elements: image file sources, image decoders, imagefreeze,
videoscale, videoconvert and audioconvert.

Port of nnstreamer_tpu/elements/media.py, the GStreamer media elements the
reference's test pipelines lean on (multifilesrc/pngdec/jpegdec,
videoscale, videoconvert). Decoding stays on the host with Pillow, as in the
JAX package; Pillow is imported when a frame is decoded, and only there.

``videoscale`` is Pillow's BILINEAR resize computed by ops/resample.py with
torch integer ops, byte for byte, on the pipeline's device (cuda unless
the pipeline says otherwise): on the card a host frame is copied up once
through a pinned staging buffer and scaled there, and the scaled frame stays
on the card for tensor_converter and the filter; a frame already on the card
is scaled where it lies; on a CPU pipeline the frame is scaled on the host
and stays a numpy array. A frame Pillow cannot make an image of (an (H, W,
1) GRAY8 frame, a non-uint8 one) raises, as the JAX element does.

``videoconvert`` and ``audioconvert`` keep the JAX arithmetic: a host array
is converted with numpy as there, a tensor with the same float64 operations
in torch on its own device.
"""

from __future__ import annotations

import glob as _glob
import io
import os
from fractions import Fraction
from typing import Any, List, Optional

import numpy as np
import torch

from ..core.buffer import Buffer, TensorMemory, NS_PER_SEC
from ..core.hw import resolve_device
from ..core.log import logger
from ..core.types import AUDIO_FORMATS, Caps, VIDEO_FORMATS
from ..graph.element import Element, FlowReturn, Pad, register_element
from ..graph.pipeline import SourceElement
from ..ops import resample

log = logger("media")


def _pillow() -> Any:
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("decoding images needs Pillow (the PIL package), "
                          "which is not installed") from e
    return Image


def _decode_image(data: bytes, fmt: str) -> np.ndarray:
    img = _pillow().open(io.BytesIO(data))
    mode = {"RGB": "RGB", "RGBA": "RGBA", "GRAY8": "L"}.get(fmt, "RGB")
    return np.asarray(img.convert(mode))


def _resident(m: TensorMemory) -> Any:
    """A memory's tensor where it is resident, else its host array."""
    return m.device() if m.is_device else m.host()


@register_element
class ImageFileSrc(SourceElement):
    """Reads image files (glob pattern) → video/x-raw frames.

    multifilesrc+pngdec equivalent: ``imagefilesrc location="imgs/*.png"
    framerate=30 loop=false``.
    """

    ELEMENT_NAME = "imagefilesrc"

    def __init__(self, name: Optional[str] = None, **props: Any):
        self.location: Optional[str] = None
        self.format = "RGB"
        self.framerate: Any = 30
        self.loop = False
        super().__init__(name, **props)
        self._files: List[str] = []
        self._idx = 0
        self._size = None

    def negotiate(self) -> Caps:
        if not self.location:
            raise ValueError("imagefilesrc requires location")
        self._files = sorted(_glob.glob(self.location)) \
            if any(c in self.location for c in "*?[") else [self.location]
        if not self._files:
            raise FileNotFoundError(f"no images match {self.location!r}")
        self._idx = 0
        with open(self._files[0], "rb") as f:
            first = _decode_image(f.read(), self.format)
        self._size = first.shape
        h, w = first.shape[:2]
        return Caps("video/x-raw", {"format": self.format, "width": w,
                                    "height": h,
                                    "framerate": Fraction(self.framerate)})

    def create(self) -> Optional[Buffer]:
        if self._idx >= len(self._files):
            if not self.loop:
                return None
            self._idx = 0
        with open(self._files[self._idx], "rb") as f:
            frame = _decode_image(f.read(), self.format)
        if frame.shape != self._size:
            raise ValueError(
                f"image {self._files[self._idx]} shape {frame.shape} != "
                f"first image {self._size}")
        rate = Fraction(self.framerate)
        dur = int(NS_PER_SEC / rate) if rate > 0 else None
        buf = Buffer.of(frame, pts=(self._idx * dur if dur else self._idx),
                        duration=dur)
        buf.offset = self._idx
        self._idx += 1
        return buf


@register_element
class MultiFileSrc(SourceElement):
    """gst multifilesrc: reads ``location`` as a printf pattern
    (``testsequence_%1d.png``) starting at ``index``, one whole encoded
    file per buffer (pair with ``pngdec``/``jpegdec`` downstream). ``caps``
    is the declared stream caps string; its framerate drives the
    synthesized pts."""

    ELEMENT_NAME = "multifilesrc"

    def __init__(self, name: Optional[str] = None, **props: Any):
        self.location: Optional[str] = None
        self.index = 0
        self.stop_index = -1      # -1: until the first missing file
        self.caps: Optional[str] = None
        super().__init__(name, **props)
        self._idx = 0
        self._rate = Fraction(30, 1)

    def negotiate(self) -> Caps:
        if not self.location or "%" not in self.location:
            raise ValueError(
                "multifilesrc needs a printf-style location pattern")
        self._idx = int(self.index)
        media = "application/octet-stream"
        if self.caps:
            from ..graph.parse import parse_caps_string

            parsed = parse_caps_string(str(self.caps))
            media = parsed.media_type
            rate = parsed.fields.get("framerate")
            if rate is not None:  # 0/1 (still image) is meaningful
                self._rate = Fraction(rate)
        return Caps(media)

    def create(self) -> Optional[Buffer]:
        if self.stop_index >= 0 and self._idx > int(self.stop_index):
            return None
        path = self.location % self._idx
        if not os.path.isfile(path):
            return None  # first gap ends the stream (gst EOS behavior)
        with open(path, "rb") as f:
            data = np.frombuffer(f.read(), np.uint8)
        dur = int(NS_PER_SEC / self._rate) if self._rate > 0 else None
        buf = Buffer.of(data, pts=((self._idx - int(self.index)) * dur
                                   if dur else self._idx),
                        duration=dur)
        buf.offset = self._idx
        self._idx += 1
        return buf


@register_element
class ImageDec(Element):
    """Decodes encoded image bytes (PNG/JPEG/...) → video/x-raw
    (pngdec/jpegdec equivalent; upstream may deliver a file in chunks)."""

    ELEMENT_NAME = "imagedec"

    def __init__(self, name: Optional[str] = None, **props: Any):
        self.format = "RGB"
        super().__init__(name, **props)
        self.add_sink_pad()
        self.add_src_pad()
        self._caps_sent = False
        self._acc = bytearray()
        self._decode_err: Optional[Exception] = None
        self._marker_seen = False
        self._fail_attempts = 0
        self._decoded_any = False

    def on_caps(self, pad: Pad, caps: Caps) -> None:
        pad.caps = caps
        self._caps_sent = False  # actual size known at first frame
        self._acc = bytearray()
        self._decode_err = None
        self._marker_seen = False
        self._fail_attempts = 0
        self._decoded_any = False

    def chain(self, pad: Pad, buf: Buffer) -> Optional[FlowReturn]:
        # accumulate chunks until a complete image decodes (filesrc !
        # pngdec), as gst's pngdec buffers
        prev_len = len(self._acc)
        for m in buf.memories:
            self._acc += m.tobytes()
        # no decode attempt while a PNG/JPEG visibly lacks its end marker
        # (IEND/EOI): searched incrementally over each new chunk with an
        # 8-byte overlap, anywhere in the stream, so trailing padding after
        # the marker still decodes
        head = bytes(self._acc[:4])
        if not self._marker_seen:
            window = bytes(self._acc[max(0, prev_len - 8):])
            if head.startswith(b"\x89PNG"):
                self._marker_seen = b"IEND" in window
            elif head.startswith(b"\xff\xd8"):
                self._marker_seen = b"\xff\xd9" in window
            else:
                self._marker_seen = True  # unknown codec: just try
        if not self._marker_seen:
            return FlowReturn.OK
        _pillow()
        try:
            frame = _decode_image(bytes(self._acc), self.format)
        except Exception as e:  # noqa: BLE001
            # a marker hit does not prove completeness (an EXIF thumbnail's
            # early EOI, 'IEND' by chance in IDAT): keep accumulating and
            # re-arm the scan, but bounded, so a corrupt frame in a live
            # stream fails instead of swallowing every frame behind it
            self._decode_err = e
            if head.startswith((b"\x89PNG", b"\xff\xd8")):
                # only marker-confirmed attempts count toward the bound
                self._fail_attempts += 1
                if self._fail_attempts >= 8:
                    raise ValueError(
                        f"{self.name}: {self._fail_attempts} decode "
                        f"attempts failed on accumulated data — corrupt "
                        f"stream ({e})") from e
            self._marker_seen = False
            return FlowReturn.OK
        self._acc = bytearray()
        self._decode_err = None
        self._marker_seen = False
        self._fail_attempts = 0
        self._decoded_any = True
        if not self._caps_sent:
            self._caps_sent = True
            h, w = frame.shape[:2]
            self.send_caps_all(Caps("video/x-raw",
                                    {"format": self.format, "width": w,
                                     "height": h,
                                     "framerate": Fraction(0, 1)}))
        return self.push(buf.with_memories([TensorMemory(frame)]))

    def on_eos(self) -> None:
        if self._acc:
            head = bytes(self._acc[:4])
            known = head.startswith((b"\x89PNG", b"\xff\xd8"))
            looks_like_padding = set(self._acc) <= {0x00, 0xFF}
            if self._decoded_any and not known and looks_like_padding:
                # constant-byte filler after a decoded frame: dropped with
                # a warning; anything structured still raises below
                log.warning("%s: dropping %d trailing non-image bytes at EOS",
                            self.name, len(self._acc))
                self._acc = bytearray()
                super().on_eos()
                return
            err = self._decode_err
            raise ValueError(
                f"{self.name}: stream ended with {len(self._acc)} bytes of "
                f"undecodable image data"
                + (f" (last decode error: {err})" if err else "")) from err
        super().on_eos()


@register_element
class PngDec(ImageDec):
    """gst pngdec name for the image decoder (Pillow decodes by content)."""

    ELEMENT_NAME = "pngdec"


@register_element
class JpegDec(ImageDec):
    """gst jpegdec name (same decoder)."""

    ELEMENT_NAME = "jpegdec"


@register_element
class ImageFreeze(Element):
    """Repeats the first frame as a video stream (gst imagefreeze).
    gst repeats it forever; here ``num_buffers`` (default 1) frames are sent
    so an in-process pipeline reaches EOS, as in the JAX package."""

    ELEMENT_NAME = "imagefreeze"

    def __init__(self, name: Optional[str] = None, **props: Any):
        self.num_buffers = 1
        self.framerate = 30
        super().__init__(name, **props)
        self.add_sink_pad()
        self.add_src_pad()
        self._frozen = False

    def on_caps(self, pad: Pad, caps: Caps) -> None:
        pad.caps = caps
        self.send_caps_all(caps)

    def chain(self, pad: Pad, buf: Buffer) -> Optional[FlowReturn]:
        if self._frozen:
            return FlowReturn.OK  # gst semantics: freeze the first frame
        self._frozen = True
        rate = Fraction(str(self.framerate))  # accepts 30, "30", "30/1"
        dur = int(NS_PER_SEC / rate) if rate else NS_PER_SEC // 30
        for i in range(int(self.num_buffers)):
            out = buf.with_memories(list(buf.memories))
            out.pts = i * dur
            out.duration = dur
            out.offset = i
            ret = self.push(out)
            if ret not in (None, FlowReturn.OK):
                return ret
        return FlowReturn.OK


@register_element
class VideoScale(Element):
    """Resize to width×height: Pillow's BILINEAR, byte for byte
    (ops/resample.py), on the pipeline's device (see the module docstring).
    ``bytes_up`` counts the host bytes it copied to the card."""

    ELEMENT_NAME = "videoscale"

    def __init__(self, name: Optional[str] = None, **props: Any):
        self.width = 0
        self.height = 0
        super().__init__(name, **props)
        self.add_sink_pad()
        self.add_src_pad()
        self._device: Any = None  # the pipeline's device; None → cuda
        self._dev: Optional[torch.device] = None  # resolved at start
        self._staging: Optional[torch.Tensor] = None
        self._staged: Any = None  # event: the last copy out of staging done
        self.bytes_up = 0

    def set_default_device(self, device: Any) -> None:
        self._device = device

    def start(self) -> None:
        self._dev = resolve_device(self._device)
        self.bytes_up = 0

    def on_caps(self, pad: Pad, caps: Caps) -> None:
        if caps.media_type != "video/x-raw":
            raise ValueError("videoscale accepts video/x-raw")
        pad.caps = caps
        if bool(self.width) != bool(self.height):
            raise ValueError(
                "videoscale needs BOTH width and height (or neither "
                "for passthrough)")
        if not (self.width and self.height):
            # no target size: passthrough (gst videoscale with no
            # downstream size constraint does not resample either)
            self.send_caps_all(caps)
            return
        self.send_caps_all(caps.with_fields(width=int(self.width),
                                            height=int(self.height)))

    def _upload(self, frame: np.ndarray) -> torch.Tensor:
        """``frame`` on the card, copied once through pinned staging."""
        frame = np.ascontiguousarray(frame)
        st = self._staging
        if st is None or tuple(st.shape) != frame.shape:
            st = self._staging = torch.empty(frame.shape, dtype=torch.uint8,
                                             pin_memory=True)
        elif self._staged is not None:
            self._staged.synchronize()  # the previous frame left staging
        st.numpy()[...] = frame
        out = st.to(self._dev, non_blocking=True)
        self._staged = torch.cuda.Event()
        self._staged.record(torch.cuda.current_stream(self._dev))
        self.bytes_up += frame.nbytes
        return out

    def chain(self, pad: Pad, buf: Buffer) -> Optional[FlowReturn]:
        if not (self.width and self.height):
            return self.push(buf)
        w, h = int(self.width), int(self.height)
        m = buf.memories[0]
        if m.is_device and m.device().device.type == "cuda":
            out: Any = resample.resize(m.device(), w, h)
        else:
            frame = m.host()
            resample.check_frame(frame.shape, frame.dtype.name)
            if self._dev.type == "cuda":
                out = resample.resize(self._upload(frame), w, h)
            else:
                out = resample.resize(torch.from_numpy(np.require(frame, requirements="CW")),
                                      w, h).numpy()
        return self.push(buf.with_memories([TensorMemory(out)]))


def _audio_convert(samples: Any, src_dt: np.dtype, dst_dt: np.dtype) -> Any:
    """The JAX element's conversion: through [-1, 1) float64, scaled by
    max + 1 with rounding half to even (gst's shift semantics int → int,
    exact int → float → int round trips). numpy for a host array, torch on
    its device for a tensor."""
    if isinstance(samples, torch.Tensor):
        dev = samples.device
        f64 = samples.to(torch.float64)

        def div(x: torch.Tensor, d: float) -> torch.Tensor:
            return x / torch.full((), d, dtype=torch.float64, device=dev)

        if src_dt.kind == "i":
            norm = div(f64, float(np.iinfo(src_dt).max + 1))
        elif src_dt.kind == "u":
            mid = (np.iinfo(src_dt).max + 1) / 2.0
            norm = div(f64 - mid, mid)
        else:
            norm = f64
        dst = getattr(torch, dst_dt.name)
        if dst_dt.kind == "i":
            info = np.iinfo(dst_dt)
            out = torch.round(torch.clamp(norm, -1.0, 1.0) * (info.max + 1.0))
            return torch.clamp(out, info.min, info.max).to(dst)
        if dst_dt.kind == "u":
            info = np.iinfo(dst_dt)
            mid = (info.max + 1) / 2.0
            out = torch.round(torch.clamp(norm, -1.0, 1.0) * mid + mid)
            return torch.clamp(out, 0, info.max).to(dst)
        return norm.to(dst)
    if src_dt.kind == "i":
        norm = samples.astype(np.float64) / float(np.iinfo(src_dt).max + 1)
    elif src_dt.kind == "u":
        mid = (np.iinfo(src_dt).max + 1) / 2.0
        norm = (samples.astype(np.float64) - mid) / mid
    else:
        norm = samples.astype(np.float64)
    if dst_dt.kind == "i":
        info = np.iinfo(dst_dt)
        out = np.rint(np.clip(norm, -1.0, 1.0) * (info.max + 1.0))
        return np.clip(out, info.min, info.max).astype(dst_dt)
    if dst_dt.kind == "u":
        info = np.iinfo(dst_dt)
        mid = (info.max + 1) / 2.0
        out = np.rint(np.clip(norm, -1.0, 1.0) * mid + mid)
        return np.clip(out, 0, info.max).astype(dst_dt)
    return norm.astype(dst_dt)


@register_element
class AudioConvert(Element):
    """Sample-format conversion among S8/U8/S16LE/S32LE/F32LE/F64LE (gst
    audioconvert). ``format=`` picks the output (also settable by a
    following caps filter); passthrough when formats match. Int samples
    normalize through [-1, 1) float the way gst does (S16 -> F32 is
    x/32768; F32 -> S16 clips then scales by 32768 with rounding)."""

    ELEMENT_NAME = "audioconvert"

    def __init__(self, name: Optional[str] = None, **props: Any):
        self.format: Optional[str] = None  # None: passthrough
        super().__init__(name, **props)
        self.add_sink_pad()
        self.add_src_pad()
        self._in_fmt = "S16LE"

    def on_caps(self, pad: Pad, caps: Caps) -> None:
        if caps.media_type != "audio/x-raw":
            raise ValueError("audioconvert accepts audio/x-raw")
        self._in_fmt = caps.get("format", "S16LE")
        if self._in_fmt not in AUDIO_FORMATS:
            raise ValueError(
                f"audioconvert: unsupported input format {self._in_fmt!r}")
        out_fmt = self.format or self._in_fmt
        if out_fmt not in AUDIO_FORMATS:
            raise ValueError(f"audioconvert: unknown format {out_fmt!r}")
        pad.caps = caps
        self.send_caps_all(caps.with_fields(format=out_fmt))

    def chain(self, pad: Pad, buf: Buffer) -> Optional[FlowReturn]:
        out_fmt = self.format or self._in_fmt
        if out_fmt == self._in_fmt:
            return self.push(buf)
        out = _audio_convert(_resident(buf.memories[0]),
                             np.dtype(AUDIO_FORMATS[self._in_fmt]),
                             np.dtype(AUDIO_FORMATS[out_fmt]))
        return self.push(buf.with_memories([TensorMemory(out)]))


@register_element
class VideoConvert(Element):
    """Pixel-format conversion among RGB/RGBA/BGR/GRAY8 (videoconvert
    equivalent). ``format=`` picks the output."""

    ELEMENT_NAME = "videoconvert"

    def __init__(self, name: Optional[str] = None, **props: Any):
        self.format = "RGB"
        super().__init__(name, **props)
        self.add_sink_pad()
        self.add_src_pad()
        self._in_fmt = "RGB"

    def on_caps(self, pad: Pad, caps: Caps) -> None:
        if caps.media_type != "video/x-raw":
            raise ValueError("videoconvert accepts video/x-raw")
        self._in_fmt = caps.get("format", "RGB")
        if self.format not in VIDEO_FORMATS:
            raise ValueError(f"unsupported output format {self.format!r}")
        pad.caps = caps
        self.send_caps_all(caps.with_fields(format=self.format))

    def chain(self, pad: Pad, buf: Buffer) -> Optional[FlowReturn]:
        out = convert_pixels(_resident(buf.memories[0]), self._in_fmt,
                             self.format)
        return self.push(buf.with_memories([TensorMemory(out)]))


def convert_pixels(frame: Any, src: str, dst: str) -> Any:
    """The JAX element's ``_convert_pixels`` on a host array (numpy) or a
    tensor (torch, on its device): channel swizzles, an opaque alpha, and
    GRAY8 as 0.299·R + 0.587·G + 0.114·B in float64, added left to right
    and truncated."""
    if src == dst:
        return frame
    is_t = isinstance(frame, torch.Tensor)

    def cat(parts: List[Any]) -> Any:
        return torch.cat(parts, dim=-1) if is_t else np.concatenate(parts, axis=-1)

    def opaque(rgb: Any) -> Any:
        shape = tuple(rgb.shape[:-1]) + (1,)
        return (torch.full(shape, 255, dtype=torch.uint8, device=rgb.device)
                if is_t else np.full(shape, 255, np.uint8))

    def contiguous(x: Any) -> Any:
        return x.contiguous() if is_t else np.ascontiguousarray(x)

    # normalize to RGB(A)
    if src.startswith("BGR"):
        rgb = frame[..., [2, 1, 0]]
    elif src == "GRAY8":
        g = frame[..., :1] if frame.ndim == 3 else frame[..., None]
        rgb = g.repeat_interleave(3, dim=-1) if is_t else np.repeat(g, 3, axis=-1)
    else:
        rgb = frame[..., :3]
    if dst == "RGB":
        return contiguous(rgb)
    if dst == "BGR":
        return contiguous(rgb[..., [2, 1, 0]])
    if dst in ("RGBA", "RGBx"):
        return cat([rgb, opaque(rgb)])
    if dst in ("BGRA", "BGRx"):
        return cat([rgb[..., [2, 1, 0]], opaque(rgb)])
    if dst == "GRAY8":
        if is_t:
            r, g, b = (rgb[..., i].to(torch.float64) for i in range(3))
            return (r * 0.299 + g * 0.587 + b * 0.114).to(torch.uint8)[..., None]
        g = (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2])
        return g.astype(np.uint8)[..., None]
    raise ValueError(f"unsupported conversion {src}->{dst}")
