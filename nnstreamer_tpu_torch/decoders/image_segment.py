"""image_segment decoder — per-pixel class masks → RGBA overlay.

Reference: ext/nnstreamer/tensor_decoder/tensordec-imagesegment.c (schemes
:105-126: tflite-deeplab, snpe-deeplab, snpe-depth). option1 = scheme.

tflite-deeplab: input [classes:W:H:1] float → argmax over classes → per-class
color. snpe-deeplab: input already argmaxed [W:H:1]. snpe-depth: depth map
[1:W:H] → grayscale.

Port of nnstreamer_tpu/decoders/image_segment.py. The two deeplab schemes
run argmax + palette lookup on the card through the hand-written CUDA
``segment_colorize`` (ops/kernels): fused into the filter's invoke
(``epilogue_reduce``), or in the decoder, at any ``async_depth``, when it
receives device-resident logits unfused (e.g. after ``tensor_unbatch``).
snpe-depth, and tensors that arrive on the host, decode on the host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.buffer import Buffer, TensorMemory
from ..core.types import Caps, TensorsConfig
from ..obs import profile as _profile
from ..ops.kernels import epilogue as _ep
from .base import Decoder, register_decoder

# 21-class PASCAL VOC palette (RGBA), class 0 = background transparent
_PALETTE = np.zeros((256, 4), np.uint8)
for i in range(1, 256):
    c = np.zeros(3, np.uint8)
    cid, shift = i, 7
    while cid:
        c[0] |= ((cid >> 0) & 1) << shift
        c[1] |= ((cid >> 1) & 1) << shift
        c[2] |= ((cid >> 2) & 1) << shift
        cid >>= 3
        shift -= 1
    _PALETTE[i, :3] = c
    _PALETTE[i, 3] = 160


@register_decoder
class ImageSegment(Decoder):
    MODE = "image_segment"

    def init(self, options) -> None:
        super().init(options)
        self.scheme = self.option(1, "tflite-deeplab").lower()
        #: the palette on the device of the first input the kernel colorizes
        self._palette: Optional[torch.Tensor] = None

    def _hw(self, config: TensorsConfig):
        shape = config.info[0].shape  # row-major
        if self.scheme == "tflite-deeplab":
            # dims [classes:W:H:1] → shape (1,H,W,classes)
            return shape[-3], shape[-2]
        return shape[-3], shape[-2] if len(shape) >= 3 else shape

    def out_caps(self, config: TensorsConfig) -> Caps:
        h, w = self._hw(config)
        return Caps("video/x-raw", {"format": "RGBA", "width": w, "height": h,
                                    "framerate": config.rate})

    def _palette_on(self, device: torch.device) -> torch.Tensor:
        if self._palette is None:
            self._palette = torch.from_numpy(_PALETTE).to(device)
        return self._palette

    def _colorize_fn(self):
        """torch fn: logits/class-ids → (H, W, 4) RGBA canvas on the
        tensor's device (ops.kernels.epilogue.segment_colorize), or None
        for host-only schemes (snpe-depth's min/max normalize is
        data-dependent)."""
        if self.scheme not in ("tflite-deeplab", "snpe-deeplab"):
            return None
        pre_argmaxed = self.scheme == "snpe-deeplab"

        def fn(x):
            if pre_argmaxed:
                x = x.squeeze()
            elif x.dim() == 4:
                x = x[0]
            return _ep.segment_colorize(x, self._palette_on(x.device),
                                        pre_argmaxed=pre_argmaxed)

        return fn

    def epilogue_reduce(self):
        fn = self._colorize_fn()
        return None if fn is None else (lambda outs: fn(outs[0]))

    def submit(self, buf: Buffer, config: TensorsConfig):
        m = buf.memories[0]
        if self._fused_epilogue:
            # upstream filter already ran argmax+colorize: memories[0]
            # holds the RGBA canvas — keep the D2H in flight
            m.prefetch()
            return (buf, m)
        if m.is_device:
            # argmax + palette on device: D2H ships the H*W*4 uint8
            # canvas, not the H*W*classes float logits, and the per-pixel
            # host NumPy gather disappears from the frame loop
            fn = self._colorize_fn()
            if fn is not None:
                prof = _profile.DISPATCH_HOOK
                with torch.inference_mode():
                    out = prof.dispatch_fn(f"decode:{self.scheme}", fn,
                                           m.device()) \
                        if prof is not None else fn(m.device())
                canvas_mem = TensorMemory(out)
                canvas_mem.prefetch()
                return (buf, canvas_mem)
        return super().submit(buf, config)

    def complete(self, token, config: TensorsConfig) -> Buffer:
        if isinstance(token, tuple):
            buf, mem = token
            canvas = np.asarray(mem.host())
            if canvas.ndim == 4:
                canvas = canvas[0]
            return buf.with_memories([TensorMemory(np.ascontiguousarray(canvas))])
        return self.decode(token, config)

    def decode(self, buf: Buffer, config: TensorsConfig) -> Buffer:
        if not self._fused_epilogue and buf.memories[0].is_device \
                and self._colorize_fn() is not None:
            # unfused device logits (e.g. after tensor_unbatch) at async
            # depth 0: colorize on the device as submit does, rather than
            # copying the logits back for a host argmax (same canvas)
            return self.complete(self.submit(buf, config), config)
        arr = buf.memories[0].host()
        if self._fused_epilogue:
            canvas = np.asarray(arr)
            if canvas.ndim == 4:
                canvas = canvas[0]
            return buf.with_memories(
                [TensorMemory(np.ascontiguousarray(canvas))])
        if self.scheme == "tflite-deeplab":
            if arr.ndim == 4:
                arr = arr[0]
            classes = np.argmax(arr, axis=-1).astype(np.uint8)  # (H,W)
            canvas = _PALETTE[classes]
        elif self.scheme == "snpe-deeplab":
            classes = np.squeeze(arr).astype(np.uint8)
            canvas = _PALETTE[classes]
        elif self.scheme == "snpe-depth":
            depth = np.squeeze(arr).astype(np.float32)
            lo, hi = float(depth.min()), float(depth.max())
            g = ((depth - lo) / (hi - lo + 1e-9) * 255).astype(np.uint8)
            canvas = np.stack([g, g, g, np.full_like(g, 255)], axis=-1)
        else:
            raise ValueError(f"image_segment: unknown scheme {self.scheme!r}")
        return buf.with_memories([TensorMemory(np.ascontiguousarray(canvas))])
