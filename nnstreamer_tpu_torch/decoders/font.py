"""font decoder — renders tensor values as text onto a video frame.

Reference: ext/nnstreamer/tensor_decoder/tensordec-font.c (renders the
tensor's textual content with a sprite font). option1 = "W:H" output size.
Input: uint8 tensor holding UTF-8 bytes (e.g. image_labeling output) or any
numeric tensor (rendered as formatted numbers).

Port of nnstreamer_tpu/decoders/font.py (host only).
"""

from __future__ import annotations

import numpy as np

from ..core.buffer import Buffer, TensorMemory
from ..core.types import Caps, TensorsConfig
from .base import Decoder, register_decoder
from .util import draw_text, new_canvas


@register_decoder
class FontDecoder(Decoder):
    MODE = "font"

    def init(self, options) -> None:
        super().init(options)
        w, h = (self.option(1, "256:64")).split(":")
        self.out_w, self.out_h = int(w), int(h)

    def out_caps(self, config: TensorsConfig) -> Caps:
        return Caps("video/x-raw", {"format": "RGBA", "width": self.out_w,
                                    "height": self.out_h,
                                    "framerate": config.rate})

    def decode(self, buf: Buffer, config: TensorsConfig) -> Buffer:
        arr = buf.memories[0].host()
        if arr.dtype == np.uint8:
            text = arr.tobytes().split(b"\x00")[0].decode("utf-8", "replace")
        else:
            vals = np.asarray(arr).reshape(-1)[:8]
            text = " ".join(f"{v:.3g}" for v in vals)
        canvas = new_canvas(self.out_w, self.out_h)
        for i, line in enumerate(text.split("\n")):
            draw_text(canvas, 2, 2 + i * 9, line)
        out = buf.with_memories([TensorMemory(canvas)])
        out.meta["text"] = text
        return out
