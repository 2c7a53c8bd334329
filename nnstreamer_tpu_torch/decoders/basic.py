"""Basic decoders: direct_video, image_labeling, flex.

References: tensordec-directvideo.c, tensordec-imagelabel.c,
tensordec-flexbuf.cc. Port of nnstreamer_tpu/decoders/basic.py."""

from __future__ import annotations

import numpy as np
import torch

from ..core.buffer import Buffer, TensorMemory
from ..core.meta import wrap_flex
from ..core.types import Caps, TensorsConfig
from .base import Decoder, register_decoder
from .util import load_labels


@register_decoder
class DirectVideo(Decoder):
    """tensor [C:W:H:1] (C∈{1,3,4}) → video/x-raw frame (passthrough view)."""

    MODE = "direct_video"

    _FMT = {1: "GRAY8", 3: "RGB", 4: "RGBA"}

    def out_caps(self, config: TensorsConfig) -> Caps:
        shape = config.info[0].shape  # (N,H,W,C)
        if len(shape) != 4 or shape[-1] not in self._FMT:
            raise ValueError(f"direct_video: bad tensor shape {shape}")
        return Caps("video/x-raw", {"format": self._FMT[shape[-1]],
                                    "width": shape[2], "height": shape[1],
                                    "framerate": config.rate})

    def decode(self, buf: Buffer, config: TensorsConfig) -> Buffer:
        arr = buf.memories[0].host()
        if arr.ndim == 4:
            arr = arr[0]
        return buf.with_memories([TensorMemory(np.ascontiguousarray(arr, np.uint8))])


@register_decoder
class ImageLabeling(Decoder):
    """scores tensor → text/x-raw best label (tensordec-imagelabel.c):
    option1 = label file."""

    MODE = "image_labeling"

    def init(self, options) -> None:
        super().init(options)
        self.labels = load_labels(self.option(1))

    def out_caps(self, config: TensorsConfig) -> Caps:
        return Caps("text/x-raw", {"format": "utf8"})

    @staticmethod
    def _rows(arr):
        """Scores as (frames, classes): a batched tensor (converter
        frames-per-tensor regrouping) yields one label per frame."""
        return arr.reshape(-1) if arr.ndim <= 1 or arr.shape[0] == 1 \
            else arr.reshape(arr.shape[0], -1)

    def decode(self, buf: Buffer, config: TensorsConfig) -> Buffer:
        m = buf.memories[0]
        if m.is_device and not m.prefetched:
            # argmax on device: D2H transfers 2 scalars per frame, not the
            # logits; (argmax, max) come back as one stacked tensor
            rows = self._rows(m.device())
            pairs = torch.stack(
                [rows.argmax(dim=-1).to(torch.float32).reshape(-1),
                 rows.amax(dim=-1).to(torch.float32).reshape(-1)],
                dim=1).cpu().numpy()
        else:
            rows = np.atleast_2d(self._rows(m.host()))
            idxs = np.argmax(rows, axis=-1)
            pairs = np.stack(
                [idxs.astype(np.float32),
                 rows[np.arange(len(rows)), idxs].astype(np.float32)], axis=1)
        names = [self.labels[int(i)] if int(i) < len(self.labels) else str(int(i))
                 for i, _ in pairs]
        label, idx, top = names[0], int(pairs[0][0]), float(pairs[0][1])
        out = buf.with_memories(
            [TensorMemory(np.frombuffer("\n".join(names).encode("utf-8"),
                                        np.uint8).copy())])
        out.meta.update(label=label, label_index=idx, label_score=top)
        if len(names) > 1:
            out.meta.update(labels=names,
                            label_indices=[int(i) for i, _ in pairs],
                            label_scores=[float(s) for _, s in pairs])
        return out


@register_decoder
class FlexBuf(Decoder):
    """tensors → self-describing flex blobs using our native 128-byte meta
    header wire format (the query/edge links' framing). For reference-style
    FlexBuffers/FlatBuffers interop blobs use mode=flexbuf / mode=flatbuf
    (converters/fb_io.py)."""

    MODE = "flex"

    def out_caps(self, config: TensorsConfig) -> Caps:
        return Caps("application/octet-stream")

    def decode(self, buf: Buffer, config: TensorsConfig) -> Buffer:
        blobs = [np.frombuffer(wrap_flex(m.tobytes(), m.info), np.uint8).copy()
                 for m in buf.memories]
        return buf.with_memories([TensorMemory(b) for b in blobs])
