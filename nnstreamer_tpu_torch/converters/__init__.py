"""Converter subplugins (media → tensor): register custom converters under
SubpluginType.CONVERTER; the built-in media handlers live in
elements/converter.py.

Port of nnstreamer_tpu/converters. A custom converter is ``fn(buf, props)
-> (arrays, TensorsConfig)`` registered via ``register_converter``
(reference NNStreamerExternalConverter,
nnstreamer_plugin_api_converter.h:41-85). The wire formats (``fb_io``,
``protobuf_io``) carry their own codecs and need no package.
"""

import numpy as np

from ..core.buffer import Buffer, TensorMemory
from ..core.registry import SubpluginType, register_subplugin, unregister_subplugin


def register_converter(name: str, fn, *, replace: bool = True) -> None:
    register_subplugin(SubpluginType.CONVERTER, name, fn, replace=replace)


def unregister_converter(name: str) -> None:
    unregister_subplugin(SubpluginType.CONVERTER, name)


def payload_view(m: TensorMemory) -> np.ndarray:
    """A tensor's host bytes as a flat uint8 array, without a copy when the
    host array is already contiguous."""
    return np.ascontiguousarray(m.host()).reshape(-1).view(np.uint8)


def wire_bytes(buf: Buffer) -> bytes:
    """A wire-format buffer's bytes: its memories' host bytes, joined."""
    return b"".join(m.tobytes() for m in buf.memories)


__all__ = ["payload_view", "register_converter", "unregister_converter",
           "wire_bytes"]
