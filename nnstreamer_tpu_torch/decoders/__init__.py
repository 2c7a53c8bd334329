"""Decoder subplugins (tensor → media)."""

from .base import Decoder, find_decoder, register_decoder

_loaded = False


def _ensure_builtin_decoders() -> None:
    global _loaded
    if _loaded:
        return
    _loaded = True
    from . import basic  # noqa: F401
    from . import bounding_box  # noqa: F401
    from . import font  # noqa: F401
    from . import image_segment  # noqa: F401
    from . import pose  # noqa: F401
    # the wire formats carry their own codecs: registered unconditionally
    from ..converters import fb_io  # noqa: F401
    from ..converters import protobuf_io  # noqa: F401


_ensure_builtin_decoders()

__all__ = ["Decoder", "find_decoder", "register_decoder"]
