"""tensor_decoder subplugin API.

Reference: ``GstTensorDecoderDef`` (nnstreamer_plugin_api_decoder.h:38-97):
subplugins keyed by ``mode=`` with ``option1..optionN`` strings, an output
caps query, and a decode callback. Registered under
``SubpluginType.DECODER``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..core.buffer import Buffer, TensorMemory
from ..core.registry import SubpluginType, get_subplugin, register_subplugin
from ..core.types import Caps, TensorsConfig


class Decoder:
    """Base decoder. Subclasses set MODE and implement out_caps/decode."""

    MODE = "base"

    def __init__(self) -> None:
        self.options: Dict[int, str] = {}

    def init(self, options: Dict[int, str]) -> None:
        """option1..optionN strings (reference optionN props)."""
        self.options = options

    def option(self, n: int, default: str = "") -> str:
        return self.options.get(n, default)

    def out_caps(self, config: TensorsConfig) -> Caps:
        raise NotImplementedError

    def decode(self, buf: Buffer, config: TensorsConfig) -> Buffer:
        """Return a new Buffer whose memories hold the decoded media
        (video frame array / utf-8 text bytes / serialized blob)."""
        raise NotImplementedError

    # -- pipelined decode (tensor_decoder async_depth) ----------------------- #
    def submit(self, buf: Buffer, config: TensorsConfig) -> Any:
        """Start this frame's async work — device-side reductions and D2H
        copies — and return a token ``complete()`` turns into the decoded
        buffer N frames later. Default: prefetch the raw memories and run
        ``decode`` on host at completion. Decoders whose host output is much
        smaller than their tensor input (argmax masks, box lists) override
        this to dispatch the reduction on device and prefetch only the
        small result, so the device→host copy carries the reduced rows
        instead of the raw model output."""
        for m in buf.memories:
            m.prefetch()
        return buf

    def complete(self, token: Any, config: TensorsConfig) -> Buffer:
        """Turn a ``submit`` token into the decoded buffer."""
        return self.decode(token, config)

    def token_ready(self, token: Any) -> bool:
        """Non-blocking: True when ``complete(token)`` would not stall on a
        device→host transfer. Walks the token's TensorMemory/Buffer members
        (tuples of them are the submit-token convention). The decoder
        element drains ready frames eagerly and only blocks when the
        pipeline exceeds ``async_depth``."""
        return _ready(token)

    # -- epilogue fusion (ops/epilogue.py) ----------------------------------- #
    #: set by the epilogue fuser: the upstream filter's invoke already ran
    #: ``epilogue_reduce`` — buffers arrive carrying the reduced tensor
    _fused_epilogue = False

    def epilogue_reduce(self) -> Optional[Any]:
        """A torch ``fn(model_output_tuple) -> reduced tensor`` the
        epilogue fuser runs INSIDE the upstream filter's invoke, or None
        when this decoder has no device reduction. When fused,
        ``decode``/``submit`` receive buffers whose single memory holds the
        reduce result (``_fused_epilogue`` is set by the fuser) and must be
        bit-identical to the unfused path."""
        return None

    def fusion_signature(self) -> str:
        """Structural identity of the fused reduce: same mode+options ⇒
        same reduce function."""
        opts = ",".join(f"{k}={self.options.get(k)}"
                        for k in sorted(self.options))
        return f"{self.MODE}:{opts}"


def _ready(obj: Any) -> bool:
    if isinstance(obj, TensorMemory):
        return obj.is_ready()
    if isinstance(obj, Buffer):
        return all(m.is_ready() for m in obj.memories)
    if isinstance(obj, (tuple, list)):
        return all(_ready(v) for v in obj)
    return True


def register_decoder(cls: type) -> type:
    register_subplugin(SubpluginType.DECODER, cls.MODE, cls, replace=True)
    for alias in getattr(cls, "ALIASES", ()):
        register_subplugin(SubpluginType.DECODER, alias, cls, replace=True)
    return cls


def find_decoder(mode: str) -> Optional[type]:
    from . import _ensure_builtin_decoders

    _ensure_builtin_decoders()
    return get_subplugin(SubpluginType.DECODER, mode)
