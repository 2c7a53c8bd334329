"""tensor_decoder element — tensor→media boundary, mode-dispatched.

Reference: gst/nnstreamer/elements/gsttensordec.c (subplugin dispatch by
``mode=`` :221-235, option1..option9 props).
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, Optional

from ..core.buffer import Buffer
from ..core.types import Caps, TensorsConfig
from ..decoders.base import Decoder, find_decoder
from ..graph.element import Element, FlowReturn, Pad, register_element
from ..obs import quality as _quality


@register_element
class TensorDecoder(Element):
    """``async_depth=N`` (default 0 = reference-exact synchronous decode)
    pipelines the tensor→media boundary: each arriving buffer's device
    memories start an async D2H copy immediately, and the actual decode of
    a buffer happens N frames later, when its readback has landed. Output
    order/count is unchanged; pending frames flush on EOS. This keeps up to
    N device→host transfers in flight, so the host never waits on a
    readback the device has not finished."""

    ELEMENT_NAME = "tensor_decoder"

    MAX_OPTIONS = 9

    def __init__(self, name: Optional[str] = None, **props: Any):
        self.mode: Optional[str] = None
        self.async_depth: int = 0
        for i in range(1, self.MAX_OPTIONS + 1):
            setattr(self, f"option{i}", None)
        super().__init__(name, **props)
        self.add_sink_pad(template=Caps.any_tensors())
        self.add_src_pad()
        self._decoder: Optional[Decoder] = None
        self._config: Optional[TensorsConfig] = None
        self._pending: deque = deque()

    def _options_dict(self) -> Dict[int, str]:
        return {i: str(getattr(self, f"option{i}"))
                for i in range(1, self.MAX_OPTIONS + 1)
                if getattr(self, f"option{i}") is not None}

    def start(self) -> None:
        if not self.mode:
            raise ValueError("tensor_decoder requires mode=")
        if str(self.mode).startswith("custom-script"):
            # reference python CustomDecoder contract
            # (tensordec-python3.cc; mode=custom-script:<path.py>)
            from ..converters.pyscript import ScriptDecoder

            if ":" not in str(self.mode):
                raise ValueError(
                    "tensor_decoder: mode=custom-script needs a script "
                    "path (custom-script:/path/to/decoder.py)")
            self._decoder = ScriptDecoder(str(self.mode).split(":", 1)[1])
            self._decoder.init(self._options_dict())
            return
        cls = find_decoder(self.mode)
        if cls is None:
            raise ValueError(f"tensor_decoder: unknown mode {self.mode!r}")
        self._decoder = cls()
        self._decoder.init(self._options_dict())

    def on_caps(self, pad: Pad, caps: Caps) -> None:
        if caps.media_type != "other/tensors":
            raise ValueError("tensor_decoder accepts other/tensors only")
        if self._decoder is None:
            self.start()
        self._config = caps.to_config()
        pad.caps = caps
        self.send_caps_all(self._decoder.out_caps(self._config))

    def chain(self, pad: Pad, buf: Buffer) -> Optional[FlowReturn]:
        depth = int(self.async_depth or 0)
        if depth <= 0:
            return self._emit(self._decoder.decode(buf, self._config))
        token = self._decoder.submit(buf, self._config)
        self._pending.append((token, self._config))
        ret: Optional[FlowReturn] = None
        # drain every leading frame whose readback has landed (in order,
        # non-blocking); block on the oldest only when over depth — depth
        # caps in-flight frames, readiness decides when to complete
        while self._pending and (
                len(self._pending) > depth
                or self._decoder.token_ready(self._pending[0][0])):
            token, cfg = self._pending.popleft()
            ret = self._emit(self._decoder.complete(token, cfg))
        return ret

    def _emit(self, out: Buffer) -> Optional[FlowReturn]:
        """Single exit point for decoded output — both the synchronous
        and the async-drain paths land here, so the quality tap below
        is the one and only decoder tap."""
        qhook = _quality.QUALITY_HOOK
        if qhook is not None:
            qhook.observe_decoder(self.name, out)
        return self.push(out)

    def on_eos(self) -> None:
        while self._pending:
            token, cfg = self._pending.popleft()
            self._emit(self._decoder.complete(token, cfg))

    def stop(self) -> None:
        self._pending.clear()
        super().stop()
