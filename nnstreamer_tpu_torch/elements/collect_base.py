"""Shared base for N-input collecting elements (mux/merge/crop).

Owns the CollectPads lifecycle and the EOS contract: drain remaining
synchronized sets when a pad finishes, forward EOS exactly once when no
further output is possible (collector exhausted) or every pad ended.
Subclasses implement ``_emit(sets)`` and normal ``chain``/``on_caps``.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

from ..core.buffer import Buffer
from ..graph.element import Element, FlowReturn, Pad
from ..graph.events import Event, EventType
from ..graph.sync import CollectPads, SyncPolicy


class CollectingElement(Element):
    def __init__(self, name: Optional[str] = None, **props: Any):
        super().__init__(name, **props)
        self._collect: Optional[CollectPads] = None
        self._eos_sent = False

    def _make_collect(self, policy: SyncPolicy, base_key: Optional[str] = None,
                      base_duration_ns: int = 0) -> None:
        self._collect = CollectPads([p.name for p in self.sink_pads], policy,
                                    base_key=base_key,
                                    base_duration_ns=base_duration_ns)
        self._eos_sent = False

    def request_sink_pad(self) -> Pad:
        pad = super().request_sink_pad()
        if self._collect is not None:
            self._collect.add_key(pad.name)
        return pad

    def _emit(self, sets: List[Tuple[dict, Optional[int]]]) -> FlowReturn:
        raise NotImplementedError

    def chain(self, pad: Pad, buf: Buffer) -> Optional[FlowReturn]:
        return self._emit(self._collect.push(pad.name, buf))

    def _event_entry(self, pad: Pad, event: Event) -> None:
        if event.type is EventType.EOS and self._collect is not None:
            self._emit(self._collect.set_eos(pad.name))
            with self._lock:
                pad.eos = True
                self._eos_pads.add(pad.name)
                should = (self._collect.exhausted or
                          len(self._eos_pads) >= len(self.sink_pads)) \
                    and not self._eos_sent
                if should:
                    self._eos_sent = True
            if should:
                self.push_event_all(Event.eos())
            return
        super()._event_entry(pad, event)
