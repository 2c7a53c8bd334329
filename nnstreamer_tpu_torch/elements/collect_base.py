"""Shared base for N-input collecting elements (mux/merge/crop).

Owns the CollectPads lifecycle and the EOS contract: drain remaining
synchronized sets when a pad finishes, forward EOS exactly once when no
further output is possible (collector exhausted) or every pad ended.
Subclasses implement ``_emit(sets)`` and normal ``chain``/``on_caps``.

Output order. Sets leave ``CollectPads`` on whichever pad's thread
completed them, and an EOS can arrive on another pad while a set taken
out a moment before is still on its way downstream. So every set, and
the EOS, goes into one ordered outbox in the same critical section that
took it out of ``CollectPads``; one thread at a time drains the outbox
downstream, outside every lock. So sets leave in the order they were
collected, and EOS leaves after every set handed out before it.

A thread that finds a drain under way leaves its sets to the drainer.
While the outbox holds no more than one set per sink pad it returns at
once, so no pad's thread waits on another's downstream push for a set of
its own (a loop's state pad cannot be wedged behind a blocked ``queue``:
a loop completes its next set only after the last one left). Past that
bound it waits until the drainer has pushed the outbox back under it,
which keeps the backpressure of a blocked downstream on every pad (under
``sync_mode=refresh`` every arrival makes a set). The drainer's own
thread never waits, should a downstream push come back into this element.
``chain`` returns the flow of the newest push downstream.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, List, Optional, Tuple

from ..core.buffer import Buffer
from ..graph.element import Element, FlowReturn, Pad
from ..graph.events import Event, EventType
from ..graph.sync import CollectPads, SyncPolicy

_EOS = object()  # outbox marker: forward EOS at this point of the order


class CollectingElement(Element):
    def __init__(self, name: Optional[str] = None, **props: Any):
        super().__init__(name, **props)
        self._collect: Optional[CollectPads] = None
        self._eos_sent = False
        self._out_lock = threading.Condition()
        self._outbox: collections.deque = collections.deque()
        self._drainer: Optional[int] = None  # the draining thread's ident
        self._flow = FlowReturn.OK

    def _make_collect(self, policy: SyncPolicy, base_key: Optional[str] = None,
                      base_duration_ns: int = 0) -> None:
        self._collect = CollectPads([p.name for p in self.sink_pads], policy,
                                    base_key=base_key,
                                    base_duration_ns=base_duration_ns)
        with self._out_lock:
            self._eos_sent = False
            self._outbox.clear()
            self._flow = FlowReturn.OK

    def request_sink_pad(self) -> Pad:
        pad = super().request_sink_pad()
        if self._collect is not None:
            self._collect.add_key(pad.name)
        return pad

    def _emit(self, sets: List[Tuple[dict, Optional[int]]]) -> FlowReturn:
        raise NotImplementedError

    def _drain(self) -> FlowReturn:
        """Push the outbox downstream in order, unless another thread is
        already doing so: that thread pushes what was added here too, and
        this one waits only while the outbox is over its bound."""
        me = threading.get_ident()
        with self._out_lock:
            while self._drainer is not None:
                if self._drainer == me or \
                        len(self._outbox) <= max(1, len(self.sink_pads)):
                    return self._flow
                self._out_lock.wait()
            self._drainer = me
        try:
            while True:
                with self._out_lock:
                    if not self._outbox:
                        self._drainer = None
                        self._out_lock.notify_all()
                        return self._flow
                    item = self._outbox.popleft()
                    self._out_lock.notify_all()
                if item is _EOS:
                    self.push_event_all(Event.eos())
                else:
                    self._flow = self._emit([item])
        except BaseException:
            with self._out_lock:
                self._drainer = None
                self._out_lock.notify_all()
            raise

    def chain(self, pad: Pad, buf: Buffer) -> Optional[FlowReturn]:
        with self._out_lock:
            self._outbox.extend(self._collect.push(pad.name, buf))
        return self._drain()

    def _event_entry(self, pad: Pad, event: Event) -> None:
        if event.type is EventType.EOS and self._collect is not None:
            with self._out_lock:
                self._outbox.extend(self._collect.set_eos(pad.name))
                with self._lock:
                    pad.eos = True
                    self._eos_pads.add(pad.name)
                if (self._collect.exhausted or
                        len(self._eos_pads) >= len(self.sink_pads)) \
                        and not self._eos_sent:
                    self._eos_sent = True
                    self._outbox.append(_EOS)
            self._drain()
            return
        super()._event_entry(pad, event)
