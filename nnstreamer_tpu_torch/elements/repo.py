"""tensor_reposink / tensor_reposrc — in-process slot table for pipeline
loops (recurrence).

Reference: gst/nnstreamer/elements/gsttensor_repo*.c + tensor_repo.h:40-60:
a global slot table with cond-var handshake lets DAG pipelines express
cycles (RNN/LSTM state feedback; tests/nnstreamer_repo_lstm). reposink
writes ``slot-index``; reposrc reads it, emitting an initial dummy frame to
break the chicken-and-egg at loop start.

Port of nnstreamer_tpu/elements/repo.py. A slot hands over the buffer
itself: tensors on the card stay there around the loop (reposink →
reposrc), and only the host zeros of the bootstrap frame are copied up.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

import numpy as np

from ..core.buffer import Buffer, TensorMemory
from ..core.types import Caps, TensorsConfig, TensorsInfo
from ..graph.element import Element, FlowReturn, Pad, register_element
from ..graph.pipeline import SourceElement


class _Slot:
    def __init__(self) -> None:
        self.cv = threading.Condition()
        self.buffer: Optional[Buffer] = None
        self.eos = False


_slots: Dict[int, _Slot] = {}
_slots_lock = threading.Lock()


def _slot(index: int) -> _Slot:
    with _slots_lock:
        if index not in _slots:
            _slots[index] = _Slot()
        return _slots[index]


def reset_repo() -> None:
    """Clear all slots (test isolation)."""
    with _slots_lock:
        _slots.clear()


@register_element
class TensorRepoSink(Element):
    ELEMENT_NAME = "tensor_reposink"

    def __init__(self, name: Optional[str] = None, **props: Any):
        self.slot_index = 0
        super().__init__(name, **props)
        self.add_sink_pad(template=Caps.any_tensors())

    def prepare(self) -> None:
        # a slot EOS'd (or left full) by a previous run must not swallow
        # this run's frames: slots are process-global, runs are not.
        # Runs in the pre-start phase — no source thread exists yet, so
        # this cannot discard a live frame.
        slot = _slot(int(self.slot_index))
        with slot.cv:
            slot.eos = False
            slot.buffer = None
            slot.cv.notify_all()

    def request_stop(self) -> None:
        super().request_stop()
        slot = _slot(int(self.slot_index))
        with slot.cv:
            slot.cv.notify_all()  # wake a chain blocked on a full slot

    def chain(self, pad: Pad, buf: Buffer) -> Optional[FlowReturn]:
        slot = _slot(int(self.slot_index))
        with slot.cv:
            # rendezvous, not latest-wins: the reference's set_buffer
            # blocks while the slot is occupied (tensor_repo.c:176-178
            # waits on cond_pull) so no frame is ever overwritten/lost
            while slot.buffer is not None and not slot.eos \
                    and not self._quitting:
                slot.cv.wait(0.05)
            if slot.eos or self._quitting:
                return FlowReturn.OK
            slot.buffer = buf
            slot.cv.notify_all()
        return FlowReturn.OK

    def on_eos(self) -> None:
        slot = _slot(int(self.slot_index))
        with slot.cv:
            slot.eos = True
            slot.cv.notify_all()


@register_element
class TensorRepoSrc(SourceElement):
    """Reads a repo slot. ``caps`` (or dims/types props) declare the stream;
    the first frame is zeros (loop bootstrap) unless ``no-initial=True``."""

    ELEMENT_NAME = "tensor_reposrc"

    def __init__(self, name: Optional[str] = None, **props: Any):
        self.slot_index = 0
        self.caps: Optional[Caps] = None
        self.dims: Optional[str] = None
        self.types: Optional[str] = None
        self.no_initial = False
        super().__init__(name, **props)
        self._sent_initial = False
        self._count = 0

    def prepare(self) -> None:
        slot = _slot(int(self.slot_index))
        with slot.cv:
            slot.eos = False  # fresh run over a process-global slot
            slot.buffer = None

    def negotiate(self) -> Caps:
        self._sent_initial = False
        self._count = 0
        if isinstance(self.caps, str):
            # gst string prop form, e.g. the reference's
            # caps="other/tensor,dimension=(string)3:16:16:1,..."
            from ..graph.parse import parse_caps_string

            self.caps = parse_caps_string(self.caps)
        if self.caps is not None:
            return self.caps
        if self.dims and self.types:
            cfg = TensorsConfig(TensorsInfo.from_strings(self.dims, self.types))
            return Caps.tensors(cfg)
        raise ValueError("tensor_reposrc needs caps or dims/types")

    def create(self) -> Optional[Buffer]:
        slot = _slot(int(self.slot_index))
        if not self._sent_initial and not self.no_initial:
            self._sent_initial = True
            cfg = (self.caps.to_config() if self.caps is not None
                   else TensorsConfig(TensorsInfo.from_strings(self.dims, self.types)))
            mems = [TensorMemory(np.zeros(i.shape, i.dtype.np_dtype))
                    for i in cfg.info]
            self._count += 1
            return Buffer(mems, pts=0, config=cfg)
        with slot.cv:
            while slot.buffer is None and not slot.eos:
                if self._stop_flag.is_set():
                    return None
                slot.cv.wait(0.05)
            if slot.buffer is None and slot.eos:
                return None
            buf = slot.buffer
            slot.buffer = None
            slot.cv.notify_all()  # wake a producer blocked on a full slot
        self._count += 1
        out = buf.with_memories(buf.memories, config=buf.config)
        out.pts = buf.pts
        return out
