"""Pipeline graph runtime: elements, pads, events, scheduling."""

from .element import (
    Element,
    FlowReturn,
    Pad,
    PadDirection,
    all_element_names,
    element_class,
    make_element,
    register_element,
)
from .events import Bus, Event, EventType, Message, MessageType
from .pipeline import Join, Pipeline, PipelineError, Queue, SourceElement, Tee

__all__ = [
    "Element", "FlowReturn", "Pad", "PadDirection", "all_element_names",
    "element_class", "make_element", "register_element",
    "Bus", "Event", "EventType", "Message", "MessageType",
    "Join", "Pipeline", "PipelineError", "Queue", "SourceElement", "Tee",
]
