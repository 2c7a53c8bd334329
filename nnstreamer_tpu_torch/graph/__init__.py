"""Pipeline graph runtime: elements, pads, events, scheduling, sync, the
gst-launch-style parser."""

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
from .parse import CapsFilter, caps_to_gst_string, parse_caps_string, parse_pipeline
from .pipeline import Join, Pipeline, PipelineError, Queue, SourceElement, Tee
from .sync import CollectPads, SyncPolicy

__all__ = [
    "Element", "FlowReturn", "Pad", "PadDirection", "all_element_names",
    "element_class", "make_element", "register_element",
    "Bus", "Event", "EventType", "Message", "MessageType",
    "CapsFilter", "caps_to_gst_string", "parse_caps_string", "parse_pipeline",
    "Join", "Pipeline", "PipelineError", "Queue", "SourceElement", "Tee",
    "CollectPads", "SyncPolicy",
]
