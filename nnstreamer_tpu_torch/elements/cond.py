"""tensor_if — conditional stream branching.

Reference: gst/nnstreamer/elements/gsttensorif.c (+ include/tensor_if.h
custom callbacks): evaluates a predicate on each frame and routes/filters.

Properties (reference grammar):
  * compared-value: "A_VALUE" (one element, compared-value-option
    "<dim idxs>:<tensor idx>" picks it — we accept "i:j:..." flat index or
    tensor idx), "TENSOR_AVERAGE_VALUE" (compared-value-option = tensor idx),
    or "CUSTOM" (compared-value-option = registered predicate name,
    registry type IF_CUSTOM).
  * supplied-value: "V" or "V1:V2" for ranges.
  * operator: EQ NE GT GE LT LE RANGE_INCLUSIVE RANGE_EXCLUSIVE
    NOT_IN_RANGE_INCLUSIVE NOT_IN_RANGE_EXCLUSIVE
  * then / else: PASSTHROUGH | SKIP | TENSORPICK (then-option/else-option =
    tensor indices to pick).
Two src pads when both branches produce data ("then" = pad 0, "else" = pad 1
if linked).

Port of nnstreamer_tpu/elements/cond.py. The compared value of a tensor on
the card is computed there and read back as one scalar
(``core.data.tensor_average``; an A_VALUE element by indexing on the
card), never by copying the frame to the host.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from ..core.buffer import Buffer, TensorMemory
from ..core.data import tensor_average
from ..core.registry import SubpluginType, get_subplugin, register_subplugin
from ..core.types import Caps
from ..graph.element import Element, FlowReturn, Pad, register_element


def register_if_custom(name: str, fn: Callable[[Buffer], bool]) -> None:
    """Register a custom predicate (reference nnstreamer_if_custom_register)."""
    register_subplugin(SubpluginType.IF_CUSTOM, name, fn, replace=True)


def unregister_if_custom(name: str) -> None:
    from ..core.registry import unregister_subplugin

    unregister_subplugin(SubpluginType.IF_CUSTOM, name)


_OPS = {
    "EQ": lambda v, a, b: v == a,
    "NE": lambda v, a, b: v != a,
    "GT": lambda v, a, b: v > a,
    "GE": lambda v, a, b: v >= a,
    "LT": lambda v, a, b: v < a,
    "LE": lambda v, a, b: v <= a,
    "RANGE_INCLUSIVE": lambda v, a, b: a <= v <= b,
    "RANGE_EXCLUSIVE": lambda v, a, b: a < v < b,
    "NOT_IN_RANGE_INCLUSIVE": lambda v, a, b: not (a <= v <= b),
    "NOT_IN_RANGE_EXCLUSIVE": lambda v, a, b: not (a < v < b),
}


@register_element
class TensorIf(Element):
    ELEMENT_NAME = "tensor_if"

    def __init__(self, name: Optional[str] = None, **props: Any):
        self.compared_value = "TENSOR_AVERAGE_VALUE"
        self.compared_value_option = "0"
        self.supplied_value: Any = "0"
        self.operator = "GT"
        self.then = "PASSTHROUGH"
        self.then_option: Optional[str] = None
        self._else = "SKIP"
        super().__init__(name, **props)
        self.add_sink_pad(template=Caps.any_tensors())
        self.add_src_pad("src_then", template=Caps.any_tensors())
        self._custom_fn: Optional[Callable[[Buffer], bool]] = None

    def _set_prop_else(self, v: str) -> None:  # 'else' is a keyword
        self._else = v

    def set_properties(self, **props: Any) -> None:
        if "else" in props:
            self._else = props.pop("else")
        if "else_option" in props or "else-option" in props:
            self.else_option = props.pop("else_option", None) or props.pop("else-option")
        super().set_properties(**props)

    else_option: Optional[str] = None

    def start(self) -> None:
        cv = self.compared_value.upper()
        if cv == "CUSTOM":
            self._custom_fn = get_subplugin(SubpluginType.IF_CUSTOM,
                                            self.compared_value_option)
            if self._custom_fn is None:
                raise ValueError(
                    f"tensor_if: custom predicate {self.compared_value_option!r} "
                    "not registered")
        if self.operator.upper() not in _OPS:
            raise ValueError(f"tensor_if: unknown operator {self.operator!r}")

    def on_caps(self, pad: Pad, caps: Caps) -> None:
        pad.caps = caps
        # both branches carry the input stream type (TENSORPICK may narrow,
        # but flexible downstream handles it)
        self.send_caps_all(caps)

    # -- predicate ----------------------------------------------------------- #
    def _value(self, buf: Buffer) -> float:
        cv = self.compared_value.upper()
        opt = str(self.compared_value_option)
        if cv == "TENSOR_AVERAGE_VALUE":
            idx = int(opt or 0)
            return tensor_average(_resident(buf.memories[idx]))
        if cv == "A_VALUE":
            parts = [int(x) for x in opt.split(":")]
            tensor_idx = parts[-1] if len(parts) > 1 else 0
            arr = _resident(buf.memories[tensor_idx])
            coords = parts[:-1] if len(parts) > 1 else parts
            if len(coords) == 1:
                return float(arr.reshape(-1)[coords[0]])
            # reference coords are innermost-first; numpy index is reversed
            return float(arr[tuple(reversed(coords))])
        raise ValueError(f"tensor_if: unknown compared-value {cv!r}")

    def _decide(self, buf: Buffer) -> bool:
        if self._custom_fn is not None:
            return bool(self._custom_fn(buf))
        sv = str(self.supplied_value).split(":")
        a = float(sv[0])
        b = float(sv[1]) if len(sv) > 1 else a
        return _OPS[self.operator.upper()](self._value(buf), a, b)

    # -- routing -------------------------------------------------------------- #
    def _apply_action(self, buf: Buffer, action: str, option: Optional[str],
                      pad_index: int) -> FlowReturn:
        action = action.upper()
        if action == "SKIP":
            return FlowReturn.OK
        if action == "TENSORPICK" and option:
            idxs = [int(x) for x in str(option).split(",")]
            buf = buf.with_memories([buf.memories[i] for i in idxs])
        if pad_index >= len(self.src_pads):
            return FlowReturn.OK  # branch not linked
        return self.push(buf, pad_index)

    def chain(self, pad: Pad, buf: Buffer) -> Optional[FlowReturn]:
        if self._decide(buf):
            return self._apply_action(buf, self.then, self.then_option, 0)
        return self._apply_action(buf, self._else, self.else_option, 1)


def _resident(m: TensorMemory):
    """The operand of a compared value: the memory's tensor when it lies on
    the card, else its host array (the JAX package's numpy arithmetic)."""
    if m.is_device and m.device().device.type == "cuda":
        return m.device()
    return m.host()
