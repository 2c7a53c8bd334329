"""gst-launch-style textual pipeline parser.

Port of nnstreamer_tpu/graph/parse.py: the same grammar builds the same
graph of the port's elements, so reference pipelines run near-verbatim:

    videotestsrc num-buffers=10 ! tensor_converter !
    tensor_transform mode=arithmetic option=typecast:float32,div:255.0 !
    tensor_filter framework=xla-tpu model=zoo://mobilenet_v2 !
    tensor_decoder mode=image_labeling option1=labels.txt ! tensor_sink

Supported grammar (the subset the reference's pipelines use):
  * ``elem prop=val prop2="quoted val" ! elem2 ...``
  * named elements + back-references: ``tee name=t ! ... t. ! queue ! ...``
    (segments separated by whitespace after a complete branch)
  * caps filter segments: ``video/x-raw,format=RGB,width=640,height=480`` or
    ``other/tensors,dimensions=...,types=...`` become CapsFilter elements
  * numbers/bools auto-typed; fractions stay strings ("30/1" → element-parsed)
"""

from __future__ import annotations

import re
import shlex
from fractions import Fraction
from typing import Any, Dict, List, Optional

from ..core.types import ANY, Caps, TensorFormat
from .element import Element, Pad, make_element, register_element
from .pipeline import Pipeline


@register_element
class CapsFilter(Element):
    """Pass-through that constrains negotiation (gst capsfilter)."""

    ELEMENT_NAME = "capsfilter"

    def __init__(self, name: Optional[str] = None, **props: Any):
        self.caps: Optional[Caps] = None
        super().__init__(name, **props)
        self.add_sink_pad()
        self.add_src_pad()

    def on_caps(self, pad: Pad, caps: Caps) -> None:
        if self.caps is not None:
            merged = caps.intersect(self.caps)
            if merged is None:
                raise ValueError(
                    f"capsfilter: stream {caps} incompatible with {self.caps}")
            caps = merged
        pad.caps = caps
        self.send_caps_all(caps)


_MEDIA_TYPES = ("video/x-raw", "audio/x-raw", "text/x-raw",
                "application/octet-stream", "other/tensor", "other/tensors",
                "other/flexbuf", "other/flatbuf", "other/protobuf")

_INT_FIELDS = {"width", "height", "channels", "rate", "num"}


def _split_caps_fields(s: str) -> List[str]:
    """Split caps on commas outside double quotes (GStreamer quoting for
    values containing commas, e.g. multi-tensor dimension strings)."""
    parts, cur, quoted = [], [], False
    for ch in s:
        if ch == '"':
            quoted = not quoted
            cur.append(ch)
        elif ch == "," and not quoted:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return parts


def parse_caps_string(s: str) -> Caps:
    """"video/x-raw,format=RGB,width=640" → Caps."""
    parts = _split_caps_fields(s)
    media = parts[0].strip()
    if media == "other/tensor":
        media = "other/tensors"
    fields: Dict[str, Any] = {}
    for kv in parts[1:]:
        kv = kv.strip()
        if not kv:
            continue
        if "=" not in kv:
            raise ValueError(f"bad caps field {kv!r} in {s!r}")
        k, v = kv.split("=", 1)
        k = k.strip()
        v = re.sub(r"^\(\w+\)", "", v.strip())  # drop "(int)3" annotations
        v = v.strip('"')
        if k in ("dimensions", "dimension"):
            k = "dims"
        elif k == "type":  # other/tensor singular field names
            k = "types"
        elif k in ("num_tensors",):
            k = "num"
        if k in _INT_FIELDS:
            fields[k] = int(v)
        elif k == "framerate":
            n, d = (v.split("/") + ["1"])[:2]
            fields[k] = Fraction(int(n), int(d))
        elif k == "format" and media == "other/tensors":
            fields[k] = TensorFormat.parse(v)
        else:
            fields[k] = v
    return Caps(media, fields)


def _auto_type(v: str) -> Any:
    if re.fullmatch(r"-?\d+", v):
        return int(v)
    if re.fullmatch(r"0[xX][0-9a-fA-F]+", v):
        return int(v, 16)  # gst hex props, e.g. videotestsrc color=0xFF0000
    if re.fullmatch(r"-?\d*\.\d+([eE]-?\d+)?", v):
        return float(v)
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    return v


def parse_pipeline(description: str, pipeline: Optional[Pipeline] = None) -> Pipeline:
    """Build (and return) a Pipeline from a textual description."""
    if not description.strip():
        raise ValueError("empty pipeline description")
    p = pipeline or Pipeline()
    branches = _split_branches(description)
    named: Dict[str, Element] = {}
    # gst-launch allows "… ! mux.sink_0" before "tensor_mux name=mux" is
    # declared; every sink-side named link is deferred and resolved once
    # all branches are parsed, in encounter order, so request pads are
    # created in index order regardless of where the declaration sits
    pending: List[tuple] = []

    for branch in branches:
        prev: Optional[Any] = None
        prev_explicit: set = set()
        closed = False  # chain already sank into a named element/pad
        for seg in branch:
            if closed:
                raise ValueError(
                    "cannot continue a chain after linking into a named "
                    f"element/pad (dangling segment {seg!r})")
            if isinstance(seg, str):  # "name." or pad ref "name.sink_0"
                if seg.endswith("."):
                    ref = seg.rstrip(".")
                    if prev is not None:
                        # "… ! name." links INTO the named element's next
                        # free sink pad and ends the chain (gst-launch);
                        # ALWAYS deferred so request-pad creation follows
                        # global encounter order even when some references
                        # precede the declaration and some follow it
                        pending.append((prev, ref, None, seg))
                        prev = None
                        closed = True
                        continue
                    if ref not in named:
                        raise ValueError(
                            f"unknown element reference {seg!r}")
                    prev = named[ref]
                    # restore the referenced element's own explicit
                    # props — a following caps filter must respect them
                    prev_explicit = getattr(prev, "_parse_explicit", set())
                    continue
                ref, pad_name = seg.split(".", 1)
                if prev is not None:
                    # chain sinks INTO this pad: ... ! mux.sink_0 (deferred,
                    # see above)
                    pending.append((prev, ref, pad_name, seg))
                    prev = None
                    closed = True
                    continue
                if ref not in named:
                    # a branch STARTING at an unseen src pad cannot be
                    # deferred (everything after it would dangle)
                    raise ValueError(f"unknown element reference {seg!r}")
                # branch starts AT this src pad: demux.src_0 ! ...
                prev = (named[ref], pad_name)
                prev_explicit = set()
                continue
            kind, props = seg
            if kind in _MEDIA_TYPES or kind.split(",")[0] in _MEDIA_TYPES:
                caps = parse_caps_string(_reassemble_caps(kind, props))
                el = CapsFilter(caps=caps)
                p.add(el)
                _configure_upstream_from_caps(prev, caps, prev_explicit)
                explicit = set()
            else:
                name = props.pop("name", None)
                explicit = {k.replace("-", "_") for k in props}
                el = make_element(kind, element_name=name, **props)
                el._parse_explicit = explicit
                p.add(el)
                if name:
                    named[name] = el
            if prev is not None:
                _link(prev, el)
            prev = el
            prev_explicit = explicit

    for prev, ref, pad_name, seg in pending:
        if ref not in named:
            raise ValueError(f"unknown element reference {seg!r}")
        _link(prev, named[ref] if pad_name is None else (named[ref], pad_name))
    return p


def _link(src_spec: Any, dst_spec: Any) -> None:
    """Link with optional explicit pads: either side may be an Element
    (first-free-pad semantics, shared with Pipeline.link) or an
    ``(element, pad_name)`` tuple from a gst ``name.sink_0`` reference."""
    src = _pad_by_name(*src_spec, "src") if isinstance(src_spec, tuple) \
        else src_spec.free_src_pad()
    sink = _pad_by_name(*dst_spec, "sink") if isinstance(dst_spec, tuple) \
        else dst_spec.free_sink_pad()
    src.link(sink)


def _pad_by_name(el: Element, pad_name: str, direction: str) -> Any:
    """Resolve ``sink_N``/``src_N``. Request pads are created strictly in
    index order — referencing ``sink_1`` before ``sink_0`` would fabricate
    an unlinked lower pad that stalls collect elements forever, so a
    skipped index is an error instead."""
    pads = el.sink_pads if direction == "sink" else el.src_pads
    for q in pads:
        if q.name == pad_name:
            return q
    if re.fullmatch(rf"{direction}_\d+", pad_name) is None:
        raise ValueError(
            f"{el.name}: no {direction} pad named {pad_name!r}")
    q = el.request_sink_pad() if direction == "sink" \
        else el.request_src_pad()
    if q.name != pad_name:
        raise ValueError(
            f"{el.name}: pad references must be used in index order "
            f"(requested {pad_name!r}, next available is {q.name!r})")
    return q


def _configure_upstream_from_caps(prev: Optional[Element], caps: Caps,
                                  explicit: set) -> None:
    """gst-launch semantics shortcut: in ``videotestsrc ! video/x-raw,
    format=GRAY8,...`` or ``videoscale ! video/x-raw,width=224,...`` the
    caps filter CONFIGURES the upstream element through negotiation.
    Full upstream negotiation is out of scope for the push scheduler, so
    the parser applies a caps filter's fields directly to the
    directly-preceding element when it exposes a matching configurable
    attribute (format/width/height/framerate/rate/channels) — sources,
    videoconvert (format), videoscale (width/height) alike. Props the
    user set EXPLICITLY stay authoritative: a conflicting caps filter
    then fails negotiation (SSAT negative cases), and the CapsFilter
    still validates whatever the element actually produces."""
    if prev is None or isinstance(prev, tuple):
        return
    for key in ("format", "width", "height", "framerate", "rate",
                "channels"):
        if key not in caps.fields:
            continue
        # gst negotiation propagates through transparent elements
        # (audioconvert/videoconvert/queue): walk upstream until an
        # element exposes the attribute — e.g. `audiotestsrc !
        # audioconvert ! audio/x-raw,rate=8000` configures the SOURCE's
        # rate while audioconvert takes the format. The walk STOPS at
        # media-type boundaries (tensor_converter/decoder) and at other
        # caps filters: an other/tensors field must never clobber an
        # upstream video element's attribute of the same name.
        el, exp = prev, explicit
        for _ in range(6):
            if el.ELEMENT_NAME in ("tensor_converter", "tensor_decoder",
                                   "capsfilter"):
                break
            if hasattr(el, key):
                if key not in exp:
                    old = getattr(el, key)
                    setattr(el, key, caps.fields[key])
                    if old not in (None, caps.fields[key]):
                        # visible trail when a caps filter reconfigures an
                        # upstream element — a same-named attribute with
                        # different semantics would otherwise diverge from
                        # gst negotiation silently
                        from ..core.log import logger

                        logger("parse").info(
                            "caps filter reconfigures %s.%s: %r -> %r",
                            el.name, key, old, caps.fields[key])
                break
            up = el.sink_pads[0].peer if el.sink_pads else None
            if up is None:
                break
            el = up.element
            exp = getattr(el, "_parse_explicit", set())


def _reassemble_caps(kind: str, props: Dict[str, Any]) -> str:
    fields = ",".join(f"{k}={v}" for k, v in props.items())
    return f"{kind},{fields}" if fields else kind


def _split_branches(description: str):
    """Tokenize into branches of segments. Each segment is either
    (element_kind, props) or a back-reference string "name."."""
    # shlex FIRST (punctuation_chars splits bare '!' as its own token) so
    # quoting protects values: model="dir!v2/m" must keep its '!'
    lex = shlex.shlex(description, posix=True, punctuation_chars="!")
    lex.whitespace_split = True
    lex.commenters = ""  # '#' is data (paths, URI fragments), not comments
    tokens: List[str] = []
    for tok in lex:
        if tok and set(tok) == {"!"}:
            # '!!' arrives as one token; expand so the empty-segment
            # check below rejects it
            tokens.extend("!" * len(tok))
        else:
            tokens.append(tok)
    branches: List[List[Any]] = []
    current: List[Any] = []
    seg_tokens: List[str] = []

    def flush_segment() -> None:
        if not seg_tokens:
            return
        # gst caps allow spaces around '=' ("format = RGB"): merge the
        # three-token form (and dangling "k=" / "=v" halves) back into
        # one k=v token before prop parsing. A DANGLING key is "k=" with
        # no earlier '=' — a complete value that merely ENDS in '='
        # (option=YWJjZA==) must not swallow the next token.
        merged: List[str] = []
        for t in seg_tokens:
            if merged and (t == "="
                           or (_dangling_key(merged[-1]) and "=" not in t)
                           or (t.startswith("=") and "="
                               not in merged[-1])):
                merged[-1] += t
            else:
                merged.append(t)
        seg_tokens[:] = merged
        head = seg_tokens[0]
        if len(seg_tokens) == 1 and not any(c in head for c in "=/") and \
                (head.endswith(".") or _PAD_REF_RE.fullmatch(head)):
            current.append(head)
        else:
            props: Dict[str, Any] = {}
            for t in seg_tokens[1:]:
                if "=" not in t:
                    raise ValueError(f"expected prop=value, got {t!r}")
                k, v = t.split("=", 1)
                props[k.replace("-", "_")] = _auto_type(v.strip('"'))
            current.append((head, props))
        seg_tokens.clear()

    for i, tok in enumerate(tokens):
        if tok == "!":
            if not seg_tokens:
                # covers a leading '!' and '! !' (empty segment) alike
                raise ValueError("empty segment before '!' in pipeline")
            if i == len(tokens) - 1:
                raise ValueError("pipeline ends with a dangling '!'")
            flush_segment()
            continue
        # a segment token arriving while another segment is open (no "!"
        # in between) ends the current branch and starts a new one —
        # UNLESS a spaced '=' is pending ("name = queue" is a prop whose
        # value merges in flush_segment, not a new branch)
        eq_pending = bool(seg_tokens) and (seg_tokens[-1] == "="
                                           or _dangling_key(seg_tokens[-1]))
        if seg_tokens and "=" not in tok and not eq_pending \
                and (tok.endswith(".") or _PAD_REF_RE.fullmatch(tok)
                     or _looks_like_element(tok)):
            flush_segment()
            if current:
                branches.append(current)
                current = []
        seg_tokens.append(tok)
    flush_segment()
    if current:
        branches.append(current)
    return branches


#: gst pad reference: ``name.sink_0`` / ``name.src_1`` (the mux/demux
#: SSAT strings link through explicit pads)
_PAD_REF_RE = re.compile(r"[A-Za-z_]\w*\.(sink|src)_\d+")


def _dangling_key(tok: str) -> bool:
    """True for a prop KEY awaiting its value ("name=") — exactly one
    '=' and it is the last character."""
    return tok.endswith("=") and "=" not in tok[:-1]


def _looks_like_element(tok: str) -> bool:
    from .element import element_class

    if "/" in tok or "," in tok or "=" in tok:
        return False
    return element_class(tok) is not None


def caps_to_gst_string(caps: Caps) -> str:
    """Inverse of ``parse_caps_string`` in GStreamer's annotated syntax
    (``media,k=(type)v,...``) — the representation carried on external
    wires (MQTT GstMQTTMessageHdr.gst_caps_str, mqttcommon.h:60)."""
    from fractions import Fraction as _F

    parts = [caps.media_type]
    for k, v in sorted(caps.fields.items()):
        if v is ANY:
            continue
        if k == "dims":
            k = "dimensions"
        elif k == "num":
            k = "num_tensors"
        if isinstance(v, _F):
            parts.append(f"{k}=(fraction){v.numerator}/{v.denominator}")
        elif isinstance(v, bool):
            parts.append(f"{k}=(boolean){'true' if v else 'false'}")
        elif isinstance(v, int):
            parts.append(f"{k}=(int){v}")
        else:
            vs = str(v)
            if "," in vs:
                vs = f'"{vs}"'  # GStreamer quoting for commas
            parts.append(f"{k}=(string){vs}")
    return ",".join(parts)
