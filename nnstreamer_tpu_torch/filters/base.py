"""NN backend (filter subplugin) API.

Equivalent of ``GstTensorFilterFramework`` v1
(nnstreamer_plugin_api_filter.h:273-495): a vtable of open/close/invoke/
getModelInfo/eventHandler that any backend implements, registered under
``SubpluginType.FILTER``. ``invoke`` consumes and produces
:class:`TensorMemory` which may hold **device-resident torch.Tensors** — a
backend that runs on the GPU never copies through host between pipeline
elements (the reference's GPU backends round-trip through CPU buffers or
managed memory; tensorrt.cc:390).

Also hosts:
 * ``FilterProps`` — parsed element properties handed to ``open``;
 * invoke statistics (GstTensorFilterStatistics, tensor_filter_common.h:80-89);
 * the shared-model table (``shared-tensor-filter-key``,
   tensor_filter_common.c:570-602 nnstreamer_filter_shared_model_*);
 * framework auto-detection from model path
   (gst_tensor_filter_detect_framework, tensor_filter_common.c:1153-1260).
"""

from __future__ import annotations

import collections
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

from ..core.buffer import TensorMemory
from ..core.hw import AcceleratorSpec
from ..core.log import logger
from ..core.registry import SubpluginType, get_subplugin, register_subplugin
from ..core.types import TensorsInfo

log = logger("filter")


@dataclass
class FilterProps:
    """Properties delivered to a backend's open() (GstTensorFilterProperties)."""

    model: Any = None                 # path(s) or in-process object
    custom: str = ""                  # backend-specific option string
    accelerator: AcceleratorSpec = field(default_factory=AcceleratorSpec)
    device: Any = None                # resolved torch.device (element prop)
    input_info: Optional[TensorsInfo] = None   # user override / hint
    output_info: Optional[TensorsInfo] = None
    num_threads: int = 0
    is_updatable: bool = False
    #: per-tensor data layouts declared by the inputlayout/outputlayout
    #: props ("none"/"any"/"nhwc"/"nchw" — tensor_filter_common.c:913-940);
    #: empty tuple = unspecified
    input_layout: tuple = ()
    output_layout: tuple = ()

    @property
    def model_path(self) -> Optional[str]:
        if isinstance(self.model, str):
            return self.model
        if isinstance(self.model, (list, tuple)) and self.model \
                and isinstance(self.model[0], str):
            return self.model[0]
        return None

    def custom_dict(self) -> Dict[str, str]:
        """Parse "key=value,key2=value2" custom strings."""
        out: Dict[str, str] = {}
        for part in self.custom.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" in part:
                k, v = part.split("=", 1)
                out[k.strip()] = v.strip()
            else:
                out[part] = "true"
        return out


class FilterFramework:
    """Backend base class. Subclasses set NAME and implement the vtable."""

    NAME = "base"
    #: backend allocates outputs itself (zero-copy wrap downstream;
    #: reference allocate_in_invoke, tensor_filter.c:308-319)
    ALLOCATE_IN_INVOKE = True
    #: backend works without a model file (e.g. custom-easy callable)
    RUN_WITHOUT_MODEL = False
    #: backend consumes inputlayout/outputlayout=NCHW (permutes data);
    #: declaring NCHW on a backend that would silently ignore it is
    #: rejected at open (tensor_filter element)
    SUPPORTS_LAYOUT = False

    def __init__(self) -> None:
        self.props: Optional[FilterProps] = None

    # -- lifecycle ---------------------------------------------------------- #
    def open(self, props: FilterProps) -> None:
        self.props = props

    def close(self) -> None:
        self.props = None

    # -- model metadata ------------------------------------------------------ #
    def get_model_info(self) -> Tuple[Optional[TensorsInfo], Optional[TensorsInfo]]:
        """(input_info, output_info); either may be None if the model adapts
        to the incoming stream (then set_input_info must resolve it)."""
        raise NotImplementedError

    def set_input_info(self, in_info: TensorsInfo) -> TensorsInfo:
        """Reconfigure for a given input (setInputDimension); returns the
        resulting output info. Default: reject reconfiguration."""
        raise RuntimeError(f"{self.NAME}: model input is fixed")

    # -- execution ----------------------------------------------------------- #
    def invoke(self, inputs: Sequence[TensorMemory]) -> Sequence[TensorMemory]:
        raise NotImplementedError

    # -- events -------------------------------------------------------------- #
    def reload_model(self, model: Any) -> None:
        """Hot model swap (RELOAD_MODEL, nnstreamer_plugin_api_filter.h:377-383)."""
        raise RuntimeError(f"{self.NAME}: reload not supported")

    def handle_event(self, name: str, data: Dict[str, Any]) -> None:
        """Other custom events; default ignore."""


# --------------------------------------------------------------------------- #
# Registration & lookup
# --------------------------------------------------------------------------- #

def register_filter(cls: type) -> type:
    """Class decorator: register a FilterFramework under its NAME (and
    aliases in cls.ALIASES)."""
    register_subplugin(SubpluginType.FILTER, cls.NAME, cls, replace=True)
    for alias in getattr(cls, "ALIASES", ()):  # e.g. "xla-tpu" for "torch-cuda"
        register_subplugin(SubpluginType.FILTER, alias, cls, replace=True)
    return cls


def find_filter(name: str) -> Optional[type]:
    from . import _ensure_builtin_filters

    _ensure_builtin_filters()
    impl = get_subplugin(SubpluginType.FILTER, name)
    return impl


def detect_framework(model: Any) -> Optional[str]:
    """framework=auto: detect from the model object / file extension via the
    config priority table (tensor_filter_common.c:1153,1200,1416)."""
    from ..core.config import get_config

    if model is None:
        return None
    if callable(model) or not isinstance(model, (str, list, tuple)):
        return "torch-cuda"  # in-process torch callables / bundles
    path = model if isinstance(model, str) else model[0]
    if isinstance(path, str) and path.startswith("zoo://"):
        return "torch-cuda"
    ext = os.path.splitext(str(path))[1].lower()
    for fw in get_config().framework_priority(ext) if ext else []:
        if find_filter(fw) is not None:
            return fw
    return None


# --------------------------------------------------------------------------- #
# Invoke statistics (tensor_filter_common.h:80-89; tensor_filter.c:321-420)
# --------------------------------------------------------------------------- #

class InvokeStats:
    """Rolling invoke latency + throughput, exposed as filter props
    ``latency``/``throughput`` like the reference (µs avg of last N;
    FPS×1000 int)."""

    def __init__(self, window: int = 10):
        self.window = window
        self._latencies_ns: Deque[int] = collections.deque(maxlen=window)
        self.total_invoke_num = 0
        self.total_invoke_latency_ns = 0
        self._first_invoke_t: Optional[float] = None
        self._lock = threading.Lock()

    def record(self, latency_ns: int) -> None:
        with self._lock:
            now = time.monotonic()
            if self._first_invoke_t is None:
                self._first_invoke_t = now
            self._latencies_ns.append(latency_ns)
            self.total_invoke_num += 1
            self.total_invoke_latency_ns += latency_ns

    @property
    def latency_us(self) -> int:
        """Average invoke latency over the window, µs (prop `latency`)."""
        with self._lock:
            if not self._latencies_ns:
                return -1
            return int(sum(self._latencies_ns) / len(self._latencies_ns) / 1000)

    @property
    def throughput(self) -> int:
        """Overall FPS×1000 (prop `throughput`)."""
        with self._lock:
            if self._first_invoke_t is None or self.total_invoke_num < 2:
                return -1
            elapsed = time.monotonic() - self._first_invoke_t
            if elapsed <= 0:
                return -1
            return int(self.total_invoke_num / elapsed * 1000)


# --------------------------------------------------------------------------- #
# Shared model table (shared-tensor-filter-key)
# --------------------------------------------------------------------------- #

_shared_lock = threading.Lock()
_shared_table: Dict[str, FilterFramework] = {}
_shared_refs: Dict[str, int] = {}


def shared_model_get_or_create(key: str, factory) -> FilterFramework:
    with _shared_lock:
        fw = _shared_table.get(key)
        if fw is None:
            fw = factory()
            _shared_table[key] = fw
            _shared_refs[key] = 0
        _shared_refs[key] += 1
        return fw


def shared_model_release(key: str) -> bool:
    """Returns True when the last reference is gone (caller closes fw)."""
    with _shared_lock:
        if key not in _shared_table:
            return False
        _shared_refs[key] -= 1
        if _shared_refs[key] <= 0:
            del _shared_table[key]
            del _shared_refs[key]
            return True
        return False
