"""Reference python custom-script converter/decoder loaders.

Port of nnstreamer_tpu/converters/pyscript.py. The reference dispatches
``tensor_converter mode=custom-script:<path.py>`` and ``tensor_decoder
mode=custom-script:<path.py>`` to user scripts with this contract
(tensor_converter_python3.cc / tensordec-python3.cc; its own test scripts
custom_converter.py / custom_decoder.py):

  * converter: ``class CustomConverter`` with
    ``convert(input_array) -> (tensors_info, raw_data, rate_n, rate_d)``
    — input is a list of raw uint8 arrays, ``tensors_info`` a list of
    ``nns.TensorShape`` (innermost-first dims + numpy dtype), ``raw_data``
    the flat per-tensor payloads;
  * decoder: ``class CustomDecoder`` with ``getOutCaps() -> bytes`` (the
    output media caps string) and
    ``decode(raw_data, in_info, rate_n, rate_d) -> bytes``.

Both may ``import nnstreamer_python as nns`` — the shim in
filters/nns_python_compat.py provides it. Scripts run on the host: a
tensor on the card is copied to the host before the script sees it.
Modules are memoized per path (in this package's own cache, under its own
module name prefix) so a pipeline reload does not re-exec the script.
"""

from __future__ import annotations

import importlib.util
import os
from fractions import Fraction
from typing import Any, Callable, Dict, Tuple

import numpy as np

from ..core.buffer import Buffer, TensorMemory
from ..core.types import Caps, TensorsConfig, TensorsInfo
from ..decoders.base import Decoder


def _load_script(path: str, class_name: str) -> Any:
    """Load the script's class and return a FRESH instance — the reference
    instantiates per element, so two pipelines sharing a stateful script
    must not share one object (the module itself is cached by
    load_script_module)."""
    cls = getattr(load_script_module(path), class_name, None)
    if cls is None:
        raise ValueError(f"{path}: must define class {class_name}")
    return cls()


_module_cache: Dict[str, Any] = {}


def load_script_module(path: str):
    """Exec a user script once per path (with the nnstreamer_python shim
    installed) — shared loader for python3 filters, converters, and
    decoders."""
    from ..filters.nns_python_compat import install_shim

    install_shim()
    key = os.path.abspath(path)
    if key in _module_cache:
        return _module_cache[key]
    if not os.path.isfile(path):
        raise FileNotFoundError(f"custom-script not found: {path}")
    spec = importlib.util.spec_from_file_location(
        f"nns_torch_script_{abs(hash(key))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _module_cache[key] = mod
    return mod


def load_script_converter(path: str) -> Callable:
    """``mode=custom-script:<path>`` → a converter subplugin callable
    ``(buf, props) -> (arrays, TensorsConfig)``."""
    from ..filters.nns_python_compat import shapes_to_info

    obj = _load_script(path, "CustomConverter")

    def convert(buf: Buffer, props: Any) -> Tuple[list, TensorsConfig]:
        raw = [np.frombuffer(m.tobytes(), np.uint8) for m in buf.memories]
        shapes, payloads, rate_n, rate_d = obj.convert(raw)
        info = shapes_to_info(shapes)
        arrays = []
        for t, payload in zip(info, payloads):
            flat = np.frombuffer(
                np.asarray(payload).tobytes(), t.dtype.np_dtype)
            arrays.append(flat.reshape(t.shape))
        cfg = TensorsConfig(info, Fraction(int(rate_n), max(int(rate_d), 1)))
        return arrays, cfg

    return convert


class ScriptDecoder(Decoder):
    """``tensor_decoder mode=custom-script:<path>`` — the Decoder contract
    (incl. the base submit/complete pipelined path) over a reference
    CustomDecoder object."""

    MODE = "custom-script"

    def __init__(self, path: str):
        super().__init__()
        self._obj = _load_script(path, "CustomDecoder")

    def out_caps(self, config: TensorsConfig) -> Caps:
        from ..graph.parse import parse_caps_string

        raw = self._obj.getOutCaps()
        caps_str = (raw.decode() if isinstance(raw, (bytes, bytearray))
                    else str(raw)).strip()
        try:
            return parse_caps_string(caps_str)  # full fields forwarded
        except Exception:
            return Caps(caps_str.split(",")[0].strip())

    def decode(self, buf: Buffer, config: TensorsConfig) -> Buffer:
        from ..filters.nns_python_compat import info_to_shapes

        raw = [np.ravel(m.host()) for m in buf.memories]
        infos: TensorsInfo = TensorsInfo(
            tuple(m.info for m in buf.memories))
        rate = config.rate or Fraction(0, 1)
        out = self._obj.decode(raw, info_to_shapes(infos),
                               rate.numerator, rate.denominator)
        blob = np.frombuffer(bytes(out), np.uint8).copy()
        return buf.with_memories([TensorMemory(blob)])
