"""NN backend subplugins. Importing registers the built-ins: torch-cuda
(with the TFLite names), custom-easy and python3 (filters/custom.py), the C
custom filter, torch/pytorch (TorchScript and the legacy zip,
filters/torch_backend.py) and tensorflow (frozen GraphDefs,
filters/tf_backend.py; TensorFlow itself is imported at open())."""

from .base import (
    FilterFramework,
    FilterProps,
    InvokeStats,
    detect_framework,
    find_filter,
    register_filter,
)
from .custom import register_custom_easy, unregister_custom_easy

_loaded = False


def _ensure_builtin_filters() -> None:
    global _loaded
    if _loaded:
        return
    _loaded = True
    from . import torch_cuda  # noqa: F401
    from . import custom  # noqa: F401
    from . import c_custom  # noqa: F401
    from . import torch_backend  # noqa: F401
    from . import tf_backend  # noqa: F401


_ensure_builtin_filters()

__all__ = [
    "FilterFramework", "FilterProps", "InvokeStats", "detect_framework",
    "find_filter", "register_custom_easy", "register_filter",
    "unregister_custom_easy",
]
