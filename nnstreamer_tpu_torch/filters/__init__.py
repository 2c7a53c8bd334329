"""NN backend subplugins. Importing registers the built-ins: torch-cuda,
custom-easy and python3 (filters/custom.py), and the C custom filter."""

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


_ensure_builtin_filters()

__all__ = [
    "FilterFramework", "FilterProps", "InvokeStats", "detect_framework",
    "find_filter", "register_custom_easy", "register_filter",
    "unregister_custom_easy",
]
