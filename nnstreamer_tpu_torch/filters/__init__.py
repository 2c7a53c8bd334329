"""NN backend subplugins. Importing registers the built-ins."""

from .base import (
    FilterFramework,
    FilterProps,
    InvokeStats,
    detect_framework,
    find_filter,
    register_filter,
)

_loaded = False


def _ensure_builtin_filters() -> None:
    global _loaded
    if _loaded:
        return
    _loaded = True
    from . import torch_cuda  # noqa: F401


_ensure_builtin_filters()

__all__ = [
    "FilterFramework", "FilterProps", "InvokeStats", "detect_framework",
    "find_filter", "register_filter",
]
