"""Logging facade (nnstreamer_log.h:29-76 equivalent).

The reference routes ml_logi/w/e/d through platform loggers (dlog/android/
glib). We route through :mod:`logging` with per-category loggers like
GST_DEBUG categories; ``NNS_TPU_DEBUG`` env sets the level
(e.g. ``NNS_TPU_DEBUG=debug`` or ``NNS_TPU_DEBUG=filter:debug,pipeline:info``).
"""

from __future__ import annotations

import logging
import os
from typing import Dict

_ROOT = "nns_tpu_torch"
_configured = False


def _configure() -> None:
    global _configured
    if _configured:
        return
    _configured = True
    root = logging.getLogger(_ROOT)
    if not root.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname).1s: %(message)s", "%H:%M:%S"))
        root.addHandler(h)
    root.setLevel(logging.WARNING)
    spec = os.environ.get("NNS_TPU_DEBUG", "")
    for part in filter(None, (p.strip() for p in spec.split(","))):
        # an invalid level must never abort the FIRST import that
        # triggers configuration (setLevel raises ValueError on unknown
        # names): warn and keep the default instead
        if ":" in part:
            cat, lvl = part.split(":", 1)
            try:
                logging.getLogger(f"{_ROOT}.{cat}").setLevel(lvl.upper())
            except (ValueError, TypeError):
                root.warning(
                    "NNS_TPU_DEBUG: invalid level %r for category %r "
                    "(ignored; keeping default)", lvl, cat)
        else:
            try:
                root.setLevel(part.upper())
            except (ValueError, TypeError):
                root.setLevel(logging.WARNING)
                root.warning(
                    "NNS_TPU_DEBUG: invalid level %r "
                    "(ignored; falling back to WARNING)", part)


def logger(category: str) -> logging.Logger:
    """Per-category logger (GST_DEBUG category equivalent)."""
    _configure()
    return logging.getLogger(f"{_ROOT}.{category}")
