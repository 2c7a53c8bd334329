"""Runtime subplugin registry.

Equivalent of ``nnstreamer_subplugin.c`` (registry keyed by (type, name),
nnstreamer_subplugin.h:40-51,61-98). The reference dlopens
``libnnstreamer_<type>_<name>.so`` from configured paths on a registry miss;
our equivalent imports a Python module ``nnstreamer_tpu_torch_<type>_<name>`` or a
path from the config search dirs, whose import side-effect calls
``register_subplugin`` — same late-binding contract, Python loading model.
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import threading
from enum import Enum
from typing import Any, Callable, Dict, List, Optional, Tuple

from .log import logger

log = logger("registry")


class SubpluginType(Enum):
    """Registry namespaces (nnstreamer_subplugin.h:40-51)."""

    FILTER = "filter"
    DECODER = "decoder"
    CONVERTER = "converter"
    EASY_CUSTOM = "easy_custom"
    IF_CUSTOM = "if_custom"
    TRAINER = "trainer"


_lock = threading.RLock()
_registry: Dict[Tuple[SubpluginType, str], Any] = {}
_custom_prop_desc: Dict[Tuple[SubpluginType, str], Dict[str, str]] = {}


def register_subplugin(kind: SubpluginType, name: str, impl: Any,
                       *, replace: bool = False) -> bool:
    """Register an implementation under (kind, name). Returns False if the
    name is taken and replace is not set (reference semantics: duplicate
    registration fails)."""
    key = (kind, name.lower())
    with _lock:
        if key in _registry and not replace:
            log.warning("subplugin %s/%s already registered", kind.value, name)
            return False
        _registry[key] = impl
    log.debug("registered subplugin %s/%s", kind.value, name)
    return True


def unregister_subplugin(kind: SubpluginType, name: str) -> bool:
    with _lock:
        return _registry.pop((kind, name.lower()), None) is not None


def get_subplugin(kind: SubpluginType, name: str) -> Optional[Any]:
    """Lookup; on miss, attempt late-binding load from search paths
    (the reference's dlopen fallback, nnstreamer_subplugin.c registry miss
    path)."""
    key = (kind, name.lower())
    with _lock:
        impl = _registry.get(key)
    if impl is not None:
        return impl
    if _try_load(kind, name):
        with _lock:
            return _registry.get(key)
    return None


def has_subplugin(kind: SubpluginType, name: str) -> bool:
    return get_subplugin(kind, name) is not None


def get_all_subplugins(kind: SubpluginType) -> List[str]:
    with _lock:
        return sorted(n for (k, n) in _registry if k is kind)


def set_custom_property_desc(kind: SubpluginType, name: str, **desc: str) -> None:
    """Per-subplugin property documentation store
    (nnstreamer_subplugin.h custom-property-description)."""
    with _lock:
        _custom_prop_desc[(kind, name.lower())] = dict(desc)


def get_custom_property_desc(kind: SubpluginType, name: str) -> Dict[str, str]:
    with _lock:
        return dict(_custom_prop_desc.get((kind, name.lower()), {}))


def _try_load(kind: SubpluginType, name: str) -> bool:
    """Late-binding loader: import module
    nnstreamer_tpu_torch_<kind>_<name>, or a .py file from configured
    subplugin dirs."""
    modname = f"nnstreamer_tpu_torch_{kind.value}_{name.lower()}"
    try:
        importlib.import_module(modname)
        return True
    except ModuleNotFoundError:
        pass
    from .config import get_config

    for d in get_config().subplugin_dirs(kind.value):
        path = os.path.join(d, f"{name}.py")
        if os.path.isfile(path):
            spec = importlib.util.spec_from_file_location(modname, path)
            if spec and spec.loader:
                mod = importlib.util.module_from_spec(spec)
                try:
                    spec.loader.exec_module(mod)
                    return True
                except Exception as e:  # noqa: BLE001 — plugin load must not kill pipeline
                    log.error("failed loading subplugin %s: %s", path, e)
    return False
