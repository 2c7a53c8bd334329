"""Configuration system (nnstreamer_conf.c/.h + nnstreamer.ini.in equivalent).

Three layers, mirroring the reference (nnstreamer_conf.c:46-66,137-143):
  1. ini file — ``/etc/nnstreamer_tpu.ini`` or ``$NNS_TPU_CONF`` path
     (keyfile sections like ``[common]``, ``[filter]``, per-backend sections);
  2. env-var overrides — ``NNS_TPU_FILTERS/DECODERS/CONVERTERS`` path lists,
     honored when ``enable_envvar`` (default on; the reference gates this at
     build time);
  3. hardcoded fallback paths.

Also hosts the per-extension framework priority table
(``framework_priority_<ext>``; nnstreamer.ini.in:13-16) used by filter
auto-detection, and free-form per-subplugin custom values
(``nnsconf_get_custom_value_*`` equivalent).
"""

from __future__ import annotations

import configparser
import os
import threading
from typing import Dict, List, Optional

_DEFAULT_INI_PATHS = ["/etc/nnstreamer_tpu.ini",
                      os.path.expanduser("~/.config/nnstreamer_tpu.ini")]
_ENV_PATH_KEYS = {
    "filter": "NNS_TPU_FILTERS",
    "decoder": "NNS_TPU_DECODERS",
    "converter": "NNS_TPU_CONVERTERS",
    "easy_custom": "NNS_TPU_CUSTOMFILTERS",
}

#: model file extension → ordered backend priority (framework auto-detect;
#: nnstreamer_conf framework_priority_* + tensor_filter_common.c:1153-1260)
DEFAULT_FRAMEWORK_PRIORITY: Dict[str, List[str]] = {
    ".jaxexport": ["xla-tpu"],
    ".jax": ["xla-tpu"],
    ".stablehlo": ["xla-tpu"],
    ".mlir": ["xla-tpu"],
    ".tflite": ["xla-tpu"],
    ".msgpack": ["xla-tpu"],
    ".ckpt": ["xla-tpu"],
    ".orbax": ["xla-tpu"],
    ".pb": ["tensorflow"],
    ".py": ["python3"],
    ".pt": ["torch"],
    ".pt2": ["torch"],
    ".torchscript": ["torch"],
    ".so": ["custom"],
}


class Config:
    def __init__(self, ini_path: Optional[str] = None):
        self._cp = configparser.ConfigParser()
        self._lock = threading.RLock()
        paths = [ini_path] if ini_path else \
            ([os.environ["NNS_TPU_CONF"]] if os.environ.get("NNS_TPU_CONF") else _DEFAULT_INI_PATHS)
        self.loaded_from: Optional[str] = None
        for p in paths:
            if p and os.path.isfile(p):
                self._cp.read(p)
                self.loaded_from = p
                break
        self.enable_envvar = self._cp.getboolean("common", "enable_envvar", fallback=True)

    # -- subplugin search paths -------------------------------------------- #
    def subplugin_dirs(self, kind: str) -> List[str]:
        dirs: List[str] = []
        if self.enable_envvar:
            env = os.environ.get(_ENV_PATH_KEYS.get(kind, ""), "")
            dirs += [d for d in env.split(":") if d]
        ini_val = self._cp.get(kind, "subplugin_path", fallback="")
        dirs += [d for d in ini_val.split(":") if d]
        dirs.append(os.path.expanduser(f"~/.nnstreamer_tpu/{kind}"))
        return dirs

    # -- framework priority ------------------------------------------------- #
    def framework_priority(self, model_ext: str) -> List[str]:
        ext = model_ext.lower()
        if not ext.startswith("."):
            ext = "." + ext
        key = f"framework_priority_{ext.lstrip('.')}"
        val = self._cp.get("filter", key, fallback="")
        if val:
            return [f.strip() for f in val.split(",") if f.strip()]
        return list(DEFAULT_FRAMEWORK_PRIORITY.get(ext, []))

    # -- custom values (nnsconf_get_custom_value_*) ------------------------- #
    def get_custom_value(self, section: str, key: str,
                         default: Optional[str] = None) -> Optional[str]:
        if self.enable_envvar:
            env_key = f"NNS_TPU_{section.upper().replace('-', '_')}_{key.upper()}"
            if env_key in os.environ:
                return os.environ[env_key]
        return self._cp.get(section, key, fallback=default)

    def get_custom_value_bool(self, section: str, key: str, default: bool = False) -> bool:
        v = self.get_custom_value(section, key)
        if v is None:
            return default
        return v.strip().lower() in ("1", "true", "yes", "on")


_config: Optional[Config] = None
_config_lock = threading.Lock()


def get_config() -> Config:
    global _config
    with _config_lock:
        if _config is None:
            _config = Config()
        return _config


def reset_config(ini_path: Optional[str] = None) -> Config:
    """Reload (tests use this to point at a temp ini)."""
    global _config
    with _config_lock:
        _config = Config(ini_path)
        return _config
