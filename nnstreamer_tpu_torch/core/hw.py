"""Accelerator detection (hw_accel.c:42-64 equivalent) through ``torch.cuda``.

Entry points run on ``cuda`` unless the caller names another device. A
request for ``cuda`` on a machine without a card raises: nothing here
drops to the CPU on its own. Also hosts the accelerator-string parser
(parse_accl_hw, nnstreamer_plugin_api_filter.h:547-568): strings like
"true:gpu", "false", "true:cpu,gpu" pick execution devices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

#: accelerator-string platform names that mean the CUDA card
_GPU_NAMES = ("gpu", "cuda")


def cuda_available() -> bool:
    return torch.cuda.is_available()


def resolve_device(spec: Any = None) -> torch.device:
    """``None``/"cuda"/"cuda:N"/"cpu"/torch.device → a concrete
    torch.device (cuda with its index, so tensor placement compares
    equal). Raises when a card is asked for and none is present."""
    dev = torch.device("cuda" if spec is None else spec)
    if dev.type == "cuda":
        if not cuda_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda", torch.cuda.current_device()
                            if dev.index is None else dev.index)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {spec!r} (use cuda or cpu)")
    return dev


@dataclass(frozen=True)
class AcceleratorSpec:
    """Parsed ``accelerator=`` property value."""

    enabled: bool = True
    preference: Tuple[str, ...] = ()  # ordered platform names, e.g. ("gpu","cpu")

    @classmethod
    def parse(cls, value: Optional[str]) -> "AcceleratorSpec":
        if not value:
            return cls(True, ())
        s = str(value).strip().lower()
        if ":" in s:
            flag, prefs = s.split(":", 1)
        else:
            flag, prefs = s, ""
        enabled = flag in ("true", "1", "yes", "on", "auto", "")
        preference = tuple(p.strip() for p in prefs.split(",") if p.strip())
        return cls(enabled, preference)

    def pick_device(self, device: Any = None) -> torch.device:
        """Resolve to a torch.device honoring preference order; with no
        usable preference the device is cuda (raising without a card).
        An explicit ``device`` (the filter's and SingleShot's ``device=``)
        wins over the spec."""
        if device is not None:
            return resolve_device(device)
        if not self.enabled:
            return resolve_device("cpu")
        for plat in self.preference:
            if plat == "cpu":
                return resolve_device("cpu")
            if plat in _GPU_NAMES and cuda_available():
                return resolve_device("cuda")
        return resolve_device("cuda")
