"""tune/ — learned autotuner closing the profiler's measure→act loop.

Port of nnstreamer_tpu/tune (stdlib and numpy). The store's device axis is
the CUDA card's name (``torch.cuda.get_device_name()``), ``"cpu"`` without
one. Flash attention's knob is its CUDA kernel's launch configuration
(ops/kernels/flash_attention.py), not the Pallas block shapes. Tuned
configurations ride the fleet's push docs and push-acks
(``obs.fleet.TUNE_PUSH_HOOK``/``TUNE_ADOPT_HOOK``). The router reads ``Tuner.auto_hedge`` to arm hedging from its observed P95.

``obs/profile.py`` records per-dispatch cost samples; this package
*acts* on them. A :class:`~nnstreamer_tpu_torch.tune.tuner.Tuner` owns the
knobs that used to be hand-set — flash-attention block shapes, the LM
engine's prefill chunk and KV page size, the spec-decode draft length,
the XLA bucket-ladder rung, the router's hedge delay — and resolves
each from (in order) its persistent store, a cost model fit over the
profiler's samples, or a bounded measured sweep. Results persist keyed
by ``(device_kind, label, shape_sig)`` and federate through
``obs/fleet.py`` push docs, so a fleet pays any sweep once, ever.

Zero-overhead contract: every wired call site gates on the module
global :data:`TUNE_HOOK` exactly like the profiler hooks —

    tn = _tune.TUNE_HOOK
    if tn is not None:
        value = tn.pick(...)

one attribute load and a None test when tuning is off, and the tuned
value is whatever the site's hand-set default was. ``enable()`` /
``disable()`` are the only writers of the hook (enforced by nnslint's
tune rule).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

from .model import CostModel
from .store import TuneStore
from .tuner import Tuner, shape_sig

__all__ = ["TUNE_HOOK", "CostModel", "TuneStore", "Tuner", "shape_sig",
           "enable", "disable", "enabled", "tuner", "report",
           "snapshot", "device_kind"]

#: the None-gated autotuner hook. None (the default) means every wired
#: knob site uses its hand-set default at zero added cost; a
#: :class:`Tuner` here means sites resolve knobs through it. Assigned
#: only by :func:`enable`/:func:`disable` below (and obs/profile.py,
#: per the nnslint ownership rule).
TUNE_HOOK: Optional[Tuner] = None

#: default on-disk store when ``enable()`` gets no path: the CLI's
#: ``--tune`` bare form and the env transport both land here
DEFAULT_STORE_ENV = "NNSTPU_TUNE_STORE"
DEFAULT_STORE = ".nnstpu_tune.json"


def device_kind() -> str:
    """The store key's device axis: the current CUDA card's name
    (``"NVIDIA H100 80GB HBM3"``-style), ``"cpu"`` without a card.
    Failure-tolerant — the tuner must key something even when CUDA is
    mid-initialisation."""
    try:
        import torch

        if not torch.cuda.is_available():
            return "cpu"
        return str(torch.cuda.get_device_name())
    except Exception:
        return "unknown"


def enable(store_path: Optional[str] = None, max_trials: int = 8,
           fit_from_profiler: bool = True) -> Tuner:
    """Build and install the process-global tuner.

    ``store_path`` None resolves through $NNSTPU_TUNE_STORE then the
    ``.nnstpu_tune.json`` default; the file is loaded when present
    (warm store → zero sweeps). When the live profiler already holds
    samples the cost model is fit from them immediately; either way
    the fleet hooks are installed so tuned configs ride push docs and
    push-acks.
    """
    global TUNE_HOOK
    if TUNE_HOOK is not None:
        return TUNE_HOOK
    path = store_path or os.environ.get(DEFAULT_STORE_ENV) \
        or DEFAULT_STORE
    tn = Tuner(store=TuneStore(path), max_trials=max_trials)
    if fit_from_profiler:
        try:
            from ..obs import profile as _profile

            rows = _profile.profiler().samples()
            if rows:
                tn.fit(rows)
        except Exception:
            pass
    # federation: the push doc carries the store, the push-ack merges
    # the fleet's — both None-gated module hooks on obs/fleet.py
    from ..obs import fleet as _fleet

    _fleet.TUNE_PUSH_HOOK = tn.push_doc
    _fleet.TUNE_ADOPT_HOOK = tn.adopt
    TUNE_HOOK = tn
    return tn


def disable(save: bool = True) -> None:
    """Uninstall the tuner and (by default) persist its store."""
    global TUNE_HOOK
    tn = TUNE_HOOK
    TUNE_HOOK = None
    from ..obs import fleet as _fleet

    _fleet.TUNE_PUSH_HOOK = None
    _fleet.TUNE_ADOPT_HOOK = None
    if tn is not None and save and tn.store.path and tn.store.dirty:
        try:
            tn.store.save()
        except OSError:
            pass


def enabled() -> bool:
    return TUNE_HOOK is not None


def tuner() -> Optional[Tuner]:
    return TUNE_HOOK


def snapshot() -> Optional[Dict[str, Any]]:
    """The ``/debug/tune`` payload (None when tuning is off)."""
    tn = TUNE_HOOK
    return None if tn is None else tn.snapshot()


def report() -> str:
    tn = TUNE_HOOK
    return "autotuner: off" if tn is None else tn.report()
