"""nnstreamer_tpu_torch.sched — multi-tenant device dispatch (one engine,
many pipelines per card).

Port of nnstreamer_tpu/sched/. A central :class:`DeviceEngine` whose single
dispatch loop drains ready work from every registered tenant, coalesces
same-filter/same-shape items into one device batch
(``TorchCudaFilter.invoke_coalesced``), overlaps host pre/post processing
with device execution through a bounded window of CUDA events, and admits
fairly — weighted deficit-round-robin with strict priorities, a hard
starvation bound, and per-tenant deadline shedding riding
``resilience.Deadline``/``record_shed``.

Opt-in surfaces:
  * ``Pipeline(..., scheduler=engine)`` — this pipeline's filters route
    invokes through the engine (graph/pipeline.py);
  * ``install()`` — process-default engine: EVERY subsequently started
    pipeline enrolls via the ``SCHED_PIPELINE_HOOK`` global (the
    ``nns-launch --sched`` path); ``uninstall()`` reverts to direct
    dispatch. Unset, a pipeline's start pays one None check;
  * ``LMEngine.enroll(engine)`` — a serving engine's iteration steps share
    the card under the same fairness (serving/lm_engine.py).

The JAX package's ``sched/telemetry.py`` (the ``nnstpu_sched_*`` metric
families and ``sched.*`` events) waits for the port of obs (ROADMAP §A7).
"""

from __future__ import annotations

from typing import Optional

from .engine import SHED, DeviceEngine, Tenant, WorkFuture

_DEFAULT: Optional[DeviceEngine] = None


def install(name: str = "dev0", **knobs) -> DeviceEngine:
    """Create (or return) the process-default engine and point every
    subsequently started pipeline at it via the graph's scheduler hook.
    Idempotent; knobs apply on first install only."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = DeviceEngine(name, **knobs)
        from ..graph import pipeline as _gp
        _gp.SCHED_PIPELINE_HOOK = _default_for_pipeline
    return _DEFAULT


def uninstall() -> None:
    """Clear the default engine and its pipeline hook; stops the dispatch
    loop (queued work is shed by tenant deregistration as attached
    pipelines detach on stop)."""
    global _DEFAULT
    eng = _DEFAULT
    _DEFAULT = None
    from ..graph import pipeline as _gp
    _gp.SCHED_PIPELINE_HOOK = None
    if eng is not None:
        eng.stop()


def installed() -> Optional[DeviceEngine]:
    return _DEFAULT


def _default_for_pipeline(pipeline) -> Optional[DeviceEngine]:
    """SCHED_PIPELINE_HOOK target: hand the default engine to a starting
    pipeline that did not opt out with its own scheduler."""
    return _DEFAULT


__all__ = ["DeviceEngine", "SHED", "Tenant", "WorkFuture", "install",
           "installed", "uninstall"]
