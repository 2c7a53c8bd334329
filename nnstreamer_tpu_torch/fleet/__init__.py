"""fleet/ — SLO-driven autoscaling with live drain and zero-loss
stream migration.

Port of nnstreamer_tpu/fleet/__init__.py (stdlib only).

The first subsystem that *acts* on the telemetry arc: obs/slo.py burns,
obs/fleet.py routing_view load, and sched/ engine occupancy feed a
reconcile-loop :class:`~nnstreamer_tpu_torch.fleet.controller.FleetController`
that scales a routed backend set up and in through a pluggable, priced
policy (fleet/autoscale.py) — and migrates live sessions off draining
backends over the existing KV_PAGE_XFER wire (fleet/migrate.py) so a
scale-in never kills a stream.

fleet/checkpoint.py extends the arc to crashes: a
:class:`~nnstreamer_tpu_torch.fleet.checkpoint.CheckpointDaemon` snapshots
live sessions into a pluggable store, and when the aggregator
tombstones an instance without a drain the controller's ``restore``
reconcile action re-pins its sessions onto survivors and splices the
freshest valid checkpoint back in (stale/missing falls back to
re-prefill, token-identically either way). ``upgrade()`` rides the
same machinery for rolling upgrades: checkpoint → drain one →
terminate → relaunch behind ``/readyz`` → confirm via the SLO burn
tap → next.

Zero-overhead contract: the only hot-path wiring is the module global
:data:`AUTOSCALE_HOOK`, gated exactly like ``TUNE_HOOK`` —

    hook = _fleet.AUTOSCALE_HOOK
    if hook is not None:
        hook.observe_occupancy(...)

one attribute load and a None test when autoscaling is off.
``enable()`` / ``disable()`` are the only writers of the hook
(enforced by nnslint's fleet rule).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from .autoscale import (POLICIES, AutoscalePolicy, Decision, PricedPolicy,
                        parse_autoscale_spec)

__all__ = ["AUTOSCALE_HOOK", "AutoscalePolicy", "PricedPolicy", "Decision",
           "POLICIES", "parse_autoscale_spec", "enable", "disable",
           "enabled", "controller", "snapshot"]

#: the None-gated controller hook. None (the default) means no wired
#: site — sched's occupancy sampler, the exporter's debug route, the
#: push-doc journal — pays more than one attribute load. Assigned only
#: by :func:`enable`/:func:`disable` below (nnslint ownership rule).
AUTOSCALE_HOOK: Optional["Any"] = None


def enable(router: Any, min_replicas: int, max_replicas: int, *,
           policy: str = "default", launcher: Any = None,
           aggregator: Any = None, start: bool = False,
           policy_kw: Optional[Dict[str, Any]] = None,
           **kw: Any) -> Any:
    """Build and install the process-global fleet controller.

    ``policy`` names an entry of :data:`POLICIES`; ``policy_kw``
    reaches its constructor (thresholds, hysteresis, cooldown), extra
    ``**kw`` the controller's. An injected ``clock`` is shared with
    the policy unless ``policy_kw`` overrides it — one fake clock
    drives the whole decision path. The obs/fleet.py
    ``FLEET_ACTIONS_HOOK`` is installed so the action journal rides
    push docs; ``start=True`` also spins the background reconcile
    thread (tests drive ``reconcile_once()`` by hand instead).
    """
    global AUTOSCALE_HOOK
    if AUTOSCALE_HOOK is not None:
        return AUTOSCALE_HOOK
    from .controller import FleetController

    pkw = dict(policy_kw or {})
    if "clock" in kw:
        pkw.setdefault("clock", kw["clock"])
    pol = POLICIES[policy](min_replicas, max_replicas, **pkw)
    ctl = FleetController(router, pol, launcher=launcher,
                          aggregator=aggregator, **kw)
    # the journal federates exactly like tune configs: a None-gated
    # module hook on obs/fleet.py, carried in every push doc
    from ..obs import fleet as _obsfleet

    _obsfleet.FLEET_ACTIONS_HOOK = ctl.actions
    AUTOSCALE_HOOK = ctl
    if start:
        ctl.start()
    return ctl


def disable() -> None:
    """Uninstall the controller and stop its reconcile thread."""
    global AUTOSCALE_HOOK
    ctl = AUTOSCALE_HOOK
    AUTOSCALE_HOOK = None
    from ..obs import fleet as _obsfleet

    _obsfleet.FLEET_ACTIONS_HOOK = None
    if ctl is not None:
        ctl.stop()


def enabled() -> bool:
    return AUTOSCALE_HOOK is not None


def controller() -> Optional[Any]:
    return AUTOSCALE_HOOK


def snapshot() -> Optional[Dict[str, Any]]:
    """The ``/debug/fleet/actions`` payload (None when off)."""
    ctl = AUTOSCALE_HOOK
    return None if ctl is None else ctl.snapshot()
