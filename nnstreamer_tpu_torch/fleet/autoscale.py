"""Autoscale policies — pure, deterministic scale decisions.

Port of nnstreamer_tpu/fleet/autoscale.py (stdlib only).

A policy is a function of the controller's observed signals (replica
count, aggregate queue depth, worst engine occupancy, SLO breach list)
to a :class:`Decision`. Policies hold their own anti-flap state —
hysteresis (N consecutive pressure ticks before acting), cooldown
(minimum quiet period between actions), and a deadband between the
scale-up and scale-in thresholds where the only legal answer is
``hold`` — so the controller itself stays a dumb reconcile loop.

Everything is clock-injectable and free of I/O: ``decide()`` on the
same tick sequence always yields the same action sequence, which is
what the seeded-chaos acceptance test pins.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

__all__ = ["Decision", "AutoscalePolicy", "PricedPolicy", "POLICIES",
           "parse_autoscale_spec"]


@dataclass
class Decision:
    """One policy verdict: ``action`` is ``"scale_up"``, ``"scale_in"``
    or ``"hold"``; ``reason`` is the human/journal explanation."""

    action: str
    reason: str
    count: int = 1
    signals: Dict[str, Any] = field(default_factory=dict)


class AutoscalePolicy:
    """Threshold policy with hysteresis, cooldown, and a deadband.

    Pressure definition: a tick is *up-pressure* when queue depth,
    occupancy, or an SLO breach exceeds the high thresholds;
    *down-pressure* when queue depth AND occupancy sit below the low
    thresholds with no breach. The gap between the two threshold pairs
    is the deadband — inside it both streaks reset and the policy
    holds, so a signal oscillating around one threshold can never flap
    the fleet. Acting requires ``hysteresis`` consecutive pressure
    ticks AND ``cooldown_s`` elapsed since the last action.
    """

    name = "default"

    def __init__(self, min_replicas: int, max_replicas: int, *,
                 queue_high: float = 8.0, queue_low: float = 1.0,
                 occupancy_high: float = 0.85, occupancy_low: float = 0.30,
                 hysteresis: int = 2, cooldown_s: float = 10.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if max_replicas < min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if queue_low > queue_high or occupancy_low > occupancy_high:
            raise ValueError("low thresholds must not exceed high "
                             "(the gap is the deadband)")
        if hysteresis < 1:
            raise ValueError("hysteresis must be >= 1")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.queue_high, self.queue_low = float(queue_high), float(queue_low)
        self.occupancy_high = float(occupancy_high)
        self.occupancy_low = float(occupancy_low)
        self.hysteresis = int(hysteresis)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._up_streak = 0
        self._down_streak = 0
        self._last_action_t: Optional[float] = None

    # -- pressure classification ------------------------------------------

    def _pressure(self, signals: Dict[str, Any]) -> Tuple[str, str]:
        """-> (direction, why) with direction in up/down/deadband."""
        queue = float(signals.get("queue_depth", 0.0) or 0.0)
        occ = float(signals.get("occupancy", 0.0) or 0.0)
        breached = signals.get("breached") or ()
        if breached:
            return "up", f"slo breach: {','.join(sorted(breached))}"
        if queue >= self.queue_high:
            return "up", f"queue {queue:g} >= {self.queue_high:g}"
        if occ >= self.occupancy_high:
            return "up", f"occupancy {occ:.2f} >= {self.occupancy_high:.2f}"
        if queue <= self.queue_low and occ <= self.occupancy_low:
            return "down", (f"queue {queue:g} <= {self.queue_low:g} and "
                            f"occupancy {occ:.2f} <= {self.occupancy_low:.2f}")
        return "deadband", "between thresholds"

    # -- the verdict ------------------------------------------------------

    def decide(self, signals: Dict[str, Any]) -> Decision:
        replicas = int(signals.get("replicas", 0) or 0)
        direction, why = self._pressure(signals)
        if direction == "up":
            self._up_streak += 1
            self._down_streak = 0
        elif direction == "down":
            self._down_streak += 1
            self._up_streak = 0
        else:  # deadband: both streaks reset — no slow drift into action
            self._up_streak = self._down_streak = 0
            return self._hold(why, signals)

        now = self._clock()
        if self._last_action_t is not None \
                and now - self._last_action_t < self.cooldown_s:
            return self._hold(f"cooldown ({why})", signals)
        if direction == "up":
            if replicas >= self.max_replicas:
                return self._hold(f"at max_replicas ({why})", signals)
            if self._up_streak < self.hysteresis:
                return self._hold(
                    f"hysteresis {self._up_streak}/{self.hysteresis} "
                    f"({why})", signals)
            return self._act("scale_up", why, signals, now)
        if replicas <= self.min_replicas:
            return self._hold(f"at min_replicas ({why})", signals)
        if self._down_streak < self.hysteresis:
            return self._hold(
                f"hysteresis {self._down_streak}/{self.hysteresis} "
                f"({why})", signals)
        return self._act("scale_in", why, signals, now)

    def _hold(self, reason: str, signals: Dict[str, Any]) -> Decision:
        return Decision("hold", reason, count=0, signals=dict(signals))

    def _act(self, action: str, reason: str, signals: Dict[str, Any],
             now: float) -> Decision:
        self._last_action_t = now
        self._up_streak = self._down_streak = 0
        return Decision(action, reason, count=1, signals=dict(signals))


class PricedPolicy(AutoscalePolicy):
    """Cost-model-priced variant: a scale-up must *pay for itself*.

    Spawning a replica costs ``spawn_cost_s`` (process start + compile
    warmup); a replica retires backlog at ``service_rate`` items/s. A
    scale-up is only worth it when the modeled time-to-drain of the
    current backlog on the current fleet exceeds the spawn cost — i.e.
    the new replica would come up before the queue clears anyway.
    Scale-in additionally prices the migration bill: holding one
    replica briefly is cheaper than migrating a large session census,
    so big-census down-pressure holds until the census shrinks or
    ``max_migration_sessions`` covers it.
    """

    name = "priced"

    def __init__(self, min_replicas: int, max_replicas: int, *,
                 spawn_cost_s: float = 5.0, service_rate: float = 4.0,
                 max_migration_sessions: int = 64, **kw: Any) -> None:
        super().__init__(min_replicas, max_replicas, **kw)
        if spawn_cost_s <= 0 or service_rate <= 0:
            raise ValueError("spawn_cost_s and service_rate must be > 0")
        self.spawn_cost_s = float(spawn_cost_s)
        self.service_rate = float(service_rate)
        self.max_migration_sessions = int(max_migration_sessions)

    def decide(self, signals: Dict[str, Any]) -> Decision:
        d = super().decide(signals)
        if d.action == "scale_up":
            replicas = max(1, int(signals.get("replicas", 1) or 1))
            queue = float(signals.get("queue_depth", 0.0) or 0.0)
            drain_s = queue / (replicas * self.service_rate)
            if not signals.get("breached") and drain_s < self.spawn_cost_s:
                # backlog clears before the new replica would be ready;
                # cooldown stamp stands, so this can't immediately re-fire
                return self._hold(
                    f"priced out: drain {drain_s:.1f}s < spawn "
                    f"{self.spawn_cost_s:.1f}s", signals)
            d.reason += f" (drain {drain_s:.1f}s >= spawn" \
                        f" {self.spawn_cost_s:.1f}s)" if queue else ""
        elif d.action == "scale_in":
            census = int(signals.get("victim_sessions", 0) or 0)
            if census > self.max_migration_sessions:
                return self._hold(
                    f"priced out: {census} sessions to migrate > "
                    f"{self.max_migration_sessions}", signals)
        return d


#: policy name -> class, the ``MIN:MAX[:policy]`` third field
POLICIES: Dict[str, type] = {
    "default": AutoscalePolicy,
    "priced": PricedPolicy,
}


def parse_autoscale_spec(spec: str) -> Tuple[int, int, str]:
    """Parse ``MIN:MAX[:policy]`` (the ``--autoscale`` argument).

    -> ``(min_replicas, max_replicas, policy_name)``; raises
    ``ValueError`` with a usage-ready message on any malformed spec.
    """
    parts = str(spec).split(":")
    if len(parts) not in (2, 3):
        raise ValueError(f"autoscale spec {spec!r}: want MIN:MAX[:policy]")
    try:
        mn, mx = int(parts[0]), int(parts[1])
    except ValueError:
        raise ValueError(f"autoscale spec {spec!r}: MIN and MAX must be "
                         "integers") from None
    if mn < 1:
        raise ValueError(f"autoscale spec {spec!r}: MIN must be >= 1")
    if mx < mn:
        raise ValueError(f"autoscale spec {spec!r}: MAX must be >= MIN")
    policy = parts[2] if len(parts) == 3 else "default"
    if policy not in POLICIES:
        raise ValueError(f"autoscale spec {spec!r}: unknown policy "
                         f"{policy!r} (one of {sorted(POLICIES)})")
    return mn, mx, policy
