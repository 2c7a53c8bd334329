"""The reconcile loop: observe → decide → act, with a bounded action
journal that rides fleet push docs.

Port of nnstreamer_tpu/fleet/controller.py (stdlib only).

:class:`FleetController` closes the telemetry arc — burn rates
(obs/slo.py), queue depths + routable census (obs/fleet.py's
aggregator), and engine occupancy (sched/engine.py's
``AUTOSCALE_HOOK`` callback) flow IN; backend add/drain/remove and live
session migration (fleet/migrate.py) flow OUT through the router.
Every action is journaled (``/debug/fleet/actions``), priced by the
policy (fleet/autoscale.py), gated by a circuit breaker
(``_rp.fleet_breaker_name``), and bounded by a deadline — an
autoscaler that hangs or flaps is worse than none.

Determinism contract: ``reconcile_once()`` with an injectable clock is
a pure function of the observed signals and policy state — the
acceptance test drives ticks by hand and the background thread
(``start()``) is just ``reconcile_once`` on a timer.
"""

from __future__ import annotations

import http.client
import socket
import subprocess
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from ..core.log import logger
from ..graph.element import join_or_warn
from ..obs import diag as _diag
from ..obs import events as _events
from ..obs import metrics as _obs
from ..resilience import policy as _rp
from .autoscale import AutoscalePolicy, Decision
from .migrate import SessionMigrator

log = logger("fleet")

_reg = _obs.registry()
_REPLICAS = _reg.gauge(
    "nnstpu_fleet_worker_replicas",
    "Active backend replicas under controller management", ("controller",))
_SCALE_ACTIONS = _reg.counter(
    "nnstpu_fleet_scale_actions_total",
    "Reconcile actions taken (and skips, labeled)",
    ("controller", "action"))


def _free_port(host: str) -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        s.bind((host, 0))
        return s.getsockname()[1]
    finally:
        s.close()


@dataclass
class LaunchHandle:
    """One launched worker: its query endpoint, readiness port, and the
    process to terminate on scale-in."""

    endpoint: str
    ready_port: int
    proc: Any = None


class BackendLauncher:
    """Subprocess launcher with readiness gating on ``/readyz``.

    ``argv_template`` is the worker command with ``{host}``, ``{port}``
    (query wire) and ``{ready_port}`` (metrics exporter) placeholders —
    e.g. ``["python", "-m", "worker", "--port", "{port}", "--metrics",
    "{ready_port}"]``. ``launch()`` picks free ports, spawns, then
    polls ``http://host:ready_port/readyz`` until it answers 200 (the
    exporter's readiness contract) before handing the endpoint to the
    router — a backend is never routable before it can serve.
    """

    def __init__(self, argv_template: List[str], *,
                 host: str = "127.0.0.1", ready_timeout_s: float = 30.0,
                 poll_interval_s: float = 0.1) -> None:
        self.argv_template = list(argv_template)
        self.host = host
        self.ready_timeout_s = float(ready_timeout_s)
        self.poll_interval_s = float(poll_interval_s)

    def launch(self) -> LaunchHandle:
        port, ready_port = _free_port(self.host), _free_port(self.host)
        argv = [a.format(host=self.host, port=port, ready_port=ready_port)
                for a in self.argv_template]
        proc = subprocess.Popen(argv)
        handle = LaunchHandle(f"{self.host}:{port}", ready_port, proc)
        try:
            self._await_ready(handle)
        except Exception:
            self.terminate(handle)
            raise
        return handle

    def _await_ready(self, handle: LaunchHandle) -> None:
        t_end = time.monotonic() + self.ready_timeout_s
        while time.monotonic() < t_end:
            if handle.proc is not None and handle.proc.poll() is not None:
                raise RuntimeError(
                    f"worker {handle.endpoint} exited rc="
                    f"{handle.proc.returncode} before ready")
            try:
                conn = http.client.HTTPConnection(
                    self.host, handle.ready_port, timeout=1.0)
                try:
                    conn.request("GET", "/readyz")
                    if conn.getresponse().status == 200:
                        return
                finally:
                    conn.close()
            except OSError:
                pass
            time.sleep(self.poll_interval_s)
        raise TimeoutError(
            f"worker {handle.endpoint} not ready within "
            f"{self.ready_timeout_s:.0f}s")

    def terminate(self, handle: LaunchHandle) -> None:
        proc = handle.proc
        if proc is None or proc.poll() is not None:
            return
        proc.terminate()
        try:
            proc.wait(timeout=5.0)
        except Exception:
            proc.kill()


class FleetController:
    """SLO-driven reconcile loop over a :class:`QueryRouter`.

    ``launcher`` is anything with ``launch() -> handle`` (the handle
    exposing ``.endpoint``) and ``terminate(handle)`` —
    :class:`BackendLauncher` for real subprocess workers, or an
    in-process shim in tests. Without one the controller still drains,
    migrates, and scales in; scale-up decisions journal as skipped.
    """

    def __init__(self, router: Any, policy: AutoscalePolicy, *,
                 launcher: Any = None, aggregator: Any = None,
                 migrator: Optional[SessionMigrator] = None,
                 restorer: Any = None,
                 interval_s: float = 1.0,
                 drain_timeout_s: float = 30.0,
                 journal_limit: int = 256,
                 name: str = "fleet",
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.router = router
        self.policy = policy
        self.launcher = launcher
        self.aggregator = aggregator
        self.migrator = migrator or SessionMigrator(router, clock=clock)
        # built lazily (fleet/checkpoint.py import) on the first dead
        # instance — controllers that never see a crash never pay it
        self._restorer = restorer
        self.interval_s = float(interval_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self.name = name
        self._clock = clock
        self._breaker = _rp.CircuitBreaker(_rp.fleet_breaker_name(name))
        self._journal: deque = deque(maxlen=int(journal_limit))
        self._seq = 0
        #: the signal snapshot the CURRENT tick decided on — journaled
        #: with every action so each entry records the evidence
        #: (occupancy, burn, census) that crossed the threshold
        self._last_signals: Dict[str, Any] = {}
        self._occ: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._launched: Dict[str, LaunchHandle] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.stats: Dict[str, int] = {
            "ticks": 0, "scale_up": 0, "scale_in": 0, "holds": 0,
            "migrations": 0, "restores": 0, "upgrades": 0}

    # -- signals (IN) -----------------------------------------------------

    def observe_occupancy(self, engine: str, occupancy: float) -> None:
        """The sched ``AUTOSCALE_HOOK`` target: latest busy fraction per
        engine, sampled at batch boundaries."""
        with self._lock:
            self._occ[str(engine)] = float(occupancy)

    def observe(self) -> Dict[str, Any]:
        """One consistent signal snapshot for the policy."""
        active = [be for be in self.router.backends.backends()
                  if be.state == "active"]
        signals: Dict[str, Any] = {
            "replicas": len(active),
            "queue_depth": 0.0,
            "occupancy": 0.0,
            "breached": [],
            "routable": len(active),
        }
        with self._lock:
            if self._occ:
                signals["occupancy"] = max(self._occ.values())
        if self.aggregator is not None:
            agg = self.aggregator.scale_signals()
            signals["queue_depth"] = agg.get("queue_depth", 0.0)
            signals["breached"] = agg.get("breached", [])
            signals["routable"] = agg.get("routable", len(active))
        if active:
            victim = self._pick_victim(active)
            signals["victim_sessions"] = len(
                self.router.backends.sessions_owned(victim.endpoint))
        return signals

    # -- the loop ---------------------------------------------------------

    def reconcile_once(self) -> Decision:
        """One deterministic tick: restore the dead, then
        observe → decide → act → journal."""
        self.stats["ticks"] += 1
        # crash-restore BEFORE observing: a just-tombstoned instance
        # must be re-pinned onto survivors before the policy reads the
        # census, or one tick of decisions is made against ghosts
        self.restore_dead()
        signals = self.observe()
        self._last_signals = signals
        decision = self.policy.decide(signals)
        _REPLICAS.labels(self.name).set(float(signals["replicas"]))
        if decision.action == "scale_up":
            self._scale_up(decision)
        elif decision.action == "scale_in":
            self._scale_in(decision)
        else:
            self.stats["holds"] += 1
        return decision

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(self.interval_s):
                try:
                    self.reconcile_once()
                except Exception:  # a sick controller must not crash serving
                    log.exception("reconcile tick failed")

        self._thread = threading.Thread(
            target=loop, name="fleet-controller", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        self._thread = None
        if t is not None:
            join_or_warn(t, f"fleet:{self.name}", timeout=5.0)

    # -- actions (OUT) ----------------------------------------------------

    def _journal_add(self, action: str, reason: str,
                     **extra: Any) -> Dict[str, Any]:
        self._seq += 1
        entry = {"seq": self._seq, "t": self._clock(), "action": action,
                 "reason": reason,
                 "signals": dict(self._last_signals), **extra}
        self._journal.append(entry)
        _SCALE_ACTIONS.labels(self.name, action).inc()
        dhook = _diag.DIAG_HOOK
        if dhook is not None:
            # real scale/migrate actions are diag capture triggers
            # (the hook ignores skips/holds); the journaled entry rides
            # inside the bundle's cause detail
            dhook.on_fleet_action(action, entry)
        return entry

    def actions(self) -> List[Dict[str, Any]]:
        """The bounded action journal — the ``FLEET_ACTIONS_HOOK``
        target (rides push docs) and the ``/debug/fleet/actions``
        payload."""
        return list(self._journal)

    def _scale_up(self, decision: Decision) -> None:
        if not self._breaker.allow():
            self._journal_add("scale_up_skipped",
                              f"breaker open ({decision.reason})")
            return
        if self.launcher is None:
            self._journal_add("scale_up_skipped",
                              f"no launcher ({decision.reason})")
            return
        try:
            handle = self.launcher.launch()
            self.router.add_backend(handle.endpoint)
        except Exception as e:
            self._breaker.record_failure()
            self._journal_add("scale_up_failed",
                              f"{type(e).__name__}: {e}")
            _events.record("fleet.scale_up",
                           f"launch failed: {e}", severity="warning",
                           controller=self.name, error=str(e))
            return
        self._breaker.record_success()
        self._launched[handle.endpoint] = handle
        self._register_kill(handle)
        self.stats["scale_up"] += 1
        self._journal_add("scale_up", decision.reason,
                          endpoint=handle.endpoint)
        _events.record("fleet.scale_up",
                       f"added {handle.endpoint}: {decision.reason}",
                       controller=self.name, endpoint=handle.endpoint)

    def _pick_victim(self, active: List[Any]) -> Any:
        """Deterministic scale-in victim: fewest owned sessions, then
        lexicographic endpoint — same snapshot, same victim."""
        owned = self.router.backends.sessions_owned
        return min(active, key=lambda be: (len(owned(be.endpoint)),
                                           be.endpoint))

    def _scale_in(self, decision: Decision) -> None:
        active = [be for be in self.router.backends.backends()
                  if be.state == "active"]
        if len(active) < 2:
            self._journal_add("scale_in_skipped", "single replica")
            return
        victim = self._pick_victim(active)
        sessions = self.router.backends.sessions_owned(victim.endpoint)
        migrated: List[Dict[str, Any]] = []
        dl = _rp.Deadline.after_s(self.drain_timeout_s)
        for s in sorted(sessions):
            target = self.router.backends.pick(
                session=s, exclude={victim.endpoint})
            if target is None:
                continue
            migrated.append(self.migrator.migrate(s, victim, target,
                                                  deadline=dl))
            self.stats["migrations"] += 1
        # drain AFTER migration: the sessions are already re-pinned, so
        # the eager drain re-pin finds nothing left to move
        try:
            self.router.remove_backend(victim.endpoint, drain=True)
        except KeyError:
            pass
        if self.aggregator is not None:
            self.aggregator.confirm_drain(victim.instance
                                          or victim.endpoint)
        handle = self._launched.pop(victim.endpoint, None)
        if handle is not None and self.launcher is not None:
            self.launcher.terminate(handle)
        self._unregister_kill(victim.endpoint)
        self.stats["scale_in"] += 1
        self._journal_add(
            "scale_in", decision.reason, endpoint=victim.endpoint,
            migrated=sum(1 for m in migrated if m["ok"]),
            absorbed=sum(1 for m in migrated if m["absorbed"]))
        _events.record("fleet.scale_in",
                       f"drained {victim.endpoint}: {decision.reason} "
                       f"({len(migrated)} sessions migrated)",
                       controller=self.name, endpoint=victim.endpoint,
                       sessions=len(migrated))

    # -- crash restore ----------------------------------------------------

    def _register_kill(self, handle: Any) -> None:
        """Expose a launched subprocess to the chaos ``kill`` fault so
        the crash-restore acceptance test can SIGKILL it by endpoint.
        Registration is a dict insert — free when chaos is off."""
        proc = getattr(handle, "proc", None)
        if proc is None:
            return
        from ..resilience import chaos as _chaos
        _chaos.register_kill_target(handle.endpoint, proc)

    def _unregister_kill(self, endpoint: str) -> None:
        from ..resilience import chaos as _chaos
        _chaos.unregister_kill_target(endpoint)

    def _restorer_get(self) -> Any:
        if self._restorer is None:
            from .checkpoint import SessionRestorer
            self._restorer = SessionRestorer(self.router,
                                             clock=self._clock)
        return self._restorer

    def restore_dead(self) -> List[Dict[str, Any]]:
        """The ``restore`` reconcile action: claim every tombstoned
        instance the aggregator declared dead-without-drain, re-pin its
        sessions onto survivors, and splice checkpoints (fresh) or fall
        back to re-prefill (stale/missing) — see fleet/checkpoint.py.

        ``consume_restore`` is an atomic first-caller-wins claim, so
        concurrent controllers (or a tick racing the background thread)
        never restore the same instance twice.
        """
        if self.aggregator is None:
            return []
        reports: List[Dict[str, Any]] = []
        for row in self.aggregator.restorables():
            payload = self.aggregator.consume_restore(row["instance"])
            if payload is None:
                continue  # another claimant won the race
            ep = payload["endpoint"]
            # reap the corpse first: a dead subprocess handle must not
            # linger as a terminate target or a chaos kill victim
            handle = self._launched.pop(ep, None)
            if handle is not None and self.launcher is not None:
                self.launcher.terminate(handle)
            self._unregister_kill(ep)
            try:
                report = self._restorer_get().restore_instance(
                    payload["instance"], ep,
                    payload.get("checkpoints"),
                    deadline=_rp.Deadline.after_s(self.drain_timeout_s))
            except Exception as e:
                self._journal_add("restore_failed",
                                  f"{type(e).__name__}: {e}", endpoint=ep)
                log.exception("restore of %s failed", ep)
                continue
            self.aggregator.confirm_drain(payload["instance"])
            self.stats["restores"] += 1
            self._journal_add(
                "restore",
                f"instance {payload['instance']} died at {ep}",
                endpoint=ep, sessions=report["sessions"],
                restored=report["restored"],
                re_prefilled=report["re_prefilled"])
            reports.append(report)
        return reports

    # -- rolling upgrade --------------------------------------------------

    def upgrade(self, *,
                checkpoint: Optional[Callable[[], Any]] = None
                ) -> Dict[str, Any]:
        """Rolling upgrade: for each active backend in turn —
        checkpoint → drain one → terminate → relaunch behind the
        launcher's ``/readyz`` gate → confirm → next.

        ``checkpoint`` is an optional pre-drain tick (usually the
        :class:`~..fleet.checkpoint.CheckpointDaemon`'s ``run_once``)
        so every session has a fresh snapshot before its owner goes
        down — a mid-upgrade crash then restores instead of
        re-prefilling. Confirmation is the SLO burn tap: any breached
        window after a step aborts the remaining plan, leaving the
        fleet in a mixed-version but healthy state.
        """
        plan = sorted(be.endpoint
                      for be in self.router.backends.backends()
                      if be.state == "active")
        report: Dict[str, Any] = {"plan": list(plan), "upgraded": [],
                                  "aborted": None}
        if self.launcher is None:
            report["aborted"] = "no launcher"
            self._journal_add("upgrade_skipped", "no launcher")
            return report
        self._journal_add("upgrade_start", f"{len(plan)} backend(s)",
                          plan=list(plan))
        _events.record("fleet.upgrade",
                       f"rolling upgrade of {len(plan)} backend(s)",
                       controller=self.name, backends=len(plan))
        for ep in plan:
            victim = next((be for be in self.router.backends.backends()
                           if be.endpoint == ep and be.state == "active"),
                          None)
            if victim is None:
                continue  # vanished since the plan snapshot
            if checkpoint is not None:
                try:
                    checkpoint()
                except Exception:
                    log.exception("pre-drain checkpoint tick failed")
            # drain one: live-migrate every owned session, then drain
            dl = _rp.Deadline.after_s(self.drain_timeout_s)
            migrated = 0
            for s in sorted(self.router.backends.sessions_owned(ep)):
                target = self.router.backends.pick(session=s,
                                                   exclude={ep})
                if target is None:
                    continue
                m = self.migrator.migrate(s, victim, target, deadline=dl)
                migrated += 1 if m["ok"] else 0
                self.stats["migrations"] += 1
            try:
                self.router.remove_backend(ep, drain=True)
            except KeyError:
                pass
            if self.aggregator is not None:
                self.aggregator.confirm_drain(victim.instance or ep)
            # terminate the old worker
            handle = self._launched.pop(ep, None)
            if handle is not None:
                self.launcher.terminate(handle)
            self._unregister_kill(ep)
            # relaunch: launch() blocks behind the /readyz gate, so the
            # replacement is never routable before it can serve
            try:
                new = self.launcher.launch()
                self.router.add_backend(new.endpoint)
            except Exception as e:
                report["aborted"] = f"relaunch failed: {e}"
                self._journal_add("upgrade_abort",
                                  f"relaunch after {ep} failed: {e}",
                                  endpoint=ep)
                _events.record("fleet.upgrade",
                               f"aborted: relaunch after {ep} failed: {e}",
                               severity="warning", controller=self.name,
                               endpoint=ep)
                return report
            self._launched[new.endpoint] = new
            self._register_kill(new)
            report["upgraded"].append({"old": ep, "new": new.endpoint,
                                       "migrated": migrated})
            self._journal_add("upgrade_step", f"{ep} -> {new.endpoint}",
                              old=ep, new=new.endpoint, migrated=migrated)
            # confirm: the SLO burn tap decides whether to continue
            if self.aggregator is not None:
                breached = self.aggregator.scale_signals().get(
                    "breached", [])
                if breached:
                    report["aborted"] = f"slo breach: {breached}"
                    self._journal_add(
                        "upgrade_abort",
                        f"SLO burn breached after {ep}: {breached}",
                        endpoint=ep, breached=list(breached))
                    _events.record(
                        "fleet.upgrade",
                        f"aborted after {ep}: SLO burn {breached}",
                        severity="warning", controller=self.name,
                        endpoint=ep)
                    return report
        self.stats["upgrades"] += 1
        self._journal_add("upgrade_done",
                          f"{len(report['upgraded'])} backend(s) upgraded")
        _events.record("fleet.upgrade",
                       f"done: {len(report['upgraded'])} backend(s)",
                       controller=self.name,
                       backends=len(report["upgraded"]))
        return report

    def snapshot(self) -> Dict[str, Any]:
        """The ``/debug/fleet/actions`` payload."""
        with self._lock:
            occ = dict(self._occ)
        return {
            "controller": self.name,
            "policy": type(self.policy).name,
            "min_replicas": self.policy.min_replicas,
            "max_replicas": self.policy.max_replicas,
            "stats": dict(self.stats),
            "occupancy": occ,
            "migrator": dict(self.migrator.stats),
            "actions": self.actions(),
        }
