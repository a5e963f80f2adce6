"""Per-node health state machine: ok -> busy -> degraded -> failed, and back.

The failure signals this plane collects used to be swallowed (a commit-
thread exception logged once and forgotten, the sealer still granting), or
fatal (ENOSPC mid-commit), or invisible (crypto-lane dispatcher death, a
node dialing dead peers forever). Each subsystem now REPORTS its fault
against a named component; the machine aggregates them into one node
state:

    ok         no live faults — full service
    busy       >= 1 overload report (utils/overload.py): the node is
               SATURATED, not sick — it keeps sealing, committing and
               accepting writes, but the serving edge shrinks per-client
               write budgets and gossip stops importing remote pending
               txs it could not seal anyway (brownout, not blackout)
    degraded   >= 1 recoverable fault: the node stops sealing and sheds
               writes with a typed error (TransactionStatus.NODE_DEGRADED)
               but keeps answering reads and serving sync/ops traffic
    failed     >= 1 fatal fault (a dead worker thread): reads still serve,
               but nothing that needs the dead component will recover
               without operator action

Self-healing: a fault may carry a `probe` callable. A small ticker thread
(started only while probed faults exist) re-runs each probe; a probe
returning True clears its fault — e.g. the storage ENOSPC fault probes by
attempting the same fsync path, so the node returns to `ok` the moment
space is back, without a restart. Components without probes are cleared
explicitly by their subsystem on the first success after the fault.

Surfaces: `getSystemStatus.health`, GET `/healthz` (200 while ok/busy,
503 while degraded/failed), and the `bcos_node_health` gauge (0 ok,
0.5 busy, 1 degraded, 2 failed — busy slots BETWEEN the older values so
existing dashboards/alerts on 0/1/2 keep their meaning unchanged).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from .log import LOG, badge

OK, BUSY, DEGRADED, FAILED = "ok", "busy", "degraded", "failed"
_RANK = {OK: 0, BUSY: 1, DEGRADED: 2, FAILED: 3}
# published gauge values: the 0/1/2 contract for ok/degraded/failed
# predates the busy step and is asserted by dashboards and CI — busy
# lands between ok and degraded instead of renumbering them
_GAUGE = {OK: 0.0, BUSY: 0.5, DEGRADED: 1.0, FAILED: 2.0}


class _Fault:
    __slots__ = ("severity", "reason", "since", "probe")

    def __init__(self, severity: str, reason: str,
                 probe: Optional[Callable[[], bool]]):
        self.severity = severity
        self.reason = reason
        self.since = time.monotonic()
        self.probe = probe


class Health:
    """One per node. Thread-safe; listeners and probes run OUTSIDE the
    lock (a probe may re-enter via clear/degraded)."""

    def __init__(self, registry=None, label: str = "",
                 probe_interval: float = 0.25):
        self._lock = threading.Lock()
        self._faults: dict[str, _Fault] = {}
        self._registry = registry
        self.label = label
        self.probe_interval = probe_interval
        # observers: callback(old_state, new_state) on every transition —
        # the node wires logging/metrics/sealing policy here
        self.on_change: list[Callable[[str, str], None]] = []
        self._ticker: Optional[threading.Thread] = None
        self._stopped = False
        self._publish(OK)

    # -- reporting ---------------------------------------------------------
    def busy(self, component: str, reason: str = "",
             probe: Optional[Callable[[], bool]] = None) -> None:
        """Overload report (utils/overload.py): the node is saturated but
        healthy — full service continues, brownout policies engage."""
        self._report(component, BUSY, reason, probe)

    def degraded(self, component: str, reason: str = "",
                 probe: Optional[Callable[[], bool]] = None) -> None:
        self._report(component, DEGRADED, reason, probe)

    def failed(self, component: str, reason: str = "",
               probe: Optional[Callable[[], bool]] = None) -> None:
        self._report(component, FAILED, reason, probe)

    def _report(self, component: str, severity: str, reason: str,
                probe: Optional[Callable[[], bool]]) -> None:
        with self._lock:
            old = self._state_locked()
            known = self._faults.get(component)
            if known is not None and known.severity == severity:
                known.reason = reason or known.reason
                known.probe = probe or known.probe
                new = old
            else:
                self._faults[component] = _Fault(severity, reason, probe)
                new = self._state_locked()
            need_ticker = any(f.probe is not None
                              for f in self._faults.values())
        if need_ticker:
            self._ensure_ticker()
        if new != old:
            LOG.error(badge("HEALTH", f"{old}->{new}", component=component,
                            reason=reason, node=self.label))
            self._transition(old, new)

    def clear(self, component: str) -> None:
        with self._lock:
            if component not in self._faults:
                return
            old = self._state_locked()
            self._faults.pop(component)
            new = self._state_locked()
        if new != old:
            LOG.warning(badge("HEALTH", f"{old}->{new}",
                              component=component, cleared=True,
                              node=self.label))
            self._transition(old, new)

    def _transition(self, old: str, new: str) -> None:
        self._publish(new)
        for cb in list(self.on_change):
            try:
                cb(old, new)
            except Exception:  # noqa: BLE001 — observers must not wedge us
                LOG.exception(badge("HEALTH", "observer-failed"))

    def _publish(self, state: str) -> None:
        if self._registry is not None:
            self._registry.set_gauge("bcos_node_health", _GAUGE[state])

    # -- queries -----------------------------------------------------------
    def _state_locked(self) -> str:
        worst = OK
        for f in self._faults.values():
            if _RANK[f.severity] > _RANK[worst]:
                worst = f.severity
        return worst

    def state(self) -> str:
        with self._lock:
            return self._state_locked()

    def writes_shed(self) -> bool:
        """True while writes must be refused with the typed error. Reads
        are NEVER shed — a degraded node keeps serving queries. A BUSY
        node is not shedding: it still accepts writes (the overload plane
        throttles them at the edge instead of refusing them outright)."""
        return _RANK[self.state()] >= _RANK[DEGRADED]

    def sealing_allowed(self) -> bool:
        """Busy nodes KEEP sealing — draining the backlog is the cure for
        overload; only degraded/failed stop proposing."""
        return _RANK[self.state()] < _RANK[DEGRADED]

    def snapshot(self) -> dict:
        now = time.monotonic()
        with self._lock:
            return {
                "state": self._state_locked(),
                "faults": {
                    c: {"severity": f.severity, "reason": f.reason,
                        "for_s": round(now - f.since, 3)}
                    for c, f in self._faults.items()},
            }

    # -- self-healing ticker -----------------------------------------------
    def _ensure_ticker(self) -> None:
        with self._lock:
            if self._ticker is not None and self._ticker.is_alive():
                return
            # a fault reported after stop() revives the ticker: a
            # stop()/start() cycled node must keep its self-healing (a
            # one-shot _stopped would leave post-restart probed faults
            # degraded forever)
            self._stopped = False
            self._ticker = threading.Thread(
                target=self._tick_loop, name="health-probe", daemon=True)
            self._ticker.start()

    def _tick_loop(self) -> None:
        while not self._stopped:
            time.sleep(self.probe_interval)
            with self._lock:
                probed = [(c, f.probe) for c, f in self._faults.items()
                          if f.probe is not None]
                if not probed:
                    self._ticker = None
                    return
            for component, probe in probed:
                try:
                    healed = bool(probe())
                except Exception as exc:  # noqa: BLE001 — still faulty
                    healed = False
                    with self._lock:
                        f = self._faults.get(component)
                        if f is not None:
                            f.reason = f"probe: {exc!r}"
                if healed:
                    self.clear(component)

    def stop(self) -> None:
        self._stopped = True


class HealthFanout:
    """Fan one shared subsystem's reports out to many nodes' Health
    instances (the process-wide p2p gateway / crypto lane in a multi-group
    daemon: its fault degrades EVERY group's node)."""

    def __init__(self, sinks: Optional[list[Health]] = None):
        self.sinks: list[Health] = list(sinks or [])

    def add(self, health: Health) -> None:
        self.sinks.append(health)

    def remove(self, health: Health) -> None:
        """Detach a departing node's Health (group removal) so shared-
        plane faults stop reporting into a stopped node."""
        try:
            self.sinks.remove(health)
        except ValueError:
            pass

    def busy(self, component: str, reason: str = "",
             probe: Optional[Callable[[], bool]] = None) -> None:
        for h in list(self.sinks):
            h.busy(component, reason, probe)

    def degraded(self, component: str, reason: str = "",
                 probe: Optional[Callable[[], bool]] = None) -> None:
        for h in list(self.sinks):
            h.degraded(component, reason, probe)

    def failed(self, component: str, reason: str = "",
               probe: Optional[Callable[[], bool]] = None) -> None:
        for h in list(self.sinks):
            h.failed(component, reason, probe)

    def clear(self, component: str) -> None:
        for h in list(self.sinks):
            h.clear(component)
