"""OverloadController — one per-node overload score, and the brownout it
drives.

PERF r10/r12 measured a hard capacity ceiling (~5k TPS of GIL-held Python
per process, consensus-RTT-bound at 4 nodes), so sustained offered load
WILL exceed capacity; the Blockchain Machine thesis (PAPERS.md, arXiv
2104.06968) is to shed and filter at the front-end before the load
consumes the expensive pipeline, and the hardware-assisted-BFT paper
(arXiv 1612.04997) names consensus as the scarce resource worth
protecting. This controller is the node-local closing of that loop:

  * **Signals.** Named callables each returning a saturation fraction
    (~1.0 = that stage is full): the scheduler's decided-but-uncommitted
    commit backlog, the ingest lane's queue occupancy, and the txpool's
    fill against its high watermark. The node wires them in init/node.py;
    anything else (WS fan-out depth, compaction debt) can register too.
  * **Score.** max() over the signals — any one saturated stage means the
    node is overloaded — smoothed with an EWMA so a single burst doesn't
    trip it.
  * **Hysteresis.** Enter `busy` only after the smoothed score holds at or
    above `enter` for `hold_s`; leave only after it holds at or below
    `exit` (a LOWER threshold) for `hold_s`. Oscillating load sits between
    the thresholds without flapping.
  * **Brownout, not blackout.** While busy the controller (a) reports the
    new `busy` step into the health plane (sealing and commits CONTINUE —
    draining is the cure), (b) shrinks the serving edge's per-client
    WRITE token rate by `busy_write_factor` (reads keep full budgets, so
    a write storm cannot brown out the read plane), and (c) tells gossip
    (net/txsync.py) to stop importing remote pending txs — a saturated
    follower must not amplify load it cannot seal; the anti-entropy sweep
    re-delivers once it heals. Reads, sync, and consensus keep full
    service throughout.

The sampler is a small ticker thread (default 100 ms — one max() over
three snapshot reads per tick); `sample_once()` is the same step exposed
for deterministic tests.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from .log import LOG, badge

# the health-plane component name busy reports land under
COMPONENT = "overload"


class OverloadController:
    def __init__(self, health=None, registry=None, label: str = "",
                 enter: float = 0.85, exit: float = 0.5,
                 hold_s: float = 0.5, interval: float = 0.1,
                 alpha: float = 0.3, busy_write_factor: float = 0.25,
                 clock: Optional[Callable[[], float]] = None):
        self.health = health
        self._registry = registry
        self.label = label
        self.enter = float(enter)
        # exit must sit BELOW enter or the hysteresis band is empty and
        # a score hovering at the threshold flaps busy<->ok every tick
        self.exit = min(float(exit), self.enter)
        self.hold_s = max(0.0, float(hold_s))
        self.interval = max(0.01, float(interval))
        self.alpha = min(1.0, max(0.01, float(alpha)))
        self.busy_write_factor = min(1.0, max(0.0,
                                              float(busy_write_factor)))
        self._clock = clock or time.monotonic
        self._signals: dict[str, Callable[[], float]] = {}
        self._lock = threading.Lock()
        self._score = 0.0          # EWMA
        self._last: dict[str, float] = {}
        self._busy = False
        self._edge_since: Optional[float] = None  # crossing pending hold
        self._transitions = 0
        self._busy_entered_at: Optional[float] = None
        self._busy_seconds = 0.0
        self._ticker: Optional[threading.Thread] = None
        self._stopped = False

    # -- wiring ------------------------------------------------------------
    def add_signal(self, name: str, fn: Callable[[], float]) -> None:
        """Register a saturation signal (callable -> fraction; ~1.0 = that
        stage is full). Snapshot reads only — they run every tick."""
        self._signals[name] = fn

    def start(self) -> None:
        if self._ticker is not None:
            return
        self._stopped = False
        self._ticker = threading.Thread(target=self._run, daemon=True,
                                        name="overload-ctl")
        self._ticker.start()

    def stop(self) -> None:
        self._stopped = True
        t = self._ticker
        if t is not None:
            t.join(timeout=2.0)
        self._ticker = None

    def _run(self) -> None:
        while not self._stopped:
            time.sleep(self.interval)
            try:
                self.sample_once()
            except Exception:  # noqa: BLE001 — a bad signal must not kill
                LOG.exception(badge("OVERLOAD", "sample-failed"))

    # -- the sampling step (public for deterministic tests) ----------------
    def sample_once(self) -> float:
        now = self._clock()
        raw = 0.0
        last = {}
        for name, fn in self._signals.items():
            try:
                v = max(0.0, float(fn()))
            except Exception:  # noqa: BLE001 — one bad signal, not the plane
                v = 0.0
            last[name] = round(v, 4)
            if v > raw:
                raw = v
        with self._lock:
            self._score = (self.alpha * raw
                           + (1.0 - self.alpha) * self._score)
            score, busy = self._score, self._busy
            self._last = last
        if not busy and score >= self.enter:
            if self._edge_since is None:
                self._edge_since = now
            elif now - self._edge_since >= self.hold_s:
                self._set_busy(True, score)
                self._edge_since = None
        elif busy and score <= self.exit:
            if self._edge_since is None:
                self._edge_since = now
            elif now - self._edge_since >= self.hold_s:
                self._set_busy(False, score)
                self._edge_since = None
        else:
            # between the thresholds (or back on the busy side): any
            # pending crossing is cancelled — that's the hysteresis
            self._edge_since = None
        if self._registry is not None:
            self._registry.set_gauge("bcos_overload_score", round(score, 4))
        return score

    def _set_busy(self, busy: bool, score: float) -> None:
        with self._lock:
            if self._busy == busy:
                return
            self._busy = busy
            self._transitions += 1
            now = self._clock()
            if busy:
                self._busy_entered_at = now
            elif self._busy_entered_at is not None:
                self._busy_seconds += now - self._busy_entered_at
                self._busy_entered_at = None
        LOG.warning(badge("OVERLOAD", "busy" if busy else "recovered",
                          score=round(score, 3), node=self.label,
                          signals=self._last))
        if self._registry is not None:
            self._registry.set_gauge("bcos_overload_busy", 1.0 if busy
                                     else 0.0)
            if busy:
                self._registry.inc("bcos_overload_busy_total")
        if self.health is not None:
            if busy:
                self.health.busy(COMPONENT,
                                 f"score {score:.2f} {self._last}")
            else:
                self.health.clear(COMPONENT)

    # -- brownout policy queries (hot paths: one lock-free bool read) ------
    def busy(self) -> bool:
        return self._busy

    def score(self) -> float:
        with self._lock:
            return self._score

    def write_rate_factor(self) -> float:
        """Multiplier on per-client WRITE token rates at the serving edge
        (rpc/admission.py). Reads are never scaled — the brownout must not
        take the query plane down with the write plane."""
        return self.busy_write_factor if self._busy else 1.0

    def accepting_remote_txs(self) -> bool:
        """Gossip import gate (net/txsync.py): a busy node stops pulling
        in remote pending txs it cannot seal — amplification control; the
        anti-entropy sweep re-delivers them after recovery."""
        return not self._busy

    def stats(self) -> dict:
        with self._lock:
            busy_s = self._busy_seconds
            if self._busy_entered_at is not None:
                busy_s += self._clock() - self._busy_entered_at
            return {
                "busy": self._busy,
                "score": round(self._score, 4),
                "signals": dict(self._last),
                "enter": self.enter,
                "exit": self.exit,
                "transitions": self._transitions,
                "busy_seconds_total": round(busy_s, 3),
            }
