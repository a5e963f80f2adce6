"""Background compaction worker for the disk engine (storage/engine.py).

Policy lives here, mechanism in the engine: the worker polls
`needs_compaction()` — true while any level carries **compaction debt**
(an L0 past its segment-count trigger, or an L(n>=1) run past its byte
target) — and runs one bounded leveled merge per wake. Each merge touches
one source slice plus the next level's overlapping segments only, so the
worker's unit of work is O(level slice) no matter how large the store
grows; read amplification is bounded at ~max_segments L0 probes plus one
probe per deeper level. A merge is crash-safe at any point: every output
segment is fsynced before the single manifest edge publishes the swap,
and recovery sweeps any orphan left by a kill -9 in between
(tests/test_storage_engine.py injects exactly those, including the
mid-output edge of a multi-output merge).

Flushes arriving DURING a merge are untouched: the merge replaces only
the segments it captured, and newer L0 segments keep precedence over the
merged output in the read path.

`pause()`/`resume()` let an operator (or a game-day schedule) starve the
compactor deliberately — the engine keeps accepting writes, debt grows,
and the overload controller's debt signal must push the node to *busy*;
that is the backpressure contract the debt tests pin.
"""

from __future__ import annotations

import threading

from ..utils.log import LOG, badge


class Compactor:
    """Poll-and-merge worker; `run_once()` is the synchronous test seam."""

    def __init__(self, engine, interval: float = 0.25):
        self.engine = engine
        self.interval = interval
        self._stop = threading.Event()
        self._paused = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="storage-compact")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            if self._paused.is_set():
                continue
            try:
                # drain the whole backlog this wake: under sustained write
                # load one merge per 250ms tick cannot keep up with flush
                # arrival, and debt would ratchet upward forever
                while self.run_once():
                    if self._stop.is_set() or self._paused.is_set():
                        break
            except Exception:
                # a failed merge leaves the old segments live (the manifest
                # never moved); the next tick retries with fresh state
                LOG.exception(badge("ENGINE", "compaction-failed"))

    def run_once(self) -> bool:
        if not self.engine.needs_compaction():
            return False
        # strict pick: work off over-budget debt only — the drain-style
        # merges (force=True) are for operator catch-up, not steady state
        return self.engine.compact_once(force=False)

    def pause(self) -> None:
        """Stop merging but keep the thread; debt accumulates."""
        self._paused.set()

    def resume(self) -> None:
        self._paused.clear()

    @property
    def paused(self) -> bool:
        return self._paused.is_set()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=30)
