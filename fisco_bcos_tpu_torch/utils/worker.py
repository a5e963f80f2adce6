"""Worker — a stoppable loop thread with a wake-up queue.

Counterpart of the reference's Worker base (FISCO-BCOS bcos-utilities/
bcos-utilities/Worker.h) that drives the sealer/consensus/sync loops
(Sealer.cpp:94, PBFTEngine.cpp:40, BlockSync.cpp:183): a single thread spins
`execute_worker()` whenever signalled, guaranteeing single-writer semantics
for the module it drives.

Wait discipline: `idle_wait` is the POLLING fallback — the loop re-runs at
least that often even with no wakeup. A worker whose wake sources are
complete (every state change it reacts to calls `wakeup()`) passes
`idle_wait=None` and sleeps until signalled; `execute_worker()` may then
return a float to request the NEXT wait (e.g. "my fill window expires in
37 ms") or None to sleep until the next wakeup. Returning a value from a
worker constructed with a numeric `idle_wait` also works — the return
value overrides the default for that one iteration. The 15% of attributed
GIL budget the sealer burned in `threading.py:wait` (a profile of the
node under load) was
exactly the cost of the polling fallback on the hottest loop.
"""

from __future__ import annotations

import threading
from typing import Optional


class Worker:
    def __init__(self, name: str, idle_wait: Optional[float] = 0.02):
        self.name = name
        self.idle_wait = idle_wait
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # override or assign
    def execute_worker(self) -> Optional[float]:  # pragma: no cover
        """One loop iteration. Return the next wait in seconds, or None
        for the constructor's `idle_wait` (None = until wakeup)."""
        return None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name=self.name,
                                        daemon=True)
        self._thread.start()

    def _run(self) -> None:
        wait = self.idle_wait
        while not self._stop.is_set():
            self._wake.wait(wait)
            self._wake.clear()
            if self._stop.is_set():
                break
            try:
                wait = self.execute_worker()
            except Exception:  # worker loops must not die silently
                wait = None
                from .log import LOG
                LOG.exception("worker %s iteration failed", self.name)
            if wait is None:
                wait = self.idle_wait

    def wakeup(self) -> None:
        self._wake.set()

    def stopping(self) -> bool:
        """True once stop() was requested — long-blocking execute_worker
        bodies poll this so stop() doesn't abandon them mid-operation."""
        return self._stop.is_set()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
