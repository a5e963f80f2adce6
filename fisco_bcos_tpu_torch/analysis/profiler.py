"""profiler — thread-role classification and per-thread stage markers.

The part of the JAX package's continuous profiler that the node planes
call on their hot paths: `stage(...)` scopes label the calling thread's
work with a pipeline stage (the ingest lane holds one around each
admission batch), `classify` maps a thread name to its subsystem role, and
`current_stage` reads a thread's label. The sampling profiler that reads
them (its sampler thread, folded stacks, CPU accounting, bursts and
flamegraph) is not ported yet (ROADMAP.md); without it a marker costs two
dict writes per scope.
"""

from __future__ import annotations

import threading
from typing import Optional

# -- thread-role classification -------------------------------------------
# prefix -> role; first match wins. Matches the repo's thread-naming
# convention (every subsystem names its threads at spawn).
_ROLE_PREFIXES = (
    ("tx-ingest", "ingest"),
    ("sched-commit", "commit"),
    ("sched-notify", "commit"),
    ("pbft", "pbft"),          # worker + pbft-exec pool
    ("sealer", "seal"),
    ("crypto-lane", "lane"),   # dispatcher + crypto-lane-w fan-out pool
    ("storage-compact", "compaction"),
    ("block-sync", "sync"),
    ("dag", "execute"),        # DAG executor pool (executor/executor.py)
    ("dmc", "execute"),
    ("rpc-worker", "edge"),
    ("ops-worker", "edge"),
    ("ops-http", "edge"),
    ("jsonrpc-http", "edge"),
    ("ws-", "edge"),
    ("gw-", "net"),
    ("p2p-", "net"),
    ("remote-front", "net"),
    ("health-probe", "control"),
    ("overload-ctl", "control"),
    ("profile-", "profiler"),
    ("MainThread", "main"),
)


def classify(thread_name: str) -> str:
    """Thread name -> subsystem role (the flamegraph's root split)."""
    for prefix, role in _ROLE_PREFIXES:
        if thread_name.startswith(prefix):
            return role
    return "other"


# -- per-thread stage markers ---------------------------------------------
# {thread ident: stage name} — written by the stage() scopes the scheduler/
# ingest/sealer hot loops hold around block-level work. A plain dict is
# enough: CPython dict item writes are atomic under the GIL, and a sampler
# reading a torn moment at worst mislabels ONE sample's stage.
_THREAD_STAGE: dict[int, str] = {}


class stage:
    """`with profiler.stage("execute"): ...` — labels the calling thread's
    samples with a pipeline stage. Disarmed cost: two dict ops per scope
    (block-level, never per-tx)."""

    __slots__ = ("name", "prev", "ident")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        ident = threading.get_ident()
        self.ident = ident
        self.prev = _THREAD_STAGE.get(ident)
        _THREAD_STAGE[ident] = self.name
        return self

    def __exit__(self, *exc):
        if self.prev is None:
            _THREAD_STAGE.pop(self.ident, None)
        else:
            _THREAD_STAGE[self.ident] = self.prev
        return False


def current_stage(ident: int) -> Optional[str]:
    return _THREAD_STAGE.get(ident)
