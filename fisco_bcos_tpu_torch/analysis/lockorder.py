"""Canonical lock-ordering declarations — ONE place, two enforcers.

The repo's cross-module locks are ranked outermost-first. A thread may
only acquire a lock whose rank is STRICTLY GREATER than every ranked
lock it already holds; taking them the other way round is how ABBA
deadlocks are built one innocent call at a time. The runtime checker
(analysis/lockcheck.py) verifies every observed acquisition edge against
these ranks; the static linter (tools/bcoslint.py, rule `lock-order`)
flags lexically nested `with` blocks that contradict them without
running anything.

Ranks are spaced by 10 so a future lock slots between neighbours without
renumbering the world. Locks NOT listed here still participate in the
runtime cycle detector (any cycle is a finding, ranked or not) — listing
is for locks with a cross-module ordering contract worth naming.

The observed topology the ranks encode (who nests inside whom):

  scheduler.exec   holds across execute: txpool fill, ledger reads
  p2p.adv          holds across route advertisement: gateway + sessions
  scheduler.2pc    holds across the storage 2PC: engine/WAL fsyncs
  txpool.receipt   receipt waiters read pool drop-records + the ledger
  scheduler.state  scheduler bookkeeping; ledger reads under it
  sealer.state     grant/round bookkeeping; txpool.seal runs OUTSIDE it
  ingest.queue     leaf: dispatch happens OUTSIDE the cv
  txpool.state     pool admission; ledger (storage) reads under it
  engine.flush     serialises flush/install; engine.state inside
  engine.compact   one merge at a time; engine.state inside
  engine.state     memtable + manifest; WAL fsync under it BY DESIGN
  storage.memory   the in-memory backend's table lock (leaf)
  wal.state        WalStorage's table+log lock; fsync under it BY DESIGN
  crypto.lane      leaf: the dispatcher calls the device OUTSIDE the cv
  p2p.gateway      session table / router
  p2p.session      leaf: the writer sends OUTSIDE the cv
"""

from __future__ import annotations

# outermost first — rank = index * 10 (see RANK below)
CANONICAL_ORDER: tuple[str, ...] = (
    "scheduler.exec",
    "p2p.adv",
    "scheduler.2pc",
    "txpool.receipt",
    "scheduler.state",
    "sealer.state",
    "ingest.queue",
    "txpool.state",
    "eventsub.task",
    "engine.flush",
    "engine.compact",
    "engine.state",
    "storage.memory",
    "wal.state",
    "crypto.lane",
    "p2p.gateway",
    "p2p.session",
)

RANK: dict[str, int] = {name: i * 10
                        for i, name in enumerate(CANONICAL_ORDER)}

# The static linter's view: per-module mapping of lock ATTRIBUTE names to
# canonical lock names, so `with self._lock:` in storage/engine.py is
# recognised as engine.state without type inference. Keys are path
# suffixes (matched with str.endswith on /-normalised paths).
MODULE_LOCK_ATTRS: dict[str, dict[str, str]] = {
    "scheduler/scheduler.py": {
        "_exec_lock": "scheduler.exec",
        "_commit_2pc": "scheduler.2pc",
        "_lock": "scheduler.state",
    },
    "txpool/txpool.py": {
        "_lock": "txpool.state",
        "_receipt_cv": "txpool.receipt",
    },
    "txpool/ingest.py": {"_cv": "ingest.queue"},
    "sealer/sealer.py": {"_lock": "sealer.state"},
    "storage/engine.py": {
        "_lock": "engine.state",
        "_flush_lock": "engine.flush",
        "_compact_lock": "engine.compact",
    },
    "storage/wal.py": {"_lock": "wal.state"},
    "storage/memory.py": {"_lock": "storage.memory"},
    "rpc/eventsub.py": {"lock": "eventsub.task"},
    "crypto/lane.py": {"_cv": "crypto.lane"},
    "net/p2p.py": {
        "_cv": "p2p.session",
        "_lock": "p2p.gateway",
        "_adv_lock": "p2p.adv",
    },
}

# Hot locks: holding one of these while performing a blocking operation
# whose kind is NOT in the allow-set is a violation (runtime marker
# `lockcheck.note_blocking(kind)`; static rule `blocking-under-lock`).
# The allow-sets encode DELIBERATE design: the engine/WAL locks exist to
# order durable writes, so fsync under them is the contract, not a bug —
# but device crypto, socket sends and subprocess waits never are.
HOT_LOCKS: dict[str, frozenset] = {
    "scheduler.2pc": frozenset({"fsync"}),   # the 2PC IS the durable write
    "engine.state": frozenset({"fsync"}),    # WAL append + manifest edge
    "engine.flush": frozenset({"fsync"}),    # sstable + manifest writes
    "engine.compact": frozenset({"fsync"}),  # merged-segment writes
    "wal.state": frozenset({"fsync"}),       # the log's whole job
    "txpool.state": frozenset(),             # admission must stay compute-only
    "eventsub.task": frozenset(),            # commit-notify must not block
    "crypto.lane": frozenset(),              # device calls OUTSIDE the cv
    "ingest.queue": frozenset(),             # dispatch OUTSIDE the cv
    "p2p.session": frozenset(),              # writer sends OUTSIDE the cv
}

# Blocking-operation kinds the runtime markers report (the static rule
# recognises the same set by call-pattern).
BLOCKING_KINDS: tuple[str, ...] = (
    "fsync",        # os.fsync / fdatasync / durable rename edges
    "socket_send",  # blocking socket sendall (p2p frames, WS pushes)
    "suite_batch",  # device/native batch crypto (verify/recover/hash)
    "subprocess",   # child-process spawn/wait
    "sleep",        # time.sleep stalls
)
