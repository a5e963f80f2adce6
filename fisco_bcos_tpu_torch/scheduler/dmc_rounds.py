"""DMC message rounds: scheduler <-> sharded-executor iterative protocol.

Reference counterpart: FISCO-BCOS bcos-scheduler/src/BlockExecutive.cpp
:861-978 (DMCExecute loops rounds until every executor reports FINISHED),
DmcExecutor.h:38-80 (per-contract message queues: submit/prepare/go),
CoroutineTransactionExecutive.h (an executive PAUSES at a cross-contract
call and round-trips an ExecutionMessage through the scheduler), and
GraphKeyLocks.cpp (cross-executor lock graph with deadlock revert).

This is the protocol that lets executors scale OUT (Max mode: one executor
process per contract partition) while cross-contract calls still work:

  * each `ShardExecutor` owns a partition of contract addresses and runs
    call frames as thread-bridged executives (the boost::context coroutine
    analogue) over a per-(shard, context) state overlay;
  * an EVM CALL leaving the shard pauses the executive and surfaces a
    CALL message; the scheduler routes it to the owning shard, which runs
    it as a new executive (nested/re-entrant cross-shard chains compose);
    the response resumes the paused frame;
  * a context entering a shard takes the shard's key lock until the whole
    context finishes — opposite acquisition orders across shards deadlock,
    which the scheduler detects (no runnable message + blocked contexts)
    and resolves the reference's way: revert the HIGHEST context id
    (abort its executives, discard its overlays, release its locks) and
    re-run it after the survivors (DmcExecutor's revert-and-retry).

Determinism: messages are processed strictly sequentially in deterministic
order (FIFO of generation, which is itself a pure function of the block),
lock grants and deadlock victims are order-functions of context ids, and a
context's writes merge into the block state only when it finishes — so
every replica derives the same receipts and state root. In-process the
sequential loop costs nothing (the state mutation is lock-serialised
anyway); across processes the same message objects ride the service RPC.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from collections import deque
from typing import Callable, Optional, Sequence

from ..executor.executor import TransactionExecutor
from ..executor.evm import EVMResult
from ..protocol import Receipt, Transaction, TransactionStatus
from ..storage.state import StateStorage
from ..utils.log import LOG, badge, metric
from ..utils.trace import DmcStepRecorder

MSG_ROOT, MSG_CALL = 0, 1


MAX_XSHARD_DEPTH = 64  # cap on cross-shard hops (each costs an executive)


@dataclasses.dataclass
class DmcMessage:
    """One scheduler<->executor message (ExecutionMessage analogue)."""

    kind: int
    context_id: int
    seq: int
    to: bytes  # routed contract address
    caller: bytes = b""
    value: int = 0
    data: bytes = b""
    gas: int = 0
    static: bool = False
    depth: int = 0  # EVM call depth carried ACROSS shards
    tx: Optional[Transaction] = None  # MSG_ROOT only


class _Aborted(Exception):
    """Raised inside an executive thread when its context is reverted."""


class _Executive:
    """A call frame on its own thread; pauses at cross-shard calls.

    The thread runs `fn(external)` where `external(msg) -> response` blocks
    until the scheduler routes the call and feeds the answer back — the
    shape of CoroutineTransactionExecutive's yield/resume.
    """

    def __init__(self, fn: Callable):
        self._outbox: "queue.Queue[tuple[str, object]]" = queue.Queue()
        self._inbox: "queue.Queue[tuple[str, object]]" = queue.Queue()
        self._thread = threading.Thread(target=self._main, args=(fn,),
                                        name="dmc-executive", daemon=True)

    def _main(self, fn) -> None:
        try:
            result = fn(self._external)
            self._outbox.put(("done", result))
        except _Aborted:
            self._outbox.put(("aborted", None))
        except Exception as exc:  # defensive; surfaces as a failed receipt
            self._outbox.put(("error", exc))

    def _external(self, request):
        self._outbox.put(("call", request))
        kind, resp = self._inbox.get()
        if kind == "abort":
            raise _Aborted()
        return resp

    def start(self) -> tuple[str, object]:
        self._thread.start()
        return self._outbox.get()

    def resume(self, response) -> tuple[str, object]:
        self._inbox.put(("resp", response))
        return self._outbox.get()

    def abort(self) -> None:
        """Only valid while paused (which a deadlocked executive is)."""
        self._inbox.put(("abort", None))
        self._outbox.get()  # the ("aborted", None) ack
        self._thread.join(timeout=5)


class ShardExecutor:
    """One contract partition: executor + per-context overlays + executives.

    `owns(addr)` defines the partition; in Max deployments this object sits
    behind the executor-service RPC (services/executor_service.py) — the
    scheduler only ever exchanges DmcMessages with it.
    """

    def __init__(self, shard_id: bytes, suite,
                 owns: Callable[[bytes], bool],
                 precompile_home: bool = False):
        self.shard_id = shard_id
        self.suite = suite
        self.owns = owns
        # system precompiles live on ONE deterministic shard (the scheduler
        # marks shards[0]) so their state has a single writer under the
        # shard lock — replicating them would lose updates at merge
        self.precompile_home = precompile_home
        self.executor = TransactionExecutor(suite)
        self._tls = threading.local()
        self.executor.evm.external_call = self._hook
        self._overlays: dict[int, StateStorage] = {}

    def _is_local(self, to: bytes) -> bool:
        if to in self.executor.registry:
            return self.precompile_home
        return self.owns(to)

    # -- cross-shard hook (runs ON an executive thread) --------------------
    def _hook(self, caller, to, value, data, gas, static, depth):
        if self._is_local(to):
            return None
        external = getattr(self._tls, "external", None)
        if external is None:
            return None  # not executing under the round scheduler
        if value:
            return EVMResult(False, gas_left=gas,
                             error="cross-shard value transfer unsupported")
        total_depth = getattr(self._tls, "base_depth", 0) + depth
        if total_depth > MAX_XSHARD_DEPTH:
            return EVMResult(False, gas_left=gas,
                             error="cross-shard call depth exceeded")
        resp: EVMResult = external(DmcMessage(
            kind=MSG_CALL, context_id=self._tls.context_id, seq=0,
            to=to, caller=caller, data=data, gas=gas, static=static,
            depth=total_depth))
        return resp

    # -- overlays ----------------------------------------------------------
    def overlay(self, ctx: int, base: StateStorage) -> StateStorage:
        ov = self._overlays.get(ctx)
        if ov is None:
            ov = self._overlays[ctx] = StateStorage(base)
        return ov

    def merge(self, ctx: int, base: StateStorage) -> None:
        ov = self._overlays.pop(ctx, None)
        if ov is None:
            return
        for (table, key), entry in ov.changeset().items():
            if entry.deleted:
                base.remove(table, key)
            else:
                base.set(table, key, entry.value)

    def discard(self, ctx: int) -> None:
        self._overlays.pop(ctx, None)

    # -- executive bodies --------------------------------------------------
    def start_root(self, msg: DmcMessage, base: StateStorage,
                   block_number: int, timestamp: int) -> _Executive:
        ov = self.overlay(msg.context_id, base)

        def run(external):
            self._tls.external = external
            self._tls.context_id = msg.context_id
            self._tls.base_depth = 0
            try:
                return self.executor.execute_transaction(
                    msg.tx, ov, block_number, timestamp)
            finally:
                self._tls.external = None

        return _Executive(run)

    def start_subcall(self, msg: DmcMessage, base: StateStorage,
                      block_number: int, timestamp: int) -> _Executive:
        ov = self.overlay(msg.context_id, base)

        def run(external):
            self._tls.external = external
            self._tls.context_id = msg.context_id
            self._tls.base_depth = msg.depth
            try:
                env = self.executor._env(msg.caller, block_number,
                                         timestamp, msg.gas)
                # each cross-shard segment is its own EIP-2929 context:
                # message boundaries are deterministic across nodes,
                # thread-local warmth from earlier segments is not
                self.executor.evm.begin_tx_access(msg.caller, msg.to,
                                                  env.coinbase)
                return self.executor.evm.execute_message(
                    ov, env, msg.caller, msg.to, msg.value, msg.data,
                    msg.gas, depth=1, static=msg.static)
            finally:
                self._tls.external = None

        return _Executive(run)


class DmcRoundScheduler:
    """Routes DmcMessages between shard executors until every context
    finishes; detects and reverts deadlocked contexts."""

    def __init__(self, shards: Sequence[ShardExecutor]):
        self.shards = list(shards)
        if self.shards and not any(sh.precompile_home for sh in self.shards):
            self.shards[0].precompile_home = True

    def _shard_for(self, addr: bytes) -> Optional[ShardExecutor]:
        for sh in self.shards:
            if sh._is_local(addr):
                return sh
        return None  # unowned: the scheduler fails the message (a fallback
        # shard would re-externalize the same call forever)

    def execute_block(self, txs: Sequence[Transaction], base: StateStorage,
                      block_number: int, timestamp: int,
                      recorder: Optional[DmcStepRecorder] = None
                      ) -> list[Receipt]:
        receipts: list[Optional[Receipt]] = [None] * len(txs)
        # shard lock table: shard_id -> holding context (the GraphKeyLocks
        # grain here is the contract partition, the DMC sharding unit)
        lock_of: dict[bytes, int] = {}
        held: dict[int, set[bytes]] = {i: set() for i in range(len(txs))}
        # paused executives awaiting a response: (ctx, shard_id) -> stack
        frames: dict[int, list[tuple[ShardExecutor, _Executive]]] = {
            i: [] for i in range(len(txs))}
        reverts = 0

        ready: deque[DmcMessage] = deque(
            DmcMessage(kind=MSG_ROOT, context_id=i, seq=0, to=tx.to, tx=tx)
            for i, tx in enumerate(txs))
        blocked: list[DmcMessage] = []
        rounds = 0

        def step(sh: ShardExecutor, ctx: int, outcome: tuple[str, object],
                 ex: _Executive) -> None:
            """Advance one executive until it pauses or its frame ends."""
            kind, payload = outcome
            if kind == "call":
                # paused: route the request; response resumes this frame
                frames[ctx].append((sh, ex))
                sub: DmcMessage = payload  # type: ignore[assignment]
                sub.seq = len(frames[ctx])
                ready.append(sub)
                return
            # frame finished: pop to the caller frame, or finish the context
            if frames[ctx]:
                parent_sh, parent_ex = frames[ctx].pop()
                if kind == "error":
                    result = EVMResult(False, gas_left=0,
                                       error=f"executive: {payload}")
                else:
                    result = payload
                step(parent_sh, ctx, parent_ex.resume(result), parent_ex)
                return
            # root frame done -> context complete
            if kind == "error":
                rc = Receipt(block_number=block_number)
                rc.status = int(TransactionStatus.EXECUTION_ABORTED)
                rc.message = f"executive: {payload}"
                receipts[ctx] = rc
            else:
                receipts[ctx] = payload  # type: ignore[assignment]
            # TRANSACTION atomicity across shards: merge overlays only when
            # the root tx succeeded; a reverted/aborted tx discards every
            # shard's writes, including remote callees'. (Frame-granular
            # rollback of a cross-shard sub-call whose ENCLOSING frame later
            # reverts inside a successful tx would need the reference's
            # per-seq revert messages — not modeled; contracts share state
            # across shards at tx granularity.)
            if receipts[ctx] is not None and receipts[ctx].status == 0:
                for shard in self.shards:
                    shard.merge(ctx, base)
            else:
                for shard in self.shards:
                    shard.discard(ctx)
            for sid in held[ctx]:
                if lock_of.get(sid) == ctx:
                    del lock_of[sid]
            held[ctx].clear()

        def revert(ctx: int) -> None:
            """Abort a context's executives and requeue its root tx."""
            nonlocal reverts
            reverts += 1
            for _sh, ex in reversed(frames[ctx]):
                ex.abort()
            frames[ctx].clear()
            for shard in self.shards:
                shard.discard(ctx)
            for sid in held[ctx]:
                if lock_of.get(sid) == ctx:
                    del lock_of[sid]
            held[ctx].clear()
            ready.append(DmcMessage(kind=MSG_ROOT, context_id=ctx, seq=0,
                                    to=txs[ctx].to, tx=txs[ctx]))

        while ready:
            rounds += 1
            progressed = False
            work = deque(ready)
            ready.clear()
            still_blocked: list[DmcMessage] = []
            while work:
                msg = work.popleft()
                sh = self._shard_for(msg.to)
                ctx = msg.context_id
                if sh is None:  # no shard owns the destination address
                    progressed = True
                    if msg.kind == MSG_ROOT:
                        rc = Receipt(block_number=block_number)
                        rc.status = int(TransactionStatus.CALL_ADDRESS_ERROR)
                        rc.message = "no shard owns destination"
                        receipts[ctx] = rc
                    elif frames[ctx]:
                        p_sh, p_ex = frames[ctx].pop()
                        fail = EVMResult(False, gas_left=0,
                                         error="no shard owns destination")
                        step(p_sh, ctx, p_ex.resume(fail), p_ex)
                        while ready:
                            work.append(ready.popleft())
                    continue
                holder = lock_of.get(sh.shard_id)
                if holder is not None and holder != ctx:
                    still_blocked.append(msg)
                    continue
                lock_of[sh.shard_id] = ctx
                held[ctx].add(sh.shard_id)
                progressed = True
                if recorder is not None:  # determinism checksum per message
                    recorder.record_message(ctx, msg.seq, msg.to, msg.data)
                if msg.kind == MSG_ROOT:
                    ex = sh.start_root(msg, base, block_number, timestamp)
                else:
                    ex = sh.start_subcall(msg, base, block_number, timestamp)
                step(sh, ctx, ex.start(), ex)
                # messages generated during the step join this round's work
                while ready:
                    work.append(ready.popleft())
            if recorder is not None:
                recorder.next_round()
            # lock-blocked messages retry next round in deterministic order
            ready.extend(sorted(still_blocked,
                                key=lambda m: (m.context_id, m.seq)))
            if not progressed and ready:
                # every waiting message is lock-blocked: deadlock. Revert
                # the HIGHEST context id among the blocked (the reference's
                # victim rule); its locks free the survivors.
                victim = max(m.context_id for m in ready)
                ready = deque(m for m in ready if m.context_id != victim)
                LOG.warning(badge("DMC", "deadlock-revert", ctx=victim))
                revert(victim)

        metric("dmc.rounds", n=len(txs), rounds=rounds, reverts=reverts)
        for i, rc in enumerate(receipts):
            if rc is None:
                rc = Receipt(block_number=block_number)
                rc.status = int(TransactionStatus.EXECUTION_ABORTED)
                rc.message = "context never completed"
                receipts[i] = rc
        return [r for r in receipts]
