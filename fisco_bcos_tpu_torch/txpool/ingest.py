"""IngestLane — continuous-batching front door for the txpool.

The framework's thesis is batch-first validation (`TxPool.submit_batch`
-> ONE device recover per packet), yet the serving edge defeats it when
every JSON-RPC `sendTransaction` calls `submit(tx)` — a batch of one —
so each independent client pays a full recover (~162 us native; device
amortization needs hundreds of lanes to win, see PERF.md). Hardware
validators get their wins exactly by aggregating independent submissions
in front of the verify engine (Blockchain Machine, arXiv:2104.06968;
FPGA ECDSA engine, arXiv:2112.02229); inference servers call the same
shape continuous batching. This lane is that aggregation layer:

  * concurrent submitters enqueue (tx, future) into a BOUNDED queue —
    a full queue rejects with `TxPoolIsFull` instead of growing without
    bound (admission control, not buffering);
  * one dispatcher thread drains up to `max_batch` txs per cycle and
    issues ONE `TxPool.submit_batch` for the drained set, resolving each
    submitter's future with its per-tx result;
  * the coalescing window is ADAPTIVE: near-zero when idle (a lone tx is
    dispatched immediately, no latency tax), growing toward
    `max_wait_ms` as the arrival rate rises, and sized against the
    crypto suite's padding buckets (crypto.suite.BUCKETS) so drained
    batches land on compiled-executable boundaries instead of paying a
    bucket's padding for a handful of txs.

Producers wired through the lane: `rpc/server.py` send_transaction (HTTP
and WS share `JsonRpcImpl`), `net/txsync.py` gossip ingestion, and the
in-process `Node.send_transaction` surface. `TransactionSync.fetch_missing`
stays on the direct `submit_batch` path: it already holds a full batch and
needs its results synchronously inside proposal verification.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional, Sequence

from ..analysis import lockcheck as lc
from ..protocol import Transaction
from ..utils import otrace
from ..utils.log import LOG, badge, metric
from ..utils.metrics import REGISTRY
from ..utils.task import Task
from ..utils.trace import observe_stage
from .txpool import TxSubmitResult

from ..crypto.suite import BUCKETS as _SUITE_BUCKETS

# batch-size histogram / coalescing-target buckets: derived from the
# suite's padding buckets so the lane tracks any retuning of the
# compiled-executable grid (1 prepended: a lone idle tx is its own batch)
_SIZE_BUCKETS = (1,) + tuple(_SUITE_BUCKETS)


class TxPoolIsFull(RuntimeError):
    """Ingest queue at capacity — backpressure, not an internal error.

    Carries no result object: the tx never entered admission. RPC maps it
    to TransactionStatus.TXPOOL_FULL for wire compatibility."""


class LaneStopped(RuntimeError):
    """Submission raced the lane's shutdown. Distinct from arbitrary
    dispatch errors so callers can fall back to the direct pool path
    WITHOUT mistaking an already-admitted batch's failure for it."""


class _Entry:
    __slots__ = ("tx", "task", "t_enq", "ctx", "wire")

    def __init__(self, tx: Optional[Transaction], task: Optional[Task],
                 ctx=None, wire: Optional[bytes] = None):
        self.tx = tx  # None: columnar entry — raw frame in `wire`, never
        #               decoded into a Transaction (protocol.columnar)
        self.task = task  # None: fire-and-forget (gossip), nobody awaits
        self.t_enq = time.monotonic()
        # otrace span context of the submitting trace (None when the
        # submission isn't traced): the dispatcher records this entry's
        # queue-to-admission span under it, and one batch span LINKS all
        # coalesced traces
        self.ctx = ctx
        self.wire = wire


class IngestLane:
    """Coalesces concurrent single-tx submissions into device-sized
    `submit_batch` calls. Thread-safe; one dispatcher thread."""

    def __init__(self, txpool, max_batch: int = 4096,
                 max_wait_ms: float = 15.0, queue_cap: int = 8192,
                 broadcast: bool = True, registry=None,
                 trace_label: str = ""):
        self.txpool = txpool
        self.trace_label = trace_label  # span node attribution
        # metrics sink: a multi-group node passes a group-labeled view
        # (utils.metrics.for_group) so G lanes don't silently aggregate
        self._reg = registry if registry is not None else REGISTRY
        self.max_batch = max(1, int(max_batch))
        self.max_wait = max(0.0, float(max_wait_ms)) / 1000.0
        self.queue_cap = max(1, int(queue_cap))
        self.broadcast = broadcast
        self._q: deque[_Entry] = deque()
        self._cv = lc.make_condition("ingest.queue")
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        # EWMA arrival rate (txs/sec) and mean dispatched batch size,
        # updated once per dispatch cycle — steer the coalescing window
        # without per-enqueue bookkeeping. The batch EWMA is the
        # closed-loop load signal: concurrent submitters each have at
        # most one tx in flight, so a depressed arrival RATE can coexist
        # with heavy concurrency (every submitter blocked on a dispatch),
        # and batches > 1 are the reliable tell.
        self._rate = 0.0
        self._batch_ewma = 1.0
        # EWMA of the intra-batch arrival gap (spread between a batch's
        # first and last enqueue over its size): the quiesce threshold is
        # "a few typical gaps of silence", so tightly-clustered closed-loop
        # cohorts dispatch within ~ms of assembling while slow open-loop
        # trickles still coalesce over the patient window
        self._gap_ewma = 0.0
        self._last_dispatch = time.monotonic()
        # totals for stats()/bench (the registry mirrors them as metrics)
        self._txs_total = 0
        self._batches_total = 0
        self._rejected_total = 0
        self._dropped_total = 0

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop = False
        self._thread = threading.Thread(target=self._run, name="tx-ingest",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop the dispatcher, draining the queue first so no submitter is
        left holding an unsettled future."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10)
            if self._thread.is_alive():
                # wedged dispatcher (e.g. stuck inside submit_batch):
                # keep the reference so a later start() can't spawn a
                # SECOND dispatcher over the same queue — the lane stays
                # stopped and callers use their direct-path fallbacks
                LOG.error(badge("INGEST", "dispatcher-wedged-at-stop"))
                return
            self._thread = None
        # anything still queued (dispatcher died / join timed out): reject
        with self._cv:
            leftovers = list(self._q)
            self._q.clear()
        for e in leftovers:
            if e.task is not None:
                e.task.reject(LaneStopped("ingest lane stopped"))

    # -- producer API ------------------------------------------------------
    def submit_async(self, tx: Transaction) -> Task:
        """Enqueue one tx; -> Task[TxSubmitResult]. Raises TxPoolIsFull
        when the queue is at capacity (bounded-memory backpressure)."""
        ctx = getattr(tx, "_otrace", None) or otrace.current()
        entry = _Entry(tx, Task(), ctx=ctx)
        with self._cv:
            if self._stop:
                raise LaneStopped("ingest lane stopped")
            if len(self._q) >= self.queue_cap:
                self._rejected_total += 1
                self._reg.inc("bcos_ingest_rejected_total")
                raise TxPoolIsFull(
                    f"ingest queue at capacity ({self.queue_cap})")
            self._q.append(entry)
            depth = len(self._q)
            self._cv.notify_all()
        self._reg.set_gauge("bcos_ingest_queue_depth", depth)
        return entry.task

    def submit(self, tx: Transaction, timeout: float = 30.0
               ) -> TxSubmitResult:
        """Blocking single-tx submission through the batching lane."""
        return self.submit_async(tx).result(timeout)

    def submit_wire_async(self, raw: bytes) -> Task:
        """Enqueue one RAW wire frame; -> Task[TxSubmitResult].

        The columnar front door (ROADMAP item 1): the frame is never
        decoded into a `Transaction` — the dispatcher folds all queued
        wire entries into one `protocol.columnar.decode_columns` +
        `TxPool.submit_columns` call, so per-tx Python marshalling
        disappears from the hot path. Raises TxPoolIsFull at capacity."""
        entry = _Entry(None, Task(), ctx=otrace.current(), wire=raw)
        with self._cv:
            if self._stop:
                raise LaneStopped("ingest lane stopped")
            if len(self._q) >= self.queue_cap:
                self._rejected_total += 1
                self._reg.inc("bcos_ingest_rejected_total")
                raise TxPoolIsFull(
                    f"ingest queue at capacity ({self.queue_cap})")
            self._q.append(entry)
            depth = len(self._q)
            self._cv.notify_all()
        self._reg.set_gauge("bcos_ingest_queue_depth", depth)
        return entry.task

    def submit_wire(self, raw: bytes, timeout: float = 30.0
                    ) -> TxSubmitResult:
        """Blocking single-frame submission through the columnar lane."""
        return self.submit_wire_async(raw).result(timeout)

    def submit_many_wire_nowait(self, wires: Sequence[bytes]) -> int:
        """Fire-and-forget bulk enqueue of RAW wire frames (the gossip
        decode path): same drop-don't-block contract as
        submit_many_nowait, but frames ride to admission undecoded."""
        if not wires:
            return 0
        accepted = 0
        with self._cv:
            if self._stop:
                return 0
            room = self.queue_cap - len(self._q)
            for w in wires[:max(0, room)]:
                self._q.append(_Entry(None, None, wire=w))
                accepted += 1
            depth = len(self._q)
            dropped = len(wires) - accepted
            self._dropped_total += dropped
            if accepted:
                self._cv.notify_all()
        if dropped:
            self._reg.inc("bcos_ingest_dropped_total", dropped)
            metric("ingest.drop", n=dropped)
        self._reg.set_gauge("bcos_ingest_queue_depth", depth)
        return accepted

    def submit_many_nowait(self, txs: Sequence[Transaction]) -> int:
        """Fire-and-forget bulk enqueue (gossip ingestion): accepts what
        fits under the cap and DROPS the rest (-> count accepted). Gossip
        may drop under overload — the pool anti-entropy sweep re-delivers;
        blocking the p2p reader thread on a full queue would back the
        network plane up behind the verify engine instead."""
        if not txs:
            return 0
        accepted = 0
        with self._cv:
            if self._stop:
                return 0
            room = self.queue_cap - len(self._q)
            for tx in txs[:max(0, room)]:
                self._q.append(_Entry(tx, None,
                                      ctx=getattr(tx, "_otrace", None)))
                accepted += 1
            depth = len(self._q)
            dropped = len(txs) - accepted
            self._dropped_total += dropped
            if accepted:
                self._cv.notify_all()
        if dropped:
            self._reg.inc("bcos_ingest_dropped_total", dropped)
            metric("ingest.drop", n=dropped)
        self._reg.set_gauge("bcos_ingest_queue_depth", depth)
        return accepted

    # -- adaptive coalescing -----------------------------------------------
    def _plan(self, queued: int) -> tuple[int, float]:
        """-> (target_batch, window_seconds) for this cycle.

        Idle (low arrival rate AND recent batches of ~1): dispatch
        immediately — a lone RPC tx must not pay a coalescing tax. Under
        load (either signal): target the smallest padding bucket covering
        what's queued plus the load estimate (capped at max_batch) so the
        drained batch fills the executable it will be padded to, and open
        a window toward max_wait. The dispatcher additionally early-exits
        the window when arrivals quiesce (see _run), so the window is an
        upper bound, not a tax."""
        if queued >= self.max_batch:
            return self.max_batch, 0.0
        # busyness is judged over a FIXED horizon, not max_wait: with a
        # small window the gate `rate * max_wait >= 2` could never open
        # (closed-loop submitters post ~1 tx per round trip, so the rate
        # only rises AFTER coalescing starts — a catch-22)
        expected = self._rate * max(self.max_wait, 0.1)
        if expected < 2.0 and self._batch_ewma < 1.5:
            return max(1, queued), 0.0
        want = min(self.max_batch,
                   max(queued, int(self._rate * self.max_wait),
                       int(self._batch_ewma * 2)))
        target = self.max_batch
        for b in _SIZE_BUCKETS:
            if want <= b:
                target = min(b, self.max_batch)
                break
        if queued >= target:
            return target, 0.0
        return target, self.max_wait

    # -- dispatcher --------------------------------------------------------
    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._stop:
                    self._cv.wait()
                if not self._q and self._stop:
                    return
                target, window = self._plan(len(self._q))
                if window > 0.0:
                    # park up to `window` for the target, but early-exit
                    # once arrivals quiesce: concurrent submitters re-post
                    # within a few ms of each other after their previous
                    # dispatch resolves, so a short silence means the
                    # in-flight cohort has fully landed. The quiesce
                    # threshold is ADAPTIVE: while the queue is still below
                    # the steady cohort size (the batch EWMA), wait the
                    # patient window/4 — trickling open-loop arrivals keep
                    # coalescing; once a full cohort is in, a ~2 ms silence
                    # suffices. Closed-loop clients' end-to-end rate is
                    # 1/admission-latency, so the old fixed window/4 idle
                    # AFTER the cohort arrived was a direct TPS ceiling.
                    deadline = time.monotonic() + window
                    cohort = max(2.0, self._batch_ewma)
                    gappy = window / 4.0
                    if self._gap_ewma > 0.0:
                        gappy = min(gappy, max(0.005, 8.0 * self._gap_ewma))
                    while (len(self._q) < target and not self._stop):
                        left = deadline - time.monotonic()
                        if left <= 0.0:
                            break
                        before = len(self._q)
                        quiet = 0.002 if before >= cohort else gappy
                        self._cv.wait(min(left, quiet))
                        if len(self._q) == before:
                            break  # quiesced: the cohort is in
                batch = [self._q.popleft()
                         for _ in range(min(len(self._q), self.max_batch))]
                depth = len(self._q)
            self._reg.set_gauge("bcos_ingest_queue_depth", depth)
            try:
                self._dispatch(batch)
            except Exception as exc:  # noqa: BLE001 — lane must survive
                LOG.exception(badge("INGEST", "dispatch-failed",
                                    n=len(batch)))
                for e in batch:
                    if e.task is not None:
                        e.task.reject(exc)

    def _dispatch(self, batch: list[_Entry]) -> None:
        now = time.monotonic()
        # columnar entries (raw wire frames) and object entries dispatch
        # through their own pool doors; a mixed drain pays two recover
        # calls, but producers are homogeneous per deployment (wire RPC +
        # wire gossip, or legacy object submitters), so the mix is a
        # transition artifact, not the steady state
        wire_entries = [e for e in batch if e.tx is None]
        obj_entries = [e for e in batch if e.tx is not None]
        # deadline shed BEFORE any admission/crypto work: entries whose
        # block_limit already passed while they sat in the queue can never
        # commit — settle them with the typed expiry status instead of
        # spending lane verify + pool slots on work that would be dropped
        # anyway (they would be rejected by the pool's precheck, but under
        # overload even carrying them through the batch costs real time).
        # Wire entries skip this: reading block_limit would mean decoding,
        # and submit_columns' precheck rejects expired rows BEFORE the
        # recover anyway (they pay one batched hash slot, nothing more).
        ledger = getattr(self.txpool, "ledger", None)  # test doubles may
        current = ledger.current_number() if ledger is not None else None
        shed = [e for e in obj_entries
                if current is not None and e.tx.block_limit <= current]
        if shed:
            from ..protocol import TransactionStatus, batch_hash
            hs = batch_hash([e.tx for e in shed], self.txpool.suite)
            for e, h in zip(shed, hs):
                if e.task is not None:
                    e.task.resolve(TxSubmitResult(
                        h, TransactionStatus.BLOCK_LIMIT_CHECK_FAIL))
            self._reg.inc("bcos_ingest_deadline_shed_total", len(shed))
            obj_entries = [e for e in obj_entries
                           if e.tx.block_limit > current]
            batch = obj_entries + wire_entries
            if not batch:
                return
        # one pool call per path == one device recover for the drained set
        from ..analysis.profiler import stage as _prof_stage
        t0 = time.perf_counter()
        with _prof_stage("ingest.admit"):
            if obj_entries:
                results = self.txpool.submit_batch(
                    [e.tx for e in obj_entries], broadcast=self.broadcast)
                for e, res in zip(obj_entries, results):
                    if e.task is not None:
                        e.task.resolve(res)
            if wire_entries:
                from ..protocol.columnar import decode_columns
                cols = decode_columns([e.wire for e in wire_entries])
                results = self.txpool.submit_columns(
                    cols, broadcast=self.broadcast)
                for e, res in zip(wire_entries, results):
                    if e.task is not None:
                        e.task.resolve(res)
        dt = time.perf_counter() - t0
        # latency attribution: per-batch coalesce time into the stage
        # histogram; traced submissions additionally get their own
        # enqueue-to-admitted span (one per traced entry, linked to the
        # shared batch by the batch-size attribute)
        # unlabeled registry on purpose: every bcos_tx_stage_seconds
        # stage must live in ONE series family or cross-stage shares
        # (the dashboard's headline panel) skew — the block stages are
        # unlabeled, so these are too
        observe_stage("ingest", now - batch[0].t_enq)
        t_done = time.monotonic()
        for e in batch:
            if e.ctx is not None and e.ctx.sampled:
                otrace.TRACER.record(
                    "ingest.admit", e.ctx, e.t_enq, t_done,
                    attrs={"batch": len(batch),
                           "node": self.trace_label})
        # rate EWMA: arrivals per second over the inter-dispatch gap
        gap = max(1e-6, now - self._last_dispatch)
        self._last_dispatch = now
        inst = len(batch) / gap
        self._rate = inst if self._rate == 0.0 else \
            0.3 * inst + 0.7 * self._rate
        self._batch_ewma = 0.3 * len(batch) + 0.7 * self._batch_ewma
        if len(batch) > 1:
            spread = (batch[-1].t_enq - batch[0].t_enq) / (len(batch) - 1)
            self._gap_ewma = spread if self._gap_ewma == 0.0 else \
                0.3 * spread + 0.7 * self._gap_ewma
        with self._cv:
            self._txs_total += len(batch)
            self._batches_total += 1
        self._reg.inc("bcos_ingest_txs_total", len(batch))
        self._reg.inc("bcos_ingest_batches_total")
        self._reg.observe("bcos_ingest_batch_size", len(batch),
                         buckets=_SIZE_BUCKETS)
        self._reg.observe("bcos_ingest_coalesce_delay_seconds",
                         now - batch[0].t_enq)
        self._reg.observe("bcos_ingest_per_tx_seconds", dt / len(batch))
        metric("ingest.batch", n=len(batch), ms=int(dt * 1000),
               rate=int(self._rate))

    # -- introspection -----------------------------------------------------
    def queue_fraction(self) -> float:
        """Queue occupancy 0..1 — the overload controller's ingest signal
        (utils/overload.py). Lock-free read of a len()."""
        return len(self._q) / max(1, self.queue_cap)

    def stats(self) -> dict:
        with self._cv:
            txs, batches = self._txs_total, self._batches_total
            return {
                "txs_total": txs,
                "batches_total": batches,
                "mean_batch": round(txs / batches, 2) if batches else 0.0,
                "queue_depth": len(self._q),
                "rejected_total": self._rejected_total,
                "dropped_total": self._dropped_total,
                "rate_tx_per_sec": round(self._rate, 1),
            }
