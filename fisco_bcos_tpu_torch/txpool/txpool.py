"""TxPool — pending-transaction store with device batch validation.

Reference counterpart: FISCO-BCOS bcos-txpool/bcos-txpool/ —
MemoryStorage (txpool/storage/MemoryStorage.cpp:66 submitTransaction, :223
verifyAndSubmitTransaction, :570 batchFetchTxs, :919 batchVerifyProposal) and
TxValidator (txpool/validator/TxValidator.cpp:27-68: nonce/chainId/groupId/
blockLimit checks then the per-tx signature recover at :56).

Design difference (the point of this framework): validation is *batch-first*.
`submit_batch` runs the cheap host checks per tx, then pushes every
still-unverified signature through ONE device recover call
(protocol.batch_recover_senders) instead of the reference's
tbb::parallel_for over scalar verifies (TransactionSync.cpp:516-537).
The single-tx `submit` is the degenerate case. Duplicate-nonce tracking
follows the reference's TxPoolNonceChecker: nonces of the last `block_limit`
committed blocks are a rolling filter.

Overload control (the serving-stack watermark discipline): admission is no
longer a hard `TXPOOL_FULL` cliff at `pool_limit`. Below the LOW watermark
everything admits; between the watermarks, band-0 txs must carry enough
remaining `block_limit` lifetime to realistically seal before expiry
(DEADLINE_UNMEETABLE otherwise — admitting them would only burn verify +
pool slots they can never repay); at the HIGH watermark an incoming tx
admits only by EVICTING a strictly lower-priority pending tx
(TXPOOL_EVICTED), so the pool can never wedge full of stale low-value
traffic. Priority = (band, block_limit): the `attribute` word's top byte
is the client-declared priority band (the gas-price-band analogue — this
chain has no fee market), ties broken toward keeping the later-expiring
and younger tx. Capacity/priority verdicts are computed BEFORE the batch
recover, so a congested pool rejects without paying the crypto lane; and
every admitted-then-dropped tx settles its waiters promptly with the
typed status (`TxDropped`) instead of letting clients hang to timeout.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Callable, Optional, Sequence

import numpy as np

from ..analysis import lockcheck as lc
from ..ledger.ledger import Ledger
from ..protocol import Block, Transaction, TransactionStatus, batch_hash, \
    batch_recover_senders
from ..utils.log import LOG, badge, metric

DEFAULT_POOL_LIMIT = 15000  # txpool.limit default (NodeConfig.cpp:473-493)


@dataclasses.dataclass
class TxSubmitResult:
    tx_hash: bytes
    status: TransactionStatus
    sender: Optional[bytes] = None


class SubmitRejected(RuntimeError):
    """Async submission failed admission; carries the TxSubmitResult."""

    def __init__(self, result: TxSubmitResult):
        super().__init__(f"tx rejected: {result.status!r}")
        self.result = result


class TxDropped(RuntimeError):
    """An ADMITTED tx left THIS node's pool without committing — evicted
    at the high watermark, shed past its deadline, or expired unsealed.
    Carries the typed status so waiters (wait_for_receipt / submit_async)
    settle with a wire-mappable reason instead of a timeout.

    The verdict is node-local: the tx was gossiped, so a peer may still
    seal and commit it. Clients should poll by hash before acting on the
    drop, and resubmit with a FRESH nonce (the original's stays in the
    replay filter for the window, exactly as after a timeout)."""

    def __init__(self, tx_hash: bytes, status: TransactionStatus):
        super().__init__(
            f"tx dropped: {TransactionStatus(status).name}")
        self.tx_hash = tx_hash
        self.status = status


# drop-reason -> the counter the overload bench/dashboards read
_DROP_METRIC = {
    TransactionStatus.TXPOOL_EVICTED: "bcos_txpool_evicted_total",
    TransactionStatus.DEADLINE_UNMEETABLE:
        "bcos_txpool_deadline_shed_total",
    TransactionStatus.BLOCK_LIMIT_CHECK_FAIL: "bcos_txpool_expired_total",
}


class TxPool:
    # max extra blocks of remaining lifetime a band-0 tx must carry as the
    # pool climbs from the low toward the high watermark (linear ramp)
    DEADLINE_SLACK_BLOCKS = 8
    # bounded memory for the typed drop records waiters settle against
    DROPPED_MAX = 8192

    def __init__(self, suite, ledger: Ledger, chain_id: str = "chain0",
                 group_id: str = "group0", pool_limit: int = DEFAULT_POOL_LIMIT,
                 block_limit_range: int = 600, registry=None,
                 low_watermark: float = 0.7, high_watermark: float = 0.95,
                 priority_bands: bool = True):
        self.suite = suite
        self._registry = registry  # None -> utils.metrics.REGISTRY
        self.ledger = ledger
        self.chain_id = chain_id
        self.group_id = group_id
        self.pool_limit = pool_limit
        # watermark admission (module docstring): fractions of pool_limit,
        # clamped sane — low strictly below high, high at most the limit
        high_watermark = min(1.0, max(0.01, float(high_watermark)))
        low_watermark = min(float(low_watermark), high_watermark)
        self._high_mark = max(1, int(pool_limit * high_watermark))
        self._low_mark = min(max(0, int(pool_limit * low_watermark)),
                             self._high_mark - 1)
        # honor the client-declared priority band (see _band). OFF treats
        # every tx as band 0 (eviction order = deadline/age only) — for
        # operators exposing the edge beyond the consortium's own
        # identified clients, where an unauthenticated band would let any
        # sender evict others' pending txs for free
        self.priority_bands = bool(priority_bands)
        self.block_limit_range = block_limit_range
        self._lock = lc.make_rlock("txpool.state")
        self._pending: "OrderedDict[bytes, Transaction]" = OrderedDict()
        self._sealed: set[bytes] = set()  # invariant: subset of _pending
        # pre-seal tombstones: hashes of in-flight proposal txs NOT yet in
        # the pool (see mark_sealed) — promoted to _sealed on arrival
        self._presealed: set[bytes] = set()
        # rolling nonce filter: block number -> set of nonces. Seeded from
        # the ledger at construction: after a WAL-replay restart the
        # filter used to come up EMPTY, so a different-hash tx reusing a
        # nonce committed just before the crash was re-admitted inside
        # the replay-protection window (found by the invariant auditor's
        # nonce_filter check during the crash-failpoint e2e run). The
        # snapshot-install path rebuilds the same way.
        self._nonces_by_block: dict[int, set[str]] = {}
        self._known_nonces: set[str] = set()
        self._install_nonce_filter(
            self._fetch_nonce_window(self.ledger.current_number()))
        self._on_ready: list[Callable[[], None]] = []
        # receipt waits: one condition broadcast per commit. A shared CV
        # (instead of the old per-hash Event dict) survives concurrent
        # waiters on the same hash — with the dict, the first waiter to
        # time out popped the registration and stranded the others — and
        # costs one notify_all per BLOCK, not per waiting RPC thread.
        self._receipt_cv = lc.make_condition("txpool.receipt")
        self._async_waiters: dict[bytes, "object"] = {}  # hash -> Task
        # typed drop records: hash -> TransactionStatus for txs that were
        # ADMITTED and later evicted/shed/expired — wait_for_receipt and
        # submit_async settle against these promptly instead of timing out
        self._dropped: "OrderedDict[bytes, TransactionStatus]" = \
            OrderedDict()
        # TransactionSync gossip hook (TransactionSync.cpp broadcast path)
        self._broadcast_hooks: list[Callable[[Sequence[Transaction]], None]] = []

    def _fetch_nonce_window(self, number: int) -> dict:
        """Read the rolling replay-protection window from the ledger —
        the ONE copy of this loop, shared by boot (no-op on fresh nodes)
        and the snapshot-install reconciliation. Pure ledger reads:
        callers run this OFF txpool.state (a window of storage lookups
        under the pool's hot lock would stall every submit/seal for the
        duration) and install the result via _install_nonce_filter."""
        by_block: dict[int, set] = {}
        lo = max(1, number - self.block_limit_range + 1)
        for bn in range(lo, number + 1):
            try:
                ns = set(n for n in self.ledger.nonces_by_number(bn) if n)
            except Exception:  # pruned below a checkpoint floor
                continue
            if ns:
                by_block[bn] = ns
        return by_block

    def _install_nonce_filter(self, by_block: dict) -> None:
        """Swap in a prefetched nonce window (txpool.state held)."""
        self._nonces_by_block = by_block
        self._known_nonces = set()
        for ns in by_block.values():
            self._known_nonces |= ns

    # -- notifications -----------------------------------------------------
    def register_unseal_notifier(self, fn: Callable[[], None]) -> None:
        self._on_ready.append(fn)

    def register_broadcast_hook(
            self, fn: Callable[[Sequence[Transaction]], None]) -> None:
        """TransactionSync registers here to gossip newly accepted txs."""
        self._broadcast_hooks.append(fn)

    def _update_pending_gauge(self) -> None:
        """Feed the dashboard's pending-tx panel (tools/monitor)."""
        from ..utils.metrics import REGISTRY
        with self._lock:
            n = len(self._pending) - len(self._sealed)
        (self._registry or REGISTRY).set_gauge("bcos_txpool_pending", n)

    def _notify_ready(self) -> None:
        for fn in self._on_ready:
            try:
                fn()
            except Exception:  # noqa: BLE001 — notifiers run AFTER
                # admission: a raising sealer callback must not surface
                # as a submit failure (the ingest lane's fallback treats
                # submit_batch exceptions as "not admitted")
                LOG.exception(badge("TXPOOL", "ready-notifier-failed"))

    # -- submission --------------------------------------------------------
    def submit(self, tx: Transaction) -> TxSubmitResult:
        return self.submit_batch([tx])[0]

    def submit_batch(self, txs: Sequence[Transaction],
                     broadcast: bool = True,
                     consensus: bool = False) -> list[TxSubmitResult]:
        """Host checks + one device batch recover for the survivors.

        Watermark/capacity verdicts run in the PRE-crypto phase: a full or
        congested pool answers TXPOOL_FULL / DEADLINE_UNMEETABLE before
        the batch recover, so rejected load costs zero lane work (the
        Blockchain-Machine shed-at-the-front-end discipline). The insert
        phase re-validates against live state — the lock is dropped across
        the recover — and performs any planned high-watermark evictions.

        `consensus=True` (the fetch-missing import behind proposal
        verification) BYPASSES watermark/capacity admission entirely: a
        saturated replica refusing the leader's proposal txs could not
        prepare and would view-change exactly while overloaded — the
        same stall the p2p layer's protected-frame classes prevent. The
        overshoot is bounded by one proposal's tx count, and the txs
        arrive pre-sealed (mark_sealed tombstones), so they are not
        eviction candidates either."""
        t0 = time.monotonic()
        hashes = batch_hash(txs, self.suite)
        results: list[Optional[TxSubmitResult]] = [None] * len(txs)
        need_verify: list[int] = []
        # ledger reads OUTSIDE txpool.state: with a remote ledger/storage
        # frontend these are RPCs, and even in-process they are GIL-held
        # time every other submitter serialises behind (bcosflow:
        # lock-blocking-interproc on the txpool.state hot lock)
        current = self.ledger.current_number()
        on_chain = [self.ledger.receipt(h) is not None for h in hashes]
        with self._lock:
            seen_batch: set[bytes] = set()
            occupancy = len(self._pending)
            victims: Optional[list] = None
            vi = 0
            for i, (tx, h) in enumerate(zip(txs, hashes)):
                st = self._precheck(tx, h, current, on_chain[i])
                if st is None and h in seen_batch:
                    st = TransactionStatus.ALREADY_IN_TXPOOL
                if st is None and not consensus:
                    if victims is None and occupancy >= min(
                            self._high_mark, self.pool_limit):
                        victims = self._victims_locked()
                    st, _victim, vi, occupancy = self._plan_admission_locked(
                        occupancy, self._band(tx), tx.block_limit, current,
                        victims, vi)
                if st is not None:
                    results[i] = TxSubmitResult(h, st)
                else:
                    seen_batch.add(h)
                    need_verify.append(i)
        drops: list[tuple[bytes, TransactionStatus, object]] = []
        if need_verify:
            sub = [txs[i] for i in need_verify]
            t_rec = time.monotonic()
            senders, ok = batch_recover_senders(sub, self.suite)
            # per-batch signature-recover time -> the latency attribution
            # plane's "crypto" stage (covers the lane AND direct paths);
            # unlabeled on purpose — all bcos_tx_stage_seconds stages
            # share one series family so cross-stage shares stay honest
            from ..utils.trace import observe_stage
            observe_stage("crypto", time.monotonic() - t_rec)
            current = self.ledger.current_number()  # off-lock, as above
            with self._lock:
                occupancy = len(self._pending)
                # the pre-crypto phase's eviction-ordered list carries
                # over: re-sorting ~pool_limit entries under the lock
                # twice per saturated batch was measurable GIL-held time
                # on exactly the hot path. The list may be stale — the
                # lock was dropped across the recover — but the consumer
                # skips entries that left the pool or got sealed, and txs
                # admitted meanwhile are merely missing as candidates
                # (errs toward rejecting the incomer, never toward
                # evicting something protected). Consumption restarts at
                # 0: the pre-phase only SIMULATED its evictions.
                vi = 0
                for j, i in enumerate(need_verify):
                    tx, h = txs[i], hashes[i]
                    if not ok[j]:
                        results[i] = TxSubmitResult(h, TransactionStatus.INVALID_SIGNATURE)
                        continue
                    victim = None
                    if not consensus:
                        if victims is None and occupancy >= min(
                                self._high_mark, self.pool_limit):
                            victims = self._victims_locked()
                        st, victim, vi, occupancy = \
                            self._plan_admission_locked(
                                occupancy, self._band(tx), tx.block_limit,
                                current, victims, vi)
                        if st is not None:
                            results[i] = TxSubmitResult(h, st)
                            continue
                    if victim is not None:
                        # high-watermark exchange: the strictly lower-
                        # priority tx loses its slot to this one
                        task = self._drop_locked(
                            victim, TransactionStatus.TXPOOL_EVICTED)
                        drops.append((victim,
                                      TransactionStatus.TXPOOL_EVICTED,
                                      task))
                    self._pending[h] = tx
                    self._dropped.pop(h, None)  # re-admission voids a
                    #                             stale drop record
                    if h in self._presealed:  # already in an in-flight
                        self._presealed.discard(h)  # proposal: arrive sealed
                        self._sealed.add(h)
                    if tx.nonce:
                        self._known_nonces.add(tx.nonce)
                    # the batch recover above already produced the
                    # sender — re-deriving via tx.sender(suite) under
                    # txpool.state puts a suite_batch recover on the
                    # hot lock's worst-case path (cache miss = crypto
                    # under the lock every submitter waits on)
                    results[i] = TxSubmitResult(h, TransactionStatus.OK,
                                                senders[j])
        self._settle_dropped(drops)
        n_ok = sum(1 for r in results
                   if r.status == TransactionStatus.OK)
        metric("txpool.submit_batch", n=len(txs), ok=n_ok,
               ms=int((time.monotonic() - t0) * 1000))
        # traced submissions: one admission span per sampled tx context
        # (cheap: touched only when a context is actually attached)
        for tx in txs:
            ctx = getattr(tx, "_otrace", None)
            if ctx is not None and ctx.sampled:
                from ..utils import otrace
                otrace.TRACER.record(
                    "txpool.admit", ctx, t0,
                    attrs={"n": len(txs), "ok": n_ok,
                           "group": self.group_id})
        self._update_pending_gauge()
        if need_verify:
            self._notify_ready()
        if broadcast and self._broadcast_hooks:
            accepted = [txs[i] for i, r in enumerate(results)
                        if r.status == TransactionStatus.OK]
            if accepted:
                for fn in self._broadcast_hooks:
                    try:
                        fn(accepted)
                    except Exception:  # noqa: BLE001 — the txs ARE admitted
                        # a gossip-hook failure must not surface as a
                        # submit failure: callers (and the ingest lane's
                        # whole coalesced cohort) would misread an
                        # admitted batch as rejected; anti-entropy
                        # re-gossips what this hook dropped
                        LOG.exception(badge("TXPOOL", "broadcast-hook-failed",
                                            n=len(accepted)))
        return [r for r in results]

    def submit_columns(self, cols, broadcast: bool = True
                       ) -> list[TxSubmitResult]:
        """Columnar admission: the wire-ingest hot path (ROADMAP item 1).

        Mirrors `submit_batch`'s two phases — pre-crypto prechecks +
        watermark planning under the lock, ONE batched recover off it,
        insert phase re-validating against live state — but every check
        reads straight off the column arrays (`protocol.columnar`): no
        `Transaction` construction, no per-field bytes copies, no Reader
        walks. Hashing is one `hash_batch` over arena slices and recovery
        is one `recover_addresses` over the batch; the only per-row
        Python object the path allocates is the lazy `TxView` for rows
        that actually ADMIT (rejected rows never materialise anything).

        Per-slice failure isolation: rows whose frames failed decode
        reject as REQUEST_NOT_BELIEVABLE (tx_hash left empty — there is
        no trustworthy identity to report), rows with bad signatures
        reject INVALID_SIGNATURE, and neither poisons its batchmates."""
        t0 = time.monotonic()
        n = len(cols)
        results: list[Optional[TxSubmitResult]] = [None] * n
        rows: list[int] = []
        for i in range(n):
            if cols.decode_ok[i]:
                rows.append(i)
            else:
                results[i] = TxSubmitResult(
                    b"", TransactionStatus.REQUEST_NOT_BELIEVABLE)
        hashes = cols.ensure_hashes(self.suite)
        from ..utils.trace import observe_stage
        # ledger reads OUTSIDE txpool.state (same rationale as
        # submit_batch: GIL-held / possibly-RPC work off the hot lock)
        current = self.ledger.current_number()
        on_chain = {i: self.ledger.receipt(hashes[i]) is not None
                    for i in rows}
        need_verify: list[int] = []
        with self._lock:
            seen_batch: set[bytes] = set()
            occupancy = len(self._pending)
            victims: Optional[list] = None
            vi = 0
            for i in rows:
                h = hashes[i]
                st = self._precheck_fields(
                    h, cols.chain_id[i], cols.group_id[i],
                    int(cols.block_limit[i]), cols.nonce[i], current,
                    on_chain[i])
                if st is None and h in seen_batch:
                    st = TransactionStatus.ALREADY_IN_TXPOOL
                if st is None:
                    if victims is None and occupancy >= min(
                            self._high_mark, self.pool_limit):
                        victims = self._victims_locked()
                    st, _victim, vi, occupancy = self._plan_admission_locked(
                        occupancy, self._band_attr(int(cols.attribute[i])),
                        int(cols.block_limit[i]), current, victims, vi)
                if st is not None:
                    results[i] = TxSubmitResult(h, st)
                else:
                    seen_batch.add(h)
                    need_verify.append(i)
        drops: list[tuple[bytes, TransactionStatus, object]] = []
        accepted: list = []
        if need_verify:
            t_rec = time.monotonic()
            ok_mask = cols.ensure_senders(self.suite, rows=need_verify)
            observe_stage("crypto", time.monotonic() - t_rec)
            current = self.ledger.current_number()  # off-lock, as above
            with self._lock:
                occupancy = len(self._pending)
                vi = 0  # stale-list carryover: see submit_batch
                for i in need_verify:
                    h = hashes[i]
                    if not ok_mask[i]:
                        results[i] = TxSubmitResult(
                            h, TransactionStatus.INVALID_SIGNATURE)
                        continue
                    if victims is None and occupancy >= min(
                            self._high_mark, self.pool_limit):
                        victims = self._victims_locked()
                    st, victim, vi, occupancy = self._plan_admission_locked(
                        occupancy, self._band_attr(int(cols.attribute[i])),
                        int(cols.block_limit[i]), current, victims, vi)
                    if st is not None:
                        results[i] = TxSubmitResult(h, st)
                        continue
                    if victim is not None:
                        task = self._drop_locked(
                            victim, TransactionStatus.TXPOOL_EVICTED)
                        drops.append((victim,
                                      TransactionStatus.TXPOOL_EVICTED,
                                      task))
                    # the FIRST (and only) per-row object on this path:
                    # the pool's pending map holds tx-shaped things, and
                    # everything downstream of admission (seal, execute,
                    # prewrite, gossip re-encode) runs on the lazy view
                    v = cols.view(i)
                    self._pending[h] = v
                    self._dropped.pop(h, None)
                    if h in self._presealed:
                        self._presealed.discard(h)
                        self._sealed.add(h)
                    if cols.nonce[i]:
                        self._known_nonces.add(cols.nonce[i])
                    accepted.append(v)
                    results[i] = TxSubmitResult(h, TransactionStatus.OK,
                                                cols.senders[i])
        self._settle_dropped(drops)
        metric("txpool.submit_columns", n=n, ok=len(accepted),
               ms=int((time.monotonic() - t0) * 1000))
        self._update_pending_gauge()
        if need_verify:
            self._notify_ready()
        if broadcast and accepted and self._broadcast_hooks:
            for fn in self._broadcast_hooks:
                try:
                    fn(accepted)
                except Exception:  # noqa: BLE001 — same contract as
                    # submit_batch: admitted txs must not read as rejected
                    LOG.exception(badge("TXPOOL", "broadcast-hook-failed",
                                        n=len(accepted)))
        return [r for r in results]

    def _precheck(self, tx: Transaction, h: bytes, current: int,
                  on_chain: bool) -> Optional[TransactionStatus]:
        """Cheap host-side validation (TxValidator.cpp:33-51 semantics).

        `on_chain` is the ledger dup-check verdict, computed by the
        caller BEFORE acquiring txpool.state: the ledger read may be a
        storage lookup (or, split-service, an RPC) and must not run
        under the pool's hot lock."""
        return self._precheck_fields(h, tx.chain_id, tx.group_id,
                                     tx.block_limit, tx.nonce, current,
                                     on_chain)

    def _precheck_fields(self, h: bytes, chain_id: str, group_id: str,
                         block_limit: int, nonce: str, current: int,
                         on_chain: bool) -> Optional[TransactionStatus]:
        """Scalar-argument core of `_precheck`: the columnar path calls
        this straight off the column arrays, so a rejected row never
        materialises a tx object at all."""
        if h in self._pending or h in self._sealed:
            return TransactionStatus.ALREADY_IN_TXPOOL
        if on_chain:
            return TransactionStatus.ALREADY_KNOWN
        if chain_id != self.chain_id:
            return TransactionStatus.INVALID_CHAINID
        if group_id != self.group_id:
            return TransactionStatus.INVALID_GROUPID
        if block_limit <= current or \
                block_limit > current + self.block_limit_range:
            return TransactionStatus.BLOCK_LIMIT_CHECK_FAIL
        if nonce and nonce in self._known_nonces:
            return TransactionStatus.NONCE_CHECK_FAIL
        return None

    # -- watermark admission (overload control) ----------------------------
    def _band(self, tx: Transaction) -> int:
        """Client-declared priority band: the `attribute` word's top byte
        (0-255, default 0). The gas-price-band analogue — this chain has
        no fee market, so priority rides the tx attribute instead.

        TRUST MODEL: the byte is unauthenticated wire data. On a
        permissioned consortium chain (this chain's deployment shape) it
        is a cooperative QoS signal among identified clients — an abuser
        is an access-control problem, and per-client edge budgets
        (rpc/admission.py) bound what any one identity can push. An
        operator exposing the edge to unidentified traffic should set
        `[txpool] priority_bands = false` (bands ignored, eviction by
        deadline/age only), because a forged band-255 flood could
        otherwise evict other clients' pending txs for free."""
        return self._band_attr(tx.attribute)

    def _band_attr(self, attribute: int) -> int:
        """`_band` off the raw attribute word — the columnar path reads
        it straight from the attribute column."""
        if not self.priority_bands:
            return 0
        return (attribute >> 24) & 0xFF

    def _victims_locked(self) -> list:
        """Unsealed pending txs in eviction order — ascending
        (band, block_limit): lowest priority band first, then the
        soonest-expiring, insertion order breaking ties (sort stability
        over the OrderedDict scan keeps the OLDEST first). Sealed txs are
        untouchable: they ride in-flight proposals."""
        return sorted(((self._band(t), t.block_limit, h)
                       for h, t in self._pending.items()
                       if h not in self._sealed),
                      key=lambda v: (v[0], v[1]))

    def _plan_admission_locked(self, occupancy: int, band: int,
                               block_limit: int, current: int,
                               victims: Optional[list], vi: int):
        """One candidate's watermark verdict, off scalar (band,
        block_limit) so the columnar path feeds it straight from columns.
        -> (status|None, victim_hash|None, vi, occupancy).

        `victims` is the lazily built eviction-ordered list (None while
        the pool is below the high watermark), consumed through `vi` so a
        batch's planned evictions never target the same victim twice.
        Pure decision in the pre-crypto phase (victim ignored); in the
        insert phase the returned victim is actually evicted. Freshly
        inserted batch members are not candidates — the scan predates
        them, which only errs toward keeping the newest txs."""
        high = min(self._high_mark, self.pool_limit)
        if occupancy >= high:
            if victims is not None:
                while vi < len(victims) and (
                        victims[vi][2] not in self._pending
                        or victims[vi][2] in self._sealed):
                    vi += 1  # went stale since the scan (committed/sealed)
                if vi < len(victims) \
                        and victims[vi][:2] < (band, block_limit):
                    # strictly lower priority pending: exchange slots
                    return None, victims[vi][2], vi + 1, occupancy
            return TransactionStatus.TXPOOL_FULL, None, vi, occupancy
        if occupancy >= self._low_mark and band == 0:
            # between the watermarks: band-0 txs must carry enough
            # remaining lifetime to realistically seal before expiry —
            # the required slack ramps with congestion
            frac = (occupancy - self._low_mark) / max(
                1, high - self._low_mark)
            required = 1 + int(self.DEADLINE_SLACK_BLOCKS * frac)
            if block_limit - current < required:
                return (TransactionStatus.DEADLINE_UNMEETABLE, None, vi,
                        occupancy)
        return None, None, vi, occupancy + 1

    def _drop_locked(self, h: bytes, status: TransactionStatus):
        """Remove a pending tx for a TYPED reason and record it so waiters
        settle promptly. Caller holds the lock; the returned async task
        (if any) must be rejected OUTSIDE it (via _settle_dropped).

        The nonce is NOT freed: a drop is NODE-LOCAL and the tx was
        already gossiped — a peer may still seal and commit it, so
        re-admitting the same nonce here would break replay protection
        (two same-nonce txs landing in different blocks). Resubmission
        after a drop uses a FRESH nonce, exactly like after a timeout."""
        self._pending.pop(h, None)
        self._sealed.discard(h)
        self._presealed.discard(h)
        self._dropped[h] = status
        while len(self._dropped) > self.DROPPED_MAX:
            self._dropped.popitem(last=False)
        return self._async_waiters.pop(h, None)

    def _settle_dropped(self, drops: list) -> None:
        """Post-lock half of a drop: metrics, receipt-waiter wakeup, async
        task rejection with the typed TxDropped."""
        if not drops:
            return
        from ..utils.metrics import REGISTRY
        reg = self._registry or REGISTRY
        for _h, status, _task in drops:
            name = _DROP_METRIC.get(status)
            if name:
                reg.inc(name)
        with self._receipt_cv:
            self._receipt_cv.notify_all()
        for h, status, task in drops:
            if task is not None:
                task.reject(TxDropped(h, status))

    def dropped_status(self, tx_hash: bytes) -> Optional[TransactionStatus]:
        """Typed reason a formerly admitted tx left the pool uncommitted
        (None when unknown/still pending/committed)."""
        with self._lock:
            return self._dropped.get(tx_hash)

    def occupancy_fraction(self) -> float:
        """Pool fill against the HIGH watermark (~1.0 = eviction
        territory) — the overload controller's txpool signal."""
        with self._lock:
            return len(self._pending) / max(1, self._high_mark)

    # -- sealing (MemoryStorage.cpp:570 batchFetchTxs) ---------------------
    def seal(self, max_txs: int, for_number: Optional[int] = None
             ) -> tuple[list[Transaction], list[bytes]]:
        """Fetch up to max_txs unsealed txs, marking them sealed. Re-checks
        block_limit against the height the proposal will OCCUPY
        (`for_number`; committed+1 when the caller doesn't know) — a tx
        whose limit falls below it would be expired inside its own block,
        so it is dropped with the typed expiry status BEFORE consuming a
        seal slot (with pipelining, proposals run ahead of the committed
        height, so checking only `current` let near-deadline txs burn
        verify + seal work and then expire anyway)."""
        drops: list = []
        current = self.ledger.current_number()  # ledger read off-lock
        with self._lock:
            threshold = for_number if for_number is not None else current + 1
            out, hashes, expired = [], [], []
            for h, tx in self._pending.items():
                if h in self._sealed:
                    continue
                if tx.block_limit < threshold:
                    expired.append(h)
                    continue
                out.append(tx)
                hashes.append(h)
                if len(out) >= max_txs:
                    break
            self._sealed.update(hashes)
            for h in expired:
                task = self._drop_locked(
                    h, TransactionStatus.BLOCK_LIMIT_CHECK_FAIL)
                drops.append((h, TransactionStatus.BLOCK_LIMIT_CHECK_FAIL,
                              task))
        self._settle_dropped(drops)  # never leak an expired submission
        self._update_pending_gauge()
        return out, hashes

    def unseal(self, hashes: Sequence[bytes]) -> None:
        """Return sealed txs to the pool (failed proposal / view change)."""
        with self._lock:
            for h in hashes:
                self._sealed.discard(h)
                self._presealed.discard(h)
        self._update_pending_gauge()
        self._notify_ready()

    def mark_sealed(self, hashes: Sequence[bytes]) -> None:
        """Mark txs as sealed WITHOUT fetching them — consensus calls this
        when accepting a proposal so the local sealer (which may lead a
        later pipelined height) never packs the same txs into a second
        proposal (the reference's asyncMarkTxs(sealed=true) on proposal
        receipt, MemoryStorage.cpp:700).

        A hash not in the pool yet leaves a PRE-SEAL tombstone: if the tx
        arrives later via gossip it enters the pool already sealed, so a
        pipelined next-height proposal can never double-include it (it
        would become unexecutable cluster-wide once the earlier height
        commits and prunes the tx). Tombstones are cleared by commit,
        unseal (view change) or tx arrival."""
        with self._lock:
            for h in hashes:
                if h in self._pending:
                    self._sealed.add(h)
                else:
                    self._presealed.add(h)
        self._update_pending_gauge()

    def pending_txs(self, max_txs: int = 0) -> list[Transaction]:
        """Unsealed pending txs, oldest first (TransactionSync's periodic
        anti-entropy rebroadcast; sealed txs ride their proposal instead)."""
        with self._lock:
            out = [tx for h, tx in self._pending.items()
                   if h not in self._sealed]
        return out[:max_txs] if max_txs else out

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending) - len(self._sealed)

    def status(self) -> dict:
        with self._lock:
            return {"pending": len(self._pending),
                    "sealed": len(self._sealed),
                    "lowWatermark": self._low_mark,
                    "highWatermark": self._high_mark,
                    "dropped": len(self._dropped)}

    def known_nonces(self) -> frozenset:
        """Snapshot of the rolling replay-protection filter — read by the
        invariant auditor (ops/audit.py), which cross-checks it against
        the nonces the ledger actually committed in the window."""
        with self._lock:
            return frozenset(self._known_nonces)

    # -- proposal verification (TxPool.cpp:160 asyncVerifyBlock) -----------
    def fill_block(self, tx_hashes: Sequence[bytes]) -> Optional[list[Transaction]]:
        """hashes -> txs from the pool (BlockExecutive::prepare's
        asyncFillBlock). None if any is missing."""
        with self._lock:
            out = []
            for h in tx_hashes:
                tx = self._pending.get(h)
                if tx is None:
                    return None
                out.append(tx)
            return out

    def missing_hashes(self, hashes: Sequence[bytes]) -> list[bytes]:
        """Subset of `hashes` not present in the pool (fetch-missing path)."""
        with self._lock:
            return [h for h in hashes if h not in self._pending]

    def unknown_hashes(self, hashes: Sequence[bytes]) -> set[bytes]:
        """Subset of `hashes` this node holds NO copy of (not pending and
        not committed) — the gossip import path's decode filter."""
        with self._lock:
            cand = [h for h in hashes if h not in self._pending]
        return {h for h in cand if self.ledger.receipt(h) is None}

    def verify_proposal(self, block: Block) -> bool:
        """Verify a proposal: every tx known (already validated at submit) or,
        if the proposal carries full txs, batch-verify the unknown ones
        (MemoryStorage.cpp:919 batchVerifyProposal)."""
        # batch_hash: txs that rode submit -> seal on this node carry their
        # cached hash; only gossip-fresh ones are hashed, in ONE call
        hashes = block.tx_hashes or batch_hash(block.transactions, self.suite)
        with self._lock:
            missing = [h for h in hashes if h not in self._pending]
        if not missing:
            return True
        if not block.transactions:
            return False
        by_hash = dict(zip(batch_hash(block.transactions, self.suite),
                           block.transactions))
        todo = [by_hash[h] for h in missing if h in by_hash]
        if len(todo) != len(missing):
            return False
        _, ok = batch_recover_senders(todo, self.suite)
        if not bool(np.all(ok)):
            return False
        # import the newly-verified txs so commit can prune them; the
        # ledger reads and hashing stay OFF the txpool.state hot lock
        todo_hashes = batch_hash(todo, self.suite)
        current = self.ledger.current_number()
        todo_known = [self.ledger.receipt(h) is not None
                      for h in todo_hashes]
        with self._lock:
            for tx, h, known in zip(todo, todo_hashes, todo_known):
                if self._precheck(tx, h, current, known) is None:
                    self._pending[h] = tx
                    self._sealed.add(h)
                    self._presealed.discard(h)
                    if tx.nonce:
                        self._known_nonces.add(tx.nonce)
        return True

    # -- commit notification (prune + nonce window) ------------------------
    def on_block_committed(self, number: int, tx_hashes: Sequence[bytes],
                           nonces: Sequence[str]) -> None:
        with self._lock:
            for h in tx_hashes:
                self._pending.pop(h, None)
                self._sealed.discard(h)
                self._presealed.discard(h)
            ns = set(n for n in nonces if n)
            self._nonces_by_block[number] = ns
            self._known_nonces.update(ns)
            expired = number - self.block_limit_range
            for bn in [b for b in self._nonces_by_block if b <= expired]:
                self._known_nonces -= self._nonces_by_block.pop(bn)
            tasks = [(h, self._async_waiters.pop(h)) for h in tx_hashes
                     if h in self._async_waiters]
        with self._receipt_cv:
            self._receipt_cv.notify_all()
        for h, task in tasks:
            task.resolve(self.ledger.receipt(h))
        self._update_pending_gauge()
        self._notify_ready()

    def on_snapshot_installed(self, number: int) -> None:
        """The ledger jumped to `number` via a snap-sync install — per-block
        commit notifications never ran for the jumped range. Reconcile:
        drop pending txs the installed state already committed (receipt
        lookup; pruned heights have none, but their txs are long past
        block_limit anyway), rebuild the rolling nonce filter from the
        installed nonce tables, and settle receipt waiters."""
        with self._lock:
            candidates = list(self._pending)
        # receipt probes are storage reads — O(pool) of them must not run
        # under the pool lock (they'd stall every submit/seal for the
        # duration); the pops below re-check membership anyway
        committed = [h for h in candidates
                     if self.ledger.receipt(h) is not None]
        nonce_window = self._fetch_nonce_window(number)  # off-lock too
        with self._lock:
            for h in committed:
                self._pending.pop(h, None)
                self._sealed.discard(h)
                self._presealed.discard(h)
            self._install_nonce_filter(nonce_window)
            # txs that survived the reconciliation are still pending: their
            # nonces were admitted at submit time and must keep blocking
            # duplicates (they are in no block's nonce table yet)
            for tx in self._pending.values():
                if tx.nonce:
                    self._known_nonces.add(tx.nonce)
            tasks = [(h, self._async_waiters.pop(h)) for h in committed
                     if h in self._async_waiters]
        with self._receipt_cv:
            self._receipt_cv.notify_all()
        for h, task in tasks:
            task.resolve(self.ledger.receipt(h))
        self._update_pending_gauge()
        self._notify_ready()

    def submit_async(self, tx: Transaction):
        """Submit and return a Task[Receipt] that settles at commit — the
        libtask analogue of the reference's coroutine submitTransaction
        (Task.h:19-50 awaited at JsonRpcImpl_2_0.cpp:455). Rejected with
        SubmitRejected if admission fails."""
        from ..utils.task import Task

        task: Task = Task()
        res = self.submit(tx)
        if int(res.status) != 0:
            task.reject(SubmitRejected(res))
            return task
        h = res.tx_hash
        rc = self.ledger.receipt(h)
        if rc is not None:
            task.resolve(rc)
            return task
        with self._lock:
            self._async_waiters[h] = task
        rc = self.ledger.receipt(h)  # commit raced the registration
        if rc is not None:
            with self._lock:
                self._async_waiters.pop(h, None)
            task.resolve(rc)
            return task
        st = self.dropped_status(h)  # ...and so can a drop (seal expiry /
        if st is not None:           # eviction): a _drop_locked that ran
            with self._lock:         # before the registration above
                popped = self._async_waiters.pop(h, None)  # popped no
            if popped is not None:   # waiter — settle it here; if the
                popped.reject(TxDropped(h, st))  # drop path raced us and
                #                      took the task, it settles it itself
        return task

    # -- RPC receipt waiting ----------------------------------------------
    def wait_for_receipt(self, tx_hash: bytes, timeout: float = 30.0):
        """Block until the tx is committed; -> Receipt or None on timeout.
        Raises TxDropped the moment the pool records the tx as evicted/
        shed/expired — a client must not hang to its full timeout for a tx
        that can no longer commit (the drop path broadcasts the same CV).

        Event-driven: parks on `_receipt_cv` (broadcast once per committed
        block from `on_block_committed`) instead of polling the ledger —
        a node under concurrent RPC load must not burn its cores spinning.
        The parked path's receipt check runs WHILE HOLDING the cv lock, so
        a commit that lands between the check and the wait still delivers
        its wakeup (the notifier can't broadcast until the waiter is
        parked); the common already-committed path stays lock-free."""
        rc = self.ledger.receipt(tx_hash)
        if rc is not None:
            return rc
        deadline = time.monotonic() + timeout
        with self._receipt_cv:
            while True:
                rc = self.ledger.receipt(tx_hash)
                if rc is not None:
                    return rc
                st = self.dropped_status(tx_hash)
                if st is not None:  # receipt checked FIRST: a committed
                    raise TxDropped(tx_hash, st)  # tx always wins
                left = deadline - time.monotonic()
                if left <= 0:
                    return None
                self._receipt_cv.wait(left)
