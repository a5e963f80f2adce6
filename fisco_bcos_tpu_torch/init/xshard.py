"""CrossShardCoordinator — drives cross-group transfers to completion.

The XShard precompile (executor/precompiled.py) defines the three legs of
a cross-group transfer as ordinary transactions: `transferOut` escrows the
debit on the source group, `credit` lands the funds on the destination
group (idempotent, dedup inbox), `finish` settles or refunds the escrow.
This worker is the 2PC coordinator binding the two groups' commit paths:

  * it observes every group's scheduler commits; a commit wakes a sweep
    that scans that group's pending-marker table (`c_xshard_pend` — O(in
    flight), not O(history));
  * for each pending transfer it submits the `credit` tx to the
    destination group, waits for its committed receipt, then submits
    `finish(ok)` back to the source group. An unknown destination group or
    a definitively REVERTED credit drives `finish(ok=0)` — the refund
    (abort) path. A timeout leaves the transfer pending for the next sweep
    (retries are safe: credit and finish are idempotent by construction).

Crash safety rides the per-group block 2PC + WAL: every leg is a committed
block change, `start()` runs a recovery sweep over whatever WAL replay
restored, and a kill -9 at ANY point between the escrow commit and the
finish commit re-drives to the same all-or-nothing outcome. The trust
model matches the deployment shape: the coordinator runs inside the node
process and signs its legs with the node key — the same trust domain as
the node's own consensus participation.
"""

from __future__ import annotations

import threading
from typing import Optional

from ..executor import precompiled as pc
from ..protocol import Transaction, TransactionStatus
from ..utils import failpoints as fp
from ..utils.log import LOG, badge, metric
from ..utils.metrics import REGISTRY

_RECEIPT_WAIT = 30.0


def _wait_receipt(node, h: bytes, timeout: float = _RECEIPT_WAIT):
    """Receipt or None — a coordinator leg evicted/shed from the pool
    under overload (TxDropped) is 'unsettled, retry next sweep', exactly
    like a timeout; the saga's idempotent legs make the retry safe."""
    from ..txpool.txpool import TxDropped
    try:
        return node.txpool.wait_for_receipt(h, timeout)
    except TxDropped:
        return None

# saga-leg fault sites (utils/failpoints.py): a raise between the escrow
# commit and the credit, or between the credit and the settle, leaves the
# transfer pending for the next sweep — the matrix asserts it still lands
# exactly once (idempotent legs + durable pending markers)
fp.register("xshard.sweep", "xshard.credit.before_submit",
            "xshard.finish.before_submit")


class CrossShardCoordinator:
    """One per GroupManager. Event-driven sweep worker + boot recovery."""

    def __init__(self, mgr, poll_s: float = 1.0):
        self.mgr = mgr  # GroupManager: .groups() / .node(gid)
        self.poll_s = poll_s
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # transfers currently being driven (survives nothing — rebuilt by
        # the sweep from the durable pending markers)
        self._inflight: set[tuple[str, bytes]] = set()
        self._lock = threading.Lock()
        self.completed_total = 0
        self.aborted_total = 0

    # -- wiring ------------------------------------------------------------
    def attach(self, group_id: str, node) -> None:
        """Observe a group's commits (called by GroupManager.add_group)."""
        node.scheduler.on_commit.append(lambda _n: self._wake.set())

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._wake.set()  # boot recovery sweep: WAL replay may have
        #                   restored pending escrows mid-protocol
        self._thread = threading.Thread(target=self._run, name="xshard",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    # -- worker ------------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self.poll_s)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self.sweep()
            except Exception:  # noqa: BLE001 — coordinator must survive
                LOG.exception(badge("XSHARD", "sweep-failed"))

    def sweep(self) -> int:
        """Drive every pending transfer one step; -> transfers settled.

        Pipelined per source group: every pending transfer's `credit` tx
        is submitted BEFORE any receipt is awaited (credits to one
        destination coalesce into shared blocks — and shared verify
        batches through the crypto lane), then the verdicts fan back into
        one wave of `finish` txs the same way."""
        fp.fire("xshard.sweep")
        driven = 0
        for gid in self.mgr.groups():
            node = self.mgr.node(gid)
            if node is None:
                continue
            try:
                pending = list(node.storage.keys(pc.T_XSHARD_PEND))
            except Exception:  # storage closing during shutdown
                continue
            if not pending or self._stop.is_set():
                continue
            driven += self._drive_group(gid, node, pending)
        return driven

    def _drive_group(self, gid: str, src_node, pending: list[bytes]) -> int:
        claimed: list[bytes] = []
        try:
            return self._drive_group_claimed(gid, src_node, pending,
                                             claimed)
        finally:
            # ALWAYS release the claims: an exception mid-drive (lane
            # timeout, corrupt row, storage stall) is swallowed by the
            # worker loop, and a leaked claim would make every later
            # sweep skip the transfer forever — locked escrow until
            # restart
            with self._lock:
                for xid in claimed:
                    self._inflight.discard((gid, xid))

    def _drive_group_claimed(self, gid: str, src_node,
                             pending: list[bytes],
                             claimed: list[bytes]) -> int:
        # phase 2 fan-out: submit every credit, then await the receipts
        waits: list[tuple[bytes, object, bytes]] = []  # (xid, dst_node, h)
        verdicts: dict[bytes, Optional[bool]] = {}
        for xid in pending:
            with self._lock:
                if (gid, xid) in self._inflight:
                    continue
                self._inflight.add((gid, xid))
            claimed.append(xid)
            raw = src_node.storage.get(pc.T_XSHARD_OUT, xid)
            intent = pc.decode_intent(raw) if raw is not None else None
            if intent is None or intent["status"] != pc.XS_PENDING:
                verdicts[xid] = None  # mid-shutdown read / already settled
                continue
            dst_node = (self.mgr.node(intent["dst_group"])
                        if intent["dst_group"] != gid else None)
            if dst_node is None:
                # unknown destination (or self-transfer): definitive abort
                LOG.warning(badge("XSHARD", "abort-unknown-dst", src=gid,
                                  dst=intent["dst_group"],
                                  xid=xid.hex()[:16]))
                verdicts[xid] = False
                continue
            # a prior (crashed) drive may have LANDED the credit already —
            # its inbox record is the durable verdict. Without this check
            # a crash between the credit commit and the finish leg parks
            # the transfer for the whole nonce window: the re-submitted
            # credit tx reuses the deterministic nonce and is refused with
            # NONCE_CHECK_FAIL until block_limit_range blocks roll by
            # (found by the xshard.finish.before_submit failpoint sweep).
            seen = dst_node.storage.get(pc.T_XSHARD_IN, xid)
            if seen is not None:
                verdicts[xid] = seen == pc.encode_inbox_record(
                    gid, intent["dst"], intent["amount"])
                continue
            # the window between the escrow commit and the credit — the
            # classic lost-in-flight-transfer crash point
            fp.fire("xshard.credit.before_submit")
            tx = self._leg_tx(
                dst_node, "credit",
                lambda w, xid=xid, intent=intent: (
                    w.blob(xid).text(gid).blob(intent["dst"])
                    .u64(intent["amount"])),
                nonce=f"xs-c-{xid.hex()}")
            h = self._submit(dst_node, tx)
            if h is None:
                verdicts[xid] = None
            else:
                waits.append((xid, dst_node, h))
        for xid, dst_node, h in waits:
            rc = _wait_receipt(dst_node, h)
            if rc is None:
                verdicts[xid] = None  # unsettled: next sweep retries
            elif rc.status == 0:
                verdicts[xid] = True
            elif rc.status == int(TransactionStatus.REVERT):
                verdicts[xid] = False  # definitive (id reused w/ other terms)
            else:
                verdicts[xid] = None
        # phase 3 fan-out: settle every decided transfer on the source
        fin: list[tuple[bytes, bool, bytes]] = []
        for xid in claimed:
            ok = verdicts.get(xid)
            if ok is None:
                continue
            # the window between the credit commit and the settle leg
            fp.fire("xshard.finish.before_submit")
            tx = self._leg_tx(
                src_node, "finish",
                lambda w, xid=xid, ok=ok: w.blob(xid).u8(1 if ok else 0),
                nonce=f"xs-f-{xid.hex()}-{int(ok)}")
            h = self._submit(src_node, tx)
            if h is not None:
                fin.append((xid, ok, h))
        settled = 0
        for xid, ok, h in fin:
            rc = _wait_receipt(src_node, h)
            if rc is not None and rc.status == 0:
                settled += 1
                with self._lock:
                    if ok:
                        self.completed_total += 1
                    else:
                        self.aborted_total += 1
                REGISTRY.inc("bcos_xshard_completed_total" if ok
                             else "bcos_xshard_aborted_total")
                metric("xshard.settled", ok=int(ok), src=gid)
        return settled

    def _submit(self, node, tx) -> Optional[bytes]:
        """Submit one leg; -> tx hash to await, or None to retry later."""
        res = node.send_transaction(tx)
        st = int(res.status)
        if st in (int(TransactionStatus.OK),
                  int(TransactionStatus.ALREADY_IN_TXPOOL),
                  int(TransactionStatus.ALREADY_KNOWN)):
            return res.tx_hash
        # NONCE_CHECK_FAIL: a prior (crashed) attempt's leg landed under
        # this nonce with a different hash — the precompile's idempotency
        # makes re-submission safe once the nonce window rolls; any other
        # admission failure (pool full) is transient. Retry next sweep.
        return None

    def _leg_tx(self, node, method: str, build, nonce: str) -> Transaction:
        current = node.ledger.current_number()
        return Transaction(
            to=pc.XSHARD_ADDRESS,
            input=pc.encode_call(method, build),
            nonce=nonce,
            chain_id=node.config.chain_id,
            group_id=node.config.group_id,
            block_limit=current + min(100, node.config.block_limit_range),
        ).sign(node.suite, node.keypair)

    # -- introspection -----------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {"completed_total": self.completed_total,
                    "aborted_total": self.aborted_total,
                    "inflight": len(self._inflight)}
