"""BlockSync — download/broadcast state machine for lagging nodes.

Reference counterpart: FISCO-BCOS bcos-sync/bcos-sync/BlockSync.cpp
(:183 executeWorker -> :194 maintainPeersStatus, :200
maintainDownloadingQueue, :216 maintainBlockRequest) — peers gossip their
latest number, a lagging node requests ranges, and every fetched block's
commit seals are batch-verified before replay
(bcos-pbft/bcos-pbft/pbft/engine/BlockValidator.cpp:141 checkSignatureList —
here ONE `suite.verify_batch` call across all seals of all fetched blocks).

Two worker threads, deliberately: the STATUS worker broadcasts our height
and prunes silent peers on a fixed cadence; the DOWNLOAD worker issues the
blocking range/snapshot requests. A slow or dead peer can therefore stall a
download for its full timeout without ever delaying our own status gossip —
previously both ran on one loop and a 10 s request starved
`broadcast_status` long enough for peers to TTL-prune us.

Sync modes:
  * replay — fetch block ranges, verify seals, re-execute, commit (the
    default catch-up path);
  * snap   — when a peer is more than `snap_sync_threshold` blocks ahead
    (or answers "pruned-below" for a requested range), fetch its snapshot
    manifest + chunks over ModuleID.SnapshotSync, batch-verify chunk hashes
    against the manifest root and the checkpoint header's commit seals
    (the same `_verify_seals`), install the state, then replay only the
    tail. O(state size) batched hashing instead of O(chain length) replay.

Wire payloads (module BlockSync):
  push:     status  = i64 number | blob latest_hash | i64 utc_ms
            (utc_ms feeds NodeTimeMaintenance, tool/timesync.py — the
            reference's NodeTimeMaintenance.cpp rides the same gossip)
  request:  range   = i64 from | i64 to
  response: u8 flag — RESP_BLOCKS: seq<blob block-encoding (full txs)>,
                      byte-capped: the server returns fewer blocks when
                      MAX_RESPONSE_BYTES is hit and the client re-requests;
            RESP_PRUNED: i64 pruned_below — the server pruned bodies below
                      that height; the client fails over to snap-sync.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ..codec.wire import Reader, Writer
from ..consensus import qc
from ..net.front import FrontService
from ..net.moduleid import ModuleID
from ..protocol import Block, BlockHeader, batch_recover_senders
from ..utils.log import LOG, badge, metric
from ..utils.metrics import REGISTRY
from ..utils.worker import Worker

MAX_BLOCKS_PER_REQUEST = 32
# full-tx blocks are unbounded; a 32-block response must still fit a gossip
# frame, so the server stops adding blocks at this budget and the client
# simply re-requests from where the response ended
MAX_RESPONSE_BYTES = 1 << 20
# must stay well below status_interval * PEER_TTL_INTERVALS: a request's
# worst-case block time on the download worker must never approach the TTL
# that peers apply to OUR silence
REQUEST_TIMEOUT = 5.0

RESP_BLOCKS = 0
RESP_PRUNED = 1

SNAP_RETRY_SECONDS = 5.0  # failed snap attempt: back off, replay continues


class _DownloadWorker(Worker):
    """Dedicated thread for the blocking download requests."""

    def __init__(self, sync: "BlockSync"):
        super().__init__("block-sync-dl", idle_wait=0.1)
        self._sync = sync

    def execute_worker(self) -> None:
        self._sync._maybe_download()


class BlockSync(Worker):
    def __init__(self, front: FrontService, ledger, scheduler, suite,
                 status_interval: float = 1.0, timesync=None,
                 snapshot=None, snap_sync_threshold: int = 0,
                 registry=None, agg_registry=None):
        super().__init__("block-sync", idle_wait=0.1)
        # metrics sink: multi-group nodes pass a group-labeled view
        self._reg = registry if registry is not None else REGISTRY
        # PoP'd BLS key roster (crypto/agg.py) — needed only to accept
        # aggregate-mode certificates; without it those blocks are rejected
        self.agg_registry = agg_registry
        self.front = front
        self.ledger = ledger
        self.scheduler = scheduler
        self.suite = suite
        self.timesync = timesync  # tool.timesync.NodeTimeMaintenance
        self.status_interval = status_interval
        self.snapshot = snapshot  # snapshot.service.SnapshotService | None
        # 0 disables snap-sync preference (pruned-below answers still
        # trigger it — replay is impossible there)
        self.snap_sync_threshold = snap_sync_threshold
        self.sync_mode = "replay"  # last catch-up mechanism used
        # peer -> (latest number, monotonic last-seen); silent peers are
        # pruned so a departed node can't pin the download target or the
        # timesync median forever
        self._peers: dict[bytes, tuple[int, float]] = {}
        # peer -> its advertised prune floor: a range request below it is a
        # guaranteed RESP_PRUNED round trip, so the download worker goes
        # straight to the (backed-off) snap path instead of re-asking every
        # idle tick
        self._pruned_floors: dict[bytes, int] = {}
        self._lock = threading.Lock()
        self._last_status = 0.0
        self._inflight = False
        self._next_snap_attempt = 0.0
        self._downloader = _DownloadWorker(self)
        self._reg.set_gauge("bcos_sync_mode", 0)  # 0 replay | 1 snap
        front.register_module(ModuleID.BlockSync, self._on_message)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        super().start()
        self._downloader.start()

    def stop(self) -> None:
        self._downloader.stop()
        super().stop()

    # -- status worker (gossip cadence; never blocks on a peer) -----------
    PEER_TTL_INTERVALS = 10  # silent for 10 status periods -> forgotten

    def execute_worker(self) -> None:
        now = time.monotonic()
        if now - self._last_status >= self.status_interval:
            self._last_status = now
            self.broadcast_status()
            self._prune_peers(now)

    def _prune_peers(self, now: float) -> None:
        ttl = self.status_interval * self.PEER_TTL_INTERVALS
        with self._lock:
            dead = [p for p, (_, seen) in self._peers.items()
                    if now - seen > ttl]
            for p in dead:
                del self._peers[p]
                self._pruned_floors.pop(p, None)
        for p in dead:
            if self.timesync is not None:
                self.timesync.forget_peer(p)

    def broadcast_status(self) -> None:
        n = self.ledger.current_number()
        h = self.ledger.header_by_number(n)
        payload = (Writer().i64(n)
                   .blob(h.hash(self.suite) if h else b"")
                   .i64(int(time.time() * 1000)).bytes())
        self.front.broadcast(ModuleID.BlockSync, payload)

    # -- download worker ---------------------------------------------------
    def _maybe_download(self) -> None:
        if self._inflight:
            return
        current = self.ledger.current_number()
        with self._lock:
            ahead = [(p, n) for p, (n, _) in self._peers.items()
                     if n > current]
            floors = dict(self._pruned_floors)
        if not ahead:
            return
        peer, peer_number = max(ahead, key=lambda x: x[1])
        self._inflight = True
        try:
            if (self.snap_sync_threshold > 0
                    and peer_number - current > self.snap_sync_threshold):
                if self._try_snap_sync(peer):
                    return
                if self._downloader.stopping():
                    # the attempt may have aborted because stop() was
                    # requested — don't fall through and start a range
                    # download during shutdown
                    return
            lo = current + 1
            if lo < floors.get(peer, 0):
                # the peer already told us it pruned this range; its
                # snapshot (behind the snap-attempt backoff) is the only
                # way forward — don't re-send the doomed range request
                self._try_snap_sync(peer)
                return
            hi = min(peer_number, current + MAX_BLOCKS_PER_REQUEST)
            req = Writer().i64(lo).i64(hi).bytes()
            resp = self.front.request(ModuleID.BlockSync, peer, req,
                                      timeout=REQUEST_TIMEOUT)
            if resp is None:
                return
            r = Reader(resp)
            flag = r.u8()
            if flag == RESP_PRUNED:
                floor = r.i64()
                with self._lock:
                    self._pruned_floors[peer] = floor
                LOG.info(badge("SYNC", "peer-pruned-below", floor=floor,
                               requested=lo))
                # replay below the peer's floor is impossible: the ONLY way
                # forward is its snapshot
                self._try_snap_sync(peer)
                return
            blocks = r.seq(lambda rr: Block.decode(rr.blob()))
            self._apply_blocks(blocks)
        finally:
            self._inflight = False
            self.wakeup()

    def _try_snap_sync(self, peer: bytes) -> bool:
        now = time.monotonic()
        if now < self._next_snap_attempt:
            return False
        from ..snapshot.importer import snap_sync
        t0 = time.monotonic()
        # flip the mode BEFORE snap_sync: the install's storage commit
        # publishes the new height, and an observer gating on
        # current_number (chain_bench run_sync_bench) must never read the
        # stale "replay" mode after seeing the post-install height
        prev_mode = self.sync_mode
        self.sync_mode = "snap"
        self._reg.set_gauge("bcos_sync_mode", 1)
        res = snap_sync(self.front, peer, self.ledger.storage, self.suite,
                        self._verify_seals, self.ledger.current_number(),
                        request_timeout=REQUEST_TIMEOUT,
                        should_abort=self._downloader.stopping,
                        pre_install=None if self.scheduler is None else
                        lambda: self.scheduler.invalidate_caches(
                            self.ledger.current_number()),
                        registry=self._reg)
        if res is None:
            self.sync_mode = prev_mode
            self._reg.set_gauge("bcos_sync_mode",
                               1 if prev_mode == "snap" else 0)
            self._next_snap_attempt = now + SNAP_RETRY_SECONDS
            return False
        manifest, chunks = res
        if self.snapshot is not None:
            # become a server for the next joiner (pruned peers included)
            self.snapshot.adopt(manifest, chunks)
        if self.scheduler is not None:
            self.scheduler.external_commit(manifest.height)
        LOG.info(badge("SYNC", "snap-sync-installed", number=manifest.height,
                       chunks=manifest.chunk_count,
                       secs=round(time.monotonic() - t0, 2)))
        metric("sync.snap_installed", number=manifest.height)
        return True

    # -- verification + replay --------------------------------------------
    def _verify_seals(self, header: BlockHeader) -> bool:
        """Verify one block's commit-seal carriage — legacy 2f+1 multi-seal
        OR a quorum certificate (consensus/qc.py), both judged against the
        LOCAL ledger's sealer set (never the peer-supplied
        header.sealer_list — a malicious peer could fabricate that).
        Admission rules are shared with the range-wide batched pre-pass
        because both are the same `qc.verify_spans` call."""
        if not qc.verify_spans([header], self._sealer_set(), self.suite,
                               agg_registry=self.agg_registry)[0]:
            LOG.warning(badge("SYNC", "seal-quorum-failed",
                              number=header.number))
            return False
        return True

    def _sealer_set(self) -> list[bytes]:
        return sorted(n.node_id for n in self.ledger.consensus_nodes()
                      if n.node_type == "consensus_sealer")

    @staticmethod
    def _collect_seals(header: BlockHeader, sealer_set: list[bytes]
                       ) -> Optional[tuple[list[int], list[bytes]]]:
        """Legacy multi-seal admission (kept for callers/tests that judge
        structure without crypto) — now a thin wrapper over the shared
        rule set in consensus/qc.py."""
        quorum = 2 * ((len(sealer_set) - 1) // 3) + 1
        return qc.collect_legacy(header, sealer_set, quorum,
                                 check_sealer_list=True)

    def _batch_verify_seals(self, headers: list[BlockHeader]
                            ) -> tuple[dict[bytes, bool], list[bytes]]:
        """ONE `suite.verify_batch` across every header's commit seals (the
        PBFT drain-loop trick, engine._batch_checked) instead of a device
        round trip per block — a range response may mix legacy multi-seal
        blocks and certificate blocks (a chain that lived through a
        seal_mode rollout) and `qc.verify_spans` merges both forms into
        the same lane call. Returns ({header hash: quorum-ok}, the
        sealer set the batch was judged against). Verdicts are keyed by
        HEADER HASH, never height: a response may carry two different
        blocks at one height, and a by-number verdict would let a forged
        one ride a legit sibling's True. The replay loop falls back to
        the per-block `_verify_seals` for any header this pre-pass
        rejected or whenever a replayed block changes the on-chain
        sealer set."""
        sealer_set = self._sealer_set()
        ok = qc.verify_spans(headers, sealer_set, self.suite,
                             agg_registry=self.agg_registry)
        out = {h.hash(self.suite): bool(v) for h, v in zip(headers, ok)}
        return out, sealer_set

    def _apply_blocks(self, blocks: list[Block]) -> None:
        blocks = [b for b in blocks
                  if b.header.number > self.ledger.current_number()]
        blocks.sort(key=lambda b: b.header.number)
        if not blocks:
            return
        # replay needs the execution slot at committed+1; consensus may
        # hold a speculative chain built on rounds the cluster moved past
        # (we would not be downloading otherwise) — discard it first
        nxt = getattr(self.scheduler, "next_executable", None)
        abort = getattr(self.scheduler, "abort_speculation", None)
        if nxt is not None and abort is not None \
                and nxt() != self.ledger.current_number() + 1:
            abort()
        # coalesce seal verification for the whole response into one batch
        pre, batch_set = self._batch_verify_seals([b.header for b in blocks])
        # the port differs here: the fetched txs arrive decoded, without
        # senders, and the executor would recover each one alone
        # (Transaction.sender: one recover launch a tx on a "device"
        # suite, 16,384 for a 16,384-tx block); recover the response's
        # senders in one batch instead. The senders are the same.
        batch_recover_senders([t for b in blocks for t in b.transactions],
                              self.suite)
        for block in blocks:
            if block.header.number <= self.ledger.current_number():
                continue  # duplicate within the response: already committed
            if block.header.number != self.ledger.current_number() + 1:
                return  # gap: stop, the next request refetches from here
            # the sealer set is ledger state and may change at any replayed
            # height: the batched verdict only holds while the set still
            # matches the one the batch was judged against
            if self._sealer_set() == batch_set \
                    and pre.get(block.header.hash(self.suite)) is True:
                pass  # seals verified in the range-wide batch
            elif not self._verify_seals(block.header):
                return
            synced = block.header
            expect_hash = synced.hash(self.suite)
            replay = Block(transactions=block.transactions)
            replay.header.version = synced.version
            replay.header.consensus_weights = list(synced.consensus_weights)
            replay.header.number = synced.number
            replay.header.timestamp = synced.timestamp
            replay.header.sealer = synced.sealer
            replay.header.sealer_list = list(synced.sealer_list)
            replay.header.extra_data = synced.extra_data
            result = self.scheduler.execute_block(replay)
            if result is None:
                return
            if result.header.hash(self.suite) != expect_hash:
                LOG.error(badge("SYNC", "replay-hash-mismatch",
                                number=synced.number))
                self.scheduler.drop_executed(result.header)
                return
            result.header.signature_list = synced.signature_list
            if not self.scheduler.commit_block(result.header):
                return
            metric("sync.committed", number=synced.number)

    # -- serving + status ingest ------------------------------------------
    def _on_message(self, src: bytes, payload: bytes, respond) -> None:
        if respond is not None:  # range request: serve blocks
            r = Reader(payload)
            lo, hi = r.i64(), r.i64()
            floor = self.ledger.pruned_below()
            if lo < floor:
                # bodies below the floor are gone — answering with an empty
                # block list would leave the downloader retrying forever;
                # tell it to fail over to snap-sync instead
                respond(Writer().u8(RESP_PRUNED).i64(floor).bytes())
                return
            hi = min(hi, lo + MAX_BLOCKS_PER_REQUEST - 1,
                     self.ledger.current_number())
            out = []
            budget = MAX_RESPONSE_BYTES
            for n in range(lo, hi + 1):
                b = self.ledger.block_by_number(n, with_txs=True)
                if b is None:
                    break
                enc = b.encode()
                if out and len(enc) > budget:
                    break  # byte cap: client re-requests the rest
                budget -= len(enc)
                out.append(enc)
            w = Writer().u8(RESP_BLOCKS)
            respond(w.seq(out, lambda ww, e: ww.blob(e)).bytes())
            return
        r = Reader(payload)
        number = r.i64()
        if self.timesync is not None:
            try:
                r.blob()  # latest_hash
                self.timesync.update_peer_time(src, r.i64())
            except Exception:
                pass  # pre-timesync peers: status without a clock field
        with self._lock:
            self._peers[src] = (number, time.monotonic())
        if number > self.ledger.current_number():
            self._downloader.wakeup()

    def wakeup(self) -> None:  # downloads react to status pushes/completions
        super().wakeup()
        self._downloader.wakeup()

    def status(self) -> dict:
        with self._lock:
            peers = {p.hex()[:16]: n for p, (n, _) in self._peers.items()}
        return {"blockNumber": self.ledger.current_number(),
                "peers": peers,
                "syncMode": self.sync_mode,
                "prunedBelow": self.ledger.pruned_below()}
