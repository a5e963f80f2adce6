"""Node — the dependency-injection composition root.

Reference counterpart: FISCO-BCOS libinitializer/Initializer.cpp (:69
initAirNode, :125 init — ordering front -> storage -> ledger -> executor ->
scheduler -> txpool -> consensus -> start) and ProtocolInitializer.cpp:62-123
(CryptoSuite selection by chain.sm_crypto — the seam where the CUDA suite
drops in).

Shapes:
  * solo mode (consensus="solo"): single node, auto-seal-execute-commit.
  * pbft mode: the same Node, a PBFTEngine bound between sealer and
    scheduler, peers over an injected gateway (FakeGateway in-process).

The port's Node wires the planes the port has: the ledger on the storage
`make_storage` selects (memory, WAL, the disk engine, key pages), the
txpool and its ingest lane, the executor, the in-process Scheduler, the
out-of-process execution workers ([scheduler] workers, scheduler/
workers.py), the sealer, front, tx gossip, block sync with snap sync,
snapshots (checkpoint, prune, serve), PBFT, health, overload, the peer
clock, AMOP,
the light-node server (given a gateway: an in-process FakeGateway or a
net.p2p.P2PGateway over TCP, with SM-TLS on the SM chain), the ZK proof
plane, and the serving edge: JSON-RPC over HTTP and WS with
the query cache, subscriptions and per-client admission, the Prometheus
endpoint, tracing and the sampling profiler. Its suite runs on `device`
("cuda" unless a caller asks for "cpu"). Multi-group hosting composes
several Nodes over one shared crypto lane (init/group.py), and the
process daemon (init/daemon.py) runs a node directory as an OS process.
A config that selects a plane the port does not have yet raises
NotImplementedError naming its ROADMAP.md item, rather than running
without it (`_check_ported`; no field does today).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

from ..crypto.suite import CryptoSuite, make_suite
from ..executor.executor import TransactionExecutor
from ..ledger.ledger import ConsensusNode, Ledger
from ..protocol import Block
from ..scheduler.scheduler import Scheduler
from ..sealer.sealer import Sealer
from ..txpool.ingest import IngestLane
from ..txpool.txpool import TxPool
from ..utils.log import LOG, badge
from ..consensus import qc
from ..consensus.pbft.engine import PBFTEngine
from ..crypto import agg
from ..net.front import FrontService
from ..net.gateway import Gateway
from ..net.txsync import TransactionSync
from ..sync.sync import BlockSync


@dataclasses.dataclass
class NodeConfig:
    """Subset of the reference's config.ini surface (NodeConfig.cpp)."""

    chain_id: str = "chain0"
    group_id: str = "group0"
    sm_crypto: bool = False
    storage_path: Optional[str] = None  # None = in-memory
    # persistent backend selection (storage/__init__.py make_storage):
    # auto = wal when a path is configured, memory otherwise (historical
    # behavior); disk = the log-structured engine (storage/engine.py —
    # memtable + sorted segments + manifest, restart flat in chain length,
    # datasets beyond RAM). memory/wal force those backends.
    storage_backend: str = "auto"  # auto | memory | wal | disk
    storage_memtable_mb: int = 64  # disk engine: flush watermark
    storage_compact_segments: int = 8  # disk engine: L0 merge trigger
    # leveled compaction geometry (storage/engine.py): L1 byte target and
    # the per-level growth factor; merges stay O(level slice) regardless
    # of dataset size, so these bound single-merge latency at GB scale
    storage_level_base_mb: int = 16
    storage_level_fanout: int = 8
    # KeyPageStorage wrap (page-packed rows, the reference's
    # storage.key_page_size — NodeConfig.cpp:620): > 0 explicit page
    # bytes, 0 off, -1 = auto (ON at the default page size for the disk
    # backend, where wide tables dominate; off for wal/memory)
    storage_key_page_size: int = -1
    tx_count_limit: int = 1000
    txpool_limit: int = 15000
    block_limit_range: int = 600
    # txpool watermark admission (txpool/txpool.py): fractions of
    # txpool_limit. Below low everything admits; between them band-0 txs
    # must carry deadline slack; at high, admission is by priority
    # EVICTION of the lowest-band/soonest-expiring pending tx
    txpool_low_watermark: float = 0.7
    txpool_high_watermark: float = 0.95
    # honor the tx attribute's client-declared priority band in eviction
    # order. Cooperative QoS for identified consortium clients; disable
    # on edges serving unidentified traffic (the band is unauthenticated)
    txpool_priority_bands: bool = True
    # overload-control plane ([overload] ini — utils/overload.py): the
    # busy/brownout controller
    overload_enabled: bool = True
    overload_enter: float = 0.85   # smoothed score entering busy
    overload_exit: float = 0.5     # smoothed score leaving busy
    overload_hold_s: float = 0.5   # hysteresis hold on both edges
    overload_commit_backlog: int = 6  # commit depth scoring 1.0
    overload_busy_write_factor: float = 0.25  # write-rate shrink while busy
    # compaction-debt backpressure: debt bytes (engine levels over target)
    # scoring 1.0 on the overload plane — a compaction-starved node goes
    # busy and sheds writes instead of silently drowning in L0 segments
    overload_compact_debt_mb: int = 256
    # the serving edge's per-client token buckets (rpc/admission.py).
    # Rates are per client, tokens/sec; 0 = that class unlimited
    # (fair-share concurrency still applies)
    client_write_rate: float = 0.0
    client_write_burst: float = 0.0  # 0 -> 2x rate
    client_read_rate: float = 0.0
    client_read_burst: float = 0.0
    # continuous-batching ingest lane (txpool/ingest.py): coalesces
    # concurrent RPC/gossip submissions into device-sized submit_batch
    # calls. ingest_lane=False restores direct per-call submission (the
    # per-request baseline, kept for benchmarking and odd embeddings).
    ingest_lane: bool = True
    ingest_max_batch: int = 4096
    ingest_max_wait_ms: float = 15.0
    ingest_queue_cap: int = 8192
    min_seal_time: float = 0.05
    # busy-pipeline fill ceiling: while a block is executing/committing the
    # sealer keeps filling the next proposal up to this long (bigger DAG
    # waves, fewer consensus rounds per tx); an idle pipeline still seals
    # at min_seal_time. Clamped to >= min_seal_time.
    max_seal_time: float = 0.5
    # pipelined block production ([scheduler] pipeline): commit runs on a
    # dedicated scheduler thread with strict height ordering, and height
    # N+1 executes speculatively over N's uncommitted changeset (stacked
    # state view; state_root stays per-changeset). False restores the
    # serial execute-then-commit path (comparison benches, odd embeddings).
    pipeline_commit: bool = True
    # out-of-process execution workers ([scheduler] workers): N spawned
    # worker interpreters run the execute stage behind the Scheduler seam
    # (scheduler/workers.py) so block execution stops taxing this
    # process's GIL. 0 = in-process execute (the default). The pool is a
    # pure offload: a dead/slow worker falls back in-process and the
    # health plane respawns it.
    scheduler_workers: int = 0
    consensus: str = "solo"  # solo | pbft
    crypto_backend: str = "auto"  # device | host | auto
    # the port's own knob: where the suite's tensor path runs ("cuda", the
    # card; "cpu" runs the kernels' plain versions, as the CPU tests do)
    device: str = "cuda"
    device_min_batch: int = 512
    # shard device crypto batches over up to N local chips (0 = off);
    # the ICI analogue of txpool.verify_worker_num (NodeConfig.cpp:486)
    crypto_mesh_devices: int = 0
    leader_period: int = 1  # consensus_leader_period (NodeConfig.cpp:568)
    # genesis feature-gate version (GenesisConfig.h:68); governance can
    # raise it on-chain later (SystemConfig precompile), never lower it
    compatibility_version: str = "1.1.0"
    view_timeout: float = 3.0
    # proposal pipeline depth (PBFTConfig.cpp:189-215 water size): consensus
    # runs this many heights ahead of the committed block while execution
    # stays strictly ordered
    waterline: int = 8
    # commit-seal carriage this node MINTS at checkpoint quorum
    # (consensus/qc.py): multi = legacy loose 2f+1 seals, cert = one
    # bitmap+ECDSA certificate, aggregate = one bitmap+BLS point.
    # Verification accepts every form regardless, so mixed-mode clusters
    # and legacy-chain replay keep working during a rollout
    seal_mode: str = "multi"  # multi | cert | aggregate
    # PoP-checked BLS key roster (crypto/agg.py AggKeyRegistry) — required
    # to mint OR accept aggregate certificates; distributed like the
    # sealer list itself (not an ini knob: tests/tooling inject it)
    agg_registry: object = None
    # snapshot/checkpoint subsystem (snapshot/): every
    # `snapshot_interval` committed blocks export a chunked Merkle-committed
    # state snapshot; keep `snapshot_retention` of them; when
    # `snapshot_prune` is on, drop block bodies below the checkpoint (keep
    # headers) and compact the WAL. A joining node more than
    # `snap_sync_threshold` blocks behind fetches a snapshot instead of
    # replaying the chain (0 disables the preference; pruned-below answers
    # still force it).
    snapshot_interval: int = 0  # blocks between checkpoints; 0 = disabled
    snapshot_retention: int = 2
    snapshot_prune: bool = False
    # replayable blocks kept above the prune floor, so a peer lagging by a
    # few blocks catches up via tail replay instead of a full snap-sync
    snapshot_keep_tail: int = 64
    snap_sync_threshold: int = 256
    snapshot_chunk_bytes: int = 1 << 20
    # multi-group hosting (init/group.py + the daemon's [groups] wiring):
    # group ids this PROCESS runs — G independent ledger/txpool/consensus/
    # scheduler stacks behind one RPC edge, one gateway, one shared
    # crypto lane, storage namespaced per group over one WAL. Empty =
    # single-group node (this config's group_id only).
    groups: list = dataclasses.field(default_factory=list)
    # shared crypto-plane lane (crypto/lane.py): merge all groups'
    # verify/recover/hash batches into single device calls. Only engaged
    # by multi-group composition; wait_ms > 0 adds a coalescing
    # micro-window for device deployments (0 = merge in-flight only).
    crypto_lane: bool = True
    crypto_lane_wait_ms: float = 0.0
    # tracing plane ([trace] ini, utils/otrace.py): sample_rate samples
    # NEW root traces (an incoming sampled traceparent is always honored);
    # ring_size bounds the in-process span ring served by getTrace and
    # /trace; spans slower than slow_ms are ALWAYS retained (never
    # sampled out) in a separate slow ring + logged. sample_rate=0 with
    # slow_ms=0 turns the whole plane into one branch on the hot path.
    trace_sample_rate: float = 0.02
    trace_ring_size: int = 4096
    trace_slow_ms: float = 1000.0
    # continuous profiling plane ([profile] ini, analysis/profiler.py):
    # hz samples every thread's stack + per-thread CPU at a LOW rate
    # always-on (folded stacks served via GET /profile); ring bounds the
    # retained distinct stacks; a [TRACE][slow-span] firing captures a
    # burst_s burst at burst_hz linked to the trace id (getTrace returns
    # it). hz=0 disarms the whole plane: no sampler thread.
    profile_hz: float = 5.0
    profile_ring: int = 2048
    profile_burst_hz: float = 97.0
    profile_burst_s: float = 1.0
    rpc_port: Optional[int] = None  # None = no RPC server; 0 = ephemeral
    rpc_host: str = "127.0.0.1"
    # serving read plane (rpc/edge.py + rpc/cache.py): one bounded worker
    # pool shared by the HTTP event-loop edge and the WS server; a
    # commit-coherent LRU serving rendered block/tx/receipt JSON
    rpc_workers: int = 8        # blocking-call offload threads
    rpc_max_batch: int = 256    # JSON-RPC 2.0 batch entry cap
    rpc_cache_entries: int = 4096  # 0 disables the query cache
    rpc_cache_mb: int = 64      # approximate rendered-bytes bound
    rpc_keepalive_s: float = 60.0  # idle keep-alive connection reap
    # push-based subscription plane (rpc/eventsub.SubHub): distinct WS
    # sessions allowed to hold subscriptions, and the per-session push
    # outbox byte bound (beyond it, droppable frames evict oldest-first
    # and a lossless overflow kills the session)
    sub_max_sessions: int = 16384
    sub_outbox_kb: int = 1024
    ws_port: Optional[int] = None  # None = no WS server; 0 = ephemeral
    metrics_port: Optional[int] = None  # None = no Prometheus endpoint
    # p2p transport (the reference's [p2p] listen_ip/listen_port +
    # nodes.json connected_nodes): consumed by the process-level daemon
    # (init/daemon.py), which builds a P2PGateway from these; in-process
    # embeddings keep injecting a gateway directly
    p2p_host: str = "127.0.0.1"
    p2p_port: Optional[int] = None  # None = no p2p listener configured
    p2p_peers: list = dataclasses.field(default_factory=list)  # (host, port)
    # ZK proof plane (zk/proof.py): persist per-block state-leaf digest
    # indexes (changeset-inclusion proofs via getProof) and render every
    # committed tx's proof bundle into the query cache at commit.
    # Poseidon hashing itself is always available via suite.poseidon_batch
    # regardless of this knob.
    zk_proofs: bool = True
    # deterministic fault injection ([failpoints] spec, utils/failpoints.py):
    # `site=action;site2=action` armed at node construction — test/chaos
    # deployments only; empty (the default) arms nothing
    failpoints: str = ""


def _check_ported(cfg: NodeConfig) -> None:
    """Raise for every config field that selects a plane the port does
    not have yet, naming its ROADMAP.md item (the JAX package's Node
    builds these; the port must not silently run without them)."""
    unported: list[str] = []
    if unported:
        raise NotImplementedError(
            "the port's Node does not have these planes yet (ROADMAP.md): "
            + "; ".join(unported))


class Node:
    def __init__(self, config: NodeConfig | None = None,
                 keypair=None, suite: CryptoSuite | None = None,
                 gateway: Optional[Gateway] = None, storage=None):
        self.config = config or NodeConfig()
        cfg = self.config
        _check_ported(cfg)
        self.suite = suite or make_suite(
            cfg.sm_crypto, backend=cfg.crypto_backend, device=cfg.device,
            device_min_batch=cfg.device_min_batch,
            mesh_devices=cfg.crypto_mesh_devices)
        self.keypair = keypair or self.suite.generate_keypair()
        # per-group metrics view: every bcos_* series this node's
        # subsystems emit carries a group label ALONGSIDE the unlabeled
        # totals, so G in-process stacks stay tellable apart
        from ..utils.metrics import for_group
        self.metrics_view = for_group(cfg.group_id)
        # health plane (utils/health.py): every subsystem's failure signal
        # lands here; degraded/failed drives sealing stop + write shedding
        from ..utils.health import Health
        self.health = Health(registry=self.metrics_view,
                             label=cfg.group_id)
        self.health.on_change.append(self._on_health_change)
        if cfg.failpoints:
            from ..utils import failpoints as _fp
            _fp.arm_spec(cfg.failpoints)
        # tracing plane: the process tracer adopts this node's [trace]
        # knobs (one node per process in deployments; in-process clusters
        # share the tracer and are told apart by the per-node trace label
        # stamped on spans)
        from ..utils import otrace
        otrace.configure(sample_rate=cfg.trace_sample_rate,
                         ring_size=cfg.trace_ring_size,
                         slow_ms=cfg.trace_slow_ms)
        self.trace_label = self.keypair.pub_bytes[:4].hex()
        # continuous profiling plane: process-wide like the tracer; armed
        # at a low always-on hz by default, disarmed entirely at hz=0
        from ..analysis import profiler as _profiler
        _profiler.configure(hz=cfg.profile_hz, ring=cfg.profile_ring,
                            burst_hz=cfg.profile_burst_hz,
                            burst_s=cfg.profile_burst_s)
        # storage injection seam — the reference's StorageInitializer picks
        # RocksDB vs TiKV (libinitializer/Initializer.cpp:145-261); callers
        # pass e.g. a carried JAX chain (storage/carry.storage_from_jax),
        # the multi-group manager a per-group NamespacedStorage
        from ..storage import make_storage
        self.storage = storage if storage is not None else make_storage(
            cfg.storage_backend, cfg.storage_path,
            memtable_mb=cfg.storage_memtable_mb,
            compact_segments=cfg.storage_compact_segments,
            key_page_size=cfg.storage_key_page_size,
            level_base_mb=cfg.storage_level_base_mb,
            level_fanout=cfg.storage_level_fanout,
            registry=self.metrics_view, health=self.health)
        # injected storage (test fixtures): adopt its ENOSPC/flush health
        # seam if the backend has one and nobody claimed it (multi-group
        # shared bases get a fanout in group.py)
        from ..storage.wal import _SpaceHealth
        if isinstance(self.storage, _SpaceHealth) \
                and self.storage.health is None:
            self.storage.health = self.health
        # multi-group composition (init/group.py) sets this to the
        # GroupManager so RPC group methods enumerate the real registry
        self.group_registry = None
        self.ledger = Ledger(self.storage, self.suite)
        self.txpool = TxPool(self.suite, self.ledger, cfg.chain_id,
                             cfg.group_id, cfg.txpool_limit,
                             cfg.block_limit_range,
                             registry=self.metrics_view,
                             low_watermark=cfg.txpool_low_watermark,
                             high_watermark=cfg.txpool_high_watermark,
                             priority_bands=cfg.txpool_priority_bands)
        self.ingest = IngestLane(
            self.txpool, max_batch=cfg.ingest_max_batch,
            max_wait_ms=cfg.ingest_max_wait_ms,
            queue_cap=cfg.ingest_queue_cap,
            registry=self.metrics_view,
            trace_label=self.trace_label) if cfg.ingest_lane else None
        # overload controller (utils/overload.py): one busy/brownout state
        # from the commit backlog, ingest queue and pool occupancy; wired
        # into the health plane's `busy` step and the gossip import gate
        self.overload = None
        if cfg.overload_enabled:
            from ..utils.overload import OverloadController
            self.overload = OverloadController(
                health=self.health, registry=self.metrics_view,
                label=cfg.group_id, enter=cfg.overload_enter,
                exit=cfg.overload_exit, hold_s=cfg.overload_hold_s,
                busy_write_factor=cfg.overload_busy_write_factor)
            backlog_norm = max(1, cfg.overload_commit_backlog)
            self.overload.add_signal(
                "txpool", self.txpool.occupancy_fraction)
            if self.ingest is not None:
                self.overload.add_signal("ingest",
                                         self.ingest.queue_fraction)
            # compaction-debt backpressure: saturation 1.0 when
            # the disk engine's un-merged debt reaches the configured cap.
            # Feature-detected so wal/memory (and injected test) backends
            # simply contribute nothing.
            debt_fn = getattr(self.storage, "compaction_debt_bytes", None)
            if debt_fn is not None:
                debt_norm = max(1, cfg.overload_compact_debt_mb) << 20
                self.overload.add_signal(
                    "compaction_debt",
                    lambda: debt_fn() / debt_norm)
        self.executor = TransactionExecutor(self.suite)
        self.scheduler = Scheduler(self.storage, self.ledger, self.executor,
                                   self.suite, self.txpool,
                                   pipeline=cfg.pipeline_commit,
                                   trace_label=self.trace_label,
                                   health=self.health,
                                   state_index=cfg.zk_proofs)
        # out-of-process execution workers ([scheduler] workers > 0):
        # the execute stage runs in spawned worker interpreters with
        # their own GILs and host suites on the CPU; roots/prewrite/2PC
        # stay here, on this node's suite (see scheduler/workers.py).
        # Started lazily in start() — spawning processes from a ctor
        # complicates embedders that only build nodes to inspect them.
        self.exec_pool = None
        if cfg.scheduler_workers > 0:
            from ..scheduler.workers import ExecPool
            self.exec_pool = ExecPool(sm_crypto=cfg.sm_crypto,
                                      workers=cfg.scheduler_workers,
                                      health=self.health,
                                      registry=self.metrics_view)
            self.scheduler.attach_exec_pool(self.exec_pool)
        # ZK proof plane bookkeeping (zk/proof.py): commit-time render
        # counts, proof cache hit rate, batched-verify volume — behind
        # bcos_zk_* and the getSystemStatus "zk" section
        from ..zk.proof import ZkPlane
        self.zk = ZkPlane(self)
        if self.overload is not None:
            self.overload.add_signal(
                "commit_backlog",
                lambda: self.scheduler.commit_backlog() / backlog_norm)
        from ..tool.timesync import NodeTimeMaintenance
        self.timesync = NodeTimeMaintenance()
        # solo mode commits synchronously inside the proposal callback, so
        # busy-aware filling would only see its own in-flight proposal
        busy = (self.scheduler.pipeline_busy
                if cfg.pipeline_commit and cfg.consensus != "solo" else None)
        self.sealer = Sealer(self.txpool, self.suite, self._on_proposal,
                             cfg.tx_count_limit, cfg.min_seal_time,
                             clock_ms=self.timesync.aligned_time_ms,
                             max_seal_time=cfg.max_seal_time,
                             pipeline_busy=busy,
                             trace_label=self.trace_label,
                             gate=self.health.sealing_allowed,
                             current_height=self.ledger.current_number)
        self._commit_lock = threading.Lock()
        self.consensus = None  # bound by PBFT wiring in start()
        self.front: Optional[FrontService] = None
        self.txsync: Optional[TransactionSync] = None
        self.blocksync: Optional[BlockSync] = None
        self.amop = None
        self.lightnode_server = None
        if gateway is not None:
            self.front = FrontService(self.keypair.pub_bytes, gateway)
            self.txsync = TransactionSync(self.front, self.txpool,
                                          self.suite, ingest=self.ingest,
                                          import_gate=self.accepting_remote_txs,
                                          registry=self.metrics_view)
        # snapshot/checkpoint service: always constructed (status() +
        # operator checkpoint() work on any node); its periodic worker only
        # runs when snapshot_interval > 0, and it serves SnapshotSync
        # whenever there is a front
        import os as _os
        from ..snapshot.service import SnapshotService
        self.snapshot = SnapshotService(
            self.storage, self.ledger, self.suite, front=self.front,
            interval=cfg.snapshot_interval, retention=cfg.snapshot_retention,
            chunk_bytes=cfg.snapshot_chunk_bytes, prune=cfg.snapshot_prune,
            keep_tail=cfg.snapshot_keep_tail,
            keep_nonces=cfg.block_limit_range,
            store_dir=_os.path.join(cfg.storage_path, "snapshots")
            if cfg.storage_path else None, registry=self.metrics_view)
        if self.front is not None:
            self.blocksync = BlockSync(
                self.front, self.ledger, self.scheduler, self.suite,
                timesync=self.timesync, snapshot=self.snapshot,
                snap_sync_threshold=cfg.snap_sync_threshold,
                registry=self.metrics_view, agg_registry=cfg.agg_registry)
            from ..net.amop import AMOPService
            self.amop = AMOPService(self.front)
            from ..lightnode import LightNodeServer
            self.lightnode_server = LightNodeServer(self)
        from ..rpc.eventsub import EventSub
        self.eventsub = EventSub(self.ledger, self.scheduler)
        self.rpc = None
        self.ws = None
        self.query_cache = None
        self.subhub = None
        self.rpc_pool = None
        self.admission = None
        if cfg.rpc_port is not None or cfg.ws_port is not None:
            from ..rpc.edge import WorkerPool
            from ..rpc.server import JsonRpcServer
            self.rpc_pool = WorkerPool(cfg.rpc_workers)
            # per-client edge admission (rpc/admission.py): token buckets
            # (reads and writes budgeted separately; 0 = unlimited) +
            # fair-share concurrency over the bounded worker pool, with
            # write rates shrunk by the overload controller while busy
            from ..rpc.admission import ClientAdmission
            self.admission = ClientAdmission(
                write_rate=cfg.client_write_rate,
                write_burst=cfg.client_write_burst,
                read_rate=cfg.client_read_rate,
                read_burst=cfg.client_read_burst,
                fair_capacity=cfg.rpc_workers * 8,
                overload=self.overload, registry=self.metrics_view)
            impl = self.make_rpc_impl()
            if cfg.rpc_port is not None:
                # the RPC edge doubles as the ops surface: GET /metrics,
                # /status, /trace served from the same event loop
                from ..rpc.ops import OpsRoutes
                self.rpc = JsonRpcServer(impl, host=cfg.rpc_host,
                                         port=cfg.rpc_port,
                                         pool=self.rpc_pool,
                                         keepalive_s=cfg.rpc_keepalive_s,
                                         ops=OpsRoutes(
                                             status_fn=self.system_status,
                                             health_fn=self.health.snapshot),
                                         admission=self.admission)
            if cfg.ws_port is not None:
                from ..rpc.ws_server import WsRpcServer
                self.ws = WsRpcServer(impl, host=cfg.rpc_host,
                                      port=cfg.ws_port, pool=self.rpc_pool,
                                      admission=self.admission,
                                      subhub=self.subhub,
                                      outbox_kb=cfg.sub_outbox_kb)
        self.metrics = None
        if cfg.metrics_port is not None:
            from ..utils.metrics import MetricsServer
            self.metrics = MetricsServer(host=cfg.rpc_host,
                                         port=cfg.metrics_port,
                                         status_fn=self.system_status,
                                         health_fn=self.health.snapshot)
        self._started = False

    def _on_health_change(self, old: str, new: str) -> None:
        """Health transitions drive the degradation policy: the sealer's
        gate and the write shed read health state directly; this observer
        adds the operator-facing record and wakes the sealer so a recovery
        resumes proposals immediately instead of at the next idle tick."""
        LOG.warning(badge("NODE", "health-transition", old=old, new=new,
                          group=self.config.group_id,
                          faults=",".join(
                              self.health.snapshot()["faults"]) or "-"))
        if new == "ok":
            self.sealer.wakeup()

    def accepting_remote_txs(self) -> bool:
        """Gossip import gate (net/txsync.py): False while this node is
        busy (overload brownout) or degraded — a saturated follower must
        not amplify load it cannot seal; the anti-entropy sweep re-delivers
        once it recovers. Consensus fetch-missing is never gated."""
        if self.health.writes_shed():
            return False
        return self.overload is None or self.overload.accepting_remote_txs()

    # -- RPC impl wiring ---------------------------------------------------
    def make_rpc_impl(self):
        """-> JsonRpcImpl bound to this node with the commit-coherent
        query cache wired (created on first call when rpc_cache_entries >
        0): hot responses pre-rendered at commit off the consensus path,
        wiped on rollback and snap-sync install (a stale cache would
        serve pre-wipe blocks after a snapshot jumped the head). The ONE
        place this wiring lives — the node's own RPC/WS servers and the
        multi-group edge (init/group.py) both call it."""
        from ..rpc.server import JsonRpcImpl

        cfg = self.config
        if self.query_cache is None and cfg.rpc_cache_entries > 0:
            from ..rpc.cache import QueryCache
            self.query_cache = QueryCache(
                max_entries=cfg.rpc_cache_entries,
                max_bytes=cfg.rpc_cache_mb << 20,
                registry=self.metrics_view)
            impl = JsonRpcImpl(self)  # reads query_cache: order matters
            self.scheduler.on_commit.append(impl.prime_block)
            self.scheduler.on_invalidate.append(self.query_cache.invalidate)
        else:
            impl = JsonRpcImpl(self)
        if self.subhub is None:
            # push-based subscription fan-out, bound to the FIRST impl
            # (the one whose prime_block runs): on_commit is appended
            # AFTER prime_block so the fan-out worker always finds the
            # block's fragments already rendered in the query cache
            from ..rpc.eventsub import SubHub
            self.subhub = SubHub(self, impl,
                                 max_sessions=cfg.sub_max_sessions,
                                 registry=self.metrics_view)
            self.scheduler.on_commit.append(self.subhub.on_commit)
            self.scheduler.on_invalidate.append(self.subhub.on_invalidate)
            self.txpool.register_broadcast_hook(self.subhub.on_pending)
        return impl

    # -- aggregated operational state (getSystemStatus RPC + /status) ------
    def system_status(self) -> dict:
        """One group-labeled JSON document collecting what used to be
        scattered across RPC methods, logs and bench hooks: pipeline
        occupancy, ingest/storage/cache stats, sync mode, txpool depth,
        the tracer and the profiler. Every value is a cheap snapshot
        read — safe to poll."""
        from ..analysis import profiler as _prof
        from ..utils import otrace
        cfg = self.config
        bs = self.blocksync
        lane = getattr(self.suite, "_lane", None)  # LaneSuite seam
        storage_stats = getattr(self.storage, "stats", None)
        reg = self.group_registry
        return {
            "group": cfg.group_id,
            "chain": cfg.chain_id,
            "node": self.keypair.pub_bytes.hex(),
            "health": self.health.snapshot(),
            "blockNumber": self.ledger.current_number(),
            "syncMode": bs.sync_mode if bs is not None else "replay",
            "txpool": {**self.txpool.status(),
                       "unsealed": self.txpool.pending_count()},
            "ingest": self.ingest.stats() if self.ingest else None,
            "pipeline": self.scheduler.pipeline_stats(),
            "execWorkers": self.exec_pool.stats()
            if self.exec_pool is not None else None,
            "storage": storage_stats() if callable(storage_stats)
            else {"backend": type(self.storage).__name__},
            "cache": self.query_cache.stats() if self.query_cache else None,
            "snapshot": self.snapshot.status(),
            "consensus": self.consensus.status()
            if self.consensus is not None else None,
            "cryptoLane": lane.stats() if lane is not None else None,
            "zk": self.zk.stats(),
            "groups": reg.groups() if reg is not None else [cfg.group_id],
            "trace": otrace.TRACER.stats(),
            "profile": _prof.PROFILER.stats(),
            "overload": self.overload.stats()
            if self.overload is not None else None,
            "admission": self.admission.stats()
            if self.admission is not None else None,
            "subscriptions": self._subscriptions_status(),
        }

    def _subscriptions_status(self) -> Optional[dict]:
        if self.subhub is None:
            return None
        out = self.subhub.stats()
        if self.ws is not None:
            out["outboxDrops"] = self.ws.push_drop_stats()
        return out

    # -- genesis -----------------------------------------------------------
    def build_genesis(self, sealers: Optional[list[ConsensusNode]] = None) -> None:
        sealers = sealers or [ConsensusNode(self.keypair.pub_bytes)]
        self.ledger.build_genesis(
            sealers, tx_count_limit=self.config.tx_count_limit,
            compatibility_version=self.config.compatibility_version)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        if self._started:
            return
        if self.ledger.current_number() < 0:
            self.build_genesis()
        self._started = True
        if self.exec_pool is not None:
            self.exec_pool.start()
        if self.config.consensus == "solo":
            self.sealer.set_should_seal(True, self.ledger.current_number() + 1)
            # commits landing OUTSIDE the proposal path (the health
            # plane's retry probe re-driving a stalled height) must still
            # roll the solo grant forward, or the sealer would keep
            # proposing the already-committed height forever. Membership-
            # guarded: a stop()/start() cycle must not stack duplicates.
            if self._solo_regrant not in self.scheduler.on_commit:
                self.scheduler.on_commit.append(self._solo_regrant)
            self.sealer.start()
        elif self.config.consensus == "pbft":
            if self.front is None:
                raise RuntimeError("pbft consensus requires a gateway")
            sealers = {n.node_id
                       for n in self.ledger.ledger_config().consensus_nodes}
            if self.keypair.pub_bytes in sealers:
                self._start_engine()
            else:
                # observer today, maybe a sealer tomorrow: live governance
                # (addSealer) must promote a RUNNING node without restart —
                # peers raise their quorum to count us the moment the
                # membership block commits, so we must start voting then
                self.scheduler.on_commit.append(self._maybe_promote)
            # observers (not in the sealer set) follow via block sync
            if self.blocksync is not None:
                self.blocksync.start()
        if self.config.snapshot_interval > 0:
            self.snapshot.start()  # periodic checkpoint + prune worker
        if self.ingest is not None:
            self.ingest.start()  # continuous-batching front door
        if self.overload is not None:
            self.overload.start()  # busy/brownout sampler
        if self.txsync is not None:
            self.txsync.start()  # periodic pool anti-entropy sweep
        if self.rpc_pool is not None:
            self.rpc_pool.start()  # before the edges: they offload into it
        if self.rpc is not None:
            self.rpc.start()
        if self.ws is not None:
            self.ws.start()
        if self.metrics is not None:
            self.metrics.start()
        LOG.info(badge("NODE", "started",
                       number=self.ledger.current_number(),
                       mode=self.config.consensus))

    def _start_engine(self) -> None:
        if self.consensus is None:
            self.consensus = PBFTEngine(
                self.suite, self.keypair, self.front, self.txpool,
                self.sealer, self.scheduler, self.ledger,
                leader_period=self.config.leader_period,
                view_timeout=self.config.view_timeout,
                txsync=self.txsync,
                clock_ms=self.timesync.aligned_time_ms,
                waterline=self.config.waterline,
                seal_mode=self.config.seal_mode,
                agg_registry=self.config.agg_registry)
        self.consensus.start()
        self.sealer.start()

    def _solo_regrant(self, number: int) -> None:
        """Solo-mode commit observer: retire grants at or below the
        committed height and arm the next one (idempotent with the
        proposal path's own revoke/grant)."""
        try:
            cfg = self.ledger.ledger_config()
            self.sealer.revoke(number)
            self.sealer.set_should_seal(True, number + 1,
                                        max_txs=cfg.block_tx_count_limit)
        except Exception:  # noqa: BLE001 — observer must not kill notify
            LOG.exception(badge("NODE", "solo-regrant-failed"))

    def _maybe_promote(self, _number: int) -> None:
        """Observer -> sealer promotion at the commit that enacts it."""
        if self.consensus is not None or not self._started:
            return
        with self._commit_lock:
            if self.consensus is not None:
                return
            sealers = {n.node_id
                       for n in self.ledger.ledger_config().consensus_nodes}
            if self.keypair.pub_bytes not in sealers:
                return
            LOG.info(badge("NODE", "promoted-to-sealer"))
            self._start_engine()

    def stop(self) -> None:
        if self.metrics is not None:
            self.metrics.stop()
        if self.rpc is not None:
            self.rpc.stop()
        if self.ws is not None:
            self.ws.stop()
        if self.subhub is not None:
            self.subhub.stop()  # after the WS edge: no new fan-outs
        if self.rpc_pool is not None:
            self.rpc_pool.stop()  # after the edges: no new submitters
        if self.ingest is not None:
            self.ingest.stop()  # after RPC: no new submitters, drain queue
        if self.overload is not None:
            self.overload.stop()
        self.snapshot.stop()
        self.sealer.stop()
        if self.consensus is not None:
            self.consensus.stop()
        if self.txsync is not None:
            self.txsync.stop()
        if self.blocksync is not None:
            self.blocksync.stop()
        if self.front is not None:
            self.front.stop()
        self.scheduler.shutdown()
        if self.exec_pool is not None:
            self.exec_pool.stop()
        self.health.stop()
        self._started = False

    # -- solo-consensus proposal path --------------------------------------
    def _on_proposal(self, block: Block) -> bool:
        if self.config.consensus != "solo":
            return self.consensus.submit_proposal(block)
        with self._commit_lock:
            cfg = self.ledger.ledger_config()
            block.header.sealer_list = [n.node_id for n in cfg.consensus_nodes]
            result = self.scheduler.execute_block(block)
            if result is None:
                return False
            # solo: self-sign the header as its own commit seal, carried
            # in whatever form seal_mode dictates (the solo chain must
            # exercise the same certificate plane replicas will judge)
            hh = result.header.hash(self.suite)
            n_sealers = len(result.header.sealer_list)
            if self.config.seal_mode == "cert":
                qc.attach(result.header, qc.mint_cert(
                    [(0, self.suite.sign(self.keypair, hh))], n_sealers))
            elif self.config.seal_mode == "aggregate":
                secret = agg.derive_secret(
                    self.keypair.secret.to_bytes(32, "big"))
                qc.attach(result.header, qc.mint_aggregate(
                    [0], agg.sign(secret, hh), n_sealers))
            else:
                result.header.signature_list = [
                    (0, self.suite.sign(self.keypair, hh))]
            try:
                ok = self.scheduler.commit_block(result.header)
            except Exception as exc:  # noqa: BLE001 — deliberate catch
                # an exception ESCAPING commit_block used to blow through
                # the sealer worker with the proposal's txs still marked
                # sealed and the grant consumed — a silently wedged solo
                # chain. Trip the health plane (degraded + retry probe)
                # and take the refused-proposal path so the txs return to
                # the pool.
                LOG.critical(badge("NODE", "solo-commit-exception",
                                   number=result.header.number,
                                   error=repr(exc)))
                self.scheduler.report_commit_fault(exc)
                ok = False
            if ok:
                # prune consumed-round markers (bounded memory; PBFT's
                # engine does this in _try_commit_ledger)
                self.sealer.revoke(self.ledger.current_number())
                self.sealer.set_should_seal(
                    True, self.ledger.current_number() + 1,
                    max_txs=cfg.block_tx_count_limit)
            return ok

    # -- client surface (pre-RPC, in-process) ------------------------------
    def send_transaction(self, tx) -> "object":
        """-> TxSubmitResult, ALWAYS (the lightnode wire path and other
        in-process embeddings encode res.status — lane conditions map to
        statuses, they must not escape as exceptions)."""
        if self.health.writes_shed():
            # degraded/failed: shed the write with the TYPED status (reads
            # keep serving). Clients fail fast and route elsewhere instead
            # of feeding a pipeline that cannot commit.
            from ..protocol import TransactionStatus
            from ..txpool.txpool import TxSubmitResult
            return TxSubmitResult(tx.hash(self.suite),
                                  TransactionStatus.NODE_DEGRADED)
        if self.ingest is not None and self._started:
            from ..protocol import TransactionStatus
            from ..txpool.ingest import LaneStopped, TxPoolIsFull
            from ..txpool.txpool import TxSubmitResult
            from ..utils.task import TaskTimeout
            try:
                return self.ingest.submit(tx)
            except TxPoolIsFull:
                # same condition the pool itself reports as a status
                return TxSubmitResult(tx.hash(self.suite),
                                      TransactionStatus.TXPOOL_FULL)
            except (LaneStopped, TaskTimeout):
                pass  # shutdown race / wedged dispatcher: the pool still
                #       works, and _precheck dedups a queued copy
            except Exception:  # noqa: BLE001 — a failed DISPATCH rejects
                # every coalesced submitter with the batch's error; retry
                # THIS tx alone on the direct path so one bad cohort
                # member can't poison the rest (a genuinely bad tx then
                # reports its own failure from the pool)
                LOG.exception(badge("NODE", "ingest-dispatch-failed"))
        return self.txpool.submit(tx)

    def call(self, tx):
        return self.scheduler.call(tx)
