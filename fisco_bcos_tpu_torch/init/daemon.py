"""NodeDaemon — run one chain node as a real OS process.

Reference counterpart: FISCO-BCOS fisco-bcos-air/main.cpp — the Air
binary's lifecycle: parse the deployment directory written by build_chain,
initialise the node stack (Initializer.cpp), then block on signals.
SIGTERM/SIGINT shut down gracefully (stop workers, close p2p sessions,
flush the WAL); SIGHUP re-opens the log file so logrotate works; a PID
file guards against double-starting the same data directory.

Boot path:

    python -m fisco_bcos_tpu_torch.tool.build_chain -n 4 -o CHAIN \
        --rpc-base-port 20200 --p2p-base-port 30300 [--sm-tls] [--device cpu]
    python -m fisco_bcos_tpu_torch CHAIN/node0

The daemon wires the build_chain-issued transport credentials (ca.pub +
node.smtls, when the chain was built with --sm-tls) into the P2P gateway,
so inter-node traffic runs over the dual-cert SM-TLS channel; without
them the gateway speaks plain TCP. Crash recovery comes from the layers
below: the WAL replays on open (storage/wal.py), the PBFT consensus log
restores the in-flight round (consensus/pbft/storage.py), and block sync
catches the node up to the live chain (sync/sync.py).

The port adds one boot step: a config whose suite runs on the card
(`[crypto] device = cuda`, a backend other than host) builds and loads
its chain's CUDA kernels before the node starts, so a machine with no
card, or a kernel that does not build or load, ends the boot with exit
code 1 instead of a node that would fail at its first batch. Nothing
falls back to the CPU.
"""

from __future__ import annotations

import os
import signal
import threading
from typing import Optional

from ..utils.log import LOG, badge, init_file_log, init_log

PID_FILE = "node.pid"


class DaemonError(RuntimeError):
    pass


def _load_kernels(cfg) -> None:
    """Build (into fisco_bcos_tpu_torch/_build/, one nvcc per source at
    once) and load the CUDA kernels the config's chain launches, when its
    suite runs on the card (the suite itself refuses to build there with
    no card). Raises if a kernel does not build or load."""
    import torch

    device = torch.device(cfg.device)
    if cfg.crypto_backend == "host" or device.type != "cuda":
        return
    from ..ops import _cuda
    names = (("sm2", "sm3", "merkle") if cfg.sm_crypto
             else ("verify", "keccak", "merkle"))
    _cuda.build_all(names)
    for name in names:
        _cuda.library(name, device)


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # exists, owned by someone else
    return True


class NodeDaemon:
    """One node process: pid file + signal-driven lifecycle around a Node."""

    def __init__(self, node_dir: str,
                 storage_passphrase: Optional[bytes] = None,
                 log_file: Optional[str] = None,
                 log_level: str = "info"):
        self.node_dir = os.path.abspath(node_dir)
        self.storage_passphrase = storage_passphrase
        self.log_file = log_file
        self.log_level = log_level
        self.node = None
        self.gateway = None
        # multi-group mode ([groups] in config.ini): the registry hosting
        # one Node per group, the storage they share, and the one edge
        self.manager = None
        self.shared_storage = None
        self.rpc = None
        self.ws = None
        self.rpc_pool = None
        self.metrics = None
        self._log_handler = None
        self._stop = threading.Event()
        self._pid_path = os.path.join(self.node_dir, PID_FILE)
        self._pid_owned = False

    # -- pid file ----------------------------------------------------------
    def _acquire_pidfile(self) -> None:
        # O_EXCL create is the atomicity point: two daemons racing the same
        # data dir cannot both win (a check-then-write would let both pass
        # and interleave WAL appends); the loser of the unlink race below
        # simply fails its own O_EXCL attempt next round
        for _ in range(3):
            try:
                fd = os.open(self._pid_path,
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644)
            except FileExistsError:
                try:
                    with open(self._pid_path) as f:
                        old = int(f.read().strip() or "0")
                except (OSError, ValueError):
                    old = 0
                if old and old != os.getpid() and _pid_alive(old):
                    raise DaemonError(
                        f"node already running (pid {old}, "
                        f"{self._pid_path}); refusing to double-start on "
                        "the same data directory")
                # stale pid from a kill -9: the WAL/consensus-log replay
                # below is exactly the recovery path for this case
                LOG.warning(badge("DAEMON", "stale-pidfile", pid=old))
                try:
                    os.remove(self._pid_path)
                except OSError:
                    pass
                continue
            with os.fdopen(fd, "w") as f:
                f.write(str(os.getpid()))
            self._pid_owned = True
            return
        raise DaemonError(f"could not acquire pid file {self._pid_path}")

    def _release_pidfile(self) -> None:
        if not self._pid_owned:
            return
        try:
            os.remove(self._pid_path)
        except OSError:
            pass
        self._pid_owned = False

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        """Acquire the pid file, build the stack, start the node."""
        import logging

        level = getattr(logging, self.log_level.upper(), logging.INFO)
        if self.log_file:
            self._log_handler = init_file_log(self.log_file, level)
        else:
            init_log(level)
        self._acquire_pidfile()
        try:
            self._boot()
        except BaseException:
            if self.gateway is not None:
                try:
                    self.gateway.stop()
                except Exception:
                    pass
                self.gateway = None
            self._release_pidfile()
            raise

    def _boot(self) -> None:
        from ..net.p2p import P2PGateway
        from ..tool.config import (_load_node_parts, load_node,
                                   load_smtls_context)

        cfg, chain, _suite, kp = _load_node_parts(
            self.node_dir, self.storage_passphrase)
        _load_kernels(cfg)
        if cfg.p2p_port is None:
            raise DaemonError(
                "config.ini has no [p2p] listen_port — rebuild the chain "
                "with fisco_bcos_tpu_torch.tool.build_chain --p2p-base-port")
        tls = load_smtls_context(self.node_dir, self.storage_passphrase)
        self.gateway = P2PGateway(
            kp.pub_bytes, host=cfg.p2p_host, port=cfg.p2p_port,
            peers=list(cfg.p2p_peers), server_ssl=tls, client_ssl=tls)
        if len(cfg.groups) >= 2:
            self._boot_multigroup(cfg, chain, kp, tls)
            return
        self.node = load_node(self.node_dir, gateway=self.gateway,
                              storage_passphrase=self.storage_passphrase)
        # p2p isolation (all peers unreachable) degrades THIS node
        self.gateway.health = self.node.health
        self.node.start()
        LOG.info(badge("DAEMON", "up", pid=os.getpid(),
                       node=kp.pub_bytes[:8].hex(),
                       p2p=f"{self.gateway.host}:{self.gateway.port}",
                       rpc=self.node.rpc.port if self.node.rpc else None,
                       tls=tls is not None,
                       number=self.node.ledger.current_number(),
                       snapshot=cfg.snapshot_interval,
                       pruned_below=self.node.ledger.pruned_below()))

    def _boot_multigroup(self, cfg, chain, kp, tls) -> None:
        """[groups] wiring: G ledger/txpool/consensus/scheduler stacks in
        THIS process behind one RPC edge, one p2p gateway (namespaced per
        group), one shared crypto lane, and one WAL the groups' storage is
        namespaced over. Every group runs the same node key and the
        genesis sealer set (the reference's one-node-many-groups shape)."""
        import dataclasses as _dc

        from ..ledger.ledger import ConsensusNode
        from ..net.gateway import MuxGateway
        from ..rpc.edge import WorkerPool
        from ..storage import make_storage
        from .group import GroupedJsonRpc, GroupManager

        # ONE engine for all groups (the per-group NamespacedStorage views
        # ride over it); unlabeled registry — the store is shared, the
        # per-group series come from each node's own subsystems
        self.shared_storage = make_storage(
            cfg.storage_backend, cfg.storage_path,
            memtable_mb=cfg.storage_memtable_mb,
            compact_segments=cfg.storage_compact_segments,
            key_page_size=cfg.storage_key_page_size,
            level_base_mb=cfg.storage_level_base_mb,
            level_fanout=cfg.storage_level_fanout)
        # ONE p2p listener for all groups: group tags ride the frames
        # (MuxGateway), sessions authenticate with the single node key
        self.manager = GroupManager(shared_gateway=MuxGateway(self.gateway),
                                    chain_id=cfg.chain_id,
                                    storage=self.shared_storage)
        # shared-plane faults (p2p isolation, shared-store ENOSPC) degrade
        # every hosted group
        self.gateway.health = self.manager.health_fanout
        for gid in cfg.groups:
            gcfg = _dc.replace(
                cfg, group_id=gid, groups=[],
                # the shared storage is injected; the per-group path only
                # anchors side stores (snapshot chunks)
                storage_path=os.path.join(cfg.storage_path, "groups", gid)
                if cfg.storage_path else None,
                rpc_port=None, ws_port=None, metrics_port=None,
                p2p_port=None, p2p_peers=[])
            node = self.manager.add_group(gcfg, keypair=kp)
            if node.ledger.current_number() < 0:
                node.build_genesis([ConsensusNode(pk)
                                    for pk in chain.sealers] or None)
        self.node = self.manager.node(cfg.groups[0])  # primary (logs/ops)
        self.manager.start()
        impl = GroupedJsonRpc(self.manager, default_group=cfg.groups[0])
        if cfg.rpc_port is not None or cfg.ws_port is not None:
            self.rpc_pool = WorkerPool(cfg.rpc_workers)
            self.rpc_pool.start()
        if cfg.rpc_port is not None:
            from ..rpc.ops import OpsRoutes
            from ..rpc.server import JsonRpcServer
            # ops surface on the shared edge: /status reports the primary
            # group's document (it carries the full group registry)
            self.rpc = JsonRpcServer(impl, host=cfg.rpc_host,
                                     port=cfg.rpc_port, pool=self.rpc_pool,
                                     keepalive_s=cfg.rpc_keepalive_s,
                                     ops=OpsRoutes(
                                         status_fn=self.node.system_status,
                                         health_fn=self.manager
                                         .health_snapshot))
            self.rpc.start()
        if cfg.ws_port is not None:
            from ..rpc.ws_server import WsRpcServer
            self.ws = WsRpcServer(impl, host=cfg.rpc_host, port=cfg.ws_port,
                                  pool=self.rpc_pool)
            self.ws.start()
        if cfg.metrics_port is not None:
            from ..utils.metrics import MetricsServer
            self.metrics = MetricsServer(host=cfg.rpc_host,
                                         port=cfg.metrics_port,
                                         status_fn=self.node.system_status,
                                         health_fn=self.manager
                                         .health_snapshot)
            self.metrics.start()
        LOG.info(badge("DAEMON", "up-multigroup", pid=os.getpid(),
                       node=kp.pub_bytes[:8].hex(),
                       groups=",".join(cfg.groups),
                       p2p=f"{self.gateway.host}:{self.gateway.port}",
                       rpc=self.rpc.port if self.rpc else None,
                       ws=self.ws.port if self.ws else None,
                       tls=tls is not None))

    def shutdown(self) -> None:
        """Graceful stop: workers, p2p sessions, then flush/close the WAL."""
        # multi-group teardown first (edges before nodes: no new submitters)
        for attr in ("metrics", "rpc", "ws", "rpc_pool"):
            svc = getattr(self, attr)
            setattr(self, attr, None)
            if svc is not None:
                try:
                    svc.stop()
                except Exception:
                    LOG.exception(badge("DAEMON", f"{attr}-stop-failed"))
        manager, self.manager = self.manager, None
        if manager is not None:
            self.node = None  # owned by the manager
            try:
                manager.stop()
            except Exception:
                LOG.exception(badge("DAEMON", "manager-stop-failed"))
        storage, self.shared_storage = self.shared_storage, None
        if storage is not None:
            close = getattr(storage, "close", None)
            if close is not None:
                try:
                    close()  # flush + fsync the shared WAL tail
                except Exception:
                    LOG.exception(badge("DAEMON", "storage-close-failed"))
        node, self.node = self.node, None
        if node is not None:
            try:
                node.stop()  # sealer/consensus/sync/front+gateway/rpc/ws
            except Exception:
                LOG.exception(badge("DAEMON", "stop-failed"))
            close = getattr(node.storage, "close", None)
            if close is not None:
                try:
                    close()  # flush + fsync the WAL tail
                except Exception:
                    LOG.exception(badge("DAEMON", "storage-close-failed"))
        gateway, self.gateway = self.gateway, None
        if gateway is not None:
            # normally already stopped via front.stop() -> unregister_front;
            # explicit (idempotent) stop covers a boot that died between
            # gateway and node construction
            try:
                gateway.stop()
            except Exception:
                LOG.exception(badge("DAEMON", "gateway-stop-failed"))
        self._release_pidfile()
        LOG.info(badge("DAEMON", "down", pid=os.getpid()))

    # -- signal-driven main loop ------------------------------------------
    def _on_terminate(self, signum, _frame) -> None:
        LOG.info(badge("DAEMON", "signal", sig=signal.Signals(signum).name))
        self._stop.set()

    def _on_hup(self, _signum, _frame) -> None:
        if self._log_handler is not None:
            self._log_handler.reopen()
            LOG.info(badge("DAEMON", "log-reopened", path=self.log_file))

    def run(self) -> int:
        """Start, then block until SIGTERM/SIGINT. Returns an exit code."""
        signal.signal(signal.SIGTERM, self._on_terminate)
        signal.signal(signal.SIGINT, self._on_terminate)
        signal.signal(signal.SIGHUP, self._on_hup)
        try:
            self.start()
        except DaemonError as exc:
            LOG.error(badge("DAEMON", "boot-refused", error=str(exc)))
            return 3
        except Exception:
            LOG.exception(badge("DAEMON", "boot-failed"))
            return 1
        try:
            while not self._stop.wait(timeout=1.0):
                pass
        finally:
            self.shutdown()
        return 0
