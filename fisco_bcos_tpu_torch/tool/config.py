"""Node configuration files: config.ini + genesis + node key.

Reference counterpart: FISCO-BCOS bcos-tool/bcos-tool/NodeConfig.cpp —
the INI surface (sections `chain.*` :517-535, `consensus.*` :568,
`txpool.*` :473-493, `storage.*` :618-620, `rpc`/`p2p`/`cert` :355-459,
`storage_security.*` :579-606) plus the genesis file defining the immutable
chain parameters and initial consensus node list; and LedgerConfigFetcher
(pull on-chain config at boot). The same three tiers exist here:

  1. config.ini  — per-node runtime knobs (this module -> NodeConfig);
  2. genesis     — chain-wide constants + initial sealers (validated
                   against the ledger once built);
  3. on-chain system config — mutable via the SystemConfig precompile,
     read from the ledger each block (ledger.system_config).
"""

from __future__ import annotations

import configparser
import dataclasses
import os
from typing import Optional

from ..init.node import Node, NodeConfig
from ..ledger.ledger import ConsensusNode
from ..security import DataEncryption, KeyCenter


@dataclasses.dataclass
class ChainConfig:
    """Parsed genesis: immutable chain constants + initial consensus set."""

    chain_id: str = "chain0"
    group_id: str = "group0"
    sm_crypto: bool = False
    consensus_type: str = "pbft"
    block_tx_count_limit: int = 1000
    leader_period: int = 1
    # GenesisConfig.h:68 m_compatibilityVersion: the chain's feature-gate
    # version (raisable later via SystemConfig governance, never lowered)
    compatibility_version: str = "1.1.0"
    sealers: list[bytes] = dataclasses.field(default_factory=list)

    def to_ini(self) -> str:
        cp = configparser.ConfigParser()
        cp["chain"] = {"chain_id": self.chain_id, "group_id": self.group_id,
                       "sm_crypto": str(self.sm_crypto).lower()}
        cp["chain"]["compatibility_version"] = self.compatibility_version
        cp["consensus"] = {
            "consensus_type": self.consensus_type,
            "block_tx_count_limit": str(self.block_tx_count_limit),
            "leader_period": str(self.leader_period),
        }
        lines = []
        for i, pk in enumerate(self.sealers):
            lines.append(f"node.{i}={pk.hex()}:1")
        import io
        buf = io.StringIO()
        cp.write(buf)
        return buf.getvalue() + "[consensus_node_list]\n" + "\n".join(lines) + "\n"

    @classmethod
    def from_ini(cls, text: str) -> "ChainConfig":
        cp = configparser.ConfigParser(strict=False)
        cp.read_string(text)
        sealers = []
        if cp.has_section("consensus_node_list"):
            for key in sorted(cp["consensus_node_list"],
                              key=lambda k: int(k.split(".")[-1])):
                val = cp["consensus_node_list"][key]
                sealers.append(bytes.fromhex(val.split(":")[0]))
        return cls(
            chain_id=cp.get("chain", "chain_id", fallback="chain0"),
            group_id=cp.get("chain", "group_id", fallback="group0"),
            sm_crypto=cp.getboolean("chain", "sm_crypto", fallback=False),
            consensus_type=cp.get("consensus", "consensus_type",
                                  fallback="pbft"),
            block_tx_count_limit=cp.getint("consensus",
                                           "block_tx_count_limit",
                                           fallback=1000),
            leader_period=cp.getint("consensus", "leader_period", fallback=1),
            compatibility_version=cp.get("chain", "compatibility_version",
                                         fallback="1.1.0"),
            sealers=sealers,
        )


def node_config_to_ini(cfg: NodeConfig) -> str:
    cp = configparser.ConfigParser()
    cp["chain"] = {"chain_id": cfg.chain_id, "group_id": cfg.group_id,
                   "sm_crypto": str(cfg.sm_crypto).lower()}
    # multi-group hosting: group ids this process runs (init/group.py);
    # empty = single-group node
    cp["groups"] = {"list": ",".join(cfg.groups)}
    cp["txpool"] = {"limit": str(cfg.txpool_limit),
                    "block_limit_range": str(cfg.block_limit_range),
                    # watermark admission (txpool/txpool.py)
                    "low_watermark": str(cfg.txpool_low_watermark),
                    "high_watermark": str(cfg.txpool_high_watermark),
                    "priority_bands": str(
                        cfg.txpool_priority_bands).lower()}
    # overload-control plane (utils/overload.py + rpc/admission.py):
    # busy thresholds + the edge's per-client read/write token budgets
    cp["overload"] = {
        "enabled": str(cfg.overload_enabled).lower(),
        "enter": str(cfg.overload_enter),
        "exit": str(cfg.overload_exit),
        "hold_s": str(cfg.overload_hold_s),
        "commit_backlog": str(cfg.overload_commit_backlog),
        "busy_write_factor": str(cfg.overload_busy_write_factor),
        "client_write_rate": str(cfg.client_write_rate),
        "client_write_burst": str(cfg.client_write_burst),
        "client_read_rate": str(cfg.client_read_rate),
        "client_read_burst": str(cfg.client_read_burst),
    }
    cp["consensus"] = {"type": cfg.consensus,
                       "min_seal_time": str(cfg.min_seal_time),
                       # busy-pipeline fill ceiling (sealer/sealer.py)
                       "max_seal_time": str(cfg.max_seal_time),
                       "view_timeout": str(cfg.view_timeout),
                       "leader_period": str(cfg.leader_period),
                       "tx_count_limit": str(cfg.tx_count_limit),
                       # proposal pipeline depth (PBFT water size)
                       "waterline": str(cfg.waterline),
                       # commit-seal carriage minted at checkpoint quorum
                       # (consensus/qc.py): multi | cert | aggregate
                       "seal_mode": cfg.seal_mode}
    # pipelined block production (scheduler/scheduler.py): off-thread
    # ordered commit + speculative next-height execution
    cp["scheduler"] = {"pipeline": str(cfg.pipeline_commit).lower(),
                       # out-of-process execution workers (scheduler/
                       # workers.py): 0 = in-process execution
                       "workers": str(cfg.scheduler_workers)}
    cp["storage"] = {"backend": cfg.storage_backend,
                     "path": cfg.storage_path or "",
                     # disk engine knobs (storage/engine.py)
                     "memtable_mb": str(cfg.storage_memtable_mb),
                     "compact_segments": str(cfg.storage_compact_segments),
                     # leveled compaction geometry: L1 byte target +
                     # per-level growth factor (merge cost stays
                     # O(level slice) at any dataset size)
                     "level_base_mb": str(cfg.storage_level_base_mb),
                     "level_fanout": str(cfg.storage_level_fanout),
                     # reference storage.key_page_size (NodeConfig.cpp:620);
                     # auto = ON for the disk backend, off otherwise
                     "key_page_size": "auto"
                     if cfg.storage_key_page_size < 0
                     else str(cfg.storage_key_page_size)}
    cp["snapshot"] = {"interval": str(cfg.snapshot_interval),
                      "retention": str(cfg.snapshot_retention),
                      "prune": str(cfg.snapshot_prune).lower(),
                      "keep_tail": str(cfg.snapshot_keep_tail),
                      "snap_sync_threshold": str(cfg.snap_sync_threshold),
                      "chunk_bytes": str(cfg.snapshot_chunk_bytes)}
    cp["rpc"] = {"listen_ip": cfg.rpc_host,
                 "listen_port": "" if cfg.rpc_port is None else str(cfg.rpc_port),
                 # serving read plane (rpc/edge.py + rpc/cache.py)
                 "workers": str(cfg.rpc_workers),
                 "max_batch": str(cfg.rpc_max_batch),
                 "cache_entries": str(cfg.rpc_cache_entries),
                 "cache_mb": str(cfg.rpc_cache_mb),
                 "keepalive_s": str(cfg.rpc_keepalive_s),
                 # push-based subscription plane (rpc/eventsub.SubHub);
                 # ws_port empty = no WS server, 0 = ephemeral
                 "ws_port": "" if cfg.ws_port is None else str(cfg.ws_port),
                 "sub_max_sessions": str(cfg.sub_max_sessions),
                 "sub_outbox_kb": str(cfg.sub_outbox_kb)}
    cp["p2p"] = {"listen_ip": cfg.p2p_host,
                 "listen_port": "" if cfg.p2p_port is None else str(cfg.p2p_port),
                 # NodeConfig.cpp's nodes.json connected_nodes, inlined
                 "nodes": ",".join(f"{h}:{p}" for h, p in cfg.p2p_peers)}
    cp["monitor"] = {"metrics_port": ""
                     if cfg.metrics_port is None else str(cfg.metrics_port)}
    # tracing plane knobs (utils/otrace.py): root sampling rate, span ring
    # bound, always-retained slow-span threshold
    cp["trace"] = {"sample_rate": str(cfg.trace_sample_rate),
                   "ring_size": str(cfg.trace_ring_size),
                   "slow_ms": str(cfg.trace_slow_ms)}
    # continuous profiling plane knobs (analysis/profiler.py): always-on
    # sampling hz (0 disarms), folded-stack ring bound, slow-span burst
    # capture rate + duration
    cp["profile"] = {"hz": str(cfg.profile_hz),
                     "ring": str(cfg.profile_ring),
                     "burst_hz": str(cfg.profile_burst_hz),
                     "burst_s": str(cfg.profile_burst_s)}
    # deterministic fault injection (utils/failpoints.py) — chaos/test
    # deployments only; empty arms nothing
    cp["failpoints"] = {"spec": cfg.failpoints}
    cp["executor"] = {}
    cp["crypto"] = {"backend": cfg.crypto_backend,
                    "device_min_batch": str(cfg.device_min_batch),
                    "mesh_devices": str(cfg.crypto_mesh_devices),
                    # shared crypto-plane lane (crypto/lane.py): merge all
                    # groups' batches into single device calls
                    "lane": str(cfg.crypto_lane).lower(),
                    "lane_wait_ms": str(cfg.crypto_lane_wait_ms),
                    # the port's own key: where the suite's tensor path
                    # runs ("cuda" or "cpu"); the JAX package's reader
                    # ignores keys it does not know
                    "device": cfg.device}
    import io
    buf = io.StringIO()
    cp.write(buf)
    return buf.getvalue()


def node_config_from_ini(text: str, base_dir: str = "") -> NodeConfig:
    cp = configparser.ConfigParser(strict=False)
    cp.read_string(text)
    path = cp.get("storage", "path", fallback="") or None
    if path and base_dir and not os.path.isabs(path):
        path = os.path.join(base_dir, path)
    # legacy configs carry `type = wal|memory` instead of `backend`
    backend = cp.get("storage", "backend", fallback="") or \
        cp.get("storage", "type", fallback="auto") or "auto"
    # key_page_size: `auto` (or empty/absent) = backend-appropriate
    # default (-1 sentinel -> make_storage turns paging on for disk)
    kps_raw = cp.get("storage", "key_page_size", fallback="auto").strip()
    key_page_size = -1 if kps_raw in ("", "auto") else int(kps_raw)
    port_s = cp.get("rpc", "listen_port", fallback="")
    ws_s = cp.get("rpc", "ws_port", fallback="")
    metrics_s = cp.get("monitor", "metrics_port", fallback="")
    p2p_port_s = cp.get("p2p", "listen_port", fallback="")
    peers = []
    for ent in cp.get("p2p", "nodes", fallback="").split(","):
        ent = ent.strip()
        if not ent:
            continue
        host, sep, port = ent.rpartition(":")
        if not sep or not host or not port.isdigit():
            raise ValueError(
                f"bad [p2p] nodes entry {ent!r} in config.ini "
                "(expected host:port)")
        peers.append((host, int(port)))
    groups = [g.strip() for g in
              cp.get("groups", "list", fallback="").split(",") if g.strip()]
    return NodeConfig(
        chain_id=cp.get("chain", "chain_id", fallback="chain0"),
        group_id=cp.get("chain", "group_id", fallback="group0"),
        sm_crypto=cp.getboolean("chain", "sm_crypto", fallback=False),
        groups=groups,
        storage_path=path,
        storage_backend=backend,
        storage_memtable_mb=cp.getint("storage", "memtable_mb",
                                      fallback=64),
        storage_compact_segments=cp.getint("storage", "compact_segments",
                                           fallback=8),
        storage_level_base_mb=cp.getint("storage", "level_base_mb",
                                        fallback=16),
        storage_level_fanout=cp.getint("storage", "level_fanout",
                                       fallback=8),
        storage_key_page_size=key_page_size,
        txpool_limit=cp.getint("txpool", "limit", fallback=15000),
        block_limit_range=cp.getint("txpool", "block_limit_range",
                                    fallback=600),
        txpool_low_watermark=cp.getfloat("txpool", "low_watermark",
                                         fallback=0.7),
        txpool_high_watermark=cp.getfloat("txpool", "high_watermark",
                                          fallback=0.95),
        txpool_priority_bands=cp.getboolean("txpool", "priority_bands",
                                            fallback=True),
        overload_enabled=cp.getboolean("overload", "enabled",
                                       fallback=True),
        overload_enter=cp.getfloat("overload", "enter", fallback=0.85),
        overload_exit=cp.getfloat("overload", "exit", fallback=0.5),
        overload_hold_s=cp.getfloat("overload", "hold_s", fallback=0.5),
        overload_commit_backlog=cp.getint("overload", "commit_backlog",
                                          fallback=6),
        overload_busy_write_factor=cp.getfloat(
            "overload", "busy_write_factor", fallback=0.25),
        client_write_rate=cp.getfloat("overload", "client_write_rate",
                                      fallback=0.0),
        client_write_burst=cp.getfloat("overload", "client_write_burst",
                                       fallback=0.0),
        client_read_rate=cp.getfloat("overload", "client_read_rate",
                                     fallback=0.0),
        client_read_burst=cp.getfloat("overload", "client_read_burst",
                                      fallback=0.0),
        consensus=cp.get("consensus", "type", fallback="solo"),
        min_seal_time=cp.getfloat("consensus", "min_seal_time",
                                  fallback=0.05),
        max_seal_time=cp.getfloat("consensus", "max_seal_time",
                                  fallback=0.5),
        view_timeout=cp.getfloat("consensus", "view_timeout", fallback=3.0),
        leader_period=cp.getint("consensus", "leader_period", fallback=1),
        tx_count_limit=cp.getint("consensus", "tx_count_limit",
                                 fallback=1000),
        waterline=cp.getint("consensus", "waterline", fallback=8),
        seal_mode=cp.get("consensus", "seal_mode", fallback="multi"),
        pipeline_commit=cp.getboolean("scheduler", "pipeline",
                                      fallback=True),
        scheduler_workers=cp.getint("scheduler", "workers", fallback=0),
        snapshot_interval=cp.getint("snapshot", "interval", fallback=0),
        snapshot_retention=cp.getint("snapshot", "retention", fallback=2),
        snapshot_prune=cp.getboolean("snapshot", "prune", fallback=False),
        snapshot_keep_tail=cp.getint("snapshot", "keep_tail", fallback=64),
        snap_sync_threshold=cp.getint("snapshot", "snap_sync_threshold",
                                      fallback=256),
        snapshot_chunk_bytes=cp.getint("snapshot", "chunk_bytes",
                                       fallback=1 << 20),
        crypto_backend=cp.get("crypto", "backend", fallback="auto"),
        device_min_batch=cp.getint("crypto", "device_min_batch", fallback=512),
        crypto_mesh_devices=cp.getint("crypto", "mesh_devices", fallback=0),
        crypto_lane=cp.getboolean("crypto", "lane", fallback=True),
        crypto_lane_wait_ms=cp.getfloat("crypto", "lane_wait_ms",
                                        fallback=0.0),
        device=cp.get("crypto", "device", fallback="cuda"),
        rpc_host=cp.get("rpc", "listen_ip", fallback="127.0.0.1"),
        rpc_port=int(port_s) if port_s else None,
        rpc_workers=cp.getint("rpc", "workers", fallback=8),
        rpc_max_batch=cp.getint("rpc", "max_batch", fallback=256),
        rpc_cache_entries=cp.getint("rpc", "cache_entries", fallback=4096),
        rpc_cache_mb=cp.getint("rpc", "cache_mb", fallback=64),
        rpc_keepalive_s=cp.getfloat("rpc", "keepalive_s", fallback=60.0),
        ws_port=int(ws_s) if ws_s else None,
        sub_max_sessions=cp.getint("rpc", "sub_max_sessions",
                                   fallback=16384),
        sub_outbox_kb=cp.getint("rpc", "sub_outbox_kb", fallback=1024),
        metrics_port=int(metrics_s) if metrics_s else None,
        trace_sample_rate=cp.getfloat("trace", "sample_rate",
                                      fallback=0.02),
        trace_ring_size=cp.getint("trace", "ring_size", fallback=4096),
        trace_slow_ms=cp.getfloat("trace", "slow_ms", fallback=1000.0),
        profile_hz=cp.getfloat("profile", "hz", fallback=5.0),
        profile_ring=cp.getint("profile", "ring", fallback=2048),
        profile_burst_hz=cp.getfloat("profile", "burst_hz", fallback=97.0),
        profile_burst_s=cp.getfloat("profile", "burst_s", fallback=1.0),
        p2p_host=cp.get("p2p", "listen_ip", fallback="127.0.0.1"),
        p2p_port=int(p2p_port_s) if p2p_port_s else None,
        p2p_peers=peers,
        failpoints=cp.get("failpoints", "spec", fallback=""),
    )


def save_node_config(node_dir: str, cfg: NodeConfig, chain: ChainConfig,
                     secret: int,
                     storage_passphrase: Optional[bytes] = None) -> None:
    """Write a node directory: config.ini, genesis, node.key[.enc]."""
    os.makedirs(node_dir, exist_ok=True)
    with open(os.path.join(node_dir, "config.ini"), "w") as f:
        f.write(node_config_to_ini(cfg))
    with open(os.path.join(node_dir, "genesis"), "w") as f:
        f.write(chain.to_ini())
    key_bytes = secret.to_bytes(32, "big")
    if storage_passphrase:
        enc = DataEncryption(KeyCenter(storage_passphrase))
        with open(os.path.join(node_dir, "node.key.enc"), "wb") as f:
            f.write(enc.encrypt(key_bytes))
    else:
        with open(os.path.join(node_dir, "node.key"), "wb") as f:
            f.write(key_bytes)


def save_smtls_files(node_dir: str, ca_pub, credential,
                     storage_passphrase: Optional[bytes] = None) -> None:
    """Write the dual-cert transport identity (build_chain --sm-tls):
    `ca.pub` trust root + `node.smtls` credential (certs + private keys,
    encrypted at rest alongside node.key when a passphrase is set)."""
    from ..net.smtls import _point_bytes
    with open(os.path.join(node_dir, "ca.pub"), "wb") as f:
        f.write(_point_bytes(ca_pub))
    blob = credential.encode()
    if storage_passphrase:
        enc = DataEncryption(KeyCenter(storage_passphrase))
        with open(os.path.join(node_dir, "node.smtls.enc"), "wb") as f:
            f.write(enc.encrypt(blob))
    else:
        with open(os.path.join(node_dir, "node.smtls"), "wb") as f:
            f.write(blob)


def load_smtls_context(node_dir: str,
                       storage_passphrase: Optional[bytes] = None):
    """-> SMTLSContext for this node's dual-cert files, or None if the
    chain was built without --sm-tls. Pass the result as the gateway's
    server_ssl/client_ssl (one context serves both directions)."""
    from ..net.smtls import Credential, SMTLSContext, _parse_point
    ca_path = os.path.join(node_dir, "ca.pub")
    if not os.path.exists(ca_path):
        return None
    with open(ca_path, "rb") as f:
        ca_pub = _parse_point(f.read())
    enc_path = os.path.join(node_dir, "node.smtls.enc")
    if os.path.exists(enc_path):
        if not storage_passphrase:
            raise ValueError("SM-TLS credential is encrypted; "
                             "passphrase required")
        enc = DataEncryption(KeyCenter(storage_passphrase))
        blob = enc.decrypt_file(enc_path)
    else:
        with open(os.path.join(node_dir, "node.smtls"), "rb") as f:
            blob = f.read()
    return SMTLSContext(ca_pub, Credential.decode(blob))


def _load_node_parts(node_dir: str,
                     storage_passphrase: Optional[bytes] = None):
    """-> (cfg, chain, suite, keypair) from a config directory."""
    with open(os.path.join(node_dir, "config.ini")) as f:
        cfg = node_config_from_ini(f.read(), base_dir=node_dir)
    with open(os.path.join(node_dir, "genesis")) as f:
        chain = ChainConfig.from_ini(f.read())
    enc_path = os.path.join(node_dir, "node.key.enc")
    if os.path.exists(enc_path):
        if not storage_passphrase:
            raise ValueError("node key is encrypted; passphrase required")
        enc = DataEncryption(KeyCenter(storage_passphrase))
        key_bytes = enc.decrypt_file(enc_path)
    else:
        with open(os.path.join(node_dir, "node.key"), "rb") as f:
            key_bytes = f.read()
    from ..crypto.suite import make_suite
    suite = make_suite(cfg.sm_crypto, backend=cfg.crypto_backend,
                       device=cfg.device,
                       device_min_batch=cfg.device_min_batch,
                       mesh_devices=cfg.crypto_mesh_devices)
    kp = suite.keypair_from_secret(int.from_bytes(key_bytes, "big"))
    cfg.tx_count_limit = chain.block_tx_count_limit
    cfg.leader_period = chain.leader_period
    cfg.compatibility_version = chain.compatibility_version
    return cfg, chain, suite, kp


def load_node(node_dir: str, gateway=None,
              storage_passphrase: Optional[bytes] = None) -> Node:
    """Boot a Node from a config directory (genesis applied on first start,
    validated against the existing ledger otherwise)."""
    cfg, chain, suite, kp = _load_node_parts(node_dir, storage_passphrase)
    node = Node(cfg, keypair=kp, suite=suite, gateway=gateway)
    if node.ledger.current_number() < 0:
        node.build_genesis([ConsensusNode(pk) for pk in chain.sealers]
                           or None)
    elif chain.sealers:
        # restart: the genesis file must agree with the built chain's
        # GENESIS block (header 0's immutable sealer_list) — NOT the live
        # consensus set, which legitimately diverges over time through
        # addSealer/remove governance (the Consensus precompile)
        g0 = node.ledger.header_by_number(0)
        if g0 is None:
            raise ValueError(
                "ledger has blocks but no readable genesis header — "
                "refusing to boot on corrupt chain data")
        if set(g0.sealer_list) != set(chain.sealers):
            raise ValueError(
                "genesis consensus_node_list does not match the existing "
                "ledger's genesis block — refusing to boot")
    return node


def load_max_node(node_dir: str, cluster_path: str, member_id: str,
                  gateway=None, storage_passphrase: Optional[bytes] = None,
                  tls_ctx=None, lease_ttl: float = 3.0,
                  heartbeat: float = 1.0):
    """Boot a Max-mode replica from a build_chain --mode max layout. The
    Max node (services/max_node.py) is not ported yet: this raises
    NotImplementedError naming its ROADMAP.md item, as the Node's
    _check_ported does for the planes the port does not have."""
    raise NotImplementedError(
        "the port has no Max-mode node yet (ROADMAP.md A3.14: "
        "services/max_node.py with storage/{native,sharded}.py)")
