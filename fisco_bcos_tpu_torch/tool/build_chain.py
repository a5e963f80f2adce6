"""build_chain — generate an N-node chain deployment directory.

Counterpart of the reference's tools/BcosAirBuilder/build_chain.sh (generate
an N-node Air chain: keys, per-node config.ini, shared genesis) and the
BcosBuilder Pro/Max deployers. Output layout:

    <out>/
      node0/ config.ini  genesis  node.key[.enc]
      node1/ ...
      chain_info.json          (node ids + rpc ports, for operators/SDKs)

The port's copy of the JAX package's tools/build_chain.py: the same
layout and files (a directory either package writes boots in the other),
plus the port's `[crypto] device` key in each config.ini.

Usage:
    python -m fisco_bcos_tpu_torch.tool.build_chain -n 4 -o CHAIN [--sm] \
        [--sm-tls] [--consensus pbft] [--rpc-base-port 20200] \
        [--p2p-base-port 30300] [--device cuda|cpu] [--encrypt-key PASS]

Run a generated node as an OS process (init/daemon.py):
    python -m fisco_bcos_tpu_torch CHAIN/node0

or boot it in-process:
    from fisco_bcos_tpu_torch.tool import load_node
    node = load_node("CHAIN/node0", gateway=...)
"""

from __future__ import annotations

import argparse
import json
import os

from ..crypto.suite import make_suite
from ..init.node import NodeConfig
from .config import ChainConfig, save_node_config

# the monitor bundle (dashboards, alert rules) beside the package in the
# repository: data, copied as it is
MONITOR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tools", "monitor")


def _write_monitor_stack(out_dir: str, targets: list[str]) -> None:
    """Copy the monitor bundle (tools/monitor) into the chain dir with the
    Prometheus target list rewritten to the generated nodes' ports."""
    import shutil

    dst = os.path.join(out_dir, "monitor")
    shutil.copytree(MONITOR, dst, dirs_exist_ok=True)
    lines = ["global:", "  scrape_interval: 5s", "", "scrape_configs:",
             "  - job_name: fisco-bcos-tpu", "    static_configs:",
             "      - targets:"]
    lines += [f'          - "{t}"' for t in targets]
    with open(os.path.join(dst, "prometheus.yml"), "w") as f:
        f.write("\n".join(lines) + "\n")


def build_chain(out_dir: str, n_nodes: int, sm_crypto: bool = False,
                consensus: str = "pbft", chain_id: str = "chain0",
                group_id: str = "group0", rpc_base_port: int | None = None,
                encrypt_passphrase: bytes | None = None,
                crypto_backend: str = "auto",
                storage_backend: str = "auto",
                metrics_base_port: int | None = None,
                sm_tls: bool = False,
                p2p_base_port: int | None = None,
                p2p_ports: list[int] | None = None,
                host: str = "127.0.0.1", device: str = "cuda") -> dict:
    suite = make_suite(sm_crypto, backend="host")
    keypairs = [suite.generate_keypair() for _ in range(n_nodes)]
    chain = ChainConfig(chain_id=chain_id, group_id=group_id,
                        sm_crypto=sm_crypto, consensus_type=consensus,
                        sealers=[kp.pub_bytes for kp in keypairs])
    ca = None
    if sm_tls:
        from ..net.smtls import CertificateAuthority
        from .config import save_smtls_files
        ca = CertificateAuthority(name=f"{chain_id}-ca")
    info = {"chain_id": chain_id, "group_id": group_id,
            "sm_crypto": sm_crypto, "sm_tls": sm_tls,
            "consensus": consensus, "nodes": []}
    # p2p plane: each node listens on its port and is configured with every
    # OTHER node's endpoint (the deterministic smaller-id-dials rule in
    # net/p2p.py picks the single live session per pair)
    if p2p_ports is None and p2p_base_port is not None:
        p2p_ports = [p2p_base_port + i for i in range(n_nodes)]
    metric_targets = []
    for i, kp in enumerate(keypairs):
        node_dir = os.path.join(out_dir, f"node{i}")
        cfg = NodeConfig(
            chain_id=chain_id, group_id=group_id, sm_crypto=sm_crypto,
            storage_path="data", consensus=consensus,
            storage_backend=storage_backend,
            crypto_backend=crypto_backend, device=device,
            rpc_port=(rpc_base_port + i) if rpc_base_port is not None else None,
            metrics_port=(metrics_base_port + i)
            if metrics_base_port is not None else None,
            p2p_host=host,
            p2p_port=p2p_ports[i] if p2p_ports else None,
            p2p_peers=[(host, p) for j, p in enumerate(p2p_ports or [])
                       if j != i],
        )
        save_node_config(node_dir, cfg, chain, kp.secret,
                         storage_passphrase=encrypt_passphrase)
        if ca is not None:
            save_smtls_files(node_dir, ca.pub, ca.issue(f"node{i}"),
                             storage_passphrase=encrypt_passphrase)
        if cfg.metrics_port is not None:
            metric_targets.append(f"127.0.0.1:{cfg.metrics_port}")
        info["nodes"].append({
            "dir": node_dir,
            "node_id": kp.pub_bytes.hex(),
            "rpc_port": cfg.rpc_port,
            "metrics_port": cfg.metrics_port,
            "p2p_port": cfg.p2p_port,
        })
    if metric_targets:
        _write_monitor_stack(out_dir, metric_targets)
    with open(os.path.join(out_dir, "chain_info.json"), "w") as f:
        json.dump(info, f, indent=2)
    return info


def build_max_cluster(out_dir: str, n_shards: int = 3,
                      n_registries: int = 3,
                      shard_base_port: int = 21100,
                      registry_base_port: int = 21200,
                      host: str = "127.0.0.1") -> dict:
    """The Max-mode shared-services layout (a sharded storage cluster and
    lease registries). The port has no Max node yet: this raises
    NotImplementedError naming its ROADMAP.md item, as load_max_node does."""
    raise NotImplementedError(
        "the port has no Max-mode node yet (ROADMAP.md A3.14: "
        "services/max_node.py with storage/{native,sharded}.py)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m fisco_bcos_tpu_torch.tool.build_chain",
        description=__doc__)
    ap.add_argument("-n", "--nodes", type=int, default=4)
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("--sm", action="store_true", help="SM2/SM3 chain")
    ap.add_argument("--consensus", default="pbft", choices=["pbft", "solo"])
    ap.add_argument("--chain-id", default="chain0")
    ap.add_argument("--group-id", default="group0")
    ap.add_argument("--rpc-base-port", type=int, default=None)
    ap.add_argument("--p2p-base-port", type=int, default=None,
                    help="per-node TCP p2p listeners + full-mesh peer "
                         "lists (required to run nodes as OS processes)")
    ap.add_argument("--metrics-base-port", type=int, default=None,
                    help="per-node Prometheus ports + monitor stack bundle")
    ap.add_argument("--sm-tls", action="store_true",
                    help="issue dual-cert SM-TLS credentials per node")
    ap.add_argument("--storage", default="auto",
                    choices=["auto", "memory", "wal", "disk"],
                    help="[storage] backend: auto = WAL-backed; disk = "
                         "log-structured engine (restart flat in chain "
                         "length, datasets beyond RAM)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="[crypto] device: where each node's suite runs "
                         "(cuda, the card; cpu, the kernels' plain versions)")
    ap.add_argument("--encrypt-key", default=None,
                    help="passphrase to encrypt node keys at rest")
    ap.add_argument("--mode", default="air", choices=["air", "max"],
                    help="max adds the shared shard cluster + lease "
                         "registries layout (max_cluster.json)")
    ap.add_argument("--shards", type=int, default=3)
    ap.add_argument("--registries", type=int, default=3)
    args = ap.parse_args(argv)
    if args.mode == "max":
        # raises before anything is written: the port has no Max node yet
        build_max_cluster(args.output, n_shards=args.shards,
                          n_registries=args.registries)
    info = build_chain(
        args.output, args.nodes, sm_crypto=args.sm,
        consensus=args.consensus, chain_id=args.chain_id,
        group_id=args.group_id, rpc_base_port=args.rpc_base_port,
        p2p_base_port=args.p2p_base_port,
        metrics_base_port=args.metrics_base_port, sm_tls=args.sm_tls,
        storage_backend=args.storage, device=args.device,
        encrypt_passphrase=args.encrypt_key.encode() if args.encrypt_key else None)
    print(json.dumps(info, indent=2))


if __name__ == "__main__":
    main()
