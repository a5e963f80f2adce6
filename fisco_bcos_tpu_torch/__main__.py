"""`python -m fisco_bcos_tpu_torch <node_dir>` — boot one node as an OS process.

The process-level entry point of the reference's fisco-bcos Air binary
(fisco-bcos-air/main.cpp): point it at one node directory generated by
tool/build_chain.py (config.ini + genesis + node.key [+ SM-TLS certs])
and it runs that node until SIGTERM/SIGINT. See init/daemon.py for the
lifecycle contract (PID file, graceful shutdown, SIGHUP log reopen). A
config whose `[crypto] device` is cuda runs its suite on the card; with
no card, or a kernel that fails to build or load, the process exits
non-zero rather than running on the CPU.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fisco_bcos_tpu_torch", description=__doc__)
    ap.add_argument("node_dir",
                    help="node directory from tool/build_chain.py")
    ap.add_argument("--log-file", default=None,
                    help="log here instead of stderr (SIGHUP re-opens it)")
    ap.add_argument("--log-level", default="info",
                    choices=["debug", "info", "warning", "error"])
    ap.add_argument("--passphrase", default=None,
                    help="storage passphrase for encrypted node keys")
    args = ap.parse_args(argv)

    from .init.daemon import NodeDaemon
    daemon = NodeDaemon(
        args.node_dir,
        storage_passphrase=args.passphrase.encode() if args.passphrase
        else None,
        log_file=args.log_file, log_level=args.log_level)
    return daemon.run()


if __name__ == "__main__":
    raise SystemExit(main())
