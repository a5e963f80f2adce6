"""RPC as a service: the access layer backed entirely by service proxies.

Reference counterpart: Pro mode's RpcService (fisco-bcos-tars-service/
RpcService/ + bcos-rpc/groupmgr binding Tars client proxies): the JSON-RPC
process owns no chain state — queries go to the ledger service, submissions
to the txpool service, calls to the scheduler service, raw state reads to
the storage service. `ProNodeFacade` assembles those proxies into the node
surface `JsonRpcImpl` consumes, so the SAME rpc implementation serves Air
(in-process node) and Pro (this facade) deployments.

Parts that are consensus-process-local (PBFT status, block sync status,
gateway peers) are absent here; the RPC methods touching them answer with
their documented "not available on this service" shapes instead of
crashing — matching the reference's per-service method availability.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..executor.executor import TransactionExecutor
from .ledger_service import RemoteLedger
from .scheduler_service import RemoteScheduler
from .storage_service import RemoteStorage
from .txpool_service import RemoteTxPool


@dataclasses.dataclass
class ProNodeConfig:
    chain_id: str = "chain0"
    group_id: str = "group0"
    sm_crypto: bool = False


class ProNodeFacade:
    """Duck-types the Node surface JsonRpcImpl reads (ledger/txpool/
    scheduler/storage/executor/suite/keypair/config); consensus-plane
    attributes are None, which the RPC methods already guard."""

    def __init__(self, suite, keypair, config: ProNodeConfig,
                 txpool: RemoteTxPool, ledger: RemoteLedger,
                 scheduler: RemoteScheduler,
                 storage: Optional[RemoteStorage] = None):
        self.suite = suite
        self.keypair = keypair
        self.config = config
        self.txpool = txpool
        self.ledger = ledger
        self.scheduler = scheduler
        self.storage = storage
        self.executor = TransactionExecutor(suite)
        self.consensus = None  # lives in the consensus service
        self.blocksync = None
        self.front = None
        self.eventsub = None  # event push needs the commit channel (WS svc)

    def close(self) -> None:
        for proxy in (self.txpool, self.ledger, self.scheduler,
                      self.storage):
            if proxy is not None:
                try:
                    proxy.close()
                except Exception:
                    pass


def make_pro_rpc(suite, keypair, config: ProNodeConfig, *,
                 txpool_addr: tuple[str, int],
                 ledger_addr: tuple[str, int],
                 scheduler_addr: tuple[str, int],
                 storage_addr: Optional[tuple[str, int]] = None,
                 host: str = "127.0.0.1", port: int = 0):
    """-> (JsonRpcServer, ProNodeFacade) wired to the given services."""
    from ..rpc.server import JsonRpcImpl, JsonRpcServer

    facade = ProNodeFacade(
        suite, keypair, config,
        RemoteTxPool(*txpool_addr),
        RemoteLedger(*ledger_addr),
        RemoteScheduler(*scheduler_addr),
        RemoteStorage(*storage_addr) if storage_addr else None)
    server = JsonRpcServer(JsonRpcImpl(facade), host=host, port=port)
    return server, facade
