"""Multi-group composition: G independent chains sharing one process.

Reference counterpart: the multi-group model of
FISCO-BCOS bcos-framework/bcos-framework/multigroup/ (GroupInfo /
ChainNodeInfo), bcos-rpc/bcos-rpc/groupmgr/GroupManager.cpp (RPC-side group
registry + per-group service routing) and the gateway's group multiplexing
(bcos-gateway GatewayNodeManager.cpp). Each group is an independent chain —
its own ledger, txpool, consensus set, scheduler pipeline — and the process
shares the expensive planes across all of them:

  * ONE serving edge: `GroupedJsonRpc` routes by the JSON-RPC `group`
    param to a per-group `JsonRpcImpl`, each with its own commit-coherent
    query cache; one HTTP event loop + one WS server + one worker pool.
  * ONE transport: `net.gateway.GroupGateway` namespaces the shared
    gateway per group.
  * ONE crypto plane: a shared `crypto.lane.CryptoLane` merges every
    group's verify/recover/hash batches into single device calls — G
    orderers keep the card's kernels fed where one never could (PAPER.md
    §1 Air/Pro/Max wiring). The lane's base suite runs on every group's
    `device` (the first group's config creates it).
  * ONE storage (optional): `storage.NamespacedStorage` gives each group
    its own table namespace over a single WAL — one fsync stream, one
    crash-recovery pass.
  * ONE coordinator: `init.xshard.CrossShardCoordinator` drives
    cross-group atomic transfers (escrow / credit / settle — see
    executor/precompiled.py XShardPrecompile) over the groups' block 2PC.
"""

from __future__ import annotations

import threading
from typing import Optional

from ..net.gateway import Gateway, GroupGateway
from ..rpc.server import (JSONRPC_GROUP_NOT_FOUND, JSONRPC_INVALID_PARAMS,
                          JsonRpcError, JsonRpcImpl, JsonRpcServer,
                          handle_payload_with)
from ..utils.log import LOG, badge
from .node import Node, NodeConfig


class GroupManager:
    """Hosts one Node per group on shared gateway/crypto/storage planes.

    `storage`: optional TransactionalStorage every group shares through a
    per-group `NamespacedStorage` view (one WAL). Without it each group
    builds its own store from its config (memory, or its storage_path).

    The shared crypto lane engages when the configs ask for it
    (`NodeConfig.crypto_lane`, default on): each group's Node receives a
    `LaneSuite` tagged with its group id over a per-crypto-kind lane.
    """

    def __init__(self, shared_gateway: Optional[Gateway] = None,
                 chain_id: str = "chain0", storage=None,
                 xshard: bool = True):
        from ..utils.health import HealthFanout

        self.chain_id = chain_id
        self.shared_gateway = shared_gateway
        self.shared_storage = storage
        self._nodes: dict[str, Node] = {}
        self._lock = threading.Lock()
        self._lanes: dict[str, "object"] = {}  # crypto kind -> CryptoLane
        # shared-plane faults (crypto lane death, shared-store ENOSPC) fan
        # into EVERY hosted group's health — one sick shared plane means
        # every group's pipeline is sick
        self.health_fanout = HealthFanout()
        from ..storage.wal import _SpaceHealth
        if isinstance(storage, _SpaceHealth) and storage.health is None:
            storage.health = self.health_fanout
        self.coordinator = None
        if xshard:
            from .xshard import CrossShardCoordinator
            self.coordinator = CrossShardCoordinator(self)

    # -- shared crypto lane ------------------------------------------------
    def _lane_suite(self, config: NodeConfig):
        """LaneSuite over the per-kind shared lane (created on first use)."""
        from ..crypto.lane import CryptoLane, LaneSuite
        from ..crypto.suite import make_suite

        kind = "sm" if config.sm_crypto else "ecdsa"
        with self._lock:
            lane = self._lanes.get(kind)
            if lane is None:
                base = make_suite(
                    config.sm_crypto, backend=config.crypto_backend,
                    device=config.device,
                    device_min_batch=config.device_min_batch,
                    mesh_devices=config.crypto_mesh_devices)
                lane = CryptoLane(base, wait_ms=config.crypto_lane_wait_ms)
                lane.on_fault.append(self._on_lane_fault)
                self._lanes[kind] = lane
        return LaneSuite(lane, tag=config.group_id)

    def _on_lane_fault(self, event: str, msg: str) -> None:
        """Dispatcher death/recovery on a shared lane -> the health plane
        of every hosted group (the lane self-heals on the next submission;
        the fault window must still be visible). The probe clears a stale
        fault even if a racing revival's "recovered" landed first."""
        if event == "died":
            if self._lanes_ok():
                return  # stale event: the lane already revived
            self.health_fanout.degraded("crypto.lane", msg,
                                        probe=self._lanes_ok)
        elif self._lanes_ok():
            # only clear when EVERY lane kind is back: one lane reviving
            # must not mask a sibling lane that is still dead (the probe
            # applies the same all-lanes rule)
            self.health_fanout.clear("crypto.lane")

    def _lanes_ok(self) -> bool:
        with self._lock:
            lanes = list(self._lanes.values())
        return all(lane.dispatcher_ok() for lane in lanes)

    def crypto_lane_stats(self) -> dict:
        with self._lock:
            lanes = dict(self._lanes)
        return {kind: lane.stats() for kind, lane in lanes.items()}

    # -- registry ----------------------------------------------------------
    def add_group(self, config: NodeConfig, keypair=None, suite=None) -> Node:
        if config.chain_id != self.chain_id:
            raise ValueError(f"chain mismatch: {config.chain_id}")
        if suite is None and config.crypto_lane:
            suite = self._lane_suite(config)
        storage = None
        if self.shared_storage is not None:
            from ..storage.namespace import (NamespacedStorage,
                                             namespace_block_id)
            # the 2PC block-id fold is a 16-bit group tag: two colliding
            # group ids would silently overwrite each other's PREPARED
            # changesets in the shared store (groups advance heights in
            # lockstep) — refuse the registration instead
            tag = namespace_block_id(config.group_id, 0)
            with self._lock:
                for gid in self._nodes:
                    if namespace_block_id(gid, 0) == tag:
                        raise ValueError(
                            f"group id {config.group_id!r} collides with "
                            f"{gid!r} in the shared store's 2PC id space; "
                            "rename the group")
            storage = NamespacedStorage(self.shared_storage, config.group_id)
        with self._lock:
            if config.group_id in self._nodes:
                raise ValueError(f"group exists: {config.group_id}")
            # socket transports authenticate sessions by the real node
            # key, so group separation rides the FRAME (MuxGateway.view);
            # the in-process FakeGateway namespaces node ids instead
            gw = None
            if self.shared_gateway is not None:
                gw = (self.shared_gateway.view(config.group_id)
                      if hasattr(self.shared_gateway, "view")
                      else GroupGateway(self.shared_gateway,
                                        config.group_id))
            node = Node(config, keypair=keypair, suite=suite, gateway=gw,
                        storage=storage)
            node.group_registry = self
            self._nodes[config.group_id] = node
            self.health_fanout.add(node.health)
        if self.coordinator is not None:
            self.coordinator.attach(config.group_id, node)
        LOG.info(badge("GROUPMGR", "group-added", group=config.group_id))
        return node

    def remove_group(self, group_id: str) -> bool:
        with self._lock:
            node = self._nodes.pop(group_id, None)
        if node is None:
            return False
        self.health_fanout.remove(node.health)
        node.stop()
        return True

    def node(self, group_id: str) -> Optional[Node]:
        with self._lock:
            return self._nodes.get(group_id)

    def groups(self) -> list[str]:
        with self._lock:
            return sorted(self._nodes)

    def health_snapshot(self) -> dict:
        """Process-level /healthz document: worst state across the hosted
        groups, faults prefixed by group id."""
        from ..utils.health import _RANK
        state, faults = "ok", {}
        for gid in self.groups():
            node = self.node(gid)
            if node is None:
                continue
            snap = node.health.snapshot()
            if _RANK[snap["state"]] > _RANK[state]:
                state = snap["state"]
            for comp, f in snap["faults"].items():
                faults[f"{gid}:{comp}"] = f
        return {"state": state, "faults": faults}

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        with self._lock:
            nodes = list(self._nodes.values())
        for n in nodes:
            n.start()
        if self.coordinator is not None:
            self.coordinator.start()

    def stop(self) -> None:
        if self.coordinator is not None:
            self.coordinator.stop()
        with self._lock:
            nodes = list(self._nodes.values())
            lanes = list(self._lanes.values())
        for n in nodes:
            n.stop()
        for lane in lanes:
            lane.stop()


# registry-wide methods answered without a group param (the per-group impls
# are registry-aware too, so any group's impl renders the full view)
_NO_GROUP_METHODS = {"getGroupList", "getGroupInfoList", "getPeers"}


class GroupedJsonRpc:
    """One RPC surface over many groups: routes by the `group` param.

    The reference's RPC holds a GroupManager and resolves (group, node) to
    the right service client (bcos-rpc/groupmgr/GroupManager.cpp); here it
    resolves to an in-process per-group JsonRpcImpl, each wired with its
    OWN commit-coherent query cache (rpc/cache.py) so G groups' hot
    responses never evict each other and invalidation stays per-group.

    Duck-compatible with `JsonRpcImpl` where the transports need it:
    `handle` / `handle_payload` / `max_batch` for the HTTP edge and batch
    framing, `.node` (the default group) for the WS server's
    eventsub/AMOP planes.
    """

    def __init__(self, mgr: GroupManager, default_group: str = ""):
        self.mgr = mgr
        self.default_group = default_group
        self._impls: dict[str, JsonRpcImpl] = {}
        self._lock = threading.Lock()

    # -- transport compatibility surface -----------------------------------
    @property
    def node(self):
        """Default group's node (WS eventsub/AMOP bind here)."""
        gid = self.default_group or (self.mgr.groups() or [""])[0]
        return self.mgr.node(gid)

    @property
    def max_batch(self) -> int:
        node = self.node
        return getattr(getattr(node, "config", None), "rpc_max_batch", 256)

    def handle_payload(self, payload):
        return handle_payload_with(self, payload, self.max_batch)

    # -- routing -----------------------------------------------------------
    def _impl(self, group: str) -> JsonRpcImpl:
        node = self.mgr.node(group)
        if node is None:
            raise JsonRpcError(JSONRPC_GROUP_NOT_FOUND,
                               f"unknown group {group}")
        with self._lock:
            impl = self._impls.get(group)
            if impl is not None and impl.node is node:
                return impl
            # per-group query cache behind the shared edge: nodes composed
            # without their own RPC server (rpc_port=None) get theirs
            # wired on first routed request (Node.make_rpc_impl is the
            # single home of the commit-coherence wiring)
            impl = node.make_rpc_impl()
            self._impls[group] = impl
            return impl

    def handle(self, request: dict) -> dict:
        rid = request.get("id")
        method = request.get("method", "")
        params = request.get("params", [])
        try:
            if method in _NO_GROUP_METHODS:
                return self._impl_default().handle(request)
            group = None
            if isinstance(params, list) and params:
                group = params[0]
            elif isinstance(params, dict):
                group = params.get("group")
            if not isinstance(group, str):
                return {"jsonrpc": "2.0", "id": rid,
                        "error": {"code": JSONRPC_INVALID_PARAMS,
                                  "message": "missing group parameter"}}
            if method == "getGroupInfo" and self.mgr.node(group) is None:
                # registry miss on the info method answers like the
                # reference: a group-not-found error object, same code
                # HTTP and WS (tested for parity)
                raise JsonRpcError(JSONRPC_GROUP_NOT_FOUND,
                                   f"unknown group {group}")
            return self._impl(group).handle(request)
        except JsonRpcError as exc:
            return {"jsonrpc": "2.0", "id": rid,
                    "error": {"code": exc.code, "message": exc.message}}

    def _impl_default(self) -> JsonRpcImpl:
        gid = self.default_group or (self.mgr.groups() or [""])[0]
        return self._impl(gid)

    def serve(self, host: str = "127.0.0.1", port: int = 0,
              pool=None, keepalive_s: float = 60.0) -> JsonRpcServer:
        srv = JsonRpcServer(self, host=host, port=port, pool=pool,
                            keepalive_s=keepalive_s)
        srv.start()
        return srv
