"""The port's own Node (init/node.py) against the JAX package's Node on the
JAX suite, from the same wire frames (test_torch_node_seam.batches): a
solo node on the port's tensor path (crypto_backend "device", device
"cpu"), a 4-node PBFT chain in the default `multi` seal mode on "auto",
and a chain the JAX Nodes started (a view change included, so its PBFT
log holds the new view) carried across with storage/carry.storage_from_jax,
on which the port's Nodes restart and commit the next height equal to a
JAX continuation. Compared: every block's state, tx and receipt roots
and the c_balance rows (header hashes carry the seal time), and within a
chain the header hashes across nodes. NodeConfig fields that select a
plane the port does not have yet must raise, the serving edge's fields
start their planes and answer as the JAX Node's do, the storage and
snapshot fields build their planes as the JAX Node does, snap sync
installs a peer's snapshot, and the default suite is on the card.
"""

import time

import pytest
import torch

import test_torch_columnar as frames  # tests/ is on sys.path under pytest
import test_torch_node_seam as seam
import test_torch_pbft as pb
from fisco_bcos_tpu.init import node as jnode
from fisco_bcos_tpu.storage.memory import MemoryStorage as JMemoryStorage
from fisco_bcos_tpu_torch.init import node as pnode
from fisco_bcos_tpu_torch.storage import storage_from_jax

ROOTS = pb.ROOTS


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _solo(root: str, kind: str, wires):
    """One solo Node of a package committing `wires` as block 1."""
    jkeys, pkeys = pb.node_keys(kind, 1)
    if root == "fisco_bcos_tpu":
        cfg = jnode.NodeConfig(sm_crypto=kind == "sm", crypto_backend="host",
                               min_seal_time=0.0, profile_hz=0, scheduler_workers=0)
        node = jnode.Node(cfg, keypair=jkeys[0])
    else:
        cfg = pnode.NodeConfig(sm_crypto=kind == "sm", crypto_backend="device",
                               device="cpu", min_seal_time=0.0)
        node = pnode.Node(cfg, keypair=pkeys[0])
        assert node.suite.backend == "device" and node.suite.device.type == "cpu"
    T = pb.mod(root, "protocol")
    node.build_genesis()
    try:
        node.start()
        res = node.txpool.submit_batch([T.Transaction.decode(w) for w in wires])
        assert [int(r.status) for r in res] == [0] * len(wires)
        assert pb.wait_until(lambda: node.ledger.current_number() >= 1)
        return pb.chain_state(root, node)
    finally:
        node.stop()


@pytest.mark.parametrize("kind", frames.CHAINS)
def test_solo_node_on_the_port_tensor_path_commits_the_jax_chain(kind):
    wires = seam.batches(kind)[0]
    want = _solo("fisco_bcos_tpu", kind, wires)
    got = _solo("fisco_bcos_tpu_torch", kind, wires)
    assert got == want
    heads, rows = got
    assert len(heads) == 1
    assert rows == {b"alice": (993).to_bytes(16, "big"), b"bob": (17).to_bytes(16, "big")}


@pytest.mark.parametrize("kind", frames.CHAINS)
def test_four_node_pbft_chain_commits_the_jax_chain(kind):
    """Two heights (two leaders) in the multi seal mode: the same roots
    and rows as the JAX Nodes' chain; every node the same header hashes,
    each header 2f+1 loose seals."""
    blocks = seam.batches(kind)
    want = pb.run_chain("fisco_bcos_tpu", kind, blocks)
    got = pb.run_chain("fisco_bcos_tpu_torch", kind, blocks)
    assert got[0] == want[0]
    assert all(s == got[0][0] for s in got[0]) and all(h == got[1][0] for h in got[1])
    heads, rows = got[0][0]
    assert len(heads) == 2 and len({h.sealer for h in got[3]}) == 2
    assert rows == {b"alice": (998).to_bytes(16, "big"), b"bob": (12).to_bytes(16, "big")}
    assert all(len(h.signature_list) >= 3 for h in got[3])
    assert {s["sealMode"] for s in got[2]} == {"multi"}


def _jax_chain_with_a_view_change(kind: str):
    """Height 1 committed by the JAX Nodes after its leader was partitioned
    (view 1), the leader healed and synced. -> each node's rows."""
    c = pb.Cluster("fisco_bcos_tpu", kind).start()
    try:
        leader = c.by_index(1)
        live = [n for n in c.nodes if n is not leader]
        c.gateway.partition(leader.keypair.pub_bytes)
        c.submit(seam.batches(kind)[0], nodes=live)
        c.wait(1, nodes=live)
        c.gateway.partition(leader.keypair.pub_bytes, isolated=False)
        c.wait(1)
    finally:
        c.stop()
    return [c.rows(n) for n in c.nodes]


def _continue(root: str, kind: str, rows):
    """The package's Nodes restarted on the carried rows commit height 2.
    -> (states, header hashes, the views the engines replayed)."""
    if root == "fisco_bcos_tpu":
        storages = []
        for r in rows:
            st = JMemoryStorage()
            for t, kv in r.items():
                for k, v in kv.items():
                    st.set(t, k, v)
            storages.append(st)
    else:
        storages = [storage_from_jax(r) for r in rows]
    c = pb.Cluster(root, kind, storages=storages).start()
    try:
        views = [n.consensus.view for n in c.nodes]
        c.submit(seam.batches(kind)[1])
        c.wait(2)
        return [c.state(n) for n in c.nodes], [c.header_hashes(n) for n in c.nodes], views
    finally:
        c.stop()


def test_chain_carried_from_jax_continues_on_the_port():
    kind = "ecdsa"
    rows = _jax_chain_with_a_view_change(kind)
    assert any(r.get("c_pbft_log", {}).get(b"view") == (1).to_bytes(8, "big") for r in rows)
    want = _continue("fisco_bcos_tpu", kind, rows)
    got = _continue("fisco_bcos_tpu_torch", kind, rows)
    assert got[0] == want[0] and got[2] == want[2]
    assert all(s == got[0][0] for s in got[0]) and all(h == got[1][0] for h in got[1])
    assert max(got[2]) == 1
    heads, balances = got[0][0]
    assert len(heads) == 2
    assert balances == {b"alice": (998).to_bytes(16, "big"), b"bob": (12).to_bytes(16, "big")}


UNPORTED = [("scheduler_workers", 1), ("groups", ["g1", "g2"])]
# the fields that start the serving edge's planes
SERVING = [("rpc_port", 0), ("ws_port", 0), ("metrics_port", 0), ("profile_hz", 5.0)]
# the fields that select the storage and snapshot planes
DURABLE = [("storage_path", "chain-dir"), ("storage_backend", "wal"),
           ("storage_backend", "disk"), ("snapshot_interval", 5),
           ("snapshot_prune", True), ("snap_sync_threshold", 256)]


@pytest.mark.parametrize("field,value", UNPORTED)
def test_unported_planes_raise(field, value):
    cfg = pnode.NodeConfig(crypto_backend="host", device="cpu", **{field: value})
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        pnode.Node(cfg)


def _first_answer(root: str, node, field: str):
    """The first request a client makes of the plane `field` started."""
    import http.client
    import json

    if field == "rpc_port":
        conn = http.client.HTTPConnection(node.rpc.host, node.rpc.port, timeout=30)
        try:
            conn.request("POST", "/", body=json.dumps({
                "jsonrpc": "2.0", "id": 1, "method": "getGroupInfo",
                "params": ["group0"]}).encode())
            doc = json.loads(conn.getresponse().read())
        finally:
            conn.close()
        doc["result"].pop("genesisHash")   # the genesis header carries its time
        return doc
    if field == "ws_port":
        cli = pb.mod(root, "sdk.ws").WsSdkClient(node.ws.host, node.ws.port)
        try:
            return [cli.get_block_number(), cli.request("getGroupList", [])]
        finally:
            cli.close()
    if field == "metrics_port":
        conn = http.client.HTTPConnection("127.0.0.1", node.metrics.port, timeout=30)
        try:
            conn.request("GET", "/healthz")
            r = conn.getresponse()
            return r.status, r.getheader("Content-Type"), json.loads(r.read())["state"]
        finally:
            conn.close()
    prof = pb.mod(root, "analysis.profiler").PROFILER
    st = prof.stats()
    return st["armed"], st["hz"], sorted(st), prof._thread.name


@pytest.mark.parametrize("field,value", SERVING)
def test_each_serving_field_starts_its_plane(field, value):
    """Each serving field starts its plane on the port's Node as on the
    JAX Node (an RPC edge, a WS server, a Prometheus endpoint, the
    sampler thread), and both answer a client's first request alike."""
    answers = []
    for root in pb.ROOTS:
        N = pb.mod(root, "init.node")
        extra = dict(scheduler_workers=0) if root == "fisco_bcos_tpu" else dict(device="cpu")
        cfg = dict(profile_hz=0.0)
        cfg[field] = value
        node = N.Node(N.NodeConfig(crypto_backend="host", min_seal_time=0.0, **extra, **cfg))
        try:
            node.start()
            planes = {"rpc_port": node.rpc, "ws_port": node.ws, "metrics_port": node.metrics}
            assert [k for k, v in planes.items() if v is not None] == \
                ([field] if field in planes else [])
            answers.append(_first_answer(root, node, field))
        finally:
            node.stop()
            pb.mod(root, "analysis.profiler").configure(hz=0)
    assert answers[1] == answers[0]
    if field == "profile_hz":
        assert answers[1][:2] == (True, 5.0)


@pytest.mark.parametrize("field,value", DURABLE)
def test_the_node_builds_the_storage_and_snapshot_planes(tmp_path, field, value):
    """Each storage and snapshot field builds its plane as the JAX Node
    builds it: the same storage stack (a path alone selects the WAL,
    "disk" key pages over the disk engine), and the snapshot service and
    block sync carrying the field."""
    built = []
    for root in pb.ROOTS:
        cfg = {field: value}
        if field == "storage_path":
            cfg[field] = str(tmp_path / root / value)
        elif field == "storage_backend":
            cfg["storage_path"] = str(tmp_path / root / value)
        N = pb.mod(root, "init.node")
        extra = dict(profile_hz=0, scheduler_workers=0) if root == "fisco_bcos_tpu" else \
            dict(device="cpu")
        gw = pb.mod(root, "net.gateway").FakeGateway()
        node = N.Node(N.NodeConfig(consensus="pbft", crypto_backend="host", **extra, **cfg),
                      gateway=gw)
        try:
            st = node.storage
            inner = getattr(st, "backend", None)
            snap = node.snapshot
            built.append(dict(storage=(type(st).__name__, type(inner).__name__ if inner
                                       else None),
                              snapshot_interval=snap.interval, snapshot_prune=snap.prune,
                              store_on_disk=snap.store.directory is not None,
                              snap_sync_threshold=node.blocksync.snap_sync_threshold))
        finally:
            node.stop()
            gw.stop()
            if hasattr(node.storage, "close"):
                node.storage.close()
    assert built[1] == built[0]
    stacks = {"storage_path": ("WalStorage", None), "storage_backend": {
        "wal": ("WalStorage", None), "disk": ("KeyPageStorage", "DiskStorage")}.get(value)}
    assert built[1]["storage"] == stacks.get(field, ("MemoryStorage", None))
    assert built[1]["store_on_disk"] == field.startswith("storage")
    if field in built[1]:
        assert built[1][field] == value


def _sync_node(**cfg):
    gw = pb.mod("fisco_bcos_tpu_torch", "net.gateway").FakeGateway()
    node = pnode.Node(pnode.NodeConfig(consensus="pbft", device="cpu", **cfg), gateway=gw)
    node.build_genesis()
    return gw, node


def test_snap_sync_raises_until_the_snapshot_plane_is_ported():
    """The snapshot plane is ported, so snap sync no longer raises:
    BlockSync._try_snap_sync installs a peer's snapshot. A joiner whose
    peer is past its threshold snap-syncs the peer's checkpoint; one on a
    threshold of 0 asks for the range, the pruned peer answers
    "pruned-below", and it snap-syncs too. Each then holds the peer's
    state at the checkpoint (head header hash, c_balance rows), is in
    "snap" mode and serves the adopted snapshot from its own store."""
    import test_torch_snapshot as snap

    root = "fisco_bcos_tpu_torch"
    c = snap.SingleSealer(root, "ecdsa", snapshot_interval=2, snapshot_prune=True,
                          snapshot_keep_tail=0, snapshot_chunk_bytes=snap.CHUNK)
    try:
        c.commit(1)
        c.commit(2)
        c.checkpointed(2)
        src = c.src
        peer = src.keypair.pub_bytes
        want = (src.ledger.header_by_number(2).hash(src.suite), snap.chain_state(root, src))
        for seed, threshold in ((b"far", 1), (b"pruned", 0)):
            node = c.joiner(seed, snap_sync_threshold=threshold)
            sync = node.blocksync
            sync._peers[peer] = (2, time.monotonic())
            sync._maybe_download()
            assert node.ledger.current_number() == 2 and sync.sync_mode == "snap"
            assert (node.ledger.header_by_number(2).hash(node.suite),
                    snap.chain_state(root, node)) == want
            assert node.snapshot.store.heights() == [2]
            assert node.snapshot.store.manifest(2).encode() == \
                src.snapshot.store.manifest(2).encode()
    finally:
        c.stop()


def test_a_node_far_behind_catches_up_by_replay():
    """On a snap_sync_threshold of 0 a lagging node replays whatever its
    distance, never reaching snap sync: a peer 257 blocks ahead (past the
    default of 256) gets a range request, and a node partitioned while the
    chain committed two heights replays them to the same headers and
    state."""
    sync_mod = pb.mod("fisco_bcos_tpu_torch", "sync.sync")
    W = pb.mod("fisco_bcos_tpu_torch", "codec.wire").Writer
    gw, node = _sync_node(snap_sync_threshold=0)
    try:
        sync = node.blocksync
        assert node.config.snap_sync_threshold == 0 == sync.snap_sync_threshold
        sync._peers[b"\x01" * 64] = (257, time.monotonic())
        asked = []
        sync.front.request = lambda module, dst, payload, timeout: asked.append(payload)
        sync._maybe_download()
        assert asked == [W().i64(1).i64(sync_mod.MAX_BLOCKS_PER_REQUEST).bytes()]
        assert sync.sync_mode == "replay"
    finally:
        node.stop()
        gw.stop()

    c = pb.Cluster("fisco_bcos_tpu_torch", "ecdsa").start()
    try:
        lagging = c.by_index(0)   # leads neither height 1 nor 2 in view 0
        live = [n for n in c.nodes if n is not lagging]
        c.gateway.partition(lagging.keypair.pub_bytes)
        for k, wires in enumerate(seam.batches("ecdsa")):
            c.submit(wires, nodes=live)
            c.wait(k + 1, nodes=live)
        assert lagging.ledger.current_number() == 0
        c.gateway.partition(lagging.keypair.pub_bytes, isolated=False)
        c.wait(2)
        assert lagging.blocksync.sync_mode == "replay"
        assert c.header_hashes(lagging) == c.header_hashes(live[0])
        assert c.state(lagging) == c.state(live[0])
    finally:
        c.stop()


def test_the_node_runs_on_the_card_unless_asked_for_the_cpu():
    """NodeConfig.device defaults to "cuda": without a card the node's
    suite refuses to build rather than running on the CPU; the sampling
    profiler's hz defaults to 5, as the JAX package's; the storage,
    snapshot and serving fields have the JAX package's defaults; and the
    settings of planes the port does not have are not fields at all."""
    cfg = pnode.NodeConfig()
    assert cfg.device == "cuda" and cfg.profile_hz == 5.0 and cfg.snap_sync_threshold == 256
    # the port keeps the JAX fields its planes read or refuse, plus device
    port_fields = set(pnode.NodeConfig.__dataclass_fields__)
    assert port_fields - set(jnode.NodeConfig.__dataclass_fields__) == {"device"}
    assert {"snap_sync_threshold", "rpc_port", "groups"} <= port_fields
    assert not port_fields & {"p2p_port", "p2p_peers", "crypto_lane"}
    durable = [f for f in port_fields if f.startswith(("storage_", "snapshot_", "snap_"))]
    assert len(durable) == 13 and "overload_compact_debt_mb" in port_fields
    serving = [f for f in port_fields if f.startswith(("rpc_", "sub_", "client_", "trace_",
                                                       "profile_"))]
    assert len(serving) == 20 and {"ws_port", "metrics_port"} <= port_fields
    jcfg = jnode.NodeConfig()
    for f in durable + serving + ["overload_compact_debt_mb", "ws_port", "metrics_port"]:
        assert getattr(cfg, f) == getattr(jcfg, f), f
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pnode.Node(cfg)
    node = pnode.Node(pnode.NodeConfig(device="cpu"))
    try:
        assert node.suite.device.type == "cpu" and node.suite.backend == "auto"
        assert node.front is None and node.blocksync is None and node.consensus is None
        assert node.rpc is None and node.ws is None and node.metrics is None
    finally:
        node.stop()
        pb.mod("fisco_bcos_tpu_torch", "analysis.profiler").configure(hz=0)
