"""The port's multi-group hosting (init/group.py: GroupManager,
GroupedJsonRpc) against the JAX package's: every case of
tests/test_multigroup.py run on each package with the same signed txs
(the gateway's group isolation, two independent chains behind one routed
RPC, the group methods over the live registry, the unknown-group error
over HTTP and WS, one query cache a group behind one edge, the metrics'
group labels), the port's answers held equal to the JAX package's; then
the port's shared crypto lane: two groups' requests merged into one call
of the base suite, which runs on the config's device.

The nodes run crypto_backend "host" (the port's on device "cpu").
"""

import json
import time
import urllib.request

import pytest
import torch

import test_torch_lane as tl  # tests/ is on sys.path under pytest
from fisco_bcos_tpu.crypto.suite import make_suite as jmake_suite
from fisco_bcos_tpu.executor import precompiled as jpc
from fisco_bcos_tpu.protocol import Transaction as JTransaction

PKGS = ("jax", "port")


def mods(pkg):
    """The package's modules these cases use, by short name."""
    import importlib

    root = "fisco_bcos_tpu" if pkg == "jax" else "fisco_bcos_tpu_torch"
    names = {"group": "init.group", "node": "init.node", "gateway": "net.gateway",
             "server": "rpc.server", "ws": "rpc.ws_server", "sdkc": "sdk.client",
             "sdkws": "sdk.ws", "metrics": "utils.metrics", "proto": "protocol",
             "memory": "storage.memory"}
    return {k: importlib.import_module(f"{root}.{v}") for k, v in names.items()}


def config(pkg, gid):
    m = mods(pkg)
    kw = {} if pkg == "jax" else {"device": "cpu"}
    return m["node"].NodeConfig(group_id=gid, crypto_backend="host", min_seal_time=0.0,
                                profile_hz=0, **kw)


def manager(pkg, shared_storage=True):
    m = mods(pkg)
    mgr = m["group"].GroupManager(
        storage=m["memory"].MemoryStorage() if shared_storage else None)
    nodes = [mgr.add_group(config(pkg, g)) for g in ("group0", "group1")]
    mgr.start()
    return mgr, nodes


_JSUITE = jmake_suite(backend="host")
_USER = _JSUITE.generate_keypair(b"mg-user")


def signed(name: bytes, nonce: str, gid: str = "group0") -> bytes:
    """One register tx signed on the JAX host suite, as wire bytes."""
    return JTransaction(to=jpc.BALANCE_ADDRESS, nonce=nonce, group_id=gid, block_limit=100,
                        input=jpc.encode_call("register", lambda w: w.blob(name).u64(42))
                        ).sign(_JSUITE, _USER).encode()


def submit(pkg, node, frame: bytes, timeout=30):
    tx = mods(pkg)["proto"].Transaction.decode(frame)
    r = node.send_transaction(tx)
    return node.txpool.wait_for_receipt(r.tx_hash, timeout)


def _http_rpc(port, method, params, rid=1):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/",
        data=json.dumps({"jsonrpc": "2.0", "id": rid, "method": method,
                         "params": params}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as f:
        return json.load(f)


@pytest.fixture(params=PKGS)
def grouped_pair(request):
    mgr, (n1, n2) = manager(request.param)
    yield request.param, mgr, n1, n2
    mgr.stop()


def _isolation(pkg):
    m = mods(pkg)
    shared = m["gateway"].FakeGateway()
    g1, g2 = m["gateway"].GroupGateway(shared, "g1"), m["gateway"].GroupGateway(shared, "g2")
    got = {"g1": [], "g2": []}

    def front(tag):
        class F:
            def on_network_message(self, src, data):
                got[tag].append((src, data))
        return F()

    try:
        g1.register_front(b"A" * 32, front("g1"))
        g1.register_front(b"B" * 32, front("g1"))
        g2.register_front(b"A" * 32, front("g2"))   # same node id, other group
        time.sleep(0.05)
        peers = (g1.peers(b"A" * 32), g2.peers(b"A" * 32))
        g1.broadcast(b"A" * 32, b"hello-g1")
        deadline = time.time() + 5
        while not got["g1"] and time.time() < deadline:
            time.sleep(0.01)
        time.sleep(0.05)
        return peers, got
    finally:
        shared.stop()


def test_group_gateway_isolation_matches_jax():
    port = _isolation("port")
    assert port == _isolation("jax")
    assert port == (([b"B" * 32], []), {"g1": [(b"A" * 32, b"hello-g1")], "g2": []})


def _two_chains(pkg):
    m = mods(pkg)
    mgr, (n1, n2) = manager(pkg, shared_storage=False)
    try:
        rc = submit(pkg, n1, signed(b"a", "n1"))
        assert rc is not None and rc.status == 0
        deadline = time.time() + 5
        while n1.ledger.current_number() < 1 and time.time() < deadline:
            time.sleep(0.02)
        rpc = m["group"].GroupedJsonRpc(mgr)
        out = [rpc.handle({"jsonrpc": "2.0", "id": i, "method": meth, "params": p})
               for i, (meth, p) in enumerate([("getGroupList", []),
                                              ("getBlockNumber", ["group0"]),
                                              ("getBlockNumber", ["group1"]),
                                              ("getBlockNumber", ["nope"]),
                                              ("getBlockNumber", [])])]
        srv = rpc.serve(port=0)
        try:
            out.append(_http_rpc(srv.port, "getBlockNumber", ["group0"], 9))
        finally:
            srv.stop()
        return rc.status, [n1.ledger.current_number(), n2.ledger.current_number()], out
    finally:
        mgr.stop()


def test_two_groups_independent_chains_and_rpc_match_jax():
    port = _two_chains("port")
    assert port == _two_chains("jax")
    status, heights, out = port
    assert heights == [1, 0]
    assert out[0]["result"]["groupList"] == ["group0", "group1"]
    assert [o.get("result") for o in out[1:3]] == [1, 0]
    assert out[3]["error"]["code"] == mods("port")["server"].JSONRPC_GROUP_NOT_FOUND
    assert out[4]["error"]["code"] == mods("port")["server"].JSONRPC_INVALID_PARAMS
    assert out[5]["result"] == 1


def _registry_view(pkg, mgr, n1, n2):
    impl = mods(pkg)["server"].JsonRpcImpl(n1)
    info = impl.get_group_info("group1")
    assert info["genesisHash"] == "0x" + n2.ledger.header_by_number(0).hash(n2.suite).hex()
    lone = mgr.node("group0")
    reg, lone.group_registry = lone.group_registry, None
    try:
        alone = mods(pkg)["server"].JsonRpcImpl(lone).get_group_list()
    finally:
        lone.group_registry = reg
    return (impl.get_group_list(), [i["groupID"] for i in impl.get_group_info_list()],
            {k: v for k, v in info.items() if k != "genesisHash"}, alone)


def test_group_methods_enumerate_real_registry():
    views = {}
    for pkg in PKGS:
        mgr, (n1, n2) = manager(pkg)
        try:
            views[pkg] = _registry_view(pkg, mgr, n1, n2)
        finally:
            mgr.stop()
    assert views["port"] == views["jax"]
    assert views["port"][0] == {"groupList": ["group0", "group1"]}
    assert views["port"][1] == ["group0", "group1"]
    assert views["port"][3] == {"groupList": ["group0"]}


def _unknown_group_errors(pkg, mgr):
    m = mods(pkg)
    grouped = m["group"].GroupedJsonRpc(mgr)
    srv = grouped.serve(port=0)
    ws = m["ws"].WsRpcServer(grouped, port=0)
    ws.start()
    out = []
    try:
        for method, params in [("getBlockNumber", ["nope"]), ("getGroupInfo", ["nope"]),
                               ("sendTransaction", ["nope", "", "0x00"]),
                               ("getGroupPeers", ["nope"])]:
            out.append(_http_rpc(srv.port, method, params)["error"])
        out.append(_http_rpc(srv.port, "getBlockNumber", ["group1"])["result"])
        client = m["sdkws"].WsSdkClient("127.0.0.1", ws.port)
        try:
            out.append(client.request("getBlockNumber", ["group0"]))
            for method in ("getBlockNumber", "getGroupInfo"):
                with pytest.raises(m["sdkc"].RpcCallError) as exc:
                    client.request(method, ["nope"])
                out.append((exc.value.code, str(exc.value)))
            out.append(client.request("getGroupList", []))
        finally:
            client.close()
    finally:
        ws.stop()
        srv.stop()
    return out


def test_unknown_group_error_parity_http_and_ws(grouped_pair):
    pkg, mgr, n1, n2 = grouped_pair
    out = _unknown_group_errors(pkg, mgr)
    code = mods(pkg)["server"].JSONRPC_GROUP_NOT_FOUND
    assert all(e["code"] == code and "nope" in e["message"] for e in out[:4])
    assert out[4:6] == [0, 0] and [c for c, _ in out[6:8]] == [code, code]
    assert out[8]["groupList"] == ["group0", "group1"]
    if pkg == "port":   # the JAX package's answers, in a fresh manager of its own
        jmgr, _ = manager("jax")
        try:
            assert out == _unknown_group_errors("jax", jmgr)
        finally:
            jmgr.stop()


def test_per_group_query_caches_behind_one_edge(grouped_pair):
    pkg, mgr, n1, n2 = grouped_pair
    grouped = mods(pkg)["group"].GroupedJsonRpc(mgr)
    assert submit(pkg, n1, signed(b"c", "c1")) is not None
    req = {"jsonrpc": "2.0", "id": 1, "method": "getBlockByNumber",
           "params": ["group0", "", 1, False, False]}
    r1, r2 = grouped.handle(dict(req)), grouped.handle(dict(req))
    assert r1["result"] is not None and r1["result"] is r2["result"]   # the cached object
    grouped.handle({"jsonrpc": "2.0", "id": 2, "method": "getBlockNumber",
                    "params": ["group1"]})
    assert n1.query_cache is not None and n2.query_cache is not None
    assert n1.query_cache is not n2.query_cache
    assert n1.query_cache.stats()["hits"] >= 1 and n2.query_cache.stats()["hits"] == 0
    tx = r1["result"]["transactions"]
    assert len(tx) == 1 and tx[0]["hash"] == "0x" + mods(pkg)["proto"].Transaction.decode(
        signed(b"c", "c1")).hash(n1.suite).hex()


def test_metrics_carry_group_label_and_keep_totals(grouped_pair):
    pkg, mgr, n1, n2 = grouped_pair
    for node, gid in ((n1, "group0"), (n2, "group1")):
        assert submit(pkg, node, signed(b"m", f"m-{gid}", gid)) is not None
    text = mods(pkg)["metrics"].REGISTRY.prometheus_text()
    assert 'bcos_txpool_pending{group="group0"}' in text
    assert 'bcos_txpool_pending{group="group1"}' in text
    assert any(line.startswith("bcos_txpool_pending ") for line in text.splitlines())


def test_the_shared_lane_merges_two_groups_into_one_base_call():
    """Each group's Node holds a LaneSuite over the manager's one lane a
    crypto kind; two groups' concurrent verify requests reach the base
    suite as one call, and each gets what a direct call gives."""
    from fisco_bcos_tpu_torch.crypto.lane import LaneSuite

    mgr, (n1, n2) = manager("port")
    try:
        lane = mgr._lanes["ecdsa"]
        assert isinstance(n1.suite, LaneSuite) and n1.suite._lane is n2.suite._lane is lane
        assert lane.suite.device.type == "cpu" and lane.suite.backend == "host"
        counting = tl.CountingSuite(lane.suite)
        # one base call a drain: no host fan-out of the merged batch
        lane.suite, lane.host_workers = counting, 1
        digests = [bytes([i]) * 32 for i in range(6)]
        sigs = [_JSUITE.sign(_USER, d) for d in digests]
        sigs[2] = bytes(32) + sigs[2][32:]
        pubs = [_USER.pub_bytes] * 6
        got = tl.merged(counting, lane, [lambda s=s: s.verify_batch(digests, sigs, pubs)
                                         for s in (n1.suite, n2.suite)])
        assert counting.calls["verify"] == [12]   # one base call, both groups' lanes
        want = [True, True, False, True, True, True]
        assert [list(map(bool, g)) for g in got] == [want, want]
        stats = mgr.crypto_lane_stats()["ecdsa"]
        assert stats["merged_calls"] >= 1
        assert set(stats["per_tag_mean_batch"]) >= {"group0", "group1"}
    finally:
        mgr.stop()


def test_the_lane_base_suite_runs_on_the_config_device():
    """GroupManager._lane_suite passes the group config's device to
    make_suite: a lane on the CPU there; on the card by default, which
    without a card refuses to build rather than running on the CPU."""
    m = mods("port")
    mgr = m["group"].GroupManager(xshard=False)
    try:
        node = mgr.add_group(m["node"].NodeConfig(crypto_backend="auto", device="cpu",
                                                  profile_hz=0))
        assert node.suite._base.device.type == "cpu" and node.suite._base.backend == "auto"
        cfg = m["node"].NodeConfig(group_id="group1", crypto_backend="auto", sm_crypto=True,
                                   profile_hz=0)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                mgr.add_group(cfg)
    finally:
        mgr.stop()
