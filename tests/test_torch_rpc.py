"""The port's JSON-RPC edge (rpc/server.py, rpc/edge.py, rpc/cache.py,
rpc/admission.py, sdk/client.py) against the JAX package's: a solo Node of
each package with `rpc_port=0`, the same signed txs sent through each
package's own SdkClient, and the replies compared.

  * the lifecycle: receipts, blocks (roots and tx lists; not header
    hashes, which carry the seal time), `call`, tx and receipt proofs;
  * JSON-RPC 2.0 batch framing: empty batch, over the cap, notifications,
    order, per-id errors, a parse error;
  * the error codes: -32004 for an unknown group, -32601 for an unknown
    method, the rate-limit reply;
  * the query cache: hits, LRU eviction with generation fencing, and
    invalidation on a commit rollback;
  * `getProof` documents and `verifyProofs` verdicts, tampered proofs
    included.

The nodes run on crypto_backend "host" (the port's suite on device="cpu"),
on both chains where the chain matters. Every node is stopped in
`finally`; every server binds port 0 on 127.0.0.1.
"""

import contextlib
import http.client
import json
import time

import pytest
import torch

import test_torch_pbft as pb  # tests/ is on sys.path under pytest

CHAINS = ("ecdsa", "sm")
JAX = "fisco_bcos_tpu"


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def node_config(root: str, kind: str = "ecdsa", **kw):
    """A solo node's config of the package at `root` on its host suite,
    the profiler disarmed unless `kw` arms it."""
    N = pb.mod(root, "init.node")
    base = dict(sm_crypto=kind == "sm", crypto_backend="host", min_seal_time=0.0,
                profile_hz=0)
    if root == JAX:
        base["scheduler_workers"] = 0
    else:
        base["device"] = "cpu"
    base.update(kw)
    return N.NodeConfig(**base)


@contextlib.contextmanager
def serving(root: str, kind: str = "ecdsa", **kw):
    """A started solo Node of the package at `root` (the sealer key is
    the same secret in both packages), stopped on exit."""
    N = pb.mod(root, "init.node")
    jkeys, pkeys = pb.node_keys(kind, 1)
    node = N.Node(node_config(root, kind, **kw), keypair=(jkeys if root == JAX else pkeys)[0])
    node.start()
    try:
        yield node
    finally:
        node.stop()


def client(root: str, node):
    return pb.mod(root, "sdk.client").SdkClient(f"http://{node.rpc.host}:{node.rpc.port}")


def user_key(kind: str):
    return pb.node_keys(kind, 5)[0][4]


def frames(kind: str, calls, tag: str):
    """Wire frames of balance-precompile txs signed on the JAX host suite
    (RFC 6979 on the default chain; the port decodes the same bytes).
    `calls` holds (method, args) with args of blobs and u64s."""
    from fisco_bcos_tpu.executor import precompiled as pc
    from fisco_bcos_tpu.protocol import Transaction

    suite, _ = pb.host_suites(kind)
    kp = user_key(kind)
    out = []
    for i, (method, args) in enumerate(calls):
        def enc(w, args=args):
            for a in args:
                (w.blob(a) if isinstance(a, bytes) else w.u64(a))
        tx = Transaction(to=pc.BALANCE_ADDRESS, nonce=f"{tag}-{i}", block_limit=100,
                         input=pc.encode_call(method, enc)).sign(suite, kp)
        out.append(tx.encode())
    return out


def send_wave(root: str, node, sdk, wires):
    """One JSON-RPC batch of sendTransaction (wait=false), then every
    receipt. -> the tx hashes in order."""
    resps = sdk.request_batch([("sendTransaction", ["group0", "", "0x" + w.hex(), False,
                                                    False]) for w in wires])
    hashes = [r["result"]["transactionHash"] for r in resps]
    for h in hashes:
        assert node.txpool.wait_for_receipt(bytes.fromhex(h[2:]), 30) is not None
    return hashes


VOLATILE_BLOCK = ("hash", "timestamp", "signatureList", "parentInfo")


def steady(block: dict) -> dict:
    """A block's JSON without what carries the seal time: its hash, the
    timestamp, the seals and the parent's hash; each tx without its pool
    import time."""
    out = {k: v for k, v in block.items() if k not in VOLATILE_BLOCK}
    if "transactions" in out:
        out["transactions"] = [t if isinstance(t, str) else
                               {k: v for k, v in t.items() if k != "importTime"}
                               for t in out["transactions"]]
    return out


REGISTERS = [("register", (b"alice", 100)), ("register", (b"bob", 5)),
             ("register", (b"carol", 7)), ("register", (b"dave", 1))]
TRANSFERS = [("transfer", (b"alice", b"bob", 30)), ("transfer", (b"bob", b"alice", 10 ** 6)),
             ("transfer", (b"carol", b"dave", 7))]


def lifecycle(root: str, kind: str):
    """Two waves over RPC (registers, then transfers with one reverting),
    each a block of its own, then every read the lifecycle covers."""
    with serving(root, kind, rpc_port=0, tx_count_limit=len(REGISTERS),
                 min_seal_time=0.5) as node:
        sdk = client(root, node)
        try:
            waves = [send_wave(root, node, sdk, frames(kind, REGISTERS, "reg")),
                     send_wave(root, node, sdk, frames(kind, TRANSFERS, "xfer"))]
            hashes = [h for w in waves for h in w]
            out = dict(number=sdk.get_block_number())
            out["blocks"] = [steady(sdk.get_block_by_number(n)) for n in (1, 2)]
            out["headers"] = [steady(sdk.get_block_by_number(n, only_header=True))
                              for n in (1, 2)]
            out["receipts"] = [sdk.get_transaction_receipt(h, require_proof=True)
                               for h in hashes]
            out["txs"] = [{k: v for k, v in sdk.get_transaction(h, require_proof=True).items()
                           if k != "importTime"} for h in hashes]
            pc = pb.mod(root, "executor.precompiled")
            out["balances"] = [sdk.call(pc.BALANCE_ADDRESS, pc.encode_call(
                "balanceOf", lambda w, a=a: w.blob(a))) for a in (b"alice", b"bob", b"carol",
                                                                   b"dave", b"nobody")]
            out["counts"] = sdk.get_total_transaction_count()
            return out
        finally:
            sdk.close()


@pytest.mark.parametrize("kind", CHAINS)
def test_rpc_lifecycle_matches_jax(kind):
    want = lifecycle(JAX, kind)
    got = lifecycle("fisco_bcos_tpu_torch", kind)
    assert got == want
    assert got["number"] == 2
    assert [len(b["transactions"]) for b in got["blocks"]] == [4, 3]
    assert [r["status"] != 0 for r in got["receipts"]] == [False] * 5 + [True, False]
    assert all(len(r["receiptProof"]) == 1 for r in got["receipts"])
    reader = pb.mod("fisco_bcos_tpu_torch", "codec.wire").Reader
    assert [reader(bytes.fromhex(b["output"][2:])).u64() for b in got["balances"][:4]] == \
        [70, 35, 0, 8]


# -- batch framing -----------------------------------------------------------

def post_raw(node, body: bytes) -> bytes:
    conn = http.client.HTTPConnection(node.rpc.host, node.rpc.port, timeout=30)
    try:
        conn.request("POST", "/", body=body, headers={"Content-Type": "application/json"})
        return conn.getresponse().read()
    finally:
        conn.close()


def _req(i, method="getBlockNumber", params=("group0", "")):
    out = {"jsonrpc": "2.0", "method": method, "params": list(params)}
    if i is not None:
        out["id"] = i
    return out


FRAMING = {
    "empty": b"[]",
    "over_cap": json.dumps([_req(i) for i in range(257)]).encode(),
    "at_cap": json.dumps([_req(i) for i in range(256)]).encode(),
    "notifications": json.dumps([_req(None), _req(None, "getPendingTxSize")]).encode(),
    "one_notification": json.dumps(_req(None)).encode(),
    "order": json.dumps([_req(3, "getPendingTxSize"), _req("b"), _req(1, "getGroupList", ()),
                         _req(None), _req(2, "getBlockNumber")]).encode(),
    "per_id_errors": json.dumps([_req(1), _req(2, "noSuchMethod", ()), 42,
                                 _req(3, params=("wrong-group", "")),
                                 {"jsonrpc": "2.0", "id": 4},
                                 _req(5, "getBlockByNumber", ("group0", "", 0, 1, 2, 3, 4, 5))
                                 ]).encode(),
    "parse_error": b"{not json",
}


@pytest.fixture(scope="module")
def node_pair():
    with serving(JAX, rpc_port=0) as j, serving("fisco_bcos_tpu_torch", rpc_port=0) as p:
        yield j, p


@pytest.mark.parametrize("case", sorted(FRAMING))
def test_batch_framing_matches_jax(node_pair, case):
    j, p = node_pair
    want, got = post_raw(j, FRAMING[case]), post_raw(p, FRAMING[case])
    assert got == want
    if case in ("notifications", "one_notification"):
        assert got == b""
        return
    out = json.loads(got)
    if case in ("empty", "over_cap", "parse_error"):
        assert isinstance(out, dict) and out["id"] is None
        assert out["error"]["code"] == (-32700 if case == "parse_error" else -32600)
    elif case == "order":
        assert [r["id"] for r in out] == [3, "b", 1, 2]
    elif case == "per_id_errors":
        assert [(r["id"], r.get("error", {}).get("code")) for r in out] == [
            (1, None), (2, -32601), (None, -32600), (3, -32004), (4, -32600), (5, -32602)]
    else:
        assert len(out) == 256


# -- error codes -------------------------------------------------------------

def _errors(root: str, case: str):
    kw = dict(rpc_port=0)
    if case == "rate_limited":
        kw.update(client_write_rate=1.0, client_write_burst=1.0)
    with serving(root, **kw) as node:
        sdk = client(root, node)
        err = pb.mod(root, "sdk.client").RpcCallError
        try:
            if case == "unknown_group":
                calls = [("getBlockNumber", ["group9", ""]),
                         ("getGroupInfo", ["group9"])]
            elif case == "unknown_method":
                calls = [("getBlockNumberz", ["group0", ""]), ("eth_call", [])]
            else:
                w = frames("ecdsa", REGISTERS[:3], "rl")
                calls = [("sendTransaction", ["group0", "", "0x" + x.hex(), False, False])
                         for x in w]
            out = []
            for method, params in calls:
                try:
                    r = sdk.request(method, params)
                    out.append(("ok", r["status"] if isinstance(r, dict) else r))
                except err as exc:
                    out.append((exc.code, str(exc)))
            return out, (node.admission.stats()["rejected_writes"]
                         if node.admission is not None else None)
        finally:
            sdk.close()


@pytest.mark.parametrize("case", ["unknown_group", "unknown_method", "rate_limited"])
def test_error_codes_match_jax(case):
    want = _errors(JAX, case)
    got = _errors("fisco_bcos_tpu_torch", case)
    assert got == want
    codes = [c for c, _ in got[0]]
    if case == "unknown_group":
        assert codes == [-32004, -32004]
    elif case == "unknown_method":
        assert codes == [-32601, -32601]
    else:
        assert codes == ["ok", -32005, -32005] and got[1] == 2


# -- the query cache -----------------------------------------------------------

CACHE_KEYS = ("entries", "hits", "misses", "generation", "invalidations")


def _cache_hits(root: str):
    """The same reads twice: the first misses or hits the commit-time
    prime, the second hits; identical bytes each time."""
    with serving(root, rpc_port=0, tx_count_limit=4, min_seal_time=0.5) as node:
        sdk = client(root, node)
        try:
            hashes = send_wave(root, node, sdk, frames("ecdsa", REGISTERS, "hit"))
            deadline = time.monotonic() + 10
            while node.zk.stats()["proofsRendered"] < 4 and time.monotonic() < deadline:
                time.sleep(0.01)
            before = {k: node.query_cache.stats()[k] for k in CACHE_KEYS}
            bodies = []
            for _ in range(2):
                for h in hashes[:2]:
                    bodies.append(post_raw(node, json.dumps(_req(
                        7, "getTransactionReceipt", ("group0", "", h))).encode()))
                bodies.append(post_raw(node, json.dumps(_req(
                    8, "getBlockByNumber", ("group0", "", 1, False, True))).encode()))
            after = {k: node.query_cache.stats()[k] for k in CACHE_KEYS}
            assert bodies[:3] == bodies[3:]
            return before, after, [json.loads(b)["result"]["transactionHash"]
                                   for b in bodies[:2]]
        finally:
            sdk.close()


def _cache_lru(root: str):
    QueryCache = pb.mod(root, "rpc.cache").QueryCache
    c = QueryCache(max_entries=2)
    g = c.generation()
    c.put("a", {"v": 1}, g)
    c.put("b", {"v": 2}, g)
    seen = [c.get("a")]
    c.put("c", {"v": 3}, g)
    seen += [c.get("b"), c.get("a"), c.get("c")]
    stale = c.generation()
    c.invalidate()
    c.put("d", {"v": 4}, stale)
    c.put("e", {"v": 5}, c.generation())
    seen += [c.get("d"), c.get("e")]
    return seen, {k: c.stats()[k] for k in CACHE_KEYS}


def _cache_rollback(root: str):
    """One injected storage-commit failure: the scheduler rolls back and
    invalidates the cache, the solo chain retries, and the reads after it
    serve the committed state."""
    with serving(root, rpc_port=0) as node:
        sdk = client(root, node)
        pc = pb.mod(root, "executor.precompiled")

        def balance(a):
            out = sdk.call(pc.BALANCE_ADDRESS, pc.encode_call("balanceOf", lambda w: w.blob(a)))
            return out["output"]

        try:
            w = frames("ecdsa", REGISTERS[:2], "rb")
            send_wave(root, node, sdk, w[:1])
            blk1 = steady(sdk.get_block_by_number(1))
            first = balance(b"alice")
            inv0 = node.query_cache.stats()["invalidations"]
            orig, tripped = node.storage.commit, []

            def flaky(number):
                if not tripped:
                    tripped.append(number)
                    raise RuntimeError("injected commit failure")
                return orig(number)

            node.storage.commit = flaky
            send_wave(root, node, sdk, w[1:])
            node.storage.commit = orig
            return (tripped, node.query_cache.stats()["invalidations"] > inv0, first,
                    balance(b"bob"), steady(sdk.get_block_by_number(1)) == blk1,
                    sdk.get_block_number())
        finally:
            sdk.close()


CACHE_CASES = {"hit": _cache_hits, "lru_eviction": _cache_lru, "rollback": _cache_rollback}


@pytest.mark.parametrize("case", sorted(CACHE_CASES))
def test_query_cache_matches_jax(case):
    want = CACHE_CASES[case](JAX)
    got = CACHE_CASES[case]("fisco_bcos_tpu_torch")
    assert got == want
    if case == "hit":
        before, after, _ = got
        assert after["hits"] - before["hits"] == 6 and after["misses"] == before["misses"]
    elif case == "lru_eviction":
        seen, stats = got
        assert seen == [{"v": 1}, None, {"v": 1}, {"v": 3}, None, {"v": 5}]
        assert stats["invalidations"] == 1 and stats["entries"] == 1
    else:
        assert got[0] and got[1] and got[4] and got[5] == 2


# -- getProof and verifyProofs ---------------------------------------------------

def _flip(h: str) -> str:
    return h[:-1] + ("0" if h[-1] != "0" else "1")


def tampered(items):
    """Items 2, 4 and 8 of every ten broken: a sibling, the position (a
    tx proof's: a block's register receipts are equal, so a receipt's
    neighbour slot holds the same digest), the root."""
    out = []
    for i, it in enumerate(items):
        it = json.loads(json.dumps(it))
        k = i % 10
        if k == 2 and it["proof"]:
            it["proof"][0]["siblings"][-1] = _flip(it["proof"][0]["siblings"][-1])
        elif k == 4 and it["proof"]:
            it["proof"][0]["index"] = (it["proof"][0]["index"] + 1) % 16
        elif k == 8:
            it["root"] = _flip(it["root"])
        out.append(it)
    return out


def _proofs(root: str, kind: str):
    with serving(root, kind, rpc_port=0, tx_count_limit=4, min_seal_time=0.5) as node:
        sdk = client(root, node)
        try:
            hashes = send_wave(root, node, sdk, frames(kind, REGISTERS, "pf"))
            hashes += send_wave(root, node, sdk, frames(kind, TRANSFERS, "pf2"))
            docs = [sdk.request("getProof", ["group0", "", h]) for h in hashes]
            docs.append(sdk.request("getProof", ["group0", "", "0x" + "ab" * 32]))
            items = []
            for h, d in zip(hashes, docs):
                rc = sdk.get_transaction_receipt(h)
                items.append({"leaf": h, "proof": d["txProof"], "root": d["txsRoot"]})
                items.append({"leaf": "0x" + node.ledger.receipt(bytes.fromhex(h[2:])).hash(
                    node.suite).hex(), "proof": d["receiptProof"], "root": d["receiptsRoot"]})
                assert rc["transactionHash"] == h
            verdicts = sdk.request("verifyProofs", ["group0", "", tampered(items)])
            return docs, verdicts, node.zk.stats()
        finally:
            sdk.close()


@pytest.mark.parametrize("kind", CHAINS)
def test_get_proof_and_verify_proofs_match_jax(kind):
    want = _proofs(JAX, kind)
    got = _proofs("fisco_bcos_tpu_torch", kind)
    assert got == want
    docs, verdicts, zk = got
    assert [d["found"] for d in docs] == [True] * 7 + [False]
    n = len(verdicts["results"])
    assert n == 14
    assert verdicts["results"] == [i % 10 not in (2, 4, 8) for i in range(n)]
    assert verdicts["verified"] == sum(verdicts["results"])
    assert zk["proofsRendered"] == 7 and zk["verifyCalls"] == 1
