"""The port's service RPC (services/rpc.py), storage service and
executor service against the JAX package's, over real sockets on
127.0.0.1: the framed round trip and its errors between every pair of
client and server packages; the RemoteStorage contract (reads, batch
reads, keys, 2PC) on a WAL backend; and a RemoteExecutor with DMC across
the packages in both directions (the port's client against the JAX
server and the reverse), the same signed block giving byte-equal
receipts and changesets, the port's server recovering the block's senders
in one batch (once on its tensor path) where the JAX server recovers one
tx at a time, and the term bump."""

import importlib
import itertools

import pytest

ROOTS = ("fisco_bcos_tpu", "fisco_bcos_tpu_torch")
JAX, PORT = ROOTS
PAIRS = list(itertools.product(ROOTS, ROOTS))   # (server package, client package)
IDS = [f"{s.rsplit('_', 1)[-1]}-server-{c.rsplit('_', 1)[-1]}-client" for s, c in PAIRS]


def mod(root: str, name: str):
    return importlib.import_module(f"{root}.{name}")


@pytest.mark.parametrize("server,client", PAIRS, ids=IDS)
def test_service_rpc_round_trip_and_errors_across_packages(server, client):
    R, C = mod(server, "services.rpc"), mod(client, "services.rpc")
    srv = R.ServiceServer("echo")
    srv.register("echo", lambda r, w: w.blob(r.blob()).u64(r.u64() + 1))

    def boom(r, w):
        raise ValueError("kaput")

    srv.register("boom", boom)
    srv.start()
    cli = C.ServiceClient("127.0.0.1", srv.port, timeout=30.0)
    try:
        r = cli.call("echo", lambda w: w.blob(b"hi").u64(41))
        assert (r.blob(), r.u64()) == (b"hi", 42)
        with pytest.raises(C.ServiceRemoteError, match="ValueError: kaput"):
            cli.call("boom")
        with pytest.raises(C.ServiceRemoteError, match="unknown method"):
            cli.call("nope")
        # the connection survives handler errors; a large payload crosses
        big = bytes(range(256)) * 4096
        assert cli.call("echo", lambda w: w.blob(big).u64(0)).blob() == big
    finally:
        cli.close()
        srv.stop()
    # a stopped service looks like a dead process to its client
    with pytest.raises((ConnectionError, OSError)):
        cli.call("echo", lambda w: w.blob(b"x").u64(0))
    assert C.MAX_FRAME == R.MAX_FRAME


def storage_contract(st, E) -> list:
    """The RemoteStorage contract's observations, in order."""
    out = []
    st.set("t", b"k", b"v")
    st.set("t", b"k2", b"v2")
    out += [st.get("t", b"k"), st.get("t", b"missing"), list(st.keys("t")),
            list(st.keys("t", b"k2")), st.get_batch("t", [b"k", b"zz", b"k2"])]
    st.prepare(3, {("t", b"k3"): E.Entry(b"v3"), ("t", b"k"): E.Entry(b"", E.EntryStatus.DELETED)})
    out.append((st.get("t", b"k3"), st.get("t", b"k")))
    st.commit(3)
    out.append((st.get("t", b"k3"), st.get("t", b"k")))
    st.prepare(4, {("t", b"k4"): E.Entry(b"v4")})
    st.rollback(4)
    out.append(st.get("t", b"k4"))
    st.remove("t", b"k2")
    out.append((st.get("t", b"k2"), list(st.keys("t"))))
    return out


@pytest.mark.parametrize("server,client", PAIRS, ids=IDS)
def test_remote_storage_contract_across_packages(tmp_path, server, client):
    srv = mod(server, "services.storage_service").StorageServer(
        mod(server, "storage.wal").WalStorage(str(tmp_path / "db")))
    srv.start()
    st = mod(client, "services.storage_service").RemoteStorage("127.0.0.1", srv.port)
    try:
        got = storage_contract(st, mod(client, "storage.interface"))
    finally:
        st.close()
        srv.stop()
        srv.backend.close()
    assert got == [b"v", None, [b"k", b"k2"], [b"k2"], [b"v", None, b"v2"], (None, b"v"),
                   (b"v3", None), None, (None, [b"k3"])]


def test_changeset_codec_is_the_jax_codec():
    from fisco_bcos_tpu.codec.wire import Reader as JR
    from fisco_bcos_tpu.codec.wire import Writer as JW
    from fisco_bcos_tpu_torch.codec.wire import Reader, Writer

    J, P = mod(JAX, "services.storage_service"), mod(PORT, "services.storage_service")
    PE = mod(PORT, "storage.interface")
    cs = {("t", b"a"): PE.Entry(b"1"), ("u", b"b" * 40): PE.Entry(b"", PE.EntryStatus.DELETED),
          ("t", b""): PE.Entry(bytes(300))}
    w = Writer()
    P._write_changeset(w, cs)
    back = J._read_changeset(JR(w.bytes()))
    assert {k: (e.value, e.deleted) for k, e in back.items()} == \
        {k: (e.value, e.deleted) for k, e in cs.items()}
    jw = JW()
    J._write_changeset(jw, back)
    assert jw.bytes() == w.bytes()
    again = P._read_changeset(Reader(jw.bytes()))
    assert {k: (e.value, e.deleted) for k, e in again.items()} == \
        {k: (e.value, e.deleted) for k, e in cs.items()}


def block_frames(kind: str, tag: str) -> list:
    """Registers, transfers (one reverting) and a balanceOf, signed on the
    JAX host suite."""
    from fisco_bcos_tpu.crypto.suite import make_suite
    from fisco_bcos_tpu.executor import precompiled as pc
    from fisco_bcos_tpu.protocol import Transaction

    suite = make_suite(kind == "sm", backend="host")
    kps = [suite.generate_keypair(b"svc-%d" % i) for i in range(3)]
    calls = [("register", lambda w: w.blob(b"a").u64(100)), ("register", lambda w: w.blob(b"b").u64(0)),
             ("transfer", lambda w: w.blob(b"a").blob(b"b").u64(30)),
             ("transfer", lambda w: w.blob(b"b").blob(b"a").u64(10 ** 6)),
             ("register", lambda w: w.blob(b"c").u64(5)),
             ("balanceOf", lambda w: w.blob(b"b"))]
    return [Transaction(to=pc.BALANCE_ADDRESS, input=pc.encode_call(m, f), nonce=f"{tag}{i}",
                        block_limit=100).sign(suite, kps[i % 3]).encode()
            for i, (m, f) in enumerate(calls)]


def executor_run(server: str, client: str, kind: str, tmp_path, suite=None):
    """A storage service and an ExecutorServer (DMC on) of the `server`
    package, a RemoteExecutor of the `client` package: block 1 executed,
    its changeset committed through the storage service, the term bumped,
    block 2 executed. -> (receipts and changesets of both blocks, terms)."""
    sm = kind == "sm"
    S = mod(server, "services")
    store_srv = S.StorageServer(mod(server, "storage.wal").WalStorage(str(tmp_path / server)))
    store_srv.start()
    exec_store = S.RemoteStorage("127.0.0.1", store_srv.port)
    exec_srv = S.ExecutorServer(suite or mod(server, "crypto.suite").make_suite(sm, backend="host"),
                                exec_store)
    assert exec_srv.dmc is not None
    exec_srv.start()
    C = mod(client, "services")
    T = mod(client, "protocol")
    ex = C.RemoteExecutor("127.0.0.1", exec_srv.port)
    commit = C.RemoteStorage("127.0.0.1", store_srv.port)
    out, terms = [], [ex.status()]
    try:
        wires = block_frames(kind, "x")
        for number, part in ((1, wires[:5]), (2, wires[5:])):
            receipts, changes = ex.execute_block([T.Transaction.decode(w) for w in part],
                                                 number, 1000 * number)
            out.append(([r.encode() for r in receipts],
                        sorted((k, e.value, e.deleted) for k, e in changes.items())))
            commit.prepare(number, changes)
            commit.commit(number)
            terms.append(ex.status())
            ex.bump_term()
    finally:
        for c in (ex, commit, exec_store):
            c.close()
        exec_srv.stop()
        store_srv.stop()
        store_srv.backend.close()
    return out, terms


@pytest.mark.parametrize("kind", ["ecdsa", "sm"])
@pytest.mark.parametrize("server,client", PAIRS, ids=IDS)
def test_remote_executor_with_dmc_across_packages(tmp_path, kind, server, client):
    got, terms = executor_run(server, client, kind, tmp_path)
    want, _ = executor_run(JAX, JAX, kind, tmp_path / "ref")
    assert got == want
    T = mod(PORT, "protocol")
    assert [T.Receipt.decode(r).status for r in got[0][0]].count(0) == 4   # one transfer reverts
    assert terms == [0, 1, 2]   # each execute carries the client's term, bumped after it


def test_port_executor_service_batches_sender_recovery_on_the_tensor_path(tmp_path):
    """The port's server on a device suite (device="cpu"): one batch
    recovery for the block (the JAX server recovers each tx alone), and
    receipts and changesets equal to the JAX server's."""
    suite = mod(PORT, "crypto.suite").make_suite(device="cpu")
    calls = []
    recover = suite.recover_addresses
    suite.recover_addresses = lambda d, s: (calls.append(len(d)), recover(d, s))[1]
    got, _ = executor_run(PORT, JAX, "ecdsa", tmp_path, suite=suite)
    want, _ = executor_run(JAX, PORT, "ecdsa", tmp_path / "ref")
    assert got == want
    assert calls == [5, 1]   # one batch a block
