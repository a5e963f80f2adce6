"""The port's snapshot plane (snapshot/: manifest, export, importer, store,
service) and its storage-backed Node against the JAX package's: the
manifest and chunk codecs and pack_chunks byte for byte; an export of
carried rows (storage/carry.storage_from_jax) identical in manifest and
chunks on the port's host path and its tensor path on the CPU; tampered
and malformed snapshots rejected by both packages with the same error; a
snap-sync join from a pruned single-sealer chain, the joiner adopting the
snapshot (the same roots and c_balance rows in both packages); a
threshold of 0 keeping replay; a cert-mode checkpoint installed with one
verify_batch; pruning and its nonce window; SnapshotStore retention in
both modes; and a port Node on the disk backend that commits, stops,
reopens and commits again to the JAX Node's state roots. A key-paged
node's snapshot installs in the port (its key pages export rows), where
the JAX package's refuses it (ROADMAP.md C).

The chains run on the port's "auto" backend on the CPU (their batches
sit below device_min_batch, so the host path) and the JAX host suite; the
tensor path takes the export's hash batch and tree only. Header hashes
carry the seal time, so they are compared within a package only.
"""

import functools
import importlib
import os
import random
import time

import pytest
import torch

from fisco_bcos_tpu.crypto import suite as jsuite

ROOTS = ("fisco_bcos_tpu", "fisco_bcos_tpu_torch")
CHAINS = ("ecdsa", "sm")
DEADLINE = 60.0
CHUNK = 1024  # bytes a chunk: the plain Keccak and SM3 are slow on the CPU


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mod(root: str, name: str):
    return importlib.import_module(f"{root}.{name}")


def wait_until(pred, timeout=DEADLINE):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.01)
    return False


@functools.lru_cache(maxsize=None)
def blocks(kind: str):
    """Wire frames of three blocks, signed once on the JAX host suite:
    register alice and bob, move 7 from alice to bob, move 5 back."""
    pc = mod("fisco_bcos_tpu", "executor.precompiled")
    T = mod("fisco_bcos_tpu", "protocol")
    j = jsuite.make_suite(kind == "sm", backend="host")
    kp = j.generate_keypair(b"snap-user")
    calls = [[("register", lambda w: w.blob(b"alice").u64(1000)),
              ("register", lambda w: w.blob(b"bob").u64(10))],
             [("transfer", lambda w: w.blob(b"alice").blob(b"bob").u64(7))],
             [("transfer", lambda w: w.blob(b"bob").blob(b"alice").u64(5))]]
    out, n = [], 0
    for block in calls:
        frames = []
        for method, args in block:
            tx = T.Transaction(to=pc.BALANCE_ADDRESS, input=pc.encode_call(method, args),
                               nonce=f"snap{n}", block_limit=100).sign(j, kp)
            frames.append(tx.encode())
            n += 1
        out.append(frames)
    return out


def keypair(root: str, kind: str, seed: bytes):
    j = jsuite.make_suite(kind == "sm", backend="host")
    kp = j.generate_keypair(seed)
    if root == "fisco_bcos_tpu":
        return kp
    return host_suite(root, kind).keypair_from_secret(kp.secret)


def host_suite(root: str, kind: str):
    if root == "fisco_bcos_tpu":
        return jsuite.make_suite(kind == "sm", backend="host")
    return mod(root, "crypto.suite").make_suite(kind == "sm", backend="auto", device="cpu")


def make_node(root: str, kind: str, kp, gateway=None, **cfg):
    N = mod(root, "init.node")
    kw = dict(sm_crypto=kind == "sm", crypto_backend="auto" if root != "fisco_bcos_tpu"
              else "host", min_seal_time=0.0, **cfg)
    if root == "fisco_bcos_tpu":
        kw.update(profile_hz=0, scheduler_workers=0)
    else:
        kw["device"] = "cpu"
    return N.Node(N.NodeConfig(**kw), keypair=kp, gateway=gateway)


def submit(root: str, node, frames, height: int):
    T = mod(root, "protocol")
    res = node.txpool.submit_batch([T.Transaction.decode(w) for w in frames])
    assert [int(r.status) for r in res] == [0] * len(frames)
    assert wait_until(lambda: node.ledger.current_number() >= height)


def chain_state(root: str, node):
    pc = mod(root, "executor.precompiled")
    heads = []
    for k in range(1, node.ledger.current_number() + 1):
        h = node.ledger.header_by_number(k)
        heads.append((k, h.state_root, h.txs_root, h.receipts_root))
    st = node.storage
    return heads, {k: st.get(pc.T_BALANCE, k) for k in st.keys(pc.T_BALANCE)}


class SingleSealer:
    """A single-sealer PBFT chain of one package's Node (the JAX package's
    tests/test_snapshot.py `_single_sealer_chain`) on a FakeGateway, and
    its joiners."""

    def __init__(self, root: str, kind: str, **cfg):
        self.root, self.kind = root, kind
        self.gw = mod(root, "net.gateway").FakeGateway()
        self.kp = keypair(root, kind, b"\x01" * 16)
        self.sealers = [mod(root, "ledger.ledger").ConsensusNode(self.kp.pub_bytes)]
        self.src = make_node(root, kind, self.kp, self.gw, consensus="pbft", **cfg)
        self.src.build_genesis(self.sealers)
        self.nodes = [self.src]
        self.src.start()

    def commit(self, k: int):
        submit(self.root, self.src, blocks(self.kind)[k - 1], k)

    def checkpointed(self, height: int):
        """Wait for the checkpoint at `height` and its prune to finish."""
        snap = self.src.snapshot
        assert wait_until(lambda: snap.store.latest_height() == height)
        with snap._lock:
            pass

    def joiner(self, seed: bytes, **cfg):
        node = make_node(self.root, self.kind, keypair(self.root, self.kind, seed),
                         self.gw, consensus="pbft", **cfg)
        node.build_genesis(self.sealers)
        self.nodes.append(node)
        return node

    def stop(self):
        for n in self.nodes:
            n.stop()
        self.gw.stop()


def exported_chain(root: str, kind: str):
    """A 3-block single-sealer chain of `root`: (its rows, its export at
    CHUNK bytes a chunk, its sealer keys)."""
    c = SingleSealer(root, kind)
    try:
        for k in (1, 2, 3):
            c.commit(k)
        st = c.src.storage
        rows = {t: {k: st.get(t, k) for k in st.keys(t)} for t in st.tables()}
        export = mod(root, "snapshot").export_snapshot(st, c.src.ledger, c.src.suite,
                                                       chunk_bytes=CHUNK)
        return rows, export, [c.kp.pub_bytes]
    finally:
        c.stop()


@functools.lru_cache(maxsize=None)
def jax_chain(kind: str):
    return exported_chain("fisco_bcos_tpu", kind)


def seal_judge(root: str, kind: str, sealers):
    qc = mod(root, "consensus.qc")
    suite = host_suite(root, kind)
    return lambda h: bool(qc.verify_spans([h], sorted(sealers), suite)[0])


# -- codecs ------------------------------------------------------------------


def test_codecs_and_pack_chunks_are_byte_equal():
    rng = random.Random(1402)
    rows = [(rng.choice(("s_tx", "c_balance", "t_x")), rng.randbytes(rng.randrange(0, 40)),
             rng.randbytes(rng.choice((0, 5, 300, 5000)))) for _ in range(80)]
    J, P = (mod(r, "snapshot.manifest") for r in ROOTS)
    for budget in (64, 1024, 1 << 20):
        jc, pc = J.pack_chunks(rows, budget), P.pack_chunks(rows, budget)
        assert pc == jc and len(jc) >= 1
        assert [r for c in jc for r in P.unpack_chunk(c)] == rows
    assert len(P.pack_chunks(rows, 64)) > 40   # every oversized row alone
    m = dict(height=7, header_bytes=b"hdr", root=b"r" * 32,
             chunk_hashes=[b"h" * 32, b"i" * 32], total_bytes=123)
    jm, pm = J.SnapshotManifest(**m), P.SnapshotManifest(**m)
    assert pm.encode() == jm.encode()
    assert P.SnapshotManifest.decode(jm.encode()) == pm
    bad = b"\x00\x02" + jm.encode()[2:]
    errs = []
    for M in (J, P):
        with pytest.raises(ValueError) as e:
            M.SnapshotManifest.decode(bad)
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    assert J.PRIVATE_TABLES == P.PRIVATE_TABLES


# -- export ------------------------------------------------------------------


@pytest.mark.parametrize("kind", CHAINS)
def test_export_of_carried_rows_is_identical(kind):
    """The JAX chain's rows carried into the port export to the same
    manifest and chunks on the port's host path and on its tensor path
    (make_suite(device="cpu"): the plain batch hash and tree)."""
    from fisco_bcos_tpu_torch.crypto.suite import make_suite
    from fisco_bcos_tpu_torch.ledger.ledger import Ledger
    from fisco_bcos_tpu_torch.snapshot import export_snapshot
    from fisco_bcos_tpu_torch.storage import storage_from_jax

    rows, (jm, jc), _ = jax_chain(kind)
    assert jm.height == 3 and len(jc) > 3
    for suite in (make_suite(kind == "sm", backend="host"),
                  make_suite(kind == "sm", device="cpu")):
        st = storage_from_jax(rows)
        pm, pc = export_snapshot(st, Ledger(st, suite), suite, chunk_bytes=CHUNK)
        assert pc == jc
        assert pm.encode() == jm.encode()


# -- verify and install --------------------------------------------------------


def _tampered(root: str, kind: str):
    """-> {case: (manifest, chunks, verify_seals)} built from the JAX
    chain's export, in `root`'s types."""
    M = mod(root, "snapshot.manifest")
    T = mod(root, "protocol")
    suite = host_suite(root, kind)
    _, (jm, jc), sealers = jax_chain(kind)
    m = M.SnapshotManifest.decode(jm.encode())
    judge = seal_judge(root, kind, sealers)

    def manifest(chunks, header_bytes=m.header_bytes):
        hashes = suite.hash_batch(chunks)
        return M.SnapshotManifest(height=m.height, header_bytes=header_bytes,
                                  root=suite.merkle_root(hashes), chunk_hashes=hashes,
                                  total_bytes=sum(map(len, chunks)))

    flipped = list(jc)
    flipped[1] = flipped[1][:-1] + bytes([flipped[1][-1] ^ 1])
    unsealed = T.BlockHeader.decode(m.header_bytes)
    unsealed.signature_list = []
    rows = [r for c in jc for r in M.unpack_chunk(c)]
    no_header = M.pack_chunks([r for r in rows if r[0] != "s_number_2_header"], CHUNK)
    private = M.pack_chunks(rows + [("c_pbft_log", b"view", b"\x00")], CHUNK)
    garbage = [b"\xff" * 40] + list(jc)
    return {
        "good": (m, jc, judge),
        "chunk flipped": (m, flipped, judge),
        "root": (M.SnapshotManifest(m.height, m.header_bytes, b"\x00" * 32,
                                    m.chunk_hashes, m.total_bytes), jc, judge),
        "chunk missing": (m, jc[:-1], judge),
        "no seals": (manifest(jc, unsealed.encode()), jc, judge),
        "other sealers": (m, jc, seal_judge(root, kind, [b"\x02" * 64])),
        "no header row": (manifest(no_header), no_header, judge),
        "private table": (manifest(private), private, judge),
        "malformed chunk": (manifest(garbage), garbage, judge),
    }


@pytest.mark.parametrize("kind", CHAINS)
def test_tampered_and_malformed_snapshots_are_rejected_alike(kind):
    got = {}
    for root in ROOTS:
        I = mod(root, "snapshot.importer")
        Mem = mod(root, "storage.memory").MemoryStorage
        out = {}
        for case, (m, chunks, judge) in _tampered(root, kind).items():
            st = Mem()
            try:
                h = I.install_snapshot(m, list(chunks), st, host_suite(root, kind), judge)
                out[case] = ("installed", h.number, sorted(st.tables()))
            except I.SnapshotVerifyError as exc:
                out[case] = ("refused", str(exc))
        got[root] = out
    assert got["fisco_bcos_tpu_torch"] == got["fisco_bcos_tpu"]
    verdicts = got["fisco_bcos_tpu"]
    assert verdicts["good"][0] == "installed"
    assert all(v[0] == "refused" for c, v in verdicts.items() if c != "good"), verdicts
    assert "malformed chunk content" in verdicts["malformed chunk"][1]


def test_a_key_paged_disk_node_snapshot_installs_in_the_port(tmp_path):
    """The disk backend's default layout is key pages. The JAX package's
    KeyPageStorage exports its pages as rows, so install finds no
    checkpoint header and refuses every such snapshot; the port's exports
    the rows, the same manifest as the rows on MemoryStorage give, and
    installs into memory and into another key-paged disk store alike."""
    kind = "ecdsa"
    rows, (jm, jc), sealers = jax_chain(kind)
    got = {}
    for root in ROOTS:
        S = mod(root, "storage")
        I = mod(root, "snapshot.importer")
        suite = host_suite(root, kind)
        st = S.make_storage("disk", str(tmp_path / root / "src"), memtable_mb=1)
        Entry = S.Entry
        st.prepare(1, {(t, k): Entry(v) for t, kv in rows.items() for k, v in kv.items()})
        st.commit(1)
        m, chunks = mod(root, "snapshot").export_snapshot(
            st, mod(root, "ledger.ledger").Ledger(st, suite), suite, chunk_bytes=CHUNK)
        st.close()
        judge = seal_judge(root, kind, sealers)
        try:
            I.install_snapshot(m, chunks, S.MemoryStorage(), suite, judge)
            got[root] = (m.encode(), chunks, "installed")
        except I.SnapshotVerifyError as exc:
            got[root] = (m.encode(), chunks, str(exc))
    assert got["fisco_bcos_tpu"][2] == "snapshot lacks its own checkpoint header"
    pm, pc, verdict = got["fisco_bcos_tpu_torch"]
    assert verdict == "installed" and pm == jm.encode() and pc == jc
    from fisco_bcos_tpu_torch.snapshot import SnapshotManifest, install_snapshot
    from fisco_bcos_tpu_torch.storage import make_storage
    dst = make_storage("disk", str(tmp_path / "dst"), memtable_mb=1)
    install_snapshot(SnapshotManifest.decode(pm), pc, dst, host_suite(ROOTS[1], kind),
                     seal_judge(ROOTS[1], kind, sealers))
    want = {t: kv for t, kv in rows.items() if t != "c_pbft_log"}
    assert {t: {k: dst.get(t, k) for k in dst.keys(t)} for t in want} == want
    dst.close()


# -- snap sync -----------------------------------------------------------------


def _join(root: str, kind: str):
    """A joiner snap-syncs a pruned single-sealer chain (checkpoint at 2,
    bodies below it pruned) and replays block 3 only. -> (the joiner's
    state, the source's, the blocks it executed, its sync mode, its
    store's heights, header hashes equal)."""
    c = SingleSealer(root, kind, snapshot_interval=2, snapshot_prune=True,
                     snapshot_keep_tail=0, snapshot_chunk_bytes=CHUNK)
    try:
        c.commit(1)
        c.commit(2)
        c.checkpointed(2)
        assert c.src.ledger.pruned_below() == 2
        c.commit(3)
        obs = c.joiner(b"obs-1", snap_sync_threshold=1)
        executed = []
        run = obs.scheduler.execute_block
        obs.scheduler.execute_block = lambda b, *a, **k: (executed.append(b.header.number),
                                                          run(b, *a, **k))[1]
        obs.start()
        assert wait_until(lambda: obs.ledger.current_number() >= 3)
        same = obs.ledger.header_by_number(3).hash(obs.suite) == \
            c.src.ledger.header_by_number(3).hash(c.src.suite)
        return (chain_state(root, obs), chain_state(root, c.src), executed,
                obs.blocksync.sync_mode, obs.snapshot.store.heights(), same)
    finally:
        c.stop()


@pytest.mark.parametrize("kind", CHAINS)
def test_snap_sync_join_from_a_pruned_peer(kind):
    want = _join("fisco_bcos_tpu", kind)
    got = _join("fisco_bcos_tpu_torch", kind)
    assert got == want
    joined, src, executed, mode, heights, same = got
    assert joined == src and executed == [3] and mode == "snap" and heights == [2] and same
    assert joined[1] == {b"alice": (998).to_bytes(16, "big"), b"bob": (12).to_bytes(16, "big")}


def test_threshold_zero_keeps_replay():
    c = SingleSealer("fisco_bcos_tpu_torch", "ecdsa", snapshot_interval=2,
                     snapshot_chunk_bytes=CHUNK)
    try:
        for k in (1, 2, 3):
            c.commit(k)
        assert wait_until(lambda: c.src.snapshot.store.latest_height() is not None)
        obs = c.joiner(b"obs-2", snap_sync_threshold=0)
        obs.start()
        assert wait_until(lambda: obs.ledger.current_number() >= 3)
        assert obs.blocksync.sync_mode == "replay"
        assert chain_state(c.root, obs) == chain_state(c.root, c.src)
        assert obs.snapshot.store.heights() == []
    finally:
        c.stop()


class _CountingSuite:
    def __init__(self, suite):
        self._suite = suite
        self.verify_calls = 0

    def __getattr__(self, name):
        return getattr(self._suite, name)

    def verify_batch(self, digests, sigs, pubs):
        self.verify_calls += 1
        return self._suite.verify_batch(digests, sigs, pubs)


def test_cert_mode_checkpoint_installs_with_one_lane_call():
    from fisco_bcos_tpu_torch.consensus import qc
    from fisco_bcos_tpu_torch.ledger.ledger import Ledger
    from fisco_bcos_tpu_torch.protocol import BlockHeader
    from fisco_bcos_tpu_torch.snapshot import export_snapshot, install_snapshot
    from fisco_bcos_tpu_torch.storage import MemoryStorage

    node = make_node("fisco_bcos_tpu_torch", "ecdsa",
                     keypair("fisco_bcos_tpu_torch", "ecdsa", b"cert"), seal_mode="cert")
    node.build_genesis()
    node.start()
    try:
        submit("fisco_bcos_tpu_torch", node, blocks("ecdsa")[0], 1)
        submit("fisco_bcos_tpu_torch", node, blocks("ecdsa")[1], 2)
        m, chunks = export_snapshot(node.storage, node.ledger, node.suite, chunk_bytes=CHUNK)
        assert qc.extract(BlockHeader.decode(m.header_bytes)).mode == qc.MODE_CERT
        counting = _CountingSuite(node.suite)
        judge = lambda h: bool(qc.verify_spans([h], [node.keypair.pub_bytes], counting)[0])
        fresh = MemoryStorage()
        assert install_snapshot(m, chunks, fresh, node.suite, judge).number == m.height
        assert counting.verify_calls == 1
        assert Ledger(fresh, node.suite).current_number() == m.height
    finally:
        node.stop()


# -- pruning and the store -------------------------------------------------------


@pytest.mark.parametrize("keep_nonces", [1, None])
def test_prune_and_its_nonce_window(keep_nonces):
    """prune_block_data on the carried chain leaves the same rows in both
    packages: bodies below the floor gone, headers kept, nonces kept for
    `keep_nonces` blocks more (the ledger's 600 by default)."""
    from fisco_bcos_tpu_torch.storage import storage_from_jax

    rows, _, _ = jax_chain("ecdsa")
    out = {}
    for root in ROOTS:
        M = mod(root, "storage.memory")
        if root == "fisco_bcos_tpu":
            st = M.MemoryStorage()
            for t, kv in rows.items():
                for k, v in kv.items():
                    st.set(t, k, v)
        else:
            st = storage_from_jax(rows)
        led = mod(root, "ledger.ledger").Ledger(st, host_suite(root, "ecdsa"))
        swept = led.prune_block_data(3, keep_nonces=keep_nonces)
        out[root] = swept, led.pruned_below(), \
            {t: {k: st.get(t, k) for k in st.keys(t)} for t in st.tables()}
    assert out["fisco_bcos_tpu_torch"] == out["fisco_bcos_tpu"]
    swept, floor, after = out["fisco_bcos_tpu"]
    assert swept == 2 and floor == 3 and after != rows
    nonces = mod("fisco_bcos_tpu", "ledger.ledger").T_NONCES
    assert (len(after.get(nonces, {})) < len(rows[nonces])) == (keep_nonces == 1)


@pytest.mark.parametrize("mode", ["fs", "memory"])
def test_snapshot_store_retention(tmp_path, mode):
    _, (jm, jc), _ = jax_chain("ecdsa")
    out = {}
    for root in ROOTS:
        M = mod(root, "snapshot")
        store = M.SnapshotStore(str(tmp_path / root) if mode == "fs" else None)
        for h in (3, 5, 8):
            m = M.SnapshotManifest.decode(jm.encode())
            m.height = h
            store.save(m, jc[:h])
        dropped = store.retain(2)
        out[root] = (dropped, store.heights(), store.latest_height(),
                     store.manifest(5).encode(), [store.chunk(8, i) for i in range(8)],
                     store.chunk(5, 5), store.manifest(3))
        if mode == "fs":
            files = {}
            for d, _, fs in os.walk(tmp_path / root):
                for f in fs:
                    p = os.path.join(d, f)
                    files[os.path.relpath(p, tmp_path / root)] = open(p, "rb").read()
            out[root] += (files,)
    assert out["fisco_bcos_tpu_torch"] == out["fisco_bcos_tpu"]
    assert out["fisco_bcos_tpu"][:3] == ([3], [5, 8], 8)


# -- the port's Node on the disk backend ------------------------------------------


@pytest.mark.parametrize("kind", CHAINS)
def test_disk_node_commits_stops_reopens_to_the_jax_state_roots(tmp_path, kind):
    """A solo port Node on storage_backend="disk" commits block 1, stops,
    closes its storage, reopens on the same directory at the same head
    and commits blocks 2 and 3: every root and c_balance row equals the
    JAX Node's fed the same transactions."""
    j = make_node("fisco_bcos_tpu", kind, keypair("fisco_bcos_tpu", kind, b"solo"))
    j.build_genesis()
    j.start()
    try:
        for k in (1, 2, 3):
            submit("fisco_bcos_tpu", j, blocks(kind)[k - 1], k)
        want = chain_state("fisco_bcos_tpu", j)
    finally:
        j.stop()
    kp = keypair("fisco_bcos_tpu_torch", kind, b"solo")
    path = str(tmp_path / "chain")
    heads = []
    for ks in ((1,), (2, 3)):
        p = make_node("fisco_bcos_tpu_torch", kind, kp, storage_path=path,
                      storage_backend="disk")
        assert type(p.storage).__name__ == "KeyPageStorage"
        p.build_genesis()
        heads.append(p.ledger.current_number())
        p.start()
        try:
            for k in ks:
                submit("fisco_bcos_tpu_torch", p, blocks(kind)[k - 1], k)
            got = chain_state("fisco_bcos_tpu_torch", p)
            head = p.ledger.header_by_number(p.ledger.current_number()).hash(p.suite)
        finally:
            p.stop()
            p.storage.close()
    assert heads == [0, 1]
    assert got == want
    again = make_node("fisco_bcos_tpu_torch", kind, kp, storage_path=path,
                      storage_backend="disk")
    try:
        assert chain_state("fisco_bcos_tpu_torch", again) == want
        assert again.ledger.header_by_number(3).hash(again.suite) == head
    finally:
        again.stop()
        again.storage.close()
