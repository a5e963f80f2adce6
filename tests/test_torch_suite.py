"""The port's slice as a whole (CryptoSuite + protocol.types on the CPU
tensor path) against the JAX package's host suite, bit-exact, plus the
port's package rules (no JAX, no fisco_bcos_tpu imports) and suite API."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from fisco_bcos_tpu.crypto import suite as jsuite
from fisco_bcos_tpu.protocol import types as JT
from fisco_bcos_tpu_torch.crypto import suite as psuite
from fisco_bcos_tpu_torch.protocol import types as PT


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These tests run thousands of small tensor ops: one intra-op thread,
    so that test workers sharing the cores do not stall at every op's
    thread barrier."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = Path(__file__).resolve().parent.parent


# lane -> corruption of its signature (sig, keys) -> sig
ECDSA_BAD = {5: lambda g, k: bytes(32) + g[32:],              # r = 0
             11: lambda g, k: g[:64] + bytes([g[64] ^ 1])}    # wrong key
SM_BAD = {5: lambda g, k: bytes(32) + g[32:],                 # r = 0
          8: lambda g, k: g[:100],                            # short
          11: lambda g, k: g[:64] + k[0].pub_bytes}           # another key


def _block(T, suite, keys, sigs=None, bad=ECDSA_BAD):
    txs = [T.Transaction(nonce=f"n{i}", to=bytes([i + 1]) * 20, block_limit=500,
                         input=bytes((i * 37 + j) % 256 for j in range(20 + 40 * i)))
           for i in range(16)]
    if sigs is None:
        sigs = []
        for i, t in enumerate(txs):
            sig = suite.sign(keys[i % 4], t.hash(suite))
            sigs.append(bad[i](sig, keys) if i in bad else sig)
    for t, g in zip(txs, sigs):
        t.signature = g
        object.__setattr__(t, "_hash", None)
    receipts = [T.Receipt(gas_used=21000 + i, status=i % 3, output=bytes([i]) * 8,
                          block_number=3) for i in range(16)]
    header = T.BlockHeader(number=3, sealer_list=[k.pub_bytes for k in keys])
    return T.Block(header=header, transactions=txs, receipts=receipts), sigs


def _slice(T, suite, block, sealers, seals=None):
    senders, ok = T.batch_recover_senders(block.transactions, suite)
    hashes = [t._hash for t in block.transactions]
    txs_root = block.calculate_txs_root(suite)
    rc_root = block.calculate_receipts_root(suite)
    h = block.header.hash(suite)
    seals = seals or [suite.sign(k, h) for k in sealers]
    digests = [h] * 4 + [bytes([h[0] ^ 1]) + h[1:]]
    pubs = [k.pub_bytes for k in sealers] + [sealers[0].pub_bytes]
    seal_ok = suite.verify_batch(digests, seals + seals[:1], pubs)
    return dict(hashes=hashes, senders=senders, ok=list(ok), txs_root=txs_root,
                receipts_root=rc_root, seals=seals, seal_ok=list(seal_ok))


def test_16_tx_block_matches_jax_host_suite():
    port = psuite.make_suite(device="cpu")
    jax_host = jsuite.make_suite(backend="host")
    keys = [port.generate_keypair(b"acct" + bytes([i])) for i in range(4)]
    jkeys = [jax_host.keypair_from_secret(k.secret) for k in keys]
    pblock, sigs = _block(PT, port, keys)
    jblock, _ = _block(JT, jax_host, jkeys, sigs)
    got = _slice(PT, port, pblock, keys)
    want = _slice(JT, jax_host, jblock, jkeys)
    assert got == want
    assert got["ok"].count(False) == 1  # r = 0; the wrong-key lane recovers
    assert got["senders"][11] != keys[3].address
    assert got["seal_ok"] == [True] * 4 + [False]


def test_16_tx_sm_block_matches_jax_host_suite():
    """The SM chain: SM3 tx and receipt hashes, SM2 senders from the
    embedded keys, SM3 roots and SM2 seal verdicts, on the port's CPU
    tensor path, equal to the JAX SM host suite. Signatures are made once
    and shared."""
    port = psuite.make_suite(sm_crypto=True, device="cpu")
    jax_host = jsuite.make_suite(sm_crypto=True, backend="host")
    keys = [port.generate_keypair(b"sm" + bytes([i])) for i in range(4)]
    jkeys = [jax_host.keypair_from_secret(k.secret) for k in keys]
    pblock, sigs = _block(PT, port, keys, bad=SM_BAD)
    jblock, _ = _block(JT, jax_host, jkeys, sigs)
    got = _slice(PT, port, pblock, keys)
    want = _slice(JT, jax_host, jblock, jkeys, got["seals"])
    assert got == want
    assert [i for i, o in enumerate(got["ok"]) if not o] == [5, 8, 11]
    assert got["senders"][0] == keys[0].address == port.address_of_pub(keys[0].pub_bytes)
    assert got["seal_ok"] == [True] * 4 + [False]
    assert port.signature_size == 128 and len(got["seals"][0]) == 128


@pytest.mark.parametrize("sm", [False, True], ids=["ecdsa", "sm"])
def test_16_tx_block_composed_route_matches_fused_and_jax(sm):
    """make_suite(ec_route="composed", device="cpu"): the 16-tx block and
    its seals through the composed EC route's plain versions, equal to the
    fused route's CPU path and to the JAX host suite, for both chains."""
    tag, bad = (b"sm", SM_BAD) if sm else (b"acct", ECDSA_BAD)
    composed = psuite.make_suite(sm_crypto=sm, device="cpu", ec_route="composed")
    fused = psuite.make_suite(sm_crypto=sm, device="cpu")
    jax_host = jsuite.make_suite(sm_crypto=sm, backend="host")
    assert (composed.ec_route, fused.ec_route) == ("composed", "fused")
    keys = [composed.generate_keypair(tag + bytes([i])) for i in range(4)]
    jkeys = [jax_host.keypair_from_secret(k.secret) for k in keys]
    cblock, sigs = _block(PT, composed, keys, bad=bad)
    fblock, _ = _block(PT, fused, keys, sigs, bad=bad)
    jblock, _ = _block(JT, jax_host, jkeys, sigs, bad=bad)
    got = _slice(PT, composed, cblock, keys)
    assert got == _slice(PT, fused, fblock, keys, got["seals"])
    assert got == _slice(JT, jax_host, jblock, jkeys, got["seals"])
    assert got["seal_ok"] == [True] * 4 + [False] and not all(got["ok"])


@pytest.mark.parametrize("sm", [False, True], ids=["ecdsa", "sm"])
def test_host_and_tensor_backends_agree_on_bad_signatures(sm):
    dev = psuite.make_suite(sm_crypto=sm, device="cpu")
    host = psuite.make_suite(sm_crypto=sm, backend="host")
    kp = host.generate_keypair(b"k")
    d = [bytes([i]) * 32 for i in range(6)]
    sigs = [host.sign(kp, x) for x in d]
    sigs[1] = sigs[1][:40]  # malformed -> r = s = 0 (and v = 255)
    # ecdsa: v >= 4; sm: an embedded key of zeros
    sigs[2] = sigs[2][:64] + (b"\x07" if not sm else bytes(64))
    pubs = [kp.pub_bytes] * 6
    pubs[3] = bytes(64)  # (0, 0) key
    assert list(dev.verify_batch(d, sigs, pubs)) == list(host.verify_batch(d, sigs, pubs))
    assert dev.recover_batch(d, sigs)[0] == host.recover_batch(d, sigs)[0]
    assert dev.recover_addresses(d, sigs)[0] == host.recover_addresses(d, sigs)[0]
    assert dev.hash_batch(d) == host.hash_batch(d)
    assert dev.merkle_root(d) == host.merkle_root(d)


def test_buckets_and_chunk_match_jax():
    assert psuite.BUCKETS == jsuite.BUCKETS and psuite.CHUNK == jsuite.CHUNK
    for n in (1, 8, 9, 4096, 16385, 65536, 70000):
        assert psuite._bucket(n) == jsuite._bucket(n)
        assert psuite._chunks(n) == jsuite._chunks(n)


def test_unported_configurations_raise(monkeypatch):
    """Sharding over several GPUs is not ported: mesh_devices >= 2 raises
    where two cards exist (stood in for here). The SM chain is ported (it
    raised before its slice), and like the default chain it never drops to
    the CPU."""
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(torch.cuda, "device_count", lambda: 2)
        with pytest.raises(NotImplementedError, match="multi-GPU"):
            psuite.make_suite(mesh_devices=2)
        with pytest.raises(NotImplementedError, match="multi-GPU"):
            psuite.make_suite(sm_crypto=True, mesh_devices=2)
        assert psuite.make_suite(mesh_devices=1).mesh_devices == 1
    sm = psuite.make_suite(sm_crypto=True, device="cpu")
    assert (sm.kind, sm.hash_name, sm.signature_size) == ("sm", "sm3", 128)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            psuite.make_suite()  # device="cuda" by default: never drops to CPU
        with pytest.raises(RuntimeError):
            psuite.make_suite(sm_crypto=True)
    assert psuite.make_suite(backend="host").backend == "host"
    assert psuite.make_suite(sm_crypto=True, backend="host").backend == "host"


class _DuckKeyPair:
    """A key pair whose secret is kept elsewhere, as an HSM keeps it:
    `secret` is None and `sign_digest` signs."""

    def __init__(self, suite, secret: int):
        self.secret = None
        self._kp = suite.keypair_from_secret(secret)
        self._suite = suite
        self.pub_bytes = self._kp.pub_bytes
        self.calls = 0

    def sign_digest(self, digest: bytes) -> bytes:
        self.calls += 1
        return self._suite.sign(self._kp, digest)


@pytest.mark.parametrize("sm", [False, True], ids=["ecdsa", "sm"])
def test_sign_goes_through_a_key_pairs_sign_digest(sm):
    """CryptoSuite.sign takes kp.sign_digest when the key pair has one, as
    the JAX suite does; the signature equals the one of the same secret
    held in a KeyPair, on the port and signed by the JAX suite itself, and
    verifies (the port's host oracle and the JAX suite)."""
    port = psuite.make_suite(sm_crypto=sm, device="cpu")
    port_host = psuite.make_suite(sm_crypto=sm, backend="host")
    jax_host = jsuite.make_suite(sm_crypto=sm, backend="host")
    kp = _DuckKeyPair(port, 0x1234567)
    d = bytes(range(32))
    sig = port.sign(kp, d)
    assert kp.calls == 1
    assert sig == jax_host.sign(kp, d) == port.sign(port.keypair_from_secret(0x1234567), d)
    assert sig == jax_host.sign(jax_host.keypair_from_secret(0x1234567), d)
    assert port_host.verify(kp.pub_bytes, d, sig) and jax_host.verify(kp.pub_bytes, d, sig)


def test_sign_with_an_hsm_key_pair(tmp_path):
    """An hsm.HsmKeyPair over a SoftHsmProvider (key 1) signs on the port's
    SM suite as on the JAX suite; the signature verifies on both and
    recovers the key pair's address."""
    from fisco_bcos_tpu.crypto import hsm

    port = psuite.make_suite(sm_crypto=True, device="cpu")
    port_host = psuite.make_suite(sm_crypto=True, backend="host")
    jax_suite = jsuite.make_suite(sm_crypto=True, backend="host")
    provider = hsm.SoftHsmProvider(str(tmp_path / "keystore"), b"pw")
    provider.generate_key(1)
    kp = hsm.HsmKeyPair(provider, 1, port)
    assert kp.secret is None
    d = bytes(range(32))
    sig = port.sign(kp, d)
    assert sig == jax_suite.sign(hsm.HsmKeyPair(provider, 1, jax_suite), d)
    assert len(sig) == 128 and sig[64:] == kp.pub_bytes
    assert port_host.verify(kp.pub_bytes, d, sig) and jax_suite.verify(kp.pub_bytes, d, sig)
    assert list(port_host.recover_addresses([d], [sig])[0]) == [kp.address]


def test_mesh_devices_run_unsharded_below_two_gpus():
    """CryptoSuite(mesh_devices=2) on the CPU constructs and runs
    unsharded, as the JAX suite does on one device: on both chains the
    same buckets as mesh_devices=None; on the default chain recovery and
    verify equal to mesh_devices=None's and the JAX host suite's on a
    small batch with bad lanes."""
    for kind in ("ecdsa", "sm"):
        port = psuite.CryptoSuite(kind, mesh_devices=2, device="cpu")
        plain = psuite.CryptoSuite(kind, device="cpu")
        assert port.mesh_devices == 2 and port._bucket_for(5) == 8
        assert ([port._bucket_for(n) for n in (1, 9, 4096, 16384)]
                == [plain._bucket_for(n) for n in (1, 9, 4096, 16384)] == [8, 64, 4096, 16384])
    jax_host = jsuite.make_suite(backend="host")
    port = psuite.CryptoSuite(mesh_devices=2, device="cpu")
    plain = psuite.CryptoSuite(device="cpu")
    kp = port.keypair_from_secret(77)
    d = [bytes([i]) * 32 for i in range(5)]
    sigs = [port.sign(kp, x) for x in d]
    sigs[2] = bytes(32) + sigs[2][32:]
    pubs = [kp.pub_bytes] * 5
    pubs[3] = port.keypair_from_secret(78).pub_bytes
    got = port.verify_batch(d, sigs, pubs)
    assert list(got) == list(plain.verify_batch(d, sigs, pubs))
    assert list(got) == list(jax_host.verify_batch(d, sigs, pubs))
    assert list(got) == [True, True, False, False, True]
    rec = port.recover_batch(d, sigs)
    assert rec[0] == plain.recover_batch(d, sigs)[0] == jax_host.recover_batch(d, sigs)[0]
    assert list(rec[1]) == [True, True, False, True, True]


def _port_sources():
    files = sorted(p for p in (REPO / "fisco_bcos_tpu_torch").rglob("*.py")
                   if "_build" not in p.parts)
    return files + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: p.name)
def test_port_imports_neither_jax_nor_the_jax_package(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [(node.module or "").split(".")[0]]
        else:
            continue
        assert not {"jax", "jaxlib", "fisco_bcos_tpu"} & set(roots), (path, roots)


def test_the_import_scan_covers_every_port_package():
    """The scan above walks the whole port: the serving edge (rpc/, sdk/)
    and the planes under it as well as the kernels' packages."""
    dirs = {p.parent.name for p in _port_sources()}
    assert {"rpc", "sdk", "net", "zk", "analysis", "init", "ops", "crypto"} <= dirs
    names = {p.name for p in _port_sources() if p.parent.name in ("rpc", "sdk")}
    assert {"server.py", "edge.py", "ws_server.py", "eventsub.py", "client.py", "ws.py"} <= names


def test_tensor_entry_points_dispatch_on_device():
    """CPU tensors take the plain versions; nothing counts a launch."""
    from fisco_bcos_tpu_torch.ops import cuda_hash, keccak

    before = cuda_hash.keccak256_varlen.launches
    blocks, nvalid = keccak.pad_batch_np([b"abc"])
    keccak.keccak256_varlen(torch.as_tensor(blocks), torch.as_tensor(nvalid))
    assert cuda_hash.keccak256_varlen.launches == before
    with pytest.raises(ValueError):
        cuda_hash.keccak256_varlen(torch.as_tensor(blocks), torch.as_tensor(nvalid))
    assert np.asarray(blocks).shape == (1, 1, 136)
