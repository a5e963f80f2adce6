"""The port's columnar wire decode (protocol/columnar.py) against the JAX
package's, exactly: the same seeded wire frames on both chains decode to
identical columns, views and fallback rows, and fill identical hash and
sender columns (the port on its CPU tensor path, the JAX package on its
host suite).

The frame set (`wire_frames`) is shared with the txpool, ledger and seam
tests: seeded payloads signed by four senders, plus a wrong chain id, a
wrong group id, block limits below and past the pool's range, a corrupted
and a short signature, a malformed frame, a padded (non-canonical) frame,
a repeated frame and short-lived txs.
"""

import numpy as np
import pytest
import torch

from fisco_bcos_tpu.crypto import suite as jsuite
from fisco_bcos_tpu.protocol import Transaction as JTx
from fisco_bcos_tpu.protocol import columnar as jcol
from fisco_bcos_tpu_torch.crypto import suite as psuite
from fisco_bcos_tpu_torch.protocol import columnar as pcol

CHAINS = ("ecdsa", "sm")
CHAIN_ID, GROUP_ID = "chain0", "group0"
# row -> what is wrong with it (every other row is a valid signed tx)
SPECIAL = {3: "foreign-chain", 5: "foreign-group", 7: "expired", 9: "beyond-range",
           11: "bad-signature", 13: "short-signature", 15: "malformed",
           17: "padded", 19: "repeat", 21: "short-life", 23: "short-life"}
_SUITES: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The plain EC paths run thousands of small tensor ops: one intra-op
    thread, so that test workers sharing the cores do not stall at every
    op's thread barrier."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def suites(kind: str):
    """(port suite on the CPU tensor path, JAX host suite) of a chain,
    one pair a process."""
    if kind not in _SUITES:
        sm = kind == "sm"
        _SUITES[kind] = (psuite.make_suite(sm, device="cpu"),
                         jsuite.make_suite(sm, backend="host"))
    return _SUITES[kind]


def sender_keys(kind: str, n: int = 4):
    """(JAX key pairs, port key pairs) of the same secrets."""
    port, jax = suites(kind)
    jkeys = [jax.generate_keypair(b"node-sender" + bytes([k])) for k in range(n)]
    return jkeys, [port.keypair_from_secret(k.secret) for k in jkeys]


def wire_frames(kind: str, n: int = 32, seed: int = 11, current: int = 0,
                tag: str = "a"):
    """n seeded wire frames signed on the JAX host suite, rows of SPECIAL
    broken as named; -> (frames, signed Transactions or None per row)."""
    _, jax = suites(kind)
    jkeys, _ = sender_keys(kind)
    rng = np.random.default_rng(seed)
    frames, txs = [], []
    for i in range(n):
        what = SPECIAL.get(i)
        limit = int(rng.integers(current + 10, current + 500))
        if what == "expired":
            limit = current
        elif what == "beyond-range":
            limit = current + 601
        elif what == "short-life":
            limit = current + 2
        tx = JTx(chain_id="chain9" if what == "foreign-chain" else CHAIN_ID,
                 group_id="group7" if what == "foreign-group" else GROUP_ID,
                 block_limit=limit, nonce=f"{tag}{seed}-{i}", to=rng.bytes(20),
                 input=rng.bytes(int(rng.integers(16, 300))),
                 import_time=1_700_000_000_000 + i,
                 attribute=int(rng.integers(0, 3)) << 24)
        tx.sign(jax, jkeys[i % len(jkeys)])
        if what == "bad-signature":
            tx.signature = bytes(32) + tx.signature[32:]          # r = 0
            tx._wire = None
        elif what == "short-signature":
            tx.signature = tx.signature[:40]
            tx._wire = None
        w = tx.encode()
        if what == "malformed":
            w = w[:21]
        elif what == "padded":
            w = w + b"\x00\x07"
        elif what == "repeat":
            w, tx = frames[2], txs[2]
        frames.append(w)
        txs.append(None if what == "malformed" else tx)
    return frames, txs


def signer_of(i: int) -> int:
    """The sender key index of wire_frames' row i."""
    return 2 if SPECIAL.get(i) == "repeat" else i % 4


_ARRAYS = ("wire_off", "wire_end", "unsig_off", "unsig_end", "sig_off", "sig_end",
           "to_off", "to_end", "in_off", "in_end", "abi_off", "abi_end", "version",
           "block_limit", "import_time", "attribute", "decode_ok")
_LISTS = ("chain_id", "group_id", "nonce", "hashes", "senders")


def assert_columns_equal(p, j):
    assert p.n == j.n and p.arena == j.arena
    for name in _ARRAYS:
        assert np.array_equal(getattr(p, name), getattr(j, name)), name
    for name in _LISTS:
        assert list(getattr(p, name)) == list(getattr(j, name)), name
    assert sorted(p.fallback) == sorted(j.fallback)
    for i, tx in j.fallback.items():
        assert p.fallback[i].encode() == tx.encode()


@pytest.mark.parametrize("kind", CHAINS)
def test_decode_columns_matches_jax(kind):
    frames, _ = wire_frames(kind)
    p, j = pcol.decode_columns(frames), jcol.decode_columns(frames)
    assert_columns_equal(p, j)
    assert not p.decode_ok[15] and p.decode_ok.sum() == len(frames) - 1
    assert list(p.fallback) == [17]
    for i in range(p.n):
        if not p.decode_ok[i]:
            with pytest.raises(ValueError):
                p.view(i)
            continue
        pv, jv = p.view(i), j.view(i)
        assert type(pv).__name__ == type(jv).__name__
        assert pv.encode() == jv.encode()
        assert pv.encode_unsigned() == jv.encode_unsigned()
        for field in ("version", "chain_id", "group_id", "block_limit", "nonce", "to",
                      "input", "abi", "signature", "import_time", "attribute"):
            assert getattr(pv, field) == getattr(jv, field), (i, field)
    assert [p.wire(i) for i in range(p.n)] == [j.wire(i) for i in range(j.n)]
    assert [p.band(i) for i in range(p.n)] == [j.band(i) for i in range(j.n)]


@pytest.mark.parametrize("kind", CHAINS)
def test_column_identity_matches_jax(kind):
    """One hash_batch and one recover_addresses fill the columns; the
    port's tensor path gives the JAX host suite's hashes and senders."""
    port, jax = suites(kind)
    frames, txs = wire_frames(kind, n=24)
    p, j = pcol.decode_columns(frames), jcol.decode_columns(frames)
    pm, jm = p.ensure_senders(port), j.ensure_senders(jax)
    assert np.array_equal(pm, jm)
    assert_columns_equal(p, j)
    jkeys, _ = sender_keys(kind)
    for i, tx in enumerate(txs):
        if tx is None:
            assert p.hashes[i] is None and not pm[i]
            continue
        assert p.hashes[i] == tx.hash(jax)
        bad = SPECIAL.get(i) in ("bad-signature", "short-signature")
        assert p.senders[i] == (None if bad else jkeys[signer_of(i)].address)
    assert p.view(17).hash(port) == j.view(17).hash(jax)    # padded: fallback row
    assert p.view(0).to_transaction().encode() == j.view(0).to_transaction().encode()


def test_columns_from_transactions_carry_identity():
    _, jax = suites("ecdsa")
    frames, _ = wire_frames("ecdsa", n=8)
    ptx = [pcol.Transaction.decode(w) for w in frames]
    jtx = [JTx.decode(w) for w in frames]
    for t, jt in zip(ptx, jtx):
        t._hash = jt.hash(jax)
    p = pcol.columns_from_transactions(ptx)
    j = jcol.columns_from_transactions(jtx)
    assert_columns_equal(p, j)
