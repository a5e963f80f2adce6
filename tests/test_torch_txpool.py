"""The port's txpool and ingest lane (txpool/) against the JAX package's,
exactly: the same seeded wire frames on both chains, admitted through the
ingest lane's columnar door into a pool small enough to shed and evict
at its watermarks, then a second batch straight into submit_columns and
a third through submit_batch, sealing, fill_block, committed blocks and
the pool's view of them. The statuses, hashes and senders of every
result, the drop records, the seal order and the pool's counts must be
identical. The port runs on its CPU tensor path, the JAX package on its
host suite.
"""

import pytest
import torch

import test_torch_columnar as frames  # tests/ is on sys.path under pytest
from test_torch_ledger import pair

POOL_LIMIT = 16  # watermarks 11 and 15: 32 frames climb past both


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _results(res):
    return [(r.tx_hash, int(r.status), r.sender) for r in res]


def _through_lane(side, wires):
    """Every frame into the side's ingest lane before its dispatcher
    starts, so that one drain admits them in one submit_columns call."""
    lane = side.txpool_mod.IngestLane(side.pool, max_batch=64, queue_cap=64)
    try:
        tasks = [lane.submit_wire_async(w) for w in wires]
        lane.start()
        out = [t.result(120) for t in tasks]
        stats = lane.stats()
    finally:
        lane.stop()
    assert lane._thread is None
    return out, stats


def _signed(wire: bytes, jax_suite, key, *, suffix=b"", **fields) -> bytes:
    """`wire`'s tx with its input extended by `suffix` and `fields` set,
    signed again on the JAX host suite."""
    from fisco_bcos_tpu.protocol import Transaction as JTx

    tx = JTx.decode(wire)
    tx.input = tx.input + suffix
    for k, v in fields.items():
        setattr(tx, k, v)
    tx._unsigned = tx._wire = None
    return tx.sign(jax_suite, key).encode()


@pytest.mark.parametrize("kind", frames.CHAINS)
def test_admission_sealing_and_commit_match_jax(kind):
    p, j = pair(kind, pool_limit=POOL_LIMIT)
    _, jax = frames.suites(kind)
    jkeys, _ = frames.sender_keys(kind)
    wires, _ = frames.wire_frames(kind)
    S = p.T.TransactionStatus

    # -- batch 1: the ingest lane's wire door, one drain ---------------------
    pr, pstats = _through_lane(p, wires)
    jr, jstats = _through_lane(j, wires)
    assert _results(pr) == _results(jr)
    assert pstats["batches_total"] == jstats["batches_total"] == 1
    got = {frames.SPECIAL.get(i): S(r.status) for i, r in enumerate(pr)
           if i in frames.SPECIAL}
    assert got["foreign-chain"] == S.INVALID_CHAINID
    assert got["foreign-group"] == S.INVALID_GROUPID
    assert got["expired"] == got["beyond-range"] == S.BLOCK_LIMIT_CHECK_FAIL
    assert got["bad-signature"] == got["short-signature"] == S.INVALID_SIGNATURE
    assert got["malformed"] == S.REQUEST_NOT_BELIEVABLE and pr[15].tx_hash == b""
    assert got["repeat"] == S.ALREADY_IN_TXPOOL
    statuses = {S(r.status) for r in pr}
    assert S.TXPOOL_FULL in statuses and S.OK in statuses
    for i, r in enumerate(pr):
        if r.status == S.OK:
            assert r.sender == jkeys[frames.signer_of(i)].address
    hashes = [r.tx_hash for r in pr if r.tx_hash]
    drops = [p.pool.dropped_status(h) for h in hashes]
    assert drops == [j.pool.dropped_status(h) for h in hashes]
    assert p.pool.status() == j.pool.status()
    assert p.pool.pending_count() == j.pool.pending_count() > 0

    # -- batch 2: submit_columns directly; every row fails before crypto ------
    admitted = [i for i, r in enumerate(pr) if r.status == S.OK]
    key = jkeys[frames.signer_of(admitted[1])]
    again = [wires[admitted[0]], _signed(wires[admitted[1]], jax, key, suffix=b"+")]
    p2 = p.pool.submit_columns(p.columnar.decode_columns(again))
    j2 = j.pool.submit_columns(j.columnar.decode_columns(again))
    assert _results(p2) == _results(j2)
    assert [S(r.status) for r in p2] == [S.ALREADY_IN_TXPOOL, S.NONCE_CHECK_FAIL]

    # -- batch 3: the object door (submit_batch) between the watermarks and at
    # the high one: a short-lived band-0 tx is shed, a band-2 tx evicts. On
    # the default chain only: the verdicts do not depend on the chain, and
    # the SM chain's plain EC path costs ~16 s a call on the CPU -----------
    if kind == "ecdsa":
        extra = [_signed(wires[admitted[1]], jax, key, suffix=b"x%d" % k, nonce=f"x{k}",
                         block_limit=limit, attribute=band << 24)
                 for k, (band, limit) in enumerate(((0, 3), (0, 400), (0, 400), (2, 400)))]
        p3 = p.pool.submit_batch([p.T.Transaction.decode(w) for w in extra])
        j3 = j.pool.submit_batch([j.T.Transaction.decode(w) for w in extra])
        assert _results(p3) == _results(j3)
        assert [S(r.status) for r in p3] == [S.DEADLINE_UNMEETABLE, S.OK, S.OK, S.OK]
        drops = [p.pool.dropped_status(h) for h in hashes]
        assert drops == [j.pool.dropped_status(h) for h in hashes]
        assert drops.count(S.TXPOOL_EVICTED) == 1   # the band-2 tx took a band-0 slot
        assert p.pool.status() == j.pool.status()
        hashes += [r.tx_hash for r in p3]

    # -- seal, fill, commit block 1 ---------------------------------------------
    ptx, phs = p.pool.seal(8)
    jtx, jhs = j.pool.seal(8)
    assert phs == jhs and len(phs) == 8
    assert [t.encode() for t in ptx] == [t.encode() for t in jtx]
    assert [t.encode() for t in p.pool.fill_block(phs)] == [t.encode() for t in ptx]
    assert p.pool.fill_block(phs + [b"\x02" * 32]) is None
    assert p.pool.missing_hashes(phs + [b"\x02" * 32]) == [b"\x02" * 32]
    assert p.pool.verify_proposal(p.T.Block(header=p.T.BlockHeader(number=1),
                                            transactions=ptx))
    ph, jh = p.commit_block(1, ptx), j.commit_block(1, jtx)
    assert ph.encode() == jh.encode() and p.rows() == j.rows()
    assert p.pool.pending_count() == j.pool.pending_count()
    assert p.pool.status() == j.pool.status()
    assert p.pool.known_nonces() == j.pool.known_nonces()
    assert p.pool.wait_for_receipt(phs[0], 1).encode() == j.ledger.receipt(phs[0]).encode()

    # -- after the commit: a committed frame is known; short-lived txs expire --
    committed = [wires[i] for i, r in enumerate(pr) if r.tx_hash == phs[0]]
    p4 = p.pool.submit_columns(p.columnar.decode_columns(committed))
    j4 = j.pool.submit_columns(j.columnar.decode_columns(committed))
    assert _results(p4) == _results(j4) and p4[0].status == S.ALREADY_KNOWN
    prest, _ = p.pool.seal(64, for_number=3)
    jrest, _ = j.pool.seal(64, for_number=3)
    assert [t.encode() for t in prest] == [t.encode() for t in jrest]
    assert ([p.pool.dropped_status(h) for h in hashes]
            == [j.pool.dropped_status(h) for h in hashes])
    p.commit_block(2, prest)
    j.commit_block(2, jrest)
    assert p.rows() == j.rows()
    assert p.pool.pending_count() == j.pool.pending_count() == 0
