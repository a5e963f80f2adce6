"""The port's DMC message rounds (scheduler/dmc_rounds.py: DmcMessage,
the thread-bridged executives, ShardExecutor, DmcRoundScheduler) and
utils/trace.DmcStepRecorder against the JAX package's: the same signed
blocks (frames signed on the JAX host suite, decoded by each package)
through each package's round scheduler over two shards, compared by
encoded receipts, the state rows and the recorder's round checksums.
Covers a cross-shard round trip, a nested re-entrant chain, two contexts
on opposite shards, a deadlock whose higher context reverts and re-runs,
a reverted tx's remote writes discarded, precompiles routed to their home
shard, and chip_smoke.py's rounds block (phase 18) on both chains, once
with its senders recovered in one batch on the port's tensor path."""

import importlib
import sys
from pathlib import Path

import pytest

import test_dmc_rounds as jt  # tests/ is on sys.path under pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the rounds block of phase 18)

ROOTS = ("fisco_bcos_tpu", "fisco_bcos_tpu_torch")
A, B, C = b"\xaa" * 20, b"\xbb" * 20, b"\xcc" * 20
A1, B1, B2, A2 = b"\xa1" * 20, b"\xb1" * 20, b"\xb2" * 20, b"\xa2" * 20


def mod(root: str, name: str):
    return importlib.import_module(f"{root}.{name}")


def signed(to_data, seed: bytes, sm: bool = False) -> list:
    """Frames of txs (to, input) signed on the JAX host suite."""
    from fisco_bcos_tpu.crypto.suite import make_suite
    from fisco_bcos_tpu.protocol import Transaction

    suite = make_suite(sm, backend="host")
    kp = suite.generate_keypair(seed)
    return [Transaction(to=to, input=data, nonce=f"n{i}", block_limit=100)
            .sign(suite, kp).encode() for i, (to, data) in enumerate(to_data)]


def run(root: str, code: dict, blocks, shard_of, sm: bool = False, suite=None, senders=None):
    """Each block of frames through one package's DmcRoundScheduler over
    two ShardExecutors on one base state. -> (encoded receipts a block,
    the state rows, the round checksums, shards)."""
    from_code = mod(root, "executor.evm")
    T = mod(root, "protocol")
    if suite is None:
        suite = mod(root, "crypto.suite").make_suite(sm, backend="host")
    base = mod(root, "storage.state").StateStorage(mod(root, "storage.memory").MemoryStorage())
    for addr, c in code.items():
        base.set(from_code.T_CODE, addr, c)
    R = mod(root, "scheduler.dmc_rounds")
    shards = [R.ShardExecutor(b"shard-%d" % i, suite, owns=lambda a, i=i: shard_of(a) == i)
              for i in range(2)]
    sched = R.DmcRoundScheduler(shards)
    rec = mod(root, "utils.trace").DmcStepRecorder()
    out = []
    for frames in blocks:
        txs = [T.Transaction.decode(f) for f in frames]
        if senders is not None:
            senders(txs, suite)
        rcs = sched.execute_block(txs, base, 1, 0, recorder=rec)
        out.append([r.encode() for r in rcs])
    rows = sorted((t, k, e.value, e.deleted) for (t, k), e in base.changeset().items())
    return out, rows, rec.checksums(), shards


def both(code, blocks, shard_of, sm=False):
    """-> the port's run, asserted equal to the JAX package's."""
    j = run(ROOTS[0], code, blocks, shard_of, sm)
    p = run(ROOTS[1], code, blocks, shard_of, sm)
    assert p[0] == j[0]        # receipts
    assert p[1] == j[1]        # state rows
    assert p[2] == j[2] and p[2]   # round checksums
    return p


def statuses(receipts):
    T = mod(ROOTS[1], "protocol")
    return [T.Receipt.decode(r) for r in receipts]


def store(rows, addr: bytes, slot: int = 0):
    key = addr + slot.to_bytes(32, "big")
    got = [v for t, k, v, d in rows if t == mod(ROOTS[1], "executor.evm").T_STORE and k == key]
    return int.from_bytes(got[0], "big") if got else None


def test_cross_shard_round_trip_matches_jax():
    code = {A: jt._call_forward(B), B: jt.LEAF}
    rcs, rows, cks, _ = both(code, [signed([(A, b"")], b"dmc-user")],
                             lambda a: 0 if a == A else 1)
    [rc] = statuses(rcs[0])
    assert rc.status == 0 and int.from_bytes(rc.output, "big") == 42
    assert store(rows, B) == 7 and store(rows, A) == 1
    assert len(cks) == 1   # the routed CALL joins the round it was made in


def test_nested_reentrant_chain_matches_jax():
    code = {A: jt._call_forward(B), B: jt._call_forward(C), C: jt.LEAF}
    rcs, rows, _, _ = both(code, [signed([(A, b"")], b"dmc-user2")],
                           lambda a: 1 if a == B else 0)
    [rc] = statuses(rcs[0])
    assert rc.status == 0 and int.from_bytes(rc.output, "big") == 42
    assert store(rows, C) == 7


def test_two_contexts_on_opposite_shards_match_jax():
    code = {A: jt.LEAF, B: jt.LEAF}
    rcs, rows, _, _ = both(code, [signed([(A, b""), (B, b"")], b"dmc-user3")],
                           lambda a: 0 if a == A else 1)
    assert [r.status for r in statuses(rcs[0])] == [0, 0]
    assert store(rows, A) == store(rows, B) == 7


def test_deadlock_reverts_the_higher_context_as_jax_does():
    code = {A1: jt._call_forward(B1), B1: jt.LEAF, B2: jt._call_forward(A2), A2: jt.LEAF}
    rcs, rows, cks, _ = both(code, [signed([(A1, b""), (B2, b"")], b"dmc-user4")],
                             lambda a: 0 if a in (A1, A2) else 1)
    assert [r.status for r in statuses(rcs[0])] == [0, 0]
    assert [store(rows, a) for a in (B1, A2, A1, B2)] == [7, 7, 1, 1]
    assert len(cks) >= 3   # the deadlocked round, the revert, the re-run


def test_reverted_tx_discards_remote_shard_writes_as_jax_does():
    code_a = (b"\x60\x20\x5f\x5f\x5f\x5f" + jt._push_addr(B) + b"\x61\xff\xff\xf1"
              + b"\x50" + b"\x5f\x5f\xfd")   # CALL B, pop, REVERT(0, 0)
    rcs, rows, _, _ = both({A: code_a, B: jt.LEAF}, [signed([(A, b"")], b"dmc-rv")],
                           lambda a: 0 if a == A else 1)
    assert statuses(rcs[0])[0].status != 0
    assert store(rows, B) is None


def test_precompile_routed_to_its_home_shard_as_jax_does():
    from fisco_bcos_tpu.codec.wire import Reader
    from fisco_bcos_tpu.executor import precompiled as pc

    frames = signed([(pc.BALANCE_ADDRESS, pc.encode_call(
        "register", lambda w: w.blob(b"dmcacct").u64(9))),
        (pc.BALANCE_ADDRESS, pc.encode_call("balanceOf", lambda w: w.blob(b"dmcacct")))],
        b"dmc-pc")
    rcs, _, _, shards = both({}, [frames[:1], frames[1:]], lambda a: 1 if a == A else -1)
    assert shards[0].precompile_home and not shards[1].precompile_home
    assert statuses(rcs[0])[0].status == 0
    assert Reader(statuses(rcs[1])[0].output).u64() == 9


@pytest.mark.parametrize("sm,n", [(False, 24), (True, 12)], ids=["ecdsa", "sm"])
def test_the_card_phase_rounds_block_matches_jax(sm, n):
    """chip_smoke.dmc_traffic: cross-shard chains rooted on shard 0,
    shard-1-local chains and, last, the pair taking the shards in opposite
    orders; every tx succeeds, the last context reverts on deadlock."""
    frames = chip_smoke.dmc_traffic(mod(ROOTS[1], "crypto.suite").make_suite(sm, backend="host"), n)
    code = {a: chip_smoke.DMC_ROUTER for a in chip_smoke.DMC_CONTRACTS}
    rcs, rows, cks, _ = both(code, [frames], lambda a: chip_smoke.DMC_SHARD_OF.get(a), sm)
    assert [r.status for r in statuses(rcs[0])] == [0] * n
    assert len(cks) > n   # one tx a round or so, plus the deadlock rounds
    visits = [int.from_bytes(v, "big") for t, k, v, d in rows if t == "s_store" and k[20:] == bytes(32)]
    assert len(visits) == len(code) and sum(visits) > n   # each router's slot 0 counts its frames


def test_rounds_on_the_port_tensor_path_with_batched_senders():
    """The phase 18 order on the port's own device suite (device="cpu"):
    the block's senders recovered in one batch, then the rounds; equal to
    the port's and the JAX package's host-suite runs."""
    suite = mod(ROOTS[1], "crypto.suite").make_suite(device="cpu")
    assert suite.backend == "device"
    frames = chip_smoke.dmc_traffic(mod(ROOTS[1], "crypto.suite").make_suite(backend="host"), 16)
    code = {a: chip_smoke.DMC_ROUTER for a in chip_smoke.DMC_CONTRACTS}
    shard_of = chip_smoke.DMC_SHARD_OF.get
    recovered = []

    def batch(txs, s):
        senders, ok = mod(ROOTS[1], "protocol").batch_recover_senders(txs, s)
        recovered.append((len(txs), bool(ok.all())))

    dev = run(ROOTS[1], code, [frames], shard_of, suite=suite, senders=batch)
    assert recovered == [(16, True)]
    assert dev[:3] == run(ROOTS[1], code, [frames], shard_of)[:3] \
        == run(ROOTS[0], code, [frames], shard_of)[:3]
