"""The port's Scheduler (scheduler/scheduler.py, with utils/trace's block
trace) against the JAX package's, exactly: chip_smoke.py's block traffic
(a probe-contract deploy and balance registers, then transfers with
reverts and probe calls) as two pipelined blocks, block 2 executed
speculatively over block 1's uncommitted changeset, then both committed,
on both chains. The JAX side runs on its host suite; the port on
make_suite(..., backend="auto", device="cpu"), so that the state root's
hash batch (over 512 leaves, packed by length class) and its tree take
the plain tensor path. Compared: each head's state, txs and receipts
roots, every receipt, the c_balance rows and a read-only call (not
header hashes; the timestamps are pinned). 384 txs a block: the plain
Keccak costs ~65 ms a block on this CPU, and the state root's longest
leaf, the block's tx-hash list, is 32 B a tx."""

import importlib
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the block traffic)

NTX = 384


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_chain(root: str, suite, frames, sealers):
    def m(name):
        return importlib.import_module(f"{root}.{name}")

    T = m("protocol.types")
    L = m("ledger.ledger")
    storage = m("storage.memory").MemoryStorage()
    ledger = L.Ledger(storage, suite)
    ledger.build_genesis([L.ConsensusNode(p) for p in sealers], tx_count_limit=NTX)
    executor = m("executor").TransactionExecutor(suite)
    sched = m("scheduler").Scheduler(storage, ledger, executor, suite, None,
                                     pipeline=True, state_index=True)
    results = []
    try:
        for number in (1, 2):
            txs = [T.Transaction.decode(f) for f in frames[number - 1]]
            _, ok = T.batch_recover_senders(txs, suite)
            assert ok.all()
            header = T.BlockHeader(number=number, timestamp=chip_smoke.EXEC_TS + number,
                                   sealer_list=list(sealers))
            r = sched.execute_block(T.Block(header=header, transactions=txs))
            assert r is not None
            results.append(r)
        assert sched.pipeline_stats()["speculative_execs"] == 1
        for r in results:
            assert sched.commit_block(r.header)
        pc = m("executor.precompiled")
        call = T.Transaction(to=pc.BALANCE_ADDRESS, nonce="q",
                             input=pc.encode_call("balanceOf", lambda w: w.blob(b"acct7")))
        call._sender = b"\x01" * 20
        answer = sched.call(call).encode()
    finally:
        sched.shutdown()
    heads = [(r.header.state_root, r.header.txs_root, r.header.receipts_root,
              r.header.gas_used, [x.encode() for x in r.receipts]) for r in results]
    bal = {k: storage.get(pc.T_BALANCE, k) for k in storage.keys(pc.T_BALANCE)}
    return heads, bal, answer, ledger.current_number()


@pytest.mark.parametrize("sm", [False, True], ids=["ecdsa", "sm"])
def test_two_pipelined_blocks_equal_the_jax_scheduler(sm, monkeypatch):
    from fisco_bcos_tpu.crypto.suite import make_suite as j_make_suite
    from fisco_bcos_tpu_torch.crypto.suite import make_suite
    from fisco_bcos_tpu_torch.ops import keccak, merkle, sm3

    port = make_suite(sm, backend="auto", device="cpu")
    tr = chip_smoke.exec_traffic(make_suite(sm, backend="host"), NTX,
                                 nsigned=None if sm else 64)
    frames = [[t.encode() for t in b] for b in tr["blocks"]]
    sealers = [k.pub_bytes for k in chip_smoke.seal_keys(port)]
    mod, name = (keccak, "keccak256_varlen") if not sm else (sm3, "sm3_varlen")
    plain, tree = getattr(mod, name), merkle.merkle_root
    calls = {"hash": 0, "tree": 0}

    def hashed(*a):
        calls["hash"] += 1
        return plain(*a)

    def treed(*a):
        calls["tree"] += 1
        return tree(*a)

    monkeypatch.setattr(mod, name, hashed)
    monkeypatch.setattr(merkle, "merkle_root", treed)
    got = run_chain("fisco_bcos_tpu_torch", port, frames, sealers)
    want = run_chain("fisco_bcos_tpu", j_make_suite(sm, backend="host"), frames, sealers)
    assert got == want
    assert got[3] == 2
    # the state roots took the tensor path: one tree and a hash launch a
    # length class each (the receipts' batches stay under 512 on the host)
    assert calls["tree"] == 2 and calls["hash"] >= 4
    bal = {k: int.from_bytes(v, "big") for k, v in got[1].items()}
    assert bal == chip_smoke.replay_balances(tr)
