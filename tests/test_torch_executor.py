"""The port's executor (executor/: precompiled, precompile_classic, evm,
nevm, wasm, wasm_interp, executor) against the JAX package's, exactly:
the same seeded transactions through both packages' TransactionExecutor
on each package's host suite, on both chains, compared by encoded
receipts (and their messages), changesets and state_root_with_leaves.
Covers balance, transfer and revert; EVM deploy, calls, KECCAK256,
CREATE2 and ecrecover on the native and the Python interpreter (the
vectors of tests/test_evm.py, with chip_smoke.py's probe contract); the
classic precompiles 0x01-0x09 (the go-ethereum corpora of
tests/data_bn256_pairing.py); a WASM deploy and calls (test_wasm_vm.py's
counter contract); and the DAG waves."""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest

import test_evm as vec  # tests/ is on sys.path under pytest
from data_bn256_pairing import ADD_VECTORS, MUL_VECTORS, PAIRING_VECTORS
from test_wasm_vm import _counter_contract

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the probe contract and the block traffic)

ROOTS = ("fisco_bcos_tpu", "fisco_bcos_tpu_torch")
TS = 1_700_000_000_000


class Side:
    """One package's executor on its host suite over fresh memory state."""

    def __init__(self, root: str, sm: bool, native=None):
        def m(name):
            return importlib.import_module(f"{root}.{name}")

        self.T = m("protocol")
        self.pc = m("executor.precompiled")
        self.suite = m("crypto.suite").make_suite(sm, backend="host")
        self.ex = m("executor").TransactionExecutor(self.suite)
        if native is not None:
            self.ex.evm.native = native
        self.state = m("storage.state").StateStorage(m("storage.memory").MemoryStorage())

    def txs(self, specs):
        out = []
        for to, data, sender, nonce in specs:
            tx = self.T.Transaction(to=to, input=data, nonce=nonce, block_limit=500)
            tx._sender = sender
            out.append(tx)
        return out

    def run(self, specs, number=1, dag=True):
        txs = self.txs(specs)
        if dag:
            rcs = self.ex.execute_block_dag(txs, self.state, number, TS + number, workers=4)
        else:
            rcs = [self.ex.execute_transaction(t, self.state, number, TS + number) for t in txs]
        return rcs

    def result(self, rcs):
        changes = self.state.changeset()
        root, leaves = self.ex.state_root_with_leaves(changes)
        return ([r.encode() for r in rcs], [r.message for r in rcs],
                {k: (e.value, e.deleted) for k, e in changes.items()}, root, leaves)


def both(sm: bool, blocks, native=None, dag=True):
    """Run the blocks of specs through both packages; assert equality ->
    the port's receipts."""
    sides = [Side(r, sm, native) for r in ROOTS]
    outs = []
    for side in sides:
        rcs = []
        for number, specs in enumerate(blocks, 1):
            rcs += side.run(specs(side) if callable(specs) else specs, number, dag)
        outs.append((side.result(rcs), rcs))
    (j, _), (p, rcs) = outs
    assert p[0] == j[0]          # encoded receipts: status, output, logs, gas
    assert p[1] == j[1]          # messages
    assert p[2] == j[2]          # changesets
    assert p[3] == j[3] and p[4] == j[4]   # state root and its leaves
    return rcs, sides[1]


SENDER = b"\xaa" * 20


def balance_specs(side, n=40, seed=1):
    """register n accounts, then seeded transfers (every 7th of more than
    its source holds: a revert), a balanceOf and a duplicate register."""
    pc = side.pc
    rng = np.random.default_rng(seed)
    specs = [(pc.BALANCE_ADDRESS,
              pc.encode_call("register", lambda w, i=i: w.blob(b"a%d" % i).u64(100 + i)),
              bytes([i]) * 20, f"r{i}") for i in range(n)]
    for k in range(3 * n):
        a, b = rng.choice(n, 2, replace=False)
        amt = 10 ** 6 if k % 7 == 0 else int(rng.integers(1, 30))
        specs.append((pc.BALANCE_ADDRESS,
                      pc.encode_call("transfer", lambda w, a=a, b=b, m=amt:
                                     w.blob(b"a%d" % a).blob(b"a%d" % b).u64(m)),
                      SENDER, f"t{k}"))
    specs.append((pc.BALANCE_ADDRESS, pc.encode_call("balanceOf", lambda w: w.blob(b"a3")),
                  SENDER, "q"))
    specs.append((pc.BALANCE_ADDRESS,
                  pc.encode_call("register", lambda w: w.blob(b"a3").u64(1)), SENDER, "dup"))
    return specs


@pytest.mark.parametrize("sm", [False, True], ids=["ecdsa", "sm"])
def test_balance_transfer_and_revert(sm):
    rcs, side = both(sm, [lambda s: balance_specs(s)])
    S = side.T.TransactionStatus
    assert sum(r.status == S.REVERT for r in rcs) == 18
    assert rcs[-1].status != S.OK   # duplicate register refused


@pytest.mark.parametrize("sm", [False, True], ids=["ecdsa", "sm"])
def test_dag_waves_equal_the_serial_schedule(sm):
    """The same block in conflict-free waves (a 4-thread pool) and one tx
    at a time: equal in both packages and to each other."""
    dag, _ = both(sm, [lambda s: balance_specs(s, 64, 2)], dag=True)
    serial, side = both(sm, [lambda s: balance_specs(s, 64, 2)], dag=False)
    assert [r.encode() for r in dag] == [r.encode() for r in serial]
    assert len(side.ex.plan_dag(side.txs(balance_specs(side, 64, 2)))) > 1


def evm_specs(side):
    """Deploys (STORE_RT, the probe contract, a CREATE2 factory, a
    precompile proxy) and calls into each."""
    suite = side.suite
    factory = (b"\x36" + vec.push(0) + vec.push(0) + b"\x37"            # mem = calldata
               + vec.push(42) + b"\x36" + vec.push(0) + vec.push(0) + b"\xf5"  # CREATE2
               + vec.push(0) + b"\x52" + vec.push(32) + vec.push(0) + b"\xf3")
    kp = suite.generate_keypair(b"probe-signer")
    return [(b"", vec.initcode_for(vec.STORE_RT), SENDER, "d0"),
            (b"", chip_smoke.evm_initcode(chip_smoke.probe_runtime()), SENDER, "d1"),
            (b"", vec.initcode_for(factory), SENDER, "d2"),
            (b"", vec.initcode_for(PROXY), SENDER, "d3"),
            ], kp


def _proxy() -> bytes:
    """Forwards calldata[32:] to the address in calldata[0:32] by
    STATICCALL with all gas, then returns the output (or reverts with it)."""
    head = (vec.push(32) + b"\x36" + b"\x03" + vec.push(32) + vec.push(0) + b"\x37"  # mem = cd[32:]
            + vec.push(0) + vec.push(0) + vec.push(32) + b"\x36" + b"\x03"
            + vec.push(0) + vec.push(0) + b"\x35" + b"\x5a" + b"\xfa"         # STATICCALL
            + b"\x3d" + vec.push(0) + vec.push(0) + b"\x3e")                  # RETURNDATACOPY
    fail = b"\x3d" + vec.push(0) + b"\xfd"                                     # REVERT
    dest = len(head) + 3 + len(fail)
    return (head + vec.push(dest) + b"\x57" + fail
            + b"\x5b" + b"\x3d" + vec.push(0) + b"\xf3")                        # RETURN


PROXY = _proxy()


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("sm", [False, True], ids=["ecdsa", "sm"])
def test_evm_deploy_call_keccak_create2_and_ecrecover(sm, native):
    def deploys(side):
        specs, side._kp = evm_specs(side)
        return specs

    def calls(side):
        ex, st = side.ex, side.state
        addrs = [ex.evm.nonce_of(st, SENDER)]
        n = addrs[0]
        created = [side.suite.hash(b"\xd6\x94" + SENDER + k.to_bytes(8, "big"))[12:]
                   for k in range(n - 4, n)]
        store, probe, factory, proxy = created
        probe_data = chip_smoke.probe_calldata(side.suite, side._kp, 0)
        return [(store, (0xBEEF).to_bytes(32, "big"), SENDER, "c0"),
                (probe, probe_data, SENDER, "c1"),
                (probe, probe_data[:64] + bytes(64), SENDER, "c2"),   # r = s = 0
                (factory, vec.initcode_for(vec.STORE_RT), SENDER, "c3"),
                (factory, vec.initcode_for(vec.STORE_RT), SENDER, "c4"),  # collision
                (proxy, (1).to_bytes(32, "big") + probe_data, SENDER, "c5"),
                (b"\x00" * 19 + b"\x01", probe_data, SENDER, "c6")]

    rcs, side = both(sm, [deploys, calls], native=native)
    S = side.T.TransactionStatus
    assert [r.status for r in rcs[:4]] == [S.OK] * 4
    assert int.from_bytes(rcs[4].output, "big") == 0xBEEF
    assert len(rcs[5].logs) == 1 and rcs[7].status == S.OK
    assert rcs[8].status == S.OK and rcs[8].output == bytes(32)   # CREATE2 collided
    init = vec.initcode_for(vec.STORE_RT)
    factory = rcs[2].contract_address
    want = side.suite.hash(b"\xff" + factory + (42).to_bytes(32, "big")
                           + side.suite.hash(init))[12:]
    assert rcs[7].output[12:] == want
    if not sm:
        assert rcs[5].logs[0].data[12:] == side._kp.address
        assert rcs[9].output[12:] == side._kp.address


def _blake2f(rounds=12):
    from fisco_bcos_tpu_torch.executor import precompile_classic as pcc

    h = list(pcc._IV)
    h[0] ^= 0x01010040
    return (rounds.to_bytes(4, "big") + b"".join(x.to_bytes(8, "little") for x in h)
            + b"abc".ljust(128, b"\x00") + (3).to_bytes(8, "little") + bytes(8) + b"\x01")


def _modexp(b, e, m):
    def n(x):
        return (x.bit_length() + 7) // 8 or 1
    return (n(b).to_bytes(32, "big") + n(e).to_bytes(32, "big") + n(m).to_bytes(32, "big")
            + b.to_bytes(n(b), "big") + e.to_bytes(n(e), "big") + m.to_bytes(n(m), "big"))


CLASSIC = [
    (1, "ecrecover"), (2, b"sha256 input"), (3, b"ripemd160 input"), (4, b"identity \x00\x01"),
    (5, _modexp(3, 2 ** 200 + 7, 2 ** 255 - 19)), (5, _modexp(0, 0, 1)),
    *[(6, bytes.fromhex(v[1])) for v in ADD_VECTORS[:3]],
    *[(7, bytes.fromhex(v[1])) for v in MUL_VECTORS[:3]],
    (8, b""), (8, bytes.fromhex(PAIRING_VECTORS[0][1])),
    (9, _blake2f()), (9, _blake2f()[:100]),
]


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_classic_precompiles(native):
    """0x01-0x09 through the proxy contract, at the chain's default and at
    compatibility_version 1.1.0 (the pairing's gate), both interpreters."""
    def setup(side):
        specs, side._kp = evm_specs(side)
        return specs[3:]

    def calls(side):
        n = side.ex.evm.nonce_of(side.state, SENDER)
        proxy = side.suite.hash(b"\xd6\x94" + SENDER + (n - 1).to_bytes(8, "big"))[12:]
        out = []
        for k, (which, data) in enumerate(CLASSIC):
            if data == "ecrecover":
                data = chip_smoke.probe_calldata(side.suite, side._kp, 5)
            out.append((proxy, which.to_bytes(32, "big") + data, SENDER, f"p{k}"))
        return out

    def gate(side):
        from fisco_bcos_tpu_torch.codec.wire import Writer  # the same bytes in both

        led = importlib.import_module(side.T.__name__.rsplit(".", 1)[0] + ".ledger.ledger")
        side.state.set(led.SYS_CONFIG, led.SYSTEM_KEY_COMPATIBILITY_VERSION.encode(),
                       Writer().text("1.1.0").i64(0).bytes())
        return []

    rcs, side = both(False, [setup, calls, gate, calls], native=native)
    S = side.T.TransactionStatus
    n = len(CLASSIC)
    first, second = rcs[1:1 + n], rcs[1 + n:]
    assert first[0].output[12:] == side._kp.address
    assert first[-3].status != S.OK                       # the pairing, gated
    assert second[-3].output.hex() == PAIRING_VECTORS[0][2]
    assert second[-2].output == __import__("hashlib").blake2b(b"abc").digest()
    assert second[-1].status != S.OK


@pytest.mark.parametrize("sm", [False, True], ids=["ecdsa", "sm"])
def test_wasm_deploy_and_calls(sm):
    code = _counter_contract()

    def deploy(side):
        return [(b"", code, SENDER, "w0")]

    def calls(side):
        scale = importlib.import_module(side.T.__name__.rsplit(".", 1)[0] + ".codec.scale")
        ex, st = side.ex, side.state
        addr = side._addr

        def call(func, args, nonce):
            return (addr, scale.Encoder().string(func).raw(args).bytes(), SENDER, nonce)
        return [call("add", (5).to_bytes(8, "little"), "w1"),
                call("add", (37).to_bytes(8, "little"), "w2"),
                call("spin", b"", "w3"), call("fail", b"", "w4"),
                call("add", (0).to_bytes(8, "little"), "w5")]

    def run(side_root):
        side = Side(side_root, sm)
        rc = side.run(deploy(side), 1)
        side._addr = rc[0].contract_address
        rcs = rc + side.run(calls(side), 2)
        return side, rcs

    (js, jr), (ps, pr) = run(ROOTS[0]), run(ROOTS[1])
    assert ps.result(pr) == js.result(jr)
    S = ps.T.TransactionStatus
    assert [r.status for r in pr] == [S.OK, S.OK, S.OK, S.OUT_OF_GAS, S.REVERT, S.OK]
    assert int.from_bytes(pr[-1].output, "little") == 42


@pytest.mark.parametrize("sm", [False, True], ids=["ecdsa", "sm"])
def test_block_traffic_of_the_card_phase(sm):
    """chip_smoke.exec_traffic's two blocks (a probe deploy and registers,
    then transfers with reverts and probe calls) at 300 txs: equal in both
    packages and to the Python replay of the balances."""
    from fisco_bcos_tpu_torch.crypto.suite import make_suite

    host = make_suite(sm, backend="host")
    tr = chip_smoke.exec_traffic(host, 300, nsigned=32 if not sm else None)
    frames = [[t.encode() for t in b] for b in tr["blocks"]]

    def block(k):
        def specs(side):
            txs = [side.T.Transaction.decode(f) for f in frames[k]]
            return [(t.to, t.input, t.sender(side.suite), t.nonce) for t in txs]
        return specs

    rcs, side = both(sm, [block(0), block(1)])
    bal = chip_smoke.replay_balances(tr)
    pc = side.pc
    got = {k[1]: int.from_bytes(v[0], "big") for k, v in side.result(rcs)[2].items()
           if k[0] == pc.T_BALANCE}
    assert got == bal
    assert rcs[0].contract_address == tr["probe"]
