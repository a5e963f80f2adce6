"""The seam between the JAX package's node and the port's suite: the JAX
`Node` (init/node.py, `suite=`) built with the port's CryptoSuite commits
the same blocks as with the JAX package's suite. A solo node takes the
port's tensor path ("device", on the CPU) for admission, roots and seals;
a 4-node PBFT chain takes the port's "auto" backend (its batches are
below device_min_batch, so the host path), as a tensor path at every
PBFT message would stall on the CPU. Both chains. Compared: every block's
state, tx and receipt roots and the c_balance rows; not header hashes,
which carry the seal time.
"""

import time

import pytest
import torch

from fisco_bcos_tpu.crypto import suite as jsuite
from fisco_bcos_tpu.executor import precompiled as pc
from fisco_bcos_tpu.init.node import Node, NodeConfig
from fisco_bcos_tpu.ledger.ledger import ConsensusNode
from fisco_bcos_tpu.net.gateway import FakeGateway
from fisco_bcos_tpu.protocol import Transaction
from fisco_bcos_tpu_torch.crypto import suite as psuite

CHAINS = ("ecdsa", "sm")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def wait_until(pred, timeout):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.02)
    return False


def batches(kind: str):
    """Wire frames of two blocks, signed once on the JAX host suite:
    register alice and bob and move 7 from alice to bob, then move 5
    back."""
    j = jsuite.make_suite(kind == "sm", backend="host")
    kp = j.generate_keypair(b"seam-user")
    calls = [[("register", lambda w: w.blob(b"alice").u64(1000)),
              ("register", lambda w: w.blob(b"bob").u64(10)),
              ("transfer", lambda w: w.blob(b"alice").blob(b"bob").u64(7))],
             [("transfer", lambda w: w.blob(b"bob").blob(b"alice").u64(5))]]
    out, n = [], 0
    for block in calls:
        frames = []
        for method, args in block:
            tx = Transaction(to=pc.BALANCE_ADDRESS, input=pc.encode_call(method, args),
                             nonce=f"seam{n}", block_limit=100).sign(j, kp)
            frames.append(tx.encode())
            n += 1
        out.append(frames)
    return out


def chain_state(node):
    """Every committed block's (number, state, tx, receipt roots) and the
    c_balance rows."""
    heads = []
    for n in range(1, node.ledger.current_number() + 1):
        h = node.ledger.header_by_number(n)
        heads.append((n, h.state_root, h.txs_root, h.receipts_root))
    rows = {k: node.storage.get(pc.T_BALANCE, k) for k in node.storage.keys(pc.T_BALANCE)}
    return heads, rows


def run_solo(suite, kind, blocks):
    node = Node(NodeConfig(sm_crypto=kind == "sm", min_seal_time=0.0, profile_hz=0,
                           scheduler_workers=0),
                keypair=suite.generate_keypair(b"seam-solo"), suite=suite)
    node.build_genesis()
    try:
        node.start()
        for k, frames in enumerate(blocks):
            res = node.txpool.submit_batch([Transaction.decode(w) for w in frames])
            assert [int(r.status) for r in res] == [0] * len(frames)
            assert wait_until(lambda: node.ledger.current_number() >= k + 1, 120)
        return chain_state(node)
    finally:
        node.stop()


def run_pbft(suite, kind, blocks):
    gateway = FakeGateway()
    keys = [suite.generate_keypair(bytes([i + 1]) * 16) for i in range(4)]
    sealers = [ConsensusNode(kp.pub_bytes) for kp in keys]
    nodes = []
    try:
        for kp in keys:
            node = Node(NodeConfig(consensus="pbft", sm_crypto=kind == "sm",
                                   min_seal_time=0.0, view_timeout=2.0, profile_hz=0,
                                   scheduler_workers=0),
                        keypair=kp, gateway=gateway, suite=suite)
            node.build_genesis(sealers)
            nodes.append(node)
        for node in nodes:
            node.start()
        for k, frames in enumerate(blocks):
            for node in nodes:
                node.txpool.submit_batch([Transaction.decode(w) for w in frames])
            assert wait_until(lambda: all(n.ledger.current_number() >= k + 1
                                          for n in nodes), 120), \
                [n.ledger.current_number() for n in nodes]
        return [chain_state(n) for n in nodes]
    finally:
        for node in nodes:
            node.stop()
        gateway.stop()


@pytest.mark.parametrize("kind", CHAINS)
def test_solo_node_on_the_port_tensor_path_commits_the_jax_suite_block(kind):
    blocks = batches(kind)[:1]
    want = run_solo(jsuite.make_suite(kind == "sm", backend="host"), kind, blocks)
    got = run_solo(psuite.make_suite(kind == "sm", device="cpu"), kind, blocks)
    assert got == want
    heads, rows = got
    assert len(heads) == 1
    assert rows == {b"alice": (993).to_bytes(16, "big"), b"bob": (17).to_bytes(16, "big")}


@pytest.mark.parametrize("kind", CHAINS)
def test_four_node_pbft_chain_on_the_port_suite_commits_the_jax_suite_chain(kind):
    blocks = batches(kind)
    want = run_pbft(jsuite.make_suite(kind == "sm", backend="auto"), kind, blocks)
    got = run_pbft(psuite.make_suite(kind == "sm", backend="auto", device="cpu"),
                   kind, blocks)
    assert got == want
    assert all(state == got[0] for state in got)
    heads, rows = got[0]
    assert len(heads) == 2
    assert rows == {b"alice": (998).to_bytes(16, "big"), b"bob": (12).to_bytes(16, "big")}
