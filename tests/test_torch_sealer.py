"""The port's sealer (sealer/sealer.py) against the JAX package's, exactly:
the same wire frames admitted into each package's txpool, then grants
driven through the sealer's worker step with a pinned clock. The
proposals (header, tx hashes and txs, byte for byte), the consumed and
re-armed rounds, the refused-proposal path, the fill window, the health
gate and the committed-height revoke must be the same. The sealer calls
no crypto, so the port's pool runs on "auto" (its host path at these
sizes) beside the JAX package's host suite.
"""

import importlib
import time

import pytest
import torch

import test_torch_columnar as frames  # tests/ is on sys.path under pytest
from fisco_bcos_tpu.crypto import suite as jsuite
from fisco_bcos_tpu_torch.crypto import suite as psuite

ROOTS = ("fisco_bcos_tpu", "fisco_bcos_tpu_torch")
CLOCK_MS = 1_700_000_000_123


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _suite(root: str, kind: str):
    sm = kind == "sm"
    if root == "fisco_bcos_tpu":
        return jsuite.make_suite(sm, backend="host")
    return psuite.make_suite(sm, backend="auto", device="cpu")


class Side:
    """One package's ledger, txpool and sealer; the sealer's proposals are
    captured, and accepted unless `refuse` is set."""

    def __init__(self, root: str, kind: str, limit: int = 8, min_seal_time: float = 0.0,
                 gate=None, refuse: bool = False):
        def m(name):
            return importlib.import_module(f"{root}.{name}")

        self.suite = _suite(root, kind)
        self.L = m("ledger.ledger")
        self.storage = m("storage.memory").MemoryStorage()
        self.ledger = self.L.Ledger(self.storage, self.suite)
        jkeys, _ = frames.sender_keys(kind)
        self.ledger.build_genesis([self.L.ConsensusNode(k.pub_bytes) for k in jkeys],
                                  tx_count_limit=limit)
        self.pool = m("txpool").TxPool(self.suite, self.ledger, pool_limit=64)
        self.proposals = []
        self.refuse = refuse
        self.sealer = m("sealer").Sealer(
            self.pool, self.suite, self._submit, max_txs_per_block=limit,
            min_seal_time=min_seal_time, clock_ms=lambda: CLOCK_MS, gate=gate,
            current_height=self.ledger.current_number)
        self.T = m("protocol")

    def _submit(self, block) -> bool:
        self.proposals.append(block.encode())
        return not self.refuse

    def admit(self, wires):
        res = self.pool.submit_batch([self.T.Transaction.decode(w) for w in wires])
        return [(r.tx_hash, int(r.status)) for r in res]


def _valid_wires(kind: str, n: int = 24):
    wires, txs = frames.wire_frames(kind, n=n, seed=21, tag="s")
    return [w for i, (w, t) in enumerate(zip(wires, txs))
            if t is not None and i not in frames.SPECIAL]


def _pair(kind: str, **kw):
    return [Side(root, kind, **kw) for root in ROOTS]


@pytest.mark.parametrize("kind", frames.CHAINS)
def test_sealer_seals_the_same_proposals_from_the_same_pool(kind):
    """Grants for heights 1 and 2 under view 0: each worker step seals up
    to the block limit in the pool's order, stamps the pinned clock and
    consumes the round; a re-delivered grant for a consumed round seals
    nothing; the pools count the same sealed and pending txs."""
    wires = _valid_wires(kind)
    out = []
    for side in _pair(kind):
        admitted = side.admit(wires)
        trail = []
        side.sealer.grant(1, 0)
        side.sealer.grant(2, 0, max_txs=5)
        for _ in range(3):
            trail.append(side.sealer.execute_worker())
        side.sealer.grant(1, 0)  # consumed: not re-armed
        trail.append(side.sealer.execute_worker())
        out.append((admitted, side.proposals, trail, side.pool.pending_count(),
                    side.pool.status()))
    assert out[0] == out[1]
    admitted, proposals, trail, _, _ = out[1]
    assert all(st == 0 for _, st in admitted) and len(proposals) == 2
    assert trail == [0.0, 0.0, None, None]


@pytest.mark.parametrize("kind", frames.CHAINS)
def test_refused_proposal_returns_its_txs_and_solo_re_arms(kind):
    """A refused proposal goes back to the pool; the solo view's grant is
    re-armed for the same height, a consensus view's is not."""
    wires = _valid_wires(kind)
    out = []
    for side in _pair(kind, refuse=True):
        side.admit(wires)
        side.sealer.set_should_seal(True, 1)          # solo: view -1
        first = side.sealer.execute_worker()
        after_solo = (side.pool.pending_count(), dict(side.sealer._grants))
        side.sealer.revoke(5)
        side.sealer.grant(1, 3)                         # a consensus view
        side.sealer.execute_worker()
        after_view = (side.pool.pending_count(), dict(side.sealer._grants),
                      sorted(side.sealer._done))
        out.append((first, after_solo, after_view, side.proposals))
    assert out[0] == out[1]
    assert out[1][1][1] == {1: (-1, 8)} and out[1][2][1] == {}


@pytest.mark.parametrize("kind", frames.CHAINS)
def test_fill_window_gate_and_committed_height(kind):
    """Below the block limit the sealer waits out min_seal_time (a timed
    re-run) before sealing a partial block; a closed health gate holds it
    at a 50 ms poll; grants at or below the committed height are dropped."""
    wires = _valid_wires(kind)[:3]
    out = []
    for root in ROOTS:
        open_gate = [False]
        side = Side(root, kind, min_seal_time=0.2, gate=lambda g=open_gate: g[0])
        side.admit(wires)
        side.sealer.grant(0, 0)   # at the committed height (genesis): dropped
        side.sealer.grant(1, 0)
        gated = side.sealer.execute_worker()
        open_gate[0] = True
        wait = side.sealer.execute_worker()
        before = list(side.proposals)
        time.sleep(0.25)
        sealed = side.sealer.execute_worker()
        out.append((gated, wait is not None and 0 < wait <= 0.2, before, sealed,
                    side.proposals, dict(side.sealer._grants)))
    assert out[0] == out[1]
    assert out[1][0] == 0.05 and out[1][1] and out[1][2] == [] and len(out[1][4]) == 1


@pytest.mark.parametrize("kind", frames.CHAINS)
def test_sealer_thread_proposes_on_grant(kind):
    """The worker thread, event-driven: a grant wakes it and the proposal
    it seals is the same in both packages."""
    wires = _valid_wires(kind)
    out = []
    for side in _pair(kind):
        side.admit(wires)
        side.sealer.start()
        try:
            side.sealer.grant(1, 0)
            t0 = time.monotonic()
            while not side.proposals and time.monotonic() - t0 < 120:
                time.sleep(0.005)
        finally:
            side.sealer.stop()
        out.append(side.proposals)
    assert out[0] == out[1] and len(out[1]) == 1
