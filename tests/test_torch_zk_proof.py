"""The port's proof plane (zk/proof.py) against the JAX package's:
`verify_inclusion_batch` on the port's suite on the tensor path
(backend "device", device="cpu": the plain hash path the card's
keccak256_varlen / sm3_varlen kernels are held to) against the JAX host
suite's, over width-16 trees of 1, 17 and 4,097 leaves on both chains,
with tampered siblings, positions, leaves and roots. One device-path
hash batch a chain (the CPU cost note in ROADMAP.md); the JSON helpers
round-trip the same documents in both packages.
"""

import numpy as np
import pytest
import torch

import test_torch_rpc as rpc  # tests/ is on sys.path under pytest
from fisco_bcos_tpu.crypto import suite as jsuite
from fisco_bcos_tpu.ops import merkle as jmerkle
from fisco_bcos_tpu.zk import proof as jproof
from fisco_bcos_tpu_torch.crypto import suite as psuite
from fisco_bcos_tpu_torch.ops import merkle as pmerkle
from fisco_bcos_tpu_torch.zk import proof as pproof

TREES = (1, 17, 4097)
SEED = 20261018


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flip(b: bytes) -> bytes:
    return b[:-1] + bytes([b[-1] ^ 1])


def proof_items(alg: str):
    """(leaf, proof, root) items over the three trees, the JAX package's
    levels and proofs (the port's must be the same), then each tamper:
    a sibling, the position, the leaf, the root. -> (items, the verdicts
    they must get)."""
    rng = np.random.default_rng(SEED)
    items, want = [], []
    for n in TREES:
        leaves = [rng.bytes(32) for _ in range(n)]
        levels = jmerkle.merkle_levels_host(leaves, alg)
        assert pmerkle.merkle_levels_host(leaves, alg) == levels
        root = levels[-1][0]
        picks = sorted({0, n - 1, n // 2, *map(int, rng.integers(0, n, 4))})
        for i in picks:
            proof = jmerkle.proof_from_levels(levels, i)
            assert pmerkle.proof_from_levels(levels, i) == proof
            items.append((leaves[i], proof, root))
            want.append(True)
        for j, i in enumerate(picks):
            proof = [(list(s), p) for s, p in jmerkle.proof_from_levels(levels, i)]
            what = j % 4
            leaf, r = leaves[i], root
            if what == 0 and proof:
                lvl = len(proof) - 1 if j % 2 else 0
                s, p = proof[lvl]
                s[(p + 1) % 16] = _flip(s[(p + 1) % 16])
            elif what == 1 and proof:
                s, p = proof[0]
                proof[0] = (s, (p + 1) % 16)
            elif what == 2:
                leaf = _flip(leaf)
            else:
                r = _flip(root)
            items.append((leaf, proof, r))
            # a flipped sibling in a padding slot or beside an equal leaf
            # is still a changed node: every tamper must fail
            want.append(False)
    return items, want


@pytest.mark.parametrize("kind", rpc.CHAINS)
def test_verify_inclusion_batch_on_the_tensor_path_matches_jax(kind):
    sm = kind == "sm"
    host = jsuite.make_suite(sm, backend="host")
    port = psuite.make_suite(sm, backend="device", device="cpu")
    items, want = proof_items(host.hash_name)
    nodes = sum(len(p) for _, p, _ in items)
    assert port._use_device(nodes) and port.device.type == "cpu"
    calls = []
    hb = port.hash_batch
    port.hash_batch = lambda msgs: calls.append(len(msgs)) or hb(msgs)
    got = pproof.verify_inclusion_batch(port, items)
    expect = jproof.verify_inclusion_batch(host, items)
    assert calls == [nodes]
    assert got.dtype == expect.dtype == bool
    assert got.tolist() == expect.tolist() == want
    assert pproof.verify_inclusion_batch(port, []).tolist() == []


@pytest.mark.parametrize("kind", rpc.CHAINS)
def test_proof_json_helpers_match_jax(kind):
    alg = "sm3" if kind == "sm" else "keccak256"
    items, _ = proof_items(alg)
    for _, proof, _ in items[:12]:
        doc = pproof.w16_proof_json(proof)
        assert doc == jproof.w16_proof_json(proof)
        back = pproof.w16_proof_from_json(doc)
        assert back == jproof.w16_proof_from_json(doc)
        assert [(list(s), p) for s, p in proof] == back
