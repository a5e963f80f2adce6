"""Port's Merkle roots (fisco_bcos_tpu_torch.ops.merkle, the plain version
of kernels 4 and B) against the JAX package, bit-exact: Keccak roots
against the XLA bucketed tree and the Pallas whole-tree kernel in
interpret mode at n in {1, 2, 13, 16, 17}, SM3 roots against the XLA tree
and the JAX host levels at n in {1, 2, 17, 300}; host levels and proofs
against the JAX host path."""

import numpy as np
import pytest
import torch

from fisco_bcos_tpu.ops import merkle as jmerkle
from fisco_bcos_tpu.ops import pallas_merkle
from fisco_bcos_tpu_torch.ops import merkle

NS = [1, 2, 13, 16, 17]


def _leaves(n):
    return np.random.default_rng(100 + n).integers(0, 256, (n, 32), dtype=np.uint8)


def _bucketed(leaves):
    n = leaves.shape[0]
    nb = max(16, 1 << (n - 1).bit_length())
    out = np.zeros((nb, 32), np.uint8)
    out[:n] = leaves
    return out


@pytest.mark.parametrize("n", NS)
def test_root_matches_jax_xla_tree(n):
    leaves = _leaves(n)
    want = np.asarray(jmerkle._merkle_root_bucketed(_bucketed(leaves), np.int32(n),
                                                     "keccak256"))
    got = merkle.merkle_root(torch.as_tensor(leaves))
    np.testing.assert_array_equal(got.numpy(), want)
    plain = merkle.merkle_root_bucketed_plain(torch.as_tensor(_bucketed(leaves)), n)
    np.testing.assert_array_equal(plain.numpy(), want)


@pytest.mark.parametrize("n", NS)
def test_root_matches_pallas_interpret(n):
    leaves = _leaves(n)
    want = np.asarray(pallas_merkle.merkle_root_fused(_bucketed(leaves), n,
                                                      "keccak256", interpret=True))
    got = merkle.merkle_root(torch.as_tensor(leaves))
    np.testing.assert_array_equal(got.numpy(), want)


def test_host_levels_and_proofs_match_jax():
    leaves = [bytes(x) for x in _leaves(40)]
    levels = merkle.merkle_levels_host(leaves)
    assert levels == jmerkle.merkle_levels_host(leaves)
    root = levels[-1][0]
    for i in (0, 17, 39):
        proof = merkle.merkle_proof(leaves, i)
        assert proof == jmerkle.merkle_proof(leaves, i)
        assert merkle.verify_merkle_proof(leaves[i], proof, root)
        assert not merkle.verify_merkle_proof(b"\x01" * 32, proof, root)


@pytest.mark.parametrize("n", [1, 2, 17, 300])
def test_sm3_root_matches_jax(n):
    leaves = _leaves(n)
    want = np.asarray(jmerkle.merkle_root(leaves, "sm3"))
    got = merkle.merkle_root(torch.as_tensor(leaves), "sm3")
    np.testing.assert_array_equal(got.numpy(), want)
    host = jmerkle.merkle_levels_host([bytes(x) for x in leaves], "sm3")
    assert merkle.merkle_levels_host([bytes(x) for x in leaves], "sm3") == host
    assert bytes(got.numpy()) == host[-1][0]


def test_sm3_proofs_match_jax():
    leaves = [bytes(x) for x in _leaves(40)]
    root = merkle.merkle_levels_host(leaves, "sm3")[-1][0]
    for i in (0, 39):
        proof = merkle.merkle_proof(leaves, i, "sm3")
        assert proof == jmerkle.merkle_proof(leaves, i, "sm3")
        assert merkle.verify_merkle_proof(leaves[i], proof, root, "sm3")
        assert not merkle.verify_merkle_proof(leaves[i], proof, root)  # keccak


def test_empty_and_unported_alg():
    """An empty tree is the zero digest; SM3 runs (it was refused before
    the SM chain was ported) and differs from Keccak; an unknown alg is
    refused."""
    assert not merkle.merkle_root(torch.zeros((0, 32), dtype=torch.uint8)).any()
    two = torch.as_tensor(_leaves(2))
    sm = merkle.merkle_root(two, alg="sm3")
    assert bytes(sm.numpy()) == merkle.merkle_levels_host(
        [bytes(x) for x in two.numpy()], "sm3")[-1][0]
    assert not torch.equal(sm, merkle.merkle_root(two))
    with pytest.raises(ValueError):
        merkle.merkle_root(two, alg="sha256")
