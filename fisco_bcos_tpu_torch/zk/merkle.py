"""Binary Poseidon-Merkle tree — the SNARK-friendly sibling of ops/merkle.

Canonical tree (deterministic, identical on host loop and device batch):

  * leaves are 32-byte big-endian values, canonicalized into the BN254
    scalar field once on entry (``poseidon.to_field`` — arbitrary
    keccak/SM3 digests map in via one modular reduction);
  * every level is padded to even length with the zero element; parent_i
    = H(children[2i], children[2i+1]) with H = Poseidon arity-2
    compression; a single leaf is its own root.

Level hashing is BATCHED: one `hasher(lefts, rights)` call per level, so
a 64k-leaf tree is 16 device calls. The `hasher` is any
``(lefts, rights) -> digests`` callable — ``CryptoSuite.poseidon_batch``
in production, the host oracle in tests.

Proofs carry BOTH children per level (not just the sibling): the hash
inputs of every level are then known up front, so verifying N proofs of
depth D is ONE batched call over all N*D pairs plus host-side linkage
equality checks (`verify_batch`). The cost is 2x proof bytes, the same
trade ops/merkle's width-16 proofs already make by carrying the full
sibling group.

Scope (honest): the CHAIN's own proofs stay on the header-anchored
width-16 keccak/SM3 trees — a Poseidon root nothing seals would prove
nothing. This module is the building block for OFF-chain provers (SNARK
circuits commit Poseidon roots; the chain's batch lane does their
hashing).

A copy of fisco_bcos_tpu/zk/merkle.py (pure Python, no JAX), kept in the
port so that the port imports nothing of the JAX package; the CPU tests
hold the two equal with the port suite's `poseidon_batch` as the hasher.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from . import poseidon

Hasher = Callable[[Sequence[bytes], Sequence[bytes]], Sequence[bytes]]

ZERO = b"\x00" * poseidon.DIGEST

# proof level: (left, right, pos) with pos 0 = the path node is the left
# child. Chain rule: level k's path node equals (left, right)[pos], the
# next path node is H(left, right).
ProofLevel = tuple[bytes, bytes, int]


def _host_hasher(lefts: Sequence[bytes],
                 rights: Sequence[bytes]) -> list[bytes]:
    return poseidon.hash2_batch_host(lefts, rights)


def build_levels(leaves: Sequence[bytes],
                 hasher: Optional[Hasher] = None) -> list[list[bytes]]:
    """All tree levels, leaves first (canonicalized), one batched hash
    call per level."""
    assert leaves
    hasher = hasher or _host_hasher
    cur = [poseidon.to_bytes(poseidon.to_field(b)) for b in leaves]
    levels = [cur]
    while len(cur) > 1:
        if len(cur) % 2:
            cur = cur + [ZERO]
            levels[-1] = cur
        nxt = list(hasher(cur[0::2], cur[1::2]))
        levels.append(nxt)
        cur = nxt
    return levels


def root(leaves: Sequence[bytes], hasher: Optional[Hasher] = None) -> bytes:
    return build_levels(leaves, hasher)[-1][0]


def proof_from_levels(levels: list[list[bytes]],
                      index: int) -> list[ProofLevel]:
    """Inclusion proof for leaf `index` out of prebuilt levels."""
    out: list[ProofLevel] = []
    idx = index
    for level in levels[:-1]:
        pair = idx & ~1
        out.append((level[pair], level[pair + 1], idx & 1))
        idx >>= 1
    return out


def merkle_proof(leaves: Sequence[bytes], index: int,
                 hasher: Optional[Hasher] = None) -> list[ProofLevel]:
    return proof_from_levels(build_levels(leaves, hasher), index)


def verify(leaf: bytes, proof: Sequence[ProofLevel], root_: bytes,
           hasher: Optional[Hasher] = None) -> bool:
    """Single-proof check (host convenience; batches go via verify_batch)."""
    return bool(verify_batch([(leaf, list(proof), root_)], hasher)[0])


def verify_batch(items: Sequence[tuple[bytes, list[ProofLevel], bytes]],
                 hasher: Optional[Hasher] = None) -> np.ndarray:
    """-> bool[N] for items of (leaf, proof, root).

    ONE batched hash call over every (left, right) pair of every item,
    then pure host equality: the leaf matches level 0's path slot, each
    level's digest matches the next level's path slot, the last digest
    matches the root. Empty proofs assert leaf == root (single-leaf
    tree)."""
    hasher = hasher or _host_hasher
    lefts: list[bytes] = []
    rights: list[bytes] = []
    for _leaf, proof, _root in items:
        for left, right, _pos in proof:
            lefts.append(left)
            rights.append(right)
    digests = list(hasher(lefts, rights)) if lefts else []
    ok = np.zeros(len(items), bool)
    off = 0
    for i, (leaf, proof, root_) in enumerate(items):
        cur = poseidon.to_bytes(poseidon.to_field(leaf))
        good = True
        for left, right, pos in proof:
            if (left, right)[1 if pos else 0] != cur:
                good = False
            cur = digests[off]
            off += 1
        ok[i] = good and cur == root_
    return ok


# -- wire/JSON shapes (shared by the RPC surface and the light client) ------

def proof_json(proof: Sequence[ProofLevel]) -> list[dict]:
    return [{"left": "0x" + left.hex(), "right": "0x" + right.hex(),
             "pos": pos} for left, right, pos in proof]


def proof_from_json(doc: Sequence[dict]) -> list[ProofLevel]:
    def unhex(s: str) -> bytes:
        return bytes.fromhex(s[2:] if s.startswith("0x") else s)

    return [(unhex(lvl["left"]), unhex(lvl["right"]), int(lvl["pos"]))
            for lvl in doc]
