"""Width-16 Merkle roots (Keccak-256 or SM3): plain PyTorch tree, dispatch
to the level kernels (kernel 4 for Keccak, kernel B for SM3), and the host
levels and proofs.

Counterpart of fisco_bcos_tpu/ops/merkle.py. Canonical tree (the
protocol's definition, identical on every path):
  - leaves: n 32-byte digests, n >= 1; a single leaf is its own root;
  - each level is zero-padded to a multiple of WIDTH; parent_i =
    H(children[16i] || ... || children[16i+15]) over the 512-byte
    concatenation; levels repeat until one node remains;
  - the plain path buckets n up to a power of two and masks virtual nodes
    to zero at every level, so the root does not depend on the bucket.
"""

from __future__ import annotations

import torch

from . import keccak as _keccak
from . import sm3 as _sm3
from ..crypto import refimpl

WIDTH = 16
DIGEST = 32
ALGS = ("keccak256", "sm3")


def _check_alg(alg: str) -> None:
    if alg not in ALGS:
        raise ValueError(f"unknown hash alg {alg!r}")


def _hash_nodes(nodes: torch.Tensor, alg: str) -> torch.Tensor:
    """[k, WIDTH*DIGEST] uint8 -> [k, DIGEST] digests. A 512-byte node is
    5 Keccak rate blocks or 9 SM3 blocks after padding."""
    k, nbytes = nodes.shape
    if alg == "keccak256":
        rate = _keccak.RATE_BYTES
        nb = nbytes // rate + 1
        buf = torch.zeros((k, nb * rate), dtype=torch.uint8, device=nodes.device)
        buf[:, :nbytes] = nodes
        buf[:, nbytes] = 0x01
        buf[:, -1] += 0x80
        return _keccak.keccak256_blocks(buf.reshape(k, nb, rate))
    _check_alg(alg)
    pad = torch.as_tensor(_sm3.pad_message_np(bytes(nbytes)).reshape(-1),
                          device=nodes.device)
    buf = pad.repeat(k, 1)  # the padding of any 512-byte message
    buf[:, :nbytes] = nodes
    return _sm3.sm3_blocks(buf.reshape(k, -1, _sm3.BLOCK_BYTES))


def merkle_root_bucketed_plain(leaves: torch.Tensor, n: int,
                               alg: str = "keccak256") -> torch.Tensor:
    """Plain version of the level kernels (fisco_bcos_tpu/ops/merkle.py
    `_merkle_root_bucketed`): leaves [N_bucket, 32] uint8 zero-padded, n
    the logical count -> [32] root."""
    nodes = leaves
    count = int(n)
    root = leaves[0] if count <= 1 else torch.zeros_like(leaves[0])
    found = count <= 1
    while nodes.shape[0] > 1:
        m = nodes.shape[0]
        pad = (-m) % WIDTH
        if pad:
            nodes = torch.cat([nodes, torch.zeros((pad, DIGEST), dtype=torch.uint8,
                                                  device=nodes.device)])
            m += pad
        parents = _hash_nodes(nodes.reshape(m // WIDTH, WIDTH * DIGEST), alg)
        count = (count + WIDTH - 1) // WIDTH
        live = torch.arange(parents.shape[0], device=parents.device) < count
        nodes = torch.where(live[:, None], parents, torch.zeros_like(parents))
        if not found and count <= 1:
            root, found = nodes[0], True
    return root


def merkle_root(leaves: torch.Tensor, alg: str = "keccak256") -> torch.Tensor:
    """Root [32] uint8 of [n, 32] uint8 leaf digests. A CUDA tensor runs
    the alg's level kernel once per level; a CPU tensor runs the plain
    bucketed tree."""
    _check_alg(alg)
    n = leaves.shape[0]
    if n == 0:
        return torch.zeros((DIGEST,), dtype=torch.uint8, device=leaves.device)
    if leaves.is_cuda:
        from . import cuda_merkle

        return cuda_merkle.merkle_root(leaves, n, alg)
    nbucket = max(WIDTH, 1 << (n - 1).bit_length())
    if nbucket > n:
        leaves = torch.cat([leaves, torch.zeros((nbucket - n, DIGEST),
                                                dtype=torch.uint8)])
    return merkle_root_bucketed_plain(leaves, n, alg)


# ---------------------------------------------------------------------------
# host-side levels and proofs (low-volume paths)
# ---------------------------------------------------------------------------

def _hash_host(data: bytes, alg: str) -> bytes:
    _check_alg(alg)
    return refimpl.keccak256(data) if alg == "keccak256" else refimpl.sm3(data)


def merkle_levels_host(leaves: list[bytes], alg: str = "keccak256") -> list[list[bytes]]:
    """All tree levels, canonical semantics (host loop, pure Python)."""
    assert leaves
    levels = [list(leaves)]
    while len(levels[-1]) > 1:
        cur = list(levels[-1])
        while len(cur) % WIDTH:
            cur.append(b"\x00" * DIGEST)
        levels.append([_hash_host(b"".join(cur[i: i + WIDTH]), alg)
                       for i in range(0, len(cur), WIDTH)])
    return levels


def proof_from_levels(levels: list[list[bytes]], index: int):
    """Inclusion proof for leaf `index` out of prebuilt levels."""
    proof = []
    idx = index
    for level in levels[:-1]:
        cur = list(level)
        while len(cur) % WIDTH:
            cur.append(b"\x00" * DIGEST)
        group = idx // WIDTH
        proof.append((cur[group * WIDTH: (group + 1) * WIDTH], idx % WIDTH))
        idx = group
    return proof


def merkle_proof(leaves: list[bytes], index: int, alg: str = "keccak256"):
    """Inclusion proof: list of (siblings, position) per level."""
    return proof_from_levels(merkle_levels_host(leaves, alg), index)


def verify_merkle_proof(leaf: bytes, proof, root: bytes, alg: str = "keccak256") -> bool:
    cur = leaf
    for sibs, pos in proof:
        if sibs[pos] != cur:
            return False
        cur = _hash_host(b"".join(sibs), alg)
    return cur == root
