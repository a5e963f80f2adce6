"""Wrappers of kernels 4 and B: the width-16 Keccak-256 and SM3 Merkle
trees on the card, the whole tree in one launch.

Source: `csrc/merkle.cu` (with `csrc/merkle.cuh`, `csrc/keccak.cuh` and
`csrc/sm3.cuh`). They replace `merkle_root_fused` (alg="keccak256" and
alg="sm3") of fisco_bcos_tpu/ops/pallas_merkle.py. The plain version is
`ops.merkle.merkle_root_bucketed_plain`.

The levels are joined inside the launch by arrival counters (the arrival
that completes a parent's children hashes the parent), so there is no
host loop over levels: the kernel writes the root to a [32] output on the
card. Its scratch (counters and the rows of the levels below the root's)
is allocated here with torch.empty; the launch zeroes the counters on the
stream. No bucket gate: any n.
"""

from __future__ import annotations

import torch

from . import _cuda

DIGEST = 32


def _tree(fn: str, leaves: torch.Tensor, n: int) -> torch.Tensor:
    leaves = leaves.contiguous()
    _cuda.require(leaves, "leaves", torch.uint8, (None, DIGEST))
    _cuda.require_aligned(leaves, "leaves")
    lib = _cuda.library("merkle", leaves.device)
    words = lib.merkle_tree_scratch_words(int(n))
    scratch = torch.empty((words,), dtype=torch.int32, device=leaves.device)
    root = torch.empty((DIGEST,), dtype=torch.uint8, device=leaves.device)
    rc = getattr(lib, fn + "_launch")(
        _cuda.ptr(leaves), leaves.shape[0], int(n), _cuda.ptr(scratch), scratch.numel(),
        _cuda.ptr(root), _cuda.stream_ptr(leaves))
    _cuda.check(lib, rc, fn)
    return root


def merkle_keccak_tree(leaves: torch.Tensor, n: int) -> torch.Tensor:
    """The Keccak root of the tree over the first n >= 2 rows of leaves
    [rows, 32] uint8 on the card (rows past n, or past `rows`, read as
    zero) -> [32] uint8, in one launch."""
    root = _tree("merkle_keccak_tree", leaves, n)
    merkle_keccak_tree.launches += 1
    return root


merkle_keccak_tree.launches = 0


def merkle_sm3_tree(leaves: torch.Tensor, n: int) -> torch.Tensor:
    """The SM3 root, as merkle_keccak_tree."""
    root = _tree("merkle_sm3_tree", leaves, n)
    merkle_sm3_tree.launches += 1
    return root


merkle_sm3_tree.launches = 0

TREES = {"keccak256": merkle_keccak_tree, "sm3": merkle_sm3_tree}


def merkle_root(leaves: torch.Tensor, n: int, alg: str = "keccak256") -> torch.Tensor:
    """Root [32] of the canonical tree over the first n of `leaves` rows;
    the kernel reads rows past n, if any, as zero."""
    tree = TREES[alg]
    if n <= 1:
        return leaves[0].clone()
    return tree(leaves, n)
