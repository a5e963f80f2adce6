"""Wrappers of kernels 4 and B: the width-16 Keccak-256 and SM3 Merkle
trees on the card.

Source: `csrc/merkle.cu` (with `csrc/keccak.cuh` and `csrc/sm3.cuh`). They
replace `merkle_root_fused` (alg="keccak256" and alg="sm3") of
fisco_bcos_tpu/ops/pallas_merkle.py. The plain version is
`ops.merkle.merkle_root_bucketed_plain`.

Blocks on the card run in no order, so the tree is one launch per level;
the root selection (the first level whose live count is <= 1) is done
here, with the count known on the host. No bucket gate: any n.
"""

from __future__ import annotations

import torch

from . import _cuda

WIDTH = 16
DIGEST = 32


def _level(fn: str, nodes: torch.Tensor, count: int) -> torch.Tensor:
    nodes = nodes.contiguous()
    _cuda.require(nodes, "nodes", torch.uint8, (None, DIGEST))
    _cuda.require_aligned(nodes, "nodes")
    rows = nodes.shape[0]
    out_rows = (rows + WIDTH - 1) // WIDTH
    out = torch.empty((out_rows, DIGEST), dtype=torch.uint8, device=nodes.device)
    lib = _cuda.library("merkle", nodes.device)
    rc = getattr(lib, fn + "_launch")(
        _cuda.ptr(nodes), rows, int(count), _cuda.ptr(out), out_rows,
        _cuda.stream_ptr(nodes))
    _cuda.check(lib, rc, fn)
    return out


def merkle_level(nodes: torch.Tensor, count: int) -> torch.Tensor:
    """One Keccak level: nodes [rows, 32] uint8 on the card, `count` live
    nodes (rows past it read as zero) -> parents [ceil(rows / 16), 32],
    zero at index >= ceil(count / 16)."""
    out = _level("merkle_keccak_level", nodes, count)
    merkle_level.launches += 1
    return out


merkle_level.launches = 0


def merkle_sm3_level(nodes: torch.Tensor, count: int) -> torch.Tensor:
    """One SM3 level, as merkle_level."""
    out = _level("merkle_sm3_level", nodes, count)
    merkle_sm3_level.launches += 1
    return out


merkle_sm3_level.launches = 0

LEVELS = {"keccak256": merkle_level, "sm3": merkle_sm3_level}


def merkle_root(leaves: torch.Tensor, n: int, alg: str = "keccak256") -> torch.Tensor:
    """Root [32] of the canonical tree over the first n of `leaves` rows;
    the kernel reads rows past n, if any, as zero."""
    level = LEVELS[alg]
    if n <= 1:
        return leaves[0].clone()
    nodes, count = leaves, int(n)
    while count > 1:
        nodes = level(nodes, count)
        count = (count + WIDTH - 1) // WIDTH
    return nodes[0]
