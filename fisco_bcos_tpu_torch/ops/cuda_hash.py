"""Wrapper of kernel 3: Keccak-256 of variable-length message batches.

Source: `csrc/keccak.cu` (with `csrc/keccak.cuh`). It replaces
`keccak256_varlen_fused` of fisco_bcos_tpu/ops/pallas_hash.py. The plain
version is `ops.keccak.keccak256_varlen_plain`. The kernel needs no
128-lane padding and no tile budget: any B and any block count.
"""

from __future__ import annotations

import torch

from . import _cuda
from .keccak import RATE_BYTES


def keccak256_varlen(blocks_u8: torch.Tensor, nvalid: torch.Tensor) -> torch.Tensor:
    """[B, nblocks, 136] uint8 pre-padded blocks on the card, nvalid [B]
    block counts -> [B, 32] uint8 digests."""
    blocks_u8 = blocks_u8.contiguous()
    _cuda.require(blocks_u8, "blocks", torch.uint8, (None, None, RATE_BYTES))
    B, nblocks = blocks_u8.shape[0], blocks_u8.shape[1]
    nvalid = nvalid.to(device=blocks_u8.device, dtype=torch.int32).contiguous()
    _cuda.require(nvalid, "nvalid", torch.int32, (B,), blocks_u8.device)
    out = torch.empty((B, 32), dtype=torch.uint8, device=blocks_u8.device)
    if B == 0:
        return out
    lib = _cuda.library("keccak", blocks_u8.device)
    rc = lib.keccak256_varlen_launch(
        _cuda.ptr(blocks_u8), _cuda.ptr(nvalid), _cuda.ptr(out), B, nblocks,
        _cuda.stream_ptr(blocks_u8))
    _cuda.check(lib, rc, "keccak256_varlen")
    keccak256_varlen.launches += 1
    return out


keccak256_varlen.launches = 0
