"""Wrapper of kernel A: SM3 of variable-length message batches.

Source: `csrc/sm3.cu` (with `csrc/sm3.cuh`). It replaces
`sm3_varlen_fused` of fisco_bcos_tpu/ops/pallas_hash.py. The plain version
is `ops.sm3.sm3_varlen_plain`. Same layout as the Keccak kernel: any B and
any block count.
"""

from __future__ import annotations

import torch

from . import _cuda
from .sm3 import BLOCK_BYTES


def sm3_varlen(blocks_u8: torch.Tensor, nvalid: torch.Tensor) -> torch.Tensor:
    """[B, nblocks, 64] uint8 pre-padded blocks on the card, nvalid [B]
    block counts -> [B, 32] uint8 digests."""
    blocks_u8 = blocks_u8.contiguous()
    _cuda.require(blocks_u8, "blocks", torch.uint8, (None, None, BLOCK_BYTES))
    _cuda.require_aligned(blocks_u8, "blocks")
    B, nblocks = blocks_u8.shape[0], blocks_u8.shape[1]
    nvalid = nvalid.to(device=blocks_u8.device, dtype=torch.int32).contiguous()
    _cuda.require(nvalid, "nvalid", torch.int32, (B,), blocks_u8.device)
    out = torch.empty((B, 32), dtype=torch.uint8, device=blocks_u8.device)
    if B == 0:
        return out
    lib = _cuda.library("sm3", blocks_u8.device)
    rc = lib.sm3_varlen_launch(
        _cuda.ptr(blocks_u8), _cuda.ptr(nvalid), _cuda.ptr(out), B, nblocks,
        _cuda.stream_ptr(blocks_u8))
    _cuda.check(lib, rc, "sm3_varlen")
    sm3_varlen.launches += 1
    return out


sm3_varlen.launches = 0
