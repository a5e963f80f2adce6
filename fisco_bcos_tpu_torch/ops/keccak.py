"""Batched Keccak-256 (Ethereum padding 0x01) in plain PyTorch, and the
dispatch to kernel 3.

Counterpart of fisco_bcos_tpu/ops/keccak.py. Each 64-bit lane is a
(hi, lo) pair of 32-bit words held in int64 and masked, as in the JAX
package (PyTorch has no uint64 shifts, and a signed `>>` on a value with
bit 63 set would smear the sign). `keccak256_varlen` is the entry point:
a CUDA tensor goes to the kernel (`ops.cuda_hash`), a CPU tensor to the
plain version.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

RATE_BYTES = 136  # 1088-bit rate for Keccak-256
RATE_WORDS = RATE_BYTES // 8  # 17 lanes
M32 = 0xFFFFFFFF

RC64 = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
RC_HI = np.array([(rc >> 32) & M32 for rc in RC64], dtype=np.uint32)
RC_LO = np.array([rc & M32 for rc in RC64], dtype=np.uint32)

# rotation offsets by lane index i = x + 5*y
ROT = [0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43, 25, 39,
       41, 45, 15, 21, 8, 18, 2, 61, 56, 14]

# pi: B[y, 2x+3y] = rot(A[x, y]); source lane of every destination lane
PI_SRC = [0] * 25
for _x in range(5):
    for _y in range(5):
        PI_SRC[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y


def _rotl64(hi, lo, r):
    r %= 64
    if r == 0:
        return hi, lo
    if r == 32:
        return lo, hi
    if r > 32:
        hi, lo = lo, hi
        r -= 32
    nhi = ((hi << r) & M32) | (lo >> (32 - r))
    nlo = ((lo << r) & M32) | (hi >> (32 - r))
    return nhi, nlo


def round_lists(H, L, rc_hi: int, rc_lo: int):
    """One Keccak round on 25 (hi, lo) lane tensors of any uniform shape."""
    H, L = list(H), list(L)
    CH = [H[x] ^ H[x + 5] ^ H[x + 10] ^ H[x + 15] ^ H[x + 20] for x in range(5)]
    CL = [L[x] ^ L[x + 5] ^ L[x + 10] ^ L[x + 15] ^ L[x + 20] for x in range(5)]
    for x in range(5):
        rh, rl = _rotl64(CH[(x + 1) % 5], CL[(x + 1) % 5], 1)
        dh, dl = CH[(x + 4) % 5] ^ rh, CL[(x + 4) % 5] ^ rl
        for y in range(5):
            H[x + 5 * y] = H[x + 5 * y] ^ dh
            L[x + 5 * y] = L[x + 5 * y] ^ dl
    BH, BL = [None] * 25, [None] * 25
    for dst in range(25):
        src = PI_SRC[dst]
        BH[dst], BL[dst] = _rotl64(H[src], L[src], ROT[src])
    for y in range(5):
        for x in range(5):
            i = x + 5 * y
            j, k = (x + 1) % 5 + 5 * y, (x + 2) % 5 + 5 * y
            H[i] = BH[i] ^ ((BH[j] ^ M32) & BH[k])
            L[i] = BL[i] ^ ((BL[j] ^ M32) & BL[k])
    H[0] = H[0] ^ rc_hi
    L[0] = L[0] ^ rc_lo
    return H, L


def keccak_f(H, L):
    """Keccak-f[1600] on 25 (hi, lo) lane tensors."""
    for rh, rl in zip(RC_HI.tolist(), RC_LO.tolist()):
        H, L = round_lists(H, L, rh, rl)
    return H, L


def bytes_to_words(data: torch.Tensor):
    """[..., 8k] uint8 -> (hi, lo) [..., k] int64 words, little-endian."""
    b = data.to(torch.int64)
    w = b[..., 0::4] | (b[..., 1::4] << 8) | (b[..., 2::4] << 16) | (
        b[..., 3::4] << 24)
    return w[..., 1::2], w[..., 0::2]


def words_to_bytes(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) [..., n] -> [..., 8n] uint8, little-endian per lane."""
    w = torch.stack([lo, hi], dim=-1).reshape(lo.shape[:-1] + (2 * lo.shape[-1],))
    b = torch.stack([(w >> (8 * k)) & 0xFF for k in range(4)], dim=-1)
    return b.reshape(lo.shape[:-1] + (8 * lo.shape[-1],)).to(torch.uint8)


def _absorb(H, L, blocks: torch.Tensor, i: int):
    bh, bl = bytes_to_words(blocks[..., i, :])
    H = [H[k] ^ bh[..., k] if k < RATE_WORDS else H[k] for k in range(25)]
    L = [L[k] ^ bl[..., k] if k < RATE_WORDS else L[k] for k in range(25)]
    return keccak_f(H, L)


def keccak256_blocks(blocks_u8: torch.Tensor) -> torch.Tensor:
    """[..., nblocks, 136] pre-padded uint8 -> [..., 32] digests."""
    zero = torch.zeros(blocks_u8.shape[:-2], dtype=torch.int64,
                       device=blocks_u8.device)
    H, L = [zero] * 25, [zero] * 25
    for i in range(blocks_u8.shape[-2]):
        H, L = _absorb(H, L, blocks_u8, i)
    return words_to_bytes(torch.stack(H[:4], -1), torch.stack(L[:4], -1))


def keccak256_varlen_plain(blocks_u8: torch.Tensor,
                           nvalid: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel 3: [B, nblocks, 136] pre-padded uint8 and
    nvalid[B] block counts -> [B, 32]; messages shorter than nblocks mask
    out the trailing permutations (ops/keccak.py:193-203)."""
    zero = torch.zeros(blocks_u8.shape[:-2], dtype=torch.int64,
                       device=blocks_u8.device)
    H, L = [zero] * 25, [zero] * 25
    nvalid = nvalid.to(device=blocks_u8.device)
    for i in range(blocks_u8.shape[-2]):
        nh, nl = _absorb(H, L, blocks_u8, i)
        live = nvalid > i
        H = [torch.where(live, a, b) for a, b in zip(nh, H)]
        L = [torch.where(live, a, b) for a, b in zip(nl, L)]
    return words_to_bytes(torch.stack(H[:4], -1), torch.stack(L[:4], -1))


def keccak256_varlen(blocks_u8: torch.Tensor,
                     nvalid: torch.Tensor) -> torch.Tensor:
    """[B, maxblocks, 136] pre-padded uint8 + nvalid[B] -> [B, 32] uint8.
    A CUDA tensor runs kernel 3; a CPU tensor runs the plain version."""
    if blocks_u8.is_cuda:
        from . import cuda_hash

        return cuda_hash.keccak256_varlen(blocks_u8, nvalid)
    return keccak256_varlen_plain(blocks_u8, nvalid)


def pad_message_np(msg: bytes) -> np.ndarray:
    """Host-side Keccak pad -> [nblocks, 136] uint8."""
    n = len(msg)
    nblocks = n // RATE_BYTES + 1
    buf = np.zeros(nblocks * RATE_BYTES, dtype=np.uint8)
    buf[:n] = np.frombuffer(msg, dtype=np.uint8)
    buf[n] ^= 0x01
    buf[-1] ^= 0x80
    return buf.reshape(nblocks, RATE_BYTES)


def pad_batch_np(msgs: Sequence[bytes]):
    """Pad a batch to its longest message -> (blocks [B, maxb, 136] uint8,
    nvalid [B] int32), the layout keccak256_varlen takes."""
    lens = np.fromiter((len(m) for m in msgs), np.int64, len(msgs))
    nvalid = (lens // RATE_BYTES + 1).astype(np.int32)
    maxb = int(nvalid.max()) if len(msgs) else 1
    blocks = np.zeros((len(msgs), maxb * RATE_BYTES), dtype=np.uint8)
    for i, m in enumerate(msgs):
        blocks[i, :len(m)] = np.frombuffer(m, np.uint8)
    rows = np.arange(len(msgs))
    blocks[rows, lens] ^= 0x01
    blocks[rows, nvalid.astype(np.int64) * RATE_BYTES - 1] ^= 0x80
    return blocks.reshape(len(msgs), maxb, RATE_BYTES), nvalid


def keccak256_batch_np(msgs: Sequence[bytes], device="cuda") -> np.ndarray:
    """Host API: pad on the host, hash on `device`, return [B, 32] uint8."""
    blocks, nvalid = pad_batch_np(msgs)
    out = keccak256_varlen(torch.as_tensor(blocks, device=device),
                           torch.as_tensor(nvalid, device=device))
    return out.cpu().numpy()
