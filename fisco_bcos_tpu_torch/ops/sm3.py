"""Batched SM3 (GB/T 32905) in plain PyTorch, and the dispatch to kernel A.

Counterpart of fisco_bcos_tpu/ops/sm3.py. SM3 is a Merkle-Damgard hash
over big-endian 32-bit words; PyTorch on the CPU has no uint32
arithmetic, so each word is held in int64 and masked to 32 bits after
every add and shift, as `ops/keccak.py` does. `sm3_varlen` is the entry
point: a CUDA tensor goes to the kernel (`ops.cuda_sm3`), a CPU tensor to
the plain version.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .keccak import pack_classes_np

BLOCK_BYTES = 64
M32 = 0xFFFFFFFF

IV = np.array([0x7380166F, 0x4914B2B9, 0x172442D7, 0xDA8A0600,
               0xA96F30BC, 0x163138AA, 0xE38DEE4D, 0xB0FB0E4E], dtype=np.uint32)
_TJ = [0x79CC4519] * 16 + [0x7A879D8A] * 48
# per-round constants T_j <<< (j mod 32)
TJROT = np.array([((t << (j % 32)) | (t >> (32 - j % 32))) & M32 if j % 32 else t
                  for j, t in enumerate(_TJ)], dtype=np.uint32)


def _rotl(x, r: int):
    r %= 32
    if r == 0:
        return x
    return ((x << r) & M32) | (x >> (32 - r))


def _p0(x):
    return x ^ _rotl(x, 9) ^ _rotl(x, 17)


def _p1(x):
    return x ^ _rotl(x, 15) ^ _rotl(x, 23)


def expand(W: list) -> list:
    """The message expansion: 16 words -> W[0..67] (ints, or int64 tensors
    of one shape, values < 2^32)."""
    W = list(W)
    for j in range(16, 68):
        W.append(_p1(W[j - 16] ^ W[j - 9] ^ _rotl(W[j - 3], 15))
                 ^ _rotl(W[j - 13], 7) ^ W[j - 6])
    return W


def pad_block_words(nbytes: int) -> list[int]:
    """W[0..63], then W'[j] = W[j] ^ W[j + 4] for j < 64, of the padding
    block of an nbytes-byte message whose length is a multiple of 64 (one
    block: 0x80, zeros, the bit length), as ints."""
    assert nbytes % BLOCK_BYTES == 0
    W = expand([0x80000000] + [0] * 13 + [(8 * nbytes) >> 32, (8 * nbytes) & M32])
    return W[:64] + [W[j] ^ W[j + 4] for j in range(64)]


def compress(V: list, W: list) -> list:
    """One SM3 compression on 8 state words and 16 message words (lists
    of int64 tensors of one shape, values < 2^32) -> the next 8 words."""
    W = expand(W)
    A, B, C, D, E, F, G, H = V
    for j in range(64):
        a12 = _rotl(A, 12)
        ss1 = _rotl((a12 + E + int(TJROT[j])) & M32, 7)
        ss2 = ss1 ^ a12
        if j < 16:
            ff, gg = A ^ B ^ C, E ^ F ^ G
        else:
            ff = (A & B) | (A & C) | (B & C)
            gg = (E & F) | ((E ^ M32) & G)
        tt1 = (ff + D + ss2 + (W[j] ^ W[j + 4])) & M32
        tt2 = (gg + H + ss1 + W[j]) & M32
        A, B, C, D, E, F, G, H = tt1, A, _rotl(B, 9), C, _p0(tt2), E, _rotl(F, 19), G
    return [v ^ o for v, o in zip(V, [A, B, C, D, E, F, G, H])]


def bytes_to_be_words(data: torch.Tensor) -> torch.Tensor:
    """[..., 4k] uint8 -> [..., k] int64 big-endian 32-bit words."""
    b = data.to(torch.int64)
    return (b[..., 0::4] << 24) | (b[..., 1::4] << 16) | (b[..., 2::4] << 8) | b[..., 3::4]


def be_words_to_bytes(w: torch.Tensor) -> torch.Tensor:
    """[..., k] words -> [..., 4k] uint8, big-endian per word."""
    b = torch.stack([(w >> (24 - 8 * i)) & 0xFF for i in range(4)], dim=-1)
    return b.reshape(w.shape[:-1] + (4 * w.shape[-1],)).to(torch.uint8)


def _iv(batch: tuple, device) -> list:
    return [torch.full(batch, int(v), dtype=torch.int64, device=device) for v in IV]


def sm3_blocks(blocks_u8: torch.Tensor) -> torch.Tensor:
    """SM3 of pre-padded messages: [..., nblocks, 64] uint8 -> [..., 32]."""
    V = _iv(blocks_u8.shape[:-2], blocks_u8.device)
    for i in range(blocks_u8.shape[-2]):
        W = bytes_to_be_words(blocks_u8[..., i, :])
        V = compress(V, [W[..., k] for k in range(16)])
    return be_words_to_bytes(torch.stack(V, dim=-1))


def sm3_varlen_plain(blocks_u8: torch.Tensor, nvalid: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel A: [B, nblocks, 64] pre-padded uint8 and
    nvalid[B] block counts -> [B, 32]; a message stops after its nvalid
    blocks (the mask of fisco_bcos_tpu/ops/sm3.py `_sm3_varlen_impl`)."""
    V = _iv(blocks_u8.shape[:-2], blocks_u8.device)
    nvalid = nvalid.to(device=blocks_u8.device)
    for i in range(blocks_u8.shape[-2]):
        W = bytes_to_be_words(blocks_u8[..., i, :])
        nv = compress(V, [W[..., k] for k in range(16)])
        live = nvalid > i
        V = [torch.where(live, a, b) for a, b in zip(nv, V)]
    return be_words_to_bytes(torch.stack(V, dim=-1))


def sm3_varlen(blocks_u8: torch.Tensor, nvalid: torch.Tensor) -> torch.Tensor:
    """[B, maxblocks, 64] pre-padded uint8 + nvalid[B] -> [B, 32] uint8.
    A CUDA tensor runs kernel A; a CPU tensor runs the plain version."""
    if blocks_u8.is_cuda:
        from . import cuda_sm3

        return cuda_sm3.sm3_varlen(blocks_u8, nvalid)
    return sm3_varlen_plain(blocks_u8, nvalid)


def pad_message_np(msg: bytes) -> np.ndarray:
    """Host-side SM3 pad (0x80, zeros, 64-bit big-endian bit length) ->
    [nblocks, 64] uint8."""
    n = len(msg)
    total = ((n + 8) // BLOCK_BYTES + 1) * BLOCK_BYTES
    buf = np.zeros(total, dtype=np.uint8)
    buf[:n] = np.frombuffer(msg, dtype=np.uint8)
    buf[n] = 0x80
    buf[-8:] = np.frombuffer((8 * n).to_bytes(8, "big"), np.uint8)
    return buf.reshape(-1, BLOCK_BYTES)


def nblocks_np(lens: np.ndarray) -> np.ndarray:
    """The padded block count of a message of each length."""
    return (lens + 8) // BLOCK_BYTES + 1


def pad_batch_np(msgs: Sequence[bytes]):
    """Pad a batch to its longest message -> (blocks [B, maxb, 64] uint8,
    nvalid [B] int32), the layout sm3_varlen takes."""
    lens = np.fromiter((len(m) for m in msgs), np.int64, len(msgs))
    nvalid = nblocks_np(lens).astype(np.int32)
    maxb = int(nvalid.max()) if len(msgs) else 1
    blocks = np.zeros((len(msgs), maxb * BLOCK_BYTES), dtype=np.uint8)
    for i, m in enumerate(msgs):
        blocks[i, :len(m)] = np.frombuffer(m, np.uint8)
    _sm3_pad_rows(blocks, lens, nvalid)
    return blocks.reshape(len(msgs), maxb, BLOCK_BYTES), nvalid


def _sm3_pad_rows(flat: np.ndarray, lens: np.ndarray, nvalid: np.ndarray) -> None:
    rows = np.arange(flat.shape[0])
    flat[rows, lens] = 0x80
    end = nvalid.astype(np.int64) * BLOCK_BYTES
    bits = lens * 8
    for k in range(8):
        flat[rows, end - 1 - k] = (bits >> (8 * k)) & 0xFF


def pack_batch_np(msgs: Sequence[bytes]):
    """SM3-pad a batch by length class (ops.keccak.pack_classes_np) ->
    [(rows, blocks [k, maxb, 64] uint8, nvalid [k] int32)]."""
    return pack_classes_np(msgs, BLOCK_BYTES, nblocks_np, _sm3_pad_rows)


def sm3_batch_np(msgs: Sequence[bytes], device="cuda") -> np.ndarray:
    """Host API: pad on the host by length class, hash each class on
    `device` (one sm3_varlen call a class), return [B, 32] uint8 in input
    order."""
    out = np.zeros((len(msgs), 32), np.uint8)
    for rows, blocks, nvalid in pack_batch_np(msgs):
        out[rows] = sm3_varlen(torch.as_tensor(blocks, device=device),
                               torch.as_tensor(nvalid, device=device)).cpu().numpy()
    return out
