"""Host conversions between Python ints, byte rows and 16-bit limb arrays.

Counterpart of the host part of fisco_bcos_tpu/ops/bigint.py: a 256-bit
unsigned integer is a little-endian vector of 16 limbs of 16 bits, held in
a uint32 array (the JAX package's public boundary, `[N, 16]`).
"""

from __future__ import annotations

import numpy as np

NLIMBS = 16
LIMB_BITS = 16
LIMB_RADIX = 1 << LIMB_BITS


def to_limbs(x: int, nlimbs: int = NLIMBS) -> np.ndarray:
    """Python int -> little-endian uint32 limb vector (16 bits per limb)."""
    if x < 0 or x >= 1 << (nlimbs * LIMB_BITS):
        raise ValueError(f"out of range for {nlimbs} limbs: {x}")
    return np.array(
        [(x >> (LIMB_BITS * i)) & (LIMB_RADIX - 1) for i in range(nlimbs)],
        dtype=np.uint32,
    )


def from_limbs(a) -> int:
    """Limb vector (numpy or a CPU tensor, 1-D) -> Python int."""
    a = np.asarray(a).astype(np.uint64)
    return sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(a.tolist()))


def batch_to_limbs(xs) -> np.ndarray:
    """List of Python ints -> [N, NLIMBS] uint32."""
    return np.stack([to_limbs(int(x)) for x in xs], axis=0)


def rows_to_limbs(rows: bytes, n: int) -> np.ndarray:
    """n concatenated 32-byte big-endian integers -> [n, NLIMBS] uint32.

    Equal to batch_to_limbs of the same integers, without a Python loop
    per value (the suite converts 64k digests and signature halves).
    """
    be = np.frombuffer(rows, np.uint8).reshape(n, 32)
    le16 = np.ascontiguousarray(be[:, ::-1]).view("<u2")
    return le16.astype(np.uint32)


def limbs_to_rows(a: np.ndarray) -> np.ndarray:
    """[n, NLIMBS] limbs (16-bit values) -> [n, 32] uint8 big-endian."""
    le = np.ascontiguousarray(np.asarray(a).astype("<u2")).view(np.uint8)
    return np.ascontiguousarray(le[:, ::-1])
