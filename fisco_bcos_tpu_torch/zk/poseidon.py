"""Poseidon permutation over the BN254 scalar field — host reference.

Parameter set: the paper's own published instantiation
``poseidonperm_x5_254_3`` (Grassi et al., "Poseidon: A New Hash Function
for Zero-Knowledge Proof Systems", USENIX Security '21): x^5 S-box,
t = 3 field elements of n = 254 bits, R_F = 8 full rounds, R_P = 57
partial rounds, over r = 21888...495617 (the alt_bn128/BN254 group order,
the BN254 group order R — the field every BN254 SNARK arithmetizes in).

Round constants and the Cauchy MDS matrix are generated EXACTLY as the
reference `generate_parameters_grain.sage` does: an 80-bit Grain LFSR
seeded from (field tag, sbox tag, n, t, R_F, R_P), 160 warm-up rounds,
self-shrinking output, 254-bit draws with rejection sampling for the
constants, then the matrix's x/y values from the same stream. The
generator is validated by the pinned reference vector in
tests/test_zk_poseidon.py (permutation of (0, 1, 2) from the reference
repository's test script) — byte-for-byte agreement there pins the whole
constant schedule.

This module is the ORACLE: pure Python ints, one permutation at a time.
The batch path (`zk/poseidon_torch.py`) must match it bit-for-bit; the
framework-facing hash API is `CryptoSuite.poseidon_batch`.

A copy of fisco_bcos_tpu/zk/poseidon.py (pure Python, no JAX), kept in
the port so that the port imports nothing of the JAX package; the CPU
tests hold the two equal.
"""

from __future__ import annotations

import functools
from typing import Iterator, Sequence

# BN254 (alt_bn128) group order — the SNARK scalar field (bn254.R)
P = 21888242871839275222246405745257275088548364400416034343698204186575808495617
T = 3        # state width (capacity 1 + rate 2)
R_F = 8      # full rounds (R_f = 4 at each end)
R_P = 57     # partial rounds
N_BITS = 254
ALPHA = 5

DIGEST = 32  # field elements travel as 32-byte big-endian


def _grain_bits(n: int, t: int, r_f: int, r_p: int) -> Iterator[int]:
    """The reference script's Grain LFSR in self-shrinking mode: 80-bit
    state from the parameter encoding, 160 discarded warm-up bits, then
    for each output pair (b1, b2): emit b2 iff b1 == 1."""
    bits: list[int] = []
    for val, width in ((1, 2), (0, 4), (n, 12), (t, 12),
                       (r_f, 10), (r_p, 10)):
        bits.extend(int(b) for b in bin(val)[2:].zfill(width))
    bits.extend([1] * 30)
    assert len(bits) == 80

    def nxt() -> int:
        nb = (bits[62] ^ bits[51] ^ bits[38] ^ bits[23]
              ^ bits[13] ^ bits[0])
        bits.pop(0)
        bits.append(nb)
        return nb

    for _ in range(160):
        nxt()
    while True:
        b = nxt()
        while b == 0:
            nxt()       # discard the pair's second bit
            b = nxt()   # resample
        yield nxt()


def _draw(gen: Iterator[int], nbits: int) -> int:
    v = 0
    for _ in range(nbits):
        v = (v << 1) | next(gen)
    return v


@functools.lru_cache(maxsize=None)
def params() -> tuple[tuple[int, ...], tuple[tuple[int, ...], ...]]:
    """-> (round_constants[(R_F+R_P)*T], mds[T][T]), generated once.

    Constants: 254-bit draws, rejection-sampled below P. MDS: the Cauchy
    matrix 1/(x_i + y_j) over the next 2T draws of the SAME stream (the
    reference script's create_mds_p; this instance's first sample passes
    its security checks, so no resampling occurs)."""
    gen = _grain_bits(N_BITS, T, R_F, R_P)
    rc = []
    while len(rc) < (R_F + R_P) * T:
        v = _draw(gen, N_BITS)
        while v >= P:
            v = _draw(gen, N_BITS)
        rc.append(v)
    xs = [_draw(gen, N_BITS) % P for _ in range(T)]
    ys = [_draw(gen, N_BITS) % P for _ in range(T)]
    mds = tuple(tuple(pow((x + y) % P, P - 2, P) for y in ys) for x in xs)
    return tuple(rc), mds


def permute(state: Sequence[int]) -> list[int]:
    """One Poseidon permutation of a T-element state (canonical ints < P).

    Non-optimized reference structure, mirroring the published script:
    every round adds T constants, applies x^5 to the full state (full
    rounds) or to element 0 only (partial rounds), then multiplies by the
    MDS matrix."""
    assert len(state) == T
    rc, mds = params()
    s = [v % P for v in state]
    c = 0
    half_f = R_F // 2
    for r in range(R_F + R_P):
        for i in range(T):
            s[i] = (s[i] + rc[c]) % P
            c += 1
        full = r < half_f or r >= half_f + R_P
        for i in range(T if full else 1):
            s[i] = pow(s[i], ALPHA, P)
        s = [sum(mds[i][j] * s[j] for j in range(T)) % P
             for i in range(T)]
    return s


def hash2(left: int, right: int) -> int:
    """Arity-2 compression: H(l, r) = permute([0, l, r])[0] — the
    capacity element starts at zero, the two inputs fill the rate, the
    first output element is the digest (the fixed-length tree-hash mode
    the paper specifies for Merkle trees)."""
    return permute([0, left % P, right % P])[0]


# -- byte plumbing (32-byte big-endian field elements) ----------------------

def to_field(b: bytes) -> int:
    """32-byte big-endian -> canonical field element. Arbitrary digests
    (keccak/SM3 leaves) land here via one modular reduction — a fixed,
    documented mapping, NOT an error, so ledger digests can feed Poseidon
    trees directly."""
    return int.from_bytes(b, "big") % P


def to_bytes(v: int) -> bytes:
    return (v % P).to_bytes(DIGEST, "big")


def hash2_bytes(left: bytes, right: bytes) -> bytes:
    return to_bytes(hash2(to_field(left), to_field(right)))


def hash2_batch_host(lefts: Sequence[bytes],
                     rights: Sequence[bytes]) -> list[bytes]:
    """Host loop over `hash2_bytes` — the oracle the device path and the
    proof-bench host baseline both compare against."""
    return [hash2_bytes(a, b) for a, b in zip(lefts, rights)]
