// Keccak-f[1600] on 25 64-bit lanes held in registers, shared by the
// varlen hash kernel (keccak.cu) and the Merkle tree kernel (merkle.cu).
// Lane index i = x + 5*y, little-endian lanes, as in ops/keccak.py.
#pragma once
#include <stdint.h>

// round constants, set from ops/consts.py through keccak_set_rc
static __constant__ uint64_t KECCAK_RC[24];

#ifdef __CUDACC__
// 48 little-endian 32-bit words (lo, hi per round) -> KECCAK_RC on the
// current device; -> the CUDA error code
static int keccak_set_rc(const uint32_t *w, int nwords) {
    if (nwords * 4 != (int)sizeof(KECCAK_RC)) return (int)cudaErrorInvalidValue;
    return (int)cudaMemcpyToSymbol(KECCAK_RC, w, sizeof(KECCAK_RC));
}
#endif

__device__ __forceinline__ uint64_t keccak_rotl(uint64_t x, int r) {
    return (x << r) | (x >> (64 - r));
}

// One round: theta, rho+pi, chi, iota; rho+pi and chi written out so every
// index and rotation is a compile-time constant and the state never leaves
// registers. On sm_90a it compiles to 3-input logic (LOP3) for theta's
// parities and for chi and two funnel shifts (SHF) a 64-bit rotate
// (chip_smoke.py counts its SASS).
__device__ __forceinline__ void keccak_round(uint64_t a[25], uint64_t rc) {
    uint64_t c0 = a[0] ^ a[5] ^ a[10] ^ a[15] ^ a[20];
    uint64_t c1 = a[1] ^ a[6] ^ a[11] ^ a[16] ^ a[21];
    uint64_t c2 = a[2] ^ a[7] ^ a[12] ^ a[17] ^ a[22];
    uint64_t c3 = a[3] ^ a[8] ^ a[13] ^ a[18] ^ a[23];
    uint64_t c4 = a[4] ^ a[9] ^ a[14] ^ a[19] ^ a[24];
    uint64_t d0 = c4 ^ keccak_rotl(c1, 1);
    uint64_t d1 = c0 ^ keccak_rotl(c2, 1);
    uint64_t d2 = c1 ^ keccak_rotl(c3, 1);
    uint64_t d3 = c2 ^ keccak_rotl(c4, 1);
    uint64_t d4 = c3 ^ keccak_rotl(c0, 1);
    a[0] ^= d0;
    a[1] ^= d1;
    a[2] ^= d2;
    a[3] ^= d3;
    a[4] ^= d4;
    a[5] ^= d0;
    a[6] ^= d1;
    a[7] ^= d2;
    a[8] ^= d3;
    a[9] ^= d4;
    a[10] ^= d0;
    a[11] ^= d1;
    a[12] ^= d2;
    a[13] ^= d3;
    a[14] ^= d4;
    a[15] ^= d0;
    a[16] ^= d1;
    a[17] ^= d2;
    a[18] ^= d3;
    a[19] ^= d4;
    a[20] ^= d0;
    a[21] ^= d1;
    a[22] ^= d2;
    a[23] ^= d3;
    a[24] ^= d4;
    uint64_t b0 = a[0];
    uint64_t b16 = keccak_rotl(a[5], 36);
    uint64_t b7 = keccak_rotl(a[10], 3);
    uint64_t b23 = keccak_rotl(a[15], 41);
    uint64_t b14 = keccak_rotl(a[20], 18);
    uint64_t b10 = keccak_rotl(a[1], 1);
    uint64_t b1 = keccak_rotl(a[6], 44);
    uint64_t b17 = keccak_rotl(a[11], 10);
    uint64_t b8 = keccak_rotl(a[16], 45);
    uint64_t b24 = keccak_rotl(a[21], 2);
    uint64_t b20 = keccak_rotl(a[2], 62);
    uint64_t b11 = keccak_rotl(a[7], 6);
    uint64_t b2 = keccak_rotl(a[12], 43);
    uint64_t b18 = keccak_rotl(a[17], 15);
    uint64_t b9 = keccak_rotl(a[22], 61);
    uint64_t b5 = keccak_rotl(a[3], 28);
    uint64_t b21 = keccak_rotl(a[8], 55);
    uint64_t b12 = keccak_rotl(a[13], 25);
    uint64_t b3 = keccak_rotl(a[18], 21);
    uint64_t b19 = keccak_rotl(a[23], 56);
    uint64_t b15 = keccak_rotl(a[4], 27);
    uint64_t b6 = keccak_rotl(a[9], 20);
    uint64_t b22 = keccak_rotl(a[14], 39);
    uint64_t b13 = keccak_rotl(a[19], 8);
    uint64_t b4 = keccak_rotl(a[24], 14);
    a[0] = b0 ^ (~b1 & b2);
    a[1] = b1 ^ (~b2 & b3);
    a[2] = b2 ^ (~b3 & b4);
    a[3] = b3 ^ (~b4 & b0);
    a[4] = b4 ^ (~b0 & b1);
    a[5] = b5 ^ (~b6 & b7);
    a[6] = b6 ^ (~b7 & b8);
    a[7] = b7 ^ (~b8 & b9);
    a[8] = b8 ^ (~b9 & b5);
    a[9] = b9 ^ (~b5 & b6);
    a[10] = b10 ^ (~b11 & b12);
    a[11] = b11 ^ (~b12 & b13);
    a[12] = b12 ^ (~b13 & b14);
    a[13] = b13 ^ (~b14 & b10);
    a[14] = b14 ^ (~b10 & b11);
    a[15] = b15 ^ (~b16 & b17);
    a[16] = b16 ^ (~b17 & b18);
    a[17] = b17 ^ (~b18 & b19);
    a[18] = b18 ^ (~b19 & b15);
    a[19] = b19 ^ (~b15 & b16);
    a[20] = b20 ^ (~b21 & b22);
    a[21] = b21 ^ (~b22 & b23);
    a[22] = b22 ^ (~b23 & b24);
    a[23] = b23 ^ (~b24 & b20);
    a[24] = b24 ^ (~b20 & b21);
    a[0] ^= rc;
}

__device__ __forceinline__ void keccak_f(uint64_t a[25]) {
#pragma unroll 1
    for (int round = 0; round < 24; ++round) keccak_round(a, KECCAK_RC[round]);
}

// Keccak-256 of message `msg`'s first n pre-padded 136-byte blocks, its
// rows nblocks x 17 lanes apart in src, digest lanes to out[4 msg ..]; a
// thread of the varlen kernel loads the next block while it permutes the
// current one. An empty slot (msg < 0, n = 0) reads and writes nothing.
__device__ __forceinline__ void keccak256_rows(const uint64_t *src, uint64_t *out, int msg,
                                               int n, int nblocks) {
    const int W = 17;  // the rate: 136 bytes
    const uint64_t *m = src + (size_t)(msg < 0 ? 0 : msg) * nblocks * W;
    uint64_t s[25], nx[W];
#pragma unroll
    for (int k = 0; k < 25; ++k) s[k] = 0;
    if (n > 0) {
#pragma unroll
        for (int k = 0; k < W; ++k) nx[k] = m[k];
    }
    for (int b = 0; b < n; ++b) {
#pragma unroll
        for (int k = 0; k < W; ++k) s[k] ^= nx[k];
        if (b + 1 < n) {
#pragma unroll
            for (int k = 0; k < W; ++k) nx[k] = m[(b + 1) * W + k];
        }
        keccak_f(s);
    }
    if (msg >= 0) {
#pragma unroll
        for (int k = 0; k < 4; ++k) out[(size_t)msg * 4 + k] = s[k];
    }
}
