// The SM3 compression (GB/T 32905) on 32-bit words held in registers,
// shared by the varlen hash kernel (sm3.cu) and the SM3 Merkle level
// kernel (merkle.cu). Counterpart of ops/sm3.py `compress` and of
// fisco_bcos_tpu/ops/pallas_hash.py _sm3_compress_values.
//
// The 68-word message expansion rolls in a 16-word window: round j reads
// W[j] and W[j+4], and from round 12 on W[j+4] is made in the slot of
// W[j-12], which no later round reads. The 64 rounds are unrolled, so every
// window index is a compile-time constant and the window stays in
// registers (68 live words would spill).
#pragma once
#include <stddef.h>
#include <stdint.h>

// IV and the 64 rotated round constants T_j <<< (j mod 32), set from
// ops/consts.py (`kernel_words(...)["sm3"]`) through sm3_set_consts
struct Sm3Consts {
    uint32_t iv[8];
    uint32_t tj[64];
};
static __constant__ Sm3Consts SM3K;

#ifdef __CUDACC__
// 72 words -> SM3K on the current device; -> the CUDA error code
static int sm3_set_consts(const uint32_t *w, int nwords) {
    if (nwords * 4 != (int)sizeof(Sm3Consts)) return (int)cudaErrorInvalidValue;
    return (int)cudaMemcpyToSymbol(SM3K, w, sizeof(Sm3Consts));
}
#endif

__device__ __forceinline__ uint32_t sm3_rotl(uint32_t x, int r) {
    return (x << r) | (x >> (32 - r));
}

// a little-endian load of 4 message bytes -> the big-endian word
__device__ __forceinline__ uint32_t sm3_bswap(uint32_t x) {
    return (x >> 24) | ((x >> 8) & 0xFF00u) | ((x << 8) & 0xFF0000u) | (x << 24);
}

__device__ __forceinline__ void sm3_init(uint32_t V[8]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) V[i] = SM3K.iv[i];
}

// round j of the compression on the state words A .. H, given W[j] and
// W'[j] = W[j] ^ W[j + 4]
__device__ __forceinline__ void sm3_round(int j, uint32_t &A, uint32_t &B, uint32_t &C,
                                          uint32_t &D, uint32_t &E, uint32_t &F, uint32_t &G,
                                          uint32_t &H, uint32_t wj, uint32_t wpj) {
    uint32_t a12 = sm3_rotl(A, 12);
    uint32_t ss1 = sm3_rotl(a12 + E + SM3K.tj[j], 7);
    uint32_t ss2 = ss1 ^ a12;
    uint32_t ff, gg;
    if (j < 16) {
        ff = A ^ B ^ C;
        gg = E ^ F ^ G;
    } else {
        ff = (A & B) | (A & C) | (B & C);
        gg = (E & F) | (~E & G);
    }
    uint32_t tt1 = ff + D + ss2 + wpj;
    uint32_t tt2 = gg + H + ss1 + wj;
    D = C;
    C = sm3_rotl(B, 9);
    B = A;
    A = tt1;
    H = G;
    G = sm3_rotl(F, 19);
    F = E;
    E = tt2 ^ sm3_rotl(tt2, 9) ^ sm3_rotl(tt2, 17);
}

// V ^= the state words A .. H (the compression's feed-forward)
__device__ __forceinline__ void sm3_feed(uint32_t V[8], uint32_t A, uint32_t B, uint32_t C,
                                         uint32_t D, uint32_t E, uint32_t F, uint32_t G,
                                         uint32_t H) {
    V[0] ^= A;
    V[1] ^= B;
    V[2] ^= C;
    V[3] ^= D;
    V[4] ^= E;
    V[5] ^= F;
    V[6] ^= G;
    V[7] ^= H;
}

// the window's step before round j: from round 12 on, W[j + 4] into the
// slot of W[j - 12]; round j then reads W[j] and W[j + 4] at j & 15 and
// (j + 4) & 15
__device__ __forceinline__ void sm3_expand_step(uint32_t w[16], int j) {
    if (j >= 12) {
        const int k = j + 4;  // W[k] into the slot of W[k - 16]
        uint32_t x = w[(k - 16) & 15] ^ w[(k - 9) & 15] ^ sm3_rotl(w[(k - 3) & 15], 15);
        w[k & 15] = (x ^ sm3_rotl(x, 15) ^ sm3_rotl(x, 23))
                    ^ sm3_rotl(w[(k - 13) & 15], 7) ^ w[(k - 6) & 15];
    }
}

// V = CF(V, W) for 16 big-endian message words; w is used as the window
__device__ __forceinline__ void sm3_compress(uint32_t V[8], uint32_t w[16]) {
    uint32_t A = V[0], B = V[1], C = V[2], D = V[3];
    uint32_t E = V[4], F = V[5], G = V[6], H = V[7];
#pragma unroll
    for (int j = 0; j < 64; ++j) {
        sm3_expand_step(w, j);
        uint32_t wj = w[j & 15], wj4 = w[(j + 4) & 15];
        sm3_round(j, A, B, C, D, E, F, G, H, wj, wj ^ wj4);
    }
    sm3_feed(V, A, B, C, D, E, F, G, H);
}

// The varlen kernel's launch shape (sm3.cu), here so that the host tests
// run its schedule with the kernel's numbers: threads a block, and room for
// SM3_VARLEN_MSGS messages (16 groups for its 8 warps)
constexpr int SM3_VARLEN_THREADS = 256, SM3_VARLEN_MSGS = 512;

// the messages a launch gives a block to sort: SM3_VARLEN_MSGS, or none
// (0: one thread a message in arrival order, SM3_VARLEN_THREADS a block)
// where no message has more than two blocks and a warp loses at most one
// compression to its longest lane
inline int sm3_block_msgs(int nblocks) { return nblocks <= 2 ? 0 : SM3_VARLEN_MSGS; }

// SM3 of message `msg`'s first n pre-padded 64-byte blocks, its rows
// nblocks x 4 uint4 apart in src, the digest's big-endian words to
// out[2 msg ..]; a thread of the varlen kernel loads the next block while
// it compresses the current one. n = 0 leaves the IV (the TPU kernel's
// mask keeps the IV for nvalid <= 0). An empty slot (msg < 0, n = 0) reads
// and writes nothing.
__device__ __forceinline__ void sm3_rows(const uint4 *src, uint4 *out, int msg, int n,
                                         int nblocks) {
    const uint4 *m = src + (size_t)(msg < 0 ? 0 : msg) * nblocks * 4;
    uint32_t V[8], w[16];
    uint4 nx[4];
    sm3_init(V);
    if (n > 0) {
#pragma unroll
        for (int q = 0; q < 4; ++q) nx[q] = m[q];
    }
    for (int b = 0; b < n; ++b) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            w[4 * q] = sm3_bswap(nx[q].x);
            w[4 * q + 1] = sm3_bswap(nx[q].y);
            w[4 * q + 2] = sm3_bswap(nx[q].z);
            w[4 * q + 3] = sm3_bswap(nx[q].w);
        }
        if (b + 1 < n) {
#pragma unroll
            for (int q = 0; q < 4; ++q) nx[q] = m[(b + 1) * 4 + q];
        }
        sm3_compress(V, w);
    }
    if (msg >= 0) {
        out[(size_t)msg * 2] =
            make_uint4(sm3_bswap(V[0]), sm3_bswap(V[1]), sm3_bswap(V[2]), sm3_bswap(V[3]));
        out[(size_t)msg * 2 + 1] =
            make_uint4(sm3_bswap(V[4]), sm3_bswap(V[5]), sm3_bswap(V[6]), sm3_bswap(V[7]));
    }
}
