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

// V = CF(V, W) for 16 big-endian message words; w is used as the window
__device__ __forceinline__ void sm3_compress(uint32_t V[8], uint32_t w[16]) {
    uint32_t A = V[0], B = V[1], C = V[2], D = V[3];
    uint32_t E = V[4], F = V[5], G = V[6], H = V[7];
#pragma unroll
    for (int j = 0; j < 64; ++j) {
        if (j >= 12) {
            const int k = j + 4;  // W[k] into the slot of W[k - 16]
            uint32_t x = w[(k - 16) & 15] ^ w[(k - 9) & 15] ^ sm3_rotl(w[(k - 3) & 15], 15);
            w[k & 15] = (x ^ sm3_rotl(x, 15) ^ sm3_rotl(x, 23))
                        ^ sm3_rotl(w[(k - 13) & 15], 7) ^ w[(k - 6) & 15];
        }
        uint32_t wj = w[j & 15], wj4 = w[(j + 4) & 15];
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
        uint32_t tt1 = ff + D + ss2 + (wj ^ wj4);
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
    V[0] ^= A;
    V[1] ^= B;
    V[2] ^= C;
    V[3] ^= D;
    V[4] ^= E;
    V[5] ^= F;
    V[6] ^= G;
    V[7] ^= H;
}
