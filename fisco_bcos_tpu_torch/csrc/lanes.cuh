// The EC kernels' boundary: lane-major [16, B] int32 columns of 16-bit
// limbs (the JAX package's layout, so adjacent threads read adjacent
// addresses per limb) to and from 8 x 32-bit words per thread, and the
// staging of constant affine window tables into shared memory.
#pragma once
#include "bigint.cuh"

__device__ __forceinline__ void load_limbs(u32 w[8], const int32_t *col, int B, int lane) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        u32 lo = (u32)col[(2 * i) * B + lane] & 0xFFFFu;
        u32 hi = (u32)col[(2 * i + 1) * B + lane] & 0xFFFFu;
        w[i] = lo | (hi << 16);
    }
}

__device__ __forceinline__ void store_limbs(int32_t *col, int B, int lane, const u32 w[8]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        col[(2 * i) * B + lane] = (int32_t)(w[i] & 0xFFFFu);
        col[(2 * i + 1) * B + lane] = (int32_t)(w[i] >> 16);
    }
}

// stage ntables [16][32] 16-bit-limb affine tables as [ntables][16][16]
// words (x words 0..7, y words 8..15); every thread of the block calls it
__device__ __forceinline__ void stage_tables(u32 *sg, const int32_t *gtab, int ntables) {
    for (int i = threadIdx.x; i < ntables * 16 * 16; i += blockDim.x) {
        const int32_t *src = gtab + 2 * i;
        sg[i] = ((u32)src[0] & 0xFFFFu) | (((u32)src[1] & 0xFFFFu) << 16);
    }
    __syncthreads();
}
