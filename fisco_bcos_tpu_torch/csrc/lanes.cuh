// The kernels' boundary: lane-major [16, B] columns of 16-bit limbs (the
// JAX package's layout, so adjacent threads read adjacent addresses per
// limb; int32 for the EC kernels, int64 for the fp kernels) to and from 8 x
// 32-bit words per thread, and the staging of constant affine window
// tables into shared memory.
#pragma once
#include "bigint.cuh"

template <class T>
__device__ __forceinline__ void load_limbs(u32 w[8], const T *col, int B, int lane) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        u32 lo = (u32)col[(2 * i) * B + lane] & 0xFFFFu;
        u32 hi = (u32)col[(2 * i + 1) * B + lane] & 0xFFFFu;
        w[i] = lo | (hi << 16);
    }
}

template <class T>
__device__ __forceinline__ void store_limbs(T *col, int B, int lane, const u32 w[8]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        col[(2 * i) * B + lane] = (T)(w[i] & 0xFFFFu);
        col[(2 * i + 1) * B + lane] = (T)(w[i] >> 16);
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
