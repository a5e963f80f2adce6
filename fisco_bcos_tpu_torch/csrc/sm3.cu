// Kernel A of the port: SM3 of a batch of pre-padded messages of varying
// length, one thread per message.
//
// Replaces fisco_bcos_tpu/ops/pallas_hash.py sm3_varlen_fused (:174 ->
// _sm3_call :164). The TPU kernel runs a lane block of big-endian word
// planes and masks every compression with nvalid; here each thread keeps
// its 8 state words and 16-word window in registers and simply stops after
// nvalid[i] of the nblocks 64-byte blocks, which is what the mask computes.
// Same byte layout as keccak256_varlen: [B, nblocks, 64] uint8 in, [B, 32]
// uint8 out (big-endian words).
//
// What bounds it: 32-bit integer issue, about 1,400 instructions a
// compression (52 expansion words of ~7, 64 rounds of ~16, with 3-input
// logic and adds fused), not bytes: a compression reads 64 bytes.
#include <cuda_runtime.h>
#include "sm3.cuh"

__global__ void sm3_varlen_kernel(const uint8_t *blocks, const int32_t *nvalid,
                                  uint8_t *out, int B, int nblocks) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= B) return;
    int nv = nvalid[i];
    nv = nv < 0 ? 0 : (nv > nblocks ? nblocks : nv);
    const uint4 *m = (const uint4 *)(blocks + (size_t)i * nblocks * 64);
    uint32_t V[8], w[16];
    sm3_init(V);
    for (int b = 0; b < nv; ++b) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // 16-byte loads
            uint4 v = m[b * 4 + q];
            w[4 * q] = sm3_bswap(v.x);
            w[4 * q + 1] = sm3_bswap(v.y);
            w[4 * q + 2] = sm3_bswap(v.z);
            w[4 * q + 3] = sm3_bswap(v.w);
        }
        sm3_compress(V, w);
    }
    uint4 *o = (uint4 *)(out + (size_t)i * 32);
    o[0] = make_uint4(sm3_bswap(V[0]), sm3_bswap(V[1]), sm3_bswap(V[2]), sm3_bswap(V[3]));
    o[1] = make_uint4(sm3_bswap(V[4]), sm3_bswap(V[5]), sm3_bswap(V[6]), sm3_bswap(V[7]));
}

#define SM3_THREADS 128

extern "C" int sm3_varlen_launch(const uint8_t *blocks, const int32_t *nvalid, uint8_t *out,
                                 int B, int nblocks, void *stream) {
    int grid = (B + SM3_THREADS - 1) / SM3_THREADS;
    sm3_varlen_kernel<<<grid, SM3_THREADS, 0, (cudaStream_t)stream>>>(
        blocks, nvalid, out, B, nblocks);
    return (int)cudaGetLastError();
}

// the IV and round constants on the current device, from
// ops/consts.kernel_words()["sm3"]; -> the CUDA error code
extern "C" int set_consts(const uint32_t *w, int nwords) { return sm3_set_consts(w, nwords); }

extern "C" const char *cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
