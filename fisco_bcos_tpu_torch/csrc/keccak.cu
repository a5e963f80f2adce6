// Kernel 3 of the port: Keccak-256 of a batch of pre-padded messages of
// varying length, one thread per message.
//
// Replaces fisco_bcos_tpu/ops/pallas_hash.py keccak256_varlen_fused (:125 ->
// _keccak_call :73). The TPU kernel runs a 128-1024 lane block of (hi, lo)
// 32-bit word planes and masks every absorb with nvalid; here each thread
// keeps its 25 64-bit lanes in registers and simply stops absorbing after
// nvalid[i] of the nblocks 136-byte blocks, which is what the mask computes.
//
// What bounds it: 64-bit logic and rotate operations (about 3,000 a
// permutation, each two 32-bit instructions), not bytes: a message reads
// 136 bytes per permutation and writes 32.
#include <cuda_runtime.h>
#include "keccak.cuh"

#define RATE_WORDS 17

__global__ void keccak256_varlen_kernel(const uint8_t *blocks, const int32_t *nvalid,
                                        uint8_t *out, int B, int nblocks) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= B) return;
    int nv = nvalid[i];
    nv = nv < 0 ? 0 : (nv > nblocks ? nblocks : nv);
    const uint64_t *m = (const uint64_t *)(blocks + (size_t)i * nblocks * 136);
    uint64_t s[25];
#pragma unroll
    for (int k = 0; k < 25; ++k) s[k] = 0;
    for (int b = 0; b < nv; ++b) {
#pragma unroll
        for (int k = 0; k < RATE_WORDS; ++k) s[k] ^= m[b * RATE_WORDS + k];
        keccak_f(s);
    }
    uint64_t *o = (uint64_t *)(out + (size_t)i * 32);
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k] = s[k];
}

#define KECCAK_THREADS 128

extern "C" int keccak256_varlen_launch(const uint8_t *blocks, const int32_t *nvalid,
                                       uint8_t *out, int B, int nblocks, void *stream) {
    int grid = (B + KECCAK_THREADS - 1) / KECCAK_THREADS;
    keccak256_varlen_kernel<<<grid, KECCAK_THREADS, 0, (cudaStream_t)stream>>>(
        blocks, nvalid, out, B, nblocks);
    return (int)cudaGetLastError();
}

// the round constants on the current device, from
// ops/consts.kernel_words()["keccak"]; -> the CUDA error code
extern "C" int set_consts(const uint32_t *w, int nwords) { return keccak_set_rc(w, nwords); }

extern "C" const char *cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
