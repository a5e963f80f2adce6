// Kernel 4 of the port: one level of the canonical width-16 Keccak-256
// Merkle tree, one thread per parent.
//
// Replaces fisco_bcos_tpu/ops/pallas_merkle.py merkle_root_fused (:220 ->
// _tree_call :176, alg="keccak256"). The TPU kernel loops over the levels
// inside one grid step, because its grid runs in order; blocks on this card
// run in no order, so the wrapper (ops/cuda_merkle.py) launches this kernel
// once per level (4 launches at n = 65,536) and keeps the root selection.
//
// Parent i = Keccak-256 over the 512-byte concatenation of children
// 16i .. 16i+15 (4 rate blocks after padding); children at index >= count
// read as zero whatever the input rows hold (the zero padding to a multiple
// of 16), and parents at index >= ceil(count / 16) are zeroed (the
// virtual-node mask of ops/merkle.py and pallas_merkle.py:197-199).
//
// What bounds it: the four Keccak permutations per parent (64-bit logic);
// a parent reads 512 bytes and writes 32.
#include <cuda_runtime.h>
#include "keccak.cuh"

__global__ void merkle_keccak_level_kernel(const uint8_t *in, int in_rows, int count,
                                           uint8_t *out, int out_rows) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= out_rows) return;
    uint64_t *o = (uint64_t *)(out + (size_t)i * 32);
    int live = (count + 15) / 16;
    if (i >= live) {
        for (int k = 0; k < 4; ++k) o[k] = 0;
        return;
    }
    const uint64_t *src = (const uint64_t *)(in + (size_t)i * 512);
    int avail = min(in_rows, count) - 16 * i;  // live children of this parent
    uint64_t s[25];
#pragma unroll
    for (int k = 0; k < 25; ++k) s[k] = 0;
    // 64 message lanes + pad: lane 64 gets 0x01, lane 67 the top bit 0x80
    for (int b = 0; b < 4; ++b) {
#pragma unroll
        for (int k = 0; k < 17; ++k) {
            int lane = b * 17 + k;
            uint64_t w = 0;
            if (lane < 64) {
                if ((lane >> 2) < avail) w = src[lane];
            } else if (lane == 64) {
                w = 0x01ULL;
            }
            if (lane == 67) w ^= 0x8000000000000000ULL;
            s[k] ^= w;
        }
        keccak_f(s);
    }
    for (int k = 0; k < 4; ++k) o[k] = s[k];
}

#define MERKLE_THREADS 128

extern "C" int merkle_keccak_level_launch(const uint8_t *in, int in_rows, int count,
                                          uint8_t *out, int out_rows, void *stream) {
    int grid = (out_rows + MERKLE_THREADS - 1) / MERKLE_THREADS;
    merkle_keccak_level_kernel<<<grid, MERKLE_THREADS, 0, (cudaStream_t)stream>>>(
        in, in_rows, count, out, out_rows);
    return (int)cudaGetLastError();
}

// the round constants on the current device, from
// ops/consts.kernel_words()["keccak"]; -> the CUDA error code
extern "C" int set_consts(const uint32_t *w, int nwords) { return keccak_set_rc(w, nwords); }

extern "C" const char *cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
