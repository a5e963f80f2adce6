// Kernels 4 and B of the port: one level of the canonical width-16 Merkle
// tree, Keccak-256 (merkle_keccak_level) or SM3 (merkle_sm3_level), one
// thread per parent.
//
// Replace fisco_bcos_tpu/ops/pallas_merkle.py merkle_root_fused (:220 ->
// _tree_call :206, alg="keccak256" and alg="sm3"). The TPU kernel loops
// over the levels inside one grid step, because its grid runs in order;
// blocks on this card run in no order, so the wrapper (ops/cuda_merkle.py)
// launches a level kernel once per level (4 launches at n = 65,536) and
// keeps the root selection.
//
// Parent i = H over the 512-byte concatenation of children 16i .. 16i+15
// (4 Keccak rate blocks or 9 SM3 blocks after padding); children at index >= count
// read as zero whatever the input rows hold (the zero padding to a multiple
// of 16), and parents at index >= ceil(count / 16) are zeroed (the
// virtual-node mask of ops/merkle.py and pallas_merkle.py:197-199).
//
// What bounds it: the hash work per parent, four Keccak permutations
// (64-bit logic) or nine SM3 compressions (32-bit logic and adds: eight
// over the children, one over the constant padding block of a 512-byte
// message, pallas_merkle._sm3_node_hash :139); a parent reads 512 bytes
// and writes 32.
#include <cuda_runtime.h>
#include "keccak.cuh"
#include "sm3.cuh"

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

__global__ void merkle_sm3_level_kernel(const uint8_t *in, int in_rows, int count,
                                        uint8_t *out, int out_rows) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= out_rows) return;
    uint4 *o = (uint4 *)(out + (size_t)i * 32);
    int live = (count + 15) / 16;
    if (i >= live) {
        o[0] = make_uint4(0, 0, 0, 0);
        o[1] = make_uint4(0, 0, 0, 0);
        return;
    }
    const uint4 *src = (const uint4 *)(in + (size_t)i * 512);
    int avail = min(in_rows, count) - 16 * i;  // live children of this parent
    uint32_t V[8], w[16];
    sm3_init(V);
    for (int b = 0; b < 8; ++b) {  // message block b = children 2b, 2b + 1
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            uint4 v = make_uint4(0, 0, 0, 0);
            if (2 * b + (q >> 1) < avail) v = src[4 * b + q];
            w[4 * q] = sm3_bswap(v.x);
            w[4 * q + 1] = sm3_bswap(v.y);
            w[4 * q + 2] = sm3_bswap(v.z);
            w[4 * q + 3] = sm3_bswap(v.w);
        }
        sm3_compress(V, w);
    }
    // the padding block of a 512-byte message: 0x80, zeros, bit length
#pragma unroll
    for (int k = 0; k < 16; ++k) w[k] = 0;
    w[0] = 0x80000000u;
    w[15] = 512 * 8;
    sm3_compress(V, w);
    o[0] = make_uint4(sm3_bswap(V[0]), sm3_bswap(V[1]), sm3_bswap(V[2]), sm3_bswap(V[3]));
    o[1] = make_uint4(sm3_bswap(V[4]), sm3_bswap(V[5]), sm3_bswap(V[6]), sm3_bswap(V[7]));
}

#define MERKLE_THREADS 128

extern "C" int merkle_keccak_level_launch(const uint8_t *in, int in_rows, int count,
                                          uint8_t *out, int out_rows, void *stream) {
    int grid = (out_rows + MERKLE_THREADS - 1) / MERKLE_THREADS;
    merkle_keccak_level_kernel<<<grid, MERKLE_THREADS, 0, (cudaStream_t)stream>>>(
        in, in_rows, count, out, out_rows);
    return (int)cudaGetLastError();
}

extern "C" int merkle_sm3_level_launch(const uint8_t *in, int in_rows, int count,
                                       uint8_t *out, int out_rows, void *stream) {
    int grid = (out_rows + MERKLE_THREADS - 1) / MERKLE_THREADS;
    merkle_sm3_level_kernel<<<grid, MERKLE_THREADS, 0, (cudaStream_t)stream>>>(
        in, in_rows, count, out, out_rows);
    return (int)cudaGetLastError();
}

#define KECCAK_WORDS 48  // 24 round constants as (lo, hi) words

// the Keccak round constants, then the SM3 IV and round constants, on the
// current device, from ops/consts.kernel_words()["keccak"] + ["sm3"];
// -> the CUDA error code
extern "C" int set_consts(const uint32_t *w, int nwords) {
    if (nwords < KECCAK_WORDS) return (int)cudaErrorInvalidValue;
    int rc = keccak_set_rc(w, KECCAK_WORDS);
    return rc ? rc : sm3_set_consts(w + KECCAK_WORDS, nwords - KECCAK_WORDS);
}

extern "C" const char *cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
