// Kernels D, E and F of the port: the standalone 256-bit field multiplies,
// one thread per lane.
//
// Replace fisco_bcos_tpu/ops/pallas_fp.py: mul (:192 -> _mul_call :146),
// mul_const (:232 -> _mul_const_call :222) and mul_stacked (:269 ->
// _mul_call_stacked :259), the launches ops/fp.py's dispatch makes for the
// batched Poseidon path (zk/poseidon_torch.py: 171 mul, 90 mul_stacked and
// 1 mul_const per chunk). Same function as the TPU kernels, not the same
// blocking: a TPU instance multiplies a [16, 512] limb block with 16-bit
// limb products in 32-bit lanes; here each thread packs its lane's 16
// limbs into 8 x 32-bit words and runs one product on Hopper's 32x32->64
// multiplier in registers.
//
// Fields, as pallas_fp.field_consts takes any field: a Montgomery field
// (R = 2^256) is passed per call as its modulus words and np0 = -n^-1 mod
// 2^32 and multiplies by bigint.cuh's CIOS `mont_mul`; the one Solinas
// field of the port, secp256k1's p, multiplies by field.cuh's `fp_mul`
// with its constants from the SecpConsts block (`set_consts`).
//
// What bounds it: device memory. A product is 136 wide multiplies
// (Montgomery) or 72 (Solinas) against 384 bytes of int64 limbs moved per
// lane (two operands read, one written; mul_const reads its column once
// per block), so at 3.35 TB/s a lane's bytes take ~8x its multiplies'
// issue time. The design moves each byte once and coalesced: limb i of
// adjacent lanes lies at adjacent addresses ([16, B] lane-major, the JAX
// package's layout). The boundary stays int64 16-bit limbs, the dtype of
// the plain field layer, so the Poseidon rounds convert nothing between
// the kernels and their plain adds.
#include <cuda_runtime.h>
#include "field.cuh"
#include "lanes.cuh"

// One field as a kernel argument (passed by value, so it rides in the
// launch's parameter space): modulus words, np0, and the Solinas flag.
struct FieldArg {
    u32 n[8];
    u32 np0;
    u32 solinas;
};

// r = a * b in the field's domain: canonical whenever one operand is below
// the modulus and the other below 2^256 (the to_rep case, bigint.cuh)
__device__ __forceinline__ void field_mul(u32 r[8], const u32 a[8], const u32 b[8],
                                          const FieldArg &f) {
    if (f.solinas) fp_mul(r, a, b);
    else mont_mul(r, a, b, f.n, f.np0);
}

__global__ void fp_mul_kernel(const int64_t *a, const int64_t *b, int64_t *out, FieldArg f,
                              int B) {
    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= B) return;
    u32 x[8], y[8], r[8];
    load_limbs(x, a, B, lane);
    load_limbs(y, b, B, lane);
    field_mul(r, x, y, f);
    store_limbs(out, B, lane, r);
}

// b is one [16, 1] column: the block's first 8 threads pack it into shared
// memory, so device memory sees it once per block, not once per lane
__global__ void fp_mul_const_kernel(const int64_t *a, const int64_t *c, int64_t *out,
                                    FieldArg f, int B) {
    __shared__ u32 cw[8];
    if (threadIdx.x < 8) {
        int i = threadIdx.x;
        cw[i] = ((u32)c[2 * i] & 0xFFFFu) | (((u32)c[2 * i + 1] & 0xFFFFu) << 16);
    }
    __syncthreads();
    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= B) return;
    u32 x[8], y[8], r[8];
    load_limbs(x, a, B, lane);
#pragma unroll
    for (int i = 0; i < 8; ++i) y[i] = cw[i];
    field_mul(r, x, y, f);
    store_limbs(out, B, lane, r);
}

// K stacked [16, B] pairs: grid (lane blocks, K), blockIdx.y picks the pair
__global__ void fp_mul_stacked_kernel(const int64_t *a, const int64_t *b, int64_t *out,
                                      FieldArg f, int B) {
    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= B) return;
    long off = (long)blockIdx.y * 16 * B;
    u32 x[8], y[8], r[8];
    load_limbs(x, a + off, B, lane);
    load_limbs(y, b + off, B, lane);
    field_mul(r, x, y, f);
    store_limbs(out + off, B, lane, r);
}

#define FP_THREADS 256

// `field`: host words n[0..7], np0, solinas (ops/cuda_fp._field_words)
static FieldArg field_arg(const uint32_t *field) {
    FieldArg f;
    for (int i = 0; i < 8; ++i) f.n[i] = field[i];
    f.np0 = field[8];
    f.solinas = field[9];
    return f;
}

extern "C" int fp_mul_launch(const int64_t *a, const int64_t *b, int64_t *out,
                             const uint32_t *field, int B, void *stream) {
    int blocks = (B + FP_THREADS - 1) / FP_THREADS;
    fp_mul_kernel<<<blocks, FP_THREADS, 0, (cudaStream_t)stream>>>(a, b, out, field_arg(field),
                                                                   B);
    return (int)cudaGetLastError();
}

extern "C" int fp_mul_const_launch(const int64_t *a, const int64_t *c, int64_t *out,
                                   const uint32_t *field, int B, void *stream) {
    int blocks = (B + FP_THREADS - 1) / FP_THREADS;
    fp_mul_const_kernel<<<blocks, FP_THREADS, 0, (cudaStream_t)stream>>>(
        a, c, out, field_arg(field), B);
    return (int)cudaGetLastError();
}

extern "C" int fp_mul_stacked_launch(const int64_t *a, const int64_t *b, int64_t *out,
                                     const uint32_t *field, int K, int B, void *stream) {
    dim3 grid((B + FP_THREADS - 1) / FP_THREADS, K);
    fp_mul_stacked_kernel<<<grid, FP_THREADS, 0, (cudaStream_t)stream>>>(
        a, b, out, field_arg(field), B);
    return (int)cudaGetLastError();
}

// the SecpConsts block (field.cuh) on the current device, from
// ops/consts.kernel_words()["verify"]; -> the CUDA error code
extern "C" int set_consts(const uint32_t *w, int nwords) {
    if (nwords * 4 != (int)sizeof(SecpConsts)) return (int)cudaErrorInvalidValue;
    return (int)cudaMemcpyToSymbol(SC, w, sizeof(SecpConsts));
}

extern "C" const char *cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
