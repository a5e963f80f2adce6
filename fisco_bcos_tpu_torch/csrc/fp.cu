// Kernels D, E and F of the port, the standalone 256-bit field multiplies,
// and kernel G, the fixed-exponent power; one thread per lane.
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
//
// Kernel G replaces pallas_fp.pow_const (:345 -> _pow_call :303, body
// pow_digits_values :281), which the composed EC route launches for
// recovery's square root and at the [16, 1] root of every batched
// inversion (ops/fp.py pow_const, inv_batch). The TPU kernel runs every
// exponent through a 4-bit window loop; here the wrapper picks a mode for
// the whole launch from the exponent (csrc/pow.cuh): an inverse (e = m - 2)
// runs modinv.cuh's safegcd over a modulus passed at launch, secp256k1's
// square root (e = (p+1)/4) ec.cuh's addition chain, any other exponent
// the window loop. Each mode returns the plain window loop's limbs. What
// bounds it: at 16,384 lanes, one warp a scheduler, the latency of each
// lane's dependent chain (266 products for the square root, 600 divsteps
// and 20 matrix updates for an inverse); at one lane, the [16, 1] root of a
// product tree, that same chain on one thread, which the inverse mode
// shortens most.
#include <cuda_runtime.h>
#include "lanes.cuh"
#include "pow.cuh"

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

// kernel G, one kernel a mode (csrc/pow.cuh); ops/cuda_fp.pow_const counts
// each launch of any of them as one
__global__ void fp_pow_kernel(const int64_t *a, int64_t *out, FieldArg f, PowArg e, int B) {
    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= B) return;
    W8 x;
    load_limbs(x.w, a, B, lane);
    W8 r = pow_window_field(x, e, f);
    store_limbs(out, B, lane, r.w);
}

__global__ void fp_pow_inv_kernel(const int64_t *a, int64_t *out, FieldArg f, InvArg v, int B) {
    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= B) return;
    W8 x;
    load_limbs(x.w, a, B, lane);
    W8 r = pow_inverse<false>(x, f, v);
    store_limbs(out, B, lane, r.w);
}

// the inverse mode's one-lane launches, in variable time
__global__ void fp_pow_inv_var_kernel(const int64_t *a, int64_t *out, FieldArg f, InvArg v,
                                      int B) {
    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= B) return;
    W8 x;
    load_limbs(x.w, a, B, lane);
    W8 r = pow_inverse<true>(x, f, v);
    store_limbs(out, B, lane, r.w);
}

// secp256k1's p only (its constants from the SecpConsts block)
__global__ void fp_pow_sqrt_kernel(const int64_t *a, int64_t *out, int B) {
    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= B) return;
    W8 x;
    load_limbs(x.w, a, B, lane);
    W8 r = fp_sqrt(x);
    store_limbs(out, B, lane, r.w);
}

#define FP_THREADS 256
// a power is ~50k instructions a lane: smaller blocks spread a 16,384-lane
// launch over all 132 SMs (128 blocks) instead of 64
#define POW_THREADS 128

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

// the window mode. digits: nd (1..64) 4-bit digits, most significant
// first; one: the field's one in its domain as 8 words (host memory,
// copied into PowArg)
extern "C" int fp_pow_launch(const int64_t *a, int64_t *out, const uint8_t *digits,
                             const uint32_t *one, const uint32_t *field, int nd, int B,
                             void *stream) {
    if (nd < 1 || nd > 64) return (int)cudaErrorInvalidValue;
    PowArg e;
    for (int i = 0; i < 8; ++i) e.one[i] = one[i];
    e.nd = nd;
    for (int i = 0; i < 64; ++i) e.d[i] = i < nd ? (digits[i] & 15u) : 0;
    int blocks = (B + POW_THREADS - 1) / POW_THREADS;
    fp_pow_kernel<<<blocks, POW_THREADS, 0, (cudaStream_t)stream>>>(a, out, field_arg(field),
                                                                    e, B);
    return (int)cudaGetLastError();
}

// the inverse mode, in variable time for one lane (B = 1) and constant
// time for more. inv: struct ModInv30 of the field's modulus (9 limbs of
// 30 bits, m^-1 mod 2^30), then R^3 mod m as 8 words (host memory,
// ops/cuda_fp._inv_words)
extern "C" int fp_pow_inv_launch(const int64_t *a, int64_t *out, const uint32_t *inv,
                                 const uint32_t *field, int B, void *stream) {
    InvArg v;
    for (int i = 0; i < 9; ++i) v.mi.m[i] = (int32_t)inv[i];
    v.mi.inv30 = inv[9];
    for (int i = 0; i < 8; ++i) v.r3[i] = inv[10 + i];
    int blocks = (B + POW_THREADS - 1) / POW_THREADS;
    if (B == 1)
        fp_pow_inv_var_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(a, out, field_arg(field), v, B);
    else
        fp_pow_inv_kernel<<<blocks, POW_THREADS, 0, (cudaStream_t)stream>>>(
            a, out, field_arg(field), v, B);
    return (int)cudaGetLastError();
}

// the square-root mode, secp256k1's p
extern "C" int fp_pow_sqrt_launch(const int64_t *a, int64_t *out, int B, void *stream) {
    int blocks = (B + POW_THREADS - 1) / POW_THREADS;
    fp_pow_sqrt_kernel<<<blocks, POW_THREADS, 0, (cudaStream_t)stream>>>(a, out, B);
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
