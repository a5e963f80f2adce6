// Kernels 1 and 2 of the port: whole secp256k1 public-key recovery and
// whole ECDSA verify, one thread per signature.
//
// Replace fisco_bcos_tpu/ops/pallas_verify.py: ecdsa_recover_fused
// (:375 -> _recover_call :341, body _recover_kernel_body :283) and
// ecdsa_verify_fused (:262 -> _verify_call :211, body _verify_kernel_body
// :160). Same function, not the same blocking: the TPU kernel works on a
// 256-lane block of 16-bit limb planes and inverts through a per-block
// product tree with a Fermat power at its root; here each thread owns one
// signature in 8 x 32-bit words and inverts with its own safegcd inverse
// (modinv.cuh: a few thousand logic ops, about a sixth of a window
// power's time, and no block to wait on). The inverse is unique, so
// outputs are identical; zero still maps to zero. The square root is an
// addition chain (ec.cuh `fp_sqrt`).
//
// What bounds it: integer multiply-adds. A recovery is about 2,700 field
// multiplies of 64 wide 32x32->64 products each (the square root's 266,
// the Q table's ~150, 136 doublings and up to 136 mixed adds) and three
// inversions; nothing is read from device memory after the 5 input
// columns and the shared G tables.
//
// Boundary: lane-major [16, B] int32 columns of 16-bit limbs, the JAX
// package's layout, so adjacent threads read adjacent addresses per limb.
#include <cuda_runtime.h>
#include "ecdsa.cuh"
#include "lanes.cuh"

__global__ void ecdsa_recover_kernel(const int32_t *e, const int32_t *r, const int32_t *s,
                                     const int32_t *v, const int32_t *gtab, int32_t *qx,
                                     int32_t *qy, int32_t *ok, int B) {
    __shared__ u32 sg[2 * TBL * 16];
    stage_tables(sg, gtab, 2);
    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= B) return;
    u32 ew[8], rw[8], sw[8], ox[8], oy[8];
    load_limbs(ew, e, B, lane);
    load_limbs(rw, r, B, lane);
    load_limbs(sw, s, B, lane);
    bool good = recover_one(ox, oy, ew, rw, sw, (u32)v[lane], sg);
    store_limbs(qx, B, lane, ox);
    store_limbs(qy, B, lane, oy);
    ok[lane] = good ? 1 : 0;
}

__global__ void ecdsa_verify_kernel(const int32_t *e, const int32_t *r, const int32_t *s,
                                    const int32_t *qx, const int32_t *qy, const int32_t *gtab,
                                    int32_t *ok, int B) {
    __shared__ u32 sg[2 * TBL * 16];
    stage_tables(sg, gtab, 2);
    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= B) return;
    u32 ew[8], rw[8], sw[8], xw[8], yw[8];
    load_limbs(ew, e, B, lane);
    load_limbs(rw, r, B, lane);
    load_limbs(sw, s, B, lane);
    load_limbs(xw, qx, B, lane);
    load_limbs(yw, qy, B, lane);
    ok[lane] = verify_one(ew, rw, sw, xw, yw, sg) ? 1 : 0;
}

#define EC_THREADS 128

extern "C" int ecdsa_recover_launch(const int32_t *e, const int32_t *r, const int32_t *s,
                                    const int32_t *v, const int32_t *gtab, int32_t *qx,
                                    int32_t *qy, int32_t *ok, int B, void *stream) {
    int blocks = (B + EC_THREADS - 1) / EC_THREADS;
    ecdsa_recover_kernel<<<blocks, EC_THREADS, 0, (cudaStream_t)stream>>>(
        e, r, s, v, gtab, qx, qy, ok, B);
    return (int)cudaGetLastError();
}

extern "C" int ecdsa_verify_launch(const int32_t *e, const int32_t *r, const int32_t *s,
                                   const int32_t *qx, const int32_t *qy, const int32_t *gtab,
                                   int32_t *ok, int B, void *stream) {
    int blocks = (B + EC_THREADS - 1) / EC_THREADS;
    ecdsa_verify_kernel<<<blocks, EC_THREADS, 0, (cudaStream_t)stream>>>(
        e, r, s, qx, qy, gtab, ok, B);
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
