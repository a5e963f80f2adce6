// Kernel C of the port: whole SM2 signature verify, one thread per
// signature.
//
// Replaces fisco_bcos_tpu/ops/pallas_verify.py sm2_verify_fused (:507 ->
// _sm2_verify_call :474, body _sm2_verify_kernel_body :404), which inlines
// the plain 64-step form of pallas_ec.ladder. Same function, not the same
// blocking: the TPU kernel works on a block of 16-bit limb planes; here
// each thread owns one signature in 8 x 32-bit words (sm2.cuh).
//
// What bounds it: integer multiply-adds. A valid lane is about 256 a = -3
// doublings (8 Montgomery products each), up to 128 mixed adds (11 each),
// the Q table with its inversion (~500) and the checks: ~3,900 products of
// 2 x 64 + 8 wide 32x32->64 multiplies. After the five input columns and
// the G table staged in shared memory, nothing touches device memory but
// the per-thread stack (the Q table and the power table, local memory).
//
// Boundary: lane-major [16, B] int32 columns of 16-bit limbs, as verify.cu.
#include <cuda_runtime.h>
#include "sm2.cuh"
#include "lanes.cuh"

__global__ void sm2_verify_kernel(const int32_t *e, const int32_t *r, const int32_t *s,
                                  const int32_t *qx, const int32_t *qy, const int32_t *gtab,
                                  int32_t *ok, int B) {
    __shared__ u32 sg[TBL * 16];
    stage_tables(sg, gtab, 1);
    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= B) return;
    u32 ew[8], rw[8], sw[8], xw[8], yw[8];
    load_limbs(ew, e, B, lane);
    load_limbs(rw, r, B, lane);
    load_limbs(sw, s, B, lane);
    load_limbs(xw, qx, B, lane);
    load_limbs(yw, qy, B, lane);
    ok[lane] = sm2_verify_one(ew, rw, sw, xw, yw, sg) ? 1 : 0;
}

#define EC_THREADS 128

extern "C" int sm2_verify_launch(const int32_t *e, const int32_t *r, const int32_t *s,
                                 const int32_t *qx, const int32_t *qy, const int32_t *gtab,
                                 int32_t *ok, int B, void *stream) {
    int blocks = (B + EC_THREADS - 1) / EC_THREADS;
    sm2_verify_kernel<<<blocks, EC_THREADS, 0, (cudaStream_t)stream>>>(
        e, r, s, qx, qy, gtab, ok, B);
    return (int)cudaGetLastError();
}

// the Sm2Consts block (sm2.cuh) on the current device, from
// ops/consts.kernel_words()["sm2"]; -> the CUDA error code
extern "C" int set_consts(const uint32_t *w, int nwords) {
    if (nwords * 4 != (int)sizeof(Sm2Consts)) return (int)cudaErrorInvalidValue;
    return (int)cudaMemcpyToSymbol(S2, w, sizeof(Sm2Consts));
}

extern "C" const char *cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
