// Kernel H of the port: the standalone double-scalar ladder, k1*G + k2*Q
// with 4-bit windows, one thread per lane, for the composed EC route.
//
// Replaces fisco_bcos_tpu/ops/pallas_ec.py ladder (:310 -> _ladder_call
// :272, body ladder_values :213) in both of its forms: secp256k1's GLV form
// (2 pairs, 34 steps, SecpFp: plain domain mod p, a = 0) and SM2's plain
// Shamir form (1 pair, 64 steps, Sm2Fp: Montgomery mod p, a = -3). The
// plain version is ops/ec.ladder_plain.
//
// Inputs, as the TPU kernel's: gts [n_pairs, 16, 32] constant affine G
// tables (16-bit limbs, field rep); digs [2 n_pairs, nsteps, B] MSB-first
// window digits with rows interleaved [g, q] per pair; negs [2 n_pairs, B]
// sign flags in the same row order; q [n_pairs, 2, 16, B] the affine Q
// planes. Output: the packed Jacobian accumulator [3, 16, B].
//
// Same sequence as ladder_values, so each lane returns the TPU kernel's
// Jacobian limbs: per pair a Jacobian window table k*Q, k < 16, no
// inversion (the TPU kernel's 14 complete adds; here 2Q is the doubling
// those adds select and each later entry a mixed add, with the same
// limbs, see ladder_lane); per step 4 doublings,
// then per pair the G entry (negated by its flag) and the Q entry (negated
// by its flag). The TPU kernel adds the G entry as the Jacobian point
// (x, y, 1), masked to infinity for digit 0; here it is a mixed add
// (jac_madd), which gives the same field values for Z2 = 1, and a digit 0
// leaves the accumulator as the masked add leaves it (zeros if it is
// infinity, else unchanged).
//
// What bounds it: multiply throughput. A GLV lane is ~2,760 products mod p
// (~150 a table, 7 a doubling, 11 a G add, 16 a Q add), an SM2 lane
// ~3,760; its inputs and output are ~1.5 KB (chip_smoke.py
// `ladder_products`: 0.39 and 0.58 ms at 16,384 lanes). The per-lane
// tables live in local memory (16 x 3 x 8 words, 1.5 KB a pair), the G
// tables in shared memory (the lanes' digits diverge).
//
// Design for Hopper (each step measured on the H100, PERF.md): at
// one thread a lane, 16,384 lanes are one warp a scheduler, so a lane's
// own instruction stream sets the pace. Its products are out of line
// (ec.cuh `fp_mul_out`, sm2.cuh `sm2_mul_out`), operands by value in
// registers, and point.cuh computes independent products two to a call
// (`mul2`): with ~20 inlined products the step loop was ~200 KB of code
// and instruction fetch, not the ALUs, held the kernel back (1.5-1.9x).
// The doubling loop stays rolled, the adds' rare doubling is out of line,
// and SM2's product reduces in special form (sm2.cuh). Spreading a lane
// over 2 or 4 threads (CGBN's layout) was 2.5-3.6x slower and is not
// used.
#include <cuda_runtime.h>
#include "ec.cuh"
#include "sm2.cuh"
#include "lanes.cuh"

#define MAX_PAIRS 2

template <class F>
__device__ void ladder_lane(Jac &acc, const u32 *sg, const int32_t *digs, const int32_t *negs,
                            const int64_t *q, int n_pairs, int nsteps, int B, int lane) {
    Jac tab[MAX_PAIRS][TBL];
    for (int p = 0; p < n_pairs; ++p) {
        jac_set_inf(tab[p][0]);
        load_limbs(tab[p][1].X, q + (long)(2 * p) * 16 * B, B, lane);
        load_limbs(tab[p][1].Y, q + (long)(2 * p + 1) * 16 * B, B, lane);
        F::one(tab[p][1].Z);
        // jac_add(tab[1], tab[1]) takes its doubling branch. Each later
        // entry adds Q with Z = 1, where jac_madd gives jac_add's limbs:
        // its F ops are canonical, and where the running entry is Q's own
        // (uncanonical) limbs, both find H = R = 0 and double it.
        jac_double<F>(tab[p][2], tab[p][1]);
        for (int k = 3; k < TBL; ++k)
            jac_madd<F>(tab[p][k], tab[p][k - 1], tab[p][1].X, tab[p][1].Y);
    }
    jac_set_inf(acc);
    u32 gx[8], gy[8];
    for (int r = 0; r < nsteps; ++r) {
#pragma unroll 1
        for (int k = 0; k < 4; ++k) jac_double<F>(acc, acc);
        for (int p = 0; p < n_pairs; ++p) {
            u32 d = (u32)digs[((long)(2 * p) * nsteps + r) * B + lane] & 15u;
            if (d) {
                const u32 *g = sg + (p * TBL + d) * 16;
                for (int i = 0; i < 8; ++i) {
                    gx[i] = g[i];
                    gy[i] = g[8 + i];
                }
                if (negs[(2 * p) * B + lane]) F::neg(gy, gy);
                jac_madd<F>(acc, acc, gx, gy);
            } else if (is_zero8(acc.Z)) {
                jac_set_inf(acc);  // infinity + infinity = the masked entry
            }
            d = (u32)digs[((long)(2 * p + 1) * nsteps + r) * B + lane] & 15u;
            Jac e = tab[p][d];
            if (negs[(2 * p + 1) * B + lane]) F::neg(e.Y, e.Y);
            jac_add<F>(acc, acc, e);
        }
    }
}

// curve 0: secp256k1 (SecpFp), 1: SM2 (Sm2Fp)
__global__ void ladder_kernel(const int64_t *gts, const int32_t *digs, const int32_t *negs,
                              const int64_t *q, int64_t *out, int curve, int n_pairs,
                              int nsteps, int B) {
    __shared__ u32 sg[MAX_PAIRS * TBL * 16];
    stage_tables(sg, gts, n_pairs);
    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= B) return;
    Jac acc;
    if (curve == 0)
        ladder_lane<SecpFp>(acc, sg, digs, negs, q, n_pairs, nsteps, B, lane);
    else
        ladder_lane<Sm2Fp>(acc, sg, digs, negs, q, n_pairs, nsteps, B, lane);
    store_limbs(out, B, lane, acc.X);
    store_limbs(out + 16 * (long)B, B, lane, acc.Y);
    store_limbs(out + 32 * (long)B, B, lane, acc.Z);
}

#define EC_THREADS 128

extern "C" int ladder_launch(const int64_t *gts, const int32_t *digs, const int32_t *negs,
                             const int64_t *q, int64_t *out, int curve, int n_pairs, int nsteps,
                             int B, void *stream) {
    if (curve < 0 || curve > 1 || n_pairs < 1 || n_pairs > MAX_PAIRS || nsteps < 1)
        return (int)cudaErrorInvalidValue;
    int blocks = (B + EC_THREADS - 1) / EC_THREADS;
    ladder_kernel<<<blocks, EC_THREADS, 0, (cudaStream_t)stream>>>(gts, digs, negs, q, out,
                                                                   curve, n_pairs, nsteps, B);
    return (int)cudaGetLastError();
}

// the SecpConsts block (field.cuh) then the Sm2Consts block (sm2.cuh) on
// the current device, from ops/consts.kernel_words()["verify"] and
// ["sm2"]; -> the CUDA error code
extern "C" int set_consts(const uint32_t *w, int nwords) {
    if (nwords * 4 != (int)(sizeof(SecpConsts) + sizeof(Sm2Consts)))
        return (int)cudaErrorInvalidValue;
    int rc = (int)cudaMemcpyToSymbol(SC, w, sizeof(SecpConsts));
    if (rc) return rc;
    return (int)cudaMemcpyToSymbol(S2, w + sizeof(SecpConsts) / 4, sizeof(Sm2Consts));
}

extern "C" const char *cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
