// secp256k1 point arithmetic and the GLV double-scalar ladder, one
// signature per thread.
//
// Replaces the device-value parts of fisco_bcos_tpu/ops/pallas_ec.py
// (vjac_double :106, vjac_add :145, the table selects :178-200,
// ladder_values :213) and pallas_verify._glv_split_values :101 /
// _glv_ladder :136. What bounds it: field multiplies (csrc/field.cuh), about
// 7 per doubling and 11 per mixed add over 34 x (4 doublings + 4 adds).
//
// Design for Hopper:
// * Jacobian coordinates, complete by branch (point.cuh, over SecpFp),
//   whose products are out of line (`fp_mul_out`, `fp_mul2_out`: one copy
//   of the product's code for the ladder's step loop, operands by value).
// * Only the per-lane Q table (k*Q, k < 16) is built, normalised to affine
//   with one inversion (Montgomery's trick over its 14 Z values, the
//   inverse modinv.cuh's safegcd); phi(Q) entries are (beta*x, y) formed
//   at lookup, so the per-thread table is 16 x 2 x 8 words rather than
//   twice that. It stays in local memory: read from shared memory instead
//   (a 128 KB block) it was no faster at 16,384 lanes and slower at more
//   (PERF.md).
// * The G and phi(G) tables (2 x 16 affine points) are indexed by each
//   lane's own digit, so they sit in shared memory (constant memory would
//   serialise the divergent reads); the kernel stages them per block.
#pragma once
#include "field.cuh"
#include "point.cuh"

#define GLV_BETA (SC.beta)
#define GLV_G1 (SC.g1)
#define GLV_G2 (SC.g2)
#define GLV_MB1R (SC.mb1r)
#define GLV_MB2R (SC.mb2r)
#define GLV_LAMR (SC.lamr)
#define HALF_N (SC.half_n)

#define GLV_DIGITS 34

// fp_mul out of line for the point code, as sm2.cuh's sm2_mul_out
__device__ __noinline__ W8 fp_mul_out(W8 a, W8 b) {
    W8 r;
    fp_mul(r.w, a.w, b.w);
    return r;
}

__device__ __noinline__ W16 fp_mul2_out(W8 a0, W8 b0, W8 a1, W8 b1) {
    W16 r;
    fp_mul(r.w, a0.w, b0.w);
    fp_mul(r.w + 8, a1.w, b1.w);
    return r;
}

// the secp256k1 field for point.cuh: plain domain mod p, a = 0
struct SecpFp {
    static constexpr bool A_MINUS3 = false;
    static __device__ __forceinline__ void mul(u32 r[8], const u32 a[8], const u32 b[8]) {
        W8 x, y;
        set8(x.w, a);
        set8(y.w, b);
        W8 z = fp_mul_out(x, y);
        set8(r, z.w);
    }
    static __device__ __forceinline__ void mul2(u32 r0[8], const u32 a0[8], const u32 b0[8],
                                                u32 r1[8], const u32 a1[8], const u32 b1[8]) {
        W8 x0, y0, x1, y1;
        set8(x0.w, a0);
        set8(y0.w, b0);
        set8(x1.w, a1);
        set8(y1.w, b1);
        W16 z = fp_mul2_out(x0, y0, x1, y1);
        set8(r0, z.w);
        set8(r1, z.w + 8);
    }
    static __device__ __forceinline__ void add(u32 r[8], const u32 a[8], const u32 b[8]) {
        fp_add(r, a, b);
    }
    static __device__ __forceinline__ void sub(u32 r[8], const u32 a[8], const u32 b[8]) {
        fp_sub(r, a, b);
    }
    static __device__ __forceinline__ void neg(u32 r[8], const u32 a[8]) { fp_neg(r, a); }
    static __device__ __forceinline__ void one(u32 r[8]) {
        zero8(r);
        r[0] = 1;
    }
    static __device__ __forceinline__ void inv(u32 r[8], const u32 a[8]) {
        W8 x;
        set8(x.w, a);
        W8 y = modinv<ModP>(x);
        set8(r, y.w);
    }
};

__device__ __forceinline__ W8 fp_sqr_n(W8 x, int n) {
#pragma unroll 1
    for (int i = 0; i < n; ++i) x = fp_mul_out(x, x);
    return x;
}

// a^((p+1)/4) mod p, a square root of a where one exists (p = 3 mod 4),
// by libsecp256k1's addition chain (secp256k1_fe_sqrt): the exponent's
// runs of ones have lengths 223, 22 and 2, built from 2^k - 1 for k in
// 1, 2, 3, 6, 9, 11, 22, 44, 88, 176, 220, 223: 253 squarings and 13
// products, against ~326 for 4-bit windows, and no table of powers. The
// chain is written for secp256k1's p, which ops/consts.kernel_words checks.
__device__ W8 fp_sqrt(W8 a) {
    W8 x2 = fp_mul_out(fp_mul_out(a, a), a);
    W8 x3 = fp_mul_out(fp_mul_out(x2, x2), a);
    W8 x6 = fp_mul_out(fp_sqr_n(x3, 3), x3);
    W8 x9 = fp_mul_out(fp_sqr_n(x6, 3), x3);
    W8 x11 = fp_mul_out(fp_sqr_n(x9, 2), x2);
    W8 x22 = fp_mul_out(fp_sqr_n(x11, 11), x11);
    W8 x44 = fp_mul_out(fp_sqr_n(x22, 22), x22);
    W8 x88 = fp_mul_out(fp_sqr_n(x44, 44), x44);
    W8 x176 = fp_mul_out(fp_sqr_n(x88, 88), x88);
    W8 x220 = fp_mul_out(fp_sqr_n(x176, 44), x44);
    W8 x223 = fp_mul_out(fp_sqr_n(x220, 3), x3);
    W8 t = fp_mul_out(fp_sqr_n(x223, 23), x22);
    t = fp_mul_out(fp_sqr_n(t, 6), x2);
    return fp_sqr_n(t, 2);
}

// k (canonical mod n) -> signed halves: k = (+-m1) + (+-m2) * lambda (mod n),
// |m1|, |m2| < 2^136, exactly ops/ec._glv_split_device.
__device__ void glv_split(const u32 k[8], u32 m1[8], bool &neg1, u32 m2[8], bool &neg2) {
    u32 t[16], c1[8], c2[8], x[8], y[8], k1[8], k2[8];
    mul_wide8(t, k, GLV_G1);
    zero8(c1);
    for (int i = 0; i < 4; ++i) c1[i] = t[12 + i];  // floor(k * g1 / 2^384)
    mul_wide8(t, k, GLV_G2);
    zero8(c2);
    for (int i = 0; i < 4; ++i) c2[i] = t[12 + i];
    fn_mont_mul(x, c1, GLV_MB1R);
    fn_mont_mul(y, c2, GLV_MB2R);
    fn_add(k2, x, y);
    fn_mont_mul(x, k2, GLV_LAMR);
    fn_sub(k1, k, x);
    neg1 = !geq8(HALF_N, k1);
    if (neg1) sub8(m1, FN_N, k1); else set8(m1, k1);
    neg2 = !geq8(HALF_N, k2);
    if (neg2) sub8(m2, FN_N, k2); else set8(m2, k2);
}

// acc = u1*G + u2*Q for canonical scalars u1, u2 and an affine Q.
// sg: shared [2][TBL][16] words, (x | y) of k*G and k*phi(G).
__device__ void glv_ladder(Jac &acc, const u32 u1[8], const u32 u2[8],
                           const u32 qx[8], const u32 qy[8], const u32 *sg) {
    u32 a1[8], a2[8], b1[8], b2[8];
    bool s1, s2, t1, t2;
    glv_split(u1, a1, s1, a2, s2);
    glv_split(u2, b1, t1, b2, t2);
    u32 tx[TBL][8], ty[TBL][8];
    q_table<SecpFp>(tx, ty, qx, qy);
    u32 beta[8];
    set8(beta, GLV_BETA);
    jac_set_inf(acc);
    u32 px[8], py[8];
    for (int j = GLV_DIGITS - 1; j >= 0; --j) {
#pragma unroll 1
        for (int k = 0; k < 4; ++k) jac_double<SecpFp>(acc, acc);
        u32 d = digit_at(a1, j);
        if (d) {
            const u32 *e = sg + d * 16;
            for (int i = 0; i < 8; ++i) { px[i] = e[i]; py[i] = e[8 + i]; }
            if (s1) fp_neg(py, py);
            jac_madd<SecpFp>(acc, acc, px, py);
        }
        d = digit_at(a2, j);
        if (d) {
            const u32 *e = sg + (TBL + d) * 16;
            for (int i = 0; i < 8; ++i) { px[i] = e[i]; py[i] = e[8 + i]; }
            if (s2) fp_neg(py, py);
            jac_madd<SecpFp>(acc, acc, px, py);
        }
        d = digit_at(b1, j);
        if (d) {
            set8(px, tx[d]);
            if (t1) fp_neg(py, ty[d]); else set8(py, ty[d]);
            jac_madd<SecpFp>(acc, acc, px, py);
        }
        d = digit_at(b2, j);
        if (d) {
            fp_mul(px, tx[d], beta);
            if (t2) fp_neg(py, ty[d]); else set8(py, ty[d]);
            jac_madd<SecpFp>(acc, acc, px, py);
        }
    }
}
