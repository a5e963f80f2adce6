// Per-signature bodies of the recover and verify kernels (verify.cu),
// following pallas_verify._recover_kernel_body :283 and
// _verify_kernel_body :160 of the JAX package step by step.
#pragma once
#include "ec.cuh"

__device__ bool recover_one(u32 qx[8], u32 qy[8], const u32 e[8], const u32 r[8],
                            const u32 s[8], u32 v, const u32 *sg) {
    zero8(qx);
    zero8(qy);
    if (is_zero8(r) || is_zero8(s) || geq8(r, FN_N) || geq8(s, FN_N) || v >= 4)
        return false;
    u32 x[8], t[8];
    set8(t, FN_N);
    if (!((v >> 1) & 1)) zero8(t);
    if (add8(x, r, t) || geq8(x, FP_P)) return false;  // x = r + (v>>1) n < p
    u32 ysq[8], y[8], ex[8], one[8];
    fp_sqr(ysq, x);
    fp_mul(ysq, ysq, x);
    set8(t, FP_B);
    fp_add(ysq, ysq, t);
    zero8(one);
    one[0] = 1;
    set8(ex, FP_SQRT_E);
    pow_fixed<FpOps>(y, ysq, ex, one);
    fp_sqr(t, y);
    if (!eq8(t, ysq)) return false;
    if ((y[0] & 1u) != (v & 1u)) fp_neg(y, y);
    // u1 = -e / r, u2 = s / r (mod n); rinv = r^-1 in the Montgomery domain
    u32 rinv[8], u1[8], u2[8];
    fn_mont_mul(t, r, FN_R2);
    set8(ex, FN_INV_E);
    set8(one, FN_ONE);
    pow_fixed<FnMontOps>(rinv, t, ex, one);
    fn_reduce(t, e);
    fn_neg(t, t);
    fn_mont_mul(u1, t, rinv);
    fn_mont_mul(u2, s, rinv);
    Jac acc;
    glv_ladder(acc, u1, u2, x, y, sg);
    if (is_zero8(acc.Z)) return false;
    u32 zi[8], zi2[8];
    zero8(one);
    one[0] = 1;
    set8(ex, FP_INV_E);
    pow_fixed<FpOps>(zi, acc.Z, ex, one);
    fp_sqr(zi2, zi);
    fp_mul(qx, acc.X, zi2);
    fp_mul(zi2, zi2, zi);
    fp_mul(qy, acc.Y, zi2);
    return true;
}

__device__ bool verify_one(const u32 e[8], const u32 r[8], const u32 s[8],
                           const u32 qx[8], const u32 qy[8], const u32 *sg) {
    if (is_zero8(r) || is_zero8(s) || geq8(r, FN_N) || geq8(s, FN_N)
        || geq8(qx, FP_P) || geq8(qy, FP_P))
        return false;
    if (is_zero8(qx) && is_zero8(qy)) return false;
    u32 lhs[8], rhs[8], t[8];
    fp_sqr(rhs, qx);
    fp_mul(rhs, rhs, qx);
    set8(t, FP_B);
    fp_add(rhs, rhs, t);
    fp_sqr(lhs, qy);
    if (!eq8(lhs, rhs)) return false;  // not on the curve
    // w = s^-1 (Montgomery domain); u1 = e w, u2 = r w (plain)
    u32 w[8], ex[8], one[8], u1[8], u2[8];
    fn_mont_mul(t, s, FN_R2);
    set8(ex, FN_INV_E);
    set8(one, FN_ONE);
    pow_fixed<FnMontOps>(w, t, ex, one);
    fn_reduce(t, e);
    fn_mont_mul(u1, t, w);
    fn_mont_mul(u2, r, w);
    Jac acc;
    glv_ladder(acc, u1, u2, qx, qy, sg);
    if (is_zero8(acc.Z)) return false;
    // x(R) == r (mod n) without an inversion: X == cand * Z^2 for
    // cand in {r, r + n}, the second only when r + n < p
    u32 zz[8], rpn[8];
    fp_sqr(zz, acc.Z);
    fp_mul(t, r, zz);
    if (eq8(acc.X, t)) return true;
    if (add8(rpn, r, FN_N) || geq8(rpn, FP_P)) return false;
    fp_mul(t, rpn, zz);
    return eq8(acc.X, t);
}
