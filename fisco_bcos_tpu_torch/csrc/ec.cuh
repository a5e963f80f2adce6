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
// * Jacobian coordinates, complete by selection as in ops/ec.py: the mixed
//   add handles P = infinity, P == Q (doubling) and P == -Q (infinity).
//   Here a branch does the selection; the rare cases diverge, the common
//   path runs once.
// * Only the per-lane Q table (k*Q, k < 16) is built, normalised to affine
//   with one inversion (Montgomery's trick over its 14 Z values); phi(Q)
//   entries are (beta*x, y) formed at lookup, so the per-thread table is
//   16 x 2 x 8 words rather than twice that.
// * The G and phi(G) tables (2 x 16 affine points) are indexed by each
//   lane's own digit, so they sit in shared memory (constant memory would
//   serialise the divergent reads); the kernel stages them per block.
#pragma once
#include "field.cuh"

#define GLV_BETA (SC.beta)
#define GLV_G1 (SC.g1)
#define GLV_G2 (SC.g2)
#define GLV_MB1R (SC.mb1r)
#define GLV_MB2R (SC.mb2r)
#define GLV_LAMR (SC.lamr)
#define HALF_N (SC.half_n)

#define GLV_DIGITS 34
#define TBL 16

struct Jac {
    u32 X[8], Y[8], Z[8];
};

__device__ __forceinline__ void jac_set_inf(Jac &P) {
    zero8(P.X);
    zero8(P.Y);
    zero8(P.Z);
}

// R = 2P for a = 0; Z = 0 (infinity) stays Z = 0. R may alias P.
__device__ void jac_double(Jac &R, const Jac &P) {
    u32 XX[8], YY[8], XYY[8], YYYY[8], M[8], S[8], t[8], Z3[8];
    fp_add(t, P.Y, P.Y);
    fp_mul(Z3, t, P.Z);
    fp_sqr(XX, P.X);
    fp_sqr(YY, P.Y);
    fp_mul(XYY, P.X, YY);
    fp_sqr(YYYY, YY);
    fp_add(M, XX, XX);
    fp_add(M, M, XX);            // 3 X^2
    fp_add(S, XYY, XYY);
    fp_add(S, S, S);             // 4 X Y^2
    fp_sqr(t, M);
    fp_sub(t, t, S);
    fp_sub(R.X, t, S);           // M^2 - 2S
    fp_sub(t, S, R.X);
    fp_mul(t, M, t);
    fp_add(YYYY, YYYY, YYYY);
    fp_add(YYYY, YYYY, YYYY);
    fp_add(YYYY, YYYY, YYYY);    // 8 Y^4
    fp_sub(R.Y, t, YYYY);
    set8(R.Z, Z3);
}

// R = P + (qx, qy), the second operand affine and not infinity.
// Complete: P = inf, P == Q and P == -Q are selected. R may alias P.
__device__ void jac_madd(Jac &R, const Jac &P, const u32 qx[8], const u32 qy[8]) {
    if (is_zero8(P.Z)) {
        set8(R.X, qx);
        set8(R.Y, qy);
        zero8(R.Z);
        R.Z[0] = 1;
        return;
    }
    u32 Z1Z1[8], U2[8], S2[8], H[8], Rr[8];
    fp_sqr(Z1Z1, P.Z);
    fp_mul(U2, qx, Z1Z1);
    fp_mul(S2, qy, P.Z);
    fp_mul(S2, S2, Z1Z1);
    fp_sub(H, U2, P.X);
    fp_sub(Rr, S2, P.Y);
    if (is_zero8(H)) {
        if (is_zero8(Rr)) jac_double(R, P);
        else jac_set_inf(R);
        return;
    }
    u32 HH[8], HHH[8], V[8], t[8], X3[8];
    fp_sqr(HH, H);
    fp_mul(HHH, H, HH);
    fp_mul(V, P.X, HH);
    fp_sqr(t, Rr);
    fp_sub(t, t, HHH);
    fp_sub(t, t, V);
    fp_sub(X3, t, V);
    fp_sub(t, V, X3);
    fp_mul(t, Rr, t);
    fp_mul(HHH, P.Y, HHH);
    fp_mul(R.Z, P.Z, H);
    fp_sub(R.Y, t, HHH);
    set8(R.X, X3);
}

// Affine table k*Q for k = 1..15 (entry 0 unused). Entries with Z = 0 can
// only come from a Q that is not on the curve; they normalise to zeros and
// the caller has already rejected that lane.
__device__ void q_table(u32 tx[TBL][8], u32 ty[TBL][8], const u32 qx[8], const u32 qy[8]) {
    u32 tz[TBL][8], pre[TBL][8];
    Jac P;
    set8(P.X, qx);
    set8(P.Y, qy);
    zero8(P.Z);
    P.Z[0] = 1;
    set8(tx[1], P.X);
    set8(ty[1], P.Y);
    set8(tz[1], P.Z);
    jac_double(P, P);
    for (int k = 2; k < TBL; ++k) {
        if (k > 2) jac_madd(P, P, qx, qy);
        set8(tx[k], P.X);
        set8(ty[k], P.Y);
        set8(tz[k], P.Z);
    }
    // Montgomery's trick: pre[k] = z1 * ... * zk, one inversion, unwind
    set8(pre[1], tz[1]);
    for (int k = 2; k < TBL; ++k) fp_mul(pre[k], pre[k - 1], tz[k]);
    u32 e[8], one[8], inv[8], zi[8], zi2[8];
    set8(e, FP_INV_E);
    zero8(one);
    one[0] = 1;
    pow_fixed<FpOps>(inv, pre[TBL - 1], e, one);
    for (int k = TBL - 1; k >= 1; --k) {
        if (k > 1) fp_mul(zi, inv, pre[k - 1]); else set8(zi, inv);
        fp_mul(inv, inv, tz[k]);
        fp_sqr(zi2, zi);
        fp_mul(tx[k], tx[k], zi2);
        fp_mul(zi2, zi2, zi);
        fp_mul(ty[k], ty[k], zi2);
    }
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

__device__ __forceinline__ u32 digit_at(const u32 m[8], int j) {
    return (m[j >> 3] >> (4 * (j & 7))) & 15u;
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
    q_table(tx, ty, qx, qy);
    u32 beta[8];
    set8(beta, GLV_BETA);
    jac_set_inf(acc);
    u32 px[8], py[8];
    for (int j = GLV_DIGITS - 1; j >= 0; --j) {
        for (int k = 0; k < 4; ++k) jac_double(acc, acc);
        u32 d = digit_at(a1, j);
        if (d) {
            const u32 *e = sg + d * 16;
            for (int i = 0; i < 8; ++i) { px[i] = e[i]; py[i] = e[8 + i]; }
            if (s1) fp_neg(py, py);
            jac_madd(acc, acc, px, py);
        }
        d = digit_at(a2, j);
        if (d) {
            const u32 *e = sg + (TBL + d) * 16;
            for (int i = 0; i < 8; ++i) { px[i] = e[i]; py[i] = e[8 + i]; }
            if (s2) fp_neg(py, py);
            jac_madd(acc, acc, px, py);
        }
        d = digit_at(b1, j);
        if (d) {
            set8(px, tx[d]);
            if (t1) fp_neg(py, ty[d]); else set8(py, ty[d]);
            jac_madd(acc, acc, px, py);
        }
        d = digit_at(b2, j);
        if (d) {
            fp_mul(px, tx[d], beta);
            if (t2) fp_neg(py, ty[d]); else set8(py, ty[d]);
            jac_madd(acc, acc, px, py);
        }
    }
}
