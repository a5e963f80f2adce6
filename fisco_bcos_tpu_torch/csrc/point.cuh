// Jacobian point arithmetic over a field F, shared by the secp256k1
// ladder (ec.cuh, a = 0), the SM2 verify ladder (sm2.cuh, a = -3) and the
// standalone ladder kernel (ladder.cu). Counterpart of ops/ec.py
// jac_double / jac_add / jac_add_affine / _q_window_affine and of
// fisco_bcos_tpu/ops/pallas_ec.py vjac_double :106 and vjac_add :145.
//
// F supplies static mul, mul2 (two independent products), add, sub, neg,
// one(r) (its one in its domain), inv(r, a) (zero maps to zero) and
// `static constexpr bool A_MINUS3`. Every F op returns a canonical
// value, so two formulas for the same field value give the same words: the
// Jacobian representative a function returns is set by which values it
// computes, not by how.
//
// The adds are complete by branch, as ops/ec.py is by selection: P =
// infinity, P == Q (doubling) and P == -Q (infinity) each take their own
// path; those lanes diverge, the common path runs once. The doubling that
// an add takes on P == Q is a call (`jac_double_cold`), so that the
// step loops keep one copy of the doubling's code and not three.
#pragma once
#include "bigint.cuh"

#define TBL 16

struct Jac {
    u32 X[8], Y[8], Z[8];
};

__device__ __forceinline__ void jac_set_inf(Jac &P) {
    zero8(P.X);
    zero8(P.Y);
    zero8(P.Z);
}

// Products go in pairs where two are independent: F::mul2(r0, a0, b0, r1,
// a1, b1) computes both in one call, whose two dependency chains fill each
// other's latency. Each value is the one the formulas of ops/ec.py
// compute, in another order.

// R = 2P; Z = 0 (infinity) stays Z = 0. R may alias P.
// a = 0: M = 3 X^2; a = -3: M = 3 (X - Z^2)(X + Z^2).
template <class F>
__device__ __forceinline__ void jac_double(Jac &R, const Jac &P) {
    u32 YY[8], XYY[8], YYYY[8], M[8], S[8], t[8], u[8], Z3[8];
    F::add(t, P.Y, P.Y);
    if constexpr (F::A_MINUS3) {
        F::mul2(Z3, t, P.Z, u, P.Z, P.Z);
        F::sub(t, P.X, u);
        F::add(u, P.X, u);
        F::mul2(YY, P.Y, P.Y, t, t, u);  // t = (X - Z^2)(X + Z^2)
        F::add(M, t, t);
        F::add(M, M, t);
        F::mul2(XYY, P.X, YY, YYYY, YY, YY);
        F::mul(t, M, M);
    } else {
        F::mul2(Z3, t, P.Z, YY, P.Y, P.Y);
        F::mul2(t, P.X, P.X, XYY, P.X, YY);  // t = X^2
        F::add(M, t, t);
        F::add(M, M, t);
        F::mul2(YYYY, YY, YY, t, M, M);
    }
    F::add(S, XYY, XYY);
    F::add(S, S, S);             // 4 X Y^2
    F::sub(t, t, S);
    F::sub(R.X, t, S);           // M^2 - 2S
    F::sub(t, S, R.X);
    F::mul(t, M, t);
    F::add(YYYY, YYYY, YYYY);
    F::add(YYYY, YYYY, YYYY);
    F::add(YYYY, YYYY, YYYY);    // 8 Y^4
    F::sub(R.Y, t, YYYY);
    set8(R.Z, Z3);
}

// 2P out of line, for the adds' rare P == Q branch; by value both ways,
// so that no operand of the caller has its address taken (which would
// keep it in local memory on the common path too)
template <class F>
__device__ __noinline__ Jac jac_double_cold(Jac P) {
    Jac R;
    jac_double<F>(R, P);
    return R;
}

// R = P + (qx, qy), the second operand affine and not infinity.
// Complete: P = inf, P == Q and P == -Q are selected. R may alias P.
template <class F>
__device__ __forceinline__ void jac_madd(Jac &R, const Jac &P, const u32 qx[8],
                                         const u32 qy[8]) {
    if (is_zero8(P.Z)) {
        set8(R.X, qx);
        set8(R.Y, qy);
        F::one(R.Z);
        return;
    }
    u32 Z1Z1[8], U2[8], S2[8], H[8], Rr[8];
    F::mul2(Z1Z1, P.Z, P.Z, S2, qy, P.Z);
    F::mul2(U2, qx, Z1Z1, S2, S2, Z1Z1);
    F::sub(H, U2, P.X);
    F::sub(Rr, S2, P.Y);
    if (is_zero8(H)) {
        if (is_zero8(Rr)) R = jac_double_cold<F>(P);
        else jac_set_inf(R);
        return;
    }
    u32 HH[8], HHH[8], V[8], RR[8], t[8], X3[8], Z3[8];
    F::mul2(HH, H, H, RR, Rr, Rr);
    F::mul2(HHH, H, HH, V, P.X, HH);
    F::sub(t, RR, HHH);
    F::sub(t, t, V);
    F::sub(X3, t, V);
    F::sub(t, V, X3);
    F::mul2(t, Rr, t, HHH, P.Y, HHH);
    F::mul(Z3, P.Z, H);
    F::sub(R.Y, t, HHH);
    set8(R.X, X3);
    set8(R.Z, Z3);
}

// R = P + Q, both Jacobian (pallas_ec.vjac_add :145, ops/ec.py jac_add).
// Complete by branch, in vjac_add's selection order: P = inf (Z = 0) gives
// Q, then Q = inf gives P, then H = 0 gives 2P (R = 0) or infinity (zeros);
// a Z = 0 point is returned with whatever X and Y it carries, as the
// selection returns it. R may alias P or Q.
template <class F>
__device__ __forceinline__ void jac_add(Jac &R, const Jac &P, const Jac &Q) {
    if (is_zero8(P.Z)) {
        R = Q;
        return;
    }
    if (is_zero8(Q.Z)) {
        R = P;
        return;
    }
    u32 Z1Z1[8], Z2Z2[8], U1[8], U2[8], S1[8], S2[8], H[8], Rr[8];
    F::mul2(Z1Z1, P.Z, P.Z, Z2Z2, Q.Z, Q.Z);
    F::mul2(S1, P.Y, Q.Z, S2, Q.Y, P.Z);
    F::mul2(U1, P.X, Z2Z2, U2, Q.X, Z1Z1);
    F::mul2(S1, S1, Z2Z2, S2, S2, Z1Z1);
    F::sub(H, U2, U1);
    F::sub(Rr, S2, S1);
    if (is_zero8(H)) {
        if (is_zero8(Rr)) R = jac_double_cold<F>(P);
        else jac_set_inf(R);
        return;
    }
    u32 HH[8], HHH[8], V[8], RR[8], t[8], X3[8], Z3[8];
    F::mul2(HH, H, H, Z3, P.Z, Q.Z);
    F::mul2(RR, Rr, Rr, Z3, Z3, H);
    F::mul2(HHH, H, HH, V, U1, HH);
    F::sub(t, RR, HHH);
    F::sub(t, t, V);
    F::sub(X3, t, V);            // R^2 - H^3 - 2V
    F::sub(t, V, X3);
    F::mul2(t, Rr, t, HHH, S1, HHH);
    F::sub(R.Y, t, HHH);         // R (V - X3) - S1 H^3
    set8(R.X, X3);
    set8(R.Z, Z3);
}

// Affine table k*Q for k = 1..15 (entry 0 unused), in F's domain. Entries
// with Z = 0 can only come from a Q that is not on the curve; they
// normalise to zeros and the caller has already rejected that lane.
template <class F>
__device__ __forceinline__ void q_table(u32 tx[TBL][8], u32 ty[TBL][8], const u32 qx[8],
                                        const u32 qy[8]) {
    u32 tz[TBL][8], pre[TBL][8];
    Jac P;
    set8(P.X, qx);
    set8(P.Y, qy);
    F::one(P.Z);
    set8(tx[1], P.X);
    set8(ty[1], P.Y);
    set8(tz[1], P.Z);
    jac_double<F>(P, P);
    for (int k = 2; k < TBL; ++k) {
        if (k > 2) jac_madd<F>(P, P, qx, qy);
        set8(tx[k], P.X);
        set8(ty[k], P.Y);
        set8(tz[k], P.Z);
    }
    // Montgomery's trick: pre[k] = z1 * ... * zk, one inversion, unwind
    set8(pre[1], tz[1]);
    for (int k = 2; k < TBL; ++k) F::mul(pre[k], pre[k - 1], tz[k]);
    u32 inv[8], zi[8], zi2[8];
    F::inv(inv, pre[TBL - 1]);
    for (int k = TBL - 1; k >= 1; --k) {
        if (k > 1) F::mul(zi, inv, pre[k - 1]); else set8(zi, inv);
        F::mul(inv, inv, tz[k]);
        F::mul(zi2, zi, zi);
        F::mul(tx[k], tx[k], zi2);
        F::mul(zi2, zi2, zi);
        F::mul(ty[k], ty[k], zi2);
    }
}
