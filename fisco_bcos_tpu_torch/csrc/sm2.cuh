// Per-signature body of the SM2 verify kernel (sm2.cu), following
// fisco_bcos_tpu/ops/pallas_verify.py _sm2_verify_kernel_body :404 step by
// step: R' = e + x(s*G + (r+s)*Q) == r (mod n), GB/T 32918.
//
// SM2's p = 2^256 - 2^224 - 2^96 + 2^64 - 1 is a generalized-Mersenne
// prime. The field is the Montgomery domain mod p (R = 2^256), as
// ops/fp.MontField, but its product is special-form: -p^-1 = 1 mod 2^32,
// so each reduction round's multiplier m is the running low word itself,
// and m p = m 2^256 - m 2^224 - m 2^96 + m 2^64 - m is word adds and
// subtracts, no multiplies (`sm2_mont_reduce`); the result is the same
// canonical a b R^-1 mod p as CIOS's, so every limb stays as it was. The
// group order n needs no product here: t = r + s and x1 = r - e are
// additions mod n.
//
// Ladder: the plain 64-step Shamir ladder of s*G + t*Q over 4-bit MSB-first
// windows (pallas_ec.ladder's 64-step form, ops/ec.shamir_mult), four
// a = -3 doublings and up to two mixed adds a step.
//
// Q table: affine, normalised with one per-lane inversion by Montgomery's
// trick (point.cuh q_table), not Jacobian as the TPU kernel builds it
// (pallas_ec.py:231-241). Affine entries take the 11-multiply mixed add in
// the ladder instead of a 16-multiply full add; over the ~60 Q adds of a
// lane that saves about what the one inversion costs (~330 products), so
// the choice is even in products, and the table is 16 x 2 x 8 words (1 KB
// of local memory a thread) instead of 1.5 KB, with point.cuh's table code
// shared with secp256k1.
#pragma once
#include "bigint.cuh"
#include "point.cuh"

// Every constant sits in one __constant__ block, filled from ops/consts.py
// (`kernel_words(...)["sm2"]`, field order `SM2_FIELDS`) by `set_consts`.
// Field values p-side are in the Montgomery domain (pone = R mod p, a and b
// as aR mod p, bR mod p); n and inv_e_p = p - 2 are plain.
struct Sm2Consts {
    u32 p[8], pr2[8], pone[8];   // p, R^2 mod p, R mod p
    u32 a[8], b[8];              // curve a, b (Montgomery)
    u32 inv_e_p[8];              // p - 2
    u32 n[8];                    // group order
    u32 pnp;                     // -p^-1 mod 2^32
};
static __constant__ Sm2Consts S2;

// r = t R^-1 mod p for t < p 2^256 (a product of canonical operands),
// canonical. Round k (0..7) takes m = word k of the running value (every
// lower word is already 0) and adds m p: word k cancels, +m at k + 2 and
// k + 8, -m at k + 3 and k + 7. The words sit in signed 64-bit columns,
// whose carries ripple once, low to high; the value before the last
// subtract is below 2p.
__device__ __forceinline__ void sm2_mont_reduce(u32 r[8], const u32 t[16]) {
    int64_t col[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) col[k] = t[k];
    int64_t carry = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        int64_t v = col[k] + carry;
        u32 m = (u32)v;
        carry = v >> 32;  // v - m is a multiple of 2^32
        col[k + 2] += m;
        col[k + 3] -= m;
        col[k + 7] -= m;
        col[k + 8] += m;
    }
#pragma unroll
    for (int k = 8; k < 16; ++k) {
        int64_t v = col[k] + carry;
        r[k - 8] = (u32)v;
        carry = v >> 32;
    }
    u32 d[8];
    u32 brw = sub8(d, r, S2.p);
    sel8(r, (u32)carry | (brw ^ 1u), d, r);
}

// The product out of line: one copy of its ~330 instructions for the ~20
// products of a ladder step, where inlined copies made the step loop too
// large for the instruction cache (PERF.md)
__device__ __noinline__ W8 sm2_mul_out(W8 a, W8 b) {
    u32 t[16];
    W8 r;
    mul_wide8(t, a.w, b.w);
    sm2_mont_reduce(r.w, t);
    return r;
}

// two independent products in one call, their chains interleaved
__device__ __noinline__ W16 sm2_mul2_out(W8 a0, W8 b0, W8 a1, W8 b1) {
    u32 t0[16], t1[16];
    W16 r;
    mul_wide8(t0, a0.w, b0.w);
    mul_wide8(t1, a1.w, b1.w);
    sm2_mont_reduce(r.w, t0);
    sm2_mont_reduce(r.w + 8, t1);
    return r;
}

struct Sm2Fp {
    static constexpr bool A_MINUS3 = true;
    static __device__ __forceinline__ void mul(u32 r[8], const u32 a[8], const u32 b[8]) {
        W8 x, y;
        set8(x.w, a);
        set8(y.w, b);
        W8 z = sm2_mul_out(x, y);
        set8(r, z.w);
    }
    static __device__ __forceinline__ void mul2(u32 r0[8], const u32 a0[8], const u32 b0[8],
                                                u32 r1[8], const u32 a1[8], const u32 b1[8]) {
        W8 x0, y0, x1, y1;
        set8(x0.w, a0);
        set8(y0.w, b0);
        set8(x1.w, a1);
        set8(y1.w, b1);
        W16 z = sm2_mul2_out(x0, y0, x1, y1);
        set8(r0, z.w);
        set8(r1, z.w + 8);
    }
    static __device__ __forceinline__ void add(u32 r[8], const u32 a[8], const u32 b[8]) {
        add_mod(r, a, b, S2.p);
    }
    static __device__ __forceinline__ void sub(u32 r[8], const u32 a[8], const u32 b[8]) {
        sub_mod(r, a, b, S2.p);
    }
    static __device__ __forceinline__ void neg(u32 r[8], const u32 a[8]) {
        u32 d[8], z[8];
        zero8(z);
        sub8(d, S2.p, a);
        sel8(r, is_zero8(a), z, d);
    }
    static __device__ __forceinline__ void one(u32 r[8]) { set8(r, S2.pone); }
    static __device__ __forceinline__ void inv(u32 r[8], const u32 a[8]) {
        u32 e[8], one1[8];
        set8(e, S2.inv_e_p);
        one(one1);
        pow_fixed<Sm2Fp>(r, a, e, one1);
    }
};

// plain x < p -> Montgomery domain
__device__ __forceinline__ void sm2_to_mont(u32 r[8], const u32 x[8]) {
    u32 r2[8];
    set8(r2, S2.pr2);
    Sm2Fp::mul(r, x, r2);
}

// sg: [TBL][16] words in shared memory, (x | y) of k*G in the Montgomery
// domain. Inputs are plain 256-bit integers.
__device__ bool sm2_verify_one(const u32 e[8], const u32 r[8], const u32 s[8],
                               const u32 qx[8], const u32 qy[8], const u32 *sg) {
    if (is_zero8(r) || is_zero8(s) || geq8(r, S2.n) || geq8(s, S2.n) || geq8(qx, S2.p)
        || geq8(qy, S2.p))
        return false;
    if (is_zero8(qx) && is_zero8(qy)) return false;
    u32 xm[8], ym[8], lhs[8], rhs[8], t[8];
    sm2_to_mont(xm, qx);
    sm2_to_mont(ym, qy);
    Sm2Fp::mul(rhs, xm, xm);
    Sm2Fp::mul(rhs, rhs, xm);
    set8(t, S2.a);
    Sm2Fp::mul(t, t, xm);
    Sm2Fp::add(rhs, rhs, t);
    set8(t, S2.b);
    Sm2Fp::add(rhs, rhs, t);
    Sm2Fp::mul(lhs, ym, ym);
    if (!eq8(lhs, rhs)) return false;  // not on the curve
    u32 tt[8];
    add_mod(tt, r, s, S2.n);  // t = r + s mod n
    if (is_zero8(tt)) return false;
    // s*G + t*Q
    u32 tx[TBL][8], ty[TBL][8], px[8], py[8];
    q_table<Sm2Fp>(tx, ty, xm, ym);
    Jac acc;
    jac_set_inf(acc);
    for (int j = 63; j >= 0; --j) {
#pragma unroll 1
        for (int k = 0; k < 4; ++k) jac_double<Sm2Fp>(acc, acc);
        u32 d = digit_at(s, j);
        if (d) {
            const u32 *g = sg + d * 16;
            for (int i = 0; i < 8; ++i) { px[i] = g[i]; py[i] = g[8 + i]; }
            jac_madd<Sm2Fp>(acc, acc, px, py);
        }
        d = digit_at(tt, j);
        if (d) jac_madd<Sm2Fp>(acc, acc, tx[d], ty[d]);
    }
    if (is_zero8(acc.Z)) return false;
    // x1 == c (mod n) for c = r - e without an inversion: X == cand * Z^2
    // for cand in {c, c + n}, the second only when c + n < p
    u32 c[8], zz[8], cm[8];
    if (geq8(e, S2.n)) sub8(c, e, S2.n); else set8(c, e);  // e < 2^256 < 2n
    sub_mod(c, r, c, S2.n);
    Sm2Fp::mul(zz, acc.Z, acc.Z);
    sm2_to_mont(cm, c);
    Sm2Fp::mul(t, cm, zz);
    if (eq8(acc.X, t)) return true;
    if (add8(c, c, S2.n) || geq8(c, S2.p)) return false;
    sm2_to_mont(cm, c);
    Sm2Fp::mul(t, cm, zz);
    return eq8(acc.X, t);
}
