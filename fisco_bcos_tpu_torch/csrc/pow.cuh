// Kernel G's per-lane bodies (csrc/fp.cu `fp_pow_*_kernel`): a^e in a
// field's domain for an exponent fixed for the whole launch, in one of
// three modes that the wrapper picks from e (ops/cuda_fp.pow_mode):
//
// * inverse, e = m - 2 for the field's prime modulus m: modinv.cuh's
//   safegcd inverse over a modulus passed in the launch's parameters
//   (`InvArg`), not ~330 dependent products; in constant time, except on
//   a one-lane launch (the [16, 1] root of a batched inversion), where the
//   variable-time form has no warp to wait for and was measured faster
//   (PERF.md). A Montgomery field's domain is fixed up with one product by
//   R^3 mod m: inv(a R) = a^-1 R^-1, times R^3 R^-1, is a^-1 R. Zero stays
//   zero, as it does under the power.
// * square root, e = (p + 1) / 4 on secp256k1's p: ec.cuh's addition
//   chain `fp_sqrt`, 266 products against the window loop's 329.
// * window, any other e: the TPU kernel's 4-bit window loop, kept for
//   generality (pallas_fp.pow_digits_values).
//
// a^e is unique and every mode returns it canonical, so every mode gives
// the limbs of the plain window loop (ops/fp.py pow_const).
#pragma once
#include "ec.cuh"

// One field as a kernel argument (passed by value, so it rides in the
// launch's parameter space): modulus words, np0, and the Solinas flag.
struct FieldArg {
    u32 n[8];
    u32 np0;
    u32 solinas;
};

// The window mode's exponent: nd 4-bit digits, most significant first,
// and the field's one in its domain (table entry 0)
struct PowArg {
    u32 one[8];
    int nd;
    unsigned char d[64];
};

// The inverse mode's modulus for modinv_of, and R^3 mod m for a
// Montgomery field's domain (unused for the Solinas field's plain domain)
struct InvArg {
    ModInv30 mi;
    u32 r3[8];
};

// r = a * b in the field's domain: canonical whenever one operand is below
// the modulus and the other below 2^256 (the to_rep case, bigint.cuh)
__device__ __forceinline__ void field_mul(u32 r[8], const u32 a[8], const u32 b[8],
                                          const FieldArg &f) {
    if (f.solinas) fp_mul(r, a, b);
    else mont_mul(r, a, b, f.n, f.np0);
}

// the inverse mode, one lane, in constant time or (VAR) variable time. An
// input in [m, 2^256) is first brought below m, since modinv takes a < m:
// every field of ops/fp has m > 2^253, so 7 conditional subtracts always
// do.
template <bool VAR>
__device__ __forceinline__ W8 pow_inverse(W8 a, const FieldArg &f, const InvArg &v) {
#pragma unroll 1
    for (int k = 0; k < 7; ++k) {
        u32 d[8];
        const u32 brw = sub8(d, a.w, f.n);
        sel8(a.w, brw ^ 1u, d, a.w);
    }
    W8 r = VAR ? modinv_var_of(a, v.mi) : modinv_of(a, v.mi);
    if (!f.solinas) mont_mul(r.w, r.w, v.r3, f.n, f.np0);
    return r;
}

// the Montgomery product by value and out of line, as ec.cuh's fp_mul_out
// is for secp256k1's p: one copy of the product's code for the loop
__device__ __noinline__ W8 mont_mul_out(W8 a, W8 b, W8 n, u32 np0) {
    W8 r;
    mont_mul(r.w, a.w, b.w, n.w, np0);
    return r;
}

__device__ __noinline__ W16 mont_mul2_out(W8 a0, W8 b0, W8 a1, W8 b1, W8 n, u32 np0) {
    W16 r;
    mont_mul(r.w, a0.w, b0.w, n.w, np0);
    mont_mul(r.w + 8, a1.w, b1.w, n.w, np0);
    return r;
}

// the window loop's products: secp256k1's p (plain domain) ...
struct SolinasPow {
    __device__ __forceinline__ W8 mul(W8 a, W8 b) const { return fp_mul_out(a, b); }
    __device__ __forceinline__ void mul2(W8 &r0, W8 a0, W8 b0, W8 &r1, W8 a1, W8 b1) const {
        W16 z = fp_mul2_out(a0, b0, a1, b1);
        set8(r0.w, z.w);
        set8(r1.w, z.w + 8);
    }
};

// ... or any Montgomery field (R = 2^256)
struct MontPow {
    W8 n;
    u32 np0;
    __device__ __forceinline__ W8 mul(W8 a, W8 b) const { return mont_mul_out(a, b, n, np0); }
    __device__ __forceinline__ void mul2(W8 &r0, W8 a0, W8 b0, W8 &r1, W8 a1, W8 b1) const {
        W16 z = mont_mul2_out(a0, b0, a1, b1, n, np0);
        set8(r0.w, z.w);
        set8(r1.w, z.w + 8);
    }
};

// the window mode, one lane: the table of a^k, k < 16, built by squaring
// (tbl[2k] = tbl[k]^2, tbl[2k+1] = tbl[2k] a) so that its products pair
// (8 dependent calls for 14 products), then per further digit 4 squarings
// and one product by the digit's entry (entry 0, the field's one, too),
// the TPU kernel's sequence. The table is indexed by the digit, a run-time
// value, so it lives in local memory.
template <class F>
__device__ __forceinline__ W8 pow_window(W8 a, const PowArg &e, const F &f) {
    W8 tbl[16];
    set8(tbl[0].w, e.one);
    tbl[1] = a;
    tbl[2] = f.mul(a, a);
    tbl[3] = f.mul(tbl[2], a);
#pragma unroll
    for (int k = 2; k < 8; k += 2) {
        f.mul2(tbl[2 * k], tbl[k], tbl[k], tbl[2 * k + 2], tbl[k + 1], tbl[k + 1]);
        f.mul2(tbl[2 * k + 1], tbl[2 * k], a, tbl[2 * k + 3], tbl[2 * k + 2], a);
    }
    W8 acc = tbl[e.d[0]];
#pragma unroll 1
    for (int i = 1; i < e.nd; ++i) {
#pragma unroll
        for (int k = 0; k < 4; ++k) acc = f.mul(acc, acc);
        acc = f.mul(acc, tbl[e.d[i]]);
    }
    return acc;
}

__device__ __forceinline__ W8 pow_window_field(W8 a, const PowArg &e, const FieldArg &f) {
    if (f.solinas) return pow_window(a, e, SolinasPow());
    MontPow m;
    set8(m.n.w, f.n);
    m.np0 = f.np0;
    return pow_window(a, e, m);
}
