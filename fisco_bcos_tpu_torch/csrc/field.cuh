// secp256k1 field and group-order arithmetic, one 256-bit value per thread.
//
// Replaces the field layer of fisco_bcos_tpu/ops/pallas_fp.py
// (solinas_mul_body :82, mont_mul_body :109, pow_digits_values :281) as
// device functions inlined into the verify and recover kernels.
//
// Design: the TPU kernels carry 16 limbs of 16 bits so that a limb product
// fits a uint32 lane. Hopper has a 32x32->64 multiply, so here a value is
// 8 little-endian 32-bit words (bigint.cuh) and a 256x256-bit product is 64
// wide multiply-adds into 64-bit accumulators. What bounds it: integer
// multiply-add issue (64 per 256-bit multiply plus the reduction), with
// every value kept in registers; nothing here touches device memory.
//
// * mod p (p = 2^256 - 2^32 - 977): plain domain, the 512-bit product folds
//   twice by 2^256 = 2^32 + 977 (mod p), then one conditional subtract.
// * mod n: Montgomery domain with R = 2^256 (CIOS), as ops/fp.MontField.
// Every function returns a canonical value (< modulus) for canonical input.
#pragma once
#include "bigint.cuh"

// Every constant the kernels read sits in one __constant__ block, filled
// from ops/consts.py (`kernel_words`, field order `SECP_FIELDS`) through
// `set_consts` before a module's first launch on a device; the sources
// carry no copy of their own. The mod-p fold below is written for the
// shape of secp256k1's p, which kernel_words checks.
struct SecpConsts {
    u32 p[8], sqrt_e[8], inv_e_p[8], b[8];  // p, (p+1)/4, p-2, curve b
    u32 n[8], r2[8], one[8], inv_e_n[8];    // n, R^2 and R mod n, n-2
    u32 beta[8], g1[8], g2[8];              // GLV: beta, round(2^384 b_i / n)
    u32 mb1r[8], mb2r[8], lamr[8];          // -b1 R, -b2 R, lambda R (mod n)
    u32 half_n[8];
    u32 np0;                                // -n^-1 mod 2^32
};
static __constant__ SecpConsts SC;

#define FP_P (SC.p)
#define FP_SQRT_E (SC.sqrt_e)
#define FP_INV_E (SC.inv_e_p)
#define FP_B (SC.b)
#define FN_N (SC.n)
#define FN_NP0 (SC.np0)
#define FN_R2 (SC.r2)
#define FN_ONE (SC.one)
#define FN_INV_E (SC.inv_e_n)

// ---------------------------------------------------------------- mod p

// r = t mod p for a 512-bit t
__device__ __forceinline__ void fp_reduce512(u32 r[8], const u32 t[16]) {
    u32 s[8];
    u64 c = 0;
    // fold 1: lo + hi * 977 + (hi << 32)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        c += (u64)t[i] + (u64)t[8 + i] * 977u + (i ? t[7 + i] : 0u);
        s[i] = (u32)c;
        c >>= 32;
    }
    u64 top = c + t[15];  // value = s + top * 2^256, top < 2^34
    // fold 2: s + top * 977 + (top << 32)
    u64 m = top * 977u;
    c = (u64)s[0] + (u32)m;
    s[0] = (u32)c;
    c >>= 32;
    c += (u64)s[1] + (m >> 32) + (u32)top;
    s[1] = (u32)c;
    c >>= 32;
    c += (u64)s[2] + (top >> 32);
    s[2] = (u32)c;
    c >>= 32;
#pragma unroll
    for (int i = 3; i < 8; ++i) {
        c += s[i];
        s[i] = (u32)c;
        c >>= 32;
    }
    if (c) {  // wrapped past 2^256: the remainder is tiny, add 2^256 mod p once
        c = (u64)s[0] + 977u;
        s[0] = (u32)c;
        c >>= 32;
        c += (u64)s[1] + 1u;
        s[1] = (u32)c;
        c >>= 32;
#pragma unroll
        for (int i = 2; i < 8; ++i) {
            c += s[i];
            s[i] = (u32)c;
            c >>= 32;
        }
    }
    u32 d[8];
    if (sub8(d, s, FP_P) == 0) set8(s, d);
    set8(r, s);
}

__device__ __forceinline__ void fp_mul(u32 r[8], const u32 a[8], const u32 b[8]) {
    u32 t[16];
    mul_wide8(t, a, b);
    fp_reduce512(r, t);
}

__device__ __forceinline__ void fp_sqr(u32 r[8], const u32 a[8]) { fp_mul(r, a, a); }

__device__ __forceinline__ void fp_add(u32 r[8], const u32 a[8], const u32 b[8]) {
    add_mod(r, a, b, FP_P);
}

__device__ __forceinline__ void fp_sub(u32 r[8], const u32 a[8], const u32 b[8]) {
    sub_mod(r, a, b, FP_P);
}

__device__ __forceinline__ void fp_neg(u32 r[8], const u32 a[8]) {
    u32 d[8];
    if (is_zero8(a)) {
        zero8(r);
        return;
    }
    sub8(d, FP_P, a);
    set8(r, d);
}

// reduce any value < 2^256 to canonical mod p (one conditional subtract)
__device__ __forceinline__ void fp_reduce(u32 r[8], const u32 a[8]) {
    u32 d[8];
    if (sub8(d, a, FP_P) == 0) set8(r, d); else set8(r, a);
}

// ---------------------------------------------------------------- mod n

// r = a * b * R^-1 mod n (bigint.cuh's CIOS over the group order)
__device__ __forceinline__ void fn_mont_mul(u32 r[8], const u32 a[8], const u32 b[8]) {
    mont_mul(r, a, b, FN_N, FN_NP0);
}

__device__ __forceinline__ void fn_add(u32 r[8], const u32 a[8], const u32 b[8]) {
    add_mod(r, a, b, FN_N);
}

__device__ __forceinline__ void fn_sub(u32 r[8], const u32 a[8], const u32 b[8]) {
    sub_mod(r, a, b, FN_N);
}

__device__ __forceinline__ void fn_neg(u32 r[8], const u32 a[8]) {
    u32 d[8];
    if (is_zero8(a)) {
        zero8(r);
        return;
    }
    sub8(d, FN_N, a);
    set8(r, d);
}

// any value < 2^256 -> canonical mod n (2n > 2^256: one conditional subtract)
__device__ __forceinline__ void fn_reduce(u32 r[8], const u32 a[8]) {
    u32 d[8];
    if (sub8(d, a, FN_N) == 0) set8(r, d); else set8(r, a);
}

// ---------------------------------------------------------------- powers

struct FpOps {
    static __device__ __forceinline__ void mul(u32 r[8], const u32 a[8], const u32 b[8]) {
        fp_mul(r, a, b);
    }
};

struct FnMontOps {
    static __device__ __forceinline__ void mul(u32 r[8], const u32 a[8], const u32 b[8]) {
        fn_mont_mul(r, a, b);
    }
};
