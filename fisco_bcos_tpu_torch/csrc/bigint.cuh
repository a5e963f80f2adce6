// 256-bit unsigned arithmetic on 8 little-endian 32-bit words, one value
// per thread, shared by the secp256k1 field (field.cuh) and SM2 (sm2.cuh).
//
// Hopper has a 32x32->64 multiply, so a 256x256-bit product is 64 wide
// multiply-adds into 64-bit accumulators; every value stays in registers.
// `mont_mul` is Montgomery multiplication (CIOS, R = 2^256) over any odd
// modulus given as a word array and its -N^-1 mod 2^32, as ops/fp.MontField.
#pragma once
#include <stdint.h>

typedef uint32_t u32;
typedef uint64_t u64;

// A 256-bit value by value: what an out-of-line product takes and returns,
// so that its operands pass in registers (arrays behind pointers would go
// through local memory)
struct W8 {
    u32 w[8];
};
struct W16 {
    u32 w[16];
};

__device__ __forceinline__ void set8(u32 r[8], const u32 a[8]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) r[i] = a[i];
}

__device__ __forceinline__ void zero8(u32 r[8]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) r[i] = 0;
}

__device__ __forceinline__ bool is_zero8(const u32 a[8]) {
    u32 acc = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc |= a[i];
    return acc == 0;
}

__device__ __forceinline__ bool eq8(const u32 a[8], const u32 b[8]) {
    u32 acc = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc |= a[i] ^ b[i];
    return acc == 0;
}

// r = a + b mod 2^256, returns the carry
__device__ __forceinline__ u32 add8(u32 r[8], const u32 a[8], const u32 b[8]) {
    u64 c = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        c += (u64)a[i] + b[i];
        r[i] = (u32)c;
        c >>= 32;
    }
    return (u32)c;
}

// r = a - b mod 2^256, returns the borrow
__device__ __forceinline__ u32 sub8(u32 r[8], const u32 a[8], const u32 b[8]) {
    u64 brw = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        u64 d = (u64)a[i] - b[i] - brw;
        r[i] = (u32)d;
        brw = (d >> 32) & 1;
    }
    return (u32)brw;
}

__device__ __forceinline__ bool geq8(const u32 a[8], const u32 b[8]) {
    u32 t[8];
    return sub8(t, a, b) == 0;
}

// t = a * b, full 512-bit product
__device__ __forceinline__ void mul_wide8(u32 t[16], const u32 a[8], const u32 b[8]) {
#pragma unroll
    for (int i = 0; i < 16; ++i) t[i] = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        u64 c = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            c += (u64)a[j] * b[i] + t[i + j];
            t[i + j] = (u32)c;
            c >>= 32;
        }
        t[i + 8] = (u32)c;
    }
}

// r = c ? a : b by masks, with no branch, so that the product or sum it
// ends shares a basic block with the next and ptxas may interleave them
__device__ __forceinline__ void sel8(u32 r[8], u32 c, const u32 a[8], const u32 b[8]) {
    const u32 m = 0u - (c != 0);
#pragma unroll
    for (int i = 0; i < 8; ++i) r[i] = (a[i] & m) | (b[i] & ~m);
}

// r = a + b mod N for canonical a, b
__device__ __forceinline__ void add_mod(u32 r[8], const u32 a[8], const u32 b[8], const u32 N[8]) {
    u32 s[8], d[8];
    u32 c = add8(s, a, b);
    u32 brw = sub8(d, s, N);
    sel8(r, c | (brw ^ 1u), d, s);
}

// r = a - b mod N for canonical a, b
__device__ __forceinline__ void sub_mod(u32 r[8], const u32 a[8], const u32 b[8], const u32 N[8]) {
    u32 d[8], n[8];
    const u32 m = 0u - sub8(d, a, b);
#pragma unroll
    for (int i = 0; i < 8; ++i) n[i] = N[i] & m;
    add8(r, d, n);
}

// r = a * b * R^-1 mod N (CIOS), np0 = -N^-1 mod 2^32. Canonical when one
// operand is < N and the other < 2^256 (the result before the last
// subtract stays < 2N, with its 2^256 bit in t[8]).
__device__ __forceinline__ void mont_mul(u32 r[8], const u32 a[8], const u32 b[8],
                                         const u32 N[8], u32 np0) {
    u32 t[10];
#pragma unroll
    for (int i = 0; i < 10; ++i) t[i] = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        u64 c = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            c += (u64)a[j] * b[i] + t[j];
            t[j] = (u32)c;
            c >>= 32;
        }
        c += t[8];
        t[8] = (u32)c;
        t[9] = (u32)(c >> 32);
        u32 m = t[0] * np0;
        c = ((u64)m * N[0] + t[0]) >> 32;
#pragma unroll
        for (int j = 1; j < 8; ++j) {
            c += (u64)m * N[j] + t[j];
            t[j - 1] = (u32)c;
            c >>= 32;
        }
        c += t[8];
        t[7] = (u32)c;
        t[8] = t[9] + (u32)(c >> 32);
    }
    u32 d[8];
    u32 brw = sub8(d, t, N);
    sel8(r, t[8] | (brw ^ 1u), d, t);
}

// 4-bit window j (0 = least significant) of a 256-bit scalar
__device__ __forceinline__ u32 digit_at(const u32 m[8], int j) {
    return (m[j >> 3] >> (4 * (j & 7))) & 15u;
}

// r = a^e for a fixed 256-bit exponent e (uniform across the warp), MSB
// first over 4-bit windows from a 16-entry table of powers. F::mul is the
// field's product and `one` its one in its domain. Zero maps to zero.
template <class F>
__device__ void pow_fixed(u32 r[8], const u32 a[8], const u32 e[8], const u32 one[8]) {
    u32 tbl[16][8];
    set8(tbl[0], one);
    set8(tbl[1], a);
    for (int k = 2; k < 16; ++k) F::mul(tbl[k], tbl[k - 1], a);
    u32 acc[8];
    set8(acc, one);
    bool started = false;
    for (int w = 63; w >= 0; --w) {
        u32 d = digit_at(e, w);
        if (started) {
            for (int k = 0; k < 4; ++k) F::mul(acc, acc, acc);
            if (d) F::mul(acc, acc, tbl[d]);
        } else if (d) {
            set8(acc, tbl[d]);
            started = true;
        }
    }
    set8(r, acc);
}
