// Modular inverses without a Fermat power: Bernstein and Yang's safegcd
// ("Fast constant-time gcd computation and modular inversion", 2019), in
// the form of libsecp256k1's src/modinv32_impl.h (secp256k1_modinv32), one
// 256-bit value per thread.
//
// Replaces the per-lane Fermat powers (~326 products each) that inverted
// r and s mod n, the Q table's Z product and Z mod p in the recover and
// verify kernels. The TPU kernel inverts through a per-block product tree
// with one Fermat power at its root (fisco_bcos_tpu/ops/pallas_verify.py
// _tree_inverse :70); one thread a lane has no block to share, and a
// divstep is a handful of 32-bit logic ops: on the H100 three inverses
// take about what half of one window power does (PERF.md).
//
// Values are 9 signed 30-bit limbs (sum v[i] 2^(30 i)); batches of 30
// divsteps run on the low limbs of f and g alone and yield a 2x2
// transition matrix, which is then applied to (f, g) and to (d, e) with
// 32x32->64 multiply-adds. The modulus (odd, below 2^256) comes as its
// limbs and m^-1 mod 2^30 (`ModInv30`): from the kernels' constant block,
// where `M::mod()` names it, so one template serves secp256k1's p and n;
// or from a launch's parameters (kernel G's inverse mode, any field).
//
// The constant-time form: 20 batches of 30 branch-free divsteps (600 >=
// 590, the bound for 256-bit inputs), the same instruction stream on every
// lane of a warp. libsecp256k1's variable-time form (`modinv_var_of`:
// divsteps that skip runs of zeros and stop at g = 0; allowed, since every
// input the kernels invert is public) was measured beside it and was no
// faster in the recover and verify kernels or at 16,384 lanes: its lanes
// take different step counts and a warp waits for its slowest. On one
// lane, where no warp waits, it is (kernel G's [16, 1] roots of the
// batched inversions, csrc/fp.cu; PERF.md). Zero maps to zero, as the
// Fermat power did.
#pragma once
#include "bigint.cuh"

#define M30 0x3FFFFFFF

struct ModInv30 {
    int32_t m[9];  // the modulus, 30-bit limbs
    u32 inv30;     // m^-1 mod 2^30
};

struct S30 {
    int32_t v[9];
};

// the 2x2 transition matrix of a batch of divsteps, scaled by 2^30
struct Trans30 {
    int32_t u, v, q, r;
};

// 8 x 32-bit words -> 9 limbs of 30 bits (limb 8: bits 240..255)
__device__ __forceinline__ void to_s30(S30 &r, const u32 a[8]) {
#pragma unroll
    for (int i = 0; i < 9; ++i) {
        const int w = 30 * i / 32, sh = 30 * i % 32;
        u32 x = a[w] >> sh;
        if (sh > 2 && w < 7) x |= a[w + 1] << (32 - sh);
        r.v[i] = (int32_t)(x & M30);
    }
}

// normalised limbs (each in [0, 2^30), the value below 2^256) -> words
__device__ __forceinline__ void from_s30(u32 r[8], const S30 &a) {
    u64 acc = 0;
    int bits = 0, w = 0;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
        acc |= (u64)(u32)a.v[i] << bits;
        bits += 30;
        if (bits >= 32 && w < 8) {
            r[w++] = (u32)acc;
            acc >>= 32;
            bits -= 32;
        }
    }
}

// 30 divsteps on the low words of f and g, branch-free
// (secp256k1_modinv32_divsteps_30); zeta = -(delta + 1/2)
__device__ __forceinline__ int32_t divsteps30(int32_t zeta, u32 f, u32 g, Trans30 &t) {
    u32 u = 1, v = 0, q = 0, r = 1;
#pragma unroll 6
    for (int i = 0; i < 30; ++i) {
        u32 c1 = (u32)(zeta >> 31);  // zeta < 0
        const u32 c2 = 0u - (g & 1u);  // g odd
        const u32 x = (f ^ c1) - c1, y = (u ^ c1) - c1, z = (v ^ c1) - c1;
        g += x & c2;
        q += y & c2;
        r += z & c2;
        c1 &= c2;
        zeta = (zeta ^ (int32_t)c1) - 1;
        f += g & c1;
        u += q & c1;
        v += r & c1;
        g >>= 1;
        u <<= 1;
        v <<= 1;
    }
    t.u = (int32_t)u;
    t.v = (int32_t)v;
    t.q = (int32_t)q;
    t.r = (int32_t)r;
    return zeta;
}

// (d, e) <- t (d, e) / 2^30 mod m, adding the multiple of m that clears
// the low 30 bits (secp256k1_modinv32_update_de_30); d, e stay in (-2m, m)
__device__ __forceinline__ void update_de30(S30 &d, S30 &e, const Trans30 &t,
                                            const ModInv30 &mi) {
    const int32_t u = t.u, v = t.v, q = t.q, r = t.r;
    const int32_t sd = d.v[8] >> 31, se = e.v[8] >> 31;
    int32_t md = (u & sd) + (v & se);
    int32_t me = (q & sd) + (r & se);
    int32_t di = d.v[0], ei = e.v[0];
    int64_t cd = (int64_t)u * di + (int64_t)v * ei;
    int64_t ce = (int64_t)q * di + (int64_t)r * ei;
    md -= (int32_t)((mi.inv30 * (u32)cd + (u32)md) & M30);
    me -= (int32_t)((mi.inv30 * (u32)ce + (u32)me) & M30);
    cd += (int64_t)mi.m[0] * md;
    ce += (int64_t)mi.m[0] * me;
    cd >>= 30;
    ce >>= 30;
#pragma unroll
    for (int i = 1; i < 9; ++i) {
        di = d.v[i];
        ei = e.v[i];
        cd += (int64_t)u * di + (int64_t)v * ei + (int64_t)mi.m[i] * md;
        ce += (int64_t)q * di + (int64_t)r * ei + (int64_t)mi.m[i] * me;
        d.v[i - 1] = (int32_t)cd & M30;
        cd >>= 30;
        e.v[i - 1] = (int32_t)ce & M30;
        ce >>= 30;
    }
    d.v[8] = (int32_t)cd;
    e.v[8] = (int32_t)ce;
}

// (f, g) <- t (f, g) / 2^30, exact (secp256k1_modinv32_update_fg_30)
__device__ __forceinline__ void update_fg30(S30 &f, S30 &g, const Trans30 &t) {
    const int32_t u = t.u, v = t.v, q = t.q, r = t.r;
    int32_t fi = f.v[0], gi = g.v[0];
    int64_t cf = (int64_t)u * fi + (int64_t)v * gi;
    int64_t cg = (int64_t)q * fi + (int64_t)r * gi;
    cf >>= 30;
    cg >>= 30;
#pragma unroll
    for (int i = 1; i < 9; ++i) {
        fi = f.v[i];
        gi = g.v[i];
        cf += (int64_t)u * fi + (int64_t)v * gi;
        cg += (int64_t)q * fi + (int64_t)r * gi;
        f.v[i - 1] = (int32_t)cf & M30;
        cf >>= 30;
        g.v[i - 1] = (int32_t)cg & M30;
        cg >>= 30;
    }
    f.v[8] = (int32_t)cf;
    g.v[8] = (int32_t)cg;
}

// d in (-2m, m) -> d * sign(f) mod m in [0, m), limbs normalised
// (secp256k1_modinv32_normalize_30)
__device__ __forceinline__ void normalize30(S30 &d, int32_t fsign, const ModInv30 &mi) {
    int32_t c = d.v[8] >> 31;
#pragma unroll
    for (int i = 0; i < 9; ++i) d.v[i] += mi.m[i] & c;
    const int32_t neg = fsign >> 31;
#pragma unroll
    for (int i = 0; i < 9; ++i) d.v[i] = (d.v[i] ^ neg) - neg;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        d.v[i + 1] += d.v[i] >> 30;
        d.v[i] &= M30;
    }
    c = d.v[8] >> 31;
#pragma unroll
    for (int i = 0; i < 9; ++i) d.v[i] += mi.m[i] & c;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        d.v[i + 1] += d.v[i] >> 30;
        d.v[i] &= M30;
    }
}

// a^-1 mod m for a < m, 0 for a = 0: 20 batches of 30 constant-time
// divsteps, the modulus `mi` read where the caller keeps it (the kernels'
// constant block through `modinv<M>`, or a launch's parameters in kernel
// G's inverse mode, csrc/fp.cu)
__device__ __forceinline__ W8 modinv_of(W8 a, const ModInv30 &mi) {
    S30 d, e, f, g;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
        d.v[i] = 0;
        e.v[i] = 0;
        f.v[i] = mi.m[i];
    }
    e.v[0] = 1;
    to_s30(g, a.w);
    int32_t zeta = -1;
#pragma unroll 1
    for (int i = 0; i < 20; ++i) {
        Trans30 t;
        zeta = divsteps30(zeta, (u32)f.v[0], (u32)g.v[0], t);
        update_de30(d, e, t, mi);
        update_fg30(f, g, t);
    }
    // g = 0 and f = +-1 (+-gcd); d = +-a^-1
    normalize30(d, f.v[8], mi);
    W8 r;
    from_s30(r.w, d);
    return r;
}

// modinv_of over the modulus M::mod() names, one out-of-line copy a modulus
template <class M>
__device__ __noinline__ W8 modinv(W8 a) {
    return modinv_of(a, M::mod());
}

// libsecp256k1's variable-time divsteps (secp256k1_modinv32_divsteps_30_var),
// eta = -delta: a run of zeros of g at once, then up to 8 low bits of g
// cancelled by a multiple of f
__device__ __forceinline__ int32_t divsteps30_var(int32_t eta, u32 f, u32 g, Trans30 &t) {
    u32 u = 1, v = 0, q = 0, r = 1;
    int i = 30;
    for (;;) {
        const int zeros = __ffs(g | (0xFFFFFFFFu << i)) - 1;  // i bounds the count
        g >>= zeros;
        u <<= zeros;
        v <<= zeros;
        eta -= zeros;
        i -= zeros;
        if (i == 0) break;
        if (eta < 0) {
            u32 x;
            eta = -eta;
            x = f, f = g, g = 0u - x;
            x = u, u = q, q = 0u - x;
            x = v, v = r, r = 0u - x;
        }
        const int limit = (eta + 1) > i ? i : (eta + 1);
        const u32 m = (0xFFFFFFFFu >> (32 - limit)) & 255u;
        // f^-1 mod 2^12 by two Newton steps (f odd, so f f = 1 mod 8), in
        // place of libsecp256k1's table of inverses mod 256
        u32 fi = f;
        fi *= 2u - f * fi;
        fi *= 2u - f * fi;
        const u32 w = (0u - g * fi) & m;
        g += f * w;
        q += u * w;
        r += v * w;
    }
    t.u = (int32_t)u;
    t.v = (int32_t)v;
    t.q = (int32_t)q;
    t.r = (int32_t)r;
    return eta;
}

// a^-1 mod m for a < m, 0 for a = 0, in variable time: batches of 30
// divsteps until g = 0 (secp256k1_modinv32_var at full length; at most 25
// batches, since 724 divsteps bound a 256-bit input of this divstep)
__device__ __forceinline__ W8 modinv_var_of(W8 a, const ModInv30 &mi) {
    S30 d, e, f, g;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
        d.v[i] = 0;
        e.v[i] = 0;
        f.v[i] = mi.m[i];
    }
    e.v[0] = 1;
    to_s30(g, a.w);
    int32_t eta = -1;
#pragma unroll 1
    for (int it = 0; it < 25; ++it) {
        int32_t live = 0;
#pragma unroll
        for (int i = 0; i < 9; ++i) live |= g.v[i];
        if (!live) break;
        Trans30 t;
        eta = divsteps30_var(eta, (u32)f.v[0], (u32)g.v[0], t);
        update_de30(d, e, t, mi);
        update_fg30(f, g, t);
    }
    normalize30(d, f.v[8], mi);
    W8 r;
    from_s30(r.w, d);
    return r;
}
