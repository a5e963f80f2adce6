"""The port's CUDA arithmetic (csrc/bigint.cuh, sm2.cuh, field.cuh,
point.cuh, modinv.cuh, ec.cuh, ecdsa.cuh, pow.cuh), the varlen Keccak and
SM3 kernels' steps (keccak.cuh, sm3.cuh, lenorder.cuh) and the Merkle tree
kernels' schedule and node hashes (merkle.cuh) compiled for the host with
g++ and held to Python integers, to the plain PyTorch point formulas of
ops/ec, to the pure-Python oracle, to the host Merkle levels and to the
JAX package's tree, on seeded operands and on carry-extreme ones.

The device code is plain C++ behind `__device__`: with empty
`__device__`, `__host__`, `__forceinline__`, `__noinline__` and
`__constant__`, and a host build runs the code the card runs. The constant blocks are filled from
ops/consts.kernel_words(), as ops/_cuda.library fills them on the card.

Tolerance: bit-exact (integer arithmetic). Skips only where g++ is absent.
"""

import functools
import random
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from fisco_bcos_tpu.ops import merkle as jmerkle
from fisco_bcos_tpu_torch.crypto import refimpl
from fisco_bcos_tpu_torch.ops import bigint, cuda_fp, ec, fp, merkle
from fisco_bcos_tpu_torch.ops.consts import derive_consts, kernel_words
from fisco_bcos_tpu_torch.zk import poseidon
import test_torch_vectors as vectors  # tests/ is on sys.path under pytest

CSRC = Path(__file__).resolve().parent.parent / "fisco_bcos_tpu_torch" / "csrc"
S, C = refimpl.SM2P256V1, refimpl.SECP256K1
R = 1 << 256

HARNESS = r"""
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __constant__
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <iostream>
#include <string>
#include <array>
#include <vector>
#include <algorithm>
#include <utility>
// lenorder.cuh's ranks and merkle.cuh's arrivals: one thread at a time
// here, so a plain add; a thread's stores are seen by the next at once
static int atomicAdd(int *p, int v) { int o = *p; *p += v; return o; }
static int __ffs(unsigned x) { return __builtin_ffs((int)x); }
static void __threadfence() {}
static void __syncwarp(unsigned = 0xFFFFFFFFu) {}
template <class T>
static T __shfl_sync(unsigned, T v, int) { return v; }
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
static uint2 make_uint2(unsigned x, unsigned y) { return uint2{x, y}; }
static uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) { return uint4{x, y, z, w}; }
#include "ecdsa.cuh"
#include "sm2.cuh"
#include "pow.cuh"
#include "keccak.cuh"
#include "lenorder.cuh"
#include "merkle.cuh"

static u32 SG[2 * TBL * 16];  // the G and phi(G) tables, as stage_tables lays them out

static u32 rdw() { std::string h; std::cin >> h; return (u32)strtoul(h.c_str(), 0, 16); }
// FieldArg from ops/cuda_fp._field_words: n[0..7], np0, solinas
static FieldArg rd_field() {
    FieldArg f;
    for (int i = 0; i < 8; ++i) f.n[i] = rdw();
    f.np0 = rdw();
    f.solinas = rdw();
    return f;
}

// a 256-bit value as 64 hex digits, most significant first
static void rd(u32 w[8]) {
    std::string h;
    std::cin >> h;
    for (int i = 0; i < 8; ++i) w[i] = (u32)strtoul(h.substr(56 - 8 * i, 8).c_str(), 0, 16);
}
static void wr(const u32 *w, int n) {
    for (int i = n - 1; i >= 0; --i) printf("%08x", w[i]);
}
static void rd_jac(Jac &P) { rd(P.X); rd(P.Y); rd(P.Z); }
static void wr_jac(const Jac &P) {
    wr(P.X, 8); printf(" "); wr(P.Y, 8); printf(" "); wr(P.Z, 8);
}

// A varlen kernel's length-ordered schedule on the host (keccak.cu,
// sm3.cu), block by block, through the kernel's own steps (lenorder.cuh)
// in the order lo_run takes them on the card: each step for every thread
// of the block before the next (lo_run's barriers), then the groups of 32 slots in the order the
// warps take them, each slot hashed by rows(msg, nv). A block of T threads
// owns `msgs` of at most M messages, as the launch sets. Exits non-zero if
// a message is not in exactly one slot or the slots are out of length
// order.
template <int M, int T, class Rows>
static void lenorder_launch(const int32_t *nvalid, int B, int nblocks, int msgs, Rows rows) {
    const int K = M / T;
    static LenOrder<M> so;
    for (int base = 0; base < B; base += msgs) {
        std::vector<std::array<int, K>> nv(T), rank(T);
        std::vector<int> seen(M, 0);
        bool same = true;
        for (int t = 0; t < T; ++t)
            same = lo_load<M, T>(so, nv[t].data(), nvalid, t, base, B, nblocks, msgs) && same;
        for (int t = 0; t < T; ++t)
            lo_rank<M, T>(so, nv[t].data(), rank[t].data(), same, t, base, B, msgs);
        if (!same) {
            for (int t = 0; t < T; ++t) lo_scan_bins<M, T>(so, t, nblocks);
            for (int t = 0; t < T; ++t)
                lo_place_msgs<M, T>(so, nv[t].data(), rank[t].data(), t, base, B, msgs);
        }
        for (int i = 0; i < msgs; ++i) {
            if (so.msg[i] >= 0) seen[so.msg[i] - base] += 1;
            if (i > 0 && lo_bin<M>(so.nv[i]) < lo_bin<M>(so.nv[i - 1])) {
                fprintf(stderr, "slot %d out of length order\n", i);
                exit(2);
            }
        }
        for (int i = 0; i < msgs && base + i < B; ++i) {
            if (seen[i] != 1) { fprintf(stderr, "message %d in %d slots\n", base + i, seen[i]); exit(2); }
        }
        for (int q = 0;; ++q) {
            const int g = lo_group_slot(q, msgs);
            if (g < 0) break;
            for (int lane = 0; lane < 32; ++lane) rows(so.msg[g + lane], so.nv[g + lane]);
        }
    }
}

// keccak256_varlen_kernel (keccak.cu): lo_block_msgs of M, each slot by
// keccak.cuh's keccak256_rows
template <int M, int T>
static void keccak_launch(const uint8_t *blocks, const int32_t *nvalid, uint8_t *out, int B,
                          int nblocks) {
    lenorder_launch<M, T>(nvalid, B, nblocks, lo_block_msgs(M, T, nblocks), [&](int msg, int n) {
        keccak256_rows((const uint64_t *)blocks, (uint64_t *)out, msg, n, nblocks);
    });
}

// sm3_varlen_kernel (sm3.cu): a block of T threads owns and sorts `msgs`
// messages (the kernel's sm3_block_msgs where M and T are its own), or, at
// msgs = 0, each thread hashes one message in arrival order; each message
// by sm3.cuh's sm3_rows
template <int M, int T>
static void sm3_launch(const uint8_t *blocks, const int32_t *nvalid, uint8_t *out, int B,
                       int nblocks, int msgs) {
    auto rows = [&](int msg, int n) {
        sm3_rows((const uint4 *)blocks, (uint4 *)out, msg, n, nblocks);
    };
    if (msgs == 0) {
        for (int i = 0; i < B; ++i) rows(i, lo_nv(nvalid, i, B, nblocks));
        return;
    }
    lenorder_launch<M, T>(nvalid, B, nblocks, msgs, rows);
}

// The warp node hashes of the tree kernels (merkle.cuh), lane by lane in
// the kernel's order. Keccak: each of a round's two stages for all 32
// lanes before the next, a lane's get(src) reading lane src's value of the
// stage before (the kernel's __shfl_sync); SM3: lanes 0-7 expand, then
// lane 0's rounds.
struct KeccakWarp {
    static void hash(uint8_t *out, const uint8_t *src8, int live) {
        const uint64_t *src = (const uint64_t *)src8;
        uint64_t A[32], R[32], nx[32];
        K25Lane l[32];
        for (int t = 0; t < 32; ++t) {
            l[t] = k25_lane(t);
            A[t] = 0;
            nx[t] = k25_word(src, live, t, 0);
        }
        for (int b = 0; b < 4; ++b) {
            for (int t = 0; t < 32; ++t) {
                A[t] ^= nx[t];
                if (b < 3) nx[t] = k25_word(src, live, t, b + 1);
            }
            for (int r = 0; r < 24; ++r) {
                for (int t = 0; t < 32; ++t)
                    R[t] = k25_theta_rho(A[t], l[t], [&](int s) { return A[s]; });
                for (int t = 0; t < 32; ++t)
                    A[t] = k25_pi_chi(l[t], [&](int s) { return R[s]; }, KECCAK_RC[r]);
            }
        }
        for (int t = 0; t < 4; ++t) ((uint64_t *)out)[t] = A[t];
    }
};
struct Sm3Warp {
    static void hash(uint8_t *out, const uint8_t *src, int live) {
        static S8Shared m;
        for (int k = 0; k < 8; ++k) s8_expand(m, (const uint4 *)src, live, k);
        s8_rounds((uint4 *)out, m);
    }
};

// A tree kernel on the host (merkle.cuh merkle_tree), warp by warp: a
// warp's first step hashes its 16 nodes of level 1 one a lane (merkle_leaf
// with the hash's one-thread form H), then, as each step after it, a node
// with the warp form G, stores it and counts its arrival (merkle_arrive).
// order 0 runs warp 0's steps to its end, then warp 1's, ...; order 1 the
// warps in reverse; order 2 takes each next step at random (xorshift64 of
// `seed`) among the pending ones, so the warps' steps interleave. -> the
// nodes hashed, the root into root[32].
template <class H, class G>
static long merkle_launch(const uint8_t *leaves, int rows, int n, int order, uint64_t seed,
                          uint8_t *root) {
    const MerkleShape s = merkle_shape(n, rows);
    std::vector<int32_t> scratch(merkle_scratch_words(s) + 4, 0);  // counters zeroed
    int *arrivals = scratch.data();
    uint8_t *nodes = (uint8_t *)(scratch.data() + merkle_counter_words(s));
    long hashes = 0;
    auto step = [&](int L, int p) -> int {
        if (L == 2)
            for (int t = 0; t < MERKLE_WIDTH; ++t)
                if (MERKLE_WIDTH * p + t < s.count[1]) {
                    merkle_leaf<H>(s, leaves, nodes, root, MERKLE_WIDTH * p + t);
                    ++hashes;
                }
        G::hash(merkle_out(s, nodes, root, L, p), merkle_children(s, leaves, nodes, L, p),
                merkle_live(s, L, p));
        ++hashes;
        if (L == s.levels) return -1;
        return merkle_arrive(s, arrivals, L, p) ? p / MERKLE_WIDTH : -1;
    };
    std::vector<std::pair<int, int>> pending;  // (level, node) of each warp's next step
    if (s.levels == 1) pending.push_back({1, 0});
    for (int w = 0; s.levels > 1 && w < s.count[2]; ++w) pending.push_back({2, w});
    if (order == 1) std::reverse(pending.begin(), pending.end());
    if (order < 2) {
        for (auto [L, p] : pending)
            for (; p >= 0; ++L) p = step(L, p);
        return hashes;
    }
    uint64_t x = seed;
    while (!pending.empty()) {
        x ^= x << 13;
        x ^= x >> 7;
        x ^= x << 17;
        const size_t k = x % pending.size();
        const auto [L, p] = pending[k];
        pending[k] = pending.back();
        pending.pop_back();
        const int q = step(L, p);
        if (q >= 0) pending.push_back({L + 1, q});
    }
    return hashes;
}

int main() {
    std::string op;
    int n;
    std::cin >> op >> n;  // the "verify" words, then the "sm2" words
    u32 w[256];
    for (int i = 0; i < n; ++i) { std::string h; std::cin >> h; w[i] = (u32)strtoul(h.c_str(), 0, 16); }
    memcpy(&SC, w, sizeof(SecpConsts));
    std::cin >> op >> n;
    for (int i = 0; i < n; ++i) { std::string h; std::cin >> h; w[i] = (u32)strtoul(h.c_str(), 0, 16); }
    memcpy(&S2, w, sizeof(Sm2Consts));
    std::cin >> op >> n;  // the "keccak" words: the round constants
    for (int i = 0; i < n; ++i) { std::string h; std::cin >> h; w[i] = (u32)strtoul(h.c_str(), 0, 16); }
    memcpy(KECCAK_RC, w, sizeof(KECCAK_RC));
    std::cin >> op >> n;  // the "sm3" words, then the "sm3_pad" words
    for (int i = 0; i < n; ++i) { std::string h; std::cin >> h; w[i] = (u32)strtoul(h.c_str(), 0, 16); }
    memcpy(&SM3K, w, sizeof(SM3K));
    std::cin >> op >> n;
    for (int i = 0; i < n; ++i) { std::string h; std::cin >> h; w[i] = (u32)strtoul(h.c_str(), 0, 16); }
    memcpy(&SM3PAD, w, sizeof(SM3PAD));
    while (std::cin >> op) {
        u32 a[8], b[8], r[8], t[16];
        Jac P, Q, Rj;
        if (op == "wide") {
            rd(a); rd(b); mul_wide8(t, a, b); wr(t, 16);
        } else if (op == "inv_p" || op == "inv_n" || op == "sqrt") {
            W8 x, y;
            rd(x.w);
            if (op == "inv_p") y = modinv<ModP>(x);
            else if (op == "inv_n") y = modinv<ModN>(x);
            else y = fp_sqrt(x);
            wr(y.w, 8);
        } else if (op == "powinv" || op == "powinvvar") {  // kernel G's inverse mode: field, InvArg words, a
            FieldArg f = rd_field();
            InvArg v;
            for (int i = 0; i < 9; ++i) v.mi.m[i] = (int32_t)rdw();
            v.mi.inv30 = rdw();
            for (int i = 0; i < 8; ++i) v.r3[i] = rdw();
            W8 x;
            rd(x.w);
            W8 y = op == "powinv" ? pow_inverse<false>(x, f, v) : pow_inverse<true>(x, f, v);
            wr(y.w, 8);
        } else if (op == "powwin") {  // the window mode: field, one, digits (hex, MSB first), a
            FieldArg f = rd_field();
            PowArg e;
            rd(e.one);
            std::string d;
            std::cin >> d;
            e.nd = (int)d.size();
            for (int i = 0; i < e.nd; ++i) e.d[i] = (unsigned char)strtoul(d.substr(i, 1).c_str(), 0, 16);
            W8 x;
            rd(x.w);
            W8 y = pow_window_field(x, e, f);
            wr(y.w, 8);
        } else if (op == "keccak") {  // M B nblocks, nvalid[B], the blocks as hex -> B digests
            int M, B, nb;
            std::cin >> M >> B >> nb;
            std::vector<int32_t> nv(B);
            for (auto &x : nv) std::cin >> x;
            std::string h;
            std::cin >> h;
            std::vector<uint8_t> blk((size_t)B * nb * 136 + 8), dg((size_t)B * 32);
            for (size_t i = 0; i < (size_t)B * nb * 136; ++i)
                blk[i] = (uint8_t)strtoul(h.substr(2 * i, 2).c_str(), 0, 16);
            if (M == 512) keccak_launch<512, 256>(blk.data(), nv.data(), dg.data(), B, nb);
            else keccak_launch<64, 32>(blk.data(), nv.data(), dg.data(), B, nb);
            for (int i = 0; i < B; ++i) {
                if (i) printf(" ");
                for (int k = 0; k < 32; ++k) printf("%02x", dg[(size_t)i * 32 + k]);
            }
        } else if (op == "sm3") {  // M B nblocks, nvalid[B], the blocks as hex -> B digests
            // M = 0: the kernel's own shape (SM3_VARLEN_MSGS, SM3_VARLEN_THREADS,
            // sm3_block_msgs); else M messages sorted in a block of 32 threads
            int M, B, nb;
            std::cin >> M >> B >> nb;
            std::vector<int32_t> nv(B);
            for (auto &x : nv) std::cin >> x;
            std::string h;
            std::cin >> h;
            std::vector<uint8_t> blk((size_t)B * nb * 64 + 16), dg((size_t)B * 32);
            for (size_t i = 0; i < (size_t)B * nb * 64; ++i)
                blk[i] = (uint8_t)strtoul(h.substr(2 * i, 2).c_str(), 0, 16);
            if (M == 0)
                sm3_launch<SM3_VARLEN_MSGS, SM3_VARLEN_THREADS>(blk.data(), nv.data(), dg.data(),
                                                                B, nb, sm3_block_msgs(nb));
            else sm3_launch<64, 32>(blk.data(), nv.data(), dg.data(), B, nb, 64);
            for (int i = 0; i < B; ++i) {
                if (i) printf(" ");
                for (int k = 0; k < 32; ++k) printf("%02x", dg[(size_t)i * 32 + k]);
            }
        } else if (op == "merkle") {  // alg n rows order seed, the leaf rows as hex
            std::string alg;
            int nn, rows, order;
            unsigned long long seed;
            std::string h;
            std::cin >> alg >> nn >> rows >> order >> seed >> h;
            std::vector<uint8_t> lv((size_t)rows * 32 + 16);
            for (size_t i = 0; i < (size_t)rows * 32; ++i)
                lv[i] = (uint8_t)strtoul(h.substr(2 * i, 2).c_str(), 0, 16);
            uint8_t root[32];
            const long hashes =
                alg == "keccak256"
                    ? merkle_launch<KeccakTree, KeccakWarp>(lv.data(), rows, nn, order, seed, root)
                    : merkle_launch<Sm3Tree, Sm3Warp>(lv.data(), rows, nn, order, seed, root);
            printf("%lx %x ", hashes, merkle_scratch_words(merkle_shape(nn, rows)));
            for (int k = 0; k < 32; ++k) printf("%02x", root[k]);
        } else if (op == "qtab") {  // q_table's Z product and its inverse, then the table
            u32 tx[TBL][8], ty[TBL][8], z[8];
            rd(a); rd(b);
            Jac Pq;
            set8(Pq.X, a); set8(Pq.Y, b); SecpFp::one(Pq.Z);
            set8(z, Pq.Z);
            jac_double<SecpFp>(Pq, Pq);
            for (int k = 2; k < TBL; ++k) {
                if (k > 2) jac_madd<SecpFp>(Pq, Pq, a, b);
                SecpFp::mul(z, z, Pq.Z);
            }
            SecpFp::inv(r, z);
            wr(z, 8); printf(" "); wr(r, 8);
            q_table<SecpFp>(tx, ty, a, b);
            for (int k = 1; k < TBL; ++k) { printf(" "); wr(tx[k], 8); printf(" "); wr(ty[k], 8); }
        } else if (op == "gtab") {
            for (int i = 0; i < 2 * TBL * 16; ++i) { std::string h; std::cin >> h; SG[i] = (u32)strtoul(h.c_str(), 0, 16); }
            printf("0");
        } else if (op == "recover") {
            u32 e[8], rr[8], ss[8], qx[8], qy[8], v;
            rd(e); rd(rr); rd(ss); std::cin >> v;
            bool ok = recover_one(qx, qy, e, rr, ss, v, SG);
            printf("%d ", ok ? 1 : 0); wr(qx, 8); printf(" "); wr(qy, 8);
        } else if (op == "verify") {
            u32 e[8], rr[8], ss[8], qx[8], qy[8];
            rd(e); rd(rr); rd(ss); rd(qx); rd(qy);
            printf("%d", verify_one(e, rr, ss, qx, qy, SG) ? 1 : 0);
        } else if (op == "sm2mul") {
            rd(a); rd(b); Sm2Fp::mul(r, a, b); wr(r, 8);
        } else if (op == "secpmul") {
            rd(a); rd(b); SecpFp::mul(r, a, b); wr(r, 8);
        } else if (op == "sm2dbl") {
            rd_jac(P); jac_double<Sm2Fp>(Rj, P); wr_jac(Rj);
        } else if (op == "sm2madd") {
            rd_jac(P); rd(a); rd(b); jac_madd<Sm2Fp>(Rj, P, a, b); wr_jac(Rj);
        } else if (op == "sm2add") {
            rd_jac(P); rd_jac(Q); jac_add<Sm2Fp>(Rj, P, Q); wr_jac(Rj);
        } else {
            fprintf(stderr, "unknown op %s\n", op.c_str());
            return 1;
        }
        printf("\n");
    }
    return 0;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the device code for the host")
    d = tmp_path_factory.mktemp("csrc_host")
    (d / "harness.cpp").write_text(HARNESS)
    exe = d / "harness"
    subprocess.run([gxx, "-std=c++20", "-O1", "-I", str(CSRC), "-o", str(exe),
                    str(d / "harness.cpp"), "-lpthread"], check=True, capture_output=True,
                   timeout=600)
    words = kernel_words(derive_consts())
    head = " ".join(f"{k} {len(words[k])} " + " ".join(f"{x:08x}" for x in words[k])
                    for k in ("verify", "sm2", "keccak", "sm3", "sm3_pad"))

    def run(lines: list[str]) -> list[list[int]]:
        out = subprocess.run([str(exe)], input=head + "\n" + "\n".join(lines) + "\n",
                             capture_output=True, text=True, check=True, timeout=600).stdout
        return [[int(v, 16) for v in line.split()] for line in out.splitlines()]

    return run


def _h(*xs: int) -> str:
    return " ".join(f"{x:064x}" for x in xs)


def _extremes(p: int) -> list[int]:
    """Canonical operands at the carry edges: 0, 1, 2, p - 1, p - 2,
    R mod p, R^2 mod p, and words of 0xFFFFFFFF (2^32k - 1 below p, p - 2^32,
    the all-ones low half)."""
    xs = [0, 1, 2, p - 1, p - 2, R % p, R * R % p, p - (1 << 32), (1 << 255) - 1, 1 << 255]
    xs += [(1 << (32 * k)) - 1 for k in (1, 2, 4, 7)]
    xs += [((1 << 32) - 1) << 192, ((1 << 128) - 1) << 64]
    return [x for x in xs if x < p]


def _operand_pairs(p: int, seed: int) -> list[tuple[int, int]]:
    rng = random.Random(seed)
    ext = _extremes(p)
    pairs = [(a, b) for a in ext for b in ext]
    pairs += [(rng.randrange(p), rng.randrange(p)) for _ in range(256)]
    pairs += [(rng.randrange(p), x) for x in ext for _ in range(4)]
    return pairs


def test_mul_wide8_is_the_full_product(harness):
    rng = random.Random(11)
    ext = [0, 1, R - 1, (1 << 255), (1 << 224) - 1, R - (1 << 32)]
    pairs = [(a, b) for a in ext for b in ext]
    pairs += [(rng.getrandbits(256), rng.getrandbits(256)) for _ in range(256)]
    got = harness([f"wide {_h(a, b)}" for a, b in pairs])
    assert [g[0] for g in got] == [a * b for a, b in pairs]


@pytest.mark.parametrize("field", ["sm2", "secp256k1"])
def test_field_mul_matches_python(harness, field):
    """Sm2Fp::mul is a b R^-1 mod p (the special-form Montgomery product,
    canonical); SecpFp::mul is a b mod p (the Solinas fold)."""
    if field == "sm2":
        p, op, rinv = S.p, "sm2mul", pow(R, -1, S.p)
    else:
        p, op, rinv = C.p, "secpmul", 1
    pairs = _operand_pairs(p, seed=5 if field == "sm2" else 6)
    # one operand canonical, the other anywhere below 2^256 (to_rep's case)
    rng = random.Random(7)
    pairs += [(rng.randrange(p), x) for x in (R - 1, R - p, p, p + 1, R - (1 << 32))]
    got = harness([f"{op} {_h(a, b)}" for a, b in pairs])
    want = [a * b * rinv % p for a, b in pairs]
    bad = [(hex(a), hex(b)) for (a, b), g, w in zip(pairs, got, want) if g[0] != w]
    assert not bad, f"{len(bad)} of {len(pairs)} products differ, first {bad[:3]}"


def _rep(cv, xs) -> torch.Tensor:
    return cv.fp.to_rep(torch.as_tensor(bigint.batch_to_limbs(xs).astype(np.int64)).T)


def _ints(t: torch.Tensor) -> list[int]:
    a = t.numpy()
    return [bigint.from_limbs(a[:, i]) for i in range(a.shape[1])]


def _sm2_points(rng, n: int):
    """n on-curve affine points and random nonzero Z: (x, y, z) ints."""
    out = []
    for _ in range(n):
        P = refimpl.ec_mul(S, rng.randrange(1, S.n), (S.gx, S.gy))
        out.append((P[0], P[1], rng.randrange(1, S.p)))
    return out


def _jac(pts, cv):
    """affine (x, y) and z -> packed Jacobian field rep [3, 16, B] of
    (x z^2, y z^3, z), z = 0 giving (x, y, 0)."""
    p = cv.params.p
    X = [x * z * z % p if z else x for x, y, z in pts]
    Y = [y * z ** 3 % p if z else y for x, y, z in pts]
    return torch.stack([_rep(cv, X), _rep(cv, Y), _rep(cv, [z for _, _, z in pts])])


def _words_of(P: torch.Tensor) -> list[tuple[int, int, int]]:
    X, Y, Z = (_ints(P[i]) for i in range(3))
    return list(zip(X, Y, Z))


@pytest.mark.parametrize("op", ["double", "madd", "add"])
def test_sm2_point_ops_match_plain(harness, op):
    """jac_double / jac_madd / jac_add over Sm2Fp against ops/ec's
    jac_double / jac_add_affine / jac_add on the same field-rep words,
    every branch: the common path, P at infinity, Q at infinity, P == Q
    (doubling), P == -Q (infinity)."""
    cv = ec.SM2P256V1
    rng = random.Random(23)
    pts = _sm2_points(rng, 24)
    qs = _sm2_points(rng, 24)
    # edges: P = inf; P == Q (same affine point, other Z); P == -Q
    qs[0] = pts[0]
    qs[1] = (pts[1][0], pts[1][1], rng.randrange(1, S.p))
    qs[2] = (pts[2][0], S.p - pts[2][1], rng.randrange(1, S.p))
    pts[3] = (pts[3][0], pts[3][1], 0)
    qs[4] = (qs[4][0], qs[4][1], 0)
    P = _jac(pts, cv)
    if op == "double":
        want = ec.jac_double(cv, P)
        lines = [f"sm2dbl {_h(*w)}" for w in _words_of(P)]
    elif op == "madd":
        qs = [(x, y, 1) for x, y, _ in qs]
        qx, qy = _rep(cv, [q[0] for q in qs]), _rep(cv, [q[1] for q in qs])
        want = ec.jac_add_affine(cv, P, qx, qy)
        lines = [f"sm2madd {_h(*w)} {_h(x, y)}"
                 for w, x, y in zip(_words_of(P), _ints(qx), _ints(qy))]
    else:
        Q = _jac(qs, cv)
        want = ec.jac_add(cv, P, Q)
        lines = [f"sm2add {_h(*w)} {_h(*v)}" for w, v in zip(_words_of(P), _words_of(Q))]
    got = [tuple(g) for g in harness(lines)]
    assert got == _words_of(want)



# -- the safegcd inverse (modinv.cuh) and the square-root chain (ec.cuh) ----

MODULI = {"p": C.p, "n": C.n}
# inputs below the modulus m at the edges of the 30-bit limbs and the
# 32-bit words, by name
EDGE_INPUTS = {
    "zero": lambda m: 0, "one": lambda m: 1, "two": lambda m: 2,
    "m-1": lambda m: m - 1, "m-2": lambda m: m - 2,
    **{f"2^{k}": (lambda k: lambda m: 1 << k)(k) for k in (29, 30, 31, 32, 60, 128, 240, 255)},
    **{f"m-2^{k}": (lambda k: lambda m: m - (1 << k))(k) for k in (30, 32, 128, 255)},
    "R mod m": lambda m: R % m, "R^2 mod m": lambda m: R * R % m,
    "words ffffffff": lambda m: (R - 1) % m,
    "words ffffffff 00000000": lambda m: int("ffffffff00000000" * 4, 16) % m,
    "words 00000000 ffffffff": lambda m: int("00000000ffffffff" * 4, 16) % m,
    "low 30-bit limbs full": lambda m: (1 << 240) - 1,
    "30-bit limbs alternate": lambda m: sum(((1 << 30) - 1) << (60 * i) for i in range(4)),
}
SEEDED_INPUTS = 8
INPUT_IDS = list(EDGE_INPUTS) + [f"seeded {i}" for i in range(SEEDED_INPUTS)]


def _inputs(m: int) -> dict[str, int]:
    xs = {name: f(m) for name, f in EDGE_INPUTS.items()}
    rng = random.Random(m % 1000)
    xs.update({f"seeded {i}": rng.randrange(m) for i in range(SEEDED_INPUTS)})
    assert all(0 <= x < m for x in xs.values()), xs
    return xs


@pytest.fixture(scope="module")
def unary_results(harness):
    """(op, input name) -> the harness's result, one run for all."""
    keys, lines = [], []
    for op, m in (("inv_p", C.p), ("inv_n", C.n), ("sqrt", C.p)):
        for name, x in _inputs(m).items():
            keys.append((op, name))
            lines.append(f"{op} {_h(x)}")
    return {k: g[0] for k, g in zip(keys, harness(lines))}


@pytest.mark.parametrize("name", INPUT_IDS)
@pytest.mark.parametrize("modulus", ["p", "n"])
def test_safegcd_inverse_matches_python(unary_results, modulus, name):
    """modinv over secp256k1's p and n: x^-1 mod m as Python's
    pow(x, -1, m), and 0 for 0."""
    m = MODULI[modulus]
    x = _inputs(m)[name]
    assert unary_results["inv_" + modulus, name] == (pow(x, -1, m) if x else 0)


@pytest.mark.parametrize("name", INPUT_IDS)
def test_sqrt_chain_matches_python(unary_results, name):
    """fp_sqrt: x^((p+1)/4) mod p as Python's pow, square or not."""
    x = _inputs(C.p)[name]
    assert unary_results["sqrt", name] == pow(x, (C.p + 1) // 4, C.p)


# -- kernel G's modes (pow.cuh): the inverse over a modulus passed at
# launch, with the Montgomery fix-up, and the window loop it replaces --

POW_FIELDS = {"secp256k1_p": fp.SolinasField(C.p), "secp256k1_n": fp.MontField(C.n),
              "sm2_p": fp.MontField(S.p), "sm2_n": fp.MontField(S.n),
              "bn254_r": fp.MontField(poseidon.P)}
# values in the field's domain (what the kernel reads), by name; the loose
# ones lie in [m, 2^256), which the Solinas field's window loop takes
POW_INPUTS = {
    "zero": lambda m: 0, "one": lambda m: 1, "m-1": lambda m: m - 1, "m-2": lambda m: m - 2,
    "R mod m": lambda m: R % m, "R^2 mod m": lambda m: R * R % m,
    **{f"seeded {i}": (lambda i: lambda m: random.Random(m % 997 + i).randrange(m))(i)
       for i in range(6)},
    "loose m": lambda m: m, "loose m+1": lambda m: m + 1, "loose 2^256-1": lambda m: R - 1,
    **{f"loose seeded {i}": (lambda i: lambda m: random.Random(m % 991 + i).randrange(m, R))(i)
       for i in range(3)},
}


def _field_line(f) -> str:
    return " ".join(f"{int(x):08x}" for x in cuda_fp._field_words(f))


def _word_int(words) -> int:
    return sum(int(x) << (32 * i) for i, x in enumerate(words))


def _powwin_line(f, e: int, x: int) -> str:
    digits = "".join(f"{int(d):x}" for d in fp.msb_digits(e, 4))
    one = _word_int(cuda_fp._words(f.encode_int(1)))
    return f"powwin {_field_line(f)} {_h(one)} {digits} {_h(x)}"


def _pow_want(f, x: int, e: int) -> int:
    """x^e in the field's domain (x a domain value, maybe loose), canonical."""
    m = f.n_int
    r = 1 if getattr(f, "c_int", None) is not None else R % m
    v = x % m * pow(r, -1, m) % m
    return pow(v, e, m) * r % m


@pytest.fixture(scope="module")
def pow_results(harness):
    """(field, input name) -> (inverse mode, window loop at m - 2, window
    loop at (p+1)/4 for secp256k1's p, square-root chain), one run."""
    keys, lines = [], []
    for name, f in POW_FIELDS.items():
        m = f.n_int
        inv = " ".join(f"{int(x):08x}" for x in cuda_fp._inv_words(f))
        for xname, g in POW_INPUTS.items():
            x = g(m)
            for op, form in (("powinv", "inverse"), ("powinvvar", "inverse var")):
                keys.append((name, xname, form))
                lines.append(f"{op} {_field_line(f)} {inv} {_h(x)}")
            keys.append((name, xname, "window m-2"))
            lines.append(_powwin_line(f, m - 2, x))
            if name == "secp256k1_p":
                keys.append((name, xname, "window sqrt"))
                lines.append(_powwin_line(f, (m + 1) // 4, x))
                keys.append((name, xname, "sqrt"))
                lines.append(f"sqrt {_h(x)}")
    return {k: g[0] for k, g in zip(keys, harness(lines))}


@pytest.mark.parametrize("form", ["inverse", "inverse var"])
@pytest.mark.parametrize("xname", list(POW_INPUTS))
@pytest.mark.parametrize("field", list(POW_FIELDS))
def test_pow_inverse_mode_matches_python(pow_results, field, xname, form):
    """pow_inverse, constant-time and variable-time (the one-lane form),
    with the modulus's ModInv30 words and R^3 mod m from
    cuda_fp._inv_words (as the launch passes them): Python's
    pow(x, m - 2, m) in the field's domain, loose inputs reduced first; and,
    on canonical inputs, the limbs of the window loop at m - 2."""
    f = POW_FIELDS[field]
    m = f.n_int
    x = POW_INPUTS[xname](m)
    got = pow_results[field, xname, form]
    assert got == _pow_want(f, x, m - 2)
    if x < m or field == "secp256k1_p":
        assert got == pow_results[field, xname, "window m-2"]


@pytest.mark.parametrize("xname", list(POW_INPUTS))
def test_pow_sqrt_mode_matches_window_loop(pow_results, xname):
    """fp_sqrt, the square-root mode, returns the limbs of the window
    loop at (p+1)/4 on secp256k1's p, loose inputs included, and both are
    Python's pow."""
    f = POW_FIELDS["secp256k1_p"]
    x = POW_INPUTS[xname](f.n_int)
    got = pow_results["secp256k1_p", xname, "sqrt"]
    assert got == pow_results["secp256k1_p", xname, "window sqrt"]
    assert got == _pow_want(f, x, (f.n_int + 1) // 4)


@pytest.mark.parametrize("field", list(POW_FIELDS))
def test_pow_window_mode_generic_exponents(harness, field):
    """The window loop (the mode of every other exponent) at 65,537, a
    seeded 256-bit exponent and 1 against Python's pow, on seeded
    canonical inputs with 0, 1 and m - 1."""
    f = POW_FIELDS[field]
    m = f.n_int
    rng = random.Random(m % 1009)
    xs = [0, 1, m - 1] + [rng.randrange(m) for _ in range(5)]
    es = [65537, rng.getrandbits(256) | 1 << 255, 1]
    cases = [(e, x) for e in es for x in xs]
    got = harness([_powwin_line(f, e, x) for e, x in cases])
    assert [g[0] for g in got] == [_pow_want(f, x, e) for e, x in cases]


# -- the varlen Keccak kernel's length-ordered schedule (lenorder.cuh) ------

def _keccak_batch(lens_blocks, nblocks, seed):
    """Random pre-padded blocks [B, nblocks, 136] and nvalid as given (may
    be out of [0, nblocks]); the digest each message must get, by
    refimpl.keccak256 over the message its clamped nvalid blocks hold."""
    from fisco_bcos_tpu_torch.ops import keccak

    rng = np.random.default_rng(seed)
    B = len(lens_blocks)
    blocks = np.zeros((B, max(nblocks, 1), 136), dtype=np.uint8)
    want = []
    for i, nv in enumerate(lens_blocks):
        k = min(max(nv, 0), nblocks)
        if k:
            msg = rng.bytes(int(rng.integers(136 * (k - 1), 136 * k)))
            blocks[i, :k] = keccak.pad_message_np(msg)
            want.append(refimpl.keccak256(msg))
        else:
            blocks[i] = rng.integers(0, 256, blocks[i].shape, dtype=np.uint8)
            want.append(bytes(32))  # nothing absorbed: the zero state's lanes
    return blocks[:, :nblocks], np.asarray(lens_blocks, dtype=np.int32), want


KECCAK_SCHEDULES = {
    # messages a block (the kernel's 512, or 64), B, nblocks, nvalid of message i
    "B=1": (512, 1, 3, lambda i, r: 2),
    "B=129 mixed": (512, 129, 4, lambda i, r: int(r.integers(0, 5))),
    "B=513 mixed with 0, -1 and above nblocks": (
        512, 513, 3, lambda i, r: int(r.choice([-1, 0, 1, 2, 3, 4, 9]))),
    "B=1100 all equal, the last block short": (512, 1100, 2, lambda i, r: 2),
    "B=1024 all equal": (512, 1024, 1, lambda i, r: 1),
    "B=70 all zero": (512, 70, 1, lambda i, r: 0),
    "B=600 one block or none, 256 a block": (512, 600, 1, lambda i, r: int(r.integers(-1, 3))),
    "M=64 B=150 past the last bin": (64, 150, 70, lambda i, r: int(r.integers(55, 75))),
    "M=64 B=65 descending": (64, 65, 6, lambda i, r: 6 - i % 7),
}


@pytest.mark.parametrize("case", list(KECCAK_SCHEDULES))
def test_keccak_length_ordered_schedule(harness, case):
    """keccak256_varlen_kernel's steps run block by block on the host:
    each message in exactly one slot, slots in length order (the harness
    exits non-zero otherwise), every digest refimpl.keccak256's at the
    message's own index, nvalid clamped to [0, nblocks]."""
    M, B, nblocks, nv = KECCAK_SCHEDULES[case]
    r = np.random.default_rng(B + nblocks)
    blocks, nvalid, want = _keccak_batch([nv(i, r) for i in range(B)], nblocks, seed=B)
    line = (f"keccak {M} {B} {nblocks} " + " ".join(str(int(x)) for x in nvalid) + " "
            + blocks.tobytes().hex())
    got = harness([line])[0]
    assert got == [int.from_bytes(w, "big") for w in want]


# -- the varlen SM3 kernel's schedule (lenorder.cuh) and absorb (sm3_rows) --

def _sm3_batch(lens_blocks, nblocks, seed):
    """Random pre-padded blocks [B, nblocks, 64] and nvalid as given (may
    be out of [0, nblocks]); the digest each message must get, by
    refimpl.sm3 over the message its clamped nvalid blocks hold, the IV's
    bytes where that is none."""
    from fisco_bcos_tpu_torch.ops import sm3

    rng = np.random.default_rng(seed)
    B = len(lens_blocks)
    blocks = np.zeros((B, max(nblocks, 1), 64), dtype=np.uint8)
    want = []
    for i, nv in enumerate(lens_blocks):
        k = min(max(nv, 0), nblocks)
        if k:
            msg = rng.bytes(int(rng.integers(max(0, 64 * k - 72), 64 * k - 8)))
            blocks[i, :k] = sm3.pad_message_np(msg)
            want.append(refimpl.sm3(msg))
        else:
            blocks[i] = rng.integers(0, 256, blocks[i].shape, dtype=np.uint8)
            want.append(sm3.IV.astype(">u4").tobytes())  # nothing compressed
    return blocks[:, :nblocks], np.asarray(lens_blocks, dtype=np.int32), want


SM3_SCHEDULES = {
    # messages a block (0: the kernel's own shape, sm3_block_msgs; else a
    # block of 32 threads), B, nblocks, nvalid of message i
    "B=1": (0, 1, 3, lambda i, r: 2),
    "B=700 mixed 3-18 blocks": (0, 700, 18, lambda i, r: int(r.integers(3, 19))),
    "B=545 mixed with 0, -1 and above nblocks": (
        0, 545, 4, lambda i, r: int(r.choice([-1, 0, 1, 2, 3, 4, 9]))),
    "B=600 all equal, the last block short": (0, 600, 2, lambda i, r: 2),
    "B=512 all equal": (0, 512, 2, lambda i, r: 2),
    "B=1100 all equal five blocks, the last block short": (0, 1100, 5, lambda i, r: 5),
    "B=70 none: -1 and 0": (0, 70, 2, lambda i, r: -(i % 2)),
    "M=64 B=150 past the last bin": (64, 150, 70, lambda i, r: int(r.integers(55, 75))),
    "M=64 B=65 descending": (64, 65, 6, lambda i, r: 6 - i % 7),
}


@pytest.mark.parametrize("case", list(SM3_SCHEDULES))
def test_sm3_length_ordered_schedule(harness, case):
    """sm3_varlen_kernel's steps run block by block on the host with the
    kernel's messages a block: each message in exactly one slot, slots in
    length order (the harness exits non-zero otherwise), every digest
    refimpl.sm3's at the message's own index (the IV for no block), nvalid
    clamped to [0, nblocks]."""
    M, B, nblocks, nv = SM3_SCHEDULES[case]
    r = np.random.default_rng(B + nblocks)
    blocks, nvalid, want = _sm3_batch([nv(i, r) for i in range(B)], nblocks, seed=B)
    line = (f"sm3 {M} {B} {nblocks} " + " ".join(str(int(x)) for x in nvalid) + " "
            + blocks.tobytes().hex())
    got = harness([line])[0]
    assert got == [int.from_bytes(w, "big") for w in want]


def _ladder_edge_qs() -> dict[str, tuple[int, int]]:
    """The affine Q of each edge of ec.LADDER_EDGES that sets one."""
    n = len(ec.LADDER_EDGES)
    _, _, qx, qy = ec.ladder_edge_lanes(C, [3] * n, [5] * n, [C.gx] * n, [C.gy] * n)
    return {name: (x, y) for name, x, y in zip(ec.LADDER_EDGES, qx, qy) if "Q" in name}


@pytest.mark.parametrize("edge", list(_ladder_edge_qs()))
def test_q_table_inverse_on_ladder_edges(harness, edge):
    """The Q table's one inversion (SecpFp::inv, modinv mod p) on the
    product of Z values that the table of an edge Q of ec.LADDER_EDGES
    builds: Python's inverse, 0 for the off-curve (5, 0) whose product is
    0; the affine table is k Q (zeros throughout for (5, 0))."""
    qx, qy = _ladder_edge_qs()[edge]
    z, zi, *tab = harness([f"qtab {_h(qx, qy)}"])[0]
    on_curve = (qy * qy - qx ** 3 - 7) % C.p == 0
    assert (z == 0) == (not on_curve)
    assert zi == (pow(z, -1, C.p) if z else 0)
    want = []
    for k in range(1, 16):
        P = refimpl.ec_mul(C, k, (qx, qy)) if on_curve else (0, 0)
        want += list(P)
    assert tab == want



def _gtab_line() -> str:
    g = derive_consts()["gtab"].reshape(-1).numpy().astype(np.int64) & 0xFFFF
    words = g[0::2] | (g[1::2] << 16)
    return "gtab " + " ".join(f"{int(w):08x}" for w in words)


def _signed_lanes(n: int):
    """n host signatures by 4 keys over seeded digests: (e, r, s, v, Q)."""
    rng = random.Random(41)
    keys = [refimpl.keygen(C, seed=b"host" + bytes([k])) for k in range(4)]
    out = []
    for i in range(n):
        sk, pub = keys[i % 4]
        h = rng.getrandbits(256).to_bytes(32, "big")
        r, s, v = refimpl.ecdsa_sign(C, sk, h)
        out.append(dict(e=int.from_bytes(h, "big"), r=r, s=s, v=v, qx=pub[0], qy=pub[1]))
    return out


def test_recover_one_matches_oracle(harness):
    """recover_one (the recover kernel's per-lane body) on signed lanes,
    test_torch_vectors' edge lanes (r, s at 1, n - 2 and n - 1, x = r + n near p, a
    key at infinity, x = 5) and corrupted ones, against
    refimpl.ecdsa_recover: ok, and the key (zeros where ok is 0)."""
    recs, _ = vectors.ecdsa_edge_lanes()
    lanes = [dict(d) for d in _signed_lanes(12)] + recs
    lanes[1]["v"] ^= 1
    lanes[2]["e"] ^= 1
    lanes[3]["s"] = C.n - lanes[3]["s"]
    got = harness([_gtab_line()] + [f"recover {_h(d['e'], d['r'], d['s'])} {d['v']}"
                                    for d in lanes])[1:]
    for d, g in zip(lanes, got):
        Q = refimpl.ecdsa_recover(C, d["e"].to_bytes(32, "big"), d["r"], d["s"], d["v"])
        assert g == ([1, Q[0], Q[1]] if Q is not None else [0, 0, 0]), d


def test_verify_one_matches_oracle(harness):
    """verify_one on signed lanes, test_torch_vectors' edge lanes (r, s at 1, n - 2
    and n - 1, Q = -G, Q = (5, 0)) and corrupted ones, against
    refimpl.ecdsa_verify."""
    _, vers = vectors.ecdsa_edge_lanes()
    lanes = [dict(d) for d in _signed_lanes(12)] + vers
    lanes[1]["e"] ^= 1 << 200
    lanes[2]["qx"], lanes[2]["qy"] = lanes[3]["qx"], lanes[3]["qy"] + 1
    lanes[4]["r"] = C.n - lanes[4]["r"]
    got = harness([_gtab_line()] + [
        f"verify {_h(d['e'], d['r'], d['s'], d['qx'], d['qy'])}" for d in lanes])[1:]
    want = [refimpl.ecdsa_verify(C, (d["qx"], d["qy"]), d["e"].to_bytes(32, "big"),
                                 d["r"], d["s"]) for d in lanes]
    assert [g[0] for g in got] == [int(w) for w in want]
    assert sum(want) >= len(lanes) - 6


# -- the Merkle tree kernels' schedule and node hashes (merkle.cuh) ----------

MERKLE_NS = [2, 15, 16, 17, 255, 256, 257, 4095, 4096, 4097]
MERKLE_BIG = 65537  # five levels, a ragged group at each
# orders of arrivals (merkle_launch in the harness): (order, seed)
ORDERS = {"in order": (0, 0), "reversed": (1, 0), "shuffle 1": (2, 11),
          "shuffle 2": (2, 22), "shuffle 3": (2, 33)}
MERKLE_ALGS = ["keccak256", "sm3"]


def _merkle_leaves(n: int, rows: int) -> np.ndarray:
    return np.random.default_rng(1000 + n).integers(0, 256, (rows, 32), dtype=np.uint8)


def _merkle_line(alg: str, n: int, rows: int, order: str) -> str:
    mode, seed = ORDERS[order]
    return (f"merkle {alg} {n} {rows} {mode} {seed} "
            + _merkle_leaves(n, rows).tobytes().hex())


def _level_counts(n: int) -> list[int]:
    counts = [n]
    while counts[-1] > 1:
        counts.append(-(-counts[-1] // 16))
    return counts


@pytest.fixture(scope="module")
def merkle_runs(harness):
    """(alg, n, order) -> (steps, scratch words, root) of the harness's
    tree over n leaves of n + 3 rows (the last 3 random: they must read as
    zero), one run for all; n = MERKLE_BIG in order only."""
    keys = [(alg, n, order) for alg in MERKLE_ALGS for n in MERKLE_NS for order in ORDERS]
    keys += [(alg, MERKLE_BIG, "in order") for alg in MERKLE_ALGS]
    got = harness([_merkle_line(alg, n, n + 3, order) for alg, n, order in keys])
    return {k: (g[0], g[1], g[2].to_bytes(32, "big")) for k, g in zip(keys, got)}


@functools.lru_cache(maxsize=None)
def _host_root(alg: str, n: int) -> bytes:
    leaves = _merkle_leaves(n, n + 3)[:n]
    return merkle.merkle_levels_host([bytes(x) for x in leaves], alg)[-1][0]


@functools.lru_cache(maxsize=None)
def _jax_root(alg: str, n: int) -> bytes:
    nb = max(16, 1 << (n - 1).bit_length())
    bucketed = np.zeros((nb, 32), np.uint8)
    bucketed[:n] = _merkle_leaves(n, n + 3)[:n]
    return bytes(np.asarray(jmerkle._merkle_root_bucketed(bucketed, np.int32(n), alg)))


def _check_run(run, alg: str, n: int) -> None:
    """A harness tree's root is merkle_levels_host's, each node was hashed
    once, and its scratch is the arrival counters of the levels above level
    2 (rounded up to 16 bytes) and the rows of the levels below the
    root's."""
    steps, words, root = run
    counts = _level_counts(n)
    assert root == _host_root(alg, n)
    assert steps == sum(counts[1:])
    assert words == ((sum(counts[3:]) + 3) & ~3) + 8 * sum(counts[1:-1])


@pytest.mark.parametrize("order", list(ORDERS))
@pytest.mark.parametrize("n", MERKLE_NS)
@pytest.mark.parametrize("alg", MERKLE_ALGS)
def test_merkle_tree_schedule_in_any_arrival_order(merkle_runs, alg, n, order):
    """The tree kernel's steps (merkle_leaf, the warp node hash and
    merkle_arrive) run on the host in an order of arrivals: the root equals merkle_levels_host's
    and the JAX package's bucketed tree on the same leaves, bit-exact,
    whatever the order, with rows past n read as zero."""
    run = merkle_runs[alg, n, order]
    _check_run(run, alg, n)
    assert run[2] == _jax_root(alg, n)


@pytest.mark.parametrize("alg", MERKLE_ALGS)
def test_merkle_tree_schedule_five_levels(merkle_runs, alg):
    """n = 65,537: five levels (4,097, 257, 17, 2, 1 nodes), a ragged group
    at each, in one order, against merkle_levels_host."""
    _check_run(merkle_runs[alg, MERKLE_BIG, "in order"], alg, MERKLE_BIG)


@pytest.mark.parametrize("alg", MERKLE_ALGS)
def test_merkle_tree_reads_missing_leaf_rows_as_zero(harness, alg):
    """n = 40 leaves of which only 20 rows exist: the 20 missing ones read
    as zero (the wrapper's min(rows, n))."""
    leaves = _merkle_leaves(40, 40)
    line = f"merkle {alg} 40 20 2 7 " + leaves[:20].tobytes().hex()
    steps, _, root = harness([line])[0]
    want = merkle.merkle_levels_host([bytes(x) for x in leaves[:20]] + [bytes(32)] * 20, alg)
    assert root.to_bytes(32, "big") == want[-1][0]
    assert steps == 4  # 3 nodes of level 1, the root
