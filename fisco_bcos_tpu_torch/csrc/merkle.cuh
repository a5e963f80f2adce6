// The width-16 Merkle tree in one launch (merkle.cu): the schedule's index
// arithmetic, each node's hash and the schedule's steps, as functions that
// the kernels call and that a host build runs step by step, lane by lane,
// in any order of arrivals (tests/test_torch_csrc_host.py).
//
// Levels: level 0 holds the n leaves, level L + 1 the ceil(count_L / 16)
// parents of level L; the root is the one node of the last level. Node p of
// level L + 1 hashes the 512 bytes of children 16p .. 16p + 15 of level L,
// those at index >= count_L read as zero (pallas_merkle.py:190-203 zero-pads
// each level and masks its dead parents to zero; a parent of a dead group
// is never read here, so it is never made).
//
// Schedule: warp w hashes the 16 nodes 16w .. 16w + 15 of level 1 from the
// leaves, one a lane (merkle_leaf: level 1 has n / 16 nodes, enough to fill
// the card one thread a node), then, together, their parent, node w of
// level 2 (merkle_group_step: above level 1 the nodes are few and each is
// one serial chain, so the warp shares each node's work). A node below the
// root's level is stored in its level's scratch rows, and the warp counts
// one arrival at its parent; the arrival that completes the parent's live
// children goes on to hash the parent ("last arrival"), up to the root.
// Each node is hashed once, whatever the order of arrivals, so the root
// does not depend on it, and no warp waits for another.
#pragma once
#include <stdint.h>
#include "keccak.cuh"
#include "sm3.cuh"

#define MERKLE_WIDTH 16
#define MERKLE_NODE 512    // a node's message: 16 children of 32 bytes
#define MERKLE_LEVELS 9    // 16^8 > 2^31 leaves, with level 0

// Children of upper levels are read through L2 only: another SM wrote them
// in this launch, so this SM's L1 may not hold them.
__device__ __forceinline__ uint64_t merkle_ld(const uint64_t *p) {
#ifdef __CUDA_ARCH__
    return __ldcg((const unsigned long long *)p);
#else
    return *p;
#endif
}
__device__ __forceinline__ uint4 merkle_ld(const uint4 *p) {
#ifdef __CUDA_ARCH__
    return __ldcg(p);
#else
    return *p;
#endif
}

struct MerkleShape {
    int levels;                     // the root's level (1 for 2 <= n <= 16)
    int leaves;                     // leaf rows read, min(rows, n); the rest read as zero
    int count[MERKLE_LEVELS];       // live nodes a level, count[0] = n
    int row[MERKLE_LEVELS];         // level L's first scratch row (0 < L < levels)
    int arrival[MERKLE_LEVELS];     // level L's first arrival counter (2 < L <= levels; a
                                    // node of level 2 is made by its children's own warp)
    int rows;                       // scratch rows (32 bytes each) in all
    int counters;                   // arrival counters in all
};

// the tree over n >= 2 leaves, `rows` of them in memory
__host__ __device__ inline MerkleShape merkle_shape(int n, int rows) {
    MerkleShape s;
    s.leaves = rows < n ? rows : n;
    s.count[0] = n;
    s.levels = 0;
    s.rows = 0;
    s.counters = 0;
    for (int L = 0; L < MERKLE_LEVELS; ++L) s.row[L] = s.arrival[L] = 0;
    while (s.count[s.levels] > 1) {
        const int L = ++s.levels;
        s.count[L] = (s.count[L - 1] + MERKLE_WIDTH - 1) / MERKLE_WIDTH;
        if (L > 1) {
            s.row[L - 1] = s.rows;  // level L - 1 is below the root: stored
            s.rows += s.count[L - 1];
        }
        if (L > 2) {
            s.arrival[L] = s.counters;
            s.counters += s.count[L];
        }
    }
    return s;
}

// scratch words (32 bits) a launch needs: the arrival counters, rounded up
// to 16 bytes, then the scratch rows
__host__ __device__ inline int merkle_counter_words(const MerkleShape &s) {
    return (s.counters + 3) & ~3;
}
__host__ __device__ inline int merkle_scratch_words(const MerkleShape &s) {
    return merkle_counter_words(s) + 8 * s.rows;
}

// the live children of node p of level L (L >= 1): those of level L - 1 at
// index < count_{L-1}, at most 16 (0 when the leaf rows end first)
__host__ __device__ inline int merkle_live(const MerkleShape &s, int L, int p) {
    const int avail = (L == 1 ? s.leaves : s.count[L - 1]) - MERKLE_WIDTH * p;
    return avail < 0 ? 0 : (avail < MERKLE_WIDTH ? avail : MERKLE_WIDTH);
}

// the first byte of node p's children (level L - 1): the leaves, or the
// scratch rows of level L - 1
__host__ __device__ inline const uint8_t *merkle_children(const MerkleShape &s,
                                                          const uint8_t *leaves,
                                                          const uint8_t *nodes, int L, int p) {
    return L == 1 ? leaves + (size_t)p * MERKLE_NODE
                  : nodes + ((size_t)s.row[L - 1] + (size_t)MERKLE_WIDTH * p) * 32;
}

// Keccak-256 of a node: the 512 bytes of its 16 children (src: the first
// child's 64 lanes), of which the first `live` are read and the rest are
// zero, in 4 rate blocks of 17 lanes; the pad words of the last block
// (lanes 64 and 67) are constants, and lanes 65 and 66 zero. The next
// block's lanes are loaded while the current one permutes.
__device__ __forceinline__ void keccak_node(uint64_t d[4], const uint64_t *src, int live) {
    uint64_t s[25], nx[17];
#pragma unroll
    for (int k = 0; k < 25; ++k) s[k] = 0;
#pragma unroll
    for (int k = 0; k < 17; ++k) nx[k] = (k >> 2) < live ? merkle_ld(src + k) : 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
#pragma unroll
        for (int k = 0; k < 17; ++k) s[k] ^= nx[k];
        if (b < 3) {
#pragma unroll
            for (int k = 0; k < 17; ++k) {
                const int m = 17 * (b + 1) + k;  // the message lane
                if (m < 64) nx[k] = (m >> 2) < live ? merkle_ld(src + m) : 0;
                else nx[k] = m == 64 ? 0x01ULL : (m == 67 ? 0x8000000000000000ULL : 0);
            }
        }
        keccak_f(s);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) d[k] = s[k];
}

// The expanded words of SM3's last block for every node: a 512-byte
// message pads to one constant block (0x80, zeros, the bit length 4,096),
// so W[0..63] and W'[j] = W[j] ^ W[j + 4] are constants too, set from
// ops/consts.kernel_words()["sm3_pad"].
struct Sm3Pad {
    uint32_t w[64];
    uint32_t wp[64];
};
static __constant__ Sm3Pad SM3PAD;

#ifdef __CUDACC__
// 128 words -> SM3PAD on the current device; -> the CUDA error code
static int sm3_set_pad(const uint32_t *w, int nwords) {
    if (nwords * 4 != (int)sizeof(Sm3Pad)) return (int)cudaErrorInvalidValue;
    return (int)cudaMemcpyToSymbol(SM3PAD, w, sizeof(Sm3Pad));
}
#endif

// the 16 big-endian words of an SM3 block from 4 little-endian 16-byte loads
__device__ __forceinline__ void sm3_words(uint32_t w[16], const uint4 v[4]) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        w[4 * q] = sm3_bswap(v[q].x);
        w[4 * q + 1] = sm3_bswap(v[q].y);
        w[4 * q + 2] = sm3_bswap(v[q].z);
        w[4 * q + 3] = sm3_bswap(v[q].w);
    }
}

// SM3 of a node (src: the first child's 32 16-byte words, `live` children
// read): 8 blocks of two children each, the next one loaded while the
// current one compresses, then the constant padding block, whose rounds
// take their words from SM3PAD and expand nothing; -> the digest's 32
// bytes as two 16-byte words
__device__ __forceinline__ void sm3_node(uint4 d[2], const uint4 *src, int live) {
    uint32_t V[8], w[16];
    uint4 nx[4];
    sm3_init(V);
#pragma unroll
    for (int q = 0; q < 4; ++q)
        nx[q] = (q >> 1) < live ? merkle_ld(src + q) : make_uint4(0, 0, 0, 0);
#pragma unroll 1
    for (int b = 0; b < 8; ++b) {  // block b = children 2b, 2b + 1
        sm3_words(w, nx);
        if (b < 7) {
#pragma unroll
            for (int q = 0; q < 4; ++q)
                nx[q] = 2 * (b + 1) + (q >> 1) < live ? merkle_ld(src + 4 * (b + 1) + q)
                                                      : make_uint4(0, 0, 0, 0);
        }
        sm3_compress(V, w);
    }
    uint32_t A = V[0], B = V[1], C = V[2], D = V[3];
    uint32_t E = V[4], F = V[5], G = V[6], H = V[7];
#pragma unroll
    for (int j = 0; j < 64; ++j) sm3_round(j, A, B, C, D, E, F, G, H, SM3PAD.w[j], SM3PAD.wp[j]);
    sm3_feed(V, A, B, C, D, E, F, G, H);
    d[0] = make_uint4(sm3_bswap(V[0]), sm3_bswap(V[1]), sm3_bswap(V[2]), sm3_bswap(V[3]));
    d[1] = make_uint4(sm3_bswap(V[4]), sm3_bswap(V[5]), sm3_bswap(V[6]), sm3_bswap(V[7]));
}


// ---------------------------------------------------------------------------
// Keccak with a warp a node: lane t (< 25) holds state lane t = x + 5y. A
// round is two exchanges by shuffle: theta and rho read the ten lanes of
// the neighbouring columns (their parities made where they are used),
// pi and chi the three lanes whose rho outputs pi moves to this lane and
// to its two chi neighbours. Each stage is a function of the lane's own
// value and of get(src), another lane's value at that stage (__shfl_sync
// on the card, an array of the lanes on the host). Lanes 25-31 take part
// in the shuffles and keep what they compute to themselves.
// ---------------------------------------------------------------------------

// the rho offsets of lanes x + 5y (refimpl._KECCAK_ROT)
static __constant__ int KECCAK_RHO[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                                          25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};

struct K25Lane {
    int cm[5], cp[5];  // the lanes of columns x - 1 and x + 1
    int b[3];          // the lanes whose rho outputs pi moves to lanes x + 5y,
                       // (x + 1) + 5y and (x + 2) + 5y: (x' + 3y) mod 5 + 5x'
    int rho;           // this lane's rho offset
    uint64_t rc;       // all ones on lane 0 (iota), else zero
};

__device__ __forceinline__ K25Lane k25_lane(int t) {
    K25Lane l;
    const int u = t < 25 ? t : 0;  // lanes 25-31 shadow lane 0
    const int x = u % 5, y = u / 5;
#pragma unroll
    for (int k = 0; k < 5; ++k) {
        l.cm[k] = (x + 4) % 5 + 5 * k;
        l.cp[k] = (x + 1) % 5 + 5 * k;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const int xk = (x + k) % 5;
        l.b[k] = (xk + 3 * y) % 5 + 5 * xk;
    }
    l.rho = KECCAK_RHO[u];
    l.rc = t == 0 ? ~0ULL : 0;
    return l;
}

// v rotated left by r (0 <= r < 64, r per lane)
__device__ __forceinline__ uint64_t k25_rotl(uint64_t v, int r) {
#ifdef __CUDA_ARCH__
    uint32_t lo = (uint32_t)v, hi = (uint32_t)(v >> 32);
    if (r & 32) {
        const uint32_t t = lo;
        lo = hi;
        hi = t;
    }
    return ((uint64_t)__funnelshift_l(lo, hi, r) << 32) | __funnelshift_l(hi, lo, r);
#else
    return r ? (v << r) | (v >> (64 - r)) : v;
#endif
}

// theta with the neighbouring columns' parities (get: the lanes' state
// words), then rho
template <class Get>
__device__ __forceinline__ uint64_t k25_theta_rho(uint64_t a, const K25Lane &l, Get get) {
    uint64_t cm = 0, cp = 0;
#pragma unroll
    for (int k = 0; k < 5; ++k) {
        cm ^= get(l.cm[k]);
        cp ^= get(l.cp[k]);
    }
    return k25_rotl(a ^ cm ^ ((cp << 1) | (cp >> 63)), l.rho);
}

// pi and chi (get: the lanes' rho outputs), then iota
template <class Get>
__device__ __forceinline__ uint64_t k25_pi_chi(const K25Lane &l, Get get, uint64_t rc) {
    return get(l.b[0]) ^ (~get(l.b[1]) & get(l.b[2])) ^ (rc & l.rc);
}

// lane t's word of rate block b: message lane 17b + t (t < 17) of the live
// children, the pad words of the last block (lanes 64 and 67), else zero
__device__ __forceinline__ uint64_t k25_word(const uint64_t *src, int live, int t, int b) {
    if (t >= 17) return 0;
    const int m = 17 * b + t;
    if (m < 64) return (m >> 2) < live ? merkle_ld(src + m) : 0;
    return m == 64 ? 0x01ULL : (m == 67 ? 0x8000000000000000ULL : 0);
}

__device__ __forceinline__ uint64_t k25_shfl(uint64_t v, int src) {
    return __shfl_sync(0xFFFFFFFFu, (unsigned long long)v, src);
}

__device__ __forceinline__ uint64_t k25_round(uint64_t a, const K25Lane &l, uint64_t rc) {
    const uint64_t r = k25_theta_rho(a, l, [&](int s) { return k25_shfl(a, s); });
    return k25_pi_chi(l, [&](int s) { return k25_shfl(r, s); }, rc);
}

// Keccak-256 of a node by a warp (lane t) -> lane t of the state; lanes 0-3
// hold the digest. The next block's word is loaded during the permutation.
__device__ __forceinline__ uint64_t keccak_node25(const uint64_t *src, int live, int t) {
    const K25Lane l = k25_lane(t);
    uint64_t a = 0, nx = k25_word(src, live, t, 0);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
        a ^= nx;
        if (b < 3) nx = k25_word(src, live, t, b + 1);
#pragma unroll 1
        for (int r = 0; r < 24; ++r) a = k25_round(a, l, KECCAK_RC[r]);
    }
    return a;
}

// ---------------------------------------------------------------------------
// SM3 with a warp a node: lane k (0..7) expands block k (children 2k,
// 2k + 1) into the warp's S8Shared, then lane 0 runs the rounds of the nine
// compressions, two expanded words a round from shared memory (the rounds
// are one dependent chain; the expansions are not).
// ---------------------------------------------------------------------------

struct S8Shared {
    uint2 w[8][64];  // (W[j], W'[j]) of block k
};

__device__ __forceinline__ void s8_expand(S8Shared &m, const uint4 *src, int live, int k) {
    uint4 v[4];
    uint32_t w[16];
#pragma unroll
    for (int q = 0; q < 4; ++q)
        v[q] = 2 * k + (q >> 1) < live ? merkle_ld(src + 4 * k + q) : make_uint4(0, 0, 0, 0);
    sm3_words(w, v);
#pragma unroll
    for (int j = 0; j < 64; ++j) {
        sm3_expand_step(w, j);
        m.w[k][j] = make_uint2(w[j & 15], w[j & 15] ^ w[(j + 4) & 15]);
    }
}

// lane 0's rounds over the expanded blocks, then the constant last block
__device__ __forceinline__ void s8_rounds(uint4 d[2], const S8Shared &m) {
    uint32_t V[8];
    sm3_init(V);
#pragma unroll 1
    for (int b = 0; b < 8; ++b) {
        uint32_t A = V[0], B = V[1], C = V[2], D = V[3];
        uint32_t E = V[4], F = V[5], G = V[6], H = V[7];
#pragma unroll
        for (int j = 0; j < 64; ++j) {
            const uint2 e = m.w[b][j];
            sm3_round(j, A, B, C, D, E, F, G, H, e.x, e.y);
        }
        sm3_feed(V, A, B, C, D, E, F, G, H);
    }
    uint32_t A = V[0], B = V[1], C = V[2], D = V[3];
    uint32_t E = V[4], F = V[5], G = V[6], H = V[7];
#pragma unroll
    for (int j = 0; j < 64; ++j) sm3_round(j, A, B, C, D, E, F, G, H, SM3PAD.w[j], SM3PAD.wp[j]);
    sm3_feed(V, A, B, C, D, E, F, G, H);
    d[0] = make_uint4(sm3_bswap(V[0]), sm3_bswap(V[1]), sm3_bswap(V[2]), sm3_bswap(V[3]));
    d[1] = make_uint4(sm3_bswap(V[4]), sm3_bswap(V[5]), sm3_bswap(V[6]), sm3_bswap(V[7]));
}


// ---------------------------------------------------------------------------
// The schedule's steps. H, the tree's hash: H::one(out, children, live) by
// one thread, H::group(out, children, live, lane, shared) by a warp.
// ---------------------------------------------------------------------------

struct KeccakTree {
    struct Shared {};
    __device__ __forceinline__ static void one(uint8_t *out, const uint8_t *src, int live) {
        uint64_t d[4];
        keccak_node(d, (const uint64_t *)src, live);
        uint64_t *o = (uint64_t *)out;
#pragma unroll
        for (int k = 0; k < 4; ++k) o[k] = d[k];
    }
    __device__ __forceinline__ static void group(uint8_t *out, const uint8_t *src, int live,
                                                 int lane, Shared &) {
        const uint64_t a = keccak_node25((const uint64_t *)src, live, lane);
        if (lane < 4) ((uint64_t *)out)[lane] = a;
    }
};

struct Sm3Tree {
    typedef S8Shared Shared;
    __device__ __forceinline__ static void one(uint8_t *out, const uint8_t *src, int live) {
        uint4 d[2];
        sm3_node(d, (const uint4 *)src, live);
        uint4 *o = (uint4 *)out;
        o[0] = d[0];
        o[1] = d[1];
    }
    __device__ __forceinline__ static void group(uint8_t *out, const uint8_t *src, int live,
                                                 int lane, Shared &m) {
        if (lane < 8) s8_expand(m, (const uint4 *)src, live, lane);
        __syncwarp();
        if (lane == 0) {
            uint4 d[2];
            s8_rounds(d, m);
            uint4 *o = (uint4 *)out;
            o[0] = d[0];
            o[1] = d[1];
        }
    }
};

// where node p of level L goes: the root at the root's level, else its
// level's scratch row
__host__ __device__ inline uint8_t *merkle_out(const MerkleShape &s, uint8_t *nodes,
                                               uint8_t *root, int L, int p) {
    return L == s.levels ? root : nodes + ((size_t)s.row[L] + p) * 32;
}

// lane t of warp w (t < 16): node i = 16w + t of level 1, from the leaves,
// by one thread (levels >= 2: stored)
template <class H>
__device__ __forceinline__ void merkle_leaf(const MerkleShape &s, const uint8_t *leaves,
                                            uint8_t *nodes, uint8_t *root, int i) {
    if (i < s.count[1])
        H::one(merkle_out(s, nodes, root, 1, i), merkle_children(s, leaves, nodes, 1, i),
               merkle_live(s, 1, i));
}

// count one arrival of node p of level L (below the root's) at its parent;
// -> whether it completed the parent's live children
__device__ __forceinline__ bool merkle_arrive(const MerkleShape &s, int *arrivals, int L, int p) {
    const int q = p / MERKLE_WIDTH;
    return atomicAdd(&arrivals[s.arrival[L + 1] + q], 1) == merkle_live(s, L + 1, q) - 1;
}

// A warp's step: hash node p of level L (L >= 2, or the root at level 1),
// store it, and count its arrival at its parent. -> the parent's index
// when this arrival completed the parent's live children (the warp goes on
// with it at level L + 1), else -1 (the warp ends). arrivals: the launch's
// counters, zero at its start; nodes: its scratch rows.
template <class H>
__device__ __forceinline__ int merkle_group_step(const MerkleShape &s, const uint8_t *leaves,
                                                 uint8_t *nodes, int *arrivals, uint8_t *root,
                                                 int L, int p, int lane,
                                                 typename H::Shared &m) {
    H::group(merkle_out(s, nodes, root, L, p), merkle_children(s, leaves, nodes, L, p),
             merkle_live(s, L, p), lane, m);
    if (L == s.levels) return -1;
    __threadfence();  // the node before its arrival, for the parent's reader
    __syncwarp();     // every lane's part of it, and the shared words free again
    int done = 0;
    if (lane == 0) done = merkle_arrive(s, arrivals, L, p);
    if (!__shfl_sync(0xFFFFFFFFu, done, 0)) return -1;
    __threadfence();  // the siblings' nodes after their arrivals
    return p / MERKLE_WIDTH;
}

// warp w's walk: its 16 nodes of level 1 one a lane, then their parent and
// every parent it completes (n <= 16: warp 0 hashes the root, level 1)
template <class H>
__device__ __forceinline__ void merkle_tree(const uint8_t *leaves, const MerkleShape &s,
                                            uint8_t *nodes, int *arrivals, uint8_t *root, int w,
                                            int lane, typename H::Shared &m) {
    int L = 1, p = 0;
    if (s.levels > 1) {
        if (MERKLE_WIDTH * w >= s.count[1]) return;
        if (lane < MERKLE_WIDTH) merkle_leaf<H>(s, leaves, nodes, root, MERKLE_WIDTH * w + lane);
        __syncwarp();  // the warp's level-1 nodes before their parent reads them
        L = 2;
        p = w;
    } else if (w) {
        return;
    }
    for (; p >= 0; ++L) p = merkle_group_step<H>(s, leaves, nodes, arrivals, root, L, p, lane, m);
}
