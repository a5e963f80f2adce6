// A length-ordered schedule for the varlen hash kernels: a block owns up
// to M consecutive messages, sorts them by block count in shared memory (a
// counting sort), and its warps take groups of 32 sorted messages, the
// longest group first, from a shared counter. A warp then hashes messages
// of equal or adjacent length, and the block's warps stay busy until its
// shortest groups are left: no warp of long messages runs alone at the end.
// Each message is still hashed by one thread, which writes its digest at
// the message's own index.
//
// The steps are plain functions of a thread index over a block's shared
// `LenOrder` (lo_load, lo_rank, lo_scan_bins, lo_place_msgs, then
// lo_group_slot), split where the kernel puts a barrier, so that a host
// build runs the kernel's own schedule thread by thread in the same order
// (tests/test_torch_csrc_host.py). lo_run holds the barriers and the warps'
// group loop, and each kernel calls it with its own per-message hash. Ranks within a bin come from atomicAdd,
// so which thread takes which message of equal length varies from run to
// run; the digests do not. A block whose messages all have one length (the
// address hash's 64-byte keys) skips the sort.
#pragma once
#include <stdint.h>

// M slots a block (a launch may fill fewer); block counts 0 .. M - 2 each
// have a bin, M - 1 and more share the last
template <int M>
struct LenOrder {
    int hist[M];   // messages a bin
    int start[M];  // the bin's first slot
    int msg[M];    // the message at each sorted slot (-1: none, past B)
    int nv[M];     // its block count, clamped to [0, nblocks]
    int next;      // the next group of 32 slots a warp takes, from the longest
};

template <int M>
__device__ __forceinline__ int lo_bin(int nv) {
    return nv < M - 1 ? nv : M - 1;
}

// the clamped block count of message i (0 past B)
__device__ __forceinline__ int lo_nv(const int32_t *nvalid, int i, int B, int nblocks) {
    if (i >= B) return 0;
    const int nv = nvalid[i];
    return nv < 0 ? 0 : (nv > nblocks ? nblocks : nv);
}

// the messages a launch gives a block of T threads with room for M: M, or
// T (one group a warp) where no message has more than one block
inline int lo_block_msgs(int M, int T, int nblocks) { return nblocks <= 1 ? T : M; }

// Thread t of a block of T, which owns messages base .. base + msgs - 1
// (msgs <= M); its messages are t, t + T, ... of the block (M / T of them).

// step 1: their clamped block counts into nv, their bins (and the group
// counter) cleared; -> whether they all have message base's count (the
// kernel ANDs it over the block at the barrier)
template <int M, int T>
__device__ __forceinline__ bool lo_load(LenOrder<M> &s, int nv[M / T], const int32_t *nvalid,
                                        int t, int base, int B, int nblocks, int msgs) {
    const int nv0 = lo_nv(nvalid, base, B, nblocks);
    bool same = true;
    if (t == 0) s.next = 0;
#pragma unroll
    for (int k = 0; k < M / T; ++k) {
        const int i = t + k * T;
        nv[k] = i < msgs ? lo_nv(nvalid, base + i, B, nblocks) : 0;
        same = same && (i >= msgs || nv[k] == nv0);
        s.hist[i] = 0;
    }
    return same;
}

// step 2, after the barrier, `same` the block's: one length keeps arrival
// order (the schedule is then ready after a barrier); otherwise each
// message's rank within its bin, and steps 3 and 4 follow
template <int M, int T>
__device__ __forceinline__ void lo_rank(LenOrder<M> &s, const int nv[M / T], int rank[M / T],
                                        bool same, int t, int base, int B, int msgs) {
#pragma unroll
    for (int k = 0; k < M / T; ++k) {
        const int i = t + k * T;
        if (same) {
            if (i < msgs) {
                s.msg[i] = base + i < B ? base + i : -1;
                s.nv[i] = nv[k];
            }
        } else {
            rank[k] = i < msgs ? atomicAdd(&s.hist[lo_bin<M>(nv[k])], 1) : 0;
        }
    }
}

// step 3, after a barrier: the first slot of bins t, t + T, ..., the sum
// of the bins below (bins past min(nblocks, M - 1) are empty)
template <int M, int T>
__device__ __forceinline__ void lo_scan_bins(LenOrder<M> &s, int t, int nblocks) {
    const int nbins = (nblocks < M - 1 ? nblocks : M - 1) + 1;
#pragma unroll
    for (int k = 0; k < M / T; ++k) {
        const int i = t + k * T;
        if (i >= nbins) continue;
        int sum = 0;
        for (int j = 0; j < i; ++j) sum += s.hist[j];
        s.start[i] = sum;
    }
}

// step 4, after a barrier: each message into its slot
template <int M, int T>
__device__ __forceinline__ void lo_place_msgs(LenOrder<M> &s, const int nv[M / T],
                                              const int rank[M / T], int t, int base, int B,
                                              int msgs) {
#pragma unroll
    for (int k = 0; k < M / T; ++k) {
        const int i = t + k * T;
        if (i >= msgs) continue;
        const int slot = s.start[lo_bin<M>(nv[k])] + rank[k];
        s.msg[slot] = base + i < B ? base + i : -1;
        s.nv[slot] = nv[k];
    }
}

// after a barrier, a warp's q-th group of 32 slots (longest first) of a
// block of `msgs` slots (a multiple of 32): its first slot, or -1 when the
// block's groups are taken
__device__ __forceinline__ int lo_group_slot(int q, int msgs) {
    return q < msgs / 32 ? msgs - 32 * (q + 1) : -1;
}

#ifdef __CUDACC__
// The schedule as a kernel runs it, in a block of T threads that owns
// `msgs` messages from `base`: steps 1-4 with their barriers, then each
// warp takes groups of 32 slots, longest first, until none is left, and
// each lane hashes its slot by rows(msg, nv). (The host tests run the same
// steps one at a time, with the barriers between them.)
template <int M, int T, class Rows>
__device__ __forceinline__ void lo_run(LenOrder<M> &s, const int32_t *nvalid, int base, int B,
                                       int nblocks, int msgs, Rows rows) {
    const int t = threadIdx.x, lane = t & 31;
    int nv[M / T], rank[M / T];
    const bool same =
        __syncthreads_and(lo_load<M, T>(s, nv, nvalid, t, base, B, nblocks, msgs));
    lo_rank<M, T>(s, nv, rank, same, t, base, B, msgs);
    if (!same) {
        __syncthreads();
        lo_scan_bins<M, T>(s, t, nblocks);
        __syncthreads();
        lo_place_msgs<M, T>(s, nv, rank, t, base, B, msgs);
    }
    __syncthreads();
    for (;;) {
        int q = 0;
        if (lane == 0) q = atomicAdd(&s.next, 1);
        const int g = lo_group_slot(__shfl_sync(0xFFFFFFFFu, q, 0), msgs);
        if (g < 0) break;
        rows(s.msg[g + lane], s.nv[g + lane]);
    }
}
#endif
