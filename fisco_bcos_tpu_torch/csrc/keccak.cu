// Kernel 3 of the port: Keccak-256 of a batch of pre-padded messages of
// varying length, one thread per message.
//
// Replaces fisco_bcos_tpu/ops/pallas_hash.py keccak256_varlen_fused (:125 ->
// _keccak_call :73). The TPU kernel runs a 128-1024 lane block of (hi, lo)
// 32-bit word planes and masks every absorb with nvalid; here each thread
// keeps its 25 64-bit lanes in registers and stops absorbing after
// nvalid[i] of the nblocks 136-byte blocks, which is what the mask computes.
//
// What bounds it: 64-bit logic and rotate operations (about 180 32-bit
// instructions a round with 3-input logic and funnel shifts, 24 rounds a
// permutation), not bytes: a message reads 136 bytes per permutation and
// writes 32.
//
// Design for this card (PERF.md has the variants measured):
// * Length-ordered (lenorder.cuh): a block of 256 threads owns 512
//   messages, sorts them by block count in shared memory, and its warps
//   take groups of 32 sorted messages, longest first, from a shared
//   counter. One thread a message in arrival order ran, on a mixed batch,
//   as many permutations a warp as its longest message (8 blocks in almost
//   every warp of a 1-8-block batch, against a mean of 4.5); sorted with
//   one group a warp, the warps of the longest messages ran on alone at
//   the end of each block.
// * Each thread reads its own message's rows, and loads the next block
//   while it permutes the current one. Staging a warp's blocks through
//   shared memory with coalesced loads was measured slower: the kernel is
//   bound by logic issue, not by the rows' sectors.
// * A block whose messages all have one length skips the sort (the
//   address hash's 65,536 64-byte keys). Where no message has more than
//   one block, a block owns 256 messages, one group a warp, so that two
//   blocks share an SM and all 16 warps load their rows at once.
#include <cuda_runtime.h>
#include "keccak.cuh"
#include "lenorder.cuh"

#define KECCAK_THREADS 256
#define KECCAK_MSGS 512  // a block's messages: 16 groups for its 8 warps
#define KECCAK_PER_THREAD (KECCAK_MSGS / KECCAK_THREADS)

// msgs: the messages a block owns (lo_block_msgs); the schedule's steps,
// the group walk's slots and each message's absorb are lenorder.cuh's and
// keccak.cuh's, which the host tests run in this order
__global__ void __launch_bounds__(KECCAK_THREADS, 2)
keccak256_varlen_kernel(const uint8_t *blocks, const int32_t *nvalid, uint8_t *out, int B,
                        int nblocks, int msgs) {
    __shared__ LenOrder<KECCAK_MSGS> so;
    const int t = threadIdx.x, lane = t & 31;
    const int base = blockIdx.x * msgs;
    int nv[KECCAK_PER_THREAD], rank[KECCAK_PER_THREAD];
    const bool same = __syncthreads_and(lo_load<KECCAK_MSGS, KECCAK_THREADS>(
        so, nv, nvalid, t, base, B, nblocks, msgs));
    lo_rank<KECCAK_MSGS, KECCAK_THREADS>(so, nv, rank, same, t, base, B, msgs);
    if (!same) {
        __syncthreads();
        lo_scan_bins<KECCAK_MSGS, KECCAK_THREADS>(so, t, nblocks);
        __syncthreads();
        lo_place_msgs<KECCAK_MSGS, KECCAK_THREADS>(so, nv, rank, t, base, B, msgs);
    }
    __syncthreads();
    for (;;) {
        int q = 0;
        if (lane == 0) q = atomicAdd(&so.next, 1);
        const int g = lo_group_slot(__shfl_sync(0xFFFFFFFFu, q, 0), msgs);
        if (g < 0) break;
        keccak256_rows((const uint64_t *)blocks, (uint64_t *)out, so.msg[g + lane],
                       so.nv[g + lane], nblocks);
    }
}

extern "C" int keccak256_varlen_launch(const uint8_t *blocks, const int32_t *nvalid,
                                       uint8_t *out, int B, int nblocks, void *stream) {
    const int msgs = lo_block_msgs(KECCAK_MSGS, KECCAK_THREADS, nblocks);
    int grid = (B + msgs - 1) / msgs;
    keccak256_varlen_kernel<<<grid, KECCAK_THREADS, 0, (cudaStream_t)stream>>>(
        blocks, nvalid, out, B, nblocks, msgs);
    return (int)cudaGetLastError();
}

// the round constants on the current device, from
// ops/consts.kernel_words()["keccak"]; -> the CUDA error code
extern "C" int set_consts(const uint32_t *w, int nwords) { return keccak_set_rc(w, nwords); }

extern "C" const char *cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
