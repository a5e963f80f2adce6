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

// msgs: the messages a block owns (lo_block_msgs); the schedule is
// lenorder.cuh's lo_run and each message's absorb keccak.cuh's, which the
// host tests run step by step
__global__ void __launch_bounds__(KECCAK_THREADS, 2)
keccak256_varlen_kernel(const uint8_t *blocks, const int32_t *nvalid, uint8_t *out, int B,
                        int nblocks, int msgs) {
    __shared__ LenOrder<KECCAK_MSGS> so;
    lo_run<KECCAK_MSGS, KECCAK_THREADS>(
        so, nvalid, blockIdx.x * msgs, B, nblocks, msgs, [&](int msg, int nv) {
            keccak256_rows((const uint64_t *)blocks, (uint64_t *)out, msg, nv, nblocks);
        });
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
