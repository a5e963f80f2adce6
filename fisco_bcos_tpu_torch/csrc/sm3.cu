// Kernel A of the port: SM3 of a batch of pre-padded messages of varying
// length, one thread per message.
//
// Replaces fisco_bcos_tpu/ops/pallas_hash.py sm3_varlen_fused (:174 ->
// _sm3_call :164). The TPU kernel runs a lane block of big-endian word
// planes and masks every compression with nvalid; here each thread keeps
// its 8 state words and 16-word window in registers and simply stops after
// nvalid[i] of the nblocks 64-byte blocks, which is what the mask computes.
// Same byte layout as keccak256_varlen: [B, nblocks, 64] uint8 in, [B, 32]
// uint8 out (big-endian words).
//
// What bounds it: 32-bit integer issue, about 1,400 instructions a
// compression (52 expansion words of ~7, 64 rounds of ~16, with 3-input
// logic and adds fused), not bytes: a compression reads 64 bytes. In SASS
// a compression is 1,269 instructions, 592 of them funnel shifts (SHF,
// the rotates).
//
// Design for this card (PERF.md has the variants measured):
// * Length-ordered, as the varlen Keccak kernel (lenorder.cuh): a block of
//   256 threads sorts its 512 messages by block count in shared memory,
//   and its 8 warps take the 16 groups of 32 sorted messages, longest
//   first, from a shared counter. In arrival order a warp ran as many
//   compressions as its longest message: 17 or 18 in almost every warp of
//   the SM block's 3-18-block tx encodings, against a mean of 10.2. One
//   group a warp (at 4, 8 or 16 warps an SM) and 4 warps an SM with four
//   groups each were measured slower: two groups a warp let the warps
//   finish together, and two warps a scheduler keep it issuing.
// * Each thread loads its message's next block while it compresses the
//   current one (sm3.cuh sm3_rows).
// * Where no message has more than two blocks (the SM block's receipts
//   and senders' keys), one thread a message in arrival order: measured
//   faster than the schedule there. A block of the sorted form whose
//   messages all have one length skips the sort.
#include <cuda_runtime.h>
#include "sm3.cuh"
#include "lenorder.cuh"

constexpr int SM3_THREADS = SM3_VARLEN_THREADS, SM3_MSGS = SM3_VARLEN_MSGS;

// msgs: the messages a block owns and sorts (sm3_block_msgs; 0: one a
// thread, unsorted); the schedule is lenorder.cuh's lo_run and each
// message's absorb sm3.cuh's, which the host tests run step by step
__global__ void __launch_bounds__(SM3_THREADS, 2)
sm3_varlen_kernel(const uint8_t *blocks, const int32_t *nvalid, uint8_t *out, int B,
                  int nblocks, int msgs) {
    __shared__ LenOrder<SM3_MSGS> so;
    auto rows = [&](int msg, int nv) {
        sm3_rows((const uint4 *)blocks, (uint4 *)out, msg, nv, nblocks);
    };
    if (msgs == 0) {
        const int i = blockIdx.x * SM3_THREADS + threadIdx.x;
        rows(i < B ? i : -1, lo_nv(nvalid, i, B, nblocks));
        return;
    }
    lo_run<SM3_MSGS, SM3_THREADS>(so, nvalid, blockIdx.x * msgs, B, nblocks, msgs, rows);
}

extern "C" int sm3_varlen_launch(const uint8_t *blocks, const int32_t *nvalid, uint8_t *out,
                                 int B, int nblocks, void *stream) {
    const int msgs = sm3_block_msgs(nblocks), per_block = msgs ? msgs : SM3_THREADS;
    int grid = (B + per_block - 1) / per_block;
    sm3_varlen_kernel<<<grid, SM3_THREADS, 0, (cudaStream_t)stream>>>(
        blocks, nvalid, out, B, nblocks, msgs);
    return (int)cudaGetLastError();
}

// the IV and round constants on the current device, from
// ops/consts.kernel_words()["sm3"]; -> the CUDA error code
extern "C" int set_consts(const uint32_t *w, int nwords) { return sm3_set_consts(w, nwords); }

extern "C" const char *cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
