// Kernels 4 and B of the port: the whole canonical width-16 Merkle tree in
// one launch, Keccak-256 (merkle_keccak_tree) or SM3 (merkle_sm3_tree).
//
// Replace fisco_bcos_tpu/ops/pallas_merkle.py merkle_root_fused (:220 ->
// _tree_call :206, alg="keccak256" and alg="sm3"). The TPU kernel carries
// the levels as values through one grid step, since its grid runs in
// order; blocks on this card run in no order, so the levels are joined by
// arrival counters instead (merkle.cuh: the arrival that completes a
// parent's children hashes the parent), and the root is written to a
// 32-byte output on the card. No host loop over levels: one launch a tree.
//
// What bounds it: each node is one dependent chain, four Keccak
// permutations (96 rounds) or nine SM3 compressions (576 rounds), and the
// levels are serial, so a tree takes its levels times one node's chain,
// whatever the card's width; the roofline bound, the hash work spread over
// the card, is 10-20x below that (PERF.md: the chain floor). What the
// design does about it (merkle.cuh): one launch instead of one a level; a
// parent starts as soon as its own children are done; level 1, where the
// nodes are many, runs one thread a node and fills the card; above it a
// warp shares each node's chain: Keccak one state lane a lane, a round in
// two exchanges by shuffle, 1.7x shorter than one thread's; SM3's eight
// message expansions one a lane and the rounds on lane 0. A chain also
// loads its next block during the current permutation or compression,
// folds Keccak's constant pad words and skips the expansion of SM3's
// constant last block.
#include <cuda_runtime.h>
#include "merkle.cuh"

#define MERKLE_THREADS 64  // two warps: 32 nodes of level 1

__global__ void __launch_bounds__(MERKLE_THREADS)
merkle_keccak_tree_kernel(const uint8_t *leaves, MerkleShape s, uint8_t *nodes, int *arrivals,
                          uint8_t *root) {
    __shared__ KeccakTree::Shared sh[MERKLE_THREADS / 32];
    const int w = (blockIdx.x * MERKLE_THREADS + threadIdx.x) >> 5;
    merkle_tree<KeccakTree>(leaves, s, nodes, arrivals, root, w, threadIdx.x & 31,
                            sh[threadIdx.x >> 5]);
}

__global__ void __launch_bounds__(MERKLE_THREADS)
merkle_sm3_tree_kernel(const uint8_t *leaves, MerkleShape s, uint8_t *nodes, int *arrivals,
                       uint8_t *root) {
    __shared__ Sm3Tree::Shared sh[MERKLE_THREADS / 32];
    const int w = (blockIdx.x * MERKLE_THREADS + threadIdx.x) >> 5;
    merkle_tree<Sm3Tree>(leaves, s, nodes, arrivals, root, w, threadIdx.x & 31,
                         sh[threadIdx.x >> 5]);
}

// the scratch words (32 bits) a tree over n >= 2 leaves needs
extern "C" int merkle_tree_scratch_words(int n) {
    return n < 2 ? 0 : merkle_scratch_words(merkle_shape(n, n));
}

// the root of the tree over the first n >= 2 of `rows` leaf rows into
// root[32]; scratch: merkle_tree_scratch_words(n) words, any contents (the
// counters are zeroed here, on the stream); -> the CUDA error code
static int merkle_tree_launch(bool sm3, const uint8_t *leaves, int rows, int n, int32_t *scratch,
                              int scratch_words, uint8_t *root, void *stream) {
    if (n < 2 || rows < 1) return (int)cudaErrorInvalidValue;
    const MerkleShape s = merkle_shape(n, rows);
    if (scratch_words < merkle_scratch_words(s)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (s.counters) {
        const int rc = (int)cudaMemsetAsync(scratch, 0, 4 * (size_t)s.counters, st);
        if (rc) return rc;
    }
    int *arrivals = (int *)scratch;
    uint8_t *nodes = (uint8_t *)(scratch + merkle_counter_words(s));
    // a warp for each 16 nodes of level 1 (one warp for n <= 16)
    const int warps = s.levels > 1 ? (s.count[1] + MERKLE_WIDTH - 1) / MERKLE_WIDTH : 1;
    const int grid = (32 * warps + MERKLE_THREADS - 1) / MERKLE_THREADS;
    if (sm3)
        merkle_sm3_tree_kernel<<<grid, MERKLE_THREADS, 0, st>>>(leaves, s, nodes, arrivals, root);
    else
        merkle_keccak_tree_kernel<<<grid, MERKLE_THREADS, 0, st>>>(leaves, s, nodes, arrivals,
                                                                   root);
    return (int)cudaGetLastError();
}

extern "C" int merkle_keccak_tree_launch(const uint8_t *leaves, int rows, int n, int32_t *scratch,
                                         int scratch_words, uint8_t *root, void *stream) {
    return merkle_tree_launch(false, leaves, rows, n, scratch, scratch_words, root, stream);
}

extern "C" int merkle_sm3_tree_launch(const uint8_t *leaves, int rows, int n, int32_t *scratch,
                                      int scratch_words, uint8_t *root, void *stream) {
    return merkle_tree_launch(true, leaves, rows, n, scratch, scratch_words, root, stream);
}

#define KECCAK_WORDS 48  // 24 round constants as (lo, hi) words
#define SM3_WORDS 72     // the IV and 64 rotated round constants

// the Keccak round constants, the SM3 IV and round constants, then SM3's
// constant last block (W, W'), on the current device, from
// ops/consts.kernel_words()["keccak"] + ["sm3"] + ["sm3_pad"]; -> the CUDA
// error code
extern "C" int set_consts(const uint32_t *w, int nwords) {
    if (nwords < KECCAK_WORDS + SM3_WORDS) return (int)cudaErrorInvalidValue;
    int rc = keccak_set_rc(w, KECCAK_WORDS);
    if (!rc) rc = sm3_set_consts(w + KECCAK_WORDS, SM3_WORDS);
    return rc ? rc : sm3_set_pad(w + KECCAK_WORDS + SM3_WORDS,
                                 nwords - KECCAK_WORDS - SM3_WORDS);
}

extern "C" const char *cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
