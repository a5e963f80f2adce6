#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's crypto paths on one NVIDIA card: the
default chain (secp256k1 + Keccak-256), the SM chain (SM2 + SM3) and the
ZK plane's batched Poseidon (BN254), both chains again on the composed
EC route, then each chain's node path from wire frames to the ledger and
the seal judge, each chain's block execution through the executor and
the scheduler, each chain on a 4-node PBFT network of the port's
Nodes, each chain's durability, each chain's serving edge driven
by the port's own SDK clients over JSON-RPC and WS, each chain on
four Nodes over loopback TCP (SM-TLS on the SM chain) with a light
client verifying it, and the Air deployment: each chain as four node
processes from build_chain, and one process hosting two groups on a
shared crypto lane with cross-group transfers.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the plain
version or to the CPU):

1. Card: name and power limit (nvidia-smi), the kernels' parallel build,
   ptxas registers and stack of every kernel, and the static SASS counts
   (instructions, LDL, STL, CALL, BRA; cuobjdump -sass) of the ladder, SM2
   verify and secp256k1 verify/recover libraries.
2. Each default-chain CUDA kernel against its plain PyTorch version on the
   card at the main path's shapes, bit-exact: recover and verify at 16,384
   lanes, with the inversion-stress lanes of
   tests/test_torch_vectors.ecdsa_edge_lanes (r and s at 1, n - 2 and
   n - 1, x = r + n near p, a recovered key at infinity, x = 5 and the
   off-curve key (5, 0), Q = -G) also held to the pure-Python oracle, then
   bit-exact at 65,536 and 131,072 lanes (the inputs tiled) and their lane
   sweeps (as in 4); Keccak over 65,536 messages of 1-8 blocks and over
   65,536 one-block 64-byte keys (the address hash's shape), Merkle
   trees (one launch a tree) at n in {1, 2, 17, 4097, 65535, 65536, 65537}
   and 200 launches at n = 65,536 and 4,097 that must all give the plain
   root (the arrival order varies from launch to launch). Kernel times are
   medians of CUDA event timings after a warm-up, with the profiler's
   device time beside them for Keccak and the trees; the plain version
   runs once.
3. The default chain's slice: a 65,536-tx block through the port's
   protocol entry points (batch_recover_senders, Block.calculate_txs_root
   and calculate_receipts_root), and a commit-seal span of 16,384 lanes
   through suite.verify_batch, checked against the pure-Python oracle on
   every distinct signed entry (by its signer), every corrupted lane and
   64 sampled tiled lanes, and against the plain path for the tx hashes
   and 65,536-leaf roots. The launch counters are zeroed just before and
   read just after; every kernel must have launched, and the profiler
   (warmed up on a small step) must record as many calls of each kernel.
4. The SM chain's kernels as in 2: SM3 at the SM block's three shapes,
   each timed apart (its 65,536 tx encodings of 3-18 blocks, its 65,536
   receipt encodings, its 65,536 senders' 64-byte keys) with the
   compressions each schedule issues, then the tx encodings in 50
   launches (a message's slot varies between launches) and ragged at
   B = 65,537 with nvalid of -1, 0 and past nblocks, SM3 Merkle trees
   at the same n and repeats, SM2 verify at
   one CHUNK of host-signed vectors with 1% adversarial lanes and 8
   carry-stress lanes (r and s at n - 1 and n - 2, a digest of 2^256 - 1,
   keys G, -2G and one with x near p - 1), then its lane sweep: ms at
   16,384, 65,536 and 131,072 lanes, the inputs tiled.
5. The SM chain's slice as in 3, on make_suite(sm_crypto=True): the same
   payloads, every tx signed with SM2 over its own payload by one of 16
   senders (so every lane is valid before corruption), seals signed by 4
   sealers. The fp, pow and ladder kernels' counters must still be 0
   here: the plain EC versions that phases 2 and 4 ran as oracles launch
   none of them.
6. The standalone field multiplies (csrc/fp.cu) against their plain
   version (the field's mul_plain) on the card, bit-exact, at the Poseidon
   path's shapes (mul and mul_const at [16, 65536], mul_stacked at
   [9, 16, 65536] and [3, 16, 65536]) over BN254 r, secp256k1 n, SM2 p and
   n (Montgomery) and secp256k1 p (Solinas), with edge lanes 0, 1, n - 1
   and R mod n and, for BN254 r, loose operands in [2r, 2^256).
7. The ZK plane's slice through make_suite()'s poseidon_batch: 65,536
   pairs, a 65,536-leaf Poseidon-Merkle tree (16 level calls) and 256
   inclusion proofs in one verify_batch call, plus 8 tampered ones; held
   to the plain path on the card on every lane and root, and to the
   pure-Python oracle on 1,024 lanes with the edge pairs and on a
   256-leaf root. Each step's fp launches must be 171 / 90 / 1 per chunk
   call and no other kernel's counter may move; the profiler (warmed up
   on a small step) records the 65,536-pair step, whose kernel calls must
   equal the counters.
8. The pow kernel (csrc/fp.cu) in each of its modes against the plain
   window loop on the card, bit-exact, at [16, 16,384] and [16, 1], each
   timed at both widths: the inverse (m - 2) on secp256k1's p and n and
   SM2's p and n, the square root ((p+1)/4) on secp256k1's p, the window
   loop (m - 3) on all four, with edge lanes 0, 1, n - 1 and R mod n and
   one-lane launches on n - 1 and 0.
9. The ladder kernel (csrc/ladder.cu) against ec.ladder_plain on the card
   at 16,384 lanes in both forms (GLV on secp256k1, plain on SM2),
   Jacobian bit-exact, on the edge lanes of ec.LADDER_EDGES (zero
   scalars, Q = +-G at k1 = k2, an off-curve Q with Z = 0 table entries,
   the last G add doubling and cancelling), 4 carry-stress lanes (scalars
   n - 1, n - 2 and 2^256 - 1 mod n, Q with x near p - 1) and flipped sign
   flags; 32 lanes held to the oracle k1 G + k2 Q; then each form's lane
   sweep as in 4.
10. The composed EC route: the blocks and seal spans of phases 3 and 5
   again, through make_suite(ec_route="composed") and
   make_suite(sm_crypto=True, ec_route="composed") by the same checks,
   whose senders, ok masks, roots and seal verdicts must be identical to
   the fused route's; one ladder a chunk call, 3 pows a recovery chunk and
   1 a secp256k1 verify chunk (none on the SM chain), the fused EC
   kernels' counters 0, and the profiler's kernel calls equal to the
   counters.
11. The node path, as a solo node wires it (the JAX package's
   init/node.py:299-312): genesis over the seal span's 4 sealers on a
   Ledger over MemoryStorage, a TxPool (limit 131,072) and an IngestLane
   (16,384 frames a dispatch); 65,536 wire frames on the default chain,
   4,096 on the SM chain: the slices' blocks of 3 and 5, or their first
   4,096 txs (block_limit 500, in the pool's default window of 600), in
   through submit_many_wire_nowait; seal and fill_block; the block's roots with
   seeded receipts standing in for execution; prewrite_block, the header
   rows and the storage 2PC (the scheduler's two commit steps, replayed
   here; phase 12 runs the executor and the scheduler themselves); then
   a span of 4,096
   headers (256 on the SM chain) tiling 3's sealed headers, mostly
   cert-mode certificates, some legacy, some below quorum, one minted
   under a foreign sealer set, 1% of the seal lanes corrupted, judged by
   qc.verify_spans as two groups' concurrent halves through one
   CryptoLane, which merges them into one verify_batch (15,868 seal
   lanes; 988 on the SM chain: the 129 or 9 headers below quorum or
   under the foreign set carry no lanes to verify). Each step's
   launches must equal the counts from the shapes and the profiler's
   calls; every status and sender is held to the oracle (every signed
   entry, corrupted lane and 64 sampled ones) and every sender to the
   slice's, the hashes and roots to
   the plain path, the committed block to the ledger's reads and a tx
   proof, each header's verdict to the quorum of the oracle's per-seal
   verdicts.
12. Block execution as a solo node runs it (the JAX package's
   init/node.py:341-347): TransactionExecutor and a pipelined Scheduler
   with the state index on a Ledger over MemoryStorage, genesis over the
   4 sealers, a TxPool and an IngestLane, the suite on backend "auto"
   (device_min_batch 512: the block's batches on the card, the EVM's
   single hashes and recoveries on the native host libraries, which must
   be loaded). Two blocks of 65,536 txs on the default chain, of 16,384
   on the SM chain: block 1 deploys a hand-written probe contract and
   registers 65,535 accounts with balance 1,000 (benchmark/chain_bench.py's
   workload); block 2 has one probe call in every 100 txs (KECCAK256 over
   its calldata, a STATICCALL of ecrecover on the signature it carries,
   an SSTORE and a LOG1) and transfers of 1 over seeded pairs, 1% of them
   of 10^6, which revert. Default-chain txs: 1,024 signed a block
   natively, the rest tiled; SM: 1,024 a block natively, the rest over
   their own payloads with sm2_sign_fixed_nonce (as phase 5), every lane
   valid. Steps, each timed with its
   launches counted: admission of both blocks' wire frames, seal and
   fill_block, execute_block of block 1, of block 2 (speculative over
   block 1's uncommitted changeset), commit_block of both, and
   scheduler.call of balanceOf on 64 accounts; each execute wall split
   into the transactions, the txs and receipts roots, prewrite_block and
   the state root. Launches must equal the counts from the shapes the
   suite was given (one hash launch a length class, one tree a root, no
   EC launch in execution) and the profiler's calls. Receipts,
   changesets, the three roots and the c_balance rows must equal the
   same blocks on the port's host suite (native, no launch); every hash
   of the execute steps the native host hash; the balances a Python
   replay (and their sum conserved). The state root's hash batch is
   timed by the profiler, and its longest length class alone.
13. A 4-node PBFT chain of the port's own Nodes (init/node.py), on each
   chain: NodeConfig(consensus="pbft", crypto_backend="device") over one
   FakeGateway, the 4 sealers of the genesis, leader_period 1 (heights
   1-2 have two leaders), blocks of one suite CHUNK (16,384 txs; 4,096
   on the SM chain), the pool limit 131,072, the ingest lane at 16,384
   frames a dispatch, a view timeout far above a healthy height. Two
   blocks of phase 12's balance workload (registers, then transfers with
   1% reverting; three were signed, phase 14 commits the third; the chain
   ran three heights until phase 17 took the script past 1,080 s on slow
   hosts), every tx signed natively, go in as wire frames through
   node 0's ingest lane; txsync gossips them (one batch recovery a
   packet on each peer), and every pool holds them all before the nodes
   start (height 1's leader last). The PBFT engines verify each drained
   inbox's packets and each flush's checkpoint seals in one verify_batch,
   the leaders compute txs_root, every node executes and commits on the
   card. Each node's suite calls are recorded by site (admission, gossip
   import, PBFT packets, checkpoint seals, proposal, leader's txs root,
   execution, sync, view change); the counters, zeroed before the frames
   go in and read after the nodes stop, must equal the launches the
   calls imply and the profiler's calls, with the verify kernel launched
   by PBFT packets and seals. Walls: admission and gossip, each height
   from its pre-prepare to its commit on every node, the chain. Checked:
   all four nodes at height 2 with equal header hashes and a seal quorum
   on each; the committed blocks executed in order by a solo Scheduler on
   the host suite give the same headers, roots and c_balance rows, and a
   Python replay the same balances.
14. Durability, on each chain, on the port's Nodes (crypto_backend
   "device") over the disk engine with key pages (storage_backend
   "disk", the page size auto) in a temporary directory each. (a) A
   single-sealer PBFT source (snapshot_interval 2, pruning on, no kept
   tail, 1 MiB chunks) commits phase 13's three blocks through its
   ingest lane (two, then the third once its checkpoint at height 2 has
   pruned the bodies below it). (b) A joiner (not a sealer,
   snap_sync_threshold 1) on the same gateway snap-syncs the checkpoint
   (one seal check, one chunk hash batch, one tree) and replays block 3
   only; its head, state root and c_balance rows equal the source's,
   and it adopts the snapshot and serves it. (c) Both stop, close their storages and
   come back as new Nodes on the same directories: same height, head
   hash and rows, the source's store still holds the checkpoint, and a
   re-export at the head gives the manifest root of one made before the
   stop. The counters, zeroed before (a) and read after (c), must equal
   the launches the recorded suite calls imply (one hash launch a
   length class of the chunks, one tree a manifest). The manifest's
   chunk hashes and root equal the host suite's. (d) phase 12's
   committed state (two full-width blocks) exported in 1 MiB chunks on
   the card, its chunk hashes and root held to the host suite's, and the
   chunk batch's device time (CUDA events, L2 flushed) beside its chain
   floor. Walls: export, verify, install, the join, the tail replay,
   the restart.
15. The serving edge, on each chain: one single-sealer PBFT Node
   (crypto_backend "device", memory storage, blocks of one suite CHUNK)
   with rpc_port, ws_port and metrics_port 0 and the JAX defaults
   otherwise (8 RPC workers, batches of 256, a query cache of 4,096
   entries and 64 MB, trace sampling 0.02, the profiler at 5 Hz).
   Phase 13's height 1 goes in over JSON-RPC in one wave (SERVE_WAVES;
   a later wave starts once every receipt of the one before is there;
   two waves took the script past 850 s on a slow card machine's
   host): 8 SdkClient threads on
   keep-alive connections post batch bodies of 256 sendTransaction
   entries (wait=false), one tx alone under a sampled traceparent. A
   WsSdkClient session holds newBlockHeaders and 64 receipt
   subscriptions. After each commit: getBlockByNumber cold (an uncached
   JsonRpcImpl: one recover batch) and over HTTP, 256 getProof (248 of
   the primed tail, 8 whose documents the LRU evicted), 256 receipts,
   verifyProofs over the 512 proofs with 1% tampered, 64 balanceOf
   calls, getSystemStatus and getAuditReport; then getTrace of the
   traced request, GET /metrics (the edge and the metrics port),
   /status and /profile. Checked: roots and c_balance rows equal a solo
   host-suite Scheduler's replay and a Python replay, every receipt
   served and pushed equals the oracle's, verifyProofs' verdicts equal
   the host suite's (tampered ones false), every committed tx's proof
   rendered, no best-effort catch fired, send_transaction's direct-path
   fallback taken 0 times, and the counters (zeroed before the first
   POST, read after the node stops) equal the launches the recorded
   suite calls imply, by site (admission, execution, seals, prime, cold
   senders, evicted proofs, verifyProofs, calls). Walls: admission over
   RPC and its tx/s, each wave's last admission to its commit, the
   prime, the reads; the lane's dispatch sizes and recover launches.
16. The p2p socket transport and the light node, on each chain: four
   port Nodes (crypto_backend "device", the 4 sealers, blocks of one
   suite CHUNK that seal only when full) on their own
   net.p2p.P2PGateway bound to 127.0.0.1 on port 0, in a full mesh
   brought up one link at a time (the smaller id of a pair dials):
   plain TCP on the default chain, SM-TLS on the SM chain (a seeded
   CertificateAuthority, one dual-cert credential a node), each
   handshake timed and any failure failing the phase, every session an
   SMSocket there. Height 1 of phase 13's traffic (16,384 txs; 4,096 on
   SM) goes in through node 0's ingest lane and txsync gossips it over
   the sockets; the nodes commit it. A fifth gateway, holding no sealer
   key, dials node 0 only; its LightNodeClient on a device suite calls
   status, header_range over the committed heights (one verify launch),
   transactions and receipts spans of 1,024 seeded hashes of the block
   (proof-checked: one identity and one proof-level hash batch a span),
   transaction, send_transaction of a fresh tx (admitted), then a rogue
   sealer set and a tampered proof root (every node's server forged at
   its level-build seam), which must be rejected. Checked: every node at
   height 1 with equal header hashes and a seal quorum; roots and
   c_balance rows equal a solo host-suite Scheduler's and a Python
   replay; the light client's answers equal a host-suite client's over
   the same front and the block's txs and the ledger's receipts; no
   best-effort catch fired (a failed frame dispatch, a dropped frame);
   the counters (zeroed before the gateways are made, read after
   everything stops) equal the launches the five parties' recorded
   suite calls imply, by site (admission, gossip import, PBFT packets
   and seals, the leader's root, execution, the light client's spans,
   the light-node server). Printed: each session's codec, the
   handshakes, admission and gossip, height 1 on each node, each light
   call's wall and launches. No profiler session.
17. The Air deployment, each node an OS process of its own (the port's
   build_chain and `python -m fisco_bcos_tpu_torch`'s main, through this
   script's child entry `--daemon-child NODE_DIR OUT_JSON INDEX`, which
   records the daemon's suite calls by site and, on SIGTERM, writes its
   counters, the launches its calls imply and its peak reserved memory).
   (a) Each chain: a 4-node build_chain directory (device cuda,
   crypto_backend "device", plain TCP on the default chain, --sm-tls on
   the SM chain, blocks of phase 13's size that seal only when full), four
   child daemons; height 1 of phase 13's traffic over JSON-RPC to node 0
   as phase 15 sends it. Checked: every child among nvidia-smi's compute
   apps; block 1's header hash equal on all four with a seal quorum; the
   roots and c_balance rows each node wrote to disk equal the host-suite
   oracle's and a Python replay; SIGTERM ends each with 0 and removes its
   node.pid; node 3 restarted alone reopens at height 1 (WAL replay) and
   a second daemon on its live directory exits 3; each child's counters
   equal the launches its recorded calls imply, by site. Printed: each
   boot, admission over RPC and its tx/s, first POST to height 1 on each
   node, the leader's pre-prepare to each commit (host clock across
   processes), the restart, each child's peak reserved memory. (b) The
   default chain: one daemon with [groups] list = group0,group1 (a
   single sealer, the node's key, JAX-default blocks of 1,000 txs, a
   partial one sealed after 2 s, the lane's window 2 ms);
   8,192 registers a group over JSON-RPC at once, the batch entries
   alternating groups; then 64 cross-group transfers, one to an unknown
   group (refunded) and one beyond its balance (reverted). Checked:
   getGroupList, JSONRPC_GROUP_NOT_FOUND for an unknown group, the
   transfers settled once each (getAuditReport's cross-group section),
   each group's blocks, roots, c_balance and xshard rows on disk equal a
   host-suite GroupManager's replay and a Python replay, a lane dispatch
   carried both groups' requests, the counters equal the launches the
   lane's base-suite calls imply. Printed: each group's wall, the lane's
   items a base call. No profiler session.

Prints, before the last line, the card line and one JSON object listing
every kernel; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import random
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

H100_INT_OPS = 132 * 64 * 1.98e9  # 32-bit integer issue slots per second
H100_BYTES = 3.35e12  # HBM3 bytes per second
SEED = 20261016
# the main path's shapes: one suite CHUNK of signatures, a 65,536-tx block
EC_B = 16384
NTX = 65536
NSIGNED = 1024  # distinct (key, tx) pairs signed on the host, then tiled
NSEAL = 16384
MERKLE_NS = (1, 2, 17, 4097, 65535, 65536, 65537)
MERKLE_N = 65536  # a block's tree, timed
MERKLE_REPEAT_NS = (65536, 4097)  # launched MERKLE_REPEATS times each
MERKLE_REPEATS = 200
# the ZK plane: chain_bench --proof-bench's largest rows
FP_B = 65536  # one Poseidon CHUNK of lanes
NPAIRS = 65536
NLEAVES = 65536
NPROOFS = 256
POSEIDON_ORACLE_LEAVES = 256  # the pure-Python oracle's root (the plain path holds all 65,536)


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event time of fn() in ms, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


BOUND = "spin_kernel"  # torch.cuda._sleep's kernel: it bounds the measured range
# s of quiet after a measured range, before its session ends: sessions that
# ended at once lost their last events (the end bound and the calls before it)
SESSION_QUIET = 0.5
LAST_EVENTS: dict = {}


@contextlib.contextmanager
def measured():
    """The measured range of a profiler session: one launch of torch's own
    spin kernel (torch.cuda._sleep, BOUND) on entry and one on exit, after
    the device has finished, then SESSION_QUIET of quiet. device_events
    counts the device work whose CUPTI correlation id lies between the two
    bounds'. Correlation ids number the runtime calls in the order they
    are made, on every thread, so the range needs no clock: on the card
    the device events' and the runtime calls' timestamps drift against the
    host's clock (by milliseconds, and in a late session of the process by
    more), and a range taken on the host's clock had all 5 measured calls
    of a session seem to fall outside it."""
    torch.cuda._sleep(1)
    yield
    torch.cuda.synchronize()
    torch.cuda._sleep(1)
    torch.cuda.synchronize()
    time.sleep(SESSION_QUIET)


def device_events(prof, tag: str):
    """Device time (us) and calls per kernel name of the device work
    (kernels, copies) launched inside measured(): the device events whose
    correlation id lies between the two bounds'. Each session first runs a
    warm-up through the same kernels, whose ids lie below the first bound,
    since a session's first events can go missing. A session whose
    profiler lost a bound's event counts nothing, and its caller measures
    again as on any lost event. LAST_EVENTS keeps (correlation id, us) of
    each counted event by name, for a failure's message."""
    from torch.autograd import DeviceType

    device = [ev for ev in prof.events()
              if ev.device_type != DeviceType.CPU and not ev.is_user_annotation
              and not ev.name.startswith("ProfilerStep")]
    bounds = sorted(ev.id for ev in device if BOUND in ev.name)
    LAST_EVENTS.clear()
    if len(bounds) != 2:
        where = (f" ({sum(ev.id < bounds[0] for ev in device)} device events below it, "
                 f"{sum(ev.id > bounds[0] for ev in device)} above)") if bounds else ""
        log(f"{tag} the profiler recorded {len(bounds)} of the measured range's 2 bounds"
            f"{where}: nothing counted")
        return {}, {}
    lo, hi = bounds
    device_us, calls, seen, outside = {}, {}, set(), 0
    for ev in device:
        if BOUND in ev.name:
            continue
        if not lo < ev.id < hi or ev.id in seen:
            outside += 1
            continue
        seen.add(ev.id)
        k = ev.name.split("(")[0]  # entries that differ past the name add up
        device_us[k] = device_us.get(k, 0) + ev.self_device_time_total
        calls[k] = calls.get(k, 0) + 1
        LAST_EVENTS.setdefault(k, []).append((ev.id, ev.self_device_time_total))
    if outside:
        log(f"{tag} left out device events outside the measured range (the warm-up's): "
            f"{outside}")
    return device_us, calls


def kernel_device_ms(fn, name: str, reps: int = 20, tries: int = 10,
                     per_call: int = 1) -> float:
    """Mean device time in ms of the kernel `name` a call of fn (which
    launches it per_call times) over reps calls, by the profiler's device
    events (CUPTI), each call after a 256 MB write that evicts the 50 MB
    L2, so the kernel reads its inputs from device memory as the bound
    assumes. For a kernel shorter than its launch, where CUDA events
    around one call time the host's launch. The warm-up calls' events are
    left out (device_events; LAST_EVENTS then holds the counted ones); a
    profiler session that lost events is run again, up to `tries` times.
    On some card machines sessions have lost some, most or all of their
    events, most often the last ones of a late session of the process (the
    state root's tree lost its end bound and the calls before it in 3
    sessions of one run): each session pauses 0.2 s first and keeps
    SESSION_QUIET after its range (measured()). More calls than launched
    cannot be a lost event and fails at once; the log names the sessions
    each measurement took."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    for session in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.2)
            for _ in range(reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
            with measured():
                for _ in range(reps):
                    flush.zero_()
                    fn()
        device_us, calls = device_events(prof, f"[{name}]")
        us, calls = device_us.get(name, 0.0), calls.get(name, 0)
        if calls > reps * per_call:
            fail(f"the profiler recorded {calls} calls of {name}, more than the "
                 f"{reps * per_call} launched")
        if calls == reps * per_call:
            log(f"[profiler] {name}: {session} session(s)")
            return us / reps / 1e3
        log(f"[profiler] recorded {calls} of {reps * per_call} calls of {name}; again")
    fail(f"the profiler recorded {calls} calls of {name}, expected {reps * per_call}, "
         f"in {tries} sessions")


def flushed_event_ms(fn, reps: int) -> float:
    """Mean CUDA-event time in ms of fn() over reps calls, each after the
    same 256 MB write as kernel_device_ms, so its inputs come from device
    memory. For one launch on tensors already on the card and long
    enough (milliseconds) that its launch is noise beside it."""
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.mean(times))


def wall_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for the work these inputs need
# ---------------------------------------------------------------------------
# EC work counts 32x32->64 wide multiplies at two 32-bit integer issue slots
# each: 64 per 256x256-bit product; a mod-p multiply adds 8 for the fold, a
# Montgomery multiply (CIOS) 2 x 64 + 8. An inversion is priced as if it
# were shared across the batch by Montgomery's trick, as the TPU kernel's
# product tree shares it across a block: 3 multiplies per lane here, and one
# Fermat power per batch (`ec_batch_inversions`). Keccak counts 32-bit
# logic/shift instructions: about 180 a round with 3-input logic fused, 24
# rounds, plus 34 for absorbing a block.
FP_MUL = 72
FN_MUL = 136
WIDE = 64
INV_LANE = 3  # multiplies per lane of a batched inversion
# a^((p+1)/4) mod secp256k1's p by its addition chain (ec.cuh fp_sqrt):
# 253 squarings and 13 multiplies
SQRT_SQR, SQRT_MUL = 253, 13
SQRT_CHAIN = SQRT_SQR + SQRT_MUL
# One convention for every bound: a 256x256-bit squaring needs 36 wide
# multiplies (8 diagonal, 28 cross), not 64, and keeps its product's
# reduction, so it is priced at SQR_SAVING fewer slots than any other
# product, whatever form a kernel computes it in (`priced`): kernel G's
# powers (`pow_bound`), the square root's chain, the points' doublings and
# adds, and the batched inversions' Fermat powers.
SQR_SAVING = WIDE - 36
# (products, squarings among them) of the point formulas (csrc/point.cuh):
# a secp256k1 doubling (a = 0: Y^2, X^2, Y^4, M^2), an SM2 one (a = -3:
# Z^2 too), a mixed add (Z^2, H^2, R^2), a Jacobian add (Z1^2, Z2^2, H^2,
# R^2); a table entry's normalisation (zi^2, then 5 multiplies)
SECP_DBL, SM2_DBL_OPS, MADD, JADD, NORM = (7, 4), (8, 4), (11, 3), (16, 4), (6, 1)
KECCAK_PERM_OPS = 24 * 180 + 34


def _pow_ops(e: int) -> tuple[int, int]:
    """(squarings, multiplies) of a^e by the 4-bit window loop: the table's
    14 entries (tbl[2k] = tbl[k]^2, tbl[2k+1] = tbl[2k] a), then 4
    squarings a digit and a multiply a nonzero digit."""
    digits = [(e >> (4 * i)) & 15 for i in range((e.bit_length() + 3) // 4)]
    return 7 + 4 * (len(digits) - 1), 7 + sum(1 for d in digits[:-1] if d)


def priced(products: float, squarings: float, per: float) -> float:
    """Wide-multiply slots of `products` products of `per` slots each, of
    which `squarings` are squarings (SQR_SAVING fewer each)."""
    return products * per - squarings * SQR_SAVING


def pow_slots(e: int, per: float) -> float:
    """Slots of a^e by the 4-bit window loop (`_pow_ops`)."""
    sqr, mul = _pow_ops(e)
    return priced(sqr + mul, sqr, per)


def _glv_nonzero(k: int) -> int:
    from fisco_bcos_tpu_torch.crypto import refimpl

    n = refimpl.SECP256K1.n
    nz = 0
    for x in refimpl.glv_split(k):
        m = min(x, n - x)
        nz += sum(1 for j in range(34) if (m >> (4 * j)) & 15)
    return nz


def _ladder_products(u1: int, u2: int) -> float:
    """Wide-multiply slots of the GLV ladder of recover and verify: the Q
    table (2Q, 13 mixed adds, 14 prefix products, the batched inversion, 14
    entries normalised), 34 steps of 4 doublings, a mixed add a nonzero
    digit, the GLV splits."""
    nz = _glv_nonzero(u1) + _glv_nonzero(u2)
    dbl, madd, norm = SECP_DBL, MADD, NORM
    prods = (dbl[0] + 13 * madd[0] + 14 + INV_LANE + 14 * norm[0] + 136 * dbl[0]
             + madd[0] * nz + nz // 4)  # phi(Q): one extra multiply
    sqrs = dbl[1] + 13 * madd[1] + 14 * norm[1] + 136 * dbl[1] + madd[1] * nz
    fn = 2 * 3 + 2  # two GLV splits, three Montgomery multiplies each
    return priced(prods, sqrs, FP_MUL) + fn * FN_MUL + 4 * WIDE


def recover_products(e, r, s, v) -> float:
    from fisco_bcos_tpu_torch.crypto import refimpl

    c = refimpl.SECP256K1
    if not (0 < r < c.n and 0 < s < c.n and 0 <= v < 4):
        return 0
    x = r + (v >> 1) * c.n
    if x >= c.p:
        return 0
    total = priced(3 + SQRT_CHAIN, 2 + SQRT_SQR, FP_MUL)  # x^2, x^3, the chain, y^2
    ysq = (x ** 3 + 7) % c.p
    if pow(ysq, (c.p + 1) // 4, c.p) ** 2 % c.p != ysq:
        return total
    rinv = pow(r, -1, c.n)
    u1, u2 = (-e * rinv) % c.n, (s * rinv) % c.n
    total += (4 + INV_LANE) * FN_MUL
    return total + _ladder_products(u1, u2) + priced(INV_LANE + 3, 1, FP_MUL)  # and Z^-2


def verify_products(e, r, s, qx, qy) -> float:
    from fisco_bcos_tpu_torch.crypto import refimpl

    c = refimpl.SECP256K1
    if not (0 < r < c.n and 0 < s < c.n and qx < c.p and qy < c.p):
        return 0
    if (qx, qy) == (0, 0) or (qy * qy - qx ** 3 - 7) % c.p:
        return priced(4, 2, FP_MUL)  # qx^2, qy^2
    w = pow(s, -1, c.n)
    u1, u2 = e % c.n * w % c.n, r * w % c.n
    fixed = priced(11, 3, FP_MUL)  # qx^2, qy^2 and Z^2
    return fixed + (4 + INV_LANE) * FN_MUL + _ladder_products(u1, u2)


def ec_batch_inversions(n_inv: int, p_inv: int) -> float:
    """Slots of the per-batch Fermat powers: n_inv mod-n, p_inv mod-p."""
    from fisco_bcos_tpu_torch.crypto import refimpl

    c = refimpl.SECP256K1
    return n_inv * pow_slots(c.n - 2, FN_MUL) + p_inv * pow_slots(c.p - 2, FP_MUL)


def ec_bound_ms(products: float) -> float:
    return products * 2 / H100_INT_OPS * 1e3


def keccak_bound(perms: int, nbytes: int):
    ops_ms = perms * KECCAK_PERM_OPS / H100_INT_OPS * 1e3
    bytes_ms = nbytes / H100_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


# SM3 counts 32-bit instructions as csrc/sm3.cuh issues them, with 3-input
# logic (LOP3) and 3-input adds fused and a rotate one funnel shift: ~7 per
# expanded word (52), ~16 per round (64), 8 for the feed-forward and 16
# byte swaps of the block's words.
SM3_COMPRESS_OPS = 52 * 7 + 64 * 16 + 8 + 16
# SM2 counts products mod p as csrc/sm2.cuh and point.cuh make them
# (SM2_DBL_OPS an a = -3 doubling, MADD a mixed add). SM2's
# p = 2^256 - 2^224 - 2^96 + 2^64 - 1 is a generalized-Mersenne prime, as
# NIST P-256's is: a product needs its 64 wide multiplies and a fold of the
# high half by word adds and subtracts only, two terms to a 3-input add of
# one issue slot (`sm2_fp_mul`). The kernels' product is of that form too
# (csrc/sm2.cuh, a special-form Montgomery reduction); their domain
# conversions are their design, not the work, and are not priced.


def sm3_bound(compressions: int, nbytes: int):
    ops_ms = compressions * SM3_COMPRESS_OPS / H100_INT_OPS * 1e3
    bytes_ms = nbytes / H100_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def fold_terms(p: int) -> int:
    """Word terms, with multiplicity, of folding words 8..15 of a 512-bit
    product into words 0..7 mod a p whose 2^256 - p has signed 32-bit
    digits of +-1 (x = 2^32, x^8 = 2^256 - p)."""
    c, low, j = (1 << 256) - p, {}, 0
    while c:
        d = c & 0xFFFFFFFF
        d -= (d >> 31) << 32  # signed digit
        if d:
            low[j] = d
        c, j = (c - d) >> 32, j + 1
    assert all(abs(d) == 1 for d in low.values()), "not a word-add fold"
    terms = 0
    for i in range(8, 16):
        poly = {i: 1}
        while max(poly) >= 8:
            k = max(poly)
            m = poly.pop(k)
            for j, d in low.items():
                poly[j + k - 8] = poly.get(j + k - 8, 0) + m * d
            poly = {k: v for k, v in poly.items() if v}
        terms += sum(abs(v) for v in poly.values())
    return terms


def sm2_fp_mul() -> float:
    """Wide-multiply slots of one product mod SM2's p: 64, plus the fold's
    word terms (58) two to a one-issue 3-input add, at two issues a slot."""
    from fisco_bcos_tpu_torch.crypto import refimpl

    return WIDE + fold_terms(refimpl.SM2P256V1.p) / 4


def sm2_products(e, r, s, qx, qy) -> float:
    """Wide-multiply slots one lane of SM2 verify needs for these inputs
    (the table's inversion priced as batched, as for secp256k1)."""
    from fisco_bcos_tpu_torch.crypto import refimpl

    c = refimpl.SM2P256V1
    if not (0 < r < c.n and 0 < s < c.n and qx < c.p and qy < c.p) or (qx, qy) == (0, 0):
        return 0
    # y^2 == x^3 + a x + b: y^2, x^2, x^3 (a x is adds)
    checks = priced(3, 2, sm2_fp_mul())
    t = (r + s) % c.n
    if (qy * qy - qx ** 3 - c.a * qx - c.b) % c.p or t == 0:
        return checks
    dbl, madd, norm = SM2_DBL_OPS, MADD, NORM
    table = (dbl[0] + 13 * madd[0] + 14 + INV_LANE + 14 * norm[0] + 5,
             dbl[1] + 13 * madd[1] + 14 * norm[1])
    nz = sum(1 for k in (s, t) for j in range(64) if (k >> (4 * j)) & 15)
    # 256 doublings; the first add lands on infinity
    ladder = (256 * dbl[0] + (nz - 1) * madd[0], 256 * dbl[1] + (nz - 1) * madd[1])
    cand = (r - e % c.n) % c.n
    final = 2 + (cand + c.n < c.p)  # Z^2, c Z^2, and (c + n) Z^2 where c + n < p
    return checks + priced(table[0] + ladder[0] + final, table[1] + ladder[1] + 1,
                          sm2_fp_mul())


def sm2_batch_inversion() -> float:
    """Wide-multiply slots of the one mod-p Fermat power a batch would share."""
    from fisco_bcos_tpu_torch.crypto import refimpl

    return pow_slots(refimpl.SM2P256V1.p - 2, sm2_fp_mul())


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def lane(xs, dev):
    from fisco_bcos_tpu_torch.ops import bigint

    return torch.as_tensor(bigint.batch_to_limbs(xs).astype(np.int64),
                           device=dev).T.contiguous()


def signed_entries():
    """256 host signatures of seeded digests by 8 keys: {e, r, s, v, qx, qy,
    pub}."""
    from fisco_bcos_tpu_torch.crypto import refimpl

    c = refimpl.SECP256K1
    keys = [refimpl.keygen(c, seed=b"k" + bytes([k])) for k in range(8)]
    signed = []
    for i in range(256):
        sk, pub = keys[i % 8]
        h = refimpl.keccak256(b"smoke" + i.to_bytes(4, "big"))
        r, s, v = refimpl.ecdsa_sign(c, sk, h)
        signed.append(dict(e=int.from_bytes(h, "big"), r=r, s=s, v=v,
                           qx=pub[0], qy=pub[1], pub=pub))
    return signed


def ecdsa_cases(rng: random.Random, signed, B: int):
    """The recover and verify kernels' B lanes, each ec_inputs with the
    tests' inversion-stress lanes (tests/test_torch_vectors.ecdsa_edge_lanes)
    in the last lanes -> (recover lanes, verify lanes, recover edge lanes,
    verify edge lanes): lists of int dicts, edges by lane index."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import test_torch_vectors

    rec_edges, ver_edges = test_torch_vectors.ecdsa_edge_lanes()
    rec = ec_inputs(rng, signed, B)
    ver = ec_inputs(rng, signed, B)
    out = []
    for lanes, edges in ((rec, rec_edges), (ver, ver_edges)):
        at = range(B - len(edges), B)
        for i, d in zip(at, edges):
            lanes[i] = d
        out.append(list(at))
    return rec, ver, out[0], out[1]


def ec_inputs(rng: random.Random, signed, B: int):
    """B lanes: the signed entries tiled over the first half with 1% of
    every 8 corrupted, random scalars (full ladder work, mostly invalid
    keys or failed matches) over the second half."""
    from fisco_bcos_tpu_torch.crypto import refimpl

    c = refimpl.SECP256K1
    out = []
    for i in range(B):
        if i < B // 2:
            d = dict(signed[i % len(signed)])
            if i % 97 == 5:
                [lambda: d.update(r=0), lambda: d.update(s=c.n + 1),
                 lambda: d.update(v=4 + i % 200), lambda: d.update(e=d["e"] ^ (1 << (i % 256))),
                 lambda: d.update(qx=(d["qx"] + 1) % c.p)][i % 5]()
        else:
            d = dict(e=rng.getrandbits(256), r=rng.randrange(1, c.n),
                     s=rng.randrange(1, c.n), v=rng.randrange(4),
                     **dict(zip(("qx", "qy"), signed[i % len(signed)]["pub"])))
        out.append(d)
    return out


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def ptxas_summary(text: str) -> dict:
    """nvcc -Xptxas -v output -> {function: "R registers, S B stack, spills"}."""
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            out[fn] = f"{m.group(1)} B stack, spills {m.group(2)}/{m.group(3)} B"
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn] = f"{m.group(1)} registers, " + out.get(fn, "")
            fn = None
    return out


def sass_opcodes(lib, dump=None) -> dict:
    """Static SASS opcodes of a built library, {function: {opcode: count}}
    with NOPs left out, from cuobjdump -sass (whose text goes to the file
    `dump` when one is given)."""
    from fisco_bcos_tpu_torch.ops import _cuda

    exe = shutil.which("cuobjdump") or str(Path(_cuda.nvcc_path()).parent / "cuobjdump")
    text = subprocess.run([exe, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    if dump is not None:
        Path(dump).write_text(text)
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), {})
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if m and cur is not None and m.group(1) != "NOP":
            cur[m.group(1)] = cur.get(m.group(1), 0) + 1
    return funcs


def sass_counts(lib, dump=None) -> dict:
    """Static SASS counts of a built library, by function: instructions
    (NOPs left out), LDL, STL, CALL and BRA (sass_opcodes)."""
    return {fn: dict(instructions=sum(ops.values()),
                     **{k: ops.get(k, 0) for k in ("LDL", "STL", "CALL", "BRA")})
            for fn, ops in sass_opcodes(lib, dump).items()}


def phase_card():
    smi = phase_card_line()
    name = torch.cuda.get_device_name(0)
    from fisco_bcos_tpu_torch.ops import _cuda

    build_s = _cuda.build_all()
    log(f"[card] {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| device {name} | kernel build {build_s:.1f} s (parallel nvcc, set-up)")
    for k, v in _cuda.PTXAS_LOG.items():
        for fn, info in ptxas_summary(v).items():
            log(f"[ptxas {k}] {fn}: {info}")
    for k in ("ladder", "sm2", "verify", "fp", "keccak", "merkle"):
        for fn, c in sass_counts(_cuda._lib_path(k)).items():
            log(f"[kernel] sass {k} {fn}: {c}")
    return smi, name


def tree_row(dev, nrng, alg: str) -> dict:
    """The tree kernel of `alg` against the plain tree (and the host levels
    up to n = 4,097) at every n of MERKLE_NS; then MERKLE_REPEATS launches
    at each n of MERKLE_REPEAT_NS, every root equal to the plain one (the
    levels are joined by arrival counters, whose order varies from launch
    to launch: a race would show as a rare mismatch); timed as the whole
    tree at n = MERKLE_N by CUDA events around a call (the host's launch
    included) and by the profiler's device time."""
    from fisco_bcos_tpu_torch.ops import cuda_merkle, merkle

    tree = cuda_merkle.TREES[alg]
    name = tree.__name__
    mism = err = 0
    kept = {}
    for n in MERKLE_NS:
        leaves = nrng.integers(0, 256, (n, 32), dtype=np.uint8)
        lt = torch.as_tensor(leaves, device=dev)
        root = cuda_merkle.merkle_root(lt, n, alg)
        nb = max(16, 1 << (n - 1).bit_length())
        padded = torch.cat([lt, torch.zeros((nb - n, 32), dtype=torch.uint8, device=dev)])
        proot, pms = wall_ms(lambda: merkle.merkle_root_bucketed_plain(padded, n, alg))
        bad = not torch.equal(root, proot)
        if n <= 4097:
            host = merkle.merkle_levels_host([bytes(x) for x in leaves], alg)[-1][0]
            bad |= bytes(root.cpu().numpy()) != host
        mism += int(bad)
        err = max(err, int((root.int() - proot.int()).abs().max()))
        kept[n] = (lt, proot, pms)
        log(f"[kernel] merkle {alg} n={n}: {'MISMATCH' if bad else 'ok'}")
    repeats = {}
    for n in MERKLE_REPEAT_NS:
        lt, proot, _ = kept[n]
        roots = torch.stack([cuda_merkle.merkle_root(lt, n, alg) for _ in range(MERKLE_REPEATS)])
        repeats[n] = int((roots != proot).any(1).sum())
        mism += repeats[n]
    lt, _, pms = kept[MERKLE_N]
    ms = cuda_ms(lambda: cuda_merkle.merkle_root(lt, MERKLE_N, alg), 20)
    dev_ms = kernel_device_ms(lambda: cuda_merkle.merkle_root(lt, MERKLE_N, alg),
                              name + "_kernel")
    parents, m = 0, MERKLE_N
    while m > 1:
        m = (m + 15) // 16
        parents += m
    nbytes = 32 * (MERKLE_N + parents) + 32 * parents
    if alg == "keccak256":  # 4 permutations or 9 compressions a parent
        bound, by = keccak_bound(4 * parents, nbytes)
    else:
        bound, by = sm3_bound(9 * parents, nbytes)
    log(f"[kernel] merkle {alg} repeats: {MERKLE_REPEATS} launches at n in "
        f"{MERKLE_REPEAT_NS}, roots not the plain one: {repeats}")
    log(f"[kernel] merkle {alg} n={MERKLE_N} tree: {ms:.4f} ms a call, {dev_ms:.4f} ms device "
        f"(plain {pms:.0f} ms), bound {bound:.4f} ms")
    return dict(
        name=name, route="cuda", source="fisco_bcos_tpu_torch/csrc/merkle.cu",
        replaces="fisco_bcos_tpu/ops/pallas_merkle.py:220", mismatches=mism,
        max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bound, bound_by=by,
        library_ms=None, device_ms=dev_ms, repeat_mismatches=repeats,
        shape=f"n={MERKLE_N}, whole tree, one launch")


def keccak_cases(nrng):
    """Kernel 3's two shapes, drawn from nrng: NTX messages of 1-8 blocks
    (as the tx payloads spread) and NTX equal one-block 64-byte keys (the
    address hash's) -> [(shape, messages)]."""
    lens = nrng.integers(0, 8 * 136, NTX)  # 1..8 blocks after padding
    flat = nrng.integers(0, 256, int(lens.sum()), dtype=np.uint8).tobytes()
    offs = np.concatenate([[0], np.cumsum(lens)])
    msgs = [flat[offs[i]:offs[i + 1]] for i in range(len(lens))]
    keys = np.frombuffer(nrng.bytes(64 * NTX), np.uint8).reshape(NTX, 64)
    return [("mixed", msgs), ("one_block", [bytes(k) for k in keys])]


def keccak_row(dev, nrng) -> dict:
    """Kernel 3 against keccak256_varlen_plain on the card, bit-exact, at
    both of keccak_cases' shapes, each timed by CUDA events around a call
    (median of 20, the host's launch included) and by its device time
    (kernel_device_ms)."""
    from fisco_bcos_tpu_torch.ops import cuda_hash, keccak

    shapes = {}
    for shape, batch in keccak_cases(nrng):
        blocks, nvalid = keccak.pad_batch_np(batch)
        bt, nv = torch.as_tensor(blocks, device=dev), torch.as_tensor(nvalid, device=dev)
        got = cuda_hash.keccak256_varlen(bt, nv)
        plain, plain_ms = wall_ms(lambda: keccak.keccak256_varlen_plain(bt, nv))
        ms = cuda_ms(lambda: cuda_hash.keccak256_varlen(bt, nv), 20)
        dev_ms = kernel_device_ms(lambda: cuda_hash.keccak256_varlen(bt, nv),
                                  "keccak256_varlen_kernel")
        perms = int(nvalid.sum())
        bound, by = keccak_bound(perms, perms * 136 + 4 * len(batch) + 32 * len(batch))
        shapes[shape] = dict(
            mismatches=int((got != plain).any(1).sum()),
            max_abs_err=int((got.int() - plain.int()).abs().max()), ms=ms, device_ms=dev_ms,
            plain_ms=plain_ms, bound_ms=bound, bound_by=by, perms=perms,
            nblocks=blocks.shape[1])
        log(f"[kernel] keccak {shape} B={len(batch)} ({perms} permutations, "
            f"{blocks.shape[1]} blocks max): mismatches {shapes[shape]['mismatches']}, "
            f"{ms:.4f} ms a call, {dev_ms:.4f} ms device (plain {plain_ms:.0f} ms), "
            f"bound {bound:.4f} ms ({by})")
    mx, one = shapes["mixed"], shapes["one_block"]
    return dict(
        name="keccak256_varlen", route="cuda", source="fisco_bcos_tpu_torch/csrc/keccak.cu",
        replaces="fisco_bcos_tpu/ops/pallas_hash.py:125",
        mismatches=mx["mismatches"] + one["mismatches"],
        max_abs_err=max(mx["max_abs_err"], one["max_abs_err"]), ms=mx["ms"],
        plain_ms=mx["plain_ms"], bound_ms=mx["bound_ms"], bound_by=mx["bound_by"],
        library_ms=None, device_ms=mx["device_ms"], one_block_ms=one["ms"],
        one_block_device_ms=one["device_ms"], one_block_plain_ms=one["plain_ms"],
        one_block_bound_ms=one["bound_ms"],
        shape=f"B={NTX}, 1-{mx['nblocks']} blocks, {mx['perms']} permutations (one-block "
              f"64-byte keys: {one['ms']:.4f} ms, bound {one['bound_ms']:.4f} ms)")


def recover_tensors(vs, dev):
    return [lane([d[k] for d in vs], dev) for k in "ers"] + [
        torch.tensor([d["v"] for d in vs], device=dev)]


def verify_tensors(vs, dev):
    return [lane([d[k] for d in vs], dev) for k in ("e", "r", "s", "qx", "qy")]


def recover_oracle_misses(vs, lanes, qx, qy, ok) -> int:
    """Lanes whose ok and key differ from refimpl.ecdsa_recover."""
    from fisco_bcos_tpu_torch.crypto import refimpl
    from fisco_bcos_tpu_torch.ops import bigint

    X, Y, okl = qx.cpu().numpy(), qy.cpu().numpy(), ok.cpu().tolist()
    bad = 0
    for i in lanes:
        d = vs[i]
        Q = refimpl.ecdsa_recover(refimpl.SECP256K1, d["e"].to_bytes(32, "big"), d["r"],
                                  d["s"], d["v"])
        got = (bigint.from_limbs(X[:, i]), bigint.from_limbs(Y[:, i]))
        bad += bool(okl[i]) != (Q is not None) or got != (Q or (0, 0))
    return bad


def recover_misses(out, px, py, pok) -> int:
    """Lanes whose (qx, qy, ok) differ from the plain version's."""
    qx, qy, ok = out
    return int((qx.long() != px).any(0).logical_or((qy.long() != py).any(0))
               .logical_or(ok.bool() != pok).sum())


def tiled_misses(launch, misses) -> dict:
    """{B: mismatched lanes} of one launch at each tiled B of SWEEP_B past
    the first: launch(k) runs the kernel on the 16,384-lane inputs tiled k
    times, misses(out, k) holds it to the plain outputs tiled k times (the
    plain versions work lane by lane)."""
    return {k * EC_B: misses(launch(k), k) for k in (b // EC_B for b in SWEEP_B[1:])}


def verify_oracle_misses(vs, lanes, ok) -> int:
    from fisco_bcos_tpu_torch.crypto import refimpl

    okl = ok.cpu().tolist()
    return sum(bool(okl[i]) != refimpl.ecdsa_verify(
        refimpl.SECP256K1, (vs[i]["qx"], vs[i]["qy"]), vs[i]["e"].to_bytes(32, "big"),
        vs[i]["r"], vs[i]["s"]) for i in lanes)


def phase_kernels(dev, signed, rng):
    from fisco_bcos_tpu_torch.ops import cuda_verify, ec

    rows = {}
    B = EC_B
    rec_vs, ver_vs, rec_edges, ver_edges = ecdsa_cases(rng, signed, B)
    # -- recover ------------------------------------------------------------
    e, r, s, v = recover_tensors(rec_vs, dev)
    qx, qy, ok = cuda_verify.ecdsa_recover(e, r, s, v)
    (px, py, pok), plain_ms = wall_ms(lambda: ec.ecdsa_recover_plain(ec.SECP256K1, e, r, s, v))
    mism = recover_misses((qx, qy, ok), px, py, pok)
    # bit-exact at the sweep's larger launches too
    tiled = tiled_misses(
        lambda k: cuda_verify.ecdsa_recover(*(x.repeat(1, k) for x in (e, r, s)), v.repeat(k)),
        lambda out, k: recover_misses(out, px.repeat(1, k), py.repeat(1, k), pok.repeat(k)))
    oracle = recover_oracle_misses(rec_vs, rec_edges, qx, qy, ok)
    err = max(int((qx.long() - px).abs().max()), int((qy.long() - py).abs().max()),
              int((ok.long() - pok.long()).abs().max()))
    ms = cuda_ms(lambda: cuda_verify.ecdsa_recover(e, r, s, v), 5)
    sweep = lane_sweep(lambda k: (lambda a=[x.repeat(1, k) for x in (e, r, s)] + [v.repeat(k)]:
                                  cuda_verify.ecdsa_recover(*a)))
    log(sweep_line("ecdsa_recover", sweep))
    # r^-1 mod n, the Q-table inverse and Z^-1 mod p
    prods = (sum(recover_products(d["e"], d["r"], d["s"], d["v"]) for d in rec_vs)
             + ec_batch_inversions(1, 2))
    rows["ecdsa_recover"] = dict(
        name="ecdsa_recover", route="cuda", source="fisco_bcos_tpu_torch/csrc/verify.cu",
        replaces="fisco_bcos_tpu/ops/pallas_verify.py:375",
        mismatches=mism + oracle + sum(tiled.values()), max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=ec_bound_ms(prods), bound_by="operations",
        library_ms=None, shape=f"B={B}", valid_lanes=int(ok.sum()), sweep_ms=sweep)
    log(f"[kernel] recover B={B}: mismatches {mism} (tiled, by B: {tiled}), "
        f"edge lanes held to the oracle "
        f"{len(rec_edges)} (misses {oracle}, valid {int(ok[rec_edges].sum())}), {ms:.3f} ms "
        f"(plain {plain_ms:.0f} ms), bound {ec_bound_ms(prods):.4f} ms, "
        f"valid lanes {int(ok.sum())}")
    # -- verify -------------------------------------------------------------
    args = verify_tensors(ver_vs, dev)
    ok = cuda_verify.ecdsa_verify(*args)
    pok, plain_ms = wall_ms(lambda: ec.ecdsa_verify_plain(ec.SECP256K1, *args))
    mism = int((ok.bool() != pok).sum())
    tiled = tiled_misses(lambda k: cuda_verify.ecdsa_verify(*(x.repeat(1, k) for x in args)),
                         lambda out, k: int((out.bool() != pok.repeat(k)).sum()))
    oracle = verify_oracle_misses(ver_vs, ver_edges, ok)
    ms = cuda_ms(lambda: cuda_verify.ecdsa_verify(*args), 5)
    sweep = lane_sweep(lambda k: (lambda a=[x.repeat(1, k) for x in args]:
                                  cuda_verify.ecdsa_verify(*a)))
    log(sweep_line("ecdsa_verify", sweep))
    # s^-1 mod n and the Q-table inverse
    prods = (sum(verify_products(d["e"], d["r"], d["s"], d["qx"], d["qy"]) for d in ver_vs)
             + ec_batch_inversions(1, 1))
    rows["ecdsa_verify"] = dict(
        name="ecdsa_verify", route="cuda", source="fisco_bcos_tpu_torch/csrc/verify.cu",
        replaces="fisco_bcos_tpu/ops/pallas_verify.py:262",
        mismatches=mism + oracle + sum(tiled.values()),
        max_abs_err=int((ok.long() - pok.long()).abs().max()), ms=ms, plain_ms=plain_ms,
        bound_ms=ec_bound_ms(prods), bound_by="operations",
        library_ms=None, shape=f"B={B}", valid_lanes=int(ok.sum()), sweep_ms=sweep)
    log(f"[kernel] verify B={B}: mismatches {mism} (tiled, by B: {tiled}), "
        f"edge lanes held to the oracle "
        f"{len(ver_edges)} (misses {oracle}, valid {int(ok[ver_edges].sum())}), {ms:.3f} ms "
        f"(plain {plain_ms:.0f} ms), bound {ec_bound_ms(prods):.4f} ms, "
        f"valid lanes {int(ok.sum())}")
    # -- keccak -------------------------------------------------------------
    nrng = np.random.default_rng(SEED)
    rows["keccak256_varlen"] = keccak_row(dev, nrng)
    # -- merkle -------------------------------------------------------------
    rows["merkle_keccak_tree"] = tree_row(dev, nrng, "keccak256")
    bad = {k: r["mismatches"] for k, r in rows.items() if r["mismatches"]}
    if bad:
        fail(f"kernel vs plain mismatches: {bad}")
    return rows


def key_near_top(c):
    """The affine point of c whose x is the largest below p - 1 on the
    curve (both p are 3 mod 4: y = rhs^((p+1)/4)), y the larger root."""
    x = c.p - 1
    while True:
        rhs = (x ** 3 + c.a * x + c.b) % c.p
        y = pow(rhs, (c.p + 1) // 4, c.p)
        if y * y % c.p == rhs:
            return x, max(y, c.p - y)
        x -= 1


def sm2_stress_lanes():
    """SM2 verify lanes whose words sit at the carry edges: valid
    signatures with r and s at n - 1 and n - 2, and r = n - 1, s = 2 (so
    r + s = 1): the nonce and the digest chosen for r, the key for s; a
    digest of 2^256 - 1; the keys G and -2G; a key with x near p - 1 and y
    near p under r = s = n - 1, and its negation under r = 1."""
    from fisco_bcos_tpu_torch.crypto import refimpl

    c = refimpl.SM2P256V1
    out = []
    for k, r, s_want in ((7, c.n - 1, c.n - 1), (11, c.n - 2, c.n - 1), (13, c.n - 1, 2)):
        x1 = refimpl.ec_mul(c, k, (c.gx, c.gy))[0]
        e = (r - x1) % c.n
        # s = (k - r d) / (1 + d) = s_want  <=>  d (s_want + r) = k - s_want
        d = (k - s_want) * pow(s_want + r, -1, c.n) % c.n
        pub = refimpl.ec_mul(c, d, (c.gx, c.gy))
        h = e.to_bytes(32, "big")
        assert refimpl.sm2_sign(d, h, k=k) == (r, s_want)
        out.append(dict(e=e, r=r, s=s_want, qx=pub[0], qy=pub[1]))
    for d in (1, c.n - 2, 0x1234567):
        pub = refimpl.ec_mul(c, d, (c.gx, c.gy))
        h = b"\xff" * 32 if d == 0x1234567 else refimpl.sm3(b"stress" + bytes([d & 255]))
        r, s = refimpl.sm2_sign(d, h)
        out.append(dict(e=int.from_bytes(h, "big"), r=r, s=s, qx=pub[0], qy=pub[1]))
    qx, qy = key_near_top(c)
    out.append(dict(e=(1 << 256) - 1, r=c.n - 1, s=c.n - 1, qx=qx, qy=qy))
    out.append(dict(e=0, r=1, s=c.n - 1, qx=qx, qy=c.p - qy))
    return out


def sm2_inputs(rng: random.Random, B: int):
    """B lanes of 256 host-signed SM2 vectors (8 keys), tiled, 1% of them
    corrupted by kind in turn: r = 0, s >= n, s = n - r, digest flipped,
    another key, off-curve key, key (0, 0), qx >= p; the last lanes the
    carry-stress lanes of sm2_stress_lanes."""
    from fisco_bcos_tpu_torch.crypto import refimpl

    c = refimpl.SM2P256V1
    keys = [refimpl.keygen(c, seed=b"sm" + bytes([k])) for k in range(8)]
    signed = []
    for i in range(256):
        sk, pub = keys[i % 8]
        h = refimpl.sm3(b"smoke" + i.to_bytes(4, "big"))
        r, s = refimpl.sm2_sign(sk, h)
        signed.append(dict(e=int.from_bytes(h, "big"), r=r, s=s, qx=pub[0], qy=pub[1]))
    out, bad = [], {}
    for j, i in enumerate(sorted(rng.sample(range(B), B // 100))):
        bad[i] = j % 8
    for i in range(B):
        d = dict(signed[i % len(signed)])
        k = bad.get(i)
        if k == 0:
            d["r"] = 0
        elif k == 1:
            d["s"] = c.n + i % 97
        elif k == 2:
            d["s"] = c.n - d["r"]
        elif k == 3:
            d["e"] ^= 1 << (i % 256)
        elif k == 4:
            d["qx"], d["qy"] = keys[(i + 1) % 8][1]
        elif k == 5:
            d["qy"] ^= 1
        elif k == 6:
            d["qx"], d["qy"] = 0, 0
        elif k == 7:
            d["qx"] = c.p + i % 97
        out.append(d)
    stress = sm2_stress_lanes()
    for j, d in enumerate(stress):
        out[B - len(stress) + j] = d
        bad.pop(B - len(stress) + j, None)
    return out, bad


def sm3_cases(data) -> list:
    """Kernel A's three launches on the SM block's main path, by shape:
    [(shape, messages)] of its tx encodings (the tx hashes), its receipt
    encodings (the receipt hashes) and its senders' 64-byte keys (the
    address hash, two blocks each)."""
    return [("tx encodings", [t.encode_unsigned() for t in data["txs"]]),
            ("receipts", [r.encode() for r in data["receipts"]]),
            ("address keys", [t.signature[64:128] for t in data["txs"]])]


SM3_REPEATS = 50  # launches of the tx encodings' shape that must all be bit-exact


def sm3_issued(nvalid: np.ndarray, nblocks: int) -> dict:
    """A host model, from the block counts alone, of the compressions that
    warps issue, summed over warps (32 x the warp's longest message): one
    thread a message in arrival order (warps of 32 consecutive messages)
    and length-ordered (blocks of 512 messages sorted, groups of 32 slots;
    slots past B count 0). Nothing here is measured on the card."""
    nv = np.clip(nvalid.astype(np.int64), 0, nblocks)
    arrival = int(np.pad(nv, (0, -len(nv) % 32)).reshape(-1, 32).max(1).sum() * 32)
    blocks = np.sort(np.pad(nv, (0, -len(nv) % 512)).reshape(-1, 512), axis=1)
    ordered = int(blocks.reshape(-1, 32).max(1).sum() * 32)
    return dict(needed=int(nv.sum()), arrival=arrival, length_ordered=ordered)


def sm3_ragged(bt, nv, rng, dev):
    """The tx encodings' blocks with one message more (B = 65,537, a block
    of 512 holding one), every fifth message's nvalid -1, 0 or nblocks + 5
    in turn (clamped to [0, nblocks] as the plain version masks) -> kernel
    A's rows that differ from sm3_varlen_plain's, plus those of 16 sampled
    clamped-to-0 messages that are not the IV's bytes."""
    from fisco_bcos_tpu_torch.ops import cuda_sm3, sm3

    bt = torch.cat([bt, bt[:1]])
    nv = torch.cat([nv, nv[:1]]).to(torch.int32)
    tweak = torch.arange(len(nv), device=dev) % 15
    nv = torch.where(tweak == 1, -1, torch.where(tweak == 6, 0, torch.where(
        tweak == 11, bt.shape[1] + 5, nv))).to(torch.int32)
    got = cuda_sm3.sm3_varlen(bt, nv)
    mism = int((got != sm3.sm3_varlen_plain(bt, nv)).any(1).sum())
    iv = torch.as_tensor(sm3.IV.astype(">u4").view(np.uint8), device=dev)
    none = torch.nonzero(nv <= 0).flatten().tolist()
    return mism + sum(int(not torch.equal(got[i], iv)) for i in rng.sample(none, 16))


def sm3_row(dev, data, rng) -> dict:
    """Kernel A against sm3_varlen_plain on the card, bit-exact, and 16
    sampled messages of each shape against refimpl.sm3, at each of
    sm3_cases' shapes, each timed apart by CUDA events around a call
    (median of 20) and by its device time, with its own bound; the log
    line adds sm3_issued's host model of each schedule's compressions;
    then the tx encodings' shape in SM3_REPEATS launches (ranks within a
    length come from atomicAdd, so the slot a message takes varies
    between launches) and ragged (sm3_ragged), both bit-exact."""
    from fisco_bcos_tpu_torch.crypto import refimpl
    from fisco_bcos_tpu_torch.ops import cuda_sm3, sm3

    shapes, kept = {}, {}
    for shape, msgs in sm3_cases(data):
        blocks, nvalid = sm3.pad_batch_np(msgs)
        bt, nv = torch.as_tensor(blocks, device=dev), torch.as_tensor(nvalid, device=dev)
        got = cuda_sm3.sm3_varlen(bt, nv)
        plain, plain_ms = wall_ms(lambda: sm3.sm3_varlen_plain(bt, nv))
        kept[shape] = (bt, nv, plain)
        mism = int((got != plain).any(1).sum())
        for i in rng.sample(range(len(msgs)), 16):
            mism += bytes(got[i].cpu().numpy()) != refimpl.sm3(msgs[i])
        ms = cuda_ms(lambda: cuda_sm3.sm3_varlen(bt, nv), 20)
        dev_ms = kernel_device_ms(lambda: cuda_sm3.sm3_varlen(bt, nv), "sm3_varlen_kernel")
        comp = int(nvalid.sum())
        bound, by = sm3_bound(comp, comp * 64 + 4 * len(msgs) + 32 * len(msgs))
        issued = sm3_issued(nvalid, blocks.shape[1])
        shapes[shape] = dict(
            mismatches=mism, max_abs_err=int((got.int() - plain.int()).abs().max()), ms=ms,
            device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
            shape=f"B={len(msgs)}, {int(nvalid.min())}-{int(nvalid.max())} blocks, "
                  f"{comp} compressions")
        log(f"[kernel] sm3 {shape} {shapes[shape]['shape']}: mismatches {mism}, "
            f"{ms:.4f} ms a call, {dev_ms:.4f} ms device (plain {plain_ms:.0f} ms), "
            f"bound {bound:.4f} ms ({by}); host model from nvalid, compressions issued / "
            f"needed: arrival order {issued['arrival'] / comp:.3f}, length-ordered "
            f"{issued['length_ordered'] / comp:.3f}")
    bt, nv, plain = kept["tx encodings"]
    repeats = sum(int((cuda_sm3.sm3_varlen(bt, nv) != plain).any(1).sum())
                  for _ in range(SM3_REPEATS))
    ragged = sm3_ragged(bt, nv, rng, dev)
    log(f"[kernel] sm3 tx encodings in {SM3_REPEATS} launches: rows not the plain ones "
        f"{repeats}; ragged B={len(nv) + 1} (nvalid -1, 0 and past nblocks): mismatches {ragged}")
    tx = shapes["tx encodings"]
    return dict(
        name="sm3_varlen", route="cuda", source="fisco_bcos_tpu_torch/csrc/sm3.cu",
        replaces="fisco_bcos_tpu/ops/pallas_hash.py:174",
        mismatches=sum(v["mismatches"] for v in shapes.values()) + repeats + ragged,
        max_abs_err=max(v["max_abs_err"] for v in shapes.values()), ms=tx["ms"],
        plain_ms=tx["plain_ms"], bound_ms=tx["bound_ms"], bound_by=tx["bound_by"],
        library_ms=None, device_ms=tx["device_ms"], shape=f"tx encodings, {tx['shape']}",
        by_shape=shapes, repeat_mismatches=repeats, ragged_mismatches=ragged)


def phase_sm_kernels(dev, data, rng):
    """Kernels A, B and C against their plain versions on the card at the
    SM path's shapes, bit-exact."""
    from fisco_bcos_tpu_torch.crypto import refimpl
    from fisco_bcos_tpu_torch.ops import cuda_verify, ec

    rows = {"sm3_varlen": sm3_row(dev, data, rng)}
    # -- B: SM3 Merkle trees ----------------------------------------------------
    rows["merkle_sm3_tree"] = tree_row(dev, np.random.default_rng(SEED + 2), "sm3")
    # -- C: SM2 verify at one CHUNK --------------------------------------------
    t0 = time.perf_counter()
    vs, bad = sm2_inputs(rng, EC_B)
    log(f"[kernel] 256 host SM2 signatures for kernel C: {time.perf_counter() - t0:.1f} s")
    args = [lane([d[k] for d in vs], dev) for k in ("e", "r", "s", "qx", "qy")]
    ok = cuda_verify.sm2_verify(*args)
    pok, plain_ms = wall_ms(lambda: ec.sm2_verify_plain(ec.SM2P256V1, *args))
    mism = int((ok.bool() != pok).sum())
    okl = ok.bool().tolist()
    stress = range(EC_B - len(sm2_stress_lanes()), EC_B)
    for i in sorted(bad) + list(stress) + rng.sample(
            [i for i in range(len(vs)) if i not in bad], 16):
        d = vs[i]
        mism += okl[i] != refimpl.sm2_verify((d["qx"], d["qy"]), d["e"].to_bytes(32, "big"),
                                             d["r"], d["s"])
    ms = cuda_ms(lambda: cuda_verify.sm2_verify(*args), 5)
    sweep = lane_sweep(lambda k: (lambda a=[x.repeat(1, k) for x in args]:
                                  cuda_verify.sm2_verify(*a)))
    log(sweep_line("sm2_verify", sweep))
    prods = (sum(sm2_products(d["e"], d["r"], d["s"], d["qx"], d["qy"]) for d in vs)
             + sm2_batch_inversion())
    rows["sm2_verify"] = dict(
        name="sm2_verify", route="cuda", source="fisco_bcos_tpu_torch/csrc/sm2.cu",
        replaces="fisco_bcos_tpu/ops/pallas_verify.py:507", mismatches=mism,
        max_abs_err=int((ok.long() - pok.long()).abs().max()), ms=ms,
        plain_ms=plain_ms, bound_ms=ec_bound_ms(prods), bound_by="operations",
        library_ms=None, shape=f"B={EC_B}", valid_lanes=int(ok.sum()), sweep_ms=sweep)
    log(f"[kernel] sm2 verify B={EC_B}: mismatches {mism} ({len(bad)} corrupted lanes, "
        f"{len(stress)} carry-stress lanes and 16 signed held to the oracle), "
        f"{ms:.3f} ms (plain {plain_ms:.0f} ms), "
        f"bound {ec_bound_ms(prods):.3f} ms, valid lanes {int(ok.sum())}")
    bad = {k: r["mismatches"] for k, r in rows.items() if r["mismatches"]}
    if bad:
        fail(f"kernel vs plain mismatches: {bad}")
    return rows


def corrupt_tx(kind: str, j: int, sig: bytes, c, other_pub: bytes) -> bytes:
    """The j-th corrupted tx signature of the slice's block: six kinds on
    the default chain, seven on the SM chain (r | s | embedded key)."""
    sig = bytearray(sig)
    if kind == "ecdsa":
        k = j % 6
        if k == 0:
            sig[:32] = bytes(32)                          # r = 0
        elif k == 1:
            sig[32:64] = (c.n + j).to_bytes(32, "big")     # s >= n
        elif k == 2:
            sig[64] = 4 + j % 200                          # v >= 4
        elif k == 3:
            sig[64] ^= 1                                   # wrong key
        elif k == 4:
            sig = sig[:40]                                 # malformed
        else:
            sig[5] ^= 0x10                                 # r flipped
        return bytes(sig)
    k = j % 7
    r = int.from_bytes(sig[:32], "big")
    if k == 0:
        sig[:32] = bytes(32)                               # r = 0
    elif k == 1:
        sig[32:64] = (c.n + j).to_bytes(32, "big")         # s >= n
    elif k == 2:
        sig[32:64] = (c.n - r).to_bytes(32, "big")         # s = n - r: t = 0
    elif k == 3:
        sig = sig[:100]                                    # under 128 bytes
    elif k == 4:
        sig[5] ^= 0x10                                     # r flipped
    elif k == 5:
        sig[64:128] = other_pub                            # another signer's key
    else:
        sig[127] ^= 1                                      # off-curve key
    return bytes(sig)


def corrupt_seal(kind: str, j: int, d: bytes, sig: bytes, pub: bytes, c, other_pub: bytes):
    """The j-th corrupted seal lane -> (digest, sig, pub): five kinds on the
    default chain, six on the SM chain (t = 0 added)."""
    k = j % (5 if kind == "ecdsa" else 6)
    if k == 0:
        sig = bytes(32) + sig[32:]                                  # r = 0
    elif k == 1:
        sig = sig[:32] + (c.n + j).to_bytes(32, "big") + sig[64:]   # s >= n
    elif k == 2:
        d = bytes([d[0] ^ 1]) + d[1:]                               # digest flipped
    elif k == 3:
        x = (int.from_bytes(pub[:32], "big") + 1) % c.p             # off-curve key
        pub = x.to_bytes(32, "big") + pub[32:]
    elif k == 4:
        pub = other_pub                                             # wrong key
    else:
        r = int.from_bytes(sig[:32], "big")
        sig = sig[:32] + (c.n - r).to_bytes(32, "big") + sig[64:]   # t = 0
    return d, sig, pub


def _ints(pub: bytes):
    return int.from_bytes(pub[:32], "big"), int.from_bytes(pub[32:64], "big")


def oracle_verify(kind: str, pub: bytes, d: bytes, sig: bytes) -> bool:
    """The pure-Python verdict of the suite's verify_batch on one lane."""
    from fisco_bcos_tpu_torch.crypto import refimpl

    size = 65 if kind == "ecdsa" else 128
    r, s = ((int.from_bytes(sig[:32], "big"), int.from_bytes(sig[32:64], "big"))
            if len(sig) >= size else (0, 0))
    if kind == "ecdsa":
        return refimpl.ecdsa_verify(refimpl.SECP256K1, _ints(pub), d, r, s)
    return refimpl.sm2_verify(_ints(pub), d, r, s)


def oracle_sender(kind: str, h: bytes, sig: bytes):
    """The pure-Python sender address of one tx lane, None if invalid."""
    from fisco_bcos_tpu_torch.crypto import refimpl

    if kind == "ecdsa":
        if len(sig) < 65:
            return None
        Q = refimpl.ecdsa_recover(refimpl.SECP256K1, h, int.from_bytes(sig[:32], "big"),
                                  int.from_bytes(sig[32:64], "big"), sig[64])
        if Q is None:
            return None
        return refimpl.keccak256(Q[0].to_bytes(32, "big") + Q[1].to_bytes(32, "big"))[12:]
    if len(sig) < 128 or not oracle_verify(kind, sig[64:128], h, sig):
        return None
    return refimpl.sm3(sig[64:128])[12:]


def sm2_sign_fixed_nonce(kp, k: int, kx: int, digest: bytes) -> bytes | None:
    """An SM2 signature r | s | pub under the nonce k (kx = x(k G)), reused
    across digests: a few products mod n instead of a point multiplication,
    so every tx of a 65,536-tx block can be signed on the host. Test
    traffic only: two signatures under one nonce reveal the key. None in
    the cases sm2_sign would retry with another nonce."""
    from fisco_bcos_tpu_torch.crypto import refimpl

    n = refimpl.SM2P256V1.n
    r = (int.from_bytes(digest, "big") + kx) % n
    s = pow(1 + kp.secret, -1, n) * (k - r * kp.secret) % n
    if r == 0 or r + k == n or s == 0:
        return None
    return r.to_bytes(32, "big") + s.to_bytes(32, "big") + kp.pub_bytes


def plain_tx_hashes(suite, txs) -> list[bytes]:
    """The suite's hash of each tx encoding by the plain PyTorch version."""
    from fisco_bcos_tpu_torch.ops import keccak, sm3

    mod, fn = ((keccak, keccak.keccak256_varlen_plain) if suite.kind == "ecdsa"
               else (sm3, sm3.sm3_varlen_plain))
    blocks, nvalid = mod.pad_batch_np([t.encode_unsigned() for t in txs])
    out = fn(torch.as_tensor(blocks, device=suite.device),
             torch.as_tensor(nvalid, device=suite.device))
    return [bytes(x) for x in out.cpu().numpy()]


def block_payloads():
    """The slice's NTX unsigned txs (seeded payloads of 64-1,024 bytes to
    seeded addresses) and NTX receipts, the same on either chain. Each tx
    carries block_limit 500, as a client sets it 500 blocks past the chain's
    height (here genesis): inside a txpool's default window of 600."""
    from fisco_bcos_tpu_torch.protocol import types as T

    nrng = np.random.default_rng(SEED + 1)
    lens = nrng.integers(64, 1025, NTX)
    txs = [T.Transaction(nonce=str(i), block_limit=500, to=nrng.bytes(20),
                         input=nrng.bytes(int(lens[i]))) for i in range(NTX)]
    receipts = [T.Receipt(gas_used=int(nrng.integers(21000, 10 ** 6)),
                          status=0, output=nrng.bytes(32), block_number=7)
                for _ in range(NTX)]
    return txs, receipts


def build_slice(suite, rng):
    """The slice's data on `suite`: a 65,536-tx block (seeded payloads,
    16 senders, 1% of lanes corrupted), 65,536 receipts, and a 16,384-lane
    seal span (256 headers x 4 sealers, tiled, 1% corrupted). The first
    1,024 txs are signed by the suite. On the default chain the rest tile
    those signatures: each still recovers some key, as a valid lane does.
    An SM2 signature carries its key and fails against another payload,
    so on the SM chain the rest are signed over their own payloads too
    (`sm2_sign_fixed_nonce`), and every lane is valid before corruption."""
    from fisco_bcos_tpu_torch.crypto import refimpl
    from fisco_bcos_tpu_torch.protocol import types as T

    c, kind = suite.params, suite.kind
    t0 = time.perf_counter()
    kps = [suite.generate_keypair(b"sender" + bytes([k])) for k in range(16)]
    txs, receipts = block_payloads()
    signed_hash = []
    for i in range(NSIGNED):
        txs[i].sign(suite, kps[i % 16])
        signed_hash.append(txs[i].hash(suite))
    if kind == "ecdsa":
        own = NSIGNED  # lanes signed over their own payload
        for i in range(NSIGNED, NTX):
            txs[i].signature = txs[i % NSIGNED].signature
    else:
        own = NTX
        nonces = [refimpl.keygen(c, seed=b"nonce" + bytes([k])) for k in range(16)]
        digests = plain_tx_hashes(suite, txs[NSIGNED:])
        for i, d in zip(range(NSIGNED, NTX), digests):
            k, (kx, _) = nonces[i % 16]
            sig = sm2_sign_fixed_nonce(kps[i % 16], k, kx, d)
            txs[i].signature = sig if sig is not None else suite.sign(kps[i % 16], d)
    # corrupt 1% of the lanes
    corrupt = {}
    for j, i in enumerate(rng.sample(range(NTX), NTX // 100)):
        other = kps[(i % NSIGNED + 1) % 16].pub_bytes
        txs[i].signature = corrupt_tx(kind, j, txs[i].signature, c, other)
        corrupt[i] = j
    for t in txs:
        object.__setattr__(t, "_hash", None)
        object.__setattr__(t, "_sender", None)
    block = T.Block(header=T.BlockHeader(number=7), transactions=txs,
                    receipts=receipts)
    # seals: 256 headers x 4 sealers, tiled to 16,384 lanes
    sealers = seal_keys(suite)
    headers = seal_headers(sealers)
    seal_d, seal_s, seal_p = [], [], []
    for hd in headers:
        d = hd.hash(suite)
        for k in sealers:
            seal_d.append(d)
            seal_s.append(suite.sign(k, d))
            seal_p.append(k.pub_bytes)
    dg = [seal_d[i % len(seal_d)] for i in range(NSEAL)]
    sg = [seal_s[i % len(seal_s)] for i in range(NSEAL)]
    pb = [seal_p[i % len(seal_p)] for i in range(NSEAL)]
    seal_bad = {}
    for j, i in enumerate(rng.sample(range(NSEAL), NSEAL // 100)):
        dg[i], sg[i], pb[i] = corrupt_seal(kind, j, dg[i], sg[i], pb[i], c,
                                           seal_p[(i + 1) % len(seal_p)])
        seal_bad[i] = j
    setup_s = time.perf_counter() - t0
    log(f"[slice {kind}] set-up (payloads, {NSIGNED + len(seal_s)} host signatures"
        f"{', ' + str(NTX - NSIGNED) + ' fixed-nonce SM2 signatures' if own > NSIGNED else ''}"
        f", corruption): {setup_s:.1f} s")
    return dict(kps=kps, txs=txs, signed_hash=signed_hash, own=own, corrupt=corrupt,
                receipts=receipts, block=block, seal_d=seal_d, seal_s=seal_s,
                seal_p=seal_p, dg=dg, sg=sg, pb=pb, seal_bad=seal_bad)


def seal_keys(suite):
    """The 4 sealers of the slice's seal span and of the node's genesis."""
    return [suite.generate_keypair(b"sealer" + bytes([k])) for k in range(4)]


def seal_headers(sealers, n: int = 256):
    """n headers tiling the slice's 256 sealed headers."""
    from fisco_bcos_tpu_torch.protocol import types as T

    return [T.BlockHeader(number=1000 + h % 256, timestamp=h % 256,
                          sealer_list=[k.pub_bytes for k in sealers])
            for h in range(n)]


def slice_counters(kind: str, route: str = "fused") -> dict:
    """The launch counters of the kernels on a suite's main path: on the
    composed EC route the fp, pow and ladder kernels take the fused EC
    kernel's place (whose counter is then expected to stay 0)."""
    from fisco_bcos_tpu_torch.ops import cuda_hash, cuda_merkle, cuda_sm3, cuda_verify

    if kind == "ecdsa":
        ec_k = {"ecdsa_recover": cuda_verify.ecdsa_recover,
                "ecdsa_verify": cuda_verify.ecdsa_verify}
        hashes = {"keccak256_varlen": cuda_hash.keccak256_varlen,
                  "merkle_keccak_tree": cuda_merkle.merkle_keccak_tree}
    else:
        ec_k = {"sm2_verify": cuda_verify.sm2_verify}
        hashes = {"sm3_varlen": cuda_sm3.sm3_varlen,
                  "merkle_sm3_tree": cuda_merkle.merkle_sm3_tree}
    if route == "fused":
        return {**ec_k, **hashes}
    return {**ec_k, **hashes, **composed_counters()}


# the kernels a counter counts, where they are more than `<counter>_kernel`:
# kernel G has one kernel a mode (csrc/fp.cu; the inverse's one-lane form
# its own), counted as one launch each
POW_KERNELS = {"window": "fp_pow_kernel", "inverse": "fp_pow_inv_kernel",
               "inverse one lane": "fp_pow_inv_var_kernel", "sqrt": "fp_pow_sqrt_kernel"}
KERNEL_NAMES = {"fp_pow": tuple(POW_KERNELS.values())}


def kernel_names(counter: str) -> tuple:
    return KERNEL_NAMES.get(counter, (counter + "_kernel",))


def composed_counters() -> dict:
    from fisco_bcos_tpu_torch.ops import cuda_ec, cuda_fp

    return {"ladder": cuda_ec.ladder, "fp_pow": cuda_fp.pow_const, **fp_counters()}


def phase_slice(dev, suite, data, rng, expect=None):
    """Drive the main path on `data` through the protocol entry points,
    with the suite's launch counters zeroed just before and read just
    after, then hold what came out to the oracle and the plain path.
    expect: counters whose launches must equal a number (0 for a kernel
    off the route); every other counter must have launched. -> (launches,
    phase walls, results: senders, ok mask, roots, seal verdicts)."""
    from fisco_bcos_tpu_torch.crypto import refimpl
    from fisco_bcos_tpu_torch.ops import keccak, merkle, sm3
    from fisco_bcos_tpu_torch.protocol import types as T

    kind = suite.kind
    tag = f"[slice {kind}{'' if suite.ec_route == 'fused' else ' ' + suite.ec_route}]"
    txs, receipts, block = data["txs"], data["receipts"], data["block"]
    dg, sg, pb, seal_bad = data["dg"], data["sg"], data["pb"], data["seal_bad"]
    corrupt, kps = data["corrupt"], data["kps"]
    host_hash = refimpl.keccak256 if kind == "ecdsa" else refimpl.sm3

    # -- the main path: counters zeroed just before, read just after --------
    # The profiler warms up on one small step through the same kernels,
    # whose events device_events leaves out: a session's first events can
    # go missing (seen in the second session of a process).
    counters = slice_counters(kind, suite.ec_route)
    expect = expect or {}
    phases = {}
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        suite.recover_addresses(dg[:8], sg[:8])
        suite.verify_batch(dg[:8], sg[:8], pb[:8])
        suite.merkle_root(data["signed_hash"][:17])
        torch.cuda.synchronize()
        with measured():
            for fn in counters.values():
                fn.launches = 0
            (senders, ok), phases["recover_senders"] = wall_ms(
                lambda: T.batch_recover_senders(txs, suite))
            txs_root, phases["txs_root"] = wall_ms(lambda: block.calculate_txs_root(suite))
            rc_root, phases["receipts_root"] = wall_ms(
                lambda: block.calculate_receipts_root(suite))
            seal_ok, phases["seal_verify"] = wall_ms(lambda: suite.verify_batch(dg, sg, pb))
            launches = {k: fn.launches for k, fn in counters.items()}
    # the device's own events (kernels, copies): a host op's device time
    # repeats its kernels', and the annotations span the whole step
    device_us, calls = device_events(prof, tag)
    total_ms = sum(phases.values())
    dev_ms = sum(device_us.values()) / 1e3
    log(f"{tag} launches on the main path: {launches}")
    for k, v in phases.items():
        log(f"{tag} {k}: {v:.1f} ms wall")
    if dev_ms:
        top = {k: (round(v, 1), calls[k])
               for k, v in sorted(device_us.items(), key=lambda kv: -kv[1])[:8]}
        log(f"{tag} device time {dev_ms:.1f} ms of {total_ms:.1f} ms wall "
            f"(host {total_ms - dev_ms:.1f} ms); largest by kernel (us, calls): {top}")
    else:
        log(f"{tag} device kernel time: not measured (profiler saw no kernels)")
    missing = [k for k, n in launches.items() if n == 0 and k not in expect]
    if missing:
        fail(f"{tag} the main path did not launch {missing}")
    off = {k: (launches[k], n) for k, n in expect.items() if launches[k] != n}
    if off:
        fail(f"{tag} launches (counted, expected) off the route's: {off}")
    seen = {k: sum(calls.get(n, 0) for n in kernel_names(k)) for k in launches}
    if seen != launches:
        fail(f"the profiler recorded kernel calls {seen}, the counters {launches}; "
             f"events: { {n: LAST_EVENTS.get(n) for k in launches for n in kernel_names(k)} }")
    log(f"{tag} device us by counter: " + ", ".join(
        f"{k} {sum(device_us.get(n, 0.0) for n in kernel_names(k)):.1f}" for k in launches))

    # -- checks ---------------------------------------------------------------
    hashes = [t._hash for t in txs]
    if hashes[:NSIGNED] != data["signed_hash"]:
        fail("tx hashes differ from the host oracle on the signed entries")
    if kind == "ecdsa":
        blocks, nvalid = keccak.pad_batch_np([t.encode_unsigned() for t in txs])
        plain = keccak.keccak256_varlen_plain(torch.as_tensor(blocks, device=dev),
                                              torch.as_tensor(nvalid, device=dev))
    else:
        blocks, nvalid = sm3.pad_batch_np([t.encode_unsigned() for t in txs])
        plain = sm3.sm3_varlen_plain(torch.as_tensor(blocks, device=dev),
                                     torch.as_tensor(nvalid, device=dev))
    if [bytes(x) for x in plain.cpu().numpy()] != hashes:
        fail("tx hashes differ from the plain path")
    bad, own = 0, data["own"]
    for i in range(own):
        want = kps[i % 16].address if i not in corrupt else None
        if want is not None and (senders[i] != want or not ok[i]):
            bad += 1
    checked = set(range(own)) | set(corrupt)
    sample = rng.sample([i for i in range(NSIGNED, NTX) if i not in corrupt], 64)
    # the oracle's verdicts are kept on `data`: a second run over the same
    # block (the composed route) is held to the same, not recomputed
    oracle = data.setdefault("oracle", {})
    for i in sorted(set(corrupt) | set(sample)):
        if ("sender", i) not in oracle:
            oracle["sender", i] = oracle_sender(kind, hashes[i], txs[i].signature)
        want = oracle["sender", i]
        if senders[i] != want or bool(ok[i]) != (want is not None):
            bad += 1
    if bad:
        fail(f"{bad} sender lanes differ from the host oracle")
    log(f"{tag} senders: {len(checked)} lanes held to their signers' addresses or "
        f"the oracle ({own} signed over their own payload, {len(corrupt)} corrupted), "
        f"{len(sample)} sampled past the first {NSIGNED} held to the oracle, "
        f"{int(ok.sum())} of {NTX} valid")
    alg = suite.hash_name
    leaves = torch.as_tensor(np.frombuffer(bytearray(b"".join(hashes)), np.uint8)
                             .reshape(NTX, 32), device=dev)
    if bytes(merkle.merkle_root_bucketed_plain(leaves, NTX, alg).cpu().numpy()) != txs_root:
        fail("txs root differs from the plain path")
    rleaves = torch.as_tensor(np.frombuffer(bytearray(b"".join(r._hash for r in receipts)),
                                            np.uint8).reshape(NTX, 32), device=dev)
    if bytes(merkle.merkle_root_bucketed_plain(rleaves, NTX, alg).cpu().numpy()) != rc_root:
        fail("receipts root differs from the plain path")
    for i in rng.sample(range(NTX), 16):
        if receipts[i]._hash != host_hash(receipts[i].encode()):
            fail("receipt hash differs from the host oracle")
    sub = [bytes(x) for x in hashes[:4096]]
    if suite.merkle_root(sub) != merkle.merkle_levels_host(sub, alg)[-1][0]:
        fail("4096-leaf root differs from merkle_levels_host")
    bad = 0
    for i in range(NSEAL):
        if i in seal_bad:
            if ("seal", i) not in oracle:
                oracle["seal", i] = oracle_verify(kind, pb[i], dg[i], sg[i])
            want = oracle["seal", i]
        else:
            want = True  # a signature the oracle made, over its own digest
        bad += bool(seal_ok[i]) != want
    seal_d, seal_s, seal_p = data["seal_d"], data["seal_s"], data["seal_p"]
    for i in rng.sample(range(len(seal_d)), 32):
        if not oracle_verify(kind, seal_p[i], seal_d[i], seal_s[i]):
            fail("oracle rejects its own seal")
    if bad:
        fail(f"{bad} seal lanes differ from the host oracle")
    log(f"{tag} seals: {NSEAL} lanes, {len(seal_bad)} corrupted, "
        f"{int(seal_ok.sum())} accepted; all agree with the oracle")
    log(f"{tag} txs root {txs_root.hex()} receipts root {rc_root.hex()}")
    results = dict(senders=senders, ok=np.asarray(ok), txs_root=txs_root,
                   receipts_root=rc_root, seal_ok=np.asarray(seal_ok))
    log(f"{tag} results digest {results_digest(results)}")
    return launches, phases, results


def results_digest(results: dict) -> str:
    """SHA-256 of a slice's outputs (every sender, the ok mask, both roots,
    every seal verdict), so that runs of two trees compare by one line."""
    import hashlib

    h = hashlib.sha256()
    for s in results["senders"]:
        h.update(b"-" if s is None else bytes(s))
    h.update(np.asarray(results["ok"], dtype=np.uint8).tobytes())
    h.update(results["txs_root"] + results["receipts_root"])
    h.update(np.asarray(results["seal_ok"], dtype=np.uint8).tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# the ZK plane: standalone field multiplies and batched Poseidon
# ---------------------------------------------------------------------------
# A Montgomery product (CIOS) is 2 x 64 + 8 wide multiplies, a product mod
# secp256k1's p 64 + 8 (FN_MUL, FP_MUL above). Each lane moves int64 limbs:
# 16 x 8 bytes per operand read and per result written.
LANE_BYTES = 16 * 8


def fp_bound(lanes: int, vectors: int, products: int, column: bool = False):
    """Bound of `lanes` products moving `vectors` [16]-limb int64 vectors a
    lane (a [16, 1] column read once more when column=True)."""
    nbytes = lanes * vectors * LANE_BYTES + (LANE_BYTES if column else 0)
    bytes_ms = nbytes / H100_BYTES * 1e3
    ops_ms = ec_bound_ms(lanes * products)
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def fp_fields():
    from fisco_bcos_tpu_torch.crypto import refimpl
    from fisco_bcos_tpu_torch.ops import fp
    from fisco_bcos_tpu_torch.zk import poseidon

    return {"bn254_r": fp.MontField(poseidon.P, "bn254r"),
            "secp256k1_n": fp.MontField(refimpl.SECP256K1.n),
            "sm2_p": fp.MontField(refimpl.SM2P256V1.p),
            "sm2_n": fp.MontField(refimpl.SM2P256V1.n),
            "secp256k1_p": fp.SolinasField(refimpl.SECP256K1.p)}


def fp_lanes(nrng, n: int, B: int, dev, loose: bool = False) -> torch.Tensor:
    """[16, B] int64 limbs of seeded values below n (a top limb below n's),
    lanes 0-3 the edges 0, 1, n - 1 and R mod n; loose=True puts every
    eighth lane in [2n, 2^256) (the to_rep operand when 2n < 2^256)."""
    from fisco_bcos_tpu_torch.ops import bigint

    limbs = nrng.integers(0, 1 << 16, (16, B), dtype=np.int64)
    limbs[15] = nrng.integers(0, n >> 240, B)
    if loose:
        lo = (2 * n >> 240) + 1
        limbs[15, 7::8] = nrng.integers(min(lo, 0xFFFF), 1 << 16, len(range(7, B, 8)))
    for j, v in enumerate((0, 1, n - 1, (1 << 256) % n)):
        limbs[:, j] = bigint.to_limbs(v)
    return torch.as_tensor(limbs, device=dev)


def phase_fp_kernels(dev):
    """Kernels D, E, F against the field's mul_plain on the card at the
    Poseidon path's shapes over five fields, bit-exact. `ms` is the
    kernel's device time on BN254 r, the Poseidon field
    (kernel_device_ms); `call_ms`, CUDA events around one call, adds the
    host's launch through the wrapper and is logged for every field."""
    from fisco_bcos_tpu_torch.ops import cuda_fp

    nrng = np.random.default_rng(SEED + 3)
    B = FP_B
    mism = {"fp_mul": 0, "fp_mul_const": 0, "fp_mul_stacked": 0}
    err = dict.fromkeys(mism, 0)
    t, calls, plain, loose_lanes = {}, {}, {}, 0
    for name, f in fp_fields().items():
        n = f.n_int
        loose = name == "bn254_r"
        a = fp_lanes(nrng, n, B, dev, loose=loose)
        b = fp_lanes(nrng, n, B, dev)
        c = b[:, 5:6].contiguous()
        a9 = torch.stack([a] + [fp_lanes(nrng, n, B, dev, loose=loose) for _ in range(8)])
        b9 = torch.stack([fp_lanes(nrng, n, B, dev) for _ in range(9)])
        a3, b3 = a9[:3].contiguous(), b9[:3].contiguous()
        if loose:
            hi = a[15] > (2 * n >> 240)
            loose_lanes = int(hi.sum())
        cases = {"fp_mul": (cuda_fp.mul, a, b), "fp_mul_const": (cuda_fp.mul_const, a, c),
                 "fp_mul_stacked": (cuda_fp.mul_stacked, a9, b9),
                 "fp_mul_stacked_k3": (cuda_fp.mul_stacked, a3, b3)}
        for k, (fn, x, y) in cases.items():
            got = fn(f, x, y)
            want, pms = wall_ms(lambda: f.mul_plain(x, y))
            row = k.replace("_k3", "")
            bad = (got != want).any(-2)
            mism[row] += int(bad.sum())
            err[row] = max(err[row], int((got - want).abs().max()))
            calls[name, k] = cuda_ms(lambda: fn(f, x, y), 20)
            plain[name, k] = pms
            if loose:
                t[k] = kernel_device_ms(lambda: fn(f, x, y), f"fp_{fn.__name__}_kernel")
        log(f"[fp] {name} (B={B}), ms a call by CUDA events: " + ", ".join(
            f"{k[3:]} {calls[name, k]:.4f}" for k in cases) + f"; mismatched lanes so far {mism}")
        del a9, b9, a3, b3
    log(f"[fp] BN254 r loose lanes in [2r, 2^256): {loose_lanes}")
    if any(mism.values()):
        fail(f"fp kernel vs plain mismatches: {mism}")
    log("[fp] bn254_r device ms, L2 evicted before each call: " + ", ".join(
        f"{k[3:]} {v:.4f}" for k, v in t.items()))
    pl = {k: plain["bn254_r", k] for k in t}
    cl = {k: calls["bn254_r", k] for k in t}
    rows = {}
    spec = {"fp_mul": ("pallas_fp.py:192", fp_bound(B, 3, FN_MUL), f"[16, {B}] x [16, {B}]"),
            "fp_mul_const": ("pallas_fp.py:232", fp_bound(B, 2, FN_MUL, column=True),
                             f"[16, {B}] x [16, 1]"),
            "fp_mul_stacked": ("pallas_fp.py:269", fp_bound(9 * B, 3, FN_MUL),
                               f"[9, 16, {B}] x [9, 16, {B}] (K=3: {t['fp_mul_stacked_k3']:.4f} ms, "
                               f"bound {fp_bound(3 * B, 3, FN_MUL)[0]:.4f} ms, plain "
                               f"{pl['fp_mul_stacked_k3']:.1f} ms)")}
    for k, (line, (bound, by), shape) in spec.items():
        rows[k] = dict(
            name=k, route="cuda", source="fisco_bcos_tpu_torch/csrc/fp.cu",
            replaces=f"fisco_bcos_tpu/ops/{line}", mismatches=mism[k], max_abs_err=err[k],
            ms=t[k], call_ms=cl[k], plain_ms=pl[k], bound_ms=bound, bound_by=by,
            library_ms=None,
            shape=f"{shape}, BN254 r; bit-exact on 5 fields",
            call_ms_by_field={name: calls[name, k] for name in fp_fields()})
        log(f"[kernel] {k}: {t[k]:.4f} ms device, {cl[k]:.4f} ms a call (plain {pl[k]:.1f} ms), "
            f"bound {bound:.4f} ms ({by})")
    return rows


def fp_counters() -> dict:
    from fisco_bcos_tpu_torch.ops import cuda_fp

    return {"fp_mul": cuda_fp.mul, "fp_mul_stacked": cuda_fp.mul_stacked,
            "fp_mul_const": cuda_fp.mul_const}


def poseidon_data():
    """65,536 seeded pairs with the edge pairs first, 65,536 seeded leaves."""
    from fisco_bcos_tpu_torch.zk import poseidon

    nrng = np.random.default_rng(SEED + 4)
    flat = nrng.bytes(32 * 2 * NPAIRS)
    vals = [flat[32 * i:32 * (i + 1)] for i in range(2 * NPAIRS)]
    lefts, rights = vals[:NPAIRS], vals[NPAIRS:]
    r = poseidon.P
    rm1, r0, rp1 = ((r + d).to_bytes(32, "big") for d in (-1, 0, 1))
    z, ones = bytes(32), b"\xff" * 32
    edges = [(z, ones), (ones, z), (z, z), (ones, ones), (rm1, r0), (r0, rp1), (rp1, rm1)]
    for i, (a, b) in enumerate(edges):
        lefts[i], rights[i] = a, b
    flat = nrng.bytes(32 * NLEAVES)
    leaves = [flat[32 * i:32 * (i + 1)] for i in range(NLEAVES)]
    return lefts, rights, leaves, len(edges)


def _flip(b: bytes) -> bytes:
    return bytes([b[0] ^ 1]) + b[1:]


def tampered_proofs(zm, levels, leaves, rng):
    """8 proofs that must fail: 3 with the leaf flipped, 3 with a sibling
    flipped at some level, 2 with the root flipped."""
    root = levels[-1][0]
    out = []
    for j in range(8):
        i = rng.randrange(len(leaves))
        proof = zm.proof_from_levels(levels, i)
        if j < 3:
            out.append((_flip(leaves[i]), proof, root))
        elif j < 6:
            k = rng.randrange(len(proof))
            left, right, pos = proof[k]
            proof[k] = (_flip(left), right, pos) if pos else (left, _flip(right), pos)
            out.append((leaves[i], proof, root))
        else:
            out.append((leaves[i], proof, _flip(root)))
    return out


def phase_poseidon(dev, suite, rng):
    """The ZK plane's slice: counters zeroed before each step and read
    after, then every result held to the plain path and the oracle."""
    from torch.profiler import ProfilerActivity, profile

    from fisco_bcos_tpu_torch.zk import merkle as zm
    from fisco_bcos_tpu_torch.zk import poseidon, poseidon_torch as pt

    tag = "[poseidon]"
    t0 = time.perf_counter()
    lefts, rights, leaves, nedge = poseidon_data()
    above = sum(int.from_bytes(v, "big") >= poseidon.P for v in lefts + rights)
    log(f"{tag} set-up: {NPAIRS} pairs ({above} of {2 * NPAIRS} values above r), "
        f"{NLEAVES} leaves: {time.perf_counter() - t0:.1f} s")
    counters = fp_counters()
    others = {**slice_counters("ecdsa"), **slice_counters("sm")}
    others_before = {k: fn.launches for k, fn in others.items()}
    per_chunk = {f"fp_{k}": v for k, v in pt.LAUNCHES_PER_CHUNK.items()}
    chunks = lambda n: -(-n // pt.CHUNK)  # noqa: E731
    steps, launches, totals = {}, {}, dict.fromkeys(counters, 0)

    def step(name, fn, nchunks):
        for c in counters.values():
            c.launches = 0
        out, steps[name] = wall_ms(fn)
        got = {k: c.launches for k, c in counters.items()}
        launches[name] = got
        want = {k: per_chunk[k] * nchunks for k in counters}
        if got != want:
            fail(f"{name}: fp launches {got}, expected {want} ({nchunks} chunk calls)")
        for k in totals:
            totals[k] += got[k]
        return out

    # -- the main path -----------------------------------------------------
    # The profiler warms up on a small step and counts the 65,536-pair
    # step only: the tree's 16 calls would hold ~250k events.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        suite.poseidon_batch(lefts[:128], rights[:128])
        torch.cuda.synchronize()
        with measured():
            digests = step("poseidon_batch", lambda: suite.poseidon_batch(lefts, rights),
                           chunks(NPAIRS))
    pairs_per_level, m = [], NLEAVES
    while m > 1:
        pairs_per_level.append((m + 1) // 2)
        m = (m + 1) // 2
    levels = step("tree_build", lambda: zm.build_levels(leaves, hasher=suite.poseidon_batch),
                  sum(chunks(p) for p in pairs_per_level))
    root = levels[-1][0]
    idx = rng.sample(range(NLEAVES), NPROOFS)
    items = [(leaves[i], zm.proof_from_levels(levels, i), root) for i in idx]
    ok = step("proof_verify", lambda: zm.verify_batch(items, hasher=suite.poseidon_batch),
              chunks(NPROOFS * len(pairs_per_level)))
    bad_items = tampered_proofs(zm, levels, leaves, rng)
    bad_ok = step("proof_verify_tampered",
                  lambda: zm.verify_batch(bad_items, hasher=suite.poseidon_batch),
                  chunks(len(bad_items) * len(pairs_per_level)))
    moved = {k: fn.launches - others_before[k] for k, fn in others.items()
             if fn.launches != others_before[k]}
    if moved:
        fail(f"{tag} kernels off the Poseidon path launched: {moved}")

    device_us, calls = device_events(prof, tag)
    seen = {k: calls.get(k + "_kernel", 0) for k in counters}
    if seen != launches["poseidon_batch"]:
        fail(f"{tag} the profiler recorded fp kernel calls {seen}, the counters "
             f"{launches['poseidon_batch']}; fp_mul_const events: "
             f"{LAST_EVENTS.get('fp_mul_const_kernel')}")
    fp_us = sum(device_us.get(k + "_kernel", 0) for k in counters)
    dev_ms = sum(device_us.values()) / 1e3
    other_calls = sum(c for k, c in calls.items() if not k.endswith("_kernel")
                      or k[:-7] not in counters)
    wall = steps["poseidon_batch"]
    top = {k: (round(v / 1e3, 2), calls[k])
           for k, v in sorted(device_us.items(), key=lambda kv: -kv[1])[:8]}
    log(f"{tag} launches per step: {launches}")
    log(f"{tag} poseidon_batch {NPAIRS} pairs: {wall:.1f} ms wall, "
        f"{NPAIRS / wall * 1e3:.0f} pairs/s; device {dev_ms:.1f} ms "
        f"({dev_ms / wall:.1%} of wall): fp kernels {fp_us / 1e3:.1f} ms "
        f"({sum(launches['poseidon_batch'].values())} launches), everything else "
        f"{dev_ms - fp_us / 1e3:.1f} ms ({other_calls} device events); "
        f"largest (ms, calls): {top}")
    log(f"{tag} tree {NLEAVES} leaves: {steps['tree_build']:.1f} ms wall, "
        f"{NLEAVES / steps['tree_build'] * 1e3:.0f} leaves/s, {len(pairs_per_level)} level calls")
    log(f"{tag} verify {NPROOFS} proofs ({NPROOFS * len(pairs_per_level)} pairs): "
        f"{steps['proof_verify']:.1f} ms wall; 8 tampered: {steps['proof_verify_tampered']:.1f} ms")

    # -- checks --------------------------------------------------------------
    t0 = time.perf_counter()
    plain, pms = wall_ms(lambda: pt.hash2_batch(lefts, rights, device=dev, plain=True))
    bad = sum(a != b for a, b in zip(digests, plain))
    if bad:
        fail(f"{tag} {bad} of {NPAIRS} digests differ from the plain path")
    host = poseidon.hash2_batch_host(lefts[:1024], rights[:1024])
    if digests[:1024] != host:
        fail(f"{tag} digests differ from the oracle on the first 1,024 lanes "
             f"({nedge} edge pairs among them)")
    plain_levels = zm.build_levels(
        leaves, hasher=lambda a, b: pt.hash2_batch(a, b, device=dev, plain=True))
    if plain_levels[-1][0] != root:
        fail(f"{tag} the {NLEAVES}-leaf root differs from the plain path's")
    small = leaves[:POSEIDON_ORACLE_LEAVES]
    if zm.root(small, hasher=suite.poseidon_batch) != zm.root(small):
        fail(f"{tag} the {len(small)}-leaf root differs from the oracle's")
    if not ok.all() or len(ok) != NPROOFS:
        fail(f"{tag} {int((~ok).sum())} of {NPROOFS} proofs failed")
    if bad_ok.any():
        fail(f"{tag} {int(bad_ok.sum())} tampered proofs verified")
    log(f"{tag} checks: {NPAIRS} digests = plain path ({pms:.0f} ms), "
        f"1,024 = oracle, roots = plain and oracle, {NPROOFS} proofs true, 8 tampered "
        f"false ({time.perf_counter() - t0:.1f} s); root {root.hex()}")
    return totals, steps


# ---------------------------------------------------------------------------
# the composed EC route: kernels G (pow) and H (ladder), then both blocks
# ---------------------------------------------------------------------------
# Products a ladder needs: a window table entry past 2Q adds Q (Z = 1), a
# mixed add; each step 4 doublings; a G entry (Z = 1) a mixed add, a Q
# entry a full add (a mixed one for entry 1).
DBL = {"secp256k1": SECP_DBL, "sm2p256v1": SM2_DBL_OPS}


def pow_cases():
    """Kernel G's fields and exponents, with each product's wide-multiply
    slots: every field's inverse (m - 2, the roots of the composed route's
    batched inversions), the square root on secp256k1's p ((p+1)/4,
    recovery's), and m - 3, a window-loop exponent as long as m - 2."""
    from fisco_bcos_tpu_torch.crypto import refimpl
    from fisco_bcos_tpu_torch.ops import fp

    c, m = refimpl.SECP256K1, refimpl.SM2P256V1
    fields = [("secp256k1_p", fp.SolinasField(c.p), FP_MUL),
              ("secp256k1_n", fp.MontField(c.n), FN_MUL),
              ("sm2_n", fp.MontField(m.n), FN_MUL),
              ("sm2_p", fp.MontField(m.p), sm2_fp_mul())]
    cases = []
    for name, f, slots in fields:
        n = f.n_int
        cases.append((name, f, n - 2, slots))
        if name == "secp256k1_p":
            cases.append((name, f, (n + 1) // 4, slots))
        cases.append((name, f, n - 3, slots))
    return cases


# Kernel G's bound by mode, in wide-multiply slots a launch of B lanes,
# a squaring at `slots - SQR_SAVING` (the same reduction, a 36-multiply
# product) and a multiply at `slots`: the window loop's (`_pow_ops`); the
# square root's chain of 253 squarings and 13 multiplies; an inverse
# priced as the EC bounds price batched inversions (`ec_batch_inversions`):
# INV_LANE products a lane and one Fermat power a launch, as if the
# launch's lanes shared one inversion by Montgomery's trick.
def pow_bound(mode: str, e: int, B: int, slots: float):
    sqr, mul = _pow_ops(e)
    if mode == "sqrt":
        sqr, mul = SQRT_SQR, SQRT_MUL
    work = priced(sqr + mul, sqr, slots)
    work = INV_LANE * B * slots + work if mode == "inverse" else work * B
    ops_ms = ec_bound_ms(work)
    bytes_ms = B * 2 * LANE_BYTES / H100_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def phase_pow_kernel(dev):
    """(8) Kernel G in every mode (ops/cuda_fp.pow_mode) against the plain
    window loop (a field built without kernels) on the card, bit-exact, at
    [16, EC_B] and [16, 1] on four fields, lanes 0-3 the edges 0, 1, n - 1
    and R mod n, the one-lane launches on n - 1 and on 0. Device time of
    every case at both widths (kernel_device_ms, by the mode's kernel);
    `ms` is the square root at [16, EC_B], the composed route's 16,384-lane
    launch, and `one_lane_ms` each mode's [16, 1] time on secp256k1's n
    (the inverse: recovery's and verify's r^-1 and s^-1 roots) or p."""
    from fisco_bcos_tpu_torch.ops import cuda_fp, fp

    nrng = np.random.default_rng(SEED + 5)
    mism, err, times = 0, 0, {}
    for name, f, e, slots in pow_cases():
        mode = cuda_fp.pow_mode(f, e)
        kname, kname1 = POW_KERNELS[mode], POW_KERNELS.get(mode + " one lane", POW_KERNELS[mode])
        a = fp_lanes(nrng, f.n_int, EC_B, dev)
        ones = {"n-1": a[:, 2:3].contiguous(), "0": a[:, 0:1].contiguous()}
        got = cuda_fp.pow_const(f, a, e)
        want, pms = wall_ms(lambda: f.pow_const(a, e))
        bad = int((got != want).any(0).sum())
        err = max(err, int((got - want).abs().max()))
        for j, x in zip((2, 0), ones.values()):
            g1 = cuda_fp.pow_const(f, x, e)
            bad += int((g1 != want[:, j:j + 1]).any())
            err = max(err, int((g1 - want[:, j:j + 1]).abs().max()))
        mism += bad
        ms = kernel_device_ms(lambda: cuda_fp.pow_const(f, a, e), kname)
        ms1 = kernel_device_ms(lambda: cuda_fp.pow_const(f, ones["n-1"], e), kname1)
        bound, by = pow_bound(mode, e, EC_B, slots)
        bound1, _ = pow_bound(mode, e, 1, slots)
        times[name, mode] = dict(ms=ms, one_lane_ms=ms1, plain_ms=pms, bound_ms=bound,
                                 bound_by=by, one_lane_bound_ms=bound1)
        log(f"[pow] {name} {mode} ({len(fp.msb_digits(e))} digits): mismatched lanes {bad}; "
            f"[16, {EC_B}] {ms:.4f} ms device (plain {pms:.1f} ms), bound {bound:.4f} ms "
            f"({by}); [16, 1] {ms1:.4f} ms device")
    if mism:
        fail(f"pow kernel vs plain mismatches: {mism}")
    sq = times["secp256k1_p", "sqrt"]
    one_lane = {"inverse": times["secp256k1_n", "inverse"]["one_lane_ms"],
                "inverse_p": times["secp256k1_p", "inverse"]["one_lane_ms"],
                "sqrt": sq["one_lane_ms"],
                "window": times["secp256k1_p", "window"]["one_lane_ms"]}
    row = dict(
        name="fp_pow", route="cuda", source="fisco_bcos_tpu_torch/csrc/fp.cu",
        replaces="fisco_bcos_tpu/ops/pallas_fp.py:345", mismatches=mism, max_abs_err=err,
        ms=sq["ms"], one_lane_ms=one_lane, plain_ms=sq["plain_ms"], bound_ms=sq["bound_ms"],
        bound_by=sq["bound_by"], library_ms=None,
        modes={f"{k[0]} {k[1]}": v for k, v in times.items()},
        shape=f"[16, {EC_B}], square-root mode on secp256k1 p (its chain: 253 squarings, "
              f"13 products); "
              f"inverse and window modes in `modes`; bit-exact on 4 fields and at [16, 1]")
    log(f"[kernel] fp_pow: sqrt {sq['ms']:.4f} ms device at [16, {EC_B}], bound "
        f"{sq['bound_ms']:.4f} ms; one lane: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                                            one_lane.items()) + " ms")
    return {"fp_pow": row}


def ladder_scalars(c, nrng, B: int):
    """B lanes of canonical scalars k1, k2 and affine keys Q (64 seeded
    keys, tiled), lanes 0-8 the port's edge lanes (ec.LADDER_EDGES), lanes
    9-12 carry-stress lanes: scalars n - 1, n - 2 and 2^256 - 1 mod n
    against the point whose x is the largest below p - 1 and its
    negation."""
    from fisco_bcos_tpu_torch.crypto import refimpl
    from fisco_bcos_tpu_torch.ops import ec

    keys = [refimpl.keygen(c, seed=b"ladder" + bytes([i]))[1] for i in range(64)]
    flat = nrng.bytes(64 * B)
    k1 = [int.from_bytes(flat[64 * i:64 * i + 32], "big") % c.n for i in range(B)]
    k2 = [int.from_bytes(flat[64 * i + 32:64 * i + 64], "big") % c.n for i in range(B)]
    qx, qy = [keys[i % 64][0] for i in range(B)], [keys[i % 64][1] for i in range(B)]
    k1, k2, qx, qy = ec.ladder_edge_lanes(c, k1, k2, qx, qy)
    tx, ty = key_near_top(c)
    top = ((1 << 256) - 1) % c.n
    for j, (a, b, y) in enumerate(((c.n - 1, c.n - 1, ty), (c.n - 2, 1, c.p - ty),
                                   (top, c.n - 1, ty), (1, top, c.p - ty))):
        k1[9 + j], k2[9 + j], qx[9 + j], qy[9 + j] = a, b, tx, y
    return k1, k2, qx, qy


def ladder_case(cv, nrng, dev):
    """Kernel H's operands at EC_B lanes on `dev` (ladder_scalars' lanes,
    the sign flags of every fourth lane from 9 flipped at random) and the
    scalars and keys they came from: -> ((nsteps, gts, digs, negs, q
    planes), (k1, k2, qx, qy))."""
    from fisco_bcos_tpu_torch.ops import ec

    c, f = cv.params, cv.fp
    k1, k2, qx, qy = ladder_scalars(c, nrng, EC_B)
    nsteps, gts, digs, negs, qp = ec.ladder_inputs(
        cv, lane(k1, dev), lane(k2, dev), f.to_rep(lane(qx, dev)), f.to_rep(lane(qy, dev)))
    flip = torch.zeros_like(negs)
    flip[:, 9::4] = torch.as_tensor(nrng.integers(0, 2, flip[:, 9::4].shape),
                                    dtype=flip.dtype, device=dev)
    return (nsteps, gts, digs, negs ^ flip, qp), (k1, k2, qx, qy)


# the lane sweep: the main path's 16,384 lanes, tiled 4 and 8 times
SWEEP_B = (EC_B, 4 * EC_B, 8 * EC_B)


def lane_sweep(make) -> dict:
    """ms of one launch (median of 5 CUDA-event timings) at each B of
    SWEEP_B; make(k) -> a function launching the 16,384-lane inputs tiled
    k times."""
    return {k * EC_B: cuda_ms(make(k), 5) for k in (B // EC_B for B in SWEEP_B)}


def sweep_line(name: str, sweep: dict) -> str:
    return f"[kernel] sweep {name}: " + ", ".join(
        f"B={B} {ms:.3f} ms ({ms * 1e6 / B:.1f} ns a lane)" for B, ms in sweep.items())


def ladder_products(cv, nsteps: int, digs, skip: int, k: int = 0) -> int:
    """Products mod p (k = 0; the squarings among them, k = 1) that a
    ladder launch needs for these digits, over lanes skip.. (the edge lanes
    before `skip` are counted at none, since their cancellations leave the
    accumulator at infinity): per pair the
    window table up to its largest Q digit m (2Q a doubling, then m - 2
    mixed adds); from a lane's first nonzero digit on, whose add is a copy
    onto infinity, 4 doublings a step and an add per nonzero digit."""
    n_pairs, dbl = digs.shape[0] // 2, DBL[cv.params.name][k]
    madd, jadd = MADD[k], JADD[k]
    d = digs[:, :, skip:].long()
    m = d[1::2].amax(1)
    table = int(torch.where(m >= 2, dbl + (m - 2) * madd, 0).sum())
    cost = torch.where(d == 0, 0, madd)
    cost[1::2] = torch.where(d[1::2] >= 2, jadd, cost[1::2])
    seq = cost.transpose(0, 1).reshape(nsteps * 2 * n_pairs, -1)  # add order
    nz = seq != 0
    first = nz.int().argmax(0)
    live = nz.any(0)
    adds = seq.sum(0) - seq.gather(0, first[None])[0]
    dbls = torch.where(live, 4 * (nsteps - 1 - first // (2 * n_pairs)), 0) * dbl
    return table + int((adds + dbls).sum())


def phase_ladder_kernel(dev, rng):
    """(9) Kernel H against ladder_plain on the card at EC_B lanes in both
    forms (GLV on secp256k1, plain Shamir on SM2), Jacobian bit-exact, on
    ladder_scalars' lanes with the sign flags of every fourth lane from 9
    flipped; 32 on-curve lanes with their own flags held to the oracle
    k1 G + k2 Q, the edge lanes among them."""
    from fisco_bcos_tpu_torch.crypto import refimpl
    from fisco_bcos_tpu_torch.ops import bigint, cuda_ec, ec

    nrng = np.random.default_rng(SEED + 6)
    rows, mism, err = {}, 0, 0
    times = {}
    for cv in (ec.SECP256K1, ec.SM2P256V1):
        c, f = cv.params, cv.fp
        (nsteps, gts, digs, negs, qp), (k1, k2, qx, qy) = ladder_case(cv, nrng, dev)
        got = cuda_ec.ladder(cv, nsteps, gts, digs, negs, qp)
        want, pms = wall_ms(lambda: ec.ladder_plain(cv, nsteps, gts, digs, negs, qp))
        bad = int((got != want).any(0).any(0).sum())
        mism += bad
        err = max(err, int((got - want).abs().max()))
        # the oracle on on-curve lanes whose flags are the split's own
        X, Y, Z = (f.from_rep(got[i]).cpu() for i in range(3))
        oracle_bad = 0
        for i in [3, 4, 6, 7, 8] + list(range(10, EC_B, 4))[:27]:
            want_pt = refimpl.ec_add(c, refimpl.ec_mul(c, k1[i], (c.gx, c.gy)),
                                     refimpl.ec_mul(c, k2[i], (qx[i], qy[i])))
            z = bigint.from_limbs(Z[:, i].numpy())
            if z == 0:
                oracle_bad += want_pt is not None
                continue
            zi = pow(z, -1, c.p)
            pt = (bigint.from_limbs(X[:, i].numpy()) * zi * zi % c.p,
                  bigint.from_limbs(Y[:, i].numpy()) * zi ** 3 % c.p)
            oracle_bad += pt != want_pt
        mism += oracle_bad
        ms = cuda_ms(lambda: cuda_ec.ladder(cv, nsteps, gts, digs, negs, qp), 5)
        sweep = lane_sweep(lambda k: (
            lambda a=(digs.repeat(1, 1, k), negs.repeat(1, k), qp.repeat(1, 1, 1, k)):
            cuda_ec.ladder(cv, nsteps, gts, *a)))
        log(sweep_line(f"ladder {c.name}", sweep))
        skip = len(ec.LADDER_EDGES)
        prods = ladder_products(cv, nsteps, digs, skip)
        sqrs = ladder_products(cv, nsteps, digs, skip, k=1)
        bound = ec_bound_ms(priced(prods, sqrs, FP_MUL if cv.has_endo else sm2_fp_mul()))
        times[c.name] = dict(ms=ms, plain_ms=pms, bound_ms=bound, products=prods, sweep=sweep)
        form = "GLV, 2 pairs" if cv.has_endo else "plain, 1 pair"
        log(f"[kernel] ladder {c.name} ({form}, {nsteps} steps) B={EC_B}: mismatched lanes "
            f"{bad}, oracle misses {oracle_bad} of 32, {ms:.3f} ms (plain {pms:.0f} ms), "
            f"bound {bound:.4f} ms ({prods / (EC_B - skip):.0f} products a lane), "
            f"infinity lanes {int((want[2] == 0).all(0).sum())}")
    if mism:
        fail(f"ladder kernel vs plain or oracle mismatches: {mism}")
    g, m = times["secp256k1"], times["sm2p256v1"]
    rows["ladder"] = dict(
        name="ladder", route="cuda", source="fisco_bcos_tpu_torch/csrc/ladder.cu",
        replaces="fisco_bcos_tpu/ops/pallas_ec.py:310", mismatches=0, max_abs_err=err,
        ms=g["ms"], plain_ms=g["plain_ms"], bound_ms=g["bound_ms"], bound_by="operations",
        library_ms=None, sm2_ms=m["ms"], sm2_plain_ms=m["plain_ms"],
        sm2_bound_ms=m["bound_ms"], sweep_ms=g["sweep"], sm2_sweep_ms=m["sweep"],
        shape=f"B={EC_B}, GLV form on secp256k1 (SM2 plain form: {m['ms']:.3f} ms, "
              f"bound {m['bound_ms']:.4f} ms)")
    return rows


def reset_caches(data) -> None:
    """Drop the hashes and senders phase_slice cached on the block, so a
    second run computes them again."""
    for t in data["txs"]:
        object.__setattr__(t, "_hash", None)
        object.__setattr__(t, "_sender", None)
    for r in data["receipts"]:
        r._hash = None


def phase_composed(dev, kind: str, data, fused: dict, rng):
    """(10) The composed EC route's slice: the same block and seal span
    through make_suite(..., ec_route="composed") by phase_slice, whose
    results must be identical to the fused route's. Launches: one ladder
    a chunk call; pow 3 a recovery chunk (square root, two inversion
    roots), 1 a secp256k1 verify chunk, 0 on the SM chain; the fused EC
    kernels' counters 0."""
    from fisco_bcos_tpu_torch.crypto.suite import CHUNK, make_suite

    suite = make_suite(sm_crypto=kind == "sm", ec_route="composed")
    reset_caches(data)
    chunks = -(-NTX // CHUNK) + -(-NSEAL // CHUNK)
    if kind == "ecdsa":
        expect = {"ecdsa_recover": 0, "ecdsa_verify": 0, "ladder": chunks,
                  "fp_pow": 3 * -(-NTX // CHUNK) + -(-NSEAL // CHUNK)}
    else:
        expect = {"sm2_verify": 0, "ladder": chunks, "fp_pow": 0, "fp_mul_stacked": 0}
    launches, phases, res = phase_slice(dev, suite, data, rng, expect)
    diff = [k for k in res if not (np.array_equal(res[k], fused[k]) if isinstance(res[k], np.ndarray)
                                   else res[k] == fused[k])]
    if diff:
        fail(f"[slice {kind} composed] results differ from the fused route's: {diff}")
    log(f"[slice {kind} composed] senders, ok mask, roots and seal verdicts identical to "
        f"the fused route's")
    return launches, phases


# ---------------------------------------------------------------------------
# the node path: admission to the ledger, and the seal judge
# ---------------------------------------------------------------------------
# A solo node's wiring (the JAX package's init/node.py:299-312) at full
# width on the default chain and at a smaller depth on the SM chain.
NODE_TXS = {"ecdsa": NTX, "sm": 4096}  # the slice's block, or its first 4,096
NODE_HEADERS = {"ecdsa": 4096, "sm": 256}  # a sync-sized span: 4 seals a header
NODE_POOL_LIMIT = 131072  # the [txpool] limit a 65,536-tx block needs (the
#                           15,000 default sheds past its 0.7 watermark)
INGEST_MAX_BATCH = 16384  # one suite CHUNK a dispatch
INGEST_QUEUE_CAP = 65536
NODE_STEPS = ("admission", "seal_fill", "roots", "prewrite_commit", "verify_spans")


def node_expected_launches(kind: str, txs, headers, nlanes: int) -> dict:
    """Each step's kernel launches, from the shapes: the ingest lane
    dispatches INGEST_MAX_BATCH frames at a time, each one submit_columns
    with one hash_batch (a varlen launch a length class of its unsigned
    encodings) and one recover_addresses (recover or SM2 verify a suite
    CHUNK, then the keys' hash); the roots hash the receipts (set after
    the run: they are made in the step) and build two trees; the span's
    two halves merge into one hash_batch of the headers and one
    verify_batch."""
    from fisco_bcos_tpu_torch.crypto.suite import CHUNK

    hashk, tree = (("keccak256_varlen", "merkle_keccak_tree") if kind == "ecdsa"
                   else ("sm3_varlen", "merkle_sm3_tree"))
    eck, verk = (("ecdsa_recover", "ecdsa_verify") if kind == "ecdsa"
                 else ("sm2_verify", "sm2_verify"))
    ntx = len(txs)
    dispatches = [txs[o:o + INGEST_MAX_BATCH] for o in range(0, ntx, INGEST_MAX_BATCH)]
    admission = {hashk: sum(hash_classes(kind, [t.encode_unsigned() for t in d]) + 1
                            for d in dispatches),
                 eck: sum(-(-len(d) // CHUNK) for d in dispatches)}
    return {"admission": admission, "seal_fill": {}, "roots": {tree: 2},
            "prewrite_commit": {},
            "verify_spans": {hashk: hash_classes(kind, [h.encode_core() for h in headers]),
                             verk: -(-nlanes // CHUNK)}}


def node_seal_span(suite, data, nheaders: int, rng):
    """nheaders headers tiling the slice's 256 sealed headers, each with
    its 4 seals: cert-mode certificates (quorum 3 of 4), every 16th a
    legacy multi-seal header, some pushed below quorum (a 2-signer bitmap,
    2 legacy seals), one certificate minted under a foreign sealer set,
    and 1% of the seal lanes corrupted. -> (headers, the local sealer
    set, the lanes [(header, digest, sig, pub)] the judge verifies, the
    corrupted lanes, the headers with no lanes)."""
    from fisco_bcos_tpu_torch.consensus import qc
    from fisco_bcos_tpu_torch.protocol import types as T

    c, kind = suite.params, suite.kind
    sealers = seal_keys(suite)
    local = [k.pub_bytes for k in sealers]
    seal_d, seal_s = data["seal_d"], data["seal_s"]
    headers, lanes, structural = seal_headers(sealers, nheaders), [], set()
    for j, hd in enumerate(headers):
        h = j % 256
        seals = [(k, seal_s[4 * h + k]) for k in range(4)]
        if j % 64 == 7:                              # cert below quorum
            qc.attach(hd, qc.mint_cert(seals[:2], 4))
            structural.add(j)
        elif j % 64 == 39:                           # legacy below quorum
            hd.signature_list = seals[:2]
            structural.add(j)
        elif j % 16 == 3:                            # legacy multi-seal
            hd.signature_list = seals
        else:
            qc.attach(hd, qc.mint_cert(seals, 4))
        if j not in structural:
            lanes += [(j, seal_d[4 * h + k], s, local[k]) for k, s in seals]
    # a certificate minted under a foreign sealer set: its own header, seals
    foreign = [suite.generate_keypair(b"foreign" + bytes([k])) for k in range(4)]
    hd = T.BlockHeader(number=999, timestamp=999, sealer_list=[k.pub_bytes for k in foreign])
    hh = hd.hash(suite)
    qc.attach(hd, qc.mint_cert([(k, suite.sign(kp, hh)) for k, kp in enumerate(foreign)], 4))
    headers[11] = hd
    lanes = [ln for ln in lanes if ln[0] != 11]
    structural.add(11)
    # 1% of the seal lanes corrupted, in place in their header's carriage
    bad = {}
    for j, i in enumerate(rng.sample(range(len(lanes)), len(lanes) // 100)):
        hj, d, sig, pub = lanes[i]
        _, sig2, _ = corrupt_seal(kind, j % 2, d, sig, pub, c, pub)   # r = 0, s >= n
        lanes[i] = (hj, d, sig2, pub)
        bad[i] = j
        hd = headers[hj]
        cert = qc.extract(hd)
        if cert is None:
            hd.signature_list = [(k, sig2 if s == sig else s) for k, s in hd.signature_list]
        else:
            size = suite.signature_size
            parts = [cert.payload[o:o + size] for o in range(0, len(cert.payload), size)]
            qc.attach(hd, qc.QuorumCert(cert.mode, cert.bitmap,
                                        b"".join(sig2 if s == sig else s for s in parts)))
    return headers, local, lanes, bad, structural


def node_results_digest(results: dict) -> str:
    """SHA-256 of the node phase's outputs: every admission result
    (status, hash, sender), the sealed hashes, the committed header and
    every seal verdict."""
    import hashlib

    h = hashlib.sha256()
    for st, th, snd in results["admitted"]:
        h.update(st.to_bytes(4, "big") + th + (snd or b"-"))
    h.update(b"".join(results["sealed"]) + results["header"])
    h.update(np.asarray(results["verdicts"], dtype=np.uint8).tobytes())
    return h.hexdigest()


class _Together:
    """A group's suite whose batch calls wait at a barrier for the other
    group's, so that both groups' halves of a span reach the crypto lane
    in one drain, as two groups syncing the same range at once do."""

    def __init__(self, suite, barrier):
        self._suite = suite
        self._barrier = barrier

    def __getattr__(self, name):
        return getattr(self._suite, name)

    def hash_batch(self, msgs):
        self._barrier.wait(120)
        return self._suite.hash_batch(msgs)

    def verify_batch(self, digests, sigs, pubs):
        self._barrier.wait(120)
        return self._suite.verify_batch(digests, sigs, pubs)


def phase_node(dev, suite, data, rng, slice_senders):
    """(11) The node path on `suite`, as a solo node wires it: the slice's
    block (`data`) as wire frames
    through the ingest lane into the txpool (submit_columns), sealing and
    fill_block, the block's roots, the ledger's prewrite and the storage
    2PC on memory storage (the scheduler's two commit steps, replayed
    here: scheduler/scheduler.py:300-306 and :591-606 of the JAX package;
    the executor, scheduler and sealer are not ported yet), the pool's
    commit notice, then a sync-sized seal span judged by qc.verify_spans
    through two groups' LaneSuites on one CryptoLane. Each step's launch
    counters are zeroed before it and read after it; held to the oracle,
    the plain path, the slice's senders (`slice_senders`) and the counts
    from the shapes. -> (launches by step, walls in ms, device ms)."""
    import threading

    from torch.profiler import ProfilerActivity, profile

    from fisco_bcos_tpu_torch.consensus import qc
    from fisco_bcos_tpu_torch.crypto.lane import CryptoLane, LaneSuite
    from fisco_bcos_tpu_torch.ledger.ledger import (T_HASH2NUM, T_HEADER, ConsensusNode,
                                                    Ledger, _be8)
    from fisco_bcos_tpu_torch.ops import keccak, merkle, sm3
    from fisco_bcos_tpu_torch.protocol import types as T
    from fisco_bcos_tpu_torch.storage import Entry, MemoryStorage, StateStorage
    from fisco_bcos_tpu_torch.txpool import IngestLane, TxPool

    kind = suite.kind
    tag = f"[node {kind}]"
    ntx, nheaders = NODE_TXS[kind], NODE_HEADERS[kind]
    S = T.TransactionStatus
    t0 = time.perf_counter()
    txs, kps, signed_hash = data["txs"][:ntx], data["kps"], data["signed_hash"]
    own = min(data["own"], ntx)
    corrupt = {i: j for i, j in data["corrupt"].items() if i < ntx}
    frames = [t.encode() for t in txs]
    headers, local, lanes, seal_bad, structural = node_seal_span(suite, data, nheaders, rng)
    log(f"{tag} set-up ({ntx} wire frames of the slice's block, {nheaders} headers, "
        f"{len(lanes)} seal lanes): {time.perf_counter() - t0:.1f} s")

    counters = slice_counters(kind)
    expect = node_expected_launches(kind, txs, headers, len(lanes))
    # no host fallback: the suite sends every batch to the device, and the
    # launch counts held to the shapes after each step show that each did
    if suite.backend != "device":
        fail(f"{tag} the suite's backend is {suite.backend!r}, not 'device'")

    def run():
        """One profiled run of the node path on fresh node state."""
        for hd in headers:
            hd._hash = None
        storage = MemoryStorage()
        ledger = Ledger(storage, suite)
        genesis = ledger.build_genesis([ConsensusNode(p) for p in local], tx_count_limit=ntx)
        pool = TxPool(suite, ledger, pool_limit=NODE_POOL_LIMIT)
        ingest = IngestLane(pool, max_batch=INGEST_MAX_BATCH, queue_cap=INGEST_QUEUE_CAP)
        crypto = CryptoLane(suite, wait_ms=100.0)
        admitted, errors = [], []
        submit_columns = pool.submit_columns

        def recording(cols, broadcast=True):
            """submit_columns, keeping each drain's results in arrival
            order (the frames go in fire-and-forget, as gossip does)."""
            try:
                res = submit_columns(cols, broadcast)
            except BaseException as exc:
                errors.append(exc)
                raise
            admitted.extend(res)
            return res

        pool.submit_columns = recording
        launches, walls, out = {}, {}, {}

        def step(name, fn):
            for c in counters.values():
                c.launches = 0
            out[name], walls[name] = wall_ms(fn)
            launches[name] = {k: c.launches for k, c in counters.items()}

        def admit():
            if ingest.submit_many_wire_nowait(frames) != ntx:
                fail(f"{tag} the ingest queue refused frames")
            deadline = time.monotonic() + 600
            while len(admitted) < ntx and not errors:
                if time.monotonic() > deadline:
                    fail(f"{tag} {len(admitted)} of {ntx} frames admitted in 600 s")
                time.sleep(0.005)
            if errors:
                fail(f"{tag} submit_columns raised {errors[0]!r}")

        def seal_fill():
            limit = ledger.ledger_config().block_tx_count_limit
            sealed, hashes = pool.seal(limit)
            return sealed, hashes, pool.fill_block(hashes)

        def roots():
            nrng = np.random.default_rng(SEED + 3)
            sealed = out["seal_fill"][2]
            header = T.BlockHeader(number=1, timestamp=1_700_000_000_000,
                                   parent_info=[T.ParentInfo(0, genesis.hash(suite))],
                                   sealer_list=list(local))
            block = T.Block(header=header, transactions=sealed)
            block.receipts = [T.Receipt(gas_used=int(nrng.integers(21000, 10 ** 6)),
                                        status=0, output=nrng.bytes(32), block_number=1)
                              for _ in sealed]
            header.txs_root = block.calculate_txs_root(suite)
            header.receipts_root = block.calculate_receipts_root(suite)
            return block

        def prewrite_commit():
            block = out["roots"]
            header = block.header
            state = StateStorage(storage)
            ledger.prewrite_block(block, state)
            changes = state.changeset()
            changes[(T_HEADER, _be8(1))] = Entry(header.encode())
            changes[(T_HASH2NUM, header.hash(suite))] = Entry(_be8(1))
            storage.prepare(1, changes)
            storage.commit(1)
            pool.on_block_committed(1, out["seal_fill"][1],
                                    [t.nonce for t in block.transactions])

        def judge():
            barrier = threading.Barrier(2)
            groups = [_Together(LaneSuite(crypto, tag=f"group{g}"), barrier)
                      for g in range(2)]
            half = nheaders // 2
            parts = [headers[:half], headers[half:]]
            verdicts, failures = [None, None], []

            def verify(g):
                try:
                    verdicts[g] = qc.verify_spans(parts[g], local, groups[g])
                except BaseException as exc:  # re-raised on the main thread below
                    failures.append(exc)
                    barrier.abort()

            threads = [threading.Thread(target=verify, args=(g,), name=f"sync-group{g}")
                       for g in range(2)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(600)
            if failures:
                raise failures[0]
            if any(th.is_alive() for th in threads):
                fail(f"{tag} verify_spans did not return in 600 s")
            return np.concatenate(verdicts)

        # the profiler warms up on small steps through the same kernels
        # (device_events leaves their events out): a pause, then three
        # rounds, since a late session of the process has lost more than
        # one round's first events
        sub = [bytes(h) for h in signed_hash[:8]]
        try:
            ingest.start()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                time.sleep(0.5)
                for _ in range(3):
                    suite.recover_addresses(sub, [t.signature for t in txs[:8]])
                    suite.hash_batch(frames[:8])
                    suite.merkle_root(signed_hash[:17])
                    suite.verify_batch(data["seal_d"][:8], data["seal_s"][:8],
                                       data["seal_p"][:8])
                torch.cuda.synchronize()
                with measured():
                    step("admission", admit)
                    step("seal_fill", seal_fill)
                    step("roots", roots)
                    step("prewrite_commit", prewrite_commit)
                    step("verify_spans", judge)
        finally:
            ingest.stop()
            crypto.stop()
        return dict(prof=prof, launches=launches, walls=walls, out=out, admitted=admitted,
                    ledger=ledger, pool=pool, ingest=ingest.stats(),
                    crypto=crypto.stats()["per_op"])

    # A late profiler session of the process has lost its first events (a
    # whole warm-up round and the first measured launch). The counters are
    # held to the shapes on every run; a run whose profiler recorded fewer
    # calls than its counters is run again on fresh node state, up to 5
    # runs. More calls than counted cannot be a lost event (it would be a
    # wrapper that launches without counting) and fails at once.
    for attempt in range(1, 6):
        r = run()
        launches, walls = r["launches"], r["walls"]
        device_us, calls = device_events(r["prof"], tag)
        dev_ms = sum(device_us.values()) / 1e3
        for name in NODE_STEPS:
            log(f"{tag} {name}: {walls[name]:.1f} ms wall, launches "
                f"{ {k: n for k, n in launches[name].items() if n} }")
        total = sum(walls.values())
        log(f"{tag} device time {dev_ms:.1f} ms of {total:.1f} ms wall "
            f"(host {total - dev_ms:.1f} ms); ingest {r['ingest']}; crypto lane {r['crypto']}")
        hashk = "keccak256_varlen" if kind == "ecdsa" else "sm3_varlen"
        expect["roots"][hashk] = hash_classes(
            kind, [rc.encode() for rc in r["out"]["roots"].receipts])
        for name in NODE_STEPS:
            got = {k: n for k, n in launches[name].items() if n}
            if got != expect[name]:
                fail(f"{tag} {name} launched {got}, the shapes give {expect[name]}")
        summed = {k: sum(launches[s][k] for s in NODE_STEPS) for k in counters}
        missing = [k for k, n in summed.items() if n == 0]
        if missing:
            fail(f"{tag} the node path did not launch {missing}")
        seen = {k: sum(calls.get(n, 0) for n in kernel_names(k)) for k in counters}
        surplus = {k: (seen[k], summed[k]) for k in counters if seen[k] > summed[k]}
        if surplus:
            fail(f"{tag} the profiler recorded more kernel calls than the counters "
                 f"(calls, counted): {surplus}")
        if seen == summed:
            log(f"[profiler] {tag} calls equal the counters in run {attempt} of the node path")
            break
        log(f"[profiler] {tag} recorded kernel calls {seen}, the counters {summed}; "
            f"the node path runs again on fresh node state")
    else:
        fail(f"{tag} the profiler recorded kernel calls {seen}, the counters {summed}, "
             f"in 5 runs")
    out, admitted, ledger, pool = r["out"], r["admitted"], r["ledger"], r["pool"]
    log(f"{tag} device us by counter: " + ", ".join(
        f"{k} {sum(device_us.get(n, 0.0) for n in kernel_names(k)):.1f}" for k in counters))

    # -- checks ---------------------------------------------------------------
    res = admitted
    hashes = [r.tx_hash for r in res]
    if hashes[:NSIGNED] != signed_hash:
        fail(f"{tag} tx hashes differ from the host oracle on the signed entries")
    if plain_tx_hashes(suite, txs) != hashes:
        fail(f"{tag} tx hashes (in frame order) differ from the plain path")
    bad = 0
    for i in range(own):
        if i not in corrupt and (res[i].status != S.OK or res[i].sender != kps[i % 16].address):
            bad += 1
    sample = rng.sample([i for i in range(NSIGNED, ntx) if i not in corrupt], 64)
    oracle = data.setdefault("oracle", {})   # the slice's verdicts on these lanes
    for i in sorted(set(corrupt) | set(sample)):
        if ("sender", i) not in oracle:
            oracle["sender", i] = oracle_sender(kind, hashes[i], txs[i].signature)
        want = oracle["sender", i]
        status = S.OK if want is not None else S.INVALID_SIGNATURE
        if res[i].status != status or res[i].sender != want:
            bad += 1
    if bad:
        fail(f"{tag} {bad} admission results differ from the host oracle")
    if [r.sender for r in res] != list(slice_senders[:ntx]):
        fail(f"{tag} admitted senders differ from the slice's batch_recover_senders")
    ok_hashes = [r.tx_hash for r in res if r.status == S.OK]
    log(f"{tag} admission: {ntx} frames, {len(ok_hashes)} admitted, "
        f"{ntx - len(ok_hashes)} rejected ({len(corrupt)} corrupted lanes; "
        f"{len(set(range(own)) | set(corrupt) | set(sample))} held to their signers or "
        f"the oracle)")
    sealed, seal_hashes, filled = out["seal_fill"]
    if seal_hashes != ok_hashes or [t.encode() for t in filled] != \
            [frames[i] for i, r in enumerate(res) if r.status == S.OK]:
        fail(f"{tag} the sealed block is not the admitted txs in admission order")
    block = out["roots"]
    header = block.header
    alg = suite.hash_name
    nb = len(seal_hashes)
    leaves = torch.as_tensor(np.frombuffer(bytearray(b"".join(seal_hashes)), np.uint8)
                             .reshape(nb, 32), device=dev)
    if bytes(merkle.merkle_root_bucketed_plain(leaves, nb, alg).cpu().numpy()) != \
            header.txs_root:
        fail(f"{tag} txs root differs from the plain path")
    mod, plain = ((keccak, keccak.keccak256_varlen_plain) if kind == "ecdsa"
                  else (sm3, sm3.sm3_varlen_plain))
    blocks, nvalid = mod.pad_batch_np([r.encode() for r in block.receipts])
    rdig = plain(torch.as_tensor(blocks, device=dev), torch.as_tensor(nvalid, device=dev))
    if [bytes(x) for x in rdig.cpu().numpy()] != [r._hash for r in block.receipts]:
        fail(f"{tag} receipt hashes differ from the plain path")
    rleaves = torch.as_tensor(rdig.cpu().numpy(), device=dev)
    if bytes(merkle.merkle_root_bucketed_plain(rleaves, nb, alg).cpu().numpy()) != \
            header.receipts_root:
        fail(f"{tag} receipts root differs from the plain path")
    if ledger.current_number() != 1 or ledger.total_tx_count() != len(ok_hashes):
        fail(f"{tag} ledger at {ledger.current_number()} with "
             f"{ledger.total_tx_count()} txs, expected 1 and {len(ok_hashes)}")
    if ledger.header_by_number(1).encode() != header.encode():
        fail(f"{tag} the committed header differs from the sealed one")
    if pool.pending_count() != 0:
        fail(f"{tag} {pool.pending_count()} txs still pending after the commit")
    picks = rng.sample(seal_hashes, 16)
    for h in picks:
        if ledger.receipt(h) is None or ledger.transaction(h) is None:
            fail(f"{tag} a committed tx has no receipt or body")
    t0 = time.perf_counter()
    nproofs = 1 if nb > 16384 else 4   # a proof rebuilds the tree on the host
    for h in picks[:nproofs]:
        proof, root = ledger.tx_proof(h)
        if root != header.txs_root or not merkle.verify_merkle_proof(h, proof, root, alg):
            fail(f"{tag} tx_proof does not verify against the header's txs root")
    log(f"{tag} ledger: block 1 committed, {ledger.total_tx_count()} txs, 16 receipts "
        f"read, {nproofs} tx proofs verified ({time.perf_counter() - t0:.1f} s on the host)")
    verdicts = out["verify_spans"]
    seal_ok = {}
    for i, (hj, d, sig, pub) in enumerate(lanes):
        seal_ok.setdefault(hj, []).append(oracle_verify(kind, pub, d, sig)
                                          if i in seal_bad else True)
    for i in rng.sample(range(len(lanes)), 32):
        if i not in seal_bad and not oracle_verify(kind, *[lanes[i][k] for k in (3, 1, 2)]):
            fail(f"{tag} the oracle rejects one of its own seals")
    want = []
    for j, hd in enumerate(headers):
        oks = seal_ok.get(j, [])
        need = len(oks) if qc.extract(hd) is not None else 3
        want.append(j not in structural and sum(oks) >= need)
    if list(verdicts) != want:
        fail(f"{tag} {sum(a != b for a, b in zip(verdicts, want))} seal verdicts differ "
             f"from the quorum of the oracle's per-seal verdicts")
    for j, hd in enumerate(headers):
        if j != 11 and hd._hash != data["seal_d"][4 * (j % 256)]:
            fail(f"{tag} a header hash differs from the host oracle's")
    log(f"{tag} seals: {nheaders} headers, {len(lanes)} lanes in one verify_batch "
        f"({len(seal_bad)} corrupted), {int(np.sum(verdicts))} headers at quorum; "
        f"all agree with the oracle")
    # a multi-group node puts each group's suite behind a LaneSuite (the
    # JAX package's init/group.py): its recover_addresses recovers through
    # the lane, then hashes the valid keys in one launch on the card
    n = min(1024, ntx)
    lane = CryptoLane(suite)
    try:
        for c in counters.values():
            c.launches = 0
        addrs, _ = LaneSuite(lane, tag="group0").recover_addresses(
            hashes[:n], [t.signature for t in txs[:n]])
        torch.cuda.synchronize()
        got = {k: c.launches for k, c in counters.items() if c.launches}
    finally:
        lane.stop()
    want = ({"ecdsa_recover": 1, "keccak256_varlen": 1} if kind == "ecdsa"
            else {"sm2_verify": 1, "sm3_varlen": 1})
    if got != want or addrs != [r.sender for r in res[:n]]:
        fail(f"{tag} LaneSuite.recover_addresses launched {got} (expected {want}) "
             f"or its senders differ from admission's")
    log(f"{tag} LaneSuite.recover_addresses: {n} lanes, launches {got}, senders as admitted")
    results = dict(admitted=[(int(r.status), r.tx_hash, r.sender) for r in res],
                   sealed=seal_hashes, header=header.encode(), verdicts=verdicts)
    log(f"{tag} results digest {node_results_digest(results)}")
    return launches, walls, dev_ms


# ---------------------------------------------------------------------------
# block execution: the executor and the scheduler, as a solo node runs them
# ---------------------------------------------------------------------------
# The bench's own workload (benchmark/chain_bench.py's balance `register`)
# and DagTransfer-style transfers, plus calls of a hand-written probe
# contract: two blocks of 65,536 txs on the default chain, of one suite
# CHUNK on the SM chain.
EXEC_TXS = {"ecdsa": NTX, "sm": 16384}
EXEC_POOL_LIMIT = 262144   # both blocks pending at once, under the 0.7 watermark
EXEC_STEPS = ("admission", "seal_fill", "execute_1", "execute_2", "commit", "call")
EXEC_TS = 1_700_000_000_000   # block 1's timestamp (ms); block 2's is one later
EXEC_BALANCE = 1000
EXEC_BIG = 10 ** 6            # a transfer of more than any account holds: reverts


def evm_push(v: int) -> bytes:
    """The shortest PUSH of v (PUSH0 for 0)."""
    if v == 0:
        return b"\x5f"
    n = (v.bit_length() + 7) // 8
    return bytes([0x5F + n]) + v.to_bytes(n, "big")


def evm_initcode(runtime: bytes) -> bytes:
    """Deploy wrapper: CODECOPY the runtime to memory and RETURN it."""
    def body(off: int) -> bytes:
        return (evm_push(len(runtime)) + evm_push(off) + evm_push(0) + b"\x39"
                + evm_push(len(runtime)) + evm_push(0) + b"\xf3")

    off = len(body(0))
    while len(body(off)) != off:  # the offset encodes its own length
        off = len(body(off))
    return body(off) + runtime


def probe_runtime() -> bytes:
    """The probe contract: h = KECCAK256(calldata) (the suite's hash),
    STATICCALL ecrecover (0x01) on the calldata (digest | v | r | s),
    SSTORE(h, the recovered address word), LOG1(that word, topic h)."""
    return (b"\x36" + evm_push(0) + evm_push(0) + b"\x37"       # CALLDATACOPY(0, 0, size)
            + b"\x36" + evm_push(0) + b"\x20"                     # h = KECCAK256(0, size)
            + evm_push(32) + evm_push(128) + evm_push(128) + evm_push(0)
            + evm_push(1) + b"\x5a" + b"\xfa" + b"\x50"           # STATICCALL(gas, 1, 0, 128, 128, 32)
            + evm_push(128) + b"\x51" + b"\x81" + b"\x55"         # SSTORE(h, mload(128))
            + evm_push(32) + evm_push(128) + b"\xa1"              # LOG1(128, 32, h)
            + b"\x00")


def probe_calldata(suite, kp, j: int) -> bytes:
    """digest | v + 27 | r | s: ecrecover's input, signed by kp (on the SM
    chain the 65-byte form recovers nothing, as that chain's precompile
    defines)."""
    d = suite.hash(b"probe %d" % j)
    sig = suite.sign(kp, d)
    v = sig[64] if suite.kind == "ecdsa" else 0
    return d + (27 + v).to_bytes(32, "big") + sig[:32] + sig[32:64]


def exec_traffic(suite, ntx: int, seed: int = SEED + 12, nsigned: int | None = None,
                 fixed_nonce: bool = False):
    """Two blocks of ntx txs on `suite` (port objects; the tests decode
    their frames into the JAX package's). Block 1: a deploy of the probe
    contract, then ntx - 1 `register(acct<i>, 1000)` to BALANCE_ADDRESS.
    Block 2: one probe call in every 100 txs (ceil(ntx / 100)), the rest
    `transfer(acct<a>, acct<b>, 1)` over seeded pairs, 1% of them of 10^6,
    which must revert. The first nsigned txs of each block are signed over
    their own payload by 16 keys (natively) and the rest tile those
    signatures (each still recovers some key), or with fixed_nonce are
    signed over their own payload too by `sm2_sign_fixed_nonce` (the SM
    chain, whose signatures carry their key: every lane valid); nsigned
    None signs every tx natively. -> dict(blocks, accounts, probe address,
    transfers [(src, dst, amount)], calls, signing seconds)."""
    from fisco_bcos_tpu_torch.crypto import refimpl
    from fisco_bcos_tpu_torch.executor import precompiled as pc
    from fisco_bcos_tpu_torch.protocol import types as T

    rng = np.random.default_rng(seed)
    kps = [suite.generate_keypair(b"exec" + bytes([k])) for k in range(16)]
    accounts = [b"acct%d" % i for i in range(1, ntx)]
    probe = suite.hash(b"\xd6\x94" + kps[0].address + (0).to_bytes(8, "big"))[12:]
    b1 = [T.Transaction(to=b"", input=evm_initcode(probe_runtime()), nonce="b1-0",
                        block_limit=500)]
    b1 += [T.Transaction(to=pc.BALANCE_ADDRESS, nonce=f"b1-{i}", block_limit=500,
                         input=pc.encode_call("register", lambda w, a=a: w.blob(a).u64(EXEC_BALANCE)))
           for i, a in enumerate(accounts, 1)]
    b2, transfers, calls = [], [], []
    src = rng.integers(0, len(accounts), ntx)
    hop = rng.integers(1, len(accounts), ntx)
    big = rng.random(ntx) < 0.01
    for i in range(ntx):
        if i % 100 == 50 or (ntx <= 50 and i == ntx - 1):
            data = probe_calldata(suite, kps[1 + len(calls) % 15], len(calls))
            calls.append(data)
            b2.append(T.Transaction(to=probe, input=data, nonce=f"b2-{i}", block_limit=500))
            continue
        a, b = accounts[src[i]], accounts[(src[i] + hop[i]) % len(accounts)]
        amount = EXEC_BIG if big[i] else 1
        transfers.append((a, b, amount))
        b2.append(T.Transaction(
            to=pc.BALANCE_ADDRESS, nonce=f"b2-{i}", block_limit=500,
            input=pc.encode_call("transfer", lambda w, a=a, b=b, m=amount: w.blob(a).blob(b).u64(m))))
    t0 = time.perf_counter()
    nsig = 0
    nonces = ([refimpl.keygen(suite.params, seed=b"exec-nonce" + bytes([k])) for k in range(16)]
              if fixed_nonce else None)
    for block in (b1, b2):
        own = len(block) if nsigned is None else min(nsigned, len(block))
        for i in range(own):
            block[i].sign(suite, kps[i % 16])
        nsig += own
        for i in range(own, len(block)):
            if nonces is None:
                block[i].signature = block[i % own].signature
                continue
            k, (kx, _) = nonces[i % 16]
            d = block[i].hash(suite)
            sig = sm2_sign_fixed_nonce(kps[i % 16], k, kx, d)
            block[i].signature = sig if sig is not None else suite.sign(kps[i % 16], d)
        for t in block:
            object.__setattr__(t, "_hash", None)
            object.__setattr__(t, "_sender", None)
    sign_s = time.perf_counter() - t0
    return dict(blocks=(b1, b2), kps=kps, accounts=accounts, probe=probe,
                transfers=transfers, calls=calls, sign_s=sign_s, nsig=nsig)


def replay_balances(traffic) -> dict:
    """The balances after both blocks by a Python replay of the traffic:
    every account registered with 1,000, then the transfers in order, a
    transfer of more than its source holds leaving both untouched."""
    bal = {a: EXEC_BALANCE for a in traffic["accounts"]}
    for a, b, amount in traffic["transfers"]:
        if bal[a] >= amount:
            bal[a] -= amount
            bal[b] += amount
    return bal


def hash_classes(kind: str, msgs) -> int:
    """The hash launches of one device hash_batch: its length classes."""
    from fisco_bcos_tpu_torch.ops import keccak, sm3

    lens = np.fromiter((len(m) for m in msgs), np.int64, len(msgs))
    return len(keccak.length_classes((keccak if kind == "ecdsa" else sm3).nblocks_np(lens)))


class _Recorder:
    """The suite with its batch calls recorded as (method, sizes or for
    hash_batch the messages, hash_batch's digests, node, site), so each
    step's launches can be computed from the shapes the suite was given.
    A wrapper, so the calls the suite makes to itself (the SM chain's
    recovery verifies through its own verify_batch) are the outer call's
    launches and never recorded again. With a node index (phase 13, where
    several nodes append to one shared list) each call is sited by
    pbft_site; the calls list may be shared."""

    def __init__(self, suite, node=None, calls=None):
        self._suite = suite
        self._node = node
        self.calls = [] if calls is None else calls

    def __getattr__(self, name):
        return getattr(self._suite, name)

    def _record(self, name, arg, out=None):
        site = None if self._node is None else pbft_site(self._node)
        self.calls.append((name, arg, out, self._node, site))

    def hash_batch(self, msgs):
        out = self._suite.hash_batch(msgs)
        self._record("hash_batch", list(msgs), out)
        return out

    def merkle_root(self, leaves):
        self._record("merkle_root", len(leaves))
        return self._suite.merkle_root(leaves)

    def recover_addresses(self, digests, sigs):
        out = self._suite.recover_addresses(digests, sigs)
        self._record("recover_addresses", len(digests), out)
        return out

    def recover_batch(self, digests, sigs):
        self._record("recover_batch", len(digests))
        return self._suite.recover_batch(digests, sigs)

    def verify_batch(self, digests, sigs, pubs):
        self._record("verify_batch", len(digests))
        return self._suite.verify_batch(digests, sigs, pubs)


def expected_launches(kind: str, suite, calls) -> dict:
    """The launches a step's recorded suite calls give by their shapes: a
    device hash_batch one a length class, a device merkle_root one tree, a
    device recover_addresses one EC launch a suite CHUNK plus one address
    hash (on the SM chain only where a key verified: an unsigned call's
    sender hashes nothing), a device verify_batch one a CHUNK; a
    host-sized call none."""
    from fisco_bcos_tpu_torch.crypto.suite import CHUNK

    hashk, tree = (("keccak256_varlen", "merkle_keccak_tree") if kind == "ecdsa"
                   else ("sm3_varlen", "merkle_sm3_tree"))
    eck, verk = (("ecdsa_recover", "ecdsa_verify") if kind == "ecdsa"
                 else ("sm2_verify", "sm2_verify"))
    want: dict = {}

    def add(k, n):
        if n:
            want[k] = want.get(k, 0) + n

    for name, arg, out, *_ in calls:
        n = len(arg) if name == "hash_batch" else arg
        if not suite._use_device(n):
            continue
        if name == "hash_batch":
            add(hashk, hash_classes(kind, arg))
        elif name == "merkle_root":
            add(tree, 1)
        elif name == "recover_addresses":
            add(eck, -(-n // CHUNK))
            add(hashk, 1 if kind == "ecdsa" or out is None or out[1].any() else 0)
        elif name in ("recover_batch", "verify_batch"):
            add(eck if name == "recover_batch" else verk, -(-n // CHUNK))
    return want


def launches_by_site(kind: str, suite, calls):
    """Recorded suite calls (_Recorder with a node index) grouped by site.
    -> (calls by site, the launches each site's calls imply, their sum by
    kernel)."""
    by_site: dict = {}
    for name, arg, out, _, site in calls:
        by_site.setdefault(site, []).append((name, arg, out))
    sites = {st: expected_launches(kind, suite, cs) for st, cs in by_site.items()}
    want: dict = {}
    for got in sites.values():
        for k, n in got.items():
            want[k] = want.get(k, 0) + n
    return by_site, sites, want


def exec_chain(suite, storage, sealers, ntx: int):
    """A solo node's execution planes (the JAX package's init/node.py:
    341-347): a Ledger with genesis over the sealers on `storage`, the
    TransactionExecutor and a pipelined Scheduler with the state index."""
    from fisco_bcos_tpu_torch.executor import TransactionExecutor
    from fisco_bcos_tpu_torch.ledger.ledger import ConsensusNode, Ledger
    from fisco_bcos_tpu_torch.scheduler import Scheduler
    from fisco_bcos_tpu_torch.txpool import TxPool

    ledger = Ledger(storage, suite)
    ledger.build_genesis([ConsensusNode(p) for p in sealers], tx_count_limit=ntx)
    pool = TxPool(suite, ledger, pool_limit=EXEC_POOL_LIMIT)
    executor = TransactionExecutor(suite)
    sched = Scheduler(storage, ledger, executor, suite, pool, pipeline=True,
                      state_index=True)
    return ledger, pool, executor, sched


def exec_block(number: int, txs, sealers):
    from fisco_bcos_tpu_torch.protocol import types as T

    header = T.BlockHeader(number=number, timestamp=EXEC_TS + number,
                           sealer_list=list(sealers))
    return T.Block(header=header, transactions=list(txs))


def stop_chain(sched, executor) -> None:
    sched.shutdown()
    if executor._dag_pool is not None:
        executor._dag_pool[0].shutdown(wait=True)
        executor._dag_pool = None


def host_blocks(host, frames, senders, sealers, ntx: int):
    """The two blocks executed and committed by the port's Scheduler on the
    host suite (native paths; launches nothing): the same frames decoded,
    each tx with the sender admission gave it. -> (results, c_balance rows,
    storage)."""
    from fisco_bcos_tpu_torch.executor import precompiled as pc
    from fisco_bcos_tpu_torch.protocol import types as T
    from fisco_bcos_tpu_torch.storage import MemoryStorage

    storage = MemoryStorage()
    ledger, pool, executor, sched = exec_chain(host, storage, sealers, ntx)
    results = []
    try:
        for number in (1, 2):
            txs = [T.Transaction.decode(f) for f in frames[(number - 1) * ntx:number * ntx]]
            for t, s in zip(txs, senders[(number - 1) * ntx:number * ntx]):
                t._sender = s
            r = sched.execute_block(exec_block(number, txs, sealers))
            if r is None:
                fail(f"the host suite's scheduler did not execute block {number}")
            results.append(r)
        for r in results:
            if not sched.commit_block(r.header):
                fail(f"the host suite's scheduler did not commit block {r.header.number}")
    finally:
        stop_chain(sched, executor)
    return results, {k: storage.get(pc.T_BALANCE, k) for k in storage.keys(pc.T_BALANCE)}


def phase_exec(dev, suite, kind: str, rng):
    """(12) Block execution as a solo node runs it, on `suite` (backend
    "auto", the node's default gating): the two blocks' wire frames
    through the ingest lane into the txpool, sealing and fill_block,
    execute_block of block 1 and then of block 2 (speculative, over block
    1's uncommitted changeset), commit_block of both, and scheduler.call
    of balanceOf on 64 accounts. Each step's launch counters are zeroed
    before it and read after it, and must equal the counts from the
    shapes the suite was given (one hash launch a length class, one tree
    a root, no EC launch in execution) and the profiler's calls. Held to
    the same blocks on the port's host suite (receipts, changesets, the
    three roots, c_balance rows), the native host hash (every hash of
    the execute steps, the state leaves among them) and a Python replay
    of the balances. -> (launches by step, walls in ms, timings)."""
    from torch.profiler import ProfilerActivity, profile

    from fisco_bcos_tpu_torch.crypto import nativeec, nativehash
    from fisco_bcos_tpu_torch.crypto.suite import make_suite
    from fisco_bcos_tpu_torch.executor import nevm
    from fisco_bcos_tpu_torch.executor import precompiled as pc
    from fisco_bcos_tpu_torch.ops import keccak, sm3
    from fisco_bcos_tpu_torch.protocol import types as T
    from fisco_bcos_tpu_torch.storage import MemoryStorage
    from fisco_bcos_tpu_torch.txpool import IngestLane

    tag = f"[exec {kind}]"
    ntx = EXEC_TXS[kind]
    S = T.TransactionStatus
    if not (nativeec.available() and nevm.available() and nativehash.keccak256() is not None):
        fail(f"{tag} a native library is not loaded (nativeec {nativeec.available()}, "
             f"nevm {nevm.available()})")
    if suite.backend != "auto":
        fail(f"{tag} the suite's backend is {suite.backend!r}, not the node's 'auto'")
    t0 = time.perf_counter()
    tr = exec_traffic(suite, ntx, nsigned=NSIGNED, fixed_nonce=kind == "sm")
    frames = [t.encode() for b in tr["blocks"] for t in b]
    sealers = [k.pub_bytes for k in seal_keys(suite)]
    log(f"{tag} set-up: 2 blocks of {ntx} txs ({len(tr['calls'])} probe calls, "
        f"{len(tr['transfers'])} transfers), {tr['nsig']} native signatures"
        + (f" and {2 * ntx - tr['nsig']} fixed-nonce SM2 ones" if kind == "sm" else "")
        + f" in {tr['sign_s']:.2f} s, {time.perf_counter() - t0:.1f} s in all")
    counters = slice_counters(kind)
    ec_names = [k for k in counters if k in ("ecdsa_recover", "ecdsa_verify", "sm2_verify")]

    def run():
        """One profiled run on fresh node state."""
        rec = _Recorder(suite)
        storage = MemoryStorage()
        ledger, pool, executor, sched = exec_chain(rec, storage, sealers, ntx)
        ingest = IngestLane(pool, max_batch=INGEST_MAX_BATCH, queue_cap=2 * ntx)
        admitted, errors = [], []
        submit_columns = pool.submit_columns

        def recording(cols, broadcast=True):
            try:
                res = submit_columns(cols, broadcast)
            except BaseException as exc:
                errors.append(exc)
                raise
            admitted.extend(res)
            return res

        pool.submit_columns = recording
        launches, walls, out, shapes, parts = {}, {}, {}, {}, {}

        def step(name, fn):
            for c in counters.values():
                c.launches = 0
            rec.calls = []
            out[name], walls[name] = wall_ms(fn)
            launches[name] = {k: c.launches for k, c in counters.items()}
            shapes[name] = rec.calls

        def admit():
            if ingest.submit_many_wire_nowait(frames) != len(frames):
                fail(f"{tag} the ingest queue refused frames")
            deadline = time.monotonic() + 600
            while len(admitted) < len(frames) and not errors:
                if time.monotonic() > deadline:
                    fail(f"{tag} {len(admitted)} of {len(frames)} frames admitted in 600 s")
                time.sleep(0.005)
            if errors:
                fail(f"{tag} submit_columns raised {errors[0]!r}")

        def seal_fill():
            got = []
            for number in (1, 2):
                _, hashes = pool.seal(ntx, for_number=number)
                got.append(pool.fill_block(hashes))
            return got

        def execute(number):
            def run_block():
                block = exec_block(number, out["seal_fill"][number - 1], sealers)
                r = sched.execute_block(block)
                if r is None:
                    fail(f"{tag} execute_block({number}) returned None")
                return r
            return run_block

        def commit():
            for number in (1, 2):
                if not sched.commit_block(out[f"execute_{number}"].header):
                    fail(f"{tag} commit_block({number}) failed")

        picks = rng.sample(tr["accounts"], 64)

        def call():
            got = []
            for a in picks:
                tx = T.Transaction(to=pc.BALANCE_ADDRESS, nonce="call",
                                   input=pc.encode_call("balanceOf", lambda w, a=a: w.blob(a)))
                tx._sender = tr["kps"][0].address
                got.append(sched.call(tx))
            return got

        # the executor's and the state root's parts of an execute step, by
        # wrapping the calls the scheduler makes (host clock, synchronised)
        ex_dag, ex_root = executor.execute_block_dag, executor.state_root_with_leaves
        calc_txs, calc_rc = T.Block.calculate_txs_root, T.Block.calculate_receipts_root
        prewrite = ledger.prewrite_block

        def timed(name, fn):
            def inner(*a, **k):
                res, ms = wall_ms(lambda: fn(*a, **k))
                parts.setdefault(cur[0], {}).setdefault(name, 0.0)
                parts[cur[0]][name] += ms
                return res
            return inner

        cur = [""]
        executor.execute_block_dag = timed("transactions", ex_dag)
        executor.state_root_with_leaves = timed("state_root", ex_root)
        ledger.prewrite_block = timed("prewrite", prewrite)
        sub = [bytes(32 * [k]) for k in range(8)]
        try:
            ingest.start()
            T.Block.calculate_txs_root = timed("txs_receipts_roots", calc_txs)
            T.Block.calculate_receipts_root = timed("txs_receipts_roots", calc_rc)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                time.sleep(0.5)
                warm = make_suite(kind == "sm", device=dev)   # "device": the same kernels
                for _ in range(3):
                    warm.recover_addresses(sub, [t.signature for t in tr["blocks"][0][:8]])
                    warm.hash_batch(frames[:8])
                    warm.merkle_root(sub * 3)
                torch.cuda.synchronize()
                with measured():
                    step("admission", admit)
                    step("seal_fill", seal_fill)
                    cur[0] = "execute_1"
                    step("execute_1", execute(1))
                    cur[0] = "execute_2"
                    step("execute_2", execute(2))
                    step("commit", commit)
                    step("call", call)
        finally:
            T.Block.calculate_txs_root, T.Block.calculate_receipts_root = calc_txs, calc_rc
            ingest.stop()
            stop_chain(sched, executor)
        return dict(prof=prof, launches=launches, walls=walls, out=out, shapes=shapes,
                    parts=parts, admitted=admitted, ledger=ledger, pool=pool,
                    storage=storage, picks=picks)

    for attempt in range(1, 6):
        r = run()
        launches, walls, shapes = r["launches"], r["walls"], r["shapes"]
        device_us, calls = device_events(r["prof"], tag)
        dev_ms = sum(device_us.values()) / 1e3
        for name in EXEC_STEPS:
            log(f"{tag} {name}: {walls[name]:.1f} ms wall, launches "
                f"{ {k: n for k, n in launches[name].items() if n} }")
        for name in ("execute_1", "execute_2"):
            p = r["parts"][name]
            log(f"{tag} {name} parts (ms): transactions {p['transactions']:.1f}, txs and "
                f"receipts roots {p['txs_receipts_roots']:.1f}, prewrite_block "
                f"{p['prewrite']:.1f}, state root {p['state_root']:.1f}")
        total = sum(walls.values())
        log(f"{tag} device time {dev_ms:.1f} ms of {total:.1f} ms wall "
            f"(host {total - dev_ms:.1f} ms)")
        for name in EXEC_STEPS:
            got = {k: n for k, n in launches[name].items() if n}
            want = expected_launches(kind, suite, shapes[name])
            if got != want:
                fail(f"{tag} {name} launched {got}, the shapes give {want}")
            if name.startswith("execute") and any(launches[name][k] for k in ec_names):
                fail(f"{tag} {name} launched an EC kernel: {got}")
        summed = {k: sum(launches[s][k] for s in EXEC_STEPS) for k in counters}
        missing = [k for k, n in summed.items() if n == 0 and k != "ecdsa_verify"]
        if missing:
            fail(f"{tag} block execution did not launch {missing}")
        seen = {k: sum(calls.get(n, 0) for n in kernel_names(k)) for k in counters}
        surplus = {k: (seen[k], summed[k]) for k in counters if seen[k] > summed[k]}
        if surplus:
            fail(f"{tag} the profiler recorded more kernel calls than the counters "
                 f"(calls, counted): {surplus}")
        if seen == summed:
            log(f"[profiler] {tag} calls equal the counters in run {attempt}")
            break
        log(f"[profiler] {tag} recorded kernel calls {seen}, the counters {summed}; "
            f"block execution runs again on fresh node state")
    else:
        fail(f"{tag} the profiler recorded kernel calls {seen}, the counters {summed}, "
             f"in 5 runs")
    log(f"{tag} device us by counter: " + ", ".join(
        f"{k} {sum(device_us.get(n, 0.0) for n in kernel_names(k)):.1f}" for k in counters))

    # -- checks ---------------------------------------------------------------
    out, admitted, ledger = r["out"], r["admitted"], r["ledger"]
    if [a.status for a in admitted] != [S.OK] * len(frames):
        fail(f"{tag} {sum(a.status != S.OK for a in admitted)} frames not admitted")
    b1, b2 = tr["blocks"]
    want_hashes = [t.hash(suite) for t in b1[:4]]
    if [a.tx_hash for a in admitted[:4]] != want_hashes:
        fail(f"{tag} admission's tx hashes differ from the host hash")
    own = ntx if kind == "sm" else NSIGNED
    for number, block in ((1, b1), (2, b2)):
        sent = admitted[(number - 1) * ntx:number * ntx]
        if any(sent[i].sender != tr["kps"][i % 16].address for i in range(own)):
            fail(f"{tag} block {number}: a sender differs from its signer's address")
    host = make_suite(kind == "sm", backend="host")
    lanes = rng.sample(range(len(frames)), 64)
    addrs, _ = host.recover_addresses([admitted[i].tx_hash for i in lanes],
                                      [T.Transaction.decode(frames[i]).signature for i in lanes])
    if addrs != [admitted[i].sender for i in lanes]:
        fail(f"{tag} sampled senders differ from the native host recovery")
    filled = out["seal_fill"]
    if [t.encode() for t in filled[0] + filled[1]] != frames:
        fail(f"{tag} the sealed blocks are not the frames in admission order")
    results = [out["execute_1"], out["execute_2"]]
    t0 = time.perf_counter()
    hres, hbal = host_blocks(host, frames, [a.sender for a in admitted], sealers, ntx)
    host_s = time.perf_counter() - t0
    for got, want in zip(results, hres):
        n = got.header.number
        if [x.encode() for x in got.receipts] != [x.encode() for x in want.receipts] or \
                [x.message for x in got.receipts] != [x.message for x in want.receipts]:
            fail(f"{tag} block {n}: receipts differ from the host suite's")
        if {k: (e.value, e.deleted) for k, e in got.changes.items()} != \
                {k: (e.value, e.deleted) for k, e in want.changes.items()}:
            fail(f"{tag} block {n}: the changeset differs from the host suite's")
        for root in ("state_root", "txs_root", "receipts_root"):
            if getattr(got.header, root) != getattr(want.header, root):
                fail(f"{tag} block {n}: {root} differs from the host suite's")
    bal = {k: r["storage"].get(pc.T_BALANCE, k) for k in r["storage"].keys(pc.T_BALANCE)}
    if bal != hbal:
        fail(f"{tag} c_balance rows differ from the host suite's")
    native_batch = nativehash.host_hash_batch(suite.hash_name)
    for name in ("execute_1", "execute_2"):
        for cname, msgs, digests, *_ in r["shapes"][name]:
            if cname == "hash_batch" and native_batch(msgs) != digests:
                fail(f"{tag} {name}: a hash_batch digest differs from the native host hash")
    # the state roots' batches: the execute steps' hash batches past ntx leaves
    state_batches = [c for c in r["shapes"]["execute_1"] + r["shapes"]["execute_2"]
                     if c[0] == "hash_batch" and len(c[1]) > ntx]
    longest = max(len(m) for _, msgs, *_ in state_batches for m in msgs)
    want_bal = replay_balances(tr)
    if sum(want_bal.values()) != EXEC_BALANCE * len(tr["accounts"]):
        fail(f"{tag} the replay does not conserve the balances")
    got_bal = {k: int.from_bytes(v, "big") for k, v in bal.items()}
    if got_bal != want_bal:
        fail(f"{tag} {sum(got_bal.get(a) != b for a, b in want_bal.items())} balances "
             f"differ from the Python replay")
    for a, rc in zip(r["picks"], out["call"]):
        if rc.status != 0 or int.from_bytes(rc.output, "big") != want_bal[a]:
            fail(f"{tag} scheduler.call balanceOf differs from the replay")
    rcs1, rcs2 = results[0].receipts, results[1].receipts
    if rcs1[0].status != S.OK or rcs1[0].contract_address != tr["probe"]:
        fail(f"{tag} the probe contract's deploy failed or landed elsewhere")
    reverted = sum(x.status == S.REVERT for x in rcs2)
    want_rev = sum(1 for a, b, m in tr["transfers"] if m == EXEC_BIG)
    probes = [x for x in rcs2 if len(x.logs) == 1 and x.logs[0].address == tr["probe"]]
    if reverted != want_rev or len(probes) != len(tr["calls"]):
        fail(f"{tag} {reverted} transfers reverted (the replay: {want_rev}), "
             f"{len(probes)} probe calls logged (sent {len(tr['calls'])})")
    if kind == "ecdsa":
        signer = tr["kps"][1].address.rjust(32, b"\x00")
        if probes[0].logs[0].data != signer:
            fail(f"{tag} the probe's ecrecover gave {probes[0].logs[0].data.hex()}")
    if ledger.current_number() != 2 or ledger.total_tx_count() != 2 * ntx:
        fail(f"{tag} the ledger is at {ledger.current_number()} with "
             f"{ledger.total_tx_count()} txs")
    if r["pool"].pending_count() != 0:
        fail(f"{tag} {r['pool'].pending_count()} txs still pending after the commits")
    log(f"{tag} receipts, changesets, state, txs and receipts roots and {len(bal)} c_balance "
        f"rows equal the host suite's ({host_s:.1f} s on the host suite); every hash of "
        f"the execute steps equals the native host hash; {reverted} transfers reverted, "
        f"{len(probes)} probe calls, balances equal the replay and conserved")
    for res in results:
        log(f"{tag} block {res.header.number}: state root {res.header.state_root.hex()}")

    # the state root's hash batch alone: its device time, and its longest
    # message's class (one launch) alone
    hcls = keccak if kind == "ecdsa" else sm3
    vname = "keccak256_varlen" if kind == "ecdsa" else "sm3_varlen"
    msgs = max(state_batches, key=lambda c: len(c[1]))[1]
    packed = hcls.pack_batch_np(msgs)
    top_rows, top_blocks, top_nv = packed[-1]
    t_blocks = torch.as_tensor(top_blocks, device=dev)
    t_nv = torch.as_tensor(top_nv, device=dev)
    wrapper = counters[vname]
    batch_ms = kernel_device_ms(lambda: suite.hash_batch(msgs), vname + "_kernel", reps=5,
                                per_call=len(packed))
    # one launch of tens of ms: CUDA events, not the profiler (whose
    # sessions on some card machines lost every event of it)
    top_ms = flushed_event_ms(lambda: wrapper(t_blocks, t_nv), reps=5)
    nblocks = int(top_nv.max())
    blocks_all = sum(int(nv.sum()) for _, _, nv in packed)
    padded = sum(b.shape[0] * b.shape[1] for _, b, _ in packed)
    bsize = keccak.RATE_BYTES if kind == "ecdsa" else sm3.BLOCK_BYTES
    bound_fn = keccak_bound if kind == "ecdsa" else sm3_bound
    bound, by = bound_fn(blocks_all, bsize * blocks_all + 32 * len(msgs))
    # the state root's tree over the same leaves (the digests), alone
    leaves = max(state_batches, key=lambda c: len(c[1]))[2]
    tname = "merkle_keccak_tree" if kind == "ecdsa" else "merkle_sm3_tree"
    tree_ms = kernel_device_ms(lambda: suite.merkle_root(leaves), tname + "_kernel", reps=5)
    parents, m = 0, len(leaves)
    while m > 1:
        m = (m + 15) // 16
        parents += m
    tbytes = 32 * (len(leaves) + parents) + 32 * parents
    tbound, tby = (keccak_bound(4 * parents, tbytes) if kind == "ecdsa"
                   else sm3_bound(9 * parents, tbytes))
    timings = dict(state_leaves=len(msgs), classes=len(packed), longest_blocks=nblocks,
                   longest_bytes=longest, batch_ms=batch_ms, top_ms=top_ms,
                   top_rows=len(top_rows), blocks=blocks_all, padded_blocks=padded,
                   bound_ms=bound, bound_by=by, tree_ms=tree_ms, tree_bound_ms=tbound,
                   tree_bound_by=tby, host_s=host_s, sign_s=tr["sign_s"],
                   nsig=tr["nsig"], parts=r["parts"], storage=r["storage"],
                   ledger=r["ledger"])
    log(f"{tag} state-root hash batch: {len(msgs)} leaves in {len(packed)} length classes, "
        f"{blocks_all} blocks needed, {padded} padded ({padded / blocks_all:.3f}x), "
        f"{batch_ms:.4f} ms device a batch (bound {bound:.4f} ms by {by}); its longest "
        f"class ({len(top_rows)} message(s) of up to {nblocks} blocks, {longest} B) "
        f"{top_ms:.4f} ms alone (CUDA events, L2 flushed)")
    log(f"{tag} state-root tree: {len(leaves)} leaves, {tree_ms:.4f} ms device "
        f"(bound {tbound:.5f} ms by {tby})")
    return launches, walls, timings


# ---------------------------------------------------------------------------
# phase 13: a 4-node PBFT chain of the port's own Nodes on the card
# ---------------------------------------------------------------------------
PBFT_TXS = {"ecdsa": 16384, "sm": 4096}   # a block: one suite CHUNK on the default chain
# phase 13's chain runs two heights (three until phase 17 took the script
# past 1,080 s on slow hosts), its traffic three: phase 14 commits all three
PBFT_HEIGHTS = 2
PBFT_TRAFFIC_HEIGHTS = 3
PBFT_POOL_LIMIT = 131072
PBFT_VIEW_TIMEOUT = 300.0   # s: far above a healthy height, so no view change fires
PBFT_MIN_SEAL = 2.0         # s: a partial block waits this long to fill
PBFT_DEADLINE = 240.0       # s for the gossip, and for the chain to reach its last height
PBFT_RUNS = 5   # a run whose profiler session lost a kernel event runs again
# s of quiet on each side of the measured range: it keeps the measured
# launches away from the session's edges, where events have gone missing
# (while the range was still taken on the host's clock, 7 of 12 runs lost
# an event without it, 1 of 7 with it; PERF.md, Findings)
PBFT_GUARD = 0.5
# the suite call's site: the innermost of these functions on its stack (a
# "file:function" key names one module's function of a common name)
PBFT_SITES = {"_apply_blocks": "sync", "_carried_by_height": "view_change",
              "_handle_newview": "view_change", "_batch_checked": "pbft_packets",
              "_flush_checkpoint_commits": "pbft_seals", "verify_proposal": "proposal",
              "fetch_missing": "proposal", "_broadcast_preprepare": "leader_txs_root",
              "execute_block": "execute", "commit_block": "commit",
              "_pack_txs": "gossip_send", "submit_columns": "ingest",
              # phase 14's snapshot calls
              "export_snapshot": "snap_export", "verify_snapshot": "snap_verify",
              "snap_sync": "snap_seals",
              # phase 15's serving calls
              "prime_block": "prime", "_senders_for_block": "cold_senders",
              "verify_proofs": "verify_proofs",
              # the ingest lane's object door (sendTransaction under a span
              # context), and a call's sender (an unsigned tx: one lane)
              "ingest.py:_dispatch": "ingest", "scheduler.py:call": "rpc_call",
              "ledger.py:receipt_proof": "proof_miss",
              # phase 16's light client (its spans) and light-node server
              "lightnode.py:header_range": "light_headers",
              "lightnode.py:transactions": "light_txs",
              "lightnode.py:receipts": "light_receipts",
              "lightnode.py:_block_levels": "light_server",
              # phase 17's shared crypto lane (the 2-group daemon's merged calls)
              "lane.py:_dispatch": "lane"}


def pbft_site(node: int) -> str:
    """The site of the suite call being made: the innermost function of
    PBFT_SITES on the caller's stack; the ingest lane's admission on node
    0 (where the frames come in) and its gossip import on the others.
    Called from _Recorder._record: the suite's caller is three frames up."""
    f = sys._getframe(3)
    while f is not None:
        code = f.f_code
        site = PBFT_SITES.get(code.co_name) or PBFT_SITES.get(
            f"{code.co_filename.rsplit('/', 1)[-1]}:{code.co_name}")
        if site is not None:
            if site == "ingest":
                return "admission" if node == 0 else "gossip_import"
            return site
        f = f.f_back
    return "other"


def pbft_traffic(suite, ntx: int, heights: int, seed: int = SEED + 13,
                 group_id: str = "group0"):
    """`heights` blocks of ntx txs of phase 12's balance workload: block 1
    registers ntx accounts with 1,000 each, the later blocks transfer 1
    over seeded pairs, 1% of them 10^6, which revert. Every tx, of group
    `group_id`, is signed natively by one of 16 keys over its own payload.
    -> dict(frames, ops {frame: op}, accounts, sign seconds)."""
    from fisco_bcos_tpu_torch.executor import precompiled as pc
    from fisco_bcos_tpu_torch.protocol import types as T

    rng = np.random.default_rng(seed)
    kps = [suite.generate_keypair(b"pbft" + bytes([k])) for k in range(16)]
    accounts = [b"pacct%d" % i for i in range(ntx)]
    txs, ops = [], []
    for i, a in enumerate(accounts):
        txs.append(T.Transaction(to=pc.BALANCE_ADDRESS, nonce=f"p1-{i}", block_limit=500,
                                 group_id=group_id,
                                 input=pc.encode_call("register",
                                                      lambda w, a=a: w.blob(a).u64(EXEC_BALANCE))))
        ops.append(("register", a, EXEC_BALANCE))
    for h in range(2, heights + 1):
        src = rng.integers(0, ntx, ntx)
        hop = rng.integers(1, ntx, ntx)
        big = rng.random(ntx) < 0.01
        for i in range(ntx):
            a, b = accounts[src[i]], accounts[(src[i] + hop[i]) % ntx]
            m = EXEC_BIG if big[i] else 1
            txs.append(T.Transaction(
                to=pc.BALANCE_ADDRESS, nonce=f"p{h}-{i}", block_limit=500, group_id=group_id,
                input=pc.encode_call("transfer",
                                     lambda w, a=a, b=b, m=m: w.blob(a).blob(b).u64(m))))
            ops.append(("transfer", a, b, m))
    t0 = time.perf_counter()
    for i, t in enumerate(txs):
        t.sign(suite, kps[i % 16])
    sign_s = time.perf_counter() - t0
    frames = [t.encode() for t in txs]
    return dict(frames=frames, ops=dict(zip(frames, ops)), accounts=accounts,
                sign_s=sign_s, kps=kps)


def pbft_replay(ops, committed) -> dict:
    """Balances after the committed txs, in their committed order, by a
    Python replay: a register sets its account, a transfer of more than
    its source holds (or from an account not registered) changes nothing."""
    bal: dict = {}
    for frame in committed:
        op = ops[frame]
        if op[0] == "register":
            bal[op[1]] = op[2]
        else:
            _, a, b, m = op
            if a in bal and b in bal and bal[a] >= m:
                bal[a] -= m
                bal[b] += m
    return bal


def pbft_oracle(host, blocks, sealers, ntx: int, compat: str):
    """The committed blocks executed in order by one solo Scheduler on the
    port's host suite (native; launches nothing), each header rebuilt from
    the committed one as block sync replays it. -> (results, c_balance rows)."""
    from fisco_bcos_tpu_torch.executor import TransactionExecutor
    from fisco_bcos_tpu_torch.executor import precompiled as pc
    from fisco_bcos_tpu_torch.ledger.ledger import ConsensusNode, Ledger
    from fisco_bcos_tpu_torch.protocol import types as T
    from fisco_bcos_tpu_torch.scheduler import Scheduler
    from fisco_bcos_tpu_torch.storage import MemoryStorage
    from fisco_bcos_tpu_torch.txpool import TxPool

    storage = MemoryStorage()
    ledger = Ledger(storage, host)
    ledger.build_genesis([ConsensusNode(p) for p in sealers], tx_count_limit=ntx,
                         compatibility_version=compat)
    pool = TxPool(host, ledger, pool_limit=PBFT_POOL_LIMIT)
    executor = TransactionExecutor(host)
    sched = Scheduler(storage, ledger, executor, host, pool, pipeline=True,
                      state_index=True)
    results = []
    try:
        for b in blocks:
            h = b.header
            replay = T.Block(transactions=[T.Transaction.decode(t.encode())
                                           for t in b.transactions])
            for f in ("version", "number", "timestamp", "sealer", "extra_data"):
                setattr(replay.header, f, getattr(h, f))
            replay.header.consensus_weights = list(h.consensus_weights)
            replay.header.sealer_list = list(h.sealer_list)
            r = sched.execute_block(replay)
            if r is None:
                fail(f"the oracle's scheduler did not execute block {h.number}")
            r.header.signature_list = h.signature_list
            if not sched.commit_block(r.header):
                fail(f"the oracle's scheduler did not commit block {h.number}")
            results.append(r)
    finally:
        stop_chain(sched, executor)
    return results, {k: storage.get(pc.T_BALANCE, k) for k in storage.keys(pc.T_BALANCE)}


def phase_pbft(dev, kind: str):
    """(13) A 4-node PBFT chain of the port's own Nodes (init/node.py) on
    the card: one FakeGateway, the 4 sealers of the genesis, leader_period
    1 (each height a leader of its own), crypto_backend "device" (every
    batch of every node on the card). The txs come in as wire frames
    through node 0's ingest lane and txsync gossips them; every pool holds
    them all before the nodes start and the first grant. Each node's suite
    calls are recorded by site; the launch counters, zeroed just before
    the frames go in and read after the nodes have stopped, must equal the
    launches those calls imply and the profiler's calls. Checked: every
    node at the last height with equal header hashes and a seal quorum on
    each, roots and c_balance rows equal to the committed blocks run on a
    solo Scheduler over the host suite (whose headers must hash the same)
    and to a Python replay. -> (launches by kernel, launches by site,
    walls in ms, timings)."""
    from torch.profiler import ProfilerActivity, profile

    from fisco_bcos_tpu_torch.consensus import qc
    from fisco_bcos_tpu_torch.consensus.pbft.engine import PBFTEngine
    from fisco_bcos_tpu_torch.crypto.suite import make_suite
    from fisco_bcos_tpu_torch.executor import precompiled as pc
    from fisco_bcos_tpu_torch.init.node import Node, NodeConfig
    from fisco_bcos_tpu_torch.ledger.ledger import ConsensusNode
    from fisco_bcos_tpu_torch.net.gateway import FakeGateway

    tag = f"[pbft {kind}]"
    ntx, heights = PBFT_TXS[kind], PBFT_HEIGHTS
    suite = make_suite(kind == "sm", device=dev)
    t0 = time.perf_counter()
    tr = pbft_traffic(suite, ntx, PBFT_TRAFFIC_HEIGHTS)
    frames = tr["frames"][:heights * ntx]
    keys = seal_keys(suite)
    sealers = [ConsensusNode(k.pub_bytes) for k in keys]
    nsig = len(tr["frames"])
    log(f"{tag} set-up: {heights} blocks of {ntx} txs, {nsig} native signatures in "
        f"{tr['sign_s']:.2f} s ({tr['sign_s'] / nsig * 1e3:.3f} ms each), "
        f"{time.perf_counter() - t0:.1f} s in all")
    cfg = NodeConfig(consensus="pbft", sm_crypto=kind == "sm", crypto_backend="device",
                     device=str(dev), tx_count_limit=ntx, txpool_limit=PBFT_POOL_LIMIT,
                     min_seal_time=PBFT_MIN_SEAL, view_timeout=PBFT_VIEW_TIMEOUT,
                     ingest_max_batch=INGEST_MAX_BATCH, ingest_queue_cap=4 * len(frames),
                     profile_hz=0)   # the sampler thread is phase 15's, not this one's
    counters = slice_counters(kind)
    verk = "ecdsa_verify" if kind == "ecdsa" else "sm2_verify"
    eck = "ecdsa_recover" if kind == "ecdsa" else "sm2_verify"
    first = sorted(k.pub_bytes for k in keys)[1 % len(keys)]   # leads height 1, view 0
    sub = [bytes(32 * [k]) for k in range(8)]
    sub_sigs = [suite.sign(keys[k % 4], sub[k]) for k in range(8)]
    sub_pubs = [keys[k % 4].pub_bytes for k in range(8)]

    def run():
        """One profiled run on fresh nodes: gossip, then the chain."""
        gw = FakeGateway()
        calls: list = []
        # each node's suite as Node builds it from cfg (init/node.py),
        # recorded; every plane of the node holds the recorder
        nodes = [Node(cfg, keypair=kp, gateway=gw, suite=_Recorder(make_suite(
                     cfg.sm_crypto, backend=cfg.crypto_backend, device=cfg.device,
                     device_min_batch=cfg.device_min_batch,
                     mesh_devices=cfg.crypto_mesh_devices), i, calls))
                 for i, kp in enumerate(keys)]
        for n in nodes:
            n.build_genesis(sealers)
            if n.suite.backend != "device" or n.suite.device.type != dev.type:
                fail(f"{tag} a node's suite is on {n.suite.backend!r} on "
                     f"{n.suite.device}, not on 'device' on {dev}")
        commits = [{} for _ in nodes]
        for i, n in enumerate(nodes):
            n.scheduler.on_commit.append(
                lambda num, i=i: commits[i].setdefault(num, time.perf_counter()))
        preprepares: dict = {}
        orig_pp = PBFTEngine._broadcast_preprepare

        def stamped(engine, block, carried=False):
            preprepares.setdefault(block.header.number, (engine.index, time.perf_counter()))
            return orig_pp(engine, block, carried)

        walls, stopped = {}, []

        def stop():
            if not stopped:
                stopped.append(True)
                for n in nodes:
                    n.stop()
                gw.stop()

        try:
            PBFTEngine._broadcast_preprepare = stamped
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                time.sleep(0.5)
                warm = make_suite(kind == "sm", device=dev)   # "device": the same kernels
                for _ in range(3):
                    warm.recover_addresses(sub, sub_sigs)
                    warm.verify_batch(sub, sub_sigs, sub_pubs)
                    warm.hash_batch(frames[:8])
                    warm.merkle_root(sub * 3)
                torch.cuda.synchronize()
                time.sleep(PBFT_GUARD)
                with measured():
                    for c in counters.values():
                        c.launches = 0
                    t_in = time.perf_counter()
                    for n in nodes:
                        n.ingest.start()
                    if nodes[0].ingest.submit_many_wire_nowait(frames) != len(frames):
                        fail(f"{tag} node 0's ingest queue refused frames")
                    deadline = time.monotonic() + PBFT_DEADLINE
                    while any(n.txpool.pending_count() < len(frames) for n in nodes):
                        if time.monotonic() > deadline:
                            fail(f"{tag} pools hold {[n.txpool.pending_count() for n in nodes]}"
                                 f" of {len(frames)} txs after {PBFT_DEADLINE:.0f} s")
                        time.sleep(0.005)
                    t_start = time.perf_counter()
                    walls["admission_gossip"] = (t_start - t_in) * 1e3
                    # height 1's leader starts last: a node's engine registers
                    # its PBFT handler in start(), so a pre-prepare sent before
                    # a peer started would be dropped there and only a view
                    # change would recover the round
                    for n in sorted(nodes, key=lambda n: n.keypair.pub_bytes == first):
                        n.start()
                    deadline = time.monotonic() + PBFT_DEADLINE
                    while any(n.ledger.current_number() < heights for n in nodes):
                        if time.monotonic() > deadline:
                            fail(f"{tag} heights {[n.ledger.current_number() for n in nodes]}"
                                 f" after {PBFT_DEADLINE:.0f} s (want {heights})")
                        time.sleep(0.005)
                    t_done = time.perf_counter()
                    walls["chain"] = (t_done - t_start) * 1e3
                    stop()   # no suite call after this: the counters are final
                    torch.cuda.synchronize()
                    launches = {k: c.launches for k, c in counters.items()}
                    time.sleep(PBFT_GUARD)
        finally:
            PBFTEngine._broadcast_preprepare = orig_pp
            stop()
        walls["total"] = (t_done - t_in) * 1e3
        heights_ms = {}
        for h in range(1, heights + 1):
            if h not in preprepares:
                fail(f"{tag} no pre-prepare of height {h} was recorded")
            leader, t_pp = preprepares[h]
            heights_ms[h] = (leader, (t_pp - t_start) * 1e3,
                             [(c[h] - t_pp) * 1e3 if h in c else None for c in commits])
        return dict(prof=prof, nodes=nodes, calls=calls, launches=launches, walls=walls,
                    heights=heights_ms)

    for attempt in range(1, PBFT_RUNS + 1):
        r = run()
        launches, calls = r["launches"], r["calls"]
        device_us, pcalls = device_events(r["prof"], tag)
        dev_ms = sum(device_us.values()) / 1e3
        w = r["walls"]
        log(f"{tag} run {attempt}: admission and gossip {w['admission_gossip']:.1f} ms wall, "
            f"chain (start to height {heights} on every node) {w['chain']:.1f} ms, "
            f"total {w['total']:.1f} ms; device time {dev_ms:.1f} ms")
        for h, (leader, t_pp, lat) in r["heights"].items():
            log(f"{tag} height {h}: leader index {leader}, pre-prepare at {t_pp:.1f} ms "
                f"after start; committed on nodes 0-3 at "
                + ", ".join("-" if x is None else f"{x:.1f}" for x in lat)
                + " ms after the pre-prepare")
        by_site, site_launches, want = launches_by_site(kind, suite, calls)
        got = {k: n for k, n in launches.items() if n}
        log(f"{tag} launches {got}; by site: {site_launches}")
        log(f"{tag} suite calls by site: "
            + ", ".join(f"{s} {len(cs)}" for s, cs in sorted(by_site.items())))
        if got != want:
            fail(f"{tag} the counters {got}, the recorded suite calls give {want}")
        for site in ("pbft_packets", "pbft_seals"):
            if not site_launches.get(site, {}).get(verk):
                fail(f"{tag} {verk} was not launched by {site}: {site_launches.get(site)}")
        for site in ("admission", "gossip_import"):
            if not site_launches.get(site, {}).get(eck):
                fail(f"{tag} {eck} was not launched by {site}: {site_launches.get(site)}")
        missing = [k for k in counters if not launches[k]]
        if missing:
            fail(f"{tag} the chain did not launch {missing}")
        seen = {k: sum(pcalls.get(n, 0) for n in kernel_names(k)) for k in counters}
        surplus = {k: (seen[k], launches[k]) for k in counters if seen[k] > launches[k]}
        if surplus:
            fail(f"{tag} the profiler recorded more kernel calls than the counters "
                 f"(calls, counted): {surplus}")
        if seen == launches:
            log(f"[profiler] {tag} calls equal the counters in run {attempt}")
            break
        log(f"[profiler] {tag} recorded kernel calls {seen}, the counters {launches}; "
            f"the chain runs again on fresh nodes")
    else:
        fail(f"{tag} the profiler recorded kernel calls {seen}, the counters {launches}, "
             f"in {PBFT_RUNS} runs")
    log(f"{tag} device us by counter: " + ", ".join(
        f"{k} {sum(device_us.get(n, 0.0) for n in kernel_names(k)):.1f}" for k in counters))

    # -- checks ---------------------------------------------------------------
    nodes = r["nodes"]
    views = [n.consensus.status()["view"] for n in nodes]
    if any(views):
        log(f"{tag} a view change fired: views {views}")
    if [n.ledger.current_number() for n in nodes] != [heights] * 4:
        fail(f"{tag} heights {[n.ledger.current_number() for n in nodes]}, want {heights}")
    host = make_suite(kind == "sm", backend="host")
    blocks = [nodes[0].ledger.block_by_number(h, with_txs=True) for h in range(1, heights + 1)]
    if [len(b.transactions) for b in blocks] != [ntx] * heights:
        fail(f"{tag} blocks of {[len(b.transactions) for b in blocks]} txs, want {ntx} each")
    committed = [t.encode() for b in blocks for t in b.transactions]
    if sorted(committed) != sorted(frames):
        fail(f"{tag} the committed txs are not the frames sent")
    sealer_set = sorted(k.pub_bytes for k in keys)
    quorum = len(keys) - (len(keys) - 1) // 3
    for i, n in enumerate(nodes):
        hs = [n.ledger.header_by_number(h) for h in range(1, heights + 1)]
        if [x.hash(host) for x in hs] != [b.header.hash(host) for b in blocks]:
            fail(f"{tag} node {i}'s header hashes differ from node 0's")
        if not all(qc.verify_spans(hs, sealer_set, host)):
            fail(f"{tag} node {i}: a committed header lacks a seal quorum")
        if any(len(x.signature_list) < quorum for x in hs):
            fail(f"{tag} node {i}: a header carries fewer than {quorum} seals")
    t0 = time.perf_counter()
    ores, obal = pbft_oracle(host, blocks, [k.pub_bytes for k in keys], ntx,
                             cfg.compatibility_version)
    oracle_s = time.perf_counter() - t0
    want_heads = [(x.header.number, x.header.state_root, x.header.txs_root,
                   x.header.receipts_root) for x in ores]
    if [x.header.hash(host) for x in ores] != [b.header.hash(host) for b in blocks]:
        fail(f"{tag} the oracle's headers hash differently from the committed ones")
    want_bal = pbft_replay(tr["ops"], committed)
    for i, n in enumerate(nodes):
        heads = [(h.number, h.state_root, h.txs_root, h.receipts_root)
                 for h in (n.ledger.header_by_number(k) for k in range(1, heights + 1))]
        if heads != want_heads:
            fail(f"{tag} node {i}: (number, state, txs, receipts roots) differ from the oracle's")
        rows = {k: n.storage.get(pc.T_BALANCE, k) for k in n.storage.keys(pc.T_BALANCE)}
        if rows != obal:
            fail(f"{tag} node {i}: c_balance rows differ from the oracle's")
        if {k: int.from_bytes(v, "big") for k, v in rows.items()} != want_bal:
            fail(f"{tag} node {i}: c_balance rows differ from the Python replay")
    reverted = sum(x.status != 0 for res in ores for x in res.receipts)
    log(f"{tag} 4 nodes at height {heights}, header hashes equal, {quorum}+ seals each; "
        f"roots and {len(obal)} c_balance rows equal the host-suite oracle's "
        f"({oracle_s:.1f} s) and the Python replay; {reverted} transfers reverted")
    for b in blocks:
        log(f"{tag} block {b.header.number}: state root {b.header.state_root.hex()}")
    timings = dict(walls=r["walls"], heights=r["heights"], device_ms=dev_ms,
                   sign_s=tr["sign_s"], oracle_s=oracle_s, views=views, traffic=tr)
    return launches, site_launches, timings


# ---------------------------------------------------------------------------
# phase 14: durability (disk storage, snapshots, snap sync, a restart)
# ---------------------------------------------------------------------------
SNAP_INTERVAL = 2        # the source checkpoints at height 2 and prunes below it
SNAP_DEADLINE = 240.0    # s for each wait of the phase
SNAP_REPS = 5            # CUDA-event timings of the full-width chunk batch
KECCAK_ROUND_SASS = 195  # a Keccak round's SASS (tools/ec_kernel_probe.py --kernels merkle)
SM3_COMPRESS_SASS = 1269  # an SM3 compression's SASS (the same probe)
SASS_HZ = 1.98e9         # the SM clock under load


def snap_wait(tag: str, what: str, pred) -> None:
    deadline = time.monotonic() + SNAP_DEADLINE
    while not pred():
        if time.monotonic() > deadline:
            fail(f"{tag} {what} not reached in {SNAP_DEADLINE:.0f} s")
        time.sleep(0.005)


@contextlib.contextmanager
def timed_calls(owner, name: str, walls: list):
    """owner.name (a module's function or a class's method) wrapped so
    that each call appends its wall in ms to `walls`; restored on exit."""
    orig = getattr(owner, name)

    def inner(*a, **k):
        t0 = time.perf_counter()
        try:
            return orig(*a, **k)
        finally:
            walls.append((time.perf_counter() - t0) * 1e3)

    setattr(owner, name, inner)
    try:
        yield walls
    finally:
        setattr(owner, name, orig)


def chain_floor_ms(kind: str, steps: int) -> float:
    """The time of `steps` hash steps in series (Keccak permutations or SM3
    compressions: one lane absorbing one message, padding included) at the
    probe's SASS a step and the SM clock: the floor of a launch whose
    lanes absorb in parallel, set by its longest message."""
    per = 24 * KECCAK_ROUND_SASS if kind == "ecdsa" else SM3_COMPRESS_SASS
    return steps * per / SASS_HZ * 1e3


def snap_rows(node) -> dict:
    from fisco_bcos_tpu_torch.executor import precompiled as pc

    return {k: node.storage.get(pc.T_BALANCE, k) for k in node.storage.keys(pc.T_BALANCE)}


def snap_head(node, host):
    h = node.ledger.current_number()
    header = node.ledger.header_by_number(h)
    return h, header.hash(host), header.state_root


def phase_snap(dev, kind: str, tr, chain):
    """(14) Durability on the card: a pruning single-sealer source, a
    snap-sync joiner, a restart of both, on the disk engine with key
    pages, every suite call of the four Nodes recorded by site; then
    (d) the full-width export of phase 12's committed `chain` (storage,
    ledger). `tr` is phase 13's traffic (its frames are reused).
    -> (launches by kernel, launches by site, timings)."""
    import tempfile

    from fisco_bcos_tpu_torch.crypto.suite import make_suite
    from fisco_bcos_tpu_torch.init.node import Node, NodeConfig
    from fisco_bcos_tpu_torch.ledger.ledger import ConsensusNode
    from fisco_bcos_tpu_torch.net.gateway import FakeGateway
    from fisco_bcos_tpu_torch.net.moduleid import ModuleID
    from fisco_bcos_tpu_torch.ops import keccak, sm3
    from fisco_bcos_tpu_torch.snapshot import importer, service
    from fisco_bcos_tpu_torch.snapshot.manifest import unpack_chunk
    from fisco_bcos_tpu_torch.storage import KeyPageStorage
    from fisco_bcos_tpu_torch.storage.engine import DiskStorage
    from fisco_bcos_tpu_torch.sync.sync import BlockSync

    tag = f"[snap {kind}]"
    t_phase = time.perf_counter()
    ntx = PBFT_TXS[kind]
    frames = tr["frames"]
    if len(frames) != 3 * ntx:
        fail(f"{tag} phase 13's traffic holds {len(frames)} frames, not {3 * ntx}")
    suite = make_suite(kind == "sm", device=dev)
    host = make_suite(kind == "sm", backend="host")
    sealer = seal_keys(suite)[0]
    sealers = [ConsensusNode(sealer.pub_bytes)]
    base = dict(consensus="pbft", sm_crypto=kind == "sm", crypto_backend="device",
                device=str(dev), tx_count_limit=ntx, txpool_limit=PBFT_POOL_LIMIT,
                min_seal_time=PBFT_MIN_SEAL, view_timeout=PBFT_VIEW_TIMEOUT,
                ingest_max_batch=INGEST_MAX_BATCH, ingest_queue_cap=4 * len(frames),
                storage_backend="disk", profile_hz=0)
    root = tempfile.mkdtemp(prefix="chip_smoke_snap_")
    src_cfg = NodeConfig(**base, storage_path=f"{root}/source",
                         snapshot_interval=SNAP_INTERVAL, snapshot_prune=True,
                         snapshot_keep_tail=0)
    join_cfg = NodeConfig(**base, storage_path=f"{root}/joiner", snap_sync_threshold=1)
    joiner_kp = suite.generate_keypair(b"snap-joiner")
    counters = slice_counters(kind)
    calls: list = []

    def node(cfg, kp, gw, i):
        # the suite as Node builds it from cfg (init/node.py), recorded
        n = Node(cfg, keypair=kp, gateway=gw, suite=_Recorder(make_suite(
            cfg.sm_crypto, backend=cfg.crypto_backend, device=cfg.device,
            device_min_batch=cfg.device_min_batch,
            mesh_devices=cfg.crypto_mesh_devices), i, calls))
        n.build_genesis(sealers)
        st = n.storage
        if not (isinstance(st, KeyPageStorage) and isinstance(st.backend, DiskStorage)):
            fail(f"{tag} node {i}'s storage is {type(st).__name__}, not key pages "
                 f"over the disk engine")
        return n

    walls: dict = {k: [] for k in ("export", "verify", "install", "join", "tail_replay")}
    live: list = []

    def shut(nodes, gw):
        for n in nodes:
            n.stop()
        gw.stop()
        for n in nodes:
            n.storage.close()
            live.remove(n)

    try:
        with contextlib.ExitStack() as patches:
            patches.enter_context(timed_calls(service, "export_snapshot", walls["export"]))
            patches.enter_context(timed_calls(importer, "verify_snapshot", walls["verify"]))
            patches.enter_context(timed_calls(importer, "install_snapshot", walls["install"]))
            patches.enter_context(timed_calls(importer, "snap_sync", walls["join"]))
            patches.enter_context(timed_calls(BlockSync, "_apply_blocks", walls["tail_replay"]))
            for c in counters.values():
                c.launches = 0
            # (a) the pruning source
            gw = FakeGateway()
            src = node(src_cfg, sealer, gw, 0)
            live.append(src)
            t0 = time.perf_counter()
            src.ingest.start()
            if src.ingest.submit_many_wire_nowait(frames[:2 * ntx]) != 2 * ntx:
                fail(f"{tag} the source's ingest queue refused frames")
            snap_wait(tag, "2 blocks' txs in the pool",
                      lambda: src.txpool.pending_count() >= 2 * ntx)
            t_adm = time.perf_counter()
            src.start()
            snap_wait(tag, "height 2", lambda: src.ledger.current_number() >= 2)
            t_two = time.perf_counter()
            snap_wait(tag, "the checkpoint at height 2",
                      lambda: src.snapshot.store.latest_height() is not None)
            with src.snapshot._lock:   # its prune and compaction are done
                pass
            t_ckpt = time.perf_counter()
            if src.snapshot.store.heights() != [SNAP_INTERVAL] or \
                    src.ledger.pruned_below() != SNAP_INTERVAL:
                fail(f"{tag} the source holds checkpoints {src.snapshot.store.heights()} "
                     f"and pruned below {src.ledger.pruned_below()}, want "
                     f"[{SNAP_INTERVAL}] and {SNAP_INTERVAL}")
            if src.ledger.block_by_number(1, with_txs=True).transactions:
                fail(f"{tag} block 1's body survived the prune")
            if src.ingest.submit_many_wire_nowait(frames[2 * ntx:]) != ntx:
                fail(f"{tag} the source's ingest queue refused frames")
            snap_wait(tag, "height 3", lambda: src.ledger.current_number() >= 3)
            t_three = time.perf_counter()
            blocks = [src.ledger.block_by_number(h, with_txs=True) for h in (2, 3)]
            if src.ledger.current_number() != 3 or \
                    [len(b.transactions) for b in blocks] != [ntx, ntx]:
                fail(f"{tag} the source is at {src.ledger.current_number()} with blocks "
                     f"2-3 of {[len(b.transactions) for b in blocks]} txs, want {ntx} each")
            # (b) the joiner
            joiner = node(join_cfg, joiner_kp, gw, 1)
            live.append(joiner)
            executed: list = []
            run_block = joiner.scheduler.execute_block
            joiner.scheduler.execute_block = lambda block, *a, **k: (
                executed.append(block.header.number), run_block(block, *a, **k))[1]
            t_j = time.perf_counter()
            joiner.start()
            snap_wait(tag, "the joiner at height 3", lambda: joiner.ledger.current_number() >= 3)
            t_joined = time.perf_counter()
            if joiner.blocksync.sync_mode != "snap" or executed != [3]:
                fail(f"{tag} the joiner's sync mode is {joiner.blocksync.sync_mode!r} and it "
                     f"executed blocks {executed}: want 'snap' and block 3 only")
            manifest = src.snapshot.store.manifest(SNAP_INTERVAL)
            chunks = [src.snapshot.store.chunk(SNAP_INTERVAL, i)
                      for i in range(manifest.chunk_count)]
            adopted = joiner.snapshot.store
            served = src.front.request(ModuleID.SnapshotSync, joiner_kp.pub_bytes,
                                       importer.request_payload(importer.OP_MANIFEST),
                                       timeout=5.0)
            if adopted.heights() != [SNAP_INTERVAL] or served != manifest.encode() or \
                    [adopted.chunk(SNAP_INTERVAL, i) for i in range(len(chunks))] != chunks:
                fail(f"{tag} the joiner did not adopt the source's snapshot, or does not "
                     f"serve it")
            heads = [snap_head(n, host) for n in (src, joiner)]
            rows = [snap_rows(n) for n in (src, joiner)]
            if heads[0] != heads[1] or rows[0] != rows[1] or len(rows[0]) != ntx:
                fail(f"{tag} the joiner's head (height, hash, state root) or c_balance rows "
                     f"differ from the source's, or the source holds {len(rows[0])} of "
                     f"{ntx} accounts")
            if host.hash_batch(chunks) != manifest.chunk_hashes or \
                    host.merkle_root(manifest.chunk_hashes) != manifest.root:
                fail(f"{tag} the manifest's chunk hashes or root differ from the host suite's")
            # (c) the restart
            before, _ = service.export_snapshot(src.storage, src.ledger, src.suite)
            shut([src, joiner], gw)
            gw = FakeGateway()
            t_r = time.perf_counter()
            src2 = node(src_cfg, sealer, gw, 2)
            live.append(src2)
            joiner2 = node(join_cfg, joiner_kp, gw, 3)
            live.append(joiner2)
            t_reopen = time.perf_counter()
            for n in (src2, joiner2):
                n.start()
            again = [snap_head(n, host) for n in (src2, joiner2)]
            if again != heads or [snap_rows(n) for n in (src2, joiner2)] != rows:
                fail(f"{tag} after the restart the heads or c_balance rows differ")
            for n in (src2, joiner2):
                store = n.snapshot.store
                if store.heights() != [SNAP_INTERVAL] or \
                        store.manifest(SNAP_INTERVAL).encode() != manifest.encode():
                    fail(f"{tag} a restarted node's store lost the checkpoint")
            after, _ = service.export_snapshot(src2.storage, src2.ledger, src2.suite)
            if after.height != 3 or after.root != before.root:
                fail(f"{tag} the re-export at height {after.height} after the restart has "
                     f"another root than the one before it")
            shut([src2, joiner2], gw)
            torch.cuda.synchronize()
            launches = {k: c.launches for k, c in counters.items()}
    finally:
        for n in live:
            n.stop()
        for n in live:
            n.storage.close()
        shutil.rmtree(root, ignore_errors=True)
    by_site, site_launches, want = launches_by_site(kind, suite, calls)
    got = {k: n for k, n in launches.items() if n}
    log(f"{tag} launches {got}; by site: {site_launches}")
    if got != want:
        fail(f"{tag} the counters {got}, the recorded suite calls give {want}")
    names = {st: sorted(c[0] for c in cs) for st, cs in by_site.items()}
    if names.get("snap_seals", []).count("verify_batch") != 1 or \
            names.get("snap_verify") != ["hash_batch", "merkle_root"] or \
            names.get("snap_export") != ["hash_batch"] * 3 + ["merkle_root"] * 3:
        fail(f"{tag} the snapshot sites made the calls {names}: want one seal check "
             f"(its headers' hash batch and one verify_batch) and one hash batch and tree "
             f"on the join, one of each an export (3 exports)")
    missing = [k for k in counters if not launches[k]]
    if missing:
        fail(f"{tag} the phase did not launch {missing}")
    w = {k: sum(v) for k, v in walls.items()}
    if len(walls["verify"]) != 1 or len(walls["install"]) != 1 or len(walls["join"]) != 1:
        fail(f"{tag} verify, install and the join ran {len(walls['verify'])}, "
             f"{len(walls['install'])} and {len(walls['join'])} times, want once each")
    walls_ms = dict(
        admission=(t_adm - t0) * 1e3, two_blocks=(t_two - t_adm) * 1e3,
        checkpoint=(t_ckpt - t_two) * 1e3, block_3=(t_three - t_ckpt) * 1e3,
        export=walls["export"], verify=w["verify"], install=w["install"], join=w["join"],
        joiner_to_height_3=(t_joined - t_j) * 1e3, tail_replay=w["tail_replay"],
        reopen=(t_reopen - t_r) * 1e3)
    log(f"{tag} walls (ms): admission of 2 blocks {walls_ms['admission']:.1f}, blocks 1-2 "
        f"{walls_ms['two_blocks']:.1f}, checkpoint with prune and compaction "
        f"{walls_ms['checkpoint']:.1f}, block 3 {walls_ms['block_3']:.1f}; exports "
        + ", ".join(f"{x:.1f}" for x in walls["export"])
        + f" (checkpoint, before and after the restart); verify {w['verify']:.1f}, install "
        f"{w['install']:.1f} (verify included), the join (fetch, verify, install) "
        f"{w['join']:.1f}, the joiner from start to height 3 {walls_ms['joiner_to_height_3']:.1f}"
        f", tail replay {w['tail_replay']:.1f}; the restart (two Nodes reopened) "
        f"{walls_ms['reopen']:.1f}")
    log(f"{tag} checkpoint {SNAP_INTERVAL}: {manifest.chunk_count} chunks, "
        f"{manifest.total_bytes} B, root {manifest.root.hex()}; the joiner snap-synced it and "
        f"replayed block 3 only, head, state root and {len(rows[0])} c_balance rows equal the "
        f"source's, before and after the restart; chunk hashes and root equal the host suite's")

    # (d) the full-width export of phase 12's committed state
    storage, ledger = chain
    rec = _Recorder(suite)
    for c in counters.values():
        c.launches = 0
    (full, fchunks), exp_ms = wall_ms(lambda: service.export_snapshot(storage, ledger, rec))
    flaunch = {k: c.launches for k, c in counters.items() if c.launches}
    fwant = expected_launches(kind, suite, rec.calls)
    if flaunch != fwant:
        fail(f"{tag} the full-width export launched {flaunch}, its calls give {fwant}")
    if host.hash_batch(fchunks) != full.chunk_hashes or \
            host.merkle_root(full.chunk_hashes) != full.root:
        fail(f"{tag} the full-width manifest's chunk hashes or root differ from the host "
             f"suite's")
    hcls = keccak if kind == "ecdsa" else sm3
    vname = "keccak256_varlen" if kind == "ecdsa" else "sm3_varlen"
    packed = hcls.pack_batch_np(fchunks)
    tens = [(torch.as_tensor(b, device=dev), torch.as_tensor(nv, device=dev))
            for _, b, nv in packed]
    wrapper = counters[vname]
    # the classes launch one after another, so the batch's floor is the
    # sum of each class's longest message's chain
    class_steps = [int(nv.max()) for _, _, nv in packed]
    top = int(np.argmax(class_steps))
    batch_ms = flushed_event_ms(lambda: [wrapper(b, nv) for b, nv in tens], reps=SNAP_REPS)
    top_ms = flushed_event_ms(lambda: wrapper(*tens[top]), reps=SNAP_REPS)
    steps = class_steps[top]
    floor = chain_floor_ms(kind, steps)
    serial = sum(chain_floor_ms(kind, n) for n in class_steps)
    longest = max(fchunks, key=len)
    in_longest = unpack_chunk(longest)
    blocks_all = sum(int(nv.sum()) for _, _, nv in packed)
    bsize = keccak.RATE_BYTES if kind == "ecdsa" else sm3.BLOCK_BYTES
    bound, by = (keccak_bound if kind == "ecdsa" else sm3_bound)(
        blocks_all, bsize * blocks_all + 32 * len(fchunks))
    log(f"{tag} full-width export of phase 12's state at height {full.height}: "
        f"{full.chunk_count} chunks, {full.total_bytes} B, {len(packed)} length classes "
        f"(chunks, steps of the longest: {[(len(r), n) for (r, _, _), n in zip(packed, class_steps)]}), "
        f"{exp_ms:.1f} ms wall, launches {flaunch}; chunk hashes and root equal the host "
        f"suite's; the longest chunk ({len(longest)} B) holds {len(in_longest)} row(s), the "
        f"first of {in_longest[0][0]}")
    log(f"{tag} chunk batch: {batch_ms:.4f} ms device a batch (CUDA events, L2 flushed, "
        f"{SNAP_REPS} reps): {batch_ms / serial:.2f}x the classes' chain floors in series "
        f"({serial:.4f} ms); the longest chunk's class alone {top_ms:.4f} ms, {steps} steps in "
        f"series, chain floor {floor:.4f} ms ({top_ms / floor:.2f}x); bound {bound:.4f} ms "
        f"by {by}")
    log(f"{tag} phase 14: {time.perf_counter() - t_phase:.1f} s")
    timings = dict(walls=walls_ms, chunks=manifest.chunk_count, bytes=manifest.total_bytes,
                   full_chunks=full.chunk_count, full_bytes=full.total_bytes,
                   classes=len(packed), batch_ms=batch_ms, top_ms=top_ms, floor_ms=floor,
                   serial_floor_ms=serial, steps=steps)
    return launches, site_launches, timings


# ---------------------------------------------------------------------------
# phase 15: the serving edge (JSON-RPC over HTTP and WS, the query cache,
# subscriptions, the proof plane, tracing, metrics and the profiler)
# ---------------------------------------------------------------------------
SERVE_CLIENTS = 8        # SdkClient threads, as benchmark/chain_bench.py --read-clients 8
SERVE_BATCH = 256        # sendTransaction entries a JSON-RPC batch body (rpc_max_batch)
SERVE_WAVES = 1          # phase 13's height 1, the registers (a second wave: its transfers)
SERVE_MIN_SEAL = 60.0    # s: a block seals when it holds a suite CHUNK, never on time
SERVE_DEADLINE = 240.0   # s for each wait of the phase
SERVE_READS = 256        # receipts and proofs read after each commit
# of the proofs, this many from the block's head, whose proof documents
# the LRU (4,096 entries) evicted while priming the rest: each such miss
# rebuilds both trees of the block, its receipts' hash batch on the card
# included (ledger.receipt_proof); the others from the primed tail
SERVE_PROOF_MISSES = 8
SERVE_PUSHED = 64        # tx hashes with a receipt subscription
SERVE_CALLS = 64         # balanceOf calls after each commit
SERVE_TAMPERED = 0.01    # share of verifyProofs' items tampered
SERVE_TRACE = "5e" * 16  # the trace id of the one request under a sampled traceparent
SERVE_SERIES = ("bcos_rpc_cache_hits_total", "bcos_rpc_cache_misses_total",
                "bcos_rpc_cache_entries", "bcos_zk_proofs_rendered_total",
                "bcos_zk_proof_cache_hits_total", "bcos_zk_verify_calls_total")
SERVE_FAILED = ("cache-prime-failed", "proof-prime-failed", "ingest-dispatch-failed")


class _Failures(logging.Handler):
    """Collects the log records of the reference's best-effort catches
    (a failed prime or render, a failed lane or frame dispatch): a kernel
    failure on the card would end there, so any record fails the phase."""

    def __init__(self, needles=SERVE_FAILED):
        super().__init__(logging.WARNING)
        self.needles = needles
        self.seen: list = []

    def emit(self, record):
        msg = record.getMessage()
        if any(s in msg for s in self.needles):
            self.seen.append(msg[:200])


def serve_post(port: int, payload, headers=None):
    """One JSON-RPC POST on a fresh connection. -> (reply, its headers)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=SERVE_DEADLINE)
    try:
        conn.request("POST", "/", body=json.dumps(payload).encode(),
                     headers={"Content-Type": "application/json", **(headers or {})})
        r = conn.getresponse()
        return json.loads(r.read()), dict(r.getheaders())
    finally:
        conn.close()


def serve_get(port: int, path: str) -> tuple:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=SERVE_DEADLINE)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def serve_wave(url: str, frames, tag: str, groups=None):
    """The frames as JSON-RPC batch bodies of SERVE_BATCH sendTransaction
    entries (wait=false), each entry to group0 or to its frame's group in
    `groups`, posted by SERVE_CLIENTS SdkClient threads on keep-alive
    connections, each thread its share of the bodies in turn.
    -> (tx hash by frame, first POST time, last response time)."""
    import threading

    from fisco_bcos_tpu_torch.sdk.client import SdkClient

    group_of = dict(zip(frames, groups)) if groups is not None else {}
    bodies = [frames[i:i + SERVE_BATCH] for i in range(0, len(frames), SERVE_BATCH)]
    hashes: dict = {}
    errors: list = []
    stamps: list = []

    def client(k):
        sdk = SdkClient(url, timeout=SERVE_DEADLINE)
        try:
            for body in bodies[k::SERVE_CLIENTS]:
                resps = sdk.request_batch([
                    ("sendTransaction", [group_of.get(f, "group0"), "", "0x" + f.hex(), False,
                                         False]) for f in body])
                stamps.append(time.perf_counter())
                for f, r in zip(body, resps):
                    res = r.get("result")
                    if not isinstance(res, dict) or res.get("status") is not None:
                        errors.append(r)
                    else:
                        hashes[f] = bytes.fromhex(res["transactionHash"][2:])
        except Exception as exc:  # noqa: BLE001 — reported below, fails the phase
            errors.append(repr(exc))
        finally:
            sdk.close()

    threads = [threading.Thread(target=client, args=(k,), name=f"sdk-client-{k}")
               for k in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors or len(hashes) != len(frames):
        fail(f"{tag} {len(errors)} sendTransaction entries failed ({errors[:3]}), "
             f"{len(hashes)} of {len(frames)} admitted")
    return hashes, t0, max(stamps)


def tamper_items(items, rng):
    """SERVE_TAMPERED of verifyProofs' items changed: a first-level
    sibling beside the claimed slot, or the root. -> (items, indexes)."""
    bad = sorted(rng.sample(range(len(items)), max(1, round(len(items) * SERVE_TAMPERED))))
    out = [dict(it) for it in items]
    for j, i in enumerate(bad):
        it = out[i]
        if j % 2 == 0 and it["proof"]:
            lvl = [dict(x) for x in it["proof"]]
            sibs = list(lvl[0]["siblings"])
            k = (lvl[0]["index"] + 1) % len(sibs)
            sibs[k] = sibs[k][:-1] + ("0" if sibs[k][-1] != "0" else "1")
            lvl[0]["siblings"] = sibs
            it["proof"] = lvl
        else:
            it["root"] = it["root"][:-1] + ("0" if it["root"][-1] != "0" else "1")
    return out, bad


def phase_serve(dev, kind: str, tr):
    """(15) The serving edge on the card: one single-sealer PBFT Node
    (crypto_backend "device", memory storage, blocks of one suite CHUNK,
    rpc_port, ws_port and metrics_port 0, every other serving field at
    the JAX defaults: 8 workers, batches of 256, a query cache of 4,096
    entries and 64 MB, trace sampling 0.02, the profiler at 5 Hz).
    Phase 13's first SERVE_WAVES heights (`tr`) go in over JSON-RPC in
    as many waves, each once every receipt of the one before is there:
    SERVE_CLIENTS
    SdkClient threads post batch bodies of SERVE_BATCH sendTransaction
    entries (wait=false), one tx alone under a sampled traceparent. A
    WsSdkClient session holds newBlockHeaders and SERVE_PUSHED receipt
    subscriptions. After each commit: getBlockByNumber hot (the cache)
    and cold (an uncached JsonRpcImpl over the node: one recover batch),
    SERVE_READS proofs (SERVE_PROOF_MISSES of them evicted) and
    receipts in one batch each, verifyProofs over
    their tx and receipt proofs (1% tampered), balanceOf SERVE_CALLS
    times, getSystemStatus and getAuditReport; then getTrace of the
    traced request and GET /metrics, /status and /profile. The suite
    calls are recorded by site; the counters, zeroed before the first
    POST and read after the node stops, must equal the launches they
    imply. -> (launches by kernel, launches by site, timings)."""
    from fisco_bcos_tpu_torch.codec.wire import Reader
    from fisco_bcos_tpu_torch.crypto.suite import CHUNK, make_suite
    from fisco_bcos_tpu_torch.executor import precompiled as pc
    from fisco_bcos_tpu_torch.init.node import Node, NodeConfig
    from fisco_bcos_tpu_torch.ledger.ledger import ConsensusNode
    from fisco_bcos_tpu_torch.net.gateway import FakeGateway
    from fisco_bcos_tpu_torch.protocol import types as T
    from fisco_bcos_tpu_torch.rpc.server import JsonRpcImpl, _receipt_json
    from fisco_bcos_tpu_torch.sdk.client import SdkClient
    from fisco_bcos_tpu_torch.sdk.ws import WsSdkClient
    from fisco_bcos_tpu_torch.zk import proof as zkproof

    tag = f"[serve {kind}]"
    ntx = PBFT_TXS[kind]
    frames = tr["frames"][:SERVE_WAVES * ntx]
    if len(frames) != SERVE_WAVES * ntx:
        fail(f"{tag} phase 13's traffic holds {len(tr['frames'])} frames, want "
             f"{SERVE_WAVES * ntx} or more")
    waves = [frames[w * ntx:(w + 1) * ntx] for w in range(SERVE_WAVES)]
    rng = random.Random(SEED + 15)
    suite = make_suite(kind == "sm", device=dev)
    host = make_suite(kind == "sm", backend="host")
    sealer = seal_keys(suite)[0]
    cfg = NodeConfig(consensus="pbft", sm_crypto=kind == "sm", crypto_backend="device",
                     device=str(dev), tx_count_limit=ntx, txpool_limit=PBFT_POOL_LIMIT,
                     min_seal_time=SERVE_MIN_SEAL, view_timeout=PBFT_VIEW_TIMEOUT,
                     rpc_port=0, ws_port=0, metrics_port=0)
    counters = slice_counters(kind)
    calls: list = []
    gw = FakeGateway()
    # the suite as Node builds it from cfg (init/node.py), recorded
    node = Node(cfg, keypair=sealer, gateway=gw, suite=_Recorder(make_suite(
        cfg.sm_crypto, backend=cfg.crypto_backend, device=cfg.device,
        device_min_batch=cfg.device_min_batch, mesh_devices=cfg.crypto_mesh_devices), 0, calls))
    node.build_genesis([ConsensusNode(sealer.pub_bytes)])
    if node.query_cache is None or node.subhub is None or node.ws is None or \
            node.metrics is None or (node.config.rpc_workers, node.config.rpc_max_batch,
                                     node.config.rpc_cache_entries, node.config.profile_hz) \
            != (8, 256, 4096, 5.0):
        fail(f"{tag} the node's serving planes are not the JAX defaults")
    commits: dict = {}
    # first of the commit observers: the cache prime and the push fan-out
    # run after it on the same notifier thread
    node.scheduler.on_commit.insert(0, lambda n: commits.setdefault(n, time.perf_counter()))
    direct: list = []   # send_transaction's direct-path fallback: txpool.submit
    submit = node.txpool.submit
    node.txpool.submit = lambda *a, **k: (direct.append(1), submit(*a, **k))[1]
    failures = _Failures()
    logging.getLogger("bcos-tpu").addHandler(failures)
    sessions: list = []
    walls: dict = {"admission": [], "tx_per_s": [], "last_admission_to_commit": [], "prime": [],
                   "hot_block": [], "cold_block": [], "proofs_primed": [],
                   "proofs_evicted": [], "verify_proofs": [],
                   "receipts": [], "calls": []}
    reads: dict = {"served": {}, "verdicts": [], "tampered": 0, "balances": [],
                   "cold_recovers": []}
    lane_stats, marks = [], []
    stopped = []

    def stop():
        if not stopped:
            stopped.append(True)
            for s in sessions:
                s.close()
            node.stop()
            gw.stop()

    try:
        node.start()
        url = f"http://{node.rpc.host}:{node.rpc.port}"
        sdk = SdkClient(url, timeout=SERVE_DEADLINE)
        sessions.append(sdk)
        push = WsSdkClient(node.ws.host, node.ws.port)
        sessions.append(push)
        wave_hashes = [[T.Transaction.decode(f).hash(host) for f in w] for w in waves]
        pushed = rng.sample([h for w in wave_hashes for h in w], SERVE_PUSHED)
        push.subscribe("newBlockHeaders")
        for h in pushed:
            push.subscribe("receipt", {"txHash": "0x" + h.hex()})
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        t_first = None
        for w, wave in enumerate(waves):
            height = w + 1
            if w == 0:
                # one tx alone under a sampled W3C traceparent header
                tp = f"00-{SERVE_TRACE}-{'7f' * 8}-01"
                t_first = time.perf_counter()
                rep, hdrs = serve_post(node.rpc.port, {
                    "jsonrpc": "2.0", "id": 1, "method": "sendTransaction",
                    "params": ["group0", "", "0x" + wave[-1].hex(), False, False]},
                    {"traceparent": tp})
                if rep.get("result", {}).get("transactionHash") != \
                        "0x" + wave_hashes[0][-1].hex() or hdrs.get("traceparent") != tp:
                    fail(f"{tag} the traced sendTransaction answered {rep} with "
                         f"traceparent {hdrs.get('traceparent')}")
                got, t0, t_last = serve_wave(url, wave[:-1], tag)
            else:
                got, t0, t_last = serve_wave(url, wave, tag)
                t_first = t0
            want = dict(zip(wave, wave_hashes[w]))
            if any(got[f] != want[f] for f in got):
                fail(f"{tag} a sendTransaction reply carries another hash than the host "
                     f"suite's")
            walls["admission"].append((t_last - t_first) * 1e3)
            walls["tx_per_s"].append(ntx / (t_last - t_first))
            snap_wait(tag, f"height {height}", lambda: node.ledger.current_number() >= height)
            snap_wait(tag, f"block {height}'s proofs rendered",
                      lambda: node.zk.stats()["proofsRendered"] >= height * ntx)
            walls["last_admission_to_commit"].append((commits[height] - t_last) * 1e3)
            walls["prime"].append((time.perf_counter() - commits[height]) * 1e3)
            missing = [h for h in wave_hashes[w] if node.ledger.receipt(h) is None]
            if missing or len(node.ledger.tx_hashes_by_number(height)) != ntx:
                fail(f"{tag} block {height} holds "
                     f"{len(node.ledger.tx_hashes_by_number(height))} txs and "
                     f"{len(missing)} of the wave's receipts are missing")
            lane_stats.append(node.ingest.stats())
            marks.append(len(calls))   # the wave's admission calls end before here
            log(f"{tag} wave {height}: admission over RPC {walls['admission'][-1]:.1f} ms "
                f"({walls['tx_per_s'][-1]:.0f} tx/s), last admission to commit "
                f"{walls['last_admission_to_commit'][-1]:.1f} ms, the prime "
                f"{walls['prime'][-1]:.1f} ms; lane {lane_stats[-1]}")
            # -- reads after the commit -----------------------------------
            # by the block's order, the order of the prime's puts: the last
            # ones still cached (the byte bound may hold fewer than 4,096)
            order = node.ledger.tx_hashes_by_number(height)
            tail = order[-4 * SERVE_READS:]
            head = order[:-cfg.rpc_cache_entries]
            nmiss = min(SERVE_PROOF_MISSES, len(head))
            sample = rng.sample(tail, SERVE_READS - nmiss) + rng.sample(head, nmiss)
            for part, hs in (("proofs_primed", sample[:SERVE_READS - nmiss]),
                             ("proofs_evicted", sample[SERVE_READS - nmiss:])):
                t0 = time.perf_counter()
                docs = sdk.request_batch([("getProof", ["group0", "", "0x" + h.hex()])
                                          for h in hs]) if hs else []
                walls[part].append((time.perf_counter() - t0) * 1e3)
                reads.setdefault("docs", []).extend(zip(hs, docs))
            cold = JsonRpcImpl(node)
            cold.cache = None
            k0 = len(calls)
            t0 = time.perf_counter()
            cold_doc = cold.get_block_by_number("group0", "", height)
            torch.cuda.synchronize()
            walls["cold_block"].append((time.perf_counter() - t0) * 1e3)
            reads["cold_recovers"].append([(c[0], c[1]) for c in calls[k0:]
                                           if c[0] in ("recover_addresses", "recover_batch")])
            for _ in range(2):   # the first may miss (the LRU evicted it while priming)
                t0 = time.perf_counter()
                hot = sdk.get_block_by_number(height)
                walls["hot_block"].append((time.perf_counter() - t0) * 1e3)
            if json.loads(json.dumps(cold_doc)) != hot or len(hot["transactions"]) != ntx:
                fail(f"{tag} block {height}'s JSON from the cache differs from the cold render")
            firsts = node.ledger.block_by_number(height, with_txs=True).transactions[:8]
            if [t["from"] for t in hot["transactions"][:8]] != [
                    "0x" + T.Transaction.decode(t.encode()).sender(host).hex() for t in firsts]:
                fail(f"{tag} block {height}'s senders differ from the host suite's")
            polled = rng.sample(wave_hashes[w], SERVE_READS)
            t0 = time.perf_counter()
            rcs = sdk.request_batch([("getTransactionReceipt", ["group0", "", "0x" + h.hex()])
                                     for h in polled])
            walls["receipts"].append((time.perf_counter() - t0) * 1e3)
            for h, r in zip(polled, rcs):
                reads["served"][h] = r.get("result")
            items = []
            for h, d in reads.pop("docs"):
                reply, d = d, d.get("result") or {}
                if not d.get("found"):
                    fail(f"{tag} getProof found no proof of {h.hex()}: {str(reply)[:300]}")
                items.append({"leaf": "0x" + h.hex(), "proof": d["txProof"],
                              "root": d["txsRoot"]})
                items.append({"leaf": "0x" + node.ledger.receipt(h).hash(host).hex(),
                              "proof": d["receiptProof"], "root": d["receiptsRoot"]})
            items, bad = tamper_items(items, rng)
            t0 = time.perf_counter()
            verdict = sdk.request("verifyProofs", ["group0", "", items])
            walls["verify_proofs"].append((time.perf_counter() - t0) * 1e3)
            oracle = zkproof.verify_inclusion_batch(host, [
                (bytes.fromhex(it["leaf"][2:]), zkproof.w16_proof_from_json(it["proof"]),
                 bytes.fromhex(it["root"][2:])) for it in items])
            want_v = [i not in bad for i in range(len(items))]
            if verdict["results"] != oracle.tolist() or verdict["results"] != want_v:
                fail(f"{tag} verifyProofs' verdicts differ from the host suite's or from "
                     f"the tampering: {sum(verdict['results'])} true of {len(items)}, "
                     f"{len(bad)} tampered")
            reads["verdicts"].append(len(items))
            reads["tampered"] += len(bad)
            accounts = rng.sample(tr["accounts"], SERVE_CALLS)
            t0 = time.perf_counter()
            outs = [sdk.call(pc.BALANCE_ADDRESS, pc.encode_call(
                "balanceOf", lambda wr, a=a: wr.blob(a))) for a in accounts]
            walls["calls"].append((time.perf_counter() - t0) * 1e3)
            reads["balances"].append((height, accounts, outs))
            status = sdk.request("getSystemStatus", ["group0"])
            audit = sdk.request("getAuditReport", ["group0"])
            if status["blockNumber"] != height or not audit["ok"]:
                fail(f"{tag} getSystemStatus says height {status['blockNumber']}, "
                     f"getAuditReport {audit}")
        trace_doc = sdk.request("getTrace", ["group0", "", SERVE_TRACE])
        metrics_rpc = serve_get(node.rpc.port, "/metrics")
        metrics_port = serve_get(node.metrics.port, "/metrics")
        status_http = serve_get(node.rpc.port, "/status")
        profile = serve_get(node.rpc.port, "/profile")
        events = []
        deadline = time.monotonic() + SERVE_DEADLINE
        while len(events) < SERVE_PUSHED + SERVE_WAVES and time.monotonic() < deadline:
            ev = push.next_event(0.5)
            if ev is not None:
                events.append(ev)
        headers_polled = [sdk.get_block_by_number(h, only_header=True)
                          for h in range(1, SERVE_WAVES + 1)]
        polled_pushed = sdk.request_batch([("getTransactionReceipt",
                                            ["group0", "", "0x" + h.hex()]) for h in pushed])
        cache, zk, subs = node.query_cache.stats(), node.zk.stats(), node.subhub.stats()
        t_stop = time.perf_counter()
        stop()   # no suite call after this: the counters are final
        torch.cuda.synchronize()
        launches = {k: c.launches for k, c in counters.items()}
        stop_ms = (time.perf_counter() - t_stop) * 1e3
    finally:
        stop()
        node.txpool.submit = submit
        logging.getLogger("bcos-tpu").removeHandler(failures)
        from fisco_bcos_tpu_torch.analysis import profiler
        profiler.configure(hz=0)   # the process-wide sampler thread ends

    # -- checks ---------------------------------------------------------------
    if failures.seen:
        fail(f"{tag} a best-effort catch fired: {failures.seen[:3]}")
    if direct:
        fail(f"{tag} send_transaction took its direct-path fallback {len(direct)} times")
    if zk["proofsRendered"] != SERVE_WAVES * ntx:
        fail(f"{tag} {zk['proofsRendered']} proofs rendered, want {SERVE_WAVES * ntx}")
    by_site, site_launches, want = launches_by_site(kind, suite, calls)
    got = {k: n for k, n in launches.items() if n}
    log(f"{tag} launches {got}; by site: {site_launches}")
    log(f"{tag} suite calls by site: "
        + ", ".join(f"{s} {len(cs)}" for s, cs in sorted(by_site.items())))
    if got != want:
        fail(f"{tag} the counters {got}, the recorded suite calls give {want}")
    eck = "ecdsa_recover" if kind == "ecdsa" else "sm2_verify"
    hashk = "keccak256_varlen" if kind == "ecdsa" else "sm3_varlen"
    for site, k in (("admission", eck), ("cold_senders", eck), ("prime", hashk),
                    ("verify_proofs", hashk), ("pbft_seals", eck if kind == "sm"
                                               else "ecdsa_verify")):
        if not site_launches.get(site, {}).get(k):
            fail(f"{tag} {k} was not launched by {site}: {site_launches.get(site)}")
    cold = reads["cold_recovers"]
    if any(len(c) != 1 or c[0][1] != ntx for c in cold):
        fail(f"{tag} a cold getBlockByNumber made the recover calls {cold}, want one "
             f"batch of {ntx}")
    vp = by_site.get("verify_proofs", [])
    if [c[0] for c in vp] != ["hash_batch"] * SERVE_WAVES:
        fail(f"{tag} verifyProofs made the calls {[c[0] for c in vp]}, want one hash "
             f"batch a request")
    missing = [k for k in counters if not launches[k]]
    if missing:
        fail(f"{tag} the phase did not launch {missing}")
    spans = {s["name"] for s in trace_doc["spans"]}
    if "rpc.sendTransaction" not in spans:
        fail(f"{tag} getTrace of the traced request holds {sorted(spans)}, not "
             f"rpc.sendTransaction")
    texts = [metrics_rpc[1].decode(), metrics_port[1].decode()]
    absent = [s for s in SERVE_SERIES for t in texts if s not in t]
    if metrics_rpc[0] != 200 or metrics_port[0] != 200 or absent:
        fail(f"{tag} GET /metrics answered {metrics_rpc[0]} and {metrics_port[0]}, "
             f"without {sorted(set(absent))}")
    series = sorted({ln.split("{")[0].split(" ")[0] for ln in texts[0].splitlines()
                     if ln.startswith(("bcos_rpc_", "bcos_zk_"))})
    roles = {ln.split(";", 1)[0] for ln in profile[1].decode().splitlines()}
    if profile[0] != 200 or not {"edge", "ingest"} <= roles:
        fail(f"{tag} GET /profile answered {profile[0]} with the roles {sorted(roles)}")
    if status_http[0] != 200 or json.loads(status_http[1])["blockNumber"] != SERVE_WAVES:
        fail(f"{tag} GET /status answered {status_http[0]}")
    # pushes: every one arrived and equals the polled JSON
    by_kind: dict = {}
    for ev in events:
        by_kind.setdefault(ev["kind"], []).append(ev["result"])
    if by_kind.get("newBlockHeaders") != headers_polled:
        fail(f"{tag} the newBlockHeaders pushes differ from the polled headers")
    pushed_rc = {r["transactionHash"]: r for r in by_kind.get("receipt", [])}
    if len(pushed_rc) != SERVE_PUSHED or any(
            pushed_rc.get("0x" + h.hex()) != r["result"] for h, r in zip(pushed, polled_pushed)):
        fail(f"{tag} {len(pushed_rc)} of {SERVE_PUSHED} receipt pushes arrived, or one "
             f"differs from the polled receipt")
    for h, r in zip(pushed, polled_pushed):
        reads["served"][h] = r["result"]
    # the chain against a solo Scheduler on the host suite and a Python replay
    blocks = [node.ledger.block_by_number(h, with_txs=True) for h in range(1, SERVE_WAVES + 1)]
    committed = [t.encode() for b in blocks for t in b.transactions]
    if sorted(committed) != sorted(frames):
        fail(f"{tag} the committed txs are not the frames sent")
    t0 = time.perf_counter()
    ores, obal = pbft_oracle(host, blocks, [sealer.pub_bytes], ntx, cfg.compatibility_version)
    oracle_s = time.perf_counter() - t0
    heads = [(h.number, h.state_root, h.txs_root, h.receipts_root)
             for h in (b.header for b in blocks)]
    if heads != [(x.header.number, x.header.state_root, x.header.txs_root,
                  x.header.receipts_root) for x in ores]:
        fail(f"{tag} (number, state, txs, receipts roots) differ from the oracle's")
    rows = {k: node.storage.get(pc.T_BALANCE, k) for k in node.storage.keys(pc.T_BALANCE)}
    want_bal = pbft_replay(tr["ops"], committed)
    if rows != obal or {k: int.from_bytes(v, "big") for k, v in rows.items()} != want_bal:
        fail(f"{tag} c_balance rows differ from the oracle's or from the Python replay")
    oracle_rc = {}   # as the ledger keeps them: the message is not stored
    for b, x in zip(blocks, ores):
        for t, rc in zip(b.transactions, x.receipts):
            oracle_rc[t.hash(host)] = _receipt_json(T.Receipt.decode(rc.encode()), t.hash(host))
    wrong = [h for h, r in reads["served"].items() if r != oracle_rc.get(h)]
    if wrong:
        log(f"{tag} a receipt served {reads['served'][wrong[0]]}, the oracle's "
            f"{oracle_rc.get(wrong[0])}")
        fail(f"{tag} {len(wrong)} of {len(reads['served'])} receipts served differ from the "
             f"oracle's")
    for height, accounts, outs in reads["balances"]:
        bal = pbft_replay(tr["ops"], committed[:height * ntx])
        if [Reader(bytes.fromhex(o["output"][2:])).u64() if o["status"] == 0 else None
                for o in outs] != [bal.get(a) for a in accounts]:
            fail(f"{tag} balanceOf after block {height} differs from the Python replay")
    adm = [[c[1] for c in calls[lo:hi] if c[4] == "admission" and c[0] == "recover_addresses"]
           for lo, hi in zip([0] + marks[:-1], marks)]
    sizes = np.array([s for a in adm for s in a] or [0])
    reverted = sum(x.status != 0 for res in ores for x in res.receipts)
    timings = dict(walls=walls, lane=lane_stats, cache=cache, zk=zk, subs=subs,
                   oracle_s=oracle_s, stop_ms=stop_ms,
                   dispatch=dict(n=[len(a) for a in adm], mean=float(sizes.mean()),
                                 median=float(np.median(sizes)), max=int(sizes.max()),
                                 recover_launches=[sum(-(-s // CHUNK) for s in a)
                                                   for a in adm]))
    log(f"{tag} {SERVE_WAVES} blocks of {ntx} txs over JSON-RPC ({SERVE_CLIENTS} clients, "
        f"batches of {SERVE_BATCH}); roots and {len(rows)} c_balance rows equal the host-suite "
        f"oracle's ({oracle_s:.1f} s) and the Python replay, {reverted} transfers reverted; "
        f"{len(reads['served'])} receipts served equal the oracle's; verifyProofs exact on "
        f"{sum(reads['verdicts'])} items ({reads['tampered']} tampered); "
        f"{SERVE_PUSHED} receipt and {SERVE_WAVES} header pushes equal the polled JSON; "
        f"{zk['proofsRendered']} proofs rendered; direct-path fallbacks 0; the traced "
        f"request's spans {sorted(spans)}; GET /metrics (the edge and the metrics port) "
        f"serves {series}; GET /profile's roles {sorted(roles)}")
    log(f"{tag} walls (ms): admission over RPC "
        + ", ".join(f"{x:.1f}" for x in walls["admission"])
        + " (" + ", ".join(f"{x:.0f} tx/s" for x in walls["tx_per_s"]) + "); last admission "
        "to commit " + ", ".join(f"{x:.1f}" for x in walls["last_admission_to_commit"])
        + "; commit to the block's proofs rendered (the prime) "
        + ", ".join(f"{x:.1f}" for x in walls["prime"]) + "; getBlockByNumber cold " + ", ".join(f"{x:.1f}" for x in walls["cold_block"])
        + ", over HTTP (first, second) " + ", ".join(f"{x:.1f}" for x in walls["hot_block"])
        + f"; {SERVE_READS} receipts " + ", ".join(f"{x:.1f}" for x in walls["receipts"])
        + f"; getProof of {SERVE_READS}: the primed ones "
        + ", ".join(f"{x:.1f}" for x in walls["proofs_primed"]) + ", the evicted ones ("
        + f"up to {SERVE_PROOF_MISSES}) " + ", ".join(f"{x:.1f}" for x in walls["proofs_evicted"])
        + f"; verifyProofs of {2 * SERVE_READS} " + ", ".join(
            f"{x:.1f}" for x in walls["verify_proofs"])
        + f"; {SERVE_CALLS} balanceOf " + ", ".join(f"{x:.1f}" for x in walls["calls"])
        + f"; the node's stop {stop_ms:.1f}")
    d = timings["dispatch"]
    log(f"{tag} ingest lane: {lane_stats[-1]['batches_total']} dispatches for "
        f"{lane_stats[-1]['txs_total']} txs (mean {lane_stats[-1]['mean_batch']}); the "
        f"admission's recover batches a wave: {d['n']}, of mean {d['mean']:.1f}, median "
        f"{d['median']:.0f}, max {d['max']} txs; {eck} launches a wave "
        f"{d['recover_launches']}")
    log(f"{tag} query cache: {cache}; zk: {zk}; subscriptions: {subs}")
    return launches, site_launches, timings


# ---------------------------------------------------------------------------
# phase 16: the p2p socket transport (plain TCP, SM-TLS) and the light node
# ---------------------------------------------------------------------------
P2P_MIN_SEAL = 60.0      # s: height 1 seals when the pool holds its block, never on time
P2P_DEADLINE = 240.0     # s for each wait of the phase
P2P_SPAN = 1024          # seeded tx hashes of block 1 a light-client span
P2P_REDIAL = 0.1         # s between a gateway's dial passes (the reference's default is 1)
P2P_FAILED = ("dispatch-failed", "bad-zstd-frame", "overlong-inflate", "zstd-frame-unsupported",
              "send-queue-full", "no-route", "peer-rejected-acl")


def p2p_wait(tag: str, what: str, pred) -> None:
    deadline = time.monotonic() + P2P_DEADLINE
    while not pred():
        if time.monotonic() > deadline:
            fail(f"{tag} {what} not reached in {P2P_DEADLINE:.0f} s")
        time.sleep(0.005)


def phase_p2p(dev, kind: str, tr):
    """(16) Four port Nodes (crypto_backend "device") on their own
    P2PGateways bound to 127.0.0.1, port 0, in a full mesh: plain TCP on
    the default chain, SM-TLS on the SM chain (a seeded
    CertificateAuthority, one dual-cert credential a node, as the
    reference selects GM TLS when sm_crypto is on). Height 1 of phase 13's
    traffic (`tr`) at full width goes in through node 0's ingest lane and
    txsync gossips it over the sockets; the nodes commit it. A fifth
    gateway, holding no sealer key, dials node 0 only; its
    LightNodeClient on a device suite asks status, header_range over the
    committed heights, transactions and receipts spans of P2P_SPAN seeded
    hashes of the block, one transaction, send_transaction of one fresh
    tx, then a rogue sealer set and a tampered proof root, which must be
    rejected; a host-suite client over the same front must give the same
    verdicts and payloads. Every suite call of the five is recorded by
    site; the counters, zeroed before the frames go in and read after
    everything stops, must equal the launches they imply. No profiler
    session. -> (launches by kernel, launches by site, timings)."""
    from fisco_bcos_tpu_torch.consensus import qc
    from fisco_bcos_tpu_torch.consensus.pbft.engine import PBFTEngine
    from fisco_bcos_tpu_torch.crypto.suite import make_suite
    from fisco_bcos_tpu_torch.executor import precompiled as pc
    from fisco_bcos_tpu_torch.init.node import Node, NodeConfig
    from fisco_bcos_tpu_torch.ledger.ledger import ConsensusNode
    from fisco_bcos_tpu_torch.lightnode import LightNodeClient, LightNodeServer
    from fisco_bcos_tpu_torch.net import p2p, smtls
    from fisco_bcos_tpu_torch.net.front import FrontService
    from fisco_bcos_tpu_torch.protocol import BlockHeader
    from fisco_bcos_tpu_torch.protocol import types as T

    tag = f"[p2p {kind}]"
    t_phase = time.perf_counter()
    ntx = PBFT_TXS[kind]
    frames = tr["frames"][:ntx]
    if len(frames) != ntx:
        fail(f"{tag} phase 13's traffic holds {len(tr['frames'])} frames, want {ntx} or more")
    suite = make_suite(kind == "sm", device=dev)
    host = make_suite(kind == "sm", backend="host")
    keys = seal_keys(suite)
    sealers = [ConsensusNode(k.pub_bytes) for k in keys]
    sealer_set = sorted(k.pub_bytes for k in keys)
    first = sealer_set[1 % len(keys)]   # leads height 1 in view 0
    # the smaller node id of a pair dials (net/p2p.py _install): the light
    # client's key is the first seeded one under node 0's, so the light
    # gateway dials node 0 and node 0 dials nothing of it
    light_kp = next(kp for kp in (suite.generate_keypair(b"p2p-light%d" % s) for s in range(256))
                    if kp.pub_bytes < keys[0].pub_bytes)
    cfg = NodeConfig(consensus="pbft", sm_crypto=kind == "sm", crypto_backend="device",
                     device=str(dev), tx_count_limit=ntx, txpool_limit=PBFT_POOL_LIMIT,
                     min_seal_time=P2P_MIN_SEAL, view_timeout=PBFT_VIEW_TIMEOUT,
                     ingest_max_batch=INGEST_MAX_BATCH, ingest_queue_cap=4 * ntx, profile_hz=0)
    counters = slice_counters(kind)
    verk = "ecdsa_verify" if kind == "ecdsa" else "sm2_verify"
    eck = "ecdsa_recover" if kind == "ecdsa" else "sm2_verify"
    hashk = "keccak256_varlen" if kind == "ecdsa" else "sm3_varlen"
    handshakes: list = []   # (ms, ok, what)

    class TimedTLS(smtls.SMTLSContext):
        """The SM-TLS context, each handshake timed and its failure kept."""

        def wrap_socket(self, sock, server_side=False, server_hostname=None):
            t0 = time.perf_counter()
            try:
                out = super().wrap_socket(sock, server_side, server_hostname)
            except Exception as exc:
                handshakes.append(((time.perf_counter() - t0) * 1e3, False, repr(exc)[:120]))
                raise
            handshakes.append(((time.perf_counter() - t0) * 1e3, True, "smtls"))
            return out

    ctxs = [None] * 5
    if kind == "sm":
        ca = smtls.CertificateAuthority(seed=b"p2p-chain-ca" * 3)
        ctxs = [TimedTLS(ca.pub, ca.issue(f"node{i}", seed=b"p2p-node%d" % i))
                for i in range(4)]
        ctxs.append(TimedTLS(ca.pub, ca.issue("light", seed=b"p2p-light")))
    calls: list = []
    failures = _Failures(P2P_FAILED)
    logging.getLogger("bcos-tpu").addHandler(failures)
    gws, nodes, live = [], [], []
    walls: dict = {}
    commits: list = [{} for _ in range(4)]
    preprepares: dict = {}
    orig_pp = PBFTEngine._broadcast_preprepare
    orig_hello = p2p.P2PGateway._handshake

    def stamped(engine, block, carried=False):
        preprepares.setdefault(block.header.number, (engine.index, time.perf_counter()))
        return orig_pp(engine, block, carried)

    def hello(gw, sock):
        t0 = time.perf_counter()
        out = orig_hello(gw, sock)
        handshakes.append(((time.perf_counter() - t0) * 1e3, out is not None, "hello"))
        return out

    def stop():
        while live:
            live.pop().stop()
        for gw in gws:
            gw.stop()

    light_calls: dict = {}
    try:
        PBFTEngine._broadcast_preprepare = stamped
        p2p.P2PGateway._handshake = hello
        for c in counters.values():
            c.launches = 0
        t_gw = time.perf_counter()
        gws = [p2p.P2PGateway(kp.pub_bytes, host="127.0.0.1", port=0, server_ssl=ctx,
                              client_ssl=ctx, reconnect_interval=P2P_REDIAL)
               for kp, ctx in zip(keys, ctxs)]
        # each node's suite as Node builds it from cfg (init/node.py), recorded
        for i, kp in enumerate(keys):
            n = Node(cfg, keypair=kp, gateway=gws[i], suite=_Recorder(make_suite(
                cfg.sm_crypto, backend=cfg.crypto_backend, device=cfg.device,
                device_min_batch=cfg.device_min_batch,
                mesh_devices=cfg.crypto_mesh_devices), i, calls))
            nodes.append(n)
            live.append(n)
            n.build_genesis(sealers)
            if n.suite.backend != "device" or n.suite.device.type != dev.type:
                fail(f"{tag} node {i}'s suite is on {n.suite.backend!r} on {n.suite.device}")
            if not isinstance(n.lightnode_server, LightNodeServer):
                fail(f"{tag} node {i} built no light-node server")
            n.scheduler.on_commit.append(
                lambda num, i=i: commits[i].setdefault(num, time.perf_counter()))
        lgw = p2p.P2PGateway(light_kp.pub_bytes, host="127.0.0.1", port=0,
                             server_ssl=ctxs[4], client_ssl=ctxs[4],
                             reconnect_interval=P2P_REDIAL)
        gws.append(lgw)
        lfront = FrontService(light_kp.pub_bytes, lgw)
        # the mesh, one link at a time: the smaller id of a pair dials
        # (net/p2p.py _install), and a handshake run alone stays far
        # inside the dial's 3 s socket timeout (the SM-TLS handshake's SM2
        # is pure Python: seven at once under one GIL time out)
        links = [(i, j) for i in range(4) for j in range(i + 1, 4)] + [(4, 0)]
        for i, j in links:
            a, b = sorted((i, j), key=lambda k: gws[k].node_id)
            gws[a].add_peer(gws[b].host, gws[b].port)
            p2p_wait(tag, f"the session of gateways {a} and {b}",
                     lambda: gws[b].node_id in gws[a]._sessions
                     and gws[a].node_id in gws[b]._sessions)
        p2p_wait(tag, "every session up", lambda: [len(g._sessions) for g in gws]
                 == [4, 3, 3, 3, 1])
        p2p_wait(tag, "every route", lambda: all(len(g.peers()) == 4 for g in gws))
        walls["sessions_up"] = (time.perf_counter() - t_gw) * 1e3
        bad = [h for h in handshakes if not h[1]]
        if bad:
            fail(f"{tag} a handshake failed: {bad[:3]}")
        socks = {type(s.sock).__name__ for g in gws for s in g._sessions.values()}
        want_socks = {"SMSocket"} if kind == "sm" else {"socket"}
        if socks != want_socks:
            fail(f"{tag} the sessions are {socks}, want {want_socks}")
        codecs = [("zstd" if g._use_zstd else "zlib",
                   sorted("zstd" if s.caps & p2p.CAP_ZSTD else "zlib"
                          for s in g._sessions.values())) for g in gws]
        log(f"{tag} sessions: {sum(len(g._sessions) for g in gws) // 2} ({socks.pop()}), up "
            f"{walls['sessions_up']:.1f} ms after the gateways were made; codec by gateway "
            f"(its frames; each session's hello): {codecs}")
        hs = sorted(h[0] for h in handshakes if h[2] == "smtls")
        he = sorted(h[0] for h in handshakes if h[2] == "hello")
        log(f"{tag} handshakes: " + (f"SM-TLS {len(hs)} (both ends), ms median "
                                      f"{hs[len(hs) // 2]:.1f}, max {hs[-1]:.1f}; " if hs else "")
            + f"p2p hello {len(he)}, ms median {he[len(he) // 2]:.1f}, max {he[-1]:.1f}")
        # height 1: in at node 0's ingest lane, gossiped over the sockets
        t_in = time.perf_counter()
        for n in nodes:
            n.ingest.start()
        if nodes[0].ingest.submit_many_wire_nowait(frames) != ntx:
            fail(f"{tag} node 0's ingest queue refused frames")
        p2p_wait(tag, "every pool full", lambda: all(n.txpool.pending_count() >= ntx
                                                     for n in nodes))
        t_start = time.perf_counter()
        walls["admission_gossip"] = (t_start - t_in) * 1e3
        # height 1's leader starts last (a pre-prepare reaching a peer whose
        # engine has not registered is dropped)
        for n in sorted(nodes, key=lambda n: n.keypair.pub_bytes == first):
            n.start()
        p2p_wait(tag, "height 1 on every node",
                 lambda: all(n.ledger.current_number() >= 1 for n in nodes))
        walls["chain"] = (time.perf_counter() - t_start) * 1e3
        # the commit observers run on each node's notifier thread, after it
        p2p_wait(tag, "every node's commit notice", lambda: all(1 in c for c in commits))
        if 1 not in preprepares:
            fail(f"{tag} no pre-prepare of height 1 was recorded")
        leader, t_pp = preprepares[1]
        walls["preprepare"] = (t_pp - t_start) * 1e3
        walls["commits"] = [(c[1] - t_pp) * 1e3 if 1 in c else None for c in commits]
        # the light client: a device suite, recorded as the fifth party
        rng = random.Random(SEED + 16)
        block = nodes[0].ledger.block_by_number(1, with_txs=True)
        hashes = [t.hash(host) for t in block.transactions]
        span = [hashes[i] for i in sorted(rng.sample(range(len(hashes)), P2P_SPAN))]
        lsuite = _Recorder(make_suite(kind == "sm", device=dev), 4, calls)
        client = LightNodeClient(lfront, lsuite, [k.pub_bytes for k in keys])
        hclient = LightNodeClient(lfront, host, [k.pub_bytes for k in keys])
        user = host.generate_keypair(b"p2p-light-user")
        fresh = T.Transaction(to=pc.BALANCE_ADDRESS, nonce="p2p-light-1", block_limit=500,
                              input=pc.encode_call("register",
                                                  lambda w: w.blob(b"p2p-light").u64(1))
                              ).sign(host, user)
        rogue_keys = [host.generate_keypair(b"p2p-rogue%d" % k) for k in range(4)]
        out: dict = {}
        want: dict = {}

        def ask(name, fn, hfn=None):
            """One call of the device client, timed with the launches the
            suite calls made meanwhile imply; then the host client's."""
            n0 = len(calls)
            t0 = time.perf_counter()
            out[name] = fn()
            light_calls[name] = ((time.perf_counter() - t0) * 1e3,
                                 expected_launches(kind, suite, calls[n0:]))
            if hfn is not None:
                want[name] = hfn()

        rogue = [k.pub_bytes for k in rogue_keys]
        ask("status", client.status, hclient.status)
        ask("header_range", lambda: client.header_range(1, 1),
            lambda: hclient.header_range(1, 1))
        ask("transactions", lambda: client.transactions(span),
            lambda: hclient.transactions(span))
        ask("receipts", lambda: client.receipts(span), lambda: hclient.receipts(span))
        ask("transaction", lambda: client.transaction(span[0]),
            lambda: hclient.transaction(span[0]))
        ask("send_transaction", lambda: client.send_transaction(fresh))
        # its gossip to the peers settles before the next call is timed
        p2p_wait(tag, "the fresh tx in every pool",
                 lambda: all(n.txpool.pending_count() >= 1 for n in nodes))
        ask("rogue_header_range", lambda: LightNodeClient(lfront, lsuite, rogue).header_range(
            1, 1), lambda: LightNodeClient(lfront, host, rogue).header_range(1, 1))
        levels = {}
        for n in nodes:   # a peer's proof root forged at the level-build seam
            levels[n] = orig = n.lightnode_server._block_levels
            n.lightnode_server._block_levels = (
                lambda memo, number, want_tx, orig=orig: (
                    lambda ctx: None if ctx is None else (ctx[0], ctx[1], b"\x13" * 32))(
                        orig(memo, number, want_tx)))
        ask("tampered_transactions", lambda: client.transactions(span[:64]),
            lambda: hclient.transactions(span[:64]))
        for n, orig in levels.items():
            n.lightnode_server._block_levels = orig
        # the teardown's own drops (a frame to a stopped peer) are not failures
        logging.getLogger("bcos-tpu").removeHandler(failures)
        stop()   # no suite call after this: the counters are final
        torch.cuda.synchronize()
        launches = {k: c.launches for k, c in counters.items()}
    finally:
        PBFTEngine._broadcast_preprepare = orig_pp
        p2p.P2PGateway._handshake = orig_hello
        logging.getLogger("bcos-tpu").removeHandler(failures)
        stop()
    if failures.seen:
        fail(f"{tag} a best-effort catch fired: {failures.seen[:3]}")

    # -- checks ---------------------------------------------------------------
    def enc(x):
        """A comparable answer: a header by its hash (each node's copy
        carries the seals it collected), a tx or receipt by its encoding."""
        if x is None or isinstance(x, int):
            return x
        if isinstance(x, list):
            return [enc(e) for e in x]
        return x.hash(host) if isinstance(x, BlockHeader) else x.encode()

    if out["status"] != 1:
        fail(f"{tag} the light client's status is {out['status']}, want 1")
    header = nodes[0].ledger.header_by_number(1)
    if enc(out["header_range"]) != [header.hash(host)]:
        fail(f"{tag} the light client's verified header is not the committed one")
    by_hash = {t.hash(host): t for t in block.transactions}
    if enc(out["transactions"]) != [by_hash[h].encode() for h in span] or \
            enc(out["transaction"]) != by_hash[span[0]].encode():
        fail(f"{tag} the light client's verified txs are not the block's")
    if enc(out["receipts"]) != [nodes[0].ledger.receipt(h).encode() for h in span]:
        fail(f"{tag} the light client's verified receipts are not the ledger's")
    status, sent_hash = out["send_transaction"]
    if status != 0 or sent_hash != fresh.hash(host):
        fail(f"{tag} send_transaction answered ({status}, {sent_hash.hex()}), want admitted")
    if out["rogue_header_range"] != [None] or out["tampered_transactions"] != [None] * 64:
        fail(f"{tag} a rogue sealer set or a tampered proof root was not rejected")
    for name, got in want.items():
        if enc(out[name]) != enc(got):
            fail(f"{tag} {name}: the device client's answer differs from the host client's")
    for name, site, k, n in (("header_range", "light_headers", verk, 1),
                             ("rogue_header_range", "light_headers", verk, 1),
                             ("transactions", "light_txs", hashk, 2)):
        got = light_calls[name][1].get(k, 0)
        if got < n:
            fail(f"{tag} {name} launched {k} {got} times, want {n} or more")
    views = [n.consensus.status()["view"] for n in nodes]
    if any(views):
        log(f"{tag} a view change fired: views {views}")
    if [n.ledger.current_number() for n in nodes] != [1] * 4:
        fail(f"{tag} heights {[n.ledger.current_number() for n in nodes]}, want 1")
    if len(block.transactions) != ntx or sorted(t.encode() for t in block.transactions) \
            != sorted(frames):
        fail(f"{tag} block 1 holds {len(block.transactions)} txs, not the {ntx} frames sent")
    quorum = len(keys) - (len(keys) - 1) // 3
    for i, n in enumerate(nodes):
        h = n.ledger.header_by_number(1)
        if h.hash(host) != header.hash(host):
            fail(f"{tag} node {i}'s header hash differs from node 0's")
        if not all(qc.verify_spans([h], sealer_set, host)) or len(h.signature_list) < quorum:
            fail(f"{tag} node {i}: the committed header lacks a seal quorum")
    t0 = time.perf_counter()
    ores, obal = pbft_oracle(host, [block], [k.pub_bytes for k in keys], ntx,
                             cfg.compatibility_version)
    oracle_s = time.perf_counter() - t0
    o = ores[0].header
    want_bal = pbft_replay(tr["ops"], [t.encode() for t in block.transactions])
    for i, n in enumerate(nodes):
        h = n.ledger.header_by_number(1)
        if (h.state_root, h.txs_root, h.receipts_root) != \
                (o.state_root, o.txs_root, o.receipts_root) or o.hash(host) != h.hash(host):
            fail(f"{tag} node {i}: the roots differ from the host-suite oracle's")
        rows = snap_rows(n)
        if rows != obal or {k: int.from_bytes(v, "big") for k, v in rows.items()} != want_bal:
            fail(f"{tag} node {i}: c_balance rows differ from the oracle's")
    by_site, site_launches, want_l = launches_by_site(kind, suite, calls)
    got = {k: n for k, n in launches.items() if n}
    log(f"{tag} launches {got}; by site: {site_launches}")
    if got != want_l:
        fail(f"{tag} the counters {got}, the recorded suite calls give {want_l}")
    for site, k in (("admission", eck), ("gossip_import", eck), ("pbft_packets", verk),
                    ("light_headers", verk), ("light_txs", hashk), ("execute", hashk)):
        if not site_launches.get(site, {}).get(k):
            fail(f"{tag} {k} was not launched by {site}: {site_launches.get(site)}")
    missing = [k for k in counters if not launches[k]]
    if missing:
        fail(f"{tag} the path did not launch {missing}")
    w = walls
    log(f"{tag} height 1 ({ntx} txs): admission and gossip {w['admission_gossip']:.1f} ms, "
        f"pre-prepare (leader index {leader}) at {w['preprepare']:.1f} ms after start, "
        f"committed on nodes 0-3 at " + ", ".join("-" if x is None else f"{x:.1f}"
                                                 for x in w["commits"])
        + f" ms after it; the chain {w['chain']:.1f} ms")
    log(f"{tag} light client (device suite; ms, launches): " + "; ".join(
        f"{k} {ms:.1f} {ln}" for k, (ms, ln) in light_calls.items()))
    log(f"{tag} 4 nodes at height 1, header hashes equal, {quorum}+ seals each; roots and "
        f"{len(obal)} c_balance rows equal the host-suite oracle's ({oracle_s:.1f} s); the "
        f"light client's verdicts equal the host client's; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    timings = dict(walls=walls, handshakes=handshakes, light=light_calls, oracle_s=oracle_s,
                   views=views, codecs=codecs)
    return launches, site_launches, timings


DAEMON_DEADLINE = 240.0   # s for each wait of the phase
DAEMON_BOOT = 180.0       # s for a child daemon to answer over RPC (torch, the card, kernels)
DAEMON_STOP = 60.0        # s for a child to exit after SIGTERM
GROUP_TXS = 8192          # registers a group of the 2-group daemon
XSHARD_N = 64             # cross-group transfers group0 -> group1
XSHARD_AMOUNT = 7
LANE_WAIT_MS = 2.0        # the 2-group daemon's lane window (crypto_lane_wait_ms)
DAEMON_FAILED = SERVE_FAILED + P2P_FAILED


def port_block(n: int) -> int:
    """A base port with n consecutive free ports on 127.0.0.1."""
    import socket

    rng = random.Random()
    for _ in range(64):
        base = rng.randint(20000, 55000)
        socks = []
        try:
            for i in range(n):
                socks.append(socket.create_server(("127.0.0.1", base + i)))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    fail("no block of free ports on 127.0.0.1")


def daemon_child(argv) -> int:
    """(17) The child side of phase 17: `chip_smoke.py --daemon-child
    NODE_DIR OUT_JSON INDEX` runs fisco_bcos_tpu_torch.__main__.main on
    NODE_DIR with every suite the daemon makes recorded by site (INDEX is
    the node's: ingest is admission on node 0, gossip import elsewhere),
    every lane dispatch's group tags kept, each pre-prepare and commit
    stamped on the host clock and the best-effort catches watched. When
    the daemon returns (SIGTERM), it writes its exit code, its kernel
    launch counters, the launches its recorded calls imply by site, the
    lane's dispatches and stats, the stamps and
    torch.cuda.max_memory_reserved() to OUT_JSON. -> the daemon's code."""
    node_dir, out_path, index = argv[0], argv[1], int(argv[2])
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from fisco_bcos_tpu_torch import __main__ as entry
    from fisco_bcos_tpu_torch.consensus.pbft.engine import PBFTEngine
    from fisco_bcos_tpu_torch.crypto import lane as lane_mod
    from fisco_bcos_tpu_torch.crypto import suite as suite_mod
    from fisco_bcos_tpu_torch.init.daemon import NodeDaemon
    from fisco_bcos_tpu_torch.tool.config import node_config_from_ini

    with open(Path(node_dir) / "config.ini") as f:
        kind = "sm" if node_config_from_ini(f.read()).sm_crypto else "ecdsa"
    calls, suites, dispatches = [], [], []
    stamps: dict = {"preprepare": {}, "commit": {}}
    held: dict = {}
    failures = _Failures(DAEMON_FAILED)
    make, dispatch = suite_mod.make_suite, lane_mod.CryptoLane._dispatch
    pp, boot, shutdown = (PBFTEngine._broadcast_preprepare, NodeDaemon._boot,
                          NodeDaemon.shutdown)

    def recorded(*a, **k):
        s = make(*a, **k)
        if s.backend == "host":
            return s
        suites.append(s)
        return _Recorder(s, index, calls)

    def tagged(lane, batch):
        dispatches.append((batch[0].op, sorted({r.tag for r in batch}), sum(r.n for r in batch)))
        return dispatch(lane, batch)

    def stamped(engine, block, carried=False):
        stamps["preprepare"].setdefault(str(block.header.number), time.time())
        return pp(engine, block, carried)

    def booted(daemon):
        logging.getLogger("bcos-tpu").addHandler(failures)   # after the daemon's log set-up
        boot(daemon)
        nodes = ([daemon.manager.node(g) for g in daemon.manager.groups()]
                 if daemon.manager is not None else [daemon.node])
        for n in nodes:   # first of the observers: the commit-time prime runs after it
            n.scheduler.on_commit.insert(0, (
                lambda num, g=n.config.group_id: stamps["commit"].setdefault(
                    f"{g}:{num}", time.time())))

    def stopping(daemon):
        # the teardown's own drops (a frame to a stopped peer) are not failures
        logging.getLogger("bcos-tpu").removeHandler(failures)
        if daemon.manager is not None:
            held["lane"] = daemon.manager.crypto_lane_stats()
            held["xshard"] = daemon.manager.coordinator.stats()
        return shutdown(daemon)

    suite_mod.make_suite = recorded
    lane_mod.CryptoLane._dispatch = tagged
    PBFTEngine._broadcast_preprepare = stamped
    NodeDaemon._boot, NodeDaemon.shutdown = booted, stopping
    rc = entry.main([node_dir, "--log-file", str(Path(node_dir) / "daemon.log")])
    out = {"rc": rc, "pid": os.getpid(), "kind": kind, "failures": failures.seen,
           "stamps": stamps, "dispatches": dispatches, **held}
    if suites:
        torch.cuda.synchronize()
        _, sites, want = launches_by_site(kind, suites[0], calls)
        out.update(launches={k: c.launches for k, c in slice_counters(kind).items()
                             if c.launches},
                   want=want, sites=sites, calls=len(calls),
                   max_reserved=torch.cuda.max_memory_reserved())
    with open(out_path, "w") as f:
        json.dump(out, f)
    return rc


class _Daemons:
    """Child daemon processes of one phase-17 chain: started through
    daemon_cmd, their output in the node directory, every one killed in
    close() if it is still running."""

    def __init__(self, tag: str):
        self.tag = tag
        self.procs: dict = {}   # key -> (Popen, node dir, out json, spawn time)
        self.termed: set = set()

    def start(self, key, node_dir: str, index: int, cmd=None):
        out = str(Path(node_dir) / f"child-{key}.json")
        env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent),
                   OMP_NUM_THREADS="1")
        log_f = open(Path(node_dir) / f"child-{key}.out", "wb")
        try:
            p = subprocess.Popen(cmd or daemon_cmd(node_dir, out, index), stdout=log_f,
                                 stderr=subprocess.STDOUT, env=env,
                                 cwd=str(Path(__file__).resolve().parent))
        finally:
            log_f.close()
        self.procs[key] = (p, node_dir, out, time.time())
        return p

    def tail(self, key) -> str:
        p, node_dir, _, _ = self.procs[key]
        text = ""
        for name in (f"child-{key}.out", "daemon.log"):
            path = Path(node_dir) / name
            if path.exists():
                text += f"\n--- {name}:\n" + path.read_text(errors="replace")[-3000:]
        return text

    def alive(self, key) -> None:
        p = self.procs[key][0]
        if p.poll() is not None:
            fail(f"{self.tag} daemon {key} exited with {p.returncode}:{self.tail(key)}")

    def term(self, key) -> None:
        """SIGTERM, once: a second one could land while the interpreter
        exits, when the default action (death by the signal) is back."""
        p = self.procs[key][0]
        if key not in self.termed and p.poll() is None:
            self.termed.add(key)
            p.send_signal(signal.SIGTERM)

    def stop(self, key) -> dict:
        """SIGTERM, wait; it must exit 0 and leave no node.pid. -> its out json."""
        p, node_dir, out, _ = self.procs[key]
        self.term(key)
        try:
            rc = p.wait(timeout=DAEMON_STOP)
        except subprocess.TimeoutExpired:
            fail(f"{self.tag} daemon {key} did not exit {DAEMON_STOP:.0f} s after SIGTERM")
        if rc != 0:
            fail(f"{self.tag} daemon {key} exited {rc} after SIGTERM:{self.tail(key)}")
        if (Path(node_dir) / "node.pid").exists():
            fail(f"{self.tag} daemon {key} left its node.pid behind")
        with open(out) as f:
            return json.load(f)

    def close(self) -> None:
        for p, *_ in self.procs.values():
            if p.poll() is None:
                p.kill()
        for p, *_ in self.procs.values():
            with contextlib.suppress(subprocess.TimeoutExpired):
                p.wait(timeout=30)


def daemon_cmd(node_dir: str, out: str, index: int) -> list:
    """The command line of one phase-17 child daemon."""
    return [sys.executable, str(Path(__file__).resolve()), "--daemon-child", node_dir, out,
            str(index)]


def daemon_rpc(port: int, method: str, params, group: str | None = "group0"):
    """One JSON-RPC call on a fresh connection; -> its result (fails on an error)."""
    rep, _ = serve_post(port, {"jsonrpc": "2.0", "id": 1, "method": method,
                               "params": ([group, ""] if group else []) + list(params)})
    if "error" in rep:
        fail(f"[daemon] {method} on port {port} answered {rep['error']}")
    return rep["result"]


def daemon_wait(tag: str, what: str, pred) -> None:
    deadline = time.monotonic() + DAEMON_DEADLINE
    while not pred():
        if time.monotonic() > deadline:
            fail(f"{tag} {what} not reached in {DAEMON_DEADLINE:.0f} s")
        time.sleep(0.05)


def daemon_up(ds: _Daemons, key, port: int, group: str = "group0") -> float:
    """Wait until daemon `key` answers getBlockNumber on `port`. -> the host
    clock time it first did."""
    deadline = time.monotonic() + DAEMON_BOOT
    while True:
        ds.alive(key)
        try:
            rep, _ = serve_post(port, {"jsonrpc": "2.0", "id": 1, "method": "getBlockNumber",
                                       "params": [group, ""]})
            if "result" in rep:
                return time.time()
        except OSError:
            pass
        if time.monotonic() > deadline:
            fail(f"{ds.tag} daemon {key} did not answer on port {port} in {DAEMON_BOOT:.0f} s:"
                 f"{ds.tail(key)}")
        time.sleep(0.1)


def child_launches(tag: str, who: str, out: dict, kind: str, served: bool = True) -> dict:
    """A child's counters against the launches its recorded suite calls
    imply (both from the child); no best-effort catch may have fired; a
    child that `served` traffic must have launched kernels and reserved
    memory on the card. -> its counters."""
    if out.get("failures"):
        fail(f"{tag} {who}: a best-effort catch fired: {out['failures'][:3]}")
    if served and not (out.get("launches") and out.get("max_reserved")):
        fail(f"{tag} {who} did not hold the card: launches {out.get('launches')}, peak "
             f"reserved {out.get('max_reserved')} B")
    got, want = out.get("launches", {}), out.get("want", {})
    if got != want:
        fail(f"{tag} {who}: the counters {got}, the recorded suite calls give {want}")
    return got


def compute_apps() -> list:
    """nvidia-smi's compute apps on the card: [(pid, used memory)]. In a
    container the pids can be another pid namespace's (the card machine
    lists a child of this script as pid 1)."""
    r = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                        "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return [(int(line.split(",")[0]), line.split(",")[1].strip())
            for line in r.stdout.splitlines() if line.strip()]


def holds_card(tag: str, before: list, pids: set) -> str:
    """Every child process holds the card: nvidia-smi lists its pid. Where
    nvidia-smi lists no pid of this pid namespace (neither a child's nor
    this script's), each child's own peak reserved memory and launches,
    which it writes when it stops, are the evidence (see child_launches).
    -> what nvidia-smi showed."""
    after = compute_apps()
    listed = {p for p, _ in after}
    if pids <= listed:
        return f"pids {sorted(pids)} among nvidia-smi's compute apps"
    if listed & (pids | {os.getpid()}):
        fail(f"{tag} nvidia-smi lists compute apps {after}, not every child {sorted(pids)}")
    return (f"nvidia-smi lists {len(after)} compute apps ({len(before)} before the children "
            f"started) under another pid namespace's pids {sorted(listed)}")


def patch_node_dir(node_dir: str, genesis_limit: int | None = None, **fields) -> None:
    """Rewrite a build_chain node directory's config.ini with `fields` set
    (as the JAX package's chaos harness patches its chains), and its
    genesis with blocks of `genesis_limit` txs."""
    from fisco_bcos_tpu_torch.tool.config import (ChainConfig, node_config_from_ini,
                                                  node_config_to_ini)

    path = Path(node_dir) / "config.ini"
    cfg = node_config_from_ini(path.read_text())
    for k, v in fields.items():
        setattr(cfg, k, v)
    path.write_text(node_config_to_ini(cfg))
    if genesis_limit is not None:
        gpath = Path(node_dir) / "genesis"
        chain = ChainConfig.from_ini(gpath.read_text())
        chain.block_tx_count_limit = genesis_limit
        gpath.write_text(chain.to_ini())


def stored_chain(node_dir: str, host, groups=None) -> dict:
    """A stopped daemon's committed chain, read from its data directory
    (the WAL the daemon wrote): {group: (blocks 1..head with txs, the
    c_balance and xshard rows)}; `groups` None reads the one group's."""
    from fisco_bcos_tpu_torch.executor import precompiled as pc
    from fisco_bcos_tpu_torch.ledger.ledger import Ledger
    from fisco_bcos_tpu_torch.storage import make_storage
    from fisco_bcos_tpu_torch.storage.namespace import NamespacedStorage

    st = make_storage("auto", str(Path(node_dir) / "data"))
    out = {}
    try:
        for g in groups or [None]:
            view = st if g is None else NamespacedStorage(st, g)
            led = Ledger(view, host)
            blocks = [led.block_by_number(h, with_txs=True)
                      for h in range(1, led.current_number() + 1)]
            rows = {t: {k: view.get(t, k) for k in view.keys(t)}
                    for t in (pc.T_BALANCE, pc.T_XSHARD_OUT, pc.T_XSHARD_IN, pc.T_XSHARD_PEND)}
            out[g or "group0"] = (blocks, rows)
    finally:
        st.close()
    return out


def phase_daemon(dev, kind: str, tr):
    """(17a) The Air deployment on each chain: a 4-node chain written by
    the port's build_chain (device = cuda, crypto_backend "device"; plain
    TCP on the default chain, --sm-tls on the SM chain), each node its own
    OS process (daemon_child: python -m fisco_bcos_tpu_torch's main, its
    suite calls recorded by site). Height 1 of phase 13's traffic (`tr`)
    goes in at node 0 over JSON-RPC as phase 15 sends it. Checked: every
    child holds the card (nvidia-smi's compute apps), block 1's header
    hash is equal on all four with a seal quorum, the roots and c_balance
    rows on every node's disk equal the host-suite oracle's and a Python
    replay; SIGTERM ends each with 0 and no node.pid; node 3 alone
    reopens at height 1 (WAL replay), a second daemon on its live
    directory exits 3; every child's counters equal the launches its
    recorded calls imply. -> (launches by kernel, by site, timings)."""
    from fisco_bcos_tpu_torch.consensus import qc
    from fisco_bcos_tpu_torch.crypto.suite import make_suite
    from fisco_bcos_tpu_torch.protocol import types as T
    from fisco_bcos_tpu_torch.tool.build_chain import build_chain

    tag = f"[daemon {kind}]"
    t_phase = time.perf_counter()
    ntx = PBFT_TXS[kind]
    frames = tr["frames"][:ntx]
    if len(frames) != ntx:
        fail(f"{tag} phase 13's traffic holds {len(tr['frames'])} frames, want {ntx} or more")
    host = make_suite(kind == "sm", backend="host")
    root = Path(tempfile.mkdtemp(prefix=f"chip-smoke-daemon-{kind}-"))
    ds = _Daemons(tag)
    walls: dict = {}
    try:
        base = port_block(8)
        info = build_chain(str(root), 4, sm_crypto=kind == "sm", consensus="pbft",
                           rpc_base_port=base, p2p_base_port=base + 4,
                           crypto_backend="device", sm_tls=kind == "sm", device=str(dev))
        dirs = [n["dir"] for n in info["nodes"]]
        rpcs = [n["rpc_port"] for n in info["nodes"]]
        sealers = [bytes.fromhex(n["node_id"]) for n in info["nodes"]]
        for d in dirs:   # blocks of one suite CHUNK that seal only when full, as phase 16's
            patch_node_dir(d, genesis_limit=ntx, min_seal_time=P2P_MIN_SEAL,
                           view_timeout=PBFT_VIEW_TIMEOUT, txpool_limit=PBFT_POOL_LIMIT)
        before = compute_apps()
        for i, d in enumerate(dirs):
            ds.start(i, d, i)
        walls["boot"] = [(daemon_up(ds, i, rpcs[i]) - ds.procs[i][3]) * 1e3 for i in range(4)]
        t_mesh = time.time()
        daemon_wait(tag, "the mesh", lambda: all(
            len(daemon_rpc(p, "getPeers", [], group=None)["peers"]) == 3 for p in rpcs))
        walls["mesh"] = (time.time() - t_mesh) * 1e3
        on_card = holds_card(tag, before, {ds.procs[i][0].pid for i in range(4)})
        t_post = time.time()
        got, t0, t_last = serve_wave(f"http://127.0.0.1:{rpcs[0]}", frames, tag)
        if any(got[f] != T.Transaction.decode(f).hash(host) for f in frames):
            fail(f"{tag} a sendTransaction reply carries another hash than the host suite's")
        walls["admission"] = (t_last - t0) * 1e3
        walls["tx_per_s"] = ntx / (t_last - t0)
        heights: dict = {}
        deadline = time.monotonic() + DAEMON_DEADLINE
        while len(heights) < 4:
            for i, p in enumerate(rpcs):
                if i not in heights and daemon_rpc(p, "getBlockNumber", []) >= 1:
                    heights[i] = time.time()
            if time.monotonic() > deadline:
                fail(f"{tag} height 1 on nodes {sorted(heights)} only, in {DAEMON_DEADLINE:.0f} s")
            time.sleep(0.02)
        walls["post_to_height1"] = [(heights[i] - t_post) * 1e3 for i in range(4)]
        quorum = 4 - (4 - 1) // 3
        heads = [daemon_rpc(p, "getBlockByNumber", [1, True, False]) for p in rpcs]
        if len({h["hash"] for h in heads}) != 1 or \
                min(len(h["signatureList"]) for h in heads) < quorum:
            fail(f"{tag} block 1's headers over RPC: hashes {[h['hash'] for h in heads]}, "
                 f"seals {[len(h['signatureList']) for h in heads]}")
        if kind == "sm" and not all("tls=True" in (Path(d) / "daemon.log").read_text()
                                    for d in dirs):
            fail(f"{tag} a daemon came up without its SM-TLS credential")
        # the commit-time prime renders each tx's proof on the notifier
        # thread, which the daemon's stop does not join: let it end first
        daemon_wait(tag, "every node's proofs rendered", lambda: all(
            daemon_rpc(p, "getSystemStatus", [])["zk"]["proofsRendered"] >= ntx for p in rpcs))
        for i in range(4):   # the four at once, then each waited for
            ds.term(i)
        outs = [ds.stop(i) for i in range(4)]
        chains = [stored_chain(d, host)["group0"] for d in dirs]   # before node 3 reopens
        blocks = [c[0] for c in chains]
        if any(len(b) != 1 for b in blocks):
            fail(f"{tag} the nodes' disks hold {[len(b) for b in blocks]} blocks, want 1")
        block = blocks[0][0]
        if len(block.transactions) != ntx or sorted(t.encode() for t in block.transactions) \
                != sorted(frames):
            fail(f"{tag} block 1 holds {len(block.transactions)} txs, not the {ntx} frames sent")
        # node 3 alone on its directory: WAL replay; a second daemon there must exit 3
        t_r = time.time()
        p3 = ds.start("3r", dirs[3], 3)
        pid_file = Path(dirs[3]) / "node.pid"
        deadline = time.monotonic() + DAEMON_BOOT
        while not (pid_file.exists() and pid_file.read_text().strip() == str(p3.pid)):
            ds.alive("3r")
            if time.monotonic() > deadline:
                fail(f"{tag} the restarted node 3 wrote no node.pid")
            time.sleep(0.02)
        double = ds.start("double", dirs[3], 3, cmd=[
            sys.executable, "-m", "fisco_bcos_tpu_torch", dirs[3], "--log-file",
            str(Path(dirs[3]) / "double.log")])
        t_o = time.perf_counter()   # the host-suite oracle, while node 3 boots
        ores, obal = pbft_oracle(host, [block], sealers, ntx, "1.1.0")
        oracle_s = time.perf_counter() - t_o
        walls["restart"] = (daemon_up(ds, "3r", rpcs[3]) - t_r) * 1e3
        if daemon_rpc(rpcs[3], "getBlockNumber", []) != 1:
            fail(f"{tag} node 3 reopened at {daemon_rpc(rpcs[3], 'getBlockNumber', [])}, want 1")
        try:
            rc = double.wait(timeout=DAEMON_BOOT)
        except subprocess.TimeoutExpired:
            fail(f"{tag} a second daemon on node 3's live directory kept running")
        if rc != 3:
            fail(f"{tag} a second daemon on node 3's live directory exited {rc}, want 3:"
                 f"{ds.tail('double')}")
        outs.append(ds.stop("3r"))
    finally:
        ds.close()
        shutil.rmtree(root, ignore_errors=True)

    # -- checks ---------------------------------------------------------------
    o = ores[0].header
    want_bal = pbft_replay(tr["ops"], [t.encode() for t in block.transactions])
    for i, (b, rows) in enumerate(chains):
        h = b[0].header
        if "0x" + h.hash(host).hex() != heads[i]["hash"]:
            fail(f"{tag} node {i}'s stored header is not the one it served")
        if not all(qc.verify_spans([h], sorted(sealers), host)) or \
                len(h.signature_list) < quorum:
            fail(f"{tag} node {i}: the committed header lacks a seal quorum")
        if (h.state_root, h.txs_root, h.receipts_root) != \
                (o.state_root, o.txs_root, o.receipts_root) or o.hash(host) != h.hash(host):
            fail(f"{tag} node {i}: the roots differ from the host-suite oracle's")
        bal = rows["c_balance"]
        if bal != obal or {k: int.from_bytes(v, "big") for k, v in bal.items()} != want_bal:
            fail(f"{tag} node {i}: c_balance rows differ from the oracle's")
    launches: dict = {}
    sites: dict = {}
    who = ["node 0", "node 1", "node 2", "node 3", "node 3 restarted"]
    for w, out in zip(who, outs):
        for k, n in child_launches(tag, w, out, kind, served=w != who[-1]).items():
            launches[k] = launches.get(k, 0) + n
        for site, ks in out.get("sites", {}).items():
            for k, n in ks.items():
                sites.setdefault(site, {})[k] = sites.setdefault(site, {}).get(k, 0) + n
    eck = "ecdsa_recover" if kind == "ecdsa" else "sm2_verify"
    verk = "ecdsa_verify" if kind == "ecdsa" else "sm2_verify"
    hashk = "keccak256_varlen" if kind == "ecdsa" else "sm3_varlen"
    for site, k in (("admission", eck), ("gossip_import", eck), ("pbft_packets", verk),
                    ("execute", hashk)):
        if not sites.get(site, {}).get(k):
            fail(f"{tag} {k} was not launched by {site}: {sites.get(site)}")
    missing = [k for k in slice_counters(kind) if not launches.get(k)]
    if missing:
        fail(f"{tag} the path did not launch {missing}")
    pps = [float(o_["stamps"]["preprepare"]["1"]) for o_ in outs[:4]
           if "1" in o_["stamps"]["preprepare"]]
    if len(pps) != 1:
        fail(f"{tag} {len(pps)} nodes stamped a pre-prepare of height 1, want 1")
    leader = next(i for i, o_ in enumerate(outs[:4]) if "1" in o_["stamps"]["preprepare"])
    walls["commits"] = [(o_["stamps"]["commit"]["group0:1"] - pps[0]) * 1e3 for o_ in outs[:4]]
    walls["max_reserved_mb"] = [o_["max_reserved"] / 2 ** 20 for o_ in outs]
    w = walls
    log(f"{tag} 4 processes on the card ({on_card}); boot, ms "
        f"(spawn to the first RPC answer): " + ", ".join(f"{x:.1f}" for x in w["boot"])
        + f"; mesh {w['mesh']:.1f} ms" + (" (SM-TLS)" if kind == "sm" else " (plain TCP)"))
    log(f"{tag} height 1 ({ntx} txs): admission over RPC {w['admission']:.1f} ms "
        f"({w['tx_per_s']:.0f} tx/s); first POST to height 1 on nodes 0-3: "
        + ", ".join(f"{x:.1f}" for x in w["post_to_height1"])
        + f" ms; pre-prepare (node {leader}) to commit on nodes 0-3: "
        + ", ".join(f"{x:.1f}" for x in w["commits"]) + " ms")
    log(f"{tag} SIGTERM: 4 exits 0, no node.pid; node 3 alone reopened at height 1 in "
        f"{w['restart']:.1f} ms (spawn to RPC); a second daemon there exited 3; peak reserved "
        f"MB by process: " + ", ".join(f"{x:.0f}" for x in w["max_reserved_mb"]))
    log(f"{tag} launches {launches}; by site: {sites}")
    log(f"{tag} header hashes equal, {quorum}+ seals; roots and {len(obal)} c_balance rows on "
        f"every disk equal the host-suite oracle's ({oracle_s:.1f} s); phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches, sites, dict(walls=walls, oracle_s=oracle_s)


def groups_oracle(host, chains: dict, sealer: bytes):
    """The groups' committed blocks executed in order by a host-suite
    GroupManager (one Node a group over one MemoryStorage, no coordinator:
    its legs are in the blocks), each header rebuilt from the committed one
    as block sync replays it. -> (manager, {group: [results]}); stop the
    manager after use."""
    from fisco_bcos_tpu_torch.init.group import GroupManager
    from fisco_bcos_tpu_torch.init.node import NodeConfig
    from fisco_bcos_tpu_torch.ledger.ledger import ConsensusNode
    from fisco_bcos_tpu_torch.protocol import types as T
    from fisco_bcos_tpu_torch.storage import MemoryStorage

    mgr = GroupManager(storage=MemoryStorage(), xshard=False)
    results: dict = {}
    for g, (blocks, _) in chains.items():
        node = mgr.add_group(NodeConfig(group_id=g, crypto_backend="host", device="cpu",
                                        profile_hz=0), suite=host)
        node.build_genesis([ConsensusNode(sealer)])
        results[g] = []
        for b in blocks:
            h = b.header
            replay = T.Block(transactions=[T.Transaction.decode(t.encode())
                                           for t in b.transactions])
            for f in ("version", "number", "timestamp", "sealer", "extra_data"):
                setattr(replay.header, f, getattr(h, f))
            replay.header.consensus_weights = list(h.consensus_weights)
            replay.header.sealer_list = list(h.sealer_list)
            r = node.scheduler.execute_block(replay)
            if r is None:
                fail(f"the oracle's group {g} did not execute block {h.number}")
            r.header.signature_list = h.signature_list
            if not node.scheduler.commit_block(r.header):
                fail(f"the oracle's group {g} did not commit block {h.number}")
            results[g].append(r)
    return mgr, results


def phase_groups(dev):
    """(17b) Multi-group hosting on the default chain: one daemon process
    (a 1-node build_chain directory, crypto_backend "device", its
    config.ini's [groups] list = group0,group1; each group a single sealer
    holding the node's key, blocks of the JAX default 1,000 txs, a
    partial one sealed after PBFT_MIN_SEAL, a lane window of LANE_WAIT_MS)
    hosts two
    chains on one shared crypto lane. GROUP_TXS registers a group go in
    over JSON-RPC at once (each batch body's entries alternate the groups,
    routed by the group param); then XSHARD_N cross-group transfers from
    group0 to group1, one to an unknown group (refunded) and one beyond
    its balance (reverted). Checked: getGroupList, an unknown group's
    JSONRPC_GROUP_NOT_FOUND; the coordinator settles every transfer once
    (getAuditReport's cross-group section clean); each group's blocks,
    roots, c_balance and xshard rows on disk equal a host-suite
    GroupManager's replay of them and a Python replay; one lane dispatch
    carried both groups' requests; the counters equal the launches the
    lane's base-suite calls imply. -> (launches by kernel, by site, timings)."""
    from fisco_bcos_tpu_torch.crypto.suite import make_suite
    from fisco_bcos_tpu_torch.executor import precompiled as pc
    from fisco_bcos_tpu_torch.ops.audit import audit_cross_group
    from fisco_bcos_tpu_torch.protocol import types as T
    from fisco_bcos_tpu_torch.rpc.server import JSONRPC_GROUP_NOT_FOUND
    from fisco_bcos_tpu_torch.tool.build_chain import build_chain

    tag = "[groups ecdsa]"
    t_phase = time.perf_counter()
    groups = ["group0", "group1"]
    host = make_suite(backend="host")
    root = Path(tempfile.mkdtemp(prefix="chip-smoke-groups-"))
    ds = _Daemons(tag)
    walls: dict = {}
    try:
        base = port_block(2)
        info = build_chain(str(root), 1, consensus="pbft", rpc_base_port=base,
                           p2p_base_port=base + 1, crypto_backend="device", device=str(dev))
        d = info["nodes"][0]["dir"]
        sealer = bytes.fromhex(info["nodes"][0]["node_id"])
        # a partial block waits PBFT_MIN_SEAL to fill, which bounds the
        # block count while the registers trickle in over RPC; the lane's
        # coalescing window for device deployments (NodeConfig:
        # crypto_lane_wait_ms) lets the groups' concurrent requests meet
        patch_node_dir(d, groups=groups, min_seal_time=PBFT_MIN_SEAL,
                       crypto_lane_wait_ms=LANE_WAIT_MS)
        ds.start("g", d, 0)
        traffic = {g: pbft_traffic(host, GROUP_TXS, 1, seed=SEED + 17 + k, group_id=g)
                   for k, g in enumerate(groups)}   # signed while the daemon boots
        walls["boot"] = (daemon_up(ds, "g", base) - ds.procs["g"][3]) * 1e3
        if daemon_rpc(base, "getGroupList", [], group=None)["groupList"] != groups:
            fail(f"{tag} getGroupList answered another list than {groups}")
        rep, _ = serve_post(base, {"jsonrpc": "2.0", "id": 1, "method": "getBlockNumber",
                                   "params": ["group9", ""]})
        if rep.get("error", {}).get("code") != JSONRPC_GROUP_NOT_FOUND:
            fail(f"{tag} an unknown group answered {rep}")
        mixed = [f for pair in zip(*(traffic[g]["frames"] for g in groups)) for f in pair]
        t_post = time.time()
        got, t0, t_last = serve_wave(f"http://127.0.0.1:{base}", mixed, tag,
                                     groups=groups * GROUP_TXS)
        if any(got[f] != T.Transaction.decode(f).hash(host) for f in mixed):
            fail(f"{tag} a sendTransaction reply carries another hash than the host suite's")
        walls["admission"] = (t_last - t0) * 1e3
        walls["tx_per_s"] = len(mixed) / (t_last - t0)
        done: dict = {}
        deadline = time.monotonic() + DAEMON_DEADLINE
        while len(done) < 2:
            for g in groups:
                if g not in done and daemon_rpc(base, "getTotalTransactionCount", [], group=g)[
                        "transactionCount"] >= GROUP_TXS:
                    done[g] = time.time()
            if time.monotonic() > deadline:
                fail(f"{tag} groups {sorted(done)} only committed their registers")
            time.sleep(0.05)
        walls["groups"] = {g: (done[g] - t_post) * 1e3 for g in groups}
        # the transfers: XSHARD_N to group1, one to a group nobody hosts, one beyond its balance
        user = host.generate_keypair(b"xshard-user")
        accts = traffic["group0"]["accounts"]
        legs = [(b"xs%03d" % i, "group1", accts[i], XSHARD_AMOUNT) for i in range(XSHARD_N)]
        legs += [(b"xs-lost", "group9", accts[XSHARD_N], XSHARD_AMOUNT),
                 (b"xs-poor", "group1", accts[XSHARD_N + 1], EXEC_BIG)]
        xframes = [T.Transaction(
            to=pc.XSHARD_ADDRESS, nonce=f"xs-{i}", block_limit=500, group_id="group0",
            input=pc.encode_call("transferOut", lambda w, x=x, g=g, a=a, m=m: (
                w.blob(x).text(g).blob(a).blob(a).u64(m)))).sign(host, user).encode()
            for i, (x, g, a, m) in enumerate(legs)]
        t_x = time.time()
        serve_wave(f"http://127.0.0.1:{base}", xframes, tag)
        deadline = time.monotonic() + DAEMON_DEADLINE
        while True:
            xg = daemon_rpc(base, "getAuditReport", [1])["crossGroup"]
            if (xg["pending"], xg["outbox"], xg["inbox"]) == (0, XSHARD_N + 1, XSHARD_N):
                break
            if time.monotonic() > deadline:
                fail(f"{tag} the transfers did not settle in {DAEMON_DEADLINE:.0f} s: {xg}")
            time.sleep(0.1)
        walls["xshard"] = (time.time() - t_x) * 1e3
        # the commit-time prime runs on the notifier thread, which the
        # daemon's stop does not join: let each group's end first
        daemon_wait(tag, "each group's proofs rendered", lambda: all(
            daemon_rpc(base, "getSystemStatus", [], group=g)["zk"]["proofsRendered"]
            >= daemon_rpc(base, "getTotalTransactionCount", [], group=g)["transactionCount"]
            for g in groups))
        if not xg["ok"]:
            fail(f"{tag} getAuditReport's cross-group section: {xg['problems'][:3]}")
        out = ds.stop("g")
    finally:
        ds.close()
    try:
        chains = stored_chain(d, host, groups)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # -- checks ---------------------------------------------------------------
    t_o = time.perf_counter()
    mgr, ores = groups_oracle(host, chains, sealer)
    try:
        oxg = audit_cross_group(mgr)
        orows = {g: {t: {k: mgr.node(g).storage.get(t, k) for k in mgr.node(g).storage.keys(t)}
                     for t in chains[g][1]} for g in groups}
    finally:
        mgr.stop()
    oracle_s = time.perf_counter() - t_o
    for g in groups:
        blocks, rows = chains[g]
        if [r.header.hash(host) for r in ores[g]] != [b.header.hash(host) for b in blocks] or \
                any((r.header.state_root, r.header.txs_root, r.header.receipts_root)
                    != (b.header.state_root, b.header.txs_root, b.header.receipts_root)
                    for r, b in zip(ores[g], blocks)):
            fail(f"{tag} {g}: the headers or roots differ from the host-suite oracle's")
        if rows != orows[g]:
            fail(f"{tag} {g}: the c_balance or xshard rows differ from the oracle's")
    if not oxg["ok"] or (oxg["outbox"], oxg["inbox"], oxg["pending"]) != \
            (XSHARD_N + 1, XSHARD_N, 0):
        fail(f"{tag} the oracle's cross-group audit: {oxg}")
    bal = {g: {k: int.from_bytes(v, "big") for k, v in chains[g][1][pc.T_BALANCE].items()}
           for g in groups}
    want = {g: {a: EXEC_BALANCE for a in traffic[g]["accounts"]} for g in groups}
    for i in range(XSHARD_N):
        want["group0"][accts[i]] -= XSHARD_AMOUNT
        want["group1"][accts[i]] += XSHARD_AMOUNT
    if bal != want:
        fail(f"{tag} the balances are not the registers with each transfer landed once")
    outbox = {x: pc.decode_intent(v) for x, v in chains["group0"][1][pc.T_XSHARD_OUT].items()}
    if sorted(outbox) != sorted(x for x, *_ in legs[:-1]) or \
            any(outbox[x]["status"] != pc.XS_DONE for x, *_ in legs[:XSHARD_N]) or \
            outbox[b"xs-lost"]["status"] != pc.XS_ABORTED:
        fail(f"{tag} the outbox is not {XSHARD_N} settled and one refunded transfer")
    if sorted(chains["group1"][1][pc.T_XSHARD_IN]) != sorted(x for x, *_ in legs[:XSHARD_N]):
        fail(f"{tag} group1's inbox does not hold each transfer once")
    got = child_launches(tag, "the daemon", out, "ecdsa")
    both = [dsp for dsp in out["dispatches"] if dsp[1] == groups]
    if not both:
        fail(f"{tag} no lane dispatch carried both groups' requests: {out['dispatches'][:8]}")
    missing = [k for k in slice_counters("ecdsa") if not got.get(k)]
    if missing:
        fail(f"{tag} the path did not launch {missing}")
    lane = out["lane"]["ecdsa"]
    merged = {op: sum(1 for dsp in both if dsp[0] == op) for op in ("recover", "verify", "hash")}
    w = walls
    log(f"{tag} 1 process, 2 groups; boot {w['boot']:.1f} ms; admission over RPC "
        f"{w['admission']:.1f} ms for {len(mixed)} txs ({w['tx_per_s']:.0f} tx/s); first POST "
        f"to every register committed: " + ", ".join(f"{g} {x:.1f}" for g, x in w["groups"].items())
        + f" ms; {XSHARD_N + 2} transfers settled {w['xshard']:.1f} ms after the POST "
        f"(coordinator {out['xshard']})")
    log(f"{tag} heights {[len(chains[g][0]) for g in groups]}; the lane: "
        f"{lane['device_calls']} base calls, {lane['items_total']} items "
        f"({lane['items_total'] / max(1, lane['device_calls']):.2f} a call), "
        f"{lane['merged_calls']} merged; dispatches carrying both groups by op {merged}; peak "
        f"reserved {out['max_reserved'] / 2 ** 20:.0f} MB")
    log(f"{tag} launches {got}; by site: {out['sites']}")
    log(f"{tag} each group's headers, roots, c_balance and xshard rows equal the host-suite "
        f"GroupManager's replay ({oracle_s:.1f} s); phase {time.perf_counter() - t_phase:.1f} s")
    return got, out["sites"], dict(walls=walls, lane=lane, merged=merged, oracle_s=oracle_s)


def main() -> int:
    if sys.argv[1:2] == ["--daemon-child"]:
        return daemon_child(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent
    if not (here / "fisco_bcos_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: fisco_bcos_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(here))
    from fisco_bcos_tpu_torch.crypto.suite import make_suite

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi, name = phase_card()
    rng = random.Random(SEED)
    suite = make_suite()
    t0 = time.perf_counter()
    signed = signed_entries()
    log(f"[kernel] 256 host signatures for the kernel inputs: "
        f"{time.perf_counter() - t0:.1f} s")
    rows = phase_kernels(dev, signed, rng)
    data = build_slice(suite, rng)
    launches, _, fused = phase_slice(dev, suite, data, rng)
    sm_suite = make_suite(sm_crypto=True)
    sm_data = build_slice(sm_suite, rng)
    rows.update(phase_sm_kernels(dev, sm_data, rng))
    sm_launches, _, sm_fused = phase_slice(dev, sm_suite, sm_data, rng)
    by_path = {k: {"slice_ecdsa": n} for k, n in launches.items()}
    by_path.update({k: {"slice_sm": n} for k, n in sm_launches.items()})
    idle = {k: fn.launches for k, fn in composed_counters().items()}
    if any(idle.values()):
        fail(f"fp, pow or ladder kernels launched during phases 2-5 (the plain EC "
             f"oracles): {idle}")
    rows.update(phase_fp_kernels(dev))
    fp_launches, _ = phase_poseidon(dev, suite, rng)
    by_path.update({k: {"poseidon": n} for k, n in fp_launches.items()})
    rows.update(phase_pow_kernel(dev))
    rows.update(phase_ladder_kernel(dev, rng))
    for kind, d, fres in (("ecdsa", data, fused), ("sm", sm_data, sm_fused)):
        got, _ = phase_composed(dev, kind, d, fres, rng)
        for k in composed_counters():
            by_path.setdefault(k, {})[f"composed_{kind}"] = got[k]
    for kind, s, d, fres in (("ecdsa", suite, data, fused), ("sm", sm_suite, sm_data, sm_fused)):
        steps, _, _ = phase_node(dev, s, d, random.Random(SEED + 4), fres["senders"])
        for k in slice_counters(kind):
            by_path[k][f"node_{kind}"] = sum(st[k] for st in steps.values())
    chains = {}
    for kind in ("ecdsa", "sm"):
        auto = make_suite(kind == "sm", backend="auto", device=dev)
        steps, _, t12 = phase_exec(dev, auto, kind, random.Random(SEED + 12))
        chains[kind] = (t12["storage"], t12["ledger"])
        for k in slice_counters(kind):
            if k != "ecdsa_verify":   # the seal judge's kernel: not on this path
                by_path[k][f"exec_{kind}"] = sum(st[k] for st in steps.values())
    traffic = {}
    for kind in ("ecdsa", "sm"):
        got, _, t13 = phase_pbft(dev, kind)
        traffic[kind] = t13["traffic"]
        for k in slice_counters(kind):
            by_path[k][f"pbft_{kind}"] = got[k]
    for kind in ("ecdsa", "sm"):
        got, _, _ = phase_snap(dev, kind, traffic[kind], chains.pop(kind))
        for k in slice_counters(kind):
            by_path[k][f"snap_{kind}"] = got[k]
    for kind in ("ecdsa", "sm"):
        got, _, _ = phase_serve(dev, kind, traffic[kind])
        for k in slice_counters(kind):
            by_path[k][f"rpc_{kind}"] = got[k]
    for kind in ("ecdsa", "sm"):
        got, _, _ = phase_p2p(dev, kind, traffic[kind])
        for k in slice_counters(kind):
            by_path[k][f"p2p_{kind}"] = got[k]
    torch.cuda.empty_cache()   # the child daemons' room on the card
    for kind in ("ecdsa", "sm"):
        got, _, _ = phase_daemon(dev, kind, traffic.pop(kind))
        for k in slice_counters(kind):
            by_path[k][f"daemon_{kind}"] = got.get(k, 0)
    got, _, _ = phase_groups(dev)
    for k in slice_counters("ecdsa"):
        by_path[k]["groups_ecdsa"] = got.get(k, 0)
    for k, paths in by_path.items():
        rows[k]["launches"] = sum(paths.values())
        rows[k]["launches_by_path"] = paths
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": list(rows.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
