#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's crypto paths on one NVIDIA card: the
default chain (secp256k1 + Keccak-256), the SM chain (SM2 + SM3) and the
ZK plane's batched Poseidon (BN254), then both chains again on the
composed EC route.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the plain
version or to the CPU):

1. Card: name and power limit (nvidia-smi), the kernels' parallel build.
2. Each default-chain CUDA kernel against its plain PyTorch version on the
   card at the main path's shapes, bit-exact: recover and verify at one
   CHUNK (16,384 lanes), Keccak over 65,536 messages of 1-8 blocks, Merkle
   trees at n in {1, 2, 17, 4097, 65535, 65536}. Kernel times are medians
   of CUDA event timings after a warm-up; the plain version runs once.
3. The default chain's slice: a 65,536-tx block through the port's
   protocol entry points (batch_recover_senders, Block.calculate_txs_root
   and calculate_receipts_root), and a commit-seal span of 16,384 lanes
   through suite.verify_batch, checked against the pure-Python oracle on
   every distinct signed entry (by its signer), every corrupted lane and
   64 sampled tiled lanes, and against the plain path for the tx hashes
   and 65,536-leaf roots. The launch counters are zeroed just before and
   read just after; every kernel must have launched, and the profiler
   (warmed up on a small step) must record as many calls of each kernel.
4. The SM chain's kernels as in 2: SM3 over the 65,536 tx encodings of the
   SM block (2-17 blocks), SM3 Merkle trees at the same n, SM2 verify at
   one CHUNK of host-signed vectors with 1% adversarial lanes.
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
   4,096-leaf root. Each step's fp launches must be 171 / 90 / 1 per chunk
   call and no other kernel's counter may move; the profiler (warmed up
   on a small step) records the 65,536-pair step, whose kernel calls must
   equal the counters.
8. The pow kernel (csrc/fp.cu) against the plain window loop on the
   card, bit-exact, at [16, 16,384] and [16, 1]: (p+1)/4 on secp256k1's
   p, n - 2 on secp256k1's and SM2's n, p - 2 on SM2's p, with edge lanes
   0, 1, n - 1 and R mod n.
9. The ladder kernel (csrc/ladder.cu) against ec.ladder_plain on the card
   at 16,384 lanes in both forms (GLV on secp256k1, plain on SM2),
   Jacobian bit-exact, on the edge lanes of ec.LADDER_EDGES (zero
   scalars, Q = +-G at k1 = k2, an off-curve Q with Z = 0 table entries,
   the last G add doubling and cancelling) and flipped sign flags; 32
   lanes held to the oracle k1 G + k2 Q.
10. The composed EC route: the blocks and seal spans of phases 3 and 5
   again, through make_suite(ec_route="composed") and
   make_suite(sm_crypto=True, ec_route="composed") by the same checks,
   whose senders, ok masks, roots and seal verdicts must be identical to
   the fused route's; one ladder a chunk call, 3 pows a recovery chunk and
   1 a secp256k1 verify chunk (none on the SM chain), the fused EC
   kernels' counters 0, and the profiler's kernel calls equal to the
   counters.

Prints, before the last line, the card line and one JSON object listing
every kernel; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import random
import subprocess
import sys
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
MERKLE_NS = (1, 2, 17, 4097, 65535, 65536)
# the ZK plane: chain_bench --proof-bench's largest rows
FP_B = 65536  # one Poseidon CHUNK of lanes
NPAIRS = 65536
NLEAVES = 65536
NPROOFS = 256


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


MARK = "chip_smoke.measured"
LAST_EVENTS: dict = {}


def device_events(prof, tag: str):
    """Device time (us) and calls per kernel name of the device work
    launched inside the host range MARK, the record_function around the
    measured work. A device event belongs to the range when the runtime
    call that launched it (a CPU event of the same CUPTI correlation id,
    on the host's clock) started inside it. The device events' own times
    cannot say so: on the card they drift by milliseconds against the
    host's clock (a kernel seemed to start before its own launch), so the
    warm-up's last kernel (run before MARK) could seem to start inside it
    and a measured one before it. Each session is
    one cycle that first runs a warm-up through the same kernels, since a
    session's first events can go missing. LAST_EVENTS keeps (correlation
    id, us of its launch after MARK, us) of each counted event by name,
    for a failure's message."""
    from torch.autograd import DeviceType

    events = prof.events()
    marks = [e for e in events if e.name == MARK and e.device_type == DeviceType.CPU]
    if len(marks) != 1:
        fail(f"{tag} the profiler recorded {len(marks)} ranges {MARK}, expected 1")
    t0, t1 = marks[0].time_range.start, marks[0].time_range.end
    device = [ev for ev in events
              if ev.device_type != DeviceType.CPU and not ev.is_user_annotation
              and ev.name != MARK and not ev.name.startswith("ProfilerStep")]
    ids = {ev.id for ev in device if ev.id}
    launched = {ev.id: ev.time_range.start - t0 for ev in events
                if ev.device_type == DeviceType.CPU and ev.id in ids
                and ev.name.startswith("cu") and t0 <= ev.time_range.start <= t1}
    device_us, calls, outside, seen = {}, {}, {}, set()
    LAST_EVENTS.clear()
    for ev in device:
        k = ev.name.split("(")[0]  # entries that differ past the name add up
        if ev.id not in launched or ev.id in seen:
            outside[k] = outside.get(k, 0) + 1
            continue
        seen.add(ev.id)
        device_us[k] = device_us.get(k, 0) + ev.self_device_time_total
        calls[k] = calls.get(k, 0) + 1
        LAST_EVENTS.setdefault(k, []).append(
            (ev.id, round(launched[ev.id], 1), ev.self_device_time_total))
    if outside:
        log(f"{tag} left out device events not launched inside the measured range "
            f"(the warm-up's): {sum(outside.values())}")
    return device_us, calls


def kernel_device_ms(fn, name: str, reps: int = 20, tries: int = 3) -> float:
    """Mean device time in ms of the kernel `name` over reps calls of fn,
    by the profiler's device events (CUPTI), each call after a 256 MB
    write that evicts the 50 MB L2, so the kernel reads its inputs from
    device memory as the bound assumes. For a kernel shorter than its
    launch, where CUDA events around one call time the host's launch. The
    warm-up calls' events are left out (device_events); a profiler session
    that lost events is run again, up to `tries` times."""
    from torch.profiler import ProfilerActivity, profile, record_function

    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
            with record_function(MARK):
                for _ in range(reps):
                    flush.zero_()
                    fn()
                torch.cuda.synchronize()
        device_us, calls = device_events(prof, f"[{name}]")
        us, calls = device_us.get(name, 0.0), calls.get(name, 0)
        if calls == reps:
            return us / calls / 1e3
        log(f"[profiler] recorded {calls} of {reps} calls of {name}; again")
    fail(f"the profiler recorded {calls} calls of {name}, expected {reps}")


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
KECCAK_PERM_OPS = 24 * 180 + 34


def _pow_muls(e: int) -> int:
    digits = [(e >> (4 * i)) & 15 for i in range((e.bit_length() + 3) // 4)]
    return 14 + 4 * (len(digits) - 1) + sum(1 for d in digits[:-1] if d)


def _glv_nonzero(k: int) -> int:
    from fisco_bcos_tpu_torch.crypto import refimpl

    n = refimpl.SECP256K1.n
    nz = 0
    for x in refimpl.glv_split(k):
        m = min(x, n - x)
        nz += sum(1 for j in range(34) if (m >> (4 * j)) & 15)
    return nz


def _ladder_products(u1: int, u2: int) -> int:
    from fisco_bcos_tpu_torch.crypto import refimpl

    p = refimpl.SECP256K1.p
    table = 7 + 13 * 11 + 14 + INV_LANE + 14 * 6
    nz = _glv_nonzero(u1) + _glv_nonzero(u2)
    fp = table + 136 * 7 + 11 * nz + nz // 4  # phi(Q): one extra multiply
    fn = 2 * 3 + 2  # two GLV splits, three Montgomery multiplies each
    return fp * FP_MUL + fn * FN_MUL + 4 * WIDE


def recover_products(e, r, s, v) -> int:
    from fisco_bcos_tpu_torch.crypto import refimpl

    c = refimpl.SECP256K1
    if not (0 < r < c.n and 0 < s < c.n and 0 <= v < 4):
        return 0
    x = r + (v >> 1) * c.n
    if x >= c.p:
        return 0
    total = (3 + _pow_muls((c.p + 1) // 4)) * FP_MUL
    ysq = (x ** 3 + 7) % c.p
    if pow(ysq, (c.p + 1) // 4, c.p) ** 2 % c.p != ysq:
        return total
    rinv = pow(r, -1, c.n)
    u1, u2 = (-e * rinv) % c.n, (s * rinv) % c.n
    total += (4 + INV_LANE) * FN_MUL
    return total + _ladder_products(u1, u2) + (INV_LANE + 3) * FP_MUL


def verify_products(e, r, s, qx, qy) -> int:
    from fisco_bcos_tpu_torch.crypto import refimpl

    c = refimpl.SECP256K1
    if not (0 < r < c.n and 0 < s < c.n and qx < c.p and qy < c.p):
        return 0
    if (qx, qy) == (0, 0) or (qy * qy - qx ** 3 - 7) % c.p:
        return 4 * FP_MUL
    w = pow(s, -1, c.n)
    u1, u2 = e % c.n * w % c.n, r * w % c.n
    return 11 * FP_MUL + (4 + INV_LANE) * FN_MUL + _ladder_products(u1, u2)


def ec_batch_inversions(n_inv: int, p_inv: int) -> int:
    """Products of the per-batch Fermat powers: n_inv mod-n, p_inv mod-p."""
    from fisco_bcos_tpu_torch.crypto import refimpl

    c = refimpl.SECP256K1
    return n_inv * _pow_muls(c.n - 2) * FN_MUL + p_inv * _pow_muls(c.p - 2) * FP_MUL


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
# SM2 counts products mod p as csrc/sm2.cuh and point.cuh make them: 8 per
# a = -3 doubling, 11 per mixed add. SM2's p = 2^256 - 2^224 - 2^96 + 2^64 - 1
# is a generalized-Mersenne prime, as NIST P-256's is: a product needs its
# 64 wide multiplies and a fold of the high half by word adds and subtracts
# only, two terms to a 3-input add of one issue slot (`sm2_fp_mul`). The
# kernel's Montgomery product (2 x 64 + 8) and its domain conversions are
# its design, not the work, and are not priced.
SM2_DBL, SM2_MADD = 8, 11


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
    checks = 3  # y^2 == x^3 + a x + b: y^2, x^2, x^3 (a x = -3 x is adds)
    t = (r + s) % c.n
    if (qy * qy - qx ** 3 - c.a * qx - c.b) % c.p or t == 0:
        return checks * sm2_fp_mul()
    table = SM2_DBL + 13 * SM2_MADD + 14 + INV_LANE + 14 * 6 + 5
    nz = sum(1 for k in (s, t) for j in range(64) if (k >> (4 * j)) & 15)
    ladder = 256 * SM2_DBL + (nz - 1) * SM2_MADD  # the first add lands on infinity
    cand = (r - e % c.n) % c.n
    final = 2 + (cand + c.n < c.p)  # Z^2, c Z^2, and (c + n) Z^2 where c + n < p
    return (checks + table + ladder + final) * sm2_fp_mul()


def sm2_batch_inversion() -> float:
    """Wide-multiply slots of the one mod-p Fermat power a batch would share."""
    from fisco_bcos_tpu_torch.crypto import refimpl

    return _pow_muls(refimpl.SM2P256V1.p - 2) * sm2_fp_mul()


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def lane(xs, dev):
    from fisco_bcos_tpu_torch.ops import bigint

    return torch.as_tensor(bigint.batch_to_limbs(xs).astype(np.int64),
                           device=dev).T.contiguous()


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

def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    name = torch.cuda.get_device_name(0)
    from fisco_bcos_tpu_torch.ops import _cuda

    build_s = _cuda.build_all()
    log(f"[card] {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| device {name} | kernel build {build_s:.1f} s (parallel nvcc, set-up)")
    for k, v in _cuda.PTXAS_LOG.items():
        for line in v.splitlines():
            if "registers" in line or "spill" in line.lower() and "0 bytes spill" not in line:
                log(f"[ptxas {k}] {line.strip()}")
    return smi, name


def tree_row(dev, nrng, alg: str) -> dict:
    """The Merkle level kernel of `alg` against the plain tree (and the
    host levels up to n = 4,097) at every n of MERKLE_NS; timed as the
    whole tree at the largest n."""
    from fisco_bcos_tpu_torch.ops import cuda_merkle, merkle

    name = "merkle_keccak_level" if alg == "keccak256" else "merkle_sm3_level"
    mism = err = 0
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
        log(f"[kernel] merkle {alg} n={n}: {'MISMATCH' if bad else 'ok'}")
    ms = cuda_ms(lambda: cuda_merkle.merkle_root(lt, n, alg), 20)
    parents, m = 0, n
    while m > 1:
        m = (m + 15) // 16
        parents += m
    nbytes = 32 * (n + parents) + 32 * parents
    if alg == "keccak256":  # 4 permutations or 9 compressions a parent
        bound, by = keccak_bound(4 * parents, nbytes)
    else:
        bound, by = sm3_bound(9 * parents, nbytes)
    log(f"[kernel] merkle {alg} n={n} tree: {ms:.3f} ms (plain {pms:.0f} ms), "
        f"bound {bound:.4f} ms")
    return dict(
        name=name, route="cuda", source="fisco_bcos_tpu_torch/csrc/merkle.cu",
        replaces="fisco_bcos_tpu/ops/pallas_merkle.py:220", mismatches=mism,
        max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bound, bound_by=by,
        library_ms=None, shape=f"n={n}, whole tree, one launch per level")


def phase_kernels(dev, signed, rng):
    from fisco_bcos_tpu_torch.ops import cuda_hash, cuda_verify, ec, keccak

    rows = {}
    B = EC_B
    # -- recover ------------------------------------------------------------
    vs = ec_inputs(rng, signed, B)
    e, r, s = (lane([d[k] for d in vs], dev) for k in "ers")
    v = torch.tensor([d["v"] for d in vs], device=dev)
    qx, qy, ok = cuda_verify.ecdsa_recover(e, r, s, v)
    (px, py, pok), plain_ms = wall_ms(lambda: ec.ecdsa_recover_plain(ec.SECP256K1, e, r, s, v))
    mism = int((qx.long() != px).any(0).logical_or((qy.long() != py).any(0))
               .logical_or(ok.bool() != pok).sum())
    err = max(int((qx.long() - px).abs().max()), int((qy.long() - py).abs().max()),
              int((ok.long() - pok.long()).abs().max()))
    ms = cuda_ms(lambda: cuda_verify.ecdsa_recover(e, r, s, v), 5)
    # r^-1 mod n, the Q-table inverse and Z^-1 mod p
    prods = (sum(recover_products(d["e"], d["r"], d["s"], d["v"]) for d in vs)
             + ec_batch_inversions(1, 2))
    rows["ecdsa_recover"] = dict(
        name="ecdsa_recover", route="cuda", source="fisco_bcos_tpu_torch/csrc/verify.cu",
        replaces="fisco_bcos_tpu/ops/pallas_verify.py:375", mismatches=mism,
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=ec_bound_ms(prods),
        bound_by="operations", library_ms=None, shape=f"B={B}",
        valid_lanes=int(ok.sum()))
    log(f"[kernel] recover B={B}: mismatches {mism}, {ms:.3f} ms (plain {plain_ms:.0f} ms), "
        f"valid lanes {int(ok.sum())}")
    # -- verify -------------------------------------------------------------
    vs = ec_inputs(rng, signed, B)
    args = [lane([d[k] for d in vs], dev) for k in ("e", "r", "s", "qx", "qy")]
    ok = cuda_verify.ecdsa_verify(*args)
    pok, plain_ms = wall_ms(lambda: ec.ecdsa_verify_plain(ec.SECP256K1, *args))
    mism = int((ok.bool() != pok).sum())
    ms = cuda_ms(lambda: cuda_verify.ecdsa_verify(*args), 5)
    # s^-1 mod n and the Q-table inverse
    prods = (sum(verify_products(d["e"], d["r"], d["s"], d["qx"], d["qy"]) for d in vs)
             + ec_batch_inversions(1, 1))
    rows["ecdsa_verify"] = dict(
        name="ecdsa_verify", route="cuda", source="fisco_bcos_tpu_torch/csrc/verify.cu",
        replaces="fisco_bcos_tpu/ops/pallas_verify.py:262", mismatches=mism,
        max_abs_err=int((ok.long() - pok.long()).abs().max()), ms=ms,
        plain_ms=plain_ms, bound_ms=ec_bound_ms(prods), bound_by="operations",
        library_ms=None, shape=f"B={B}", valid_lanes=int(ok.sum()))
    log(f"[kernel] verify B={B}: mismatches {mism}, {ms:.3f} ms (plain {plain_ms:.0f} ms), "
        f"valid lanes {int(ok.sum())}")
    # -- keccak -------------------------------------------------------------
    nrng = np.random.default_rng(SEED)
    lens = nrng.integers(0, 8 * 136, NTX)  # 1..8 blocks after padding
    flat = nrng.integers(0, 256, int(lens.sum()), dtype=np.uint8).tobytes()
    offs = np.concatenate([[0], np.cumsum(lens)])
    msgs = [flat[offs[i]:offs[i + 1]] for i in range(len(lens))]
    blocks, nvalid = keccak.pad_batch_np(msgs)
    bt, nv = torch.as_tensor(blocks, device=dev), torch.as_tensor(nvalid, device=dev)
    got = cuda_hash.keccak256_varlen(bt, nv)
    plain, plain_ms = wall_ms(lambda: keccak.keccak256_varlen_plain(bt, nv))
    mism = int((got != plain).any(1).sum())
    ms = cuda_ms(lambda: cuda_hash.keccak256_varlen(bt, nv), 20)
    perms = int(nvalid.sum())
    bound, by = keccak_bound(perms, perms * 136 + 4 * len(msgs) + 32 * len(msgs))
    rows["keccak256_varlen"] = dict(
        name="keccak256_varlen", route="cuda", source="fisco_bcos_tpu_torch/csrc/keccak.cu",
        replaces="fisco_bcos_tpu/ops/pallas_hash.py:125", mismatches=mism,
        max_abs_err=int((got.int() - plain.int()).abs().max()), ms=ms,
        plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None,
        shape=f"B={NTX}, {blocks.shape[1]} blocks max, {perms} permutations")
    log(f"[kernel] keccak B={NTX}: mismatches {mism}, {ms:.3f} ms (plain {plain_ms:.0f} ms)")
    # -- merkle -------------------------------------------------------------
    rows["merkle_keccak_level"] = tree_row(dev, nrng, "keccak256")
    bad = {k: r["mismatches"] for k, r in rows.items() if r["mismatches"]}
    if bad:
        fail(f"kernel vs plain mismatches: {bad}")
    return rows


def sm2_inputs(rng: random.Random, B: int):
    """B lanes of 256 host-signed SM2 vectors (8 keys), tiled, 1% of them
    corrupted by kind in turn: r = 0, s >= n, s = n - r, digest flipped,
    another key, off-curve key, key (0, 0), qx >= p."""
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
    return out, bad


def phase_sm_kernels(dev, data, rng):
    """Kernels A, B and C against their plain versions on the card at the
    SM path's shapes, bit-exact."""
    from fisco_bcos_tpu_torch.crypto import refimpl
    from fisco_bcos_tpu_torch.ops import cuda_sm3, cuda_verify, ec, sm3

    rows = {}
    # -- A: SM3 over the SM block's tx encodings ------------------------------
    msgs = [t.encode_unsigned() for t in data["txs"]]
    blocks, nvalid = sm3.pad_batch_np(msgs)
    bt, nv = torch.as_tensor(blocks, device=dev), torch.as_tensor(nvalid, device=dev)
    got = cuda_sm3.sm3_varlen(bt, nv)
    plain, plain_ms = wall_ms(lambda: sm3.sm3_varlen_plain(bt, nv))
    mism = int((got != plain).any(1).sum())
    for i in rng.sample(range(len(msgs)), 16):
        mism += bytes(got[i].cpu().numpy()) != refimpl.sm3(msgs[i])
    ms = cuda_ms(lambda: cuda_sm3.sm3_varlen(bt, nv), 20)
    comp = int(nvalid.sum())
    bound, by = sm3_bound(comp, comp * 64 + 4 * len(msgs) + 32 * len(msgs))
    rows["sm3_varlen"] = dict(
        name="sm3_varlen", route="cuda", source="fisco_bcos_tpu_torch/csrc/sm3.cu",
        replaces="fisco_bcos_tpu/ops/pallas_hash.py:174", mismatches=mism,
        max_abs_err=int((got.int() - plain.int()).abs().max()), ms=ms,
        plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None,
        shape=f"B={len(msgs)}, {int(nvalid.min())}-{int(nvalid.max())} blocks, "
              f"{comp} compressions")
    log(f"[kernel] sm3 B={len(msgs)}: mismatches {mism}, {ms:.3f} ms "
        f"(plain {plain_ms:.0f} ms), bound {bound:.4f} ms")
    # -- B: SM3 Merkle trees ----------------------------------------------------
    rows["merkle_sm3_level"] = tree_row(dev, np.random.default_rng(SEED + 2), "sm3")
    # -- C: SM2 verify at one CHUNK --------------------------------------------
    t0 = time.perf_counter()
    vs, bad = sm2_inputs(rng, EC_B)
    log(f"[kernel] 256 host SM2 signatures for kernel C: {time.perf_counter() - t0:.1f} s")
    args = [lane([d[k] for d in vs], dev) for k in ("e", "r", "s", "qx", "qy")]
    ok = cuda_verify.sm2_verify(*args)
    pok, plain_ms = wall_ms(lambda: ec.sm2_verify_plain(ec.SM2P256V1, *args))
    mism = int((ok.bool() != pok).sum())
    okl = ok.bool().tolist()
    for i in sorted(bad) + rng.sample([i for i in range(len(vs)) if i not in bad], 16):
        d = vs[i]
        mism += okl[i] != refimpl.sm2_verify((d["qx"], d["qy"]), d["e"].to_bytes(32, "big"),
                                             d["r"], d["s"])
    ms = cuda_ms(lambda: cuda_verify.sm2_verify(*args), 5)
    prods = (sum(sm2_products(d["e"], d["r"], d["s"], d["qx"], d["qy"]) for d in vs)
             + sm2_batch_inversion())
    rows["sm2_verify"] = dict(
        name="sm2_verify", route="cuda", source="fisco_bcos_tpu_torch/csrc/sm2.cu",
        replaces="fisco_bcos_tpu/ops/pallas_verify.py:507", mismatches=mism,
        max_abs_err=int((ok.long() - pok.long()).abs().max()), ms=ms,
        plain_ms=plain_ms, bound_ms=ec_bound_ms(prods), bound_by="operations",
        library_ms=None, shape=f"B={EC_B}", valid_lanes=int(ok.sum()))
    log(f"[kernel] sm2 verify B={EC_B}: mismatches {mism} ({len(bad)} corrupted lanes "
        f"and 16 signed held to the oracle), {ms:.3f} ms (plain {plain_ms:.0f} ms), "
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
    nrng = np.random.default_rng(SEED + 1)
    t0 = time.perf_counter()
    kps = [suite.generate_keypair(b"sender" + bytes([k])) for k in range(16)]
    txs = []
    lens = nrng.integers(64, 1025, NTX)
    for i in range(NTX):
        txs.append(T.Transaction(
            nonce=str(i), block_limit=1000, to=nrng.bytes(20),
            input=nrng.bytes(int(lens[i]))))
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
    receipts = [T.Receipt(gas_used=int(nrng.integers(21000, 10 ** 6)),
                          status=0, output=nrng.bytes(32), block_number=7)
                for _ in range(NTX)]
    block = T.Block(header=T.BlockHeader(number=7), transactions=txs,
                    receipts=receipts)
    # seals: 256 headers x 4 sealers, tiled to 16,384 lanes
    sealers = [suite.generate_keypair(b"sealer" + bytes([k])) for k in range(4)]
    headers = [T.BlockHeader(number=1000 + h, timestamp=h,
                             sealer_list=[k.pub_bytes for k in sealers])
               for h in range(256)]
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


def slice_counters(kind: str, route: str = "fused") -> dict:
    """The launch counters of the kernels on a suite's main path: on the
    composed EC route the fp, pow and ladder kernels take the fused EC
    kernel's place (whose counter is then expected to stay 0)."""
    from fisco_bcos_tpu_torch.ops import cuda_hash, cuda_merkle, cuda_sm3, cuda_verify

    if kind == "ecdsa":
        ec_k = {"ecdsa_recover": cuda_verify.ecdsa_recover,
                "ecdsa_verify": cuda_verify.ecdsa_verify}
        hashes = {"keccak256_varlen": cuda_hash.keccak256_varlen,
                  "merkle_keccak_level": cuda_merkle.merkle_level}
    else:
        ec_k = {"sm2_verify": cuda_verify.sm2_verify}
        hashes = {"sm3_varlen": cuda_sm3.sm3_varlen,
                  "merkle_sm3_level": cuda_merkle.merkle_sm3_level}
    if route == "fused":
        return {**ec_k, **hashes}
    return {**ec_k, **hashes, **composed_counters()}


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
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        suite.recover_addresses(dg[:8], sg[:8])
        suite.verify_batch(dg[:8], sg[:8], pb[:8])
        suite.merkle_root(data["signed_hash"][:17])
        torch.cuda.synchronize()
        with record_function(MARK):
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
    seen = {k: calls.get(k + "_kernel", 0) for k in launches}
    if seen != launches:
        fail(f"the profiler recorded kernel calls {seen}, the counters {launches}; "
             f"events: { {k + '_kernel': LAST_EVENTS.get(k + '_kernel') for k in launches} }")

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
    return launches, phases, results


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
    from torch.profiler import ProfilerActivity, profile, record_function

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
        with record_function(MARK):
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
    small = leaves[:4096]
    if zm.root(small, hasher=suite.poseidon_batch) != zm.root(small):
        fail(f"{tag} the 4,096-leaf root differs from the oracle's")
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
JAC_ADD, MIXED_ADD = 16, 11
DBL = {"secp256k1": 7, "sm2p256v1": SM2_DBL}


def pow_cases():
    """Kernel G's fields and exponents on the composed route: recovery's
    square root, and the inversions' n - 2 and p - 2."""
    from fisco_bcos_tpu_torch.crypto import refimpl
    from fisco_bcos_tpu_torch.ops import fp

    c, m = refimpl.SECP256K1, refimpl.SM2P256V1
    return [("secp256k1_p", fp.SolinasField(c.p), (c.p + 1) // 4, FP_MUL),
            ("secp256k1_n", fp.MontField(c.n), c.n - 2, FN_MUL),
            ("sm2_n", fp.MontField(m.n), m.n - 2, FN_MUL),
            ("sm2_p", fp.MontField(m.p), m.p - 2, sm2_fp_mul())]


def phase_pow_kernel(dev):
    """(8) Kernel G against the plain window loop (a field built without
    kernels) on the card, bit-exact, at [16, EC_B] and [16, 1], lanes 0-3
    the edges 0, 1, n - 1 and R mod n. `ms` is the device time at
    (p+1)/4 on secp256k1's p, recovery's square root (kernel_device_ms);
    `one_lane_ms` the device time of a [16, 1] launch, bound by the
    latency of its dependent products."""
    from fisco_bcos_tpu_torch.ops import cuda_fp, fp

    nrng = np.random.default_rng(SEED + 5)
    mism, err, row = 0, 0, None
    for name, f, e, mul_slots in pow_cases():
        a = fp_lanes(nrng, f.n_int, EC_B, dev)
        one = a[:, 2:3].contiguous()  # n - 1
        got = cuda_fp.pow_const(f, a, e)
        want, pms = wall_ms(lambda: f.pow_const(a, e))
        got1 = cuda_fp.pow_const(f, one, e)
        bad = int((got != want).any(0).sum()) + int((got1 != want[:, 2:3]).any())
        mism += bad
        err = max(err, int((got - want).abs().max()), int((got1 - want[:, 2:3]).abs().max()))
        call = cuda_ms(lambda: cuda_fp.pow_const(f, a, e), 20)
        log(f"[pow] {name} e={'(p+1)/4' if name == 'secp256k1_p' else 'm-2'} "
            f"({len(fp.msb_digits(e))} digits): mismatched lanes {bad}, {call:.4f} ms a call "
            f"[16, {EC_B}] (plain {pms:.1f} ms)")
        if row is None:
            ms = kernel_device_ms(lambda: cuda_fp.pow_const(f, a, e), "fp_pow_kernel")
            ms1 = kernel_device_ms(lambda: cuda_fp.pow_const(f, one, e), "fp_pow_kernel")
            prods = _pow_muls(e)
            ops_ms = ec_bound_ms(EC_B * prods * mul_slots)
            bytes_ms = EC_B * 2 * LANE_BYTES / H100_BYTES * 1e3
            bound, by = (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")
            row = dict(
                name="fp_pow", route="cuda", source="fisco_bcos_tpu_torch/csrc/fp.cu",
                replaces="fisco_bcos_tpu/ops/pallas_fp.py:345", ms=ms, call_ms=call,
                one_lane_ms=ms1, plain_ms=pms, bound_ms=bound, bound_by=by, library_ms=None,
                shape=f"[16, {EC_B}], e=(p+1)/4 on secp256k1 p ({prods} products a lane); "
                      f"bit-exact on 4 fields and at [16, 1]")
            log(f"[kernel] fp_pow: {ms:.4f} ms device, {call:.4f} ms a call (plain "
                f"{pms:.1f} ms), bound {bound:.4f} ms ({by}); one lane {ms1:.4f} ms device "
                f"(latency of {14 + 5 * (len(fp.msb_digits(e)) - 1)} dependent products)")
    if mism:
        fail(f"pow kernel vs plain mismatches: {mism}")
    row.update(mismatches=mism, max_abs_err=err)
    return {"fp_pow": row}


def ladder_scalars(c, nrng, B: int):
    """B lanes of canonical scalars k1, k2 and affine keys Q (64 seeded
    keys, tiled), lanes 0-8 the port's edge lanes (ec.LADDER_EDGES)."""
    from fisco_bcos_tpu_torch.crypto import refimpl
    from fisco_bcos_tpu_torch.ops import ec

    keys = [refimpl.keygen(c, seed=b"ladder" + bytes([i]))[1] for i in range(64)]
    flat = nrng.bytes(64 * B)
    k1 = [int.from_bytes(flat[64 * i:64 * i + 32], "big") % c.n for i in range(B)]
    k2 = [int.from_bytes(flat[64 * i + 32:64 * i + 64], "big") % c.n for i in range(B)]
    qx, qy = [keys[i % 64][0] for i in range(B)], [keys[i % 64][1] for i in range(B)]
    return ec.ladder_edge_lanes(c, k1, k2, qx, qy)


def ladder_products(cv, nsteps: int, digs, skip: int) -> int:
    """Products mod p that a ladder launch needs for these digits, over
    lanes skip.. (the edge lanes before `skip` are counted at none, since
    their cancellations leave the accumulator at infinity): per pair the
    window table up to its largest Q digit m (2Q a doubling, then m - 2
    mixed adds); from a lane's first nonzero digit on, whose add is a copy
    onto infinity, 4 doublings a step and an add per nonzero digit."""
    n_pairs, dbl = digs.shape[0] // 2, DBL[cv.params.name]
    d = digs[:, :, skip:].long()
    m = d[1::2].amax(1)
    table = int(torch.where(m >= 2, dbl + (m - 2) * MIXED_ADD, 0).sum())
    cost = torch.where(d == 0, 0, MIXED_ADD)
    cost[1::2] = torch.where(d[1::2] >= 2, JAC_ADD, cost[1::2])
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
        k1, k2, qx, qy = ladder_scalars(c, nrng, EC_B)
        nsteps, gts, digs, negs, qp = ec.ladder_inputs(
            cv, lane(k1, dev), lane(k2, dev), f.to_rep(lane(qx, dev)), f.to_rep(lane(qy, dev)))
        flip = torch.zeros_like(negs)
        flip[:, 9::4] = torch.as_tensor(nrng.integers(0, 2, flip[:, 9::4].shape),
                                        dtype=flip.dtype, device=dev)
        negs = negs ^ flip
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
        skip = len(ec.LADDER_EDGES)
        prods = ladder_products(cv, nsteps, digs, skip)
        slots = FP_MUL if cv.has_endo else sm2_fp_mul()
        bound = ec_bound_ms(prods * slots)
        times[c.name] = dict(ms=ms, plain_ms=pms, bound_ms=bound, products=prods)
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
        sm2_bound_ms=m["bound_ms"],
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


def main() -> int:
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
    from fisco_bcos_tpu_torch.crypto import refimpl
    from fisco_bcos_tpu_torch.crypto.suite import make_suite

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi, name = phase_card()
    rng = random.Random(SEED)
    suite = make_suite()
    c = refimpl.SECP256K1
    t0 = time.perf_counter()
    keys = [refimpl.keygen(c, seed=b"k" + bytes([k])) for k in range(8)]
    signed = []
    for i in range(256):
        sk, pub = keys[i % 8]
        h = refimpl.keccak256(b"smoke" + i.to_bytes(4, "big"))
        r, s, v = refimpl.ecdsa_sign(c, sk, h)
        signed.append(dict(e=int.from_bytes(h, "big"), r=r, s=s, v=v,
                           qx=pub[0], qy=pub[1], pub=pub))
    log(f"[kernel] 256 host signatures for the kernel inputs: "
        f"{time.perf_counter() - t0:.1f} s")
    rows = phase_kernels(dev, signed, rng)
    data = build_slice(suite, rng)
    launches, _, fused = phase_slice(dev, suite, data, rng)
    sm_suite = make_suite(sm_crypto=True)
    sm_data = build_slice(sm_suite, rng)
    rows.update(phase_sm_kernels(dev, sm_data, rng))
    sm_launches, _, sm_fused = phase_slice(dev, sm_suite, sm_data, rng)
    launches.update(sm_launches)
    idle = {k: fn.launches for k, fn in composed_counters().items()}
    if any(idle.values()):
        fail(f"fp, pow or ladder kernels launched during phases 2-5 (the plain EC "
             f"oracles): {idle}")
    rows.update(phase_fp_kernels(dev))
    fp_launches, _ = phase_poseidon(dev, suite, rng)
    by_path = {k: {"poseidon": n} for k, n in fp_launches.items()}
    rows.update(phase_pow_kernel(dev))
    rows.update(phase_ladder_kernel(dev, rng))
    for kind, d, fres in (("ecdsa", data, fused), ("sm", sm_data, sm_fused)):
        got, _ = phase_composed(dev, kind, d, fres, rng)
        for k in composed_counters():
            by_path.setdefault(k, {})[f"composed_{kind}"] = got[k]
    for k, n in launches.items():
        rows[k]["launches"] = n
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
