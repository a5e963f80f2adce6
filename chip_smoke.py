#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's block crypto path on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the plain
version or to the CPU):

1. Card: name and power limit (nvidia-smi), the kernels' parallel build.
2. Each CUDA kernel against its plain PyTorch version on the card at the
   main path's shapes, bit-exact: recover and verify at one CHUNK (16,384
   lanes), Keccak over 65,536 messages of 1-8 blocks, Merkle trees at
   n in {1, 2, 17, 4097, 65535, 65536}. Kernel times are medians of CUDA
   event timings after a warm-up; the plain version runs once.
3. The slice: a 65,536-tx block through the port's protocol entry points
   (batch_recover_senders, Block.calculate_txs_root and
   calculate_receipts_root), and a commit-seal span of 16,384 lanes through
   suite.verify_batch, checked against the pure-Python oracle on every
   distinct signed entry (by its signer) and every corrupted lane, and
   against the plain path for the tx hashes and 65,536-leaf roots. The
   launch counters are zeroed just before and read just after; every
   kernel must have launched.

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


def ec_bound_ms(products: int) -> float:
    return products * 2 / H100_INT_OPS * 1e3


def keccak_bound(perms: int, nbytes: int):
    ops_ms = perms * KECCAK_PERM_OPS / H100_INT_OPS * 1e3
    bytes_ms = nbytes / H100_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


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


def phase_kernels(dev, signed, rng):
    from fisco_bcos_tpu_torch.ops import (cuda_hash, cuda_merkle, cuda_verify,
                                          ec, keccak, merkle)

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
    mism = 0
    err = 0
    for n in MERKLE_NS:
        leaves = nrng.integers(0, 256, (n, 32), dtype=np.uint8)
        lt = torch.as_tensor(leaves, device=dev)
        root = cuda_merkle.merkle_root(lt, n)
        nb = max(16, 1 << (n - 1).bit_length())
        padded = torch.cat([lt, torch.zeros((nb - n, 32), dtype=torch.uint8, device=dev)])
        proot, pms = wall_ms(lambda: merkle.merkle_root_bucketed_plain(padded, n))
        bad = not torch.equal(root, proot)
        if n <= 4097:
            host = merkle.merkle_levels_host([bytes(x) for x in leaves])[-1][0]
            bad |= bytes(root.cpu().numpy()) != host
        mism += int(bad)
        err = max(err, int((root.int() - proot.int()).abs().max()))
        log(f"[kernel] merkle n={n}: {'MISMATCH' if bad else 'ok'}")
    ms = cuda_ms(lambda: cuda_merkle.merkle_root(lt, n), 20)
    parents, m = 0, n
    while m > 1:
        m = (m + 15) // 16
        parents += m
    bound, by = keccak_bound(4 * parents, 32 * (n + parents) + 32 * parents)
    rows["merkle_keccak_level"] = dict(
        name="merkle_keccak_level", route="cuda", source="fisco_bcos_tpu_torch/csrc/merkle.cu",
        replaces="fisco_bcos_tpu/ops/pallas_merkle.py:220", mismatches=mism,
        max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bound, bound_by=by,
        library_ms=None, shape=f"n={n}, whole tree, one launch per level")
    log(f"[kernel] merkle n={n} tree: {ms:.3f} ms (plain {pms:.0f} ms)")
    bad = {k: r["mismatches"] for k, r in rows.items() if r["mismatches"]}
    if bad:
        fail(f"kernel vs plain mismatches: {bad}")
    return rows


def phase_slice(dev, suite, rng):
    from fisco_bcos_tpu_torch.crypto import refimpl
    from fisco_bcos_tpu_torch.ops import cuda_hash, cuda_merkle, cuda_verify, keccak, merkle
    from fisco_bcos_tpu_torch.protocol import types as T

    c = refimpl.SECP256K1
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
    for i in range(NSIGNED, NTX):
        txs[i].signature = txs[i % NSIGNED].signature
    # corrupt 1% of the lanes
    corrupt = {}
    for j, i in enumerate(rng.sample(range(NTX), NTX // 100)):
        sig = bytearray(txs[i].signature)
        kind = j % 6
        if kind == 0:
            sig[:32] = bytes(32)                          # r = 0
        elif kind == 1:
            sig[32:64] = (c.n + j).to_bytes(32, "big")     # s >= n
        elif kind == 2:
            sig[64] = 4 + j % 200                          # v >= 4
        elif kind == 3:
            sig[64] ^= 1                                   # wrong key
        elif kind == 4:
            sig = sig[:40]                                 # malformed
        else:
            sig[5] ^= 0x10                                 # r flipped
        txs[i].signature = bytes(sig)
        corrupt[i] = kind
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
        kind = j % 5
        if kind == 0:
            sg[i] = bytes(32) + sg[i][32:]
        elif kind == 1:
            sg[i] = sg[i][:32] + (c.n + j).to_bytes(32, "big") + sg[i][64:]
        elif kind == 2:
            dg[i] = bytes([dg[i][0] ^ 1]) + dg[i][1:]
        elif kind == 3:
            x = (int.from_bytes(pb[i][:32], "big") + 1) % c.p
            pb[i] = x.to_bytes(32, "big") + pb[i][32:]
        else:
            pb[i] = seal_p[(i + 1) % len(seal_p)]
        seal_bad[i] = kind
    setup_s = time.perf_counter() - t0
    log(f"[slice] set-up (payloads, {NSIGNED + len(seal_s)} host signatures, "
        f"corruption): {setup_s:.1f} s")

    # -- the main path: counters zeroed just before, read just after --------
    counters = {"ecdsa_recover": cuda_verify.ecdsa_recover,
                "ecdsa_verify": cuda_verify.ecdsa_verify,
                "keccak256_varlen": cuda_hash.keccak256_varlen,
                "merkle_keccak_level": cuda_merkle.merkle_level}
    for fn in counters.values():
        fn.launches = 0
    phases = {}
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        (senders, ok), phases["recover_senders"] = wall_ms(
            lambda: T.batch_recover_senders(txs, suite))
        txs_root, phases["txs_root"] = wall_ms(lambda: block.calculate_txs_root(suite))
        rc_root, phases["receipts_root"] = wall_ms(
            lambda: block.calculate_receipts_root(suite))
        seal_ok, phases["seal_verify"] = wall_ms(lambda: suite.verify_batch(dg, sg, pb))
    launches = {k: fn.launches for k, fn in counters.items()}
    device_us = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", 0) or 0
        if t:
            device_us[ev.key.split("(")[0]] = t
    total_ms = sum(phases.values())
    dev_ms = sum(device_us.values()) / 1e3
    log(f"[slice] launches on the main path: {launches}")
    for k, v in phases.items():
        log(f"[slice] {k}: {v:.1f} ms wall")
    if dev_ms:
        top = dict(sorted(device_us.items(), key=lambda kv: -kv[1])[:8])
        log(f"[slice] device time {dev_ms:.1f} ms of {total_ms:.1f} ms wall "
            f"(host {total_ms - dev_ms:.1f} ms); largest by kernel (us): {top}")
    else:
        log("[slice] device kernel time: not measured (profiler saw no kernels)")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        fail(f"the main path did not launch {missing}")

    # -- checks ---------------------------------------------------------------
    hashes = [t._hash for t in txs]
    if hashes[:NSIGNED] != signed_hash:
        fail("tx hashes differ from the host oracle on the signed entries")
    blocks, nvalid = keccak.pad_batch_np([t.encode_unsigned() for t in txs])
    plain = keccak.keccak256_varlen_plain(torch.as_tensor(blocks, device=dev),
                                          torch.as_tensor(nvalid, device=dev))
    if [bytes(x) for x in plain.cpu().numpy()] != hashes:
        fail("tx hashes differ from the plain path")
    bad = 0
    for i in range(NSIGNED):
        want = kps[i % 16].address if i not in corrupt else None
        if want is not None and (senders[i] != want or not ok[i]):
            bad += 1
    checked = set(range(NSIGNED)) | set(corrupt)
    sample = rng.sample([i for i in range(NSIGNED, NTX) if i not in corrupt], 64)
    for i in sorted(set(corrupt) | set(sample)):
        sig = txs[i].signature
        if len(sig) < 65:
            Q = None
        else:
            Q = refimpl.ecdsa_recover(c, hashes[i], int.from_bytes(sig[:32], "big"),
                                      int.from_bytes(sig[32:64], "big"), sig[64])
        want = (refimpl.keccak256(Q[0].to_bytes(32, "big") + Q[1].to_bytes(32, "big"))[12:]
                if Q is not None else None)
        if senders[i] != want or bool(ok[i]) != (Q is not None):
            bad += 1
    if bad:
        fail(f"{bad} sender lanes differ from the host oracle")
    log(f"[slice] senders: {len(checked) + len(sample)} lanes held to the oracle "
        f"({NSIGNED} signed, {len(corrupt)} corrupted, {len(sample)} tiled), "
        f"{int(ok.sum())} of {NTX} valid")
    leaves = torch.as_tensor(np.frombuffer(bytearray(b"".join(hashes)), np.uint8)
                             .reshape(NTX, 32), device=dev)
    if bytes(merkle.merkle_root_bucketed_plain(leaves, NTX).cpu().numpy()) != txs_root:
        fail("txs root differs from the plain path")
    rleaves = torch.as_tensor(np.frombuffer(bytearray(b"".join(r._hash for r in receipts)),
                                            np.uint8).reshape(NTX, 32), device=dev)
    if bytes(merkle.merkle_root_bucketed_plain(rleaves, NTX).cpu().numpy()) != rc_root:
        fail("receipts root differs from the plain path")
    for i in rng.sample(range(NTX), 16):
        if receipts[i]._hash != refimpl.keccak256(receipts[i].encode()):
            fail("receipt hash differs from the host oracle")
    sub = [bytes(x) for x in hashes[:4096]]
    if suite.merkle_root(sub) != merkle.merkle_levels_host(sub)[-1][0]:
        fail("4096-leaf root differs from merkle_levels_host")
    bad = 0
    for i in range(NSEAL):
        if i in seal_bad:
            want = refimpl.ecdsa_verify(
                c, (int.from_bytes(pb[i][:32], "big"), int.from_bytes(pb[i][32:], "big")),
                dg[i], int.from_bytes(sg[i][:32], "big"), int.from_bytes(sg[i][32:64], "big"))
        else:
            want = True  # a signature the oracle made, over its own digest
        bad += bool(seal_ok[i]) != want
    for i in rng.sample(range(len(seal_d)), 32):
        if not refimpl.ecdsa_verify(c, (int.from_bytes(seal_p[i][:32], "big"),
                                        int.from_bytes(seal_p[i][32:], "big")),
                                    seal_d[i], int.from_bytes(seal_s[i][:32], "big"),
                                    int.from_bytes(seal_s[i][32:64], "big")):
            fail("oracle rejects its own seal")
    if bad:
        fail(f"{bad} seal lanes differ from the host oracle")
    log(f"[slice] seals: {NSEAL} lanes, {len(seal_bad)} corrupted, "
        f"{int(seal_ok.sum())} accepted; all agree with the oracle")
    log(f"[slice] txs root {txs_root.hex()} receipts root {rc_root.hex()}")
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
    launches, _ = phase_slice(dev, suite, rng)
    for k, n in launches.items():
        rows[k]["launches"] = n
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": list(rows.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
