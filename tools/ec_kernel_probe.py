#!/usr/bin/env python3
"""Probe the port's EC kernels (csrc/ladder.cu, csrc/sm2.cu and the
secp256k1 recover and verify kernels of csrc/verify.cu), kernel G (the
pow kernels of csrc/fp.cu), the varlen Keccak and SM3 kernels
(csrc/keccak.cu, csrc/sm3.cu) and the Merkle tree kernels
(csrc/merkle.cu) on one NVIDIA card, for one or more copies of their
sources.

    python3 tools/ec_kernel_probe.py [--out DIR] [--kernels K,...] [COPY ...]

A COPY is a copy of csrc/ or a tree that holds fisco_bcos_tpu_torch/csrc/
(for example an unpacked `git archive` of an older commit). With none it
probes the port's own fisco_bcos_tpu_torch/csrc/. Several copies (at
different steps of a change) are built in parallel and measured in one
process on one card, in turns, so that their times compare. K is any of
ladder, sm2, verify, fp, keccak, sm3, merkle (default all). For each copy it
prints:

- ptxas registers and stack of each kernel, and the static SASS counts of
  each function (instructions, LDL, STL, CALL, BRA; cuobjdump -sass);
- the SASS instructions of one field product, from a one-product kernel
  per field (`probe_*_mul`), with ladder or sm2;
- a lane sweep: ms and ns per lane of each kernel (the ladder in its GLV
  form on secp256k1 and its plain form on SM2, SM2 verify, secp256k1
  recover and verify) at B = 16,384, 65,536 and 131,072 lanes, the
  16,384-lane inputs tiled;
- mismatches at B = 16,384 against the plain versions (computed once on
  the card): the ladder on chip_smoke.py's lanes (edge, carry-stress and
  flipped-sign lanes), SM2 verify on its 1% adversarial and carry-stress
  lanes, recover and verify on chip_smoke.py's lanes (1% corrupted, the
  inversion-stress lanes of chip_smoke.ecdsa_cases);
- with fp: kernel G at each of chip_smoke.pow_cases' fields and exponents
  (every field's m - 2, secp256k1's (p+1)/4, m - 3), bit-exact against the
  plain window loop, device ms at [16, 16,384] and [16, 1] (the
  profiler's mean of 20, chip_smoke.kernel_device_ms), through the copy's
  mode launch where it has one (a copy without them runs every exponent
  through its window loop);
- with keccak: the varlen kernel on chip_smoke.keccak_cases' two shapes
  (65,536 messages of 1-8 blocks, 65,536 one-block 64-byte keys), bit-exact
  against the plain version, device ms as for fp, and the SASS opcodes of
  one Keccak round (`probe_keccak_round`, where the copy's keccak.cuh has
  `keccak_round`);
- with sm3: the varlen kernel on the SM block's three shapes (chip_smoke's
  65,536 tx encodings of 3-18 blocks and 65,536 receipt encodings, from
  chip_smoke.block_payloads, and 65,536 seeded 64-byte keys, two blocks
  each), bit-exact against the plain version in 50 launches a shape (the
  slot a message takes varies between launches), device ms as for fp, ms
  a call by CUDA events, the kernel's SASS opcodes and those of one SM3
  compression (`probe_sm3_compress`);
- with merkle: the Keccak and SM3 trees at n = 65,536 and n = 16 leaves,
  bit-exact against the plain tree in 50 launches each, device ms a tree (the profiler's, as
  for fp) and, for a copy that launches once a level, each level's; ms a
  tree by CUDA events (the host's launches included); the SASS of one
  Keccak round and one SM3 compression (`probe_sm3_compress`), and each
  tree's chain floor at n = 65,536: levels x steps a node (96 Keccak
  rounds, 9 SM3 compressions) x SASS instructions a step, over the SM
  clock that nvidia-smi reads while the card runs trees.

Builds go to fisco_bcos_tpu_torch/_build/probe/<copy>/, the SASS text of
the one-product kernels to DIR (default: the same build directory). A
tree's kernels take the constant blocks of that tree's own
ops/consts.kernel_words (so an older layout loads as that tree loaded it);
a bare csrc/ copy takes this tree's. Exits non-zero on a build failure or
a mismatch.
"""

from __future__ import annotations

import ctypes
import random
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

OUT = ROOT / "fisco_bcos_tpu_torch" / "_build" / "probe"  # git-ignored
# one product per field, its operands and result in device memory
PROBE_SRC = r"""
#include "ec.cuh"
#include "sm2.cuh"
template <class F>
__device__ __forceinline__ void one_mul(u32 *o, const u32 *a, const u32 *b) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    u32 x[8], y[8], r[8];
    for (int k = 0; k < 8; ++k) { x[k] = a[8 * i + k]; y[k] = b[8 * i + k]; }
    F::mul(r, x, y);
    for (int k = 0; k < 8; ++k) o[8 * i + k] = r[k];
}
__global__ void probe_sm2_mul(u32 *o, const u32 *a, const u32 *b) { one_mul<Sm2Fp>(o, a, b); }
__global__ void probe_secp_mul(u32 *o, const u32 *a, const u32 *b) { one_mul<SecpFp>(o, a, b); }
"""
# one Keccak round on a state in device memory, for its SASS
PROBE_KECCAK_SRC = r"""
#include "keccak.cuh"
__global__ void probe_keccak_round(uint64_t *s, uint64_t rc) {
    uint64_t a[25];
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    for (int k = 0; k < 25; ++k) a[k] = s[25 * i + k];
    keccak_round(a, rc);
    for (int k = 0; k < 25; ++k) s[25 * i + k] = a[k];
}
"""
# one SM3 compression on a state in device memory, for its SASS
PROBE_SM3_SRC = r"""
#include "sm3.cuh"
__global__ void probe_sm3_compress(uint32_t *s, const uint32_t *m) {
    uint32_t V[8], w[16];
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    for (int k = 0; k < 8; ++k) V[k] = s[8 * i + k];
    for (int k = 0; k < 16; ++k) w[k] = m[16 * i + k];
    sm3_compress(V, w);
    for (int k = 0; k < 8; ++k) s[8 * i + k] = V[k];
}
"""
PROBES = {"probe_mul": PROBE_SRC, "probe_keccak": PROBE_KECCAK_SRC, "probe_sm3": PROBE_SM3_SRC}
# the opcodes left out of a probe's count: its state's loads and stores and
# the index arithmetic around them
NOT_STEP = ("LDG", "STG", "LDC", "S2R", "IMAD", "EXIT", "BRA", "ULDC")
# the entry points of older copies, which _cuda.SIGNATURES no longer lists:
# older copies of csrc/merkle.cu, one launch a level
LEGACY_SIGNATURES = {"merkle": {
    "merkle_keccak_level_launch": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_void_p],
    "merkle_sm3_level_launch": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                ctypes.c_int, ctypes.c_void_p]}}
MERKLE_NS = (65536, 16)
MERKLE_STEPS = {"keccak256": 96, "sm3": 9}  # rounds, compressions a node


def log(*a):
    print(*a, flush=True)


KERNELS = ("ladder", "sm2", "verify", "fp", "keccak", "sm3", "merkle")


def build(todo: dict[str, tuple[Path, list[str]]]) -> dict:
    """nvcc every copy's libraries ({copy: (csrc/ directory, [library])},
    a library being a kernel source or the one-product probe), all at
    once; -> {(copy, library): (library path, ptxas log)}."""
    from fisco_bcos_tpu_torch.ops import _cuda

    procs = {}
    for c, (d, names) in todo.items():
        out = OUT / c
        out.mkdir(parents=True, exist_ok=True)
        for name in names:
            src = d / f"{name}.cu"
            if name in PROBES:
                src = out / f"{name}.cu"
                src.write_text(PROBES[name])
            lib = out / f"lib{name}.so"
            cmd = [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-I", str(d), "-o", str(lib), str(src)]
            procs[c, name] = (lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for key, (lib, p) in procs.items():
        text, _ = p.communicate()
        if p.returncode:
            log(text)
            raise SystemExit(f"probe: nvcc failed for {key}")
        built[key] = (lib, text)
    return built


# a tree's constant words for each library, by that tree's own code:
# python3 -c CONST_WORDS_SRC TREE OUT.npz LIB...
CONST_WORDS_SRC = r"""
import sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from fisco_bcos_tpu_torch.ops import _cuda
from fisco_bcos_tpu_torch.ops.consts import derive_consts, kernel_words
blocks = kernel_words(derive_consts())
np.savez(sys.argv[2], **{n: np.concatenate([blocks[b] for b in _cuda.CONST_BLOCK[n]])
                         for n in sys.argv[3:]})
"""


def copy_dirs(arg: str) -> tuple[Path, Path | None]:
    """A COPY argument -> (its csrc/ directory, its tree or None for a bare
    csrc/ copy)."""
    d = Path(arg).resolve()
    if (d / "fisco_bcos_tpu_torch" / "csrc").is_dir():
        return d / "fisco_bcos_tpu_torch" / "csrc", d
    return d, None


def const_words(tree: Path | None, kernels) -> dict:
    """{library: the uint32 words its set_consts takes}: from `tree`'s own
    kernel_words, in a process of its own (the tree's package has this
    one's name), or from this tree's."""
    from fisco_bcos_tpu_torch.ops import _cuda
    from fisco_bcos_tpu_torch.ops.consts import derive_consts, kernel_words

    if tree is None or tree == ROOT:
        blocks = kernel_words(derive_consts())
        return {n: np.concatenate([blocks[b] for b in _cuda.CONST_BLOCK[n]]) for n in kernels}
    OUT.mkdir(parents=True, exist_ok=True)
    out = OUT / f"{tree.name}_consts.npz"
    subprocess.run([sys.executable, "-c", CONST_WORDS_SRC, str(tree), str(out), *kernels],
                   check=True, cwd=tree)
    with np.load(out) as z:
        return {n: z[n] for n in kernels}


def load(lib_path: Path, name: str, dev, words: np.ndarray) -> ctypes.CDLL:
    """A copy's library with its constant block (`words`) set, as
    ops/_cuda.library loads the port's own."""
    from fisco_bcos_tpu_torch.ops import _cuda

    lib = ctypes.CDLL(str(lib_path))
    lib.cuda_error_string.restype = ctypes.c_char_p
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    for fn, argtypes in {**_cuda.SIGNATURES[name], **LEGACY_SIGNATURES.get(name, {}),
                         "set_consts": [_cuda._P, _cuda._I]}.items():
        if not hasattr(lib, fn):  # an older copy without this entry point
            continue
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    words = np.ascontiguousarray(words, dtype=np.uint32)
    with torch.cuda.device(dev):
        rc = lib.set_consts(words.ctypes.data_as(ctypes.c_void_p), words.size)
    _cuda.check(lib, rc, f"{lib_path} set_consts")
    return lib


def ladder_call(lib, curve: int, nsteps: int, gts, digs, negs, qp):
    from fisco_bcos_tpu_torch.ops import _cuda

    B = qp.shape[-1]
    out = torch.empty((3, 16, B), dtype=torch.int64, device=qp.device)
    rc = lib.ladder_launch(_cuda.ptr(gts), _cuda.ptr(digs), _cuda.ptr(negs), _cuda.ptr(qp),
                           _cuda.ptr(out), curve, qp.shape[0], nsteps, B, _cuda.stream_ptr(qp))
    _cuda.check(lib, rc, "ladder")
    return out


def sm2_call(lib, gtab, args):
    from fisco_bcos_tpu_torch.ops import _cuda

    B = args[0].shape[1]
    ok = torch.empty((B,), dtype=torch.int32, device=args[0].device)
    rc = lib.sm2_verify_launch(*(_cuda.ptr(a) for a in args), _cuda.ptr(gtab), _cuda.ptr(ok), B,
                               _cuda.stream_ptr(ok))
    _cuda.check(lib, rc, "sm2_verify")
    return ok


def recover_call(lib, gtab, e, r, s, v):
    from fisco_bcos_tpu_torch.ops import _cuda

    B = e.shape[1]
    qx = torch.empty((16, B), dtype=torch.int32, device=e.device)
    qy = torch.empty_like(qx)
    ok = torch.empty((B,), dtype=torch.int32, device=e.device)
    rc = lib.ecdsa_recover_launch(*(_cuda.ptr(a) for a in (e, r, s, v, gtab, qx, qy, ok)), B,
                                  _cuda.stream_ptr(e))
    _cuda.check(lib, rc, "ecdsa_recover")
    return qx, qy, ok


def verify_call(lib, gtab, args):
    from fisco_bcos_tpu_torch.ops import _cuda

    B = args[0].shape[1]
    ok = torch.empty((B,), dtype=torch.int32, device=args[0].device)
    rc = lib.ecdsa_verify_launch(*(_cuda.ptr(a) for a in args), _cuda.ptr(gtab), _cuda.ptr(ok),
                                 B, _cuda.stream_ptr(ok))
    _cuda.check(lib, rc, "ecdsa_verify")
    return ok


def pow_call(lib, f, a, e: int):
    """Kernel G of a copy's fp library at a^e: through its mode launch
    (cuda_fp.pow_mode) where the library has one, else its window loop."""
    from fisco_bcos_tpu_torch.ops import _cuda, cuda_fp, fp

    B = a.shape[1]
    out = torch.empty_like(a)
    fw = cuda_fp._field_words(f).ctypes.data_as(ctypes.c_void_p)
    mode = cuda_fp.pow_mode(f, e)
    st = _cuda.stream_ptr(a)
    if mode == cuda_fp.INVERSE and hasattr(lib, "fp_pow_inv_launch"):
        iw = cuda_fp._inv_words(f).ctypes.data_as(ctypes.c_void_p)
        rc = lib.fp_pow_inv_launch(_cuda.ptr(a), _cuda.ptr(out), iw, fw, B, st)
    elif mode == cuda_fp.SQRT and hasattr(lib, "fp_pow_sqrt_launch"):
        rc = lib.fp_pow_sqrt_launch(_cuda.ptr(a), _cuda.ptr(out), B, st)
    else:
        digits = np.ascontiguousarray(fp.msb_digits(e, 4), dtype=np.uint8)
        one = cuda_fp._words(f.encode_int(1))
        rc = lib.fp_pow_launch(_cuda.ptr(a), _cuda.ptr(out),
                               digits.ctypes.data_as(ctypes.c_void_p),
                               one.ctypes.data_as(ctypes.c_void_p), fw, len(digits), B, st)
    _cuda.check(lib, rc, "fp_pow")
    return out


def keccak_call(lib, blocks, nvalid):
    from fisco_bcos_tpu_torch.ops import _cuda

    out = torch.empty((blocks.shape[0], 32), dtype=torch.uint8, device=blocks.device)
    rc = lib.keccak256_varlen_launch(_cuda.ptr(blocks), _cuda.ptr(nvalid), _cuda.ptr(out),
                                     blocks.shape[0], blocks.shape[1], _cuda.stream_ptr(out))
    _cuda.check(lib, rc, "keccak256_varlen")
    return out


def sm3_call(lib, blocks, nvalid):
    from fisco_bcos_tpu_torch.ops import _cuda

    out = torch.empty((blocks.shape[0], 32), dtype=torch.uint8, device=blocks.device)
    rc = lib.sm3_varlen_launch(_cuda.ptr(blocks), _cuda.ptr(nvalid), _cuda.ptr(out),
                               blocks.shape[0], blocks.shape[1], _cuda.stream_ptr(out))
    _cuda.check(lib, rc, "sm3_varlen")
    return out


def sm3_cases():
    """The SM block's three SM3 launches: [(shape, messages)]."""
    txs, receipts = cs.block_payloads()
    keys = np.random.default_rng(cs.SEED + 8).integers(0, 256, (cs.NTX, 64), dtype=np.uint8)
    return [("tx encodings", [t.encode_unsigned() for t in txs]),
            ("receipts", [r.encode() for r in receipts]),
            ("address keys", [bytes(k) for k in keys])]


def merkle_levels(n: int) -> int:
    levels = 0
    while n > 1:
        n, levels = -(-n // 16), levels + 1
    return levels


def merkle_call(lib, alg: str, leaves, n: int):
    """A copy's tree of `alg` over the first n rows of leaves -> its root:
    one launch (the tree kernels) or one a level (older copies' level
    kernels)."""
    from fisco_bcos_tpu_torch.ops import _cuda

    h = "keccak" if alg == "keccak256" else "sm3"
    st = _cuda.stream_ptr(leaves)
    if hasattr(lib, f"merkle_{h}_tree_launch"):
        words = lib.merkle_tree_scratch_words(n)
        scratch = torch.empty((words,), dtype=torch.int32, device=leaves.device)
        root = torch.empty((32,), dtype=torch.uint8, device=leaves.device)
        rc = getattr(lib, f"merkle_{h}_tree_launch")(
            _cuda.ptr(leaves), leaves.shape[0], n, _cuda.ptr(scratch), scratch.numel(),
            _cuda.ptr(root), st)
        _cuda.check(lib, rc, f"merkle_{h}_tree")
        return root
    nodes, count = leaves, n
    while count > 1:
        out = torch.empty((-(-nodes.shape[0] // 16), 32), dtype=torch.uint8, device=leaves.device)
        rc = getattr(lib, f"merkle_{h}_level_launch")(
            _cuda.ptr(nodes), nodes.shape[0], count, _cuda.ptr(out), out.shape[0], st)
        _cuda.check(lib, rc, f"merkle_{h}_level")
        nodes, count = out, -(-count // 16)
    return nodes[0]


def merkle_kernel(lib, alg: str, n: int) -> tuple[str, int]:
    """A copy's tree kernel's name and its launches a tree."""
    h = "keccak" if alg == "keccak256" else "sm3"
    if hasattr(lib, f"merkle_{h}_tree_launch"):
        return f"merkle_{h}_tree_kernel", 1
    return f"merkle_{h}_level_kernel", merkle_levels(n)


def sm_clock_under(fn, seconds: float = 1.5) -> float:
    """The SM clock (MHz) that nvidia-smi reads while the card runs fn()
    over and over."""
    import threading

    got = {}

    def query():
        time.sleep(0.5)
        got["smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()

    t = threading.Thread(target=query)
    t.start()
    t0 = time.perf_counter()
    while t.is_alive() or time.perf_counter() - t0 < seconds:
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
    t.join()
    log(f"[probe] nvidia-smi under load: clocks.sm, clocks.max.sm = {got['smi']}")
    return float(got["smi"].split(",")[0].split()[0])


def ladder_tiles(lib, curve, nsteps, gts, digs, negs, qp):
    """k -> a launch of the ladder on the inputs tiled k times"""
    def make(k):
        a = (digs.repeat(1, 1, k), negs.repeat(1, k), qp.repeat(1, 1, 1, k))
        return lambda: ladder_call(lib, curve, nsteps, gts, *a)
    return make


def sm2_tiles(lib, gtab, args):
    """k -> a launch of SM2 verify on the inputs tiled k times"""
    def make(k):
        a = [x.repeat(1, k) for x in args]
        return lambda: sm2_call(lib, gtab, a)
    return make


def main() -> int:
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 2
    from fisco_bcos_tpu_torch.ops import cuda_verify, ec

    args = sys.argv[1:]
    sass_out, kernels = OUT, KERNELS
    while args[:1] in (["--out"], ["--kernels"]):
        if args[0] == "--out":
            sass_out = Path(args[1]).resolve()
        else:
            kernels = tuple(args[1].split(","))
            if set(kernels) - set(KERNELS):
                raise SystemExit(f"probe: kernels are among {KERNELS}")
        args = args[2:]
    copies = [copy_dirs(a) for a in args] or [(ROOT / "fisco_bcos_tpu_torch" / "csrc", None)]
    names = [(t or d).name for d, t in copies]
    if len(set(names)) != len(names):
        raise SystemExit("probe: the copies need distinct names")
    # every copy's libraries
    todo = {c: (d, list(kernels) + (["probe_mul"] if {"ladder", "sm2"} & set(kernels) else [])
                + (["probe_keccak"] if {"keccak", "merkle"} & set(kernels)
                   and "keccak_round" in (d / "keccak.cuh").read_text() else [])
                + (["probe_sm3"] if {"sm3", "merkle"} & set(kernels) else []))
            for c, (d, _) in zip(names, copies)}
    dev = torch.device("cuda")
    log(f"[probe] {cs.phase_card_line()}")
    t0 = time.perf_counter()
    built = build(todo)
    sass_out.mkdir(parents=True, exist_ok=True)
    log(f"[probe] {len(built)} builds in parallel: {time.perf_counter() - t0:.1f} s")
    step_sass = {}  # (copy, alg) -> SASS instructions a step of the node's chain
    for (copy, name), (lib, text) in sorted(built.items()):
        for fn, info in cs.ptxas_summary(text).items():
            log(f"[ptxas {copy}/{name}] {fn}: {info}")
        dump = sass_out / f"{copy}_{name}.sass" if name == "probe_mul" else None
        for fn, c in cs.sass_counts(lib, dump).items():
            log(f"[sass {copy}/{name}] {fn}: {c}")
        if name == "probe_keccak":
            ops = next(v for k, v in cs.sass_opcodes(lib).items() if "probe_keccak_round" in k)
            logic = {k: v for k, v in ops.items() if k not in NOT_STEP}
            step_sass[copy, "keccak256"] = sum(logic.values())
            log(f"[sass {copy}/keccak round] {sum(logic.values())} instructions a round "
                f"past the state's loads and stores: {logic} (all: {ops})")
        if name == "sm3":
            for fn, ops in cs.sass_opcodes(lib).items():
                log(f"[sass {copy}/sm3] {fn} opcodes: {dict(sorted(ops.items()))}")
        if name == "probe_sm3":
            ops = next(v for k, v in cs.sass_opcodes(lib).items() if "probe_sm3_compress" in k)
            logic = {k: v for k, v in ops.items() if k not in NOT_STEP}
            step_sass[copy, "sm3"] = sum(logic.values())
            log(f"[sass {copy}/sm3 compression] {sum(logic.values())} instructions a "
                f"compression past the state's loads and stores: {logic} (all: {ops})")

    # -- inputs at B = 16,384 and the plain versions, once --------------------
    # each case: (kernel, form, k -> a launcher of the inputs tiled k times
    # on a copy's library, the copy's outputs -> mismatched lanes)
    rng = random.Random(cs.SEED)
    cases = []
    if "ladder" in kernels:
        for cv, curve in ((ec.SECP256K1, 0), (ec.SM2P256V1, 1)):
            (nsteps, gts, digs, negs, qp), _ = cs.ladder_case(
                cv, np.random.default_rng(cs.SEED + 6), dev)
            want, pms = cs.wall_ms(lambda: ec.ladder_plain(cv, nsteps, gts, digs, negs, qp))
            log(f"[probe] ladder {cv.params.name}: plain {pms:.0f} ms at B={cs.EC_B}")
            a = (curve, nsteps, gts, digs, negs, qp)
            cases.append(("ladder", f"ladder {cv.params.name}",
                          lambda lib, k, a=a: ladder_tiles(lib, *a)(k),
                          lambda got, want=want: int((got != want).any(0).any(0).sum())))
    if "sm2" in kernels:
        vs, _ = cs.sm2_inputs(rng, cs.EC_B)
        sm_args = [cs.lane([d[k] for d in vs], dev).to(torch.int32).contiguous()
                   for k in ("e", "r", "s", "qx", "qy")]
        sm_want, pms = cs.wall_ms(lambda: ec.sm2_verify_plain(ec.SM2P256V1, *sm_args))
        log(f"[probe] sm2_verify: plain {pms:.0f} ms at B={cs.EC_B}, "
            f"{int(sm_want.sum())} valid lanes")
        gtab = cuda_verify._gtab(dev, "sm2_gtab")
        cases.append(("sm2", "sm2_verify", lambda lib, k: sm2_tiles(lib, gtab, sm_args)(k),
                      lambda ok: int((ok.bool() != sm_want).sum())))
    if "verify" in kernels:
        rec_vs, ver_vs, _, _ = cs.ecdsa_cases(rng, cs.signed_entries(), cs.EC_B)
        gtab = cuda_verify._gtab(dev)
        e, r, s, v = (x.to(torch.int32).contiguous() for x in cs.recover_tensors(rec_vs, dev))
        (px, py, pok), pms = cs.wall_ms(lambda: ec.ecdsa_recover_plain(ec.SECP256K1, e, r, s, v))
        log(f"[probe] ecdsa_recover: plain {pms:.0f} ms at B={cs.EC_B}, "
            f"{int(pok.sum())} valid lanes")
        cases.append(("verify", "ecdsa_recover",
                      lambda lib, k: lambda a=[x.repeat(1, k) for x in (e, r, s)] + [v.repeat(k)]:
                      recover_call(lib, gtab, *a),
                      lambda out: int((out[0].long() != px).any(0).logical_or(
                          (out[1].long() != py).any(0)).logical_or(out[2].bool() != pok).sum())))
        ver_args = [x.to(torch.int32).contiguous() for x in cs.verify_tensors(ver_vs, dev)]
        vok, pms = cs.wall_ms(lambda: ec.ecdsa_verify_plain(ec.SECP256K1, *ver_args))
        log(f"[probe] ecdsa_verify: plain {pms:.0f} ms at B={cs.EC_B}, "
            f"{int(vok.sum())} valid lanes")
        cases.append(("verify", "ecdsa_verify",
                      lambda lib, k: lambda a=[x.repeat(1, k) for x in ver_args]:
                      verify_call(lib, gtab, a),
                      lambda ok: int((ok.bool() != vok).sum())))

    # kernel G, Keccak, Merkle: bit-exact, then ms at fixed shapes, copies in
    # turns (library, case, launcher(lib) -> a function, kernel name(lib) or
    # (name, launches a call), mismatch(out) -> int)
    timed = []
    if "fp" in kernels:
        from fisco_bcos_tpu_torch.ops import cuda_fp

        nrng = np.random.default_rng(cs.SEED + 5)
        for name, f, e, _ in cs.pow_cases():
            a = cs.fp_lanes(nrng, f.n_int, cs.EC_B, dev)
            want = f.pow_const(a, e)
            one = a[:, 2:3].contiguous()
            mode = cuda_fp.pow_mode(f, e)
            launch = {cuda_fp.INVERSE: "fp_pow_inv_launch", cuda_fp.SQRT: "fp_pow_sqrt_launch"}
            for x, w, width in ((a, want, cs.EC_B), (one, want[:, 2:3], 1)):
                kname = cs.POW_KERNELS[mode]
                if width == 1:
                    kname = cs.POW_KERNELS.get(mode + " one lane", kname)
                timed.append(("fp", f"pow {name} {mode} [16, {width}]",
                              lambda lib, f=f, x=x, e=e: lambda: pow_call(lib, f, x, e),
                              lambda lib, k=kname, fn=launch.get(mode): k
                              if fn and hasattr(lib, fn) else "fp_pow_kernel",
                              lambda out, w=w: int((out != w).any(0).sum())))
    if "keccak" in kernels:
        from fisco_bcos_tpu_torch.ops import keccak

        for shape, batch in cs.keccak_cases(np.random.default_rng(cs.SEED)):
            blocks, nvalid = keccak.pad_batch_np(batch)
            bt = torch.as_tensor(blocks, device=dev)
            nv = torch.as_tensor(nvalid, device=dev).to(torch.int32).contiguous()
            want = keccak.keccak256_varlen_plain(bt, nv)
            timed.append(("keccak", f"keccak {shape} B={cs.NTX}",
                          lambda lib, bt=bt, nv=nv: lambda: keccak_call(lib, bt, nv),
                          lambda lib: "keccak256_varlen_kernel",
                          lambda out, w=want: int((out != w).any(1).sum())))
    if "sm3" in kernels:
        from fisco_bcos_tpu_torch.ops import sm3

        for shape, batch in sm3_cases():
            blocks, nvalid = sm3.pad_batch_np(batch)
            bt = torch.as_tensor(blocks, device=dev)
            nv = torch.as_tensor(nvalid, device=dev).to(torch.int32).contiguous()
            want = sm3.sm3_varlen_plain(bt, nv)
            log(f"[probe] sm3 {shape}: B={len(batch)}, {int(nvalid.min())}-"
                f"{int(nvalid.max())} blocks, {int(nvalid.sum())} compressions")
            timed.append(("sm3", f"sm3 {shape}",
                          lambda lib, bt=bt, nv=nv: lambda: sm3_call(lib, bt, nv),
                          lambda lib: "sm3_varlen_kernel",
                          lambda out, w=want: int((out != w).any(1).sum())))
    if "merkle" in kernels:
        from fisco_bcos_tpu_torch.ops import merkle

        nrng = np.random.default_rng(cs.SEED + 7)
        for alg in ("keccak256", "sm3"):
            for n in MERKLE_NS:
                lt = torch.as_tensor(nrng.integers(0, 256, (n, 32), dtype=np.uint8), device=dev)
                nb = max(16, 1 << (n - 1).bit_length())
                padded = torch.cat([lt, torch.zeros((nb - n, 32), dtype=torch.uint8, device=dev)])
                want = merkle.merkle_root_bucketed_plain(padded, n, alg)
                timed.append(("merkle", f"merkle {alg} n={n}",
                              lambda lib, a=alg, x=lt, n=n: lambda: merkle_call(lib, a, x, n),
                              lambda lib, a=alg, n=n: merkle_kernel(lib, a, n),
                              lambda out, w=want: int(not torch.equal(out, w))))

    # -- every copy: bit-exact, then the sweep, copies in turns ---------------
    words = {c: const_words(t, kernels) for c, (_, t) in zip(names, copies)}
    libs = {(c, k): load(built[c, k][0], k, dev, words[c][k]) for c in names for k in kernels}
    bad = 0
    for c in names:
        for lib_name, kern, launcher, mism in cases:
            n = mism(launcher(libs[c, lib_name], 1)())
            bad += n
            log(f"[probe {c}] {kern}: mismatched lanes {n} of {cs.EC_B}")
    for c in names:
        for lib_name, case, launcher, _, mism in timed:
            # a tree's schedule depends on the order of arrivals, a varlen
            # SM3 message's slot on the order of ranks: 50 launches
            reps = 50 if lib_name in ("merkle", "sm3") else 1
            n = sum(mism(launcher(libs[c, lib_name])()) for _ in range(reps))
            bad += n
            log(f"[probe {c}] {case}: mismatched lanes {n}"
                + (f" (in {reps} launches)" if reps > 1 else ""))
    # device time (the profiler's, L2 evicted before each call: a one-lane
    # launch is shorter than the host's launch through Python)
    fixed = {c: {} for c in names}
    by_launch = {c: {} for c in names}  # device ms of each launch of a call
    events = {c: {} for c in names}  # CUDA-event ms a call, the host's launches included
    for rep in range(2):  # copies in turns, twice
        for c in names:
            for lib_name, case, launcher, kname, _ in timed:
                lib = libs[c, lib_name]
                kn = kname(lib)
                kn, per = (kn, 1) if isinstance(kn, str) else kn
                fixed[c].setdefault(case, []).append(
                    cs.kernel_device_ms(launcher(lib), kn, per_call=per))
                if per > 1:
                    ev = sorted(cs.LAST_EVENTS[kn])
                    by_launch[c].setdefault(case, []).append(
                        [float(np.mean([e[2] for e in ev[k::per]])) / 1e3 for k in range(per)])
                if lib_name in ("merkle", "sm3"):
                    events[c].setdefault(case, []).append(cs.cuda_ms(launcher(lib), 20))
                log(f"[turn {rep} {c}] {case}: device ms {fixed[c][case][-1]:.4f}")
    for c in names:
        for case, ms in fixed[c].items():
            log(f"[time {c}] {case}: device ms {', '.join(f'{m:.4f}' for m in ms)}")
            for ls in by_launch[c].get(case, []):
                log(f"[time {c}] {case}: device ms by launch (level) "
                    f"{', '.join(f'{m:.4f}' for m in ls)}")
            if case in events[c]:
                log(f"[time {c}] {case}: ms a call by CUDA events "
                    f"{', '.join(f'{m:.4f}' for m in events[c][case])}")
    if "merkle" in kernels:  # the chain floor at the card's clock under load
        big = next(launcher for lib_name, case, launcher, _, _ in timed
                   if case == f"merkle keccak256 n={MERKLE_NS[0]}")
        mhz = sm_clock_under(big(libs[names[-1], "merkle"]))
        levels = merkle_levels(MERKLE_NS[0])
        for c in names:
            for alg, steps in MERKLE_STEPS.items():
                sass = step_sass.get((c, alg))
                if sass:
                    log(f"[chain {c}] merkle {alg} n={MERKLE_NS[0]}: {levels} levels x {steps} "
                        f"steps x {sass} SASS instructions / {mhz:.0f} MHz = chain floor "
                        f"{levels * steps * sass / (mhz * 1e3):.4f} ms")
    sweep = {c: {} for c in names}
    for rep in range(2):  # copies in turns, twice
        for c in names:
            for lib_name, kern, launcher, _ in cases:
                sweep[c].setdefault(kern, []).append(
                    cs.lane_sweep(lambda k: launcher(libs[c, lib_name], k)))
    for c in names:
        for kern, runs in sweep[c].items():
            for B in cs.SWEEP_B:
                ms = [r[B] for r in runs]
                log(f"[sweep {c}] {kern} B={B}: ms {', '.join(f'{m:.3f}' for m in ms)}; "
                    f"ns a lane {min(ms) * 1e6 / B:.1f}")

    if bad:
        log(f"[probe] FAILED: {bad} mismatched lanes")
        return 1
    log("[probe] ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
