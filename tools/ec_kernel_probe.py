#!/usr/bin/env python3
"""Probe the port's EC kernels (csrc/ladder.cu, csrc/sm2.cu and the
secp256k1 recover and verify kernels of csrc/verify.cu) on one NVIDIA
card, for one or more copies of their sources.

    python3 tools/ec_kernel_probe.py [--out DIR] [--kernels K,...] [COPY ...]

A COPY is a copy of csrc/ or a tree that holds fisco_bcos_tpu_torch/csrc/
(for example an unpacked `git archive` of an older commit). With none it
probes the port's own fisco_bcos_tpu_torch/csrc/. Several copies (at
different steps of a change) are built in parallel and measured in one
process on one card, in turns, so that their times compare. K is any of
ladder, sm2, verify (default all). For each copy it prints:

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
  inversion-stress lanes of chip_smoke.ecdsa_cases).

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



def log(*a):
    print(*a, flush=True)


KERNELS = ("ladder", "sm2", "verify")


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
            if name == "probe_mul":
                src = out / "probe_mul.cu"
                src.write_text(PROBE_SRC)
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
    for fn, argtypes in {**_cuda.SIGNATURES[name], "set_consts": [_cuda._P, _cuda._I]}.items():
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
    todo = {c: (d, list(kernels) + (["probe_mul"] if {"ladder", "sm2"} & set(kernels) else []))
            for c, (d, _) in zip(names, copies)}
    dev = torch.device("cuda")
    log(f"[probe] {cs.phase_card_line()}")
    t0 = time.perf_counter()
    built = build(todo)
    sass_out.mkdir(parents=True, exist_ok=True)
    log(f"[probe] {len(built)} builds in parallel: {time.perf_counter() - t0:.1f} s")
    for (copy, name), (lib, text) in sorted(built.items()):
        for fn, info in cs.ptxas_summary(text).items():
            log(f"[ptxas {copy}/{name}] {fn}: {info}")
        dump = sass_out / f"{copy}_{name}.sass" if name == "probe_mul" else None
        for fn, c in cs.sass_counts(lib, dump).items():
            log(f"[sass {copy}/{name}] {fn}: {c}")

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

    # -- every copy: bit-exact, then the sweep, copies in turns ---------------
    words = {c: const_words(t, kernels) for c, (_, t) in zip(names, copies)}
    libs = {(c, k): load(built[c, k][0], k, dev, words[c][k]) for c in names for k in kernels}
    bad = 0
    for c in names:
        for lib_name, kern, launcher, mism in cases:
            n = mism(launcher(libs[c, lib_name], 1)())
            bad += n
            log(f"[probe {c}] {kern}: mismatched lanes {n} of {cs.EC_B}")
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
