#!/usr/bin/env python3
"""Probe the port's EC ladder and SM2 verify kernels (csrc/ladder.cu,
csrc/sm2.cu) on one NVIDIA card, for one or more copies of their sources.

    python3 tools/ec_kernel_probe.py [--out DIR] [CSRC_DIR ...]

With no directory it probes the port's own fisco_bcos_tpu_torch/csrc/.
Several directories (copies of csrc/ at different steps of a change) are
built in parallel and measured in one process on one card, in turns, so
that their times compare. For each copy it prints:

- ptxas registers and stack of each kernel, and the static SASS counts of
  each function (instructions, LDL, STL, CALL, BRA; cuobjdump -sass);
- the SASS instructions of one field product, from a one-product kernel
  per field (`probe_*_mul`);
- a lane sweep: ms and ns per lane of the ladder (GLV form on secp256k1,
  plain form on SM2) and of SM2 verify at B = 16,384, 65,536 and 131,072
  lanes, the 16,384-lane inputs tiled;
- mismatches at B = 16,384 against the plain versions (computed once on
  the card): the ladder on chip_smoke.py's lanes (edge, carry-stress and
  flipped-sign lanes), SM2 verify on its 1% adversarial and carry-stress
  lanes.

Builds go to fisco_bcos_tpu_torch/_build/probe/<copy>/, the SASS text of
the one-product kernels to DIR (default: the same build directory).
Exits non-zero on a build failure or a mismatch.
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


def build(srcs: list[Path]) -> dict:
    """nvcc ladder.cu, sm2.cu and the one-product probe of every copy, all
    at once; -> {(copy, name): (library path, ptxas log)}."""
    from fisco_bcos_tpu_torch.ops import _cuda

    procs = {}
    for d in srcs:
        out = OUT / d.name
        out.mkdir(parents=True, exist_ok=True)
        (out / "probe_mul.cu").write_text(PROBE_SRC)
        for name, src in (("ladder", d / "ladder.cu"), ("sm2", d / "sm2.cu"),
                          ("probe_mul", out / "probe_mul.cu")):
            lib = out / f"lib{name}.so"
            cmd = [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-I", str(d), "-o", str(lib), str(src)]
            procs[d.name, name] = (lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for key, (lib, p) in procs.items():
        text, _ = p.communicate()
        if p.returncode:
            log(text)
            raise SystemExit(f"probe: nvcc failed for {key}")
        built[key] = (lib, text)
    return built


def load(lib_path: Path, name: str, dev) -> ctypes.CDLL:
    """A copy's library with its constant block set, as ops/_cuda.library
    loads the port's own."""
    from fisco_bcos_tpu_torch.ops import _cuda
    from fisco_bcos_tpu_torch.ops.consts import derive_consts, kernel_words

    lib = ctypes.CDLL(str(lib_path))
    lib.cuda_error_string.restype = ctypes.c_char_p
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    for fn, argtypes in {**_cuda.SIGNATURES[name], "set_consts": [_cuda._P, _cuda._I]}.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    blocks = kernel_words(derive_consts())
    rc = 0
    # a copy from before the secp_mont block takes the blocks without it
    for names in (_cuda.CONST_BLOCK[name],
                  [b for b in _cuda.CONST_BLOCK[name] if b != "secp_mont"]):
        words = np.ascontiguousarray(np.concatenate([blocks[b] for b in names]), dtype=np.uint32)
        with torch.cuda.device(dev):
            rc = lib.set_consts(words.ctypes.data_as(ctypes.c_void_p), words.size)
        if rc == 0:
            break
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
    sass_out = OUT
    if args[:1] == ["--out"]:
        sass_out, args = Path(args[1]).resolve(), args[2:]
    srcs = [Path(a).resolve() for a in args] or [ROOT / "fisco_bcos_tpu_torch" / "csrc"]
    names = [d.name for d in srcs]
    if len(set(names)) != len(names):
        raise SystemExit("probe: the source directories need distinct names")
    dev = torch.device("cuda")
    log(f"[probe] {cs.phase_card_line()}")
    t0 = time.perf_counter()
    built = build(srcs)
    sass_out.mkdir(parents=True, exist_ok=True)
    log(f"[probe] {len(built)} builds in parallel: {time.perf_counter() - t0:.1f} s")
    for (copy, name), (lib, text) in sorted(built.items()):
        for fn, info in cs.ptxas_summary(text).items():
            log(f"[ptxas {copy}/{name}] {fn}: {info}")
        dump = sass_out / f"{copy}_{name}.sass" if name == "probe_mul" else None
        for fn, c in cs.sass_counts(lib, dump).items():
            log(f"[sass {copy}/{name}] {fn}: {c}")

    # -- inputs at B = 16,384 and the plain versions, once --------------------
    rng = random.Random(cs.SEED)
    cases = {}
    for cv, curve in ((ec.SECP256K1, 0), (ec.SM2P256V1, 1)):
        (nsteps, gts, digs, negs, qp), _ = cs.ladder_case(
            cv, np.random.default_rng(cs.SEED + 6), dev)
        want, pms = cs.wall_ms(lambda: ec.ladder_plain(cv, nsteps, gts, digs, negs, qp))
        cases[cv.params.name] = (curve, nsteps, gts, digs, negs, qp, want)
        log(f"[probe] ladder {cv.params.name}: plain {pms:.0f} ms at B={cs.EC_B}")
    vs, _ = cs.sm2_inputs(rng, cs.EC_B)
    sm_args = [cs.lane([d[k] for d in vs], dev).to(torch.int32).contiguous()
               for k in ("e", "r", "s", "qx", "qy")]
    sm_want, pms = cs.wall_ms(lambda: ec.sm2_verify_plain(ec.SM2P256V1, *sm_args))
    log(f"[probe] sm2_verify: plain {pms:.0f} ms at B={cs.EC_B}, "
        f"{int(sm_want.sum())} valid lanes")
    gtab = cuda_verify._gtab(dev, "sm2_gtab")

    # -- every copy: bit-exact, then the sweep, copies in turns ---------------
    libs = {c: (load(built[c, "ladder"][0], "ladder", dev), load(built[c, "sm2"][0], "sm2", dev))
            for c in names}
    bad = 0
    for c in names:
        lad, sm2 = libs[c]
        for form, (curve, nsteps, gts, digs, negs, qp, want) in cases.items():
            got = ladder_call(lad, curve, nsteps, gts, digs, negs, qp)
            n = int((got != want).any(0).any(0).sum())
            bad += n
            log(f"[probe {c}] ladder {form}: mismatched lanes {n} of {cs.EC_B}")
        ok = sm2_call(sm2, gtab, sm_args)
        n = int((ok.bool() != sm_want).sum())
        bad += n
        log(f"[probe {c}] sm2_verify: mismatched lanes {n} of {cs.EC_B}")
    sweep = {c: {} for c in names}
    for rep in range(2):  # copies in turns, twice
        for c in names:
            lad, sm2 = libs[c]
            for form, case in cases.items():
                sweep[c].setdefault(f"ladder {form}", []).append(
                    cs.lane_sweep(ladder_tiles(lad, *case[:-1])))
            sweep[c].setdefault("sm2_verify", []).append(
                cs.lane_sweep(sm2_tiles(sm2, gtab, sm_args)))
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
