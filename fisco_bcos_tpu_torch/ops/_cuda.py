"""Build and load the port's CUDA kernels (plain C interface over ctypes).

Each source `csrc/<name>.cu` compiles with `nvcc` for `sm_90a` into its own
shared library under `fisco_bcos_tpu_torch/_build/`, named by a hash of the
sources so a stale build is never loaded. Nothing is built or loaded when
this module is imported: `library(name, device)` builds on first use and
sets the library's constant block on `device` from `ops/consts.py`, and
`build_all()` starts one `nvcc` per source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
SOURCES = ("verify", "keccak", "merkle", "sm3", "sm2", "fp", "ladder")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# the C interface of every source: function -> argument types (all return
# an int, a CUDA error code but for merkle_tree_scratch_words); every
# source also has set_consts(words, n)
SIGNATURES = {
    "verify": {
        "ecdsa_recover_launch": [_P] * 8 + [_I, _P],
        "ecdsa_verify_launch": [_P] * 7 + [_I, _P],
    },
    "keccak": {"keccak256_varlen_launch": [_P, _P, _P, _I, _I, _P]},
    "merkle": {"merkle_keccak_tree_launch": [_P, _I, _I, _P, _I, _P, _P],
               "merkle_sm3_tree_launch": [_P, _I, _I, _P, _I, _P, _P],
               "merkle_tree_scratch_words": [_I]},
    "sm3": {"sm3_varlen_launch": [_P, _P, _P, _I, _I, _P]},
    "sm2": {"sm2_verify_launch": [_P] * 7 + [_I, _P]},
    "fp": {"fp_mul_launch": [_P] * 4 + [_I, _P],
           "fp_mul_const_launch": [_P] * 4 + [_I, _P],
           "fp_mul_stacked_launch": [_P] * 4 + [_I, _I, _P],
           "fp_pow_launch": [_P] * 5 + [_I, _I, _P],
           "fp_pow_inv_launch": [_P] * 4 + [_I, _P],
           "fp_pow_sqrt_launch": [_P] * 2 + [_I, _P]},
    "ladder": {"ladder_launch": [_P] * 5 + [_I, _I, _I, _I, _P]},
}
# which blocks of consts.kernel_words() each source's set_consts takes,
# concatenated in this order
CONST_BLOCK = {"verify": ("verify",), "keccak": ("keccak",),
               "merkle": ("keccak", "sm3", "sm3_pad"), "sm3": ("sm3",), "sm2": ("sm2",),
               "fp": ("verify",), "ladder": ("verify", "sm2")}

_LIBS: dict[str, ctypes.CDLL] = {}
_CONSTS_SET: set[tuple[str, int]] = set()
PTXAS_LOG: dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; -> (Popen, temp path, final path) or None
    when the library is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    PTXAS_LOG[name] = log
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names=SOURCES) -> float:
    """Build every named source in parallel; -> wall seconds."""
    t0 = time.perf_counter()
    started = {n: _start(n) for n in names}
    for n, s in started.items():
        if s is not None:
            _finish(n, s)
    return time.perf_counter() - t0


def library(name: str, device: torch.device) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use, with its
    constant block set on `device` (once per device)."""
    lib = _LIBS.get(name)
    if lib is None:
        started = _start(name)
        if started is not None:
            _finish(name, started)
        lib = ctypes.CDLL(str(_lib_path(name)))
        lib.cuda_error_string.restype = ctypes.c_char_p
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        for fn, argtypes in {**SIGNATURES[name], "set_consts": [_P, _I]}.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    key = (name, device.index)
    if key not in _CONSTS_SET:
        from .consts import derive_consts, kernel_words

        blocks = kernel_words(derive_consts())
        words = np.ascontiguousarray(
            np.concatenate([blocks[b] for b in CONST_BLOCK[name]]), dtype=np.uint32)
        with torch.cuda.device(device):
            rc = lib.set_consts(words.ctypes.data_as(ctypes.c_void_p), words.size)
        check(lib, rc, f"{name} set_consts")
        _CONSTS_SET.add(key)
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch reported a CUDA error (cudaGetLastError)."""
    if rc != 0:
        msg = lib.cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def stream_ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
            device: torch.device | None = None) -> None:
    """Check a kernel argument: CUDA, dtype, shape (None = any), contiguous."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if len(shape) != t.dim() or any(s is not None and s != d
                                    for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def require_aligned(t: torch.Tensor, name: str, align: int = 16) -> None:
    """Kernels that load 16 bytes at a time need 16-byte aligned rows."""
    if t.data_ptr() % align:
        raise ValueError(f"{name}: expected a {align}-byte aligned tensor")
