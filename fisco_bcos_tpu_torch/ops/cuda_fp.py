"""Wrappers of kernels D, E and F, the standalone field multiplies, and of
kernel G, the fixed-exponent power.

Source: `csrc/fp.cu` (with `field.cuh` and `bigint.cuh`). They replace
`mul`, `mul_const`, `mul_stacked` and `pow_const` of
fisco_bcos_tpu/ops/pallas_fp.py and are reached through
`ops/fp._FieldBase.mul` and `pow_const` on a field built with
`kernels=True`. Their plain versions are the field's `mul_plain` and the
`pow_const` window loop of a field built without kernels.

`pow_const` picks kernel G's mode for the whole launch from the exponent
(`pow_mode`): the safegcd inverse for e = m - 2, secp256k1's square-root
chain for e = (p + 1) / 4, the window loop for any other e; each mode
returns the window loop's limbs.

Each wrapper takes the field and int64 lane-major operands of 16-bit limbs
on one CUDA device (the plain field layer's dtype, so a Poseidon round
converts nothing between its adds and its products), launches once on the
current stream and counts the launch in its `launches` attribute. It
raises on anything the kernel does not take and on a launch error; it
never falls back. A Montgomery field of any odd modulus is passed per
call; of the Solinas fields only secp256k1's p has a kernel (the fold of
`csrc/field.cuh`).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _cuda
from .bigint import NLIMBS
from .consts import modinv30_words
from .fp import msb_digits

I64 = torch.int64
SECP256K1_C = (1 << 32) + 977  # 2^256 - p of the one Solinas field with a kernel
_WORDS: dict = {}


def np0(n: int) -> int:
    """-n^-1 mod 2^32, the one Montgomery word CIOS needs (n odd)."""
    return -pow(n, -1, 1 << 32) % (1 << 32)


def _field_words(field) -> np.ndarray:
    """The kernels' field argument as host words: n[0..7], np0, solinas."""
    key = (type(field).__name__, field.n_int)
    w = _WORDS.get(key)
    if w is None:
        c = getattr(field, "c_int", None)
        if c is not None and c != SECP256K1_C:
            raise ValueError(f"{field}: the fp kernels' Solinas fold is "
                             "secp256k1's (2^256 - p = 2^32 + 977)")
        n = field.n_int
        w = np.array([(n >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
                     + [0 if c is not None else np0(n), int(c is not None)],
                     dtype=np.uint32)
        _WORDS[key] = w
    return w


def _launch(fn_name: str, field, *tensors, host=(), dims):
    """One launch: the tensors' pointers, then the host arrays' (`host`),
    the field words, `dims` and the stream (the C signatures of
    csrc/fp.cu)."""
    words = _field_words(field)
    lib = _cuda.library("fp", tensors[0].device)
    rc = getattr(lib, fn_name)(*(_cuda.ptr(t) for t in tensors),
                               *(h.ctypes.data_as(ctypes.c_void_p) for h in host),
                               words.ctypes.data_as(ctypes.c_void_p),
                               *dims, _cuda.stream_ptr(tensors[0]))
    _cuda.check(lib, rc, fn_name)


def mul(field, a, b):
    """a * b of two [16, B] int64 operands -> [16, B] int64."""
    _cuda.require(a, "a", I64, (NLIMBS, None))
    B = a.shape[1]
    _cuda.require(b, "b", I64, (NLIMBS, B), a.device)
    out = torch.empty_like(a)
    if B:
        _launch("fp_mul_launch", field, a, b, out, dims=(B,))
        mul.launches += 1
    return out


mul.launches = 0


def mul_const(field, a, c):
    """a [16, B] times one column c [16, 1], both int64 -> [16, B] int64."""
    _cuda.require(a, "a", I64, (NLIMBS, None))
    _cuda.require(c, "c", I64, (NLIMBS, 1), a.device)
    out = torch.empty_like(a)
    if a.shape[1]:
        _launch("fp_mul_const_launch", field, a, c, out, dims=(a.shape[1],))
        mul_const.launches += 1
    return out


mul_const.launches = 0


def mul_stacked(field, a, b):
    """K stacked products of [K, 16, B] int64 operands -> [K, 16, B]."""
    _cuda.require(a, "a", I64, (None, NLIMBS, None))
    K, _, B = a.shape
    _cuda.require(b, "b", I64, (K, NLIMBS, B), a.device)
    if K > 65535:
        raise ValueError(f"mul_stacked: K={K} exceeds the grid's y extent")
    out = torch.empty_like(a)
    if K and B:
        _launch("fp_mul_stacked_launch", field, a, b, out, dims=(K, B))
        mul_stacked.launches += 1
    return out


mul_stacked.launches = 0


MAX_POW_DIGITS = 64  # the kernel's digit array: exponents below 2^256


def _words(limbs) -> np.ndarray:
    """16 little-endian 16-bit limbs -> 8 uint32 words."""
    v = np.asarray(limbs).astype(np.uint32)
    return np.ascontiguousarray(v[0::2] | (v[1::2] << 16), dtype=np.uint32)


# kernel G's modes (csrc/pow.cuh)
INVERSE, SQRT, WINDOW = "inverse", "sqrt", "window"


@functools.cache
def _prime_moduli() -> frozenset:
    """The moduli of the five fields the kernels serve, all prime:
    secp256k1's p and n, SM2's p and n, and BN254's r (Poseidon's)."""
    from ..crypto import refimpl
    from ..zk import poseidon

    c, s = refimpl.SECP256K1, refimpl.SM2P256V1
    return frozenset((c.p, c.n, s.p, s.n, poseidon.P))


def pow_mode(field, e: int) -> str:
    """Kernel G's mode for a^e on `field`: INVERSE for e = m - 2 where m
    is one of the kernels' prime moduli (`_prime_moduli`; a^(m - 2) is an
    inverse only for a prime m), SQRT for e = (p + 1) / 4 on secp256k1's
    p, WINDOW for every other exponent."""
    m = field.n_int
    if e == m - 2 and m in _prime_moduli():
        return INVERSE
    if getattr(field, "c_int", None) == SECP256K1_C and e == (m + 1) // 4:
        return SQRT
    return WINDOW


def _inv_words(field) -> np.ndarray:
    """The inverse mode's host words: struct ModInv30 of the modulus (9
    limbs of 30 bits, m^-1 mod 2^30), then R^3 mod m (R = 2^256) as 8 words
    for a Montgomery field's domain fix-up (zeros for the Solinas field's
    plain domain, which needs none)."""
    key = ("inv", type(field).__name__, field.n_int)
    w = _WORDS.get(key)
    if w is None:
        m = field.n_int
        r3 = 0 if getattr(field, "c_int", None) is not None else pow(1 << 256, 3, m)
        w = np.array(modinv30_words(m) + [(r3 >> (32 * i)) & 0xFFFFFFFF for i in range(8)],
                     dtype=np.uint32)
        _WORDS[key] = w
    return w


def pow_const(field, a, e: int):
    """a^e of a [16, B] int64 operand in the field's domain -> [16, B]
    int64, for a static 0 < e < 2^256, in the mode `pow_mode` picks: the
    inverse takes the modulus's ModInv30 words and R^3 mod m
    (`_inv_words`), the square root nothing, the window loop the
    exponent's 4-bit MSB-first digits (`fp.msb_digits`) and the field's
    one. One launch, counted once, whatever the mode."""
    _cuda.require(a, "a", I64, (NLIMBS, None))
    if not 0 < e < 1 << (4 * MAX_POW_DIGITS):
        raise ValueError(f"pow_const: exponent out of range (0, 2^256): {e}")
    mode = pow_mode(field, e)
    out = torch.empty_like(a)
    B = a.shape[1]
    if B:
        if mode == INVERSE:
            _launch("fp_pow_inv_launch", field, a, out, host=(_inv_words(field),), dims=(B,))
        elif mode == SQRT:
            lib = _cuda.library("fp", a.device)
            rc = lib.fp_pow_sqrt_launch(_cuda.ptr(a), _cuda.ptr(out), B, _cuda.stream_ptr(a))
            _cuda.check(lib, rc, "fp_pow_sqrt_launch")
        else:
            digits = np.ascontiguousarray(msb_digits(e, 4), dtype=np.uint8)
            one = _words(field.encode_int(1))
            _launch("fp_pow_launch", field, a, out, host=(digits, one), dims=(len(digits), B))
        pow_const.launches += 1
    return out


pow_const.launches = 0
