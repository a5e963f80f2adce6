"""Wrappers of kernels D, E and F, the standalone field multiplies, and of
kernel G, the fixed-exponent power.

Source: `csrc/fp.cu` (with `field.cuh` and `bigint.cuh`). They replace
`mul`, `mul_const`, `mul_stacked` and `pow_const` of
fisco_bcos_tpu/ops/pallas_fp.py and are reached through
`ops/fp._FieldBase.mul` and `pow_const` on a field built with
`kernels=True`. Their plain versions are the field's `mul_plain` and the
`pow_const` window loop of a field built without kernels.

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

import numpy as np
import torch

from . import _cuda
from .bigint import NLIMBS
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


def pow_const(field, a, e: int):
    """a^e of a [16, B] int64 operand in the field's domain -> [16, B]
    int64, for a static 0 < e < 2^256. The exponent goes to the launch as
    its 4-bit MSB-first digits (`fp.msb_digits`), with the field's one."""
    _cuda.require(a, "a", I64, (NLIMBS, None))
    if not 0 < e < 1 << (4 * MAX_POW_DIGITS):
        raise ValueError(f"pow_const: exponent out of range (0, 2^256): {e}")
    digits = np.ascontiguousarray(msb_digits(e, 4), dtype=np.uint8)
    one = _words(field.encode_int(1))
    out = torch.empty_like(a)
    if a.shape[1]:
        _launch("fp_pow_launch", field, a, out, host=(digits, one),
                dims=(len(digits), a.shape[1]))
        pow_const.launches += 1
    return out


pow_const.launches = 0
