"""Wrapper of kernel H: the standalone double-scalar ladder.

Source: `csrc/ladder.cu` (with `point.cuh`, `ec.cuh`, `field.cuh`,
`sm2.cuh`, `bigint.cuh` and `lanes.cuh`). It replaces `ladder` of
fisco_bcos_tpu/ops/pallas_ec.py, the one launch of the composed EC route's
double-scalar multiply (ops/ec.py `ladder`). Its plain version is
`ops.ec.ladder_plain`.

The wrapper takes the TPU kernel's operands on one CUDA device, launches
once on the current stream and counts the launch in its `launches`
attribute. It raises on anything the kernel does not take (a curve other
than secp256k1 or SM2, a shape, dtype or layout off the contract) and on a
launch error; it never falls back.
"""

from __future__ import annotations

import torch

from . import _cuda
from .bigint import NLIMBS
from ..crypto import refimpl

I64, I32 = torch.int64, torch.int32
CURVES = {refimpl.SECP256K1: 0, refimpl.SM2P256V1: 1}  # ladder.cu's `curve`
MAX_PAIRS = 2


def ladder(cv, nsteps: int, gts, digs, negs, q_planes):
    """k1*G + k2*Q on curve cv: gts [n_pairs, 16, 32] int64 constant
    affine G tables (field rep), digs [2 n_pairs, nsteps, B] int32 MSB-first
    4-bit digits (rows [g, q] per pair), negs [2 n_pairs, B] int32 sign
    flags, q_planes [n_pairs, 2, 16, B] int64 affine Q planes (field rep)
    -> packed Jacobian [3, 16, B] int64 in field rep."""
    curve = CURVES.get(cv.params)
    if curve is None:
        raise ValueError(f"ladder: no kernel for {cv}")
    _cuda.require(q_planes, "q_planes", I64, (None, 2, NLIMBS, None))
    n_pairs, _, _, B = q_planes.shape
    if not 1 <= n_pairs <= MAX_PAIRS:
        raise ValueError(f"ladder: {n_pairs} pairs, the kernel takes 1 or 2")
    if not 1 <= nsteps <= 64:
        raise ValueError(f"ladder: {nsteps} steps, the kernel takes 1..64")
    dev = q_planes.device
    _cuda.require(gts, "gts", I64, (n_pairs, 16, 2 * NLIMBS), dev)
    _cuda.require(digs, "digs", I32, (2 * n_pairs, nsteps, B), dev)
    _cuda.require(negs, "negs", I32, (2 * n_pairs, B), dev)
    out = torch.empty((3, NLIMBS, B), dtype=I64, device=dev)
    if B:
        lib = _cuda.library("ladder", dev)
        rc = lib.ladder_launch(_cuda.ptr(gts), _cuda.ptr(digs), _cuda.ptr(negs),
                               _cuda.ptr(q_planes), _cuda.ptr(out), curve, n_pairs,
                               nsteps, B, _cuda.stream_ptr(q_planes))
        _cuda.check(lib, rc, "ladder")
        ladder.launches += 1
    return out


ladder.launches = 0
