"""Wrappers of kernels 1, 2 and C: whole secp256k1 recovery and verify,
and whole SM2 verify.

Sources: `csrc/verify.cu` (secp256k1 kernels), `csrc/ecdsa.cuh`
(per-signature bodies), `csrc/ec.cuh` (GLV ladder), `csrc/field.cuh`
(secp256k1 field); `csrc/sm2.cu` and `csrc/sm2.cuh` (SM2); `point.cuh`,
`bigint.cuh` and `lanes.cuh` shared. They replace `ecdsa_recover_fused`,
`ecdsa_verify_fused` and `sm2_verify_fused` of
fisco_bcos_tpu/ops/pallas_verify.py. The plain versions are
`ops.ec.ecdsa_recover_plain` / `ecdsa_verify_plain` / `sm2_verify_plain`.

Each wrapper takes lane-major `[16, B]` columns of 16-bit limbs on one CUDA
device, launches once on the current stream and counts the launch in its
`launches` attribute. It raises on anything the kernel does not take and
on a launch error; it never falls back.
"""

from __future__ import annotations

import torch

from . import _cuda
from .bigint import NLIMBS

_GTAB: dict = {}


def _gtab(device: torch.device, name: str = "gtab") -> torch.Tensor:
    """A constant window-table block on `device`: "gtab" the [2, 16, 32]
    int32 G and phi(G) tables of secp256k1, "sm2_gtab" SM2's [16, 32] G
    table."""
    t = _GTAB.get((device, name))
    if t is None:
        from .consts import derive_consts

        t = _GTAB[device, name] = derive_consts()[name].to(device).contiguous()
    return t


def _limb_args(args, names):
    out = []
    for a, n in zip(args, names):
        a = a.to(torch.int32).contiguous()
        _cuda.require(a, n, torch.int32, (NLIMBS, None), args[0].device)
        out.append(a)
    return out


def ecdsa_recover(e, r, s, v):
    """e, r, s: [16, B] limbs; v: [B] recovery ids -> (qx, qy [16, B]
    int32, ok [B] int32). qx = qy = 0 where ok is 0."""
    e, r, s = _limb_args((e, r, s), ("e", "r", "s"))
    B = e.shape[1]
    v = v.to(device=e.device, dtype=torch.int32).contiguous()
    _cuda.require(v, "v", torch.int32, (B,), e.device)
    qx = torch.empty((NLIMBS, B), dtype=torch.int32, device=e.device)
    qy = torch.empty_like(qx)
    ok = torch.empty((B,), dtype=torch.int32, device=e.device)
    if B == 0:
        return qx, qy, ok
    lib = _cuda.library("verify", e.device)
    rc = lib.ecdsa_recover_launch(
        _cuda.ptr(e), _cuda.ptr(r), _cuda.ptr(s), _cuda.ptr(v),
        _cuda.ptr(_gtab(e.device)), _cuda.ptr(qx), _cuda.ptr(qy),
        _cuda.ptr(ok), B, _cuda.stream_ptr(e))
    _cuda.check(lib, rc, "ecdsa_recover")
    ecdsa_recover.launches += 1
    return qx, qy, ok


ecdsa_recover.launches = 0


def ecdsa_verify(e, r, s, qx, qy):
    """e, r, s, qx, qy: [16, B] limbs -> ok [B] int32."""
    e, r, s, qx, qy = _limb_args((e, r, s, qx, qy),
                                 ("e", "r", "s", "qx", "qy"))
    B = e.shape[1]
    ok = torch.empty((B,), dtype=torch.int32, device=e.device)
    if B == 0:
        return ok
    lib = _cuda.library("verify", e.device)
    rc = lib.ecdsa_verify_launch(
        _cuda.ptr(e), _cuda.ptr(r), _cuda.ptr(s), _cuda.ptr(qx),
        _cuda.ptr(qy), _cuda.ptr(_gtab(e.device)), _cuda.ptr(ok), B,
        _cuda.stream_ptr(e))
    _cuda.check(lib, rc, "ecdsa_verify")
    ecdsa_verify.launches += 1
    return ok


ecdsa_verify.launches = 0


def sm2_verify(e, r, s, qx, qy):
    """SM2 verify. e, r, s, qx, qy: [16, B] limbs -> ok [B] int32."""
    e, r, s, qx, qy = _limb_args((e, r, s, qx, qy),
                                 ("e", "r", "s", "qx", "qy"))
    B = e.shape[1]
    ok = torch.empty((B,), dtype=torch.int32, device=e.device)
    if B == 0:
        return ok
    lib = _cuda.library("sm2", e.device)
    rc = lib.sm2_verify_launch(
        _cuda.ptr(e), _cuda.ptr(r), _cuda.ptr(s), _cuda.ptr(qx),
        _cuda.ptr(qy), _cuda.ptr(_gtab(e.device, "sm2_gtab")), _cuda.ptr(ok), B,
        _cuda.stream_ptr(e))
    _cuda.check(lib, rc, "sm2_verify")
    sm2_verify.launches += 1
    return ok


sm2_verify.launches = 0
