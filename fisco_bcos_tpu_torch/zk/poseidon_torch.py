"""Batched Poseidon on the port's lane-major limb substrate (ops/fp.py).

Counterpart of fisco_bcos_tpu/zk/poseidon_jax.py, bit-identical to the
oracle `zk.poseidon` at every padding bucket. The field is
`fp.MontField(P, kernels=True)`: on the card every multiply launches one
of the standalone kernels of csrc/fp.cu (ops/cuda_fp.py) by shape, as the
JAX field launches pallas_fp on a TPU; on the CPU the same products run
their plain version. The round adds stay plain PyTorch, as they stay XLA
ops outside any Pallas kernel in the JAX package.

Per chunk (any bucket), as in the JAX path:

  * inputs arrive as raw 32-byte big-endian values; `to_rep` maps any
    x < 2^256 to the canonical Montgomery form of x mod P in one product
    against R^2 (a [2, 16, B] stack: one `mul_stacked`, K = 2);
  * the state stays in the Montgomery domain over all 65 rounds (4 full,
    57 partial, 4 full; constants and MDS pre-encoded); a full round's
    S-box is three K = 3 stacked products, a partial round's three 2-D
    products of the first row, and every round's MDS one K = 9 stacked
    product plus exact-limb row adds;
  * one `from_rep` of the digest row (a product against a [16, 1]
    column: one `mul_const`).

So one chunk launches 57 x 3 = 171 `mul`, 8 x (3 + 1) + 57 + 1 = 90
`mul_stacked` and 1 `mul_const` (LAUNCHES_PER_CHUNK), 831 lane products
per pair. Padded lanes run the permutation on zero states and are sliced
off before returning.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from ..ops import fp
from . import poseidon as ref

NLIMBS = fp.NLIMBS
# padding buckets and the chunk, as the JAX path's
BUCKETS = (128, 512, 4096, 16384, 65536)
CHUNK = 65536
LAUNCHES_PER_CHUNK = {"mul": ref.R_P * 3,
                      "mul_stacked": ref.R_F * (3 + 1) + ref.R_P + 1,
                      "mul_const": 1}


_FIELDS: dict[bool, fp.MontField] = {}


def field(kernels: bool = True) -> fp.MontField:
    """The BN254 scalar field on the limb substrate; kernels=False gives
    the same field whose products always run their plain version (the
    plain path chip_smoke.py holds the kernels' path to on the card)."""
    f = _FIELDS.get(kernels)
    if f is None:
        f = _FIELDS[kernels] = fp.MontField(ref.P, "bn254r", kernels=kernels)
    return f


@functools.lru_cache(maxsize=None)
def _consts() -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Montgomery-encoded schedule: (rc_begin [R_f, T, L, 1],
    rc_partial [R_P, T, L, 1], rc_end [R_f, T, L, 1], mds [T, T, L, 1])."""
    f = field()
    rc, mds = ref.params()
    enc = np.stack([f.encode_int(v) for v in rc]).reshape(
        ref.R_F + ref.R_P, ref.T, NLIMBS, 1)
    half = ref.R_F // 2
    mds_enc = np.stack(
        [f.encode_int(v) for row in mds for v in row]).reshape(
        ref.T, ref.T, NLIMBS, 1)
    return (enc[:half], enc[half:half + ref.R_P], enc[half + ref.R_P:],
            mds_enc)


_DEVICE_CONSTS: dict = {}


def _consts_on(device: torch.device) -> tuple[torch.Tensor, ...]:
    """_consts() as int64 tensors on `device`, copied there once."""
    c = _DEVICE_CONSTS.get(device)
    if c is None:
        c = _DEVICE_CONSTS[device] = tuple(
            torch.as_tensor(a.astype(np.int64), device=device) for a in _consts())
    return c


def _bucket(n: int) -> int:
    for b in BUCKETS:
        if n <= b:
            return b
    raise AssertionError(f"chunking bounds n <= {CHUNK}, got {n}")


def _x5(f: fp.MontField, s):
    return f.mul(f.sqr(f.sqr(s)), s)


def _mds_mul(f: fp.MontField, mds_c, s):
    """state [T, L, B] -> MDS @ state, rows reduced with exact-limb adds."""
    prods = f.mul(mds_c, s[None].expand(mds_c.shape[:1] + s.shape))
    out = prods[:, 0]
    for j in range(1, ref.T):
        out = f.add(out, prods[:, j])
    return out


def _permute_mont(f: fp.MontField, states):
    """Montgomery-domain permutation of [T, NLIMBS, B]."""
    rc_begin, rc_partial, rc_end, mds = _consts_on(states.device)
    s = states
    for rc in rc_begin:
        s = _mds_mul(f, mds, _x5(f, f.add(s, rc)))
    for rc in rc_partial:
        s = f.add(s, rc)
        s = torch.cat([_x5(f, s[0])[None], s[1:]], dim=0)
        s = _mds_mul(f, mds, s)
    for rc in rc_end:
        s = _mds_mul(f, mds, _x5(f, f.add(s, rc)))
    return s


def _hash2(f: fp.MontField, inputs):
    """[2, NLIMBS, B] raw (non-Montgomery) inputs -> [NLIMBS, B] digest
    row: to_rep canonicalizes (x mod P included), the capacity row starts
    at Montgomery zero."""
    rate = f.to_rep(inputs)
    cap = torch.zeros_like(rate[0])[None]
    out = _permute_mont(f, torch.cat([cap, rate], dim=0))
    return f.from_rep(out[0])


# -- byte <-> limb plumbing (vectorized, no Python bigints) ------------------

_LO_IDX = 31 - 2 * np.arange(NLIMBS)
_HI_IDX = 30 - 2 * np.arange(NLIMBS)


def bytes_to_limbs(vals: Sequence[bytes]) -> np.ndarray:
    """32-byte big-endian values -> lane-major uint32[NLIMBS, B]."""
    arr = np.frombuffer(b"".join(vals), dtype=np.uint8).reshape(-1, 32)
    return ((arr[:, _HI_IDX].astype(np.uint32) << 8)
            | arr[:, _LO_IDX]).T.copy()


def limbs_to_bytes(limbs: np.ndarray) -> list[bytes]:
    """[NLIMBS, B] limbs -> list of 32-byte big-endian values."""
    b = limbs.shape[-1]
    arr = np.zeros((b, 32), np.uint8)
    arr[:, _LO_IDX] = (limbs & 0xFF).T
    arr[:, _HI_IDX] = (limbs >> 8).T
    flat = arr.tobytes()
    return [flat[i * 32:(i + 1) * 32] for i in range(b)]


def hash2_batch(lefts: Sequence[bytes], rights: Sequence[bytes],
                device: str | torch.device = "cuda",
                plain: bool = False) -> list[bytes]:
    """Batched H(l, r) (zk.poseidon.hash2_bytes semantics) on `device`,
    padded to the bucket grid and cut into CHUNK-sized calls. On "cuda"
    the products launch the fp kernels; plain=True runs their plain
    versions wherever the tensors lie."""
    n = len(lefts)
    if len(rights) != n:
        raise ValueError("hash2_batch: lefts and rights differ in length")
    if n == 0:
        return []
    f = field(kernels=not plain)
    device = torch.device(device)
    out: list[bytes] = []
    for off in range(0, n, CHUNK):
        ln = min(CHUNK, n - off)
        b = _bucket(ln)
        limbs = np.zeros((2, NLIMBS, b), np.int64)
        limbs[0, :, :ln] = bytes_to_limbs(lefts[off:off + ln])
        limbs[1, :, :ln] = bytes_to_limbs(rights[off:off + ln])
        digest = _hash2(f, torch.as_tensor(limbs, device=device))
        out.extend(limbs_to_bytes(digest[:, :ln].cpu().numpy()))
    return out
