"""The crypto plane's constants ("weights"), in the port's tensor form.

A crypto system's weights are its constants: the G and phi(G) window
tables, the field constants (modulus limbs, Montgomery n', R^2, R), the
GLV split columns, the Keccak round constants, and the SM chain's SM2 G
table and field columns and SM3 IV and round constants. `derive_consts()` builds
them from the port's own `refimpl` copy; `consts_from_jax(np_dict)` turns
the JAX package's numpy arrays (same names, see `JAX_NAMES`) into the same
tensors, so a test can hold the two equal. They are the kernels' only copy:
the EC kernels take their G tables from `gtab` / `sm2_gtab` and every
other constant, like the hash kernels' round constants, from
`kernel_words`, which `ops/_cuda.py` writes into each module's constant
block.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import keccak, sm3

# name -> where the JAX package keeps it (fisco_bcos_tpu.ops...)
JAX_NAMES = {
    "g_table": "ec.SECP256K1.g_table",
    "g_table_endo": "ec.SECP256K1.g_table_endo",
    "p_limbs": "ec.SECP256K1.fp.limbs",
    "n_limbs": "ec.SECP256K1.fn.limbs",
    "nprime": "ec.SECP256K1.fn.nprime",
    "r2": "ec.SECP256K1.fn.r2",
    "one_m": "ec.SECP256K1.fn.one_m",
    "b_rep": "ec.SECP256K1.b_rep",
    "beta_rep": "ec.SECP256K1.beta_rep",
    "g1_limbs": "ec.SECP256K1.g1_limbs",
    "g2_limbs": "ec.SECP256K1.g2_limbs",
    "half_n_limbs": "ec.SECP256K1.half_n_limbs",
    "glv_consts": "pallas_verify._secp_consts()[0]",
    "keccak_rc_hi": "keccak._RC_HI",
    "keccak_rc_lo": "keccak._RC_LO",
    "sm2_g_table": "ec.SM2P256V1.g_table",
    "sm2_consts": "pallas_verify._sm2_consts()[0]",
    "sm3_iv": "sm3._IV",
    "sm3_tjrot": "sm3._TJROT",
}


def consts_from_jax(np_dict: dict) -> dict[str, torch.Tensor]:
    """numpy arrays named as in JAX_NAMES -> int64 tensors, plus `gtab`
    and `sm2_gtab`, the [2, 16, 32] and [16, 32] int32 table blocks the
    CUDA kernels read."""
    missing = set(JAX_NAMES) - set(np_dict)
    if missing:
        raise KeyError(f"missing constants: {sorted(missing)}")
    out = {k: torch.as_tensor(np.asarray(np_dict[k]).astype(np.int64))
           for k in JAX_NAMES}
    out["gtab"] = torch.stack([out["g_table"], out["g_table_endo"]]).to(torch.int32)
    out["sm2_gtab"] = out["sm2_g_table"].to(torch.int32)
    return out


def derive_np() -> dict[str, np.ndarray]:
    """The same constants derived by the port itself, as numpy arrays."""
    from . import ec

    cv, sm = ec.SECP256K1, ec.SM2P256V1
    fn = cv.fn
    glv = np.zeros((16, 13), np.uint32)
    cols = [cv.fp.limbs, cv.b_rep, cv.beta_rep, fn.limbs, fn.nprime, fn.r2,
            fn.one_m, cv.half_n_limbs, cv.g1_limbs, cv.g2_limbs,
            fn.encode_int(cv.mb1_int), fn.encode_int(cv.mb2_int),
            fn.encode_int(cv.glv_lambda)]
    for j, c in enumerate(cols):
        glv[:, j] = c
    sm2 = np.stack([sm.fp.limbs, sm.fp.nprime, sm.fp.one_m, sm.fp.r2, sm.a_rep,
                    sm.b_rep, sm.fn.limbs, sm.fn.nprime, sm.fn.r2, sm.fn.one_m],
                   axis=1)
    return {
        "g_table": cv.g_table, "g_table_endo": cv.g_table_endo,
        "p_limbs": cv.fp.limbs, "n_limbs": fn.limbs, "nprime": fn.nprime,
        "r2": fn.r2, "one_m": fn.one_m, "b_rep": cv.b_rep,
        "beta_rep": cv.beta_rep, "g1_limbs": cv.g1_limbs,
        "g2_limbs": cv.g2_limbs, "half_n_limbs": cv.half_n_limbs,
        "glv_consts": glv, "keccak_rc_hi": keccak.RC_HI,
        "keccak_rc_lo": keccak.RC_LO, "sm2_g_table": sm.g_table,
        "sm2_consts": sm2, "sm3_iv": sm3.IV, "sm3_tjrot": sm3.TJROT,
    }


@functools.lru_cache(maxsize=None)
def derive_consts() -> dict[str, torch.Tensor]:
    return consts_from_jax(derive_np())


# the fields of struct SecpConsts in csrc/field.cuh, in order: 8 words each,
# then np0 as one word, then a ModInv30 (csrc/modinv.cuh) for each of
# SECP_MODINV: 9 limbs of 30 bits and m^-1 mod 2^30
SECP_FIELDS = ("p", "b", "n", "r2", "beta", "g1", "g2", "mb1r", "mb2r", "lamr",
               "half_n")
SECP_MODINV = ("p", "n")
# the columns of glv_consts (pallas_verify._secp_consts), in order
GLV_COLUMNS = ("p", "b", "beta", "n", "nprime", "r2", "one", "half_n", "g1",
               "g2", "mb1r", "mb2r", "lamr")
# the fields of struct Sm2Consts in csrc/sm2.cu, in order: 8 words each,
# then pnp (-p^-1 mod 2^32) as one word
SM2_FIELDS = ("p", "pr2", "pone", "a", "b", "inv_e_p", "n")
# the columns of sm2_consts (pallas_verify._sm2_consts), in order
SM2_COLUMNS = ("p", "pnp", "pone", "pr2", "a", "b", "n", "nnp", "nr2", "none")


def _int(limbs) -> int:
    return sum(int(v) << (16 * i) for i, v in enumerate(limbs))


def _words(v: dict[str, int], fields) -> list[int]:
    return [(v[f] >> (32 * i)) & 0xFFFFFFFF for f in fields for i in range(8)]


def modinv30_words(m: int) -> list[int]:
    """struct ModInv30 of an odd modulus m < 2^256: its 9 limbs of 30
    bits, then m^-1 mod 2^30."""
    return [(m >> (30 * i)) & 0x3FFFFFFF for i in range(9)] + [pow(m, -1, 1 << 30)]


def kernel_words(c: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """The kernels' constant blocks as little-endian uint32 words: "verify"
    is struct SecpConsts (csrc/field.cuh) from the glv_consts columns,
    "keccak" the 24 round constants as (lo, hi) pairs (csrc/keccak.cuh),
    "sm2" struct Sm2Consts (csrc/sm2.cu) from the sm2_consts columns,
    "sm3" the IV then the 64 rotated round constants (csrc/sm3.cuh),
    "sm3_pad" the expanded words W[0..63] and W'[0..63] of the padding
    block of a 512-byte Merkle node (csrc/merkle.cuh)."""
    glv = c["glv_consts"]
    v = {k: _int(glv[:, j].tolist()) for j, k in enumerate(GLV_COLUMNS)}
    p = v["p"]
    if p != 2 ** 256 - 2 ** 32 - 977:
        raise ValueError("field.cuh's mod-p fold and ec.cuh's square-root chain are "
                         "written for secp256k1's p")
    secp = _words(v, SECP_FIELDS) + [v["nprime"] & 0xFFFFFFFF]
    for m in (v[k] for k in SECP_MODINV):
        secp += modinv30_words(m)
    rc = np.stack([c["keccak_rc_lo"].numpy(), c["keccak_rc_hi"].numpy()], axis=1)
    smc = c["sm2_consts"]
    v = {k: _int(smc[:, j].tolist()) for j, k in enumerate(SM2_COLUMNS)}
    if v["p"] != 2 ** 256 - 2 ** 224 - 2 ** 96 + 2 ** 64 - 1:
        raise ValueError("sm2.cuh's special-form reduction is written for SM2's p")
    v["inv_e_p"] = v["p"] - 2
    sm2 = _words(v, SM2_FIELDS) + [v["pnp"] & 0xFFFFFFFF]
    sm3w = np.concatenate([c["sm3_iv"].numpy(), c["sm3_tjrot"].numpy()])
    return {"verify": np.array(secp, np.uint32),
            "keccak": rc.reshape(-1).astype(np.uint32),
            "sm2": np.array(sm2, np.uint32), "sm3": sm3w.astype(np.uint32),
            "sm3_pad": np.array(sm3.pad_block_words(512), np.uint32)}
