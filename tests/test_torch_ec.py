"""Port's plain secp256k1 layer (fisco_bcos_tpu_torch.ops.ec) against the
JAX package and the pure-Python oracle, bit-exact.

The fast tests hold the GLV split, the curve constants and the plain
verify/recover at B=8 (valid, adversarial and ladder-collision vectors)
against JAX and `refimpl`. The `slow` tests compare with the JAX batch
entry points, whose CPU compiles take minutes (as tests/test_ec.py marks
its own)."""

import numpy as np
import pytest
import torch

from fisco_bcos_tpu.ops import ec as jec
from fisco_bcos_tpu.ops import pallas_verify
from fisco_bcos_tpu.ops import keccak as jkeccak
from fisco_bcos_tpu.ops import sm3 as jsm3
from fisco_bcos_tpu_torch.crypto import refimpl
from fisco_bcos_tpu_torch.ops import bigint, consts, ec
import test_torch_vectors as vectors  # tests/ is on sys.path under pytest

C = refimpl.SECP256K1


def _vectors():
    return vectors.signed_vectors(5, tag=21) + vectors.collision_vectors()


def _lane_np(xs) -> np.ndarray:
    return np.ascontiguousarray(bigint.batch_to_limbs(xs).T)


def _lane(xs) -> torch.Tensor:
    return torch.as_tensor(_lane_np(xs).astype(np.int64))


def test_curve_tables_match_jax():
    cv, jcv = ec.SECP256K1, jec.SECP256K1
    for name in ("g_table", "g_table_endo", "beta_rep", "b_rep", "g1_limbs",
                 "g2_limbs", "half_n_limbs"):
        np.testing.assert_array_equal(getattr(cv, name), getattr(jcv, name))
    for name in ("limbs", "nprime", "r2", "one_m"):
        np.testing.assert_array_equal(getattr(cv.fn, name), getattr(jcv.fn, name))
    np.testing.assert_array_equal(cv.fp.limbs, jcv.fp.limbs)


def test_consts_from_jax_equal_derived():
    jcv = jec.SECP256K1
    jax_np = {
        "g_table": jcv.g_table, "g_table_endo": jcv.g_table_endo,
        "p_limbs": jcv.fp.limbs, "n_limbs": jcv.fn.limbs,
        "nprime": jcv.fn.nprime, "r2": jcv.fn.r2, "one_m": jcv.fn.one_m,
        "b_rep": jcv.b_rep, "beta_rep": jcv.beta_rep,
        "g1_limbs": jcv.g1_limbs, "g2_limbs": jcv.g2_limbs,
        "half_n_limbs": jcv.half_n_limbs,
        "glv_consts": pallas_verify._secp_consts()[0],
        "keccak_rc_hi": jkeccak._RC_HI, "keccak_rc_lo": jkeccak._RC_LO,
        "sm2_g_table": jec.SM2P256V1.g_table,
        "sm2_consts": pallas_verify._sm2_consts()[0],
        "sm3_iv": jsm3._IV, "sm3_tjrot": jsm3._TJROT,
    }
    assert set(jax_np) == set(consts.JAX_NAMES)
    got, mine = consts.consts_from_jax(jax_np), consts.derive_consts()
    assert set(got) == set(mine)
    for k in got:
        assert torch.equal(got[k], mine[k]), k
    assert mine["gtab"].shape == (2, 16, 32) and mine["gtab"].dtype == torch.int32
    assert mine["sm2_gtab"].shape == (16, 32) and mine["sm2_gtab"].dtype == torch.int32
    kj, km = consts.kernel_words(got), consts.kernel_words(mine)
    assert set(kj) == set(km) == {"verify", "keccak", "sm2", "sm3"}
    for k in kj:
        np.testing.assert_array_equal(kj[k], km[k])


def test_kernel_words_match_the_cuda_structs():
    """The constant blocks the kernels read: field order as declared in
    csrc/field.cuh, values as the oracle defines them."""
    import re
    from pathlib import Path

    csrc = Path(consts.__file__).resolve().parent.parent / "csrc"
    body = re.search(r"struct SecpConsts \{(.*?)\};",
                     (csrc / "field.cuh").read_text(), re.S).group(1)
    decl = re.findall(r"(\w+)(\[8\])?[,;]", re.sub(r"//[^\n]*|\bu32\b", "", body))
    assert [n for n, arr in decl if arr] == list(consts.SECP_FIELDS)
    assert [n for n, arr in decl if not arr] == ["np0"]
    w = consts.kernel_words(consts.derive_consts())
    words = w["verify"]
    assert words.shape == (8 * len(consts.SECP_FIELDS) + 1,)
    val = {f: sum(int(words[8 * j + i]) << (32 * i) for i in range(8))
           for j, f in enumerate(consts.SECP_FIELDS)}
    R = 1 << 256
    assert val == {
        "p": C.p, "sqrt_e": (C.p + 1) // 4, "inv_e_p": C.p - 2, "b": C.b,
        "n": C.n, "r2": R * R % C.n, "one": R % C.n, "inv_e_n": C.n - 2,
        "beta": refimpl.GLV_BETA, "g1": refimpl._GLV_G1, "g2": refimpl._GLV_G2,
        "mb1r": refimpl._GLV_MINUS_B1 * R % C.n,
        "mb2r": refimpl._GLV_MINUS_B2 * R % C.n,
        "lamr": refimpl.GLV_LAMBDA * R % C.n, "half_n": C.n // 2}
    assert (int(words[-1]) * C.n) % (1 << 32) == (1 << 32) - 1
    rc = w["keccak"].view("<u8")
    assert w["keccak"].dtype == np.uint32 and rc.shape == (24,)
    assert int(rc[0]) == 1 and int(rc[23]) == 0x8000000080008008
    assert "0x" not in re.sub(r"//[^\n]*", "", (csrc / "keccak.cuh").read_text())


def test_glv_split_matches_jax_and_oracle():
    rng = np.random.default_rng(31)
    ks = [0, 1, C.n - 1, C.n // 2, C.n // 2 + 1, refimpl.GLV_LAMBDA] + [
        int.from_bytes(rng.bytes(32), "big") % C.n for _ in range(10)]
    got = ec._glv_split_device(ec.SECP256K1, _lane(ks))
    want = jec._glv_split_device(jec.SECP256K1, _lane_np(ks))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      np.asarray(w).astype(np.int64))
    m1, n1, m2, n2 = got
    for i, k in enumerate(ks):
        a = bigint.from_limbs(m1[:, i].numpy()) * (-1 if n1[i] else 1)
        b = bigint.from_limbs(m2[:, i].numpy()) * (-1 if n2[i] else 1)
        assert (a + b * refimpl.GLV_LAMBDA - k) % C.n == 0
        assert abs(a) < 1 << 136 and abs(b) < 1 << 136


def test_plain_verify_matches_oracle():
    vs = _vectors()
    ok = ec.ecdsa_verify_batch(ec.SECP256K1, *(
        vectors.limbs([d[k] for d in vs]) for k in ("e", "r", "s", "qx", "qy")))
    want = [refimpl.ecdsa_verify(C, (d["qx"], d["qy"]), d["e"].to_bytes(32, "big"),
                                 d["r"], d["s"]) for d in vs]
    assert ok.tolist() == want
    assert any(want) and not all(want)


def test_plain_recover_matches_oracle():
    vs = _vectors()
    qx, qy, ok = ec.ecdsa_recover_batch(
        ec.SECP256K1, *(vectors.limbs([d[k] for d in vs]) for k in "ers"),
        torch.tensor([d["v"] for d in vs]))
    for i, d in enumerate(vs):
        Q = refimpl.ecdsa_recover(C, d["e"].to_bytes(32, "big"), d["r"], d["s"], d["v"])
        got = (bigint.from_limbs(qx[i].numpy()), bigint.from_limbs(qy[i].numpy()))
        assert (got if ok[i] else None) == Q, i
        if not ok[i]:
            assert got == (0, 0)
    assert ok.any() and not ok.all()


def test_non_secp_curve_is_refused():
    """SM2 is a curve of the port now, but ECDSA runs on secp256k1 only,
    SM2 verify on SM2 only, and a curve the point formulas do not cover
    (a not 0 or -3) is refused at construction."""
    sm = ec.Curve(refimpl.SM2P256V1)
    assert isinstance(sm.fp, ec.fp.MontField) and sm.a_is_minus3 and not sm.has_endo
    z = vectors.limbs([0] * 8)
    with pytest.raises(ValueError):
        ec.ecdsa_verify_batch(ec.SM2P256V1, z, z, z, z, z)
    with pytest.raises(ValueError):
        ec.ecdsa_recover_batch(ec.SM2P256V1, z, z, z, torch.zeros(8))
    with pytest.raises(ValueError):
        ec.sm2_verify_batch(ec.SECP256K1, z, z, z, z, z)
    with pytest.raises(ValueError):
        ec.Curve(refimpl.CurveParams("a1", C.p, 1, 7, C.n, C.gx, C.gy))


def test_glv_constants_are_checked():
    """A curve that can have the endomorphism (a = 0, p = 1 mod 3) gets
    the GLV plane only if secp256k1's (beta, lambda) hold for its G: a
    base point of another group order fails at construction."""
    assert ec.SECP256K1.has_endo
    with pytest.raises(AssertionError, match="GLV"):
        ec.Curve(refimpl.CurveParams("g1", C.p, 0, 7, C.n, C.gx + 1, C.gy))


# ---------------------------------------------------------------------------
# against the JAX batch entry points (minutes of XLA compile on the CPU)
# ---------------------------------------------------------------------------

def _rows(vs, k):
    return bigint.batch_to_limbs([d[k] for d in vs])


@pytest.mark.slow
def test_verify_matches_jax_batch():
    vs = _vectors()[:8]
    want = np.asarray(jec.ecdsa_verify_batch(
        jec.SECP256K1, *(_rows(vs, k) for k in ("e", "r", "s", "qx", "qy"))))
    got = ec.ecdsa_verify_batch(ec.SECP256K1, *(
        torch.as_tensor(_rows(vs, k).astype(np.int64)) for k in ("e", "r", "s", "qx", "qy")))
    assert got.tolist() == want.tolist()


@pytest.mark.slow
def test_recover_matches_jax_batch():
    vs = _vectors()[:8]
    v = np.array([d["v"] for d in vs], np.uint32)
    jx, jy, jok = jec.ecdsa_recover_batch(jec.SECP256K1, *(_rows(vs, k) for k in "ers"), v)
    qx, qy, ok = ec.ecdsa_recover_batch(
        ec.SECP256K1, *(torch.as_tensor(_rows(vs, k).astype(np.int64)) for k in "ers"),
        torch.as_tensor(v.astype(np.int64)))
    assert ok.tolist() == np.asarray(jok).tolist()
    np.testing.assert_array_equal(qx.numpy(), np.asarray(jx).astype(np.int64))
    np.testing.assert_array_equal(qy.numpy(), np.asarray(jy).astype(np.int64))


@pytest.mark.slow
def test_glv_shamir_mult_matches_jax_jacobian():
    rng = np.random.default_rng(41)
    k1 = [int.from_bytes(rng.bytes(32), "big") % C.n for _ in range(8)]
    k2 = [int.from_bytes(rng.bytes(32), "big") % C.n for _ in range(8)]
    pts = [refimpl.keygen(C, seed=bytes([i]))[1] for i in range(8)]
    qx, qy = [p[0] for p in pts], [p[1] for p in pts]
    want = jec.glv_shamir_mult(jec.SECP256K1, _lane_np(k1), _lane_np(k2),
                               _lane_np(qx), _lane_np(qy))
    got = ec.glv_shamir_mult(ec.SECP256K1, _lane(k1), _lane(k2), _lane(qx), _lane(qy))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
