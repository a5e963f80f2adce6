"""Port's plain SM2 layer (fisco_bcos_tpu_torch.ops.ec, SM2P256V1) against
the JAX package and the pure-Python oracle, bit-exact.

The fast tests hold the SM2 curve tables and field constants, the a = -3
point formulas and the plain verify (valid, adversarial and ladder-
collision vectors) against JAX and `refimpl`. The `slow` tests compare
with the JAX batch entry points, whose CPU compiles take minutes (as
tests/test_ec.py marks its own)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from fisco_bcos_tpu.ops import ec as jec
from fisco_bcos_tpu.ops import pallas_verify
from fisco_bcos_tpu_torch.crypto import refimpl
from fisco_bcos_tpu_torch.ops import bigint, consts, ec
import test_torch_vectors as vectors  # tests/ is on sys.path under pytest


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These tests run thousands of small tensor ops: one intra-op thread,
    so that test workers sharing the cores do not stall at every op's
    thread barrier."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


S = refimpl.SM2P256V1
KEYS = ("e", "r", "s", "qx", "qy")


def _lane_np(xs) -> np.ndarray:
    return np.ascontiguousarray(bigint.batch_to_limbs(xs).T)


def _lane(xs) -> torch.Tensor:
    return torch.as_tensor(_lane_np(xs).astype(np.int64))


def _vectors():
    return vectors.sm2_vectors(17, tag=5) + vectors.sm2_collision_vectors()


def test_curve_tables_match_jax():
    cv, jcv = ec.SM2P256V1, jec.SM2P256V1
    for name in ("g_table", "a_rep", "b_rep"):
        np.testing.assert_array_equal(getattr(cv, name), getattr(jcv, name))
    for f, jf in ((cv.fp, jcv.fp), (cv.fn, jcv.fn)):
        assert type(f).__name__ == type(jf).__name__ == "MontField"
        for name in ("limbs", "nprime", "r2", "one_m"):
            np.testing.assert_array_equal(getattr(f, name), getattr(jf, name))
    assert (cv.a_is_zero, cv.a_is_minus3, cv.has_endo) == (
        jcv.a_is_zero, jcv.a_is_minus3, jcv.has_endo) == (False, True, False)


def test_sm2_consts_match_jax_and_the_cuda_struct():
    jcols, jgts = pallas_verify._sm2_consts()
    mine = consts.derive_consts()
    np.testing.assert_array_equal(mine["sm2_consts"].numpy(), jcols.astype(np.int64))
    np.testing.assert_array_equal(mine["sm2_gtab"].numpy(), jgts[0].astype(np.int64))
    csrc = Path(consts.__file__).resolve().parent.parent / "csrc"
    body = re.search(r"struct Sm2Consts \{(.*?)\};",
                     (csrc / "sm2.cuh").read_text(), re.S).group(1)
    decl = re.findall(r"(\w+)(\[8\])?[,;]", re.sub(r"//[^\n]*|\bu32\b", "", body))
    assert [n for n, arr in decl if arr] == list(consts.SM2_FIELDS)
    assert [n for n, arr in decl if not arr] == ["pnp"]
    words = consts.kernel_words(mine)["sm2"]
    assert words.shape == (8 * len(consts.SM2_FIELDS) + 1,)
    val = {f: sum(int(words[8 * j + i]) << (32 * i) for i in range(8))
           for j, f in enumerate(consts.SM2_FIELDS)}
    R = 1 << 256
    assert val == {"p": S.p, "pr2": R * R % S.p, "pone": R % S.p,
                   "a": S.a * R % S.p, "b": S.b * R % S.p, "inv_e_p": S.p - 2,
                   "n": S.n}
    assert (int(words[-1]) * S.p) % (1 << 32) == (1 << 32) - 1
    assert "0x" not in re.sub(r"//[^\n]*", "", (csrc / "sm2.cuh").read_text())


def _points(k):
    """k affine multiples of G (field rep) as lane-major tensors."""
    pts = [refimpl.ec_mul(S, 3 + 5 * i, (S.gx, S.gy)) for i in range(k)]
    f = ec.SM2P256V1.fp
    x = np.stack([f.encode_int(p[0]) for p in pts], axis=1)
    y = np.stack([f.encode_int(p[1]) for p in pts], axis=1)
    return x, y


def test_point_formulas_match_jax():
    """a = -3 doubling and the mixed add on Jacobian points with Z != 1
    (and at infinity), against the JAX package."""
    cv, jcv = ec.SM2P256V1, jec.SM2P256V1
    x, y = _points(4)
    one = np.repeat(cv.fp.one_m[:, None], 4, axis=1)
    P = np.stack([x, y, one]).astype(np.uint32)
    jd = np.array(jec.jac_double(jcv, P))
    np.testing.assert_array_equal(ec.jac_double(cv, torch.as_tensor(P.astype(np.int64))).numpy(),
                                  jd.astype(np.int64))
    jd[:, :, 3] = 0  # lane 3 at infinity
    qx, qy = x[:, ::-1].copy(), y[:, ::-1].copy()
    want = np.asarray(jec.jac_add_affine(jcv, jd, qx, qy)).astype(np.int64)
    got = ec.jac_add_affine(cv, torch.as_tensor(jd.astype(np.int64)),
                            torch.as_tensor(qx.astype(np.int64)),
                            torch.as_tensor(qy.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_verify_matches_oracle():
    vs = _vectors()
    ok = ec.sm2_verify_batch(ec.SM2P256V1, *(vectors.limbs([d[k] for d in vs]) for k in KEYS))
    want = [vectors.sm2_verifies(d) for d in vs]
    assert ok.tolist() == want
    assert want.count(False) == len(vectors.SM2_CORRUPTIONS)


def test_cpu_tensors_take_the_plain_version():
    from fisco_bcos_tpu_torch.ops import cuda_verify

    vs = vectors.sm2_vectors(2, tag=8)
    before = cuda_verify.sm2_verify.launches
    args = [vectors.limbs([d[k] for d in vs]) for k in KEYS]
    assert ec.sm2_verify_batch(ec.SM2P256V1, *args).tolist() == [True, False]
    assert cuda_verify.sm2_verify.launches == before
    with pytest.raises(ValueError):
        cuda_verify.sm2_verify(*(a.T for a in args))


# ---------------------------------------------------------------------------
# against the JAX batch entry points (minutes of XLA compile on the CPU)
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_verify_matches_jax_batch():
    vs = _vectors()[:8]
    rows = [bigint.batch_to_limbs([d[k] for d in vs]) for k in KEYS]
    want = np.asarray(jec.sm2_verify_batch(jec.SM2P256V1, *rows))
    got = ec.sm2_verify_batch(ec.SM2P256V1, *(torch.as_tensor(r.astype(np.int64))
                                              for r in rows))
    assert got.tolist() == want.tolist()


@pytest.mark.slow
def test_shamir_mult_matches_jax_jacobian():
    rng = np.random.default_rng(43)
    k1 = [int.from_bytes(rng.bytes(32), "big") % S.n for _ in range(8)]
    k2 = [int.from_bytes(rng.bytes(32), "big") % S.n for _ in range(8)]
    x, y = _points(8)
    want = jec.shamir_mult(jec.SM2P256V1, _lane_np(k1), _lane_np(k2), x, y)
    got = ec.shamir_mult(ec.SM2P256V1, _lane(k1), _lane(k2),
                         torch.as_tensor(x.astype(np.int64)),
                         torch.as_tensor(y.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
