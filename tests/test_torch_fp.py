"""Port's plain field layer (fisco_bcos_tpu_torch.ops.fp) against the JAX
package's ops.fp, bit-exact, on seeded inputs including zero and
modulus-edge lanes. Limbs cross between the two as numpy arrays."""

import numpy as np
import pytest
import torch

from fisco_bcos_tpu.crypto import refimpl as jref
from fisco_bcos_tpu.ops import fp as jfp
from fisco_bcos_tpu_torch.ops import bigint, fp

P, N = jref.SECP256K1.p, jref.SECP256K1.n
# SM2's p has no one-word fold and lies near 2^256: a Montgomery field, whose
# redundant columns press hardest on the int64 carry collapse
SM2_P, SM2_N = jref.SM2P256V1.p, jref.SM2P256V1.n
B = 8


def _values(mod: int, seed: int) -> list[int]:
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "big") % mod for _ in range(B)]
    vals[0], vals[1], vals[2] = 0, mod - 1, 1
    return vals


def _np(vals) -> np.ndarray:
    """ints -> lane-major [16, B] uint32."""
    return np.ascontiguousarray(bigint.batch_to_limbs(vals).T)


def _port(a: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(a.astype(np.int64))


def _same(port_out: torch.Tensor, jax_out) -> None:
    np.testing.assert_array_equal(port_out.numpy(), np.asarray(jax_out).astype(np.int64))


FIELDS = {
    "solinas_p": (lambda: fp.SolinasField(P), lambda: jfp.SolinasField(P), P),
    "mont_n": (lambda: fp.MontField(N), lambda: jfp.MontField(N), N),
    "sm2_p": (lambda: fp.MontField(SM2_P), lambda: jfp.MontField(SM2_P), SM2_P),
    "sm2_n": (lambda: fp.MontField(SM2_N), lambda: jfp.MontField(SM2_N), SM2_N),
}


@pytest.fixture(params=sorted(FIELDS))
def fields(request):
    mk_port, mk_jax, mod = FIELDS[request.param]
    return mk_port(), mk_jax(), mod


@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_binary_ops(fields, op):
    f, jf, mod = fields
    a, b = _np(_values(mod, 1)), _np(_values(mod, 2))
    ar, br = jf.to_rep(a), jf.to_rep(b)
    _same(getattr(f, op)(_port(np.asarray(ar)), _port(np.asarray(br))),
          getattr(jf, op)(ar, br))


def test_neg_and_domain_round_trip(fields):
    f, jf, mod = fields
    a = _np(_values(mod, 3))
    _same(f.to_rep(_port(a)), jf.to_rep(a))
    rep = np.asarray(jf.to_rep(a))
    _same(f.neg(_port(rep)), jf.neg(rep))
    _same(f.from_rep(_port(rep)), jf.from_rep(rep))


def test_reduce_loose_above_modulus(fields):
    f, jf, mod = fields
    vals = [(1 << 256) - 1, mod, mod + 5, 0, 1, mod - 1, (1 << 255), 7]
    a = _np(vals)
    _same(f.reduce_loose(_port(a)), jf.reduce_loose(a))


@pytest.mark.parametrize("e", [0, 1, 5, 0xFFFF_FFFF_FFFF, "order-2"])
def test_pow_const(fields, e):
    f, jf, mod = fields
    e = mod - 2 if e == "order-2" else e
    rep = np.asarray(jf.to_rep(_np(_values(mod, 4))))
    _same(f.pow_const(_port(rep), e), jf.pow_const(rep, e))


def test_inv_batch_with_zero_lanes(fields):
    f, jf, mod = fields
    vals = _values(mod, 5)
    vals[3] = 0
    rep = np.asarray(jf.to_rep(_np(vals)))
    got = f.inv_batch(_port(rep))
    _same(got, jf.inv_batch(rep))
    plain = f.from_rep(got)
    for i, v in enumerate(vals):
        want = pow(v, -1, mod) if v else 0
        assert bigint.from_limbs(plain[:, i].numpy()) == want


def test_limb_helpers_match():
    a, b = _np(_values(P, 6)), _np(_values(P, 7))
    s, c = fp.add_limbs(_port(a), _port(b))
    js, jc = jfp.add_limbs(a, b)
    _same(s, js)
    _same(c, jc)
    d, brw = fp.sub_limbs(_port(a), _port(b))
    jd, jb = jfp.sub_limbs(a, b)
    _same(d, jd)
    _same(brw, jb)
    assert fp.geq(_port(a), _port(b)).tolist() == np.asarray(jfp.geq(a, b)).tolist()
    _same(fp.window_digits(_port(a), 4), jfp.window_digits(a, 4))
    np.testing.assert_array_equal(fp.msb_digits(N - 2), jfp.msb_digits(N - 2))
    wide = fp.carry_prop(fp.mul_wide(_port(a), _port(b)), 32)[0]
    jwide = jfp.carry_prop(jfp.mul_wide(a, b), 32)[0]
    _same(wide, jwide)


def test_rows_to_limbs_matches_batch_to_limbs():
    vals = _values(1 << 256, 8)
    rows = b"".join(v.to_bytes(32, "big") for v in vals)
    np.testing.assert_array_equal(bigint.rows_to_limbs(rows, len(vals)),
                                  bigint.batch_to_limbs(vals))
    back = bigint.limbs_to_rows(bigint.batch_to_limbs(vals))
    assert back.tobytes() == rows
