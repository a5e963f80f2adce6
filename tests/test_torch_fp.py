"""Port's plain field layer (fisco_bcos_tpu_torch.ops.fp) against the JAX
package's ops.fp, bit-exact, on seeded inputs including zero and
modulus-edge lanes. Limbs cross between the two as numpy arrays."""

import numpy as np
import pytest
import torch

from fisco_bcos_tpu.crypto import refimpl as jref
from fisco_bcos_tpu.ops import fp as jfp
from fisco_bcos_tpu_torch.ops import bigint, fp


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These tests run thousands of small tensor ops: one intra-op thread,
    so that test workers sharing the cores do not stall at every op's
    thread barrier."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


# -- the fp kernels' dispatch (ops/fp._FieldBase.mul on kernels=True fields) --
# On CPU tensors each route runs the kernel's plain version, held here to
# the JAX package's pallas_fp kernels in interpret mode, bit-exact.

from fisco_bcos_tpu.ops import pallas_fp as jpallas  # noqa: E402
from fisco_bcos_tpu.zk import poseidon as jposeidon  # noqa: E402
from fisco_bcos_tpu_torch.ops import cuda_fp, ec  # noqa: E402

R = jposeidon.P  # BN254 r, 2r < 2^256
KB = 256
KERNEL_FIELDS = {
    "bn254_r": (fp.MontField, jfp.MontField, R),
    "secp_p": (fp.SolinasField, jfp.SolinasField, P),
    "secp_n": (fp.MontField, jfp.MontField, N),
    "sm2_p": (fp.MontField, jfp.MontField, SM2_P),
    "sm2_n": (fp.MontField, jfp.MontField, SM2_N),
}


def _kernel_lanes(mod: int, seed: int, loose: bool = False) -> np.ndarray:
    """KB seeded canonical lanes with the edge lanes 0, 1, n - 1 and R mod n
    (Montgomery one); loose=True puts values in [2n, 2^256) in every
    eighth lane (the to_rep operand when 2n < 2^256, else in [n, 2^256))."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "big") % mod for _ in range(KB)]
    vals[:4] = [0, 1, mod - 1, (1 << 256) % mod]
    if loose:
        lo = min(2 * mod, (1 << 256) - 1)
        for i in range(7, KB, 8):
            vals[i] = lo + int.from_bytes(rng.bytes(32), "big") % ((1 << 256) - lo)
        vals[15] = (1 << 256) - 1
    return _np(vals)


@pytest.fixture(params=sorted(KERNEL_FIELDS))
def kfields(request):
    mk_port, mk_jax, mod = KERNEL_FIELDS[request.param]
    return mk_port(mod, kernels=True), mk_jax(mod), mod


def test_fp_mul_dispatch_matches_pallas_mul(kfields):
    f, jf, mod = kfields
    a, b = _kernel_lanes(mod, 20, loose=True), _kernel_lanes(mod, 21)
    _same(f.mul(_port(a), _port(b)), jpallas.mul(jf, a, b, interpret=True))


def test_fp_mul_const_dispatch_matches_pallas(kfields):
    f, jf, mod = kfields
    a = _kernel_lanes(mod, 22, loose=True)
    c = _np([(1 << 256) % mod * 3 % mod])  # one [16, 1] column
    want = jpallas.mul_const(jf, a, c, interpret=True)
    _same(f.mul(_port(a), _port(c)), want)
    _same(f.mul(_port(c), _port(a)), want)  # either operand order


def test_fp_mul_stacked_dispatch_matches_pallas(kfields):
    f, jf, mod = kfields
    a = np.stack([_kernel_lanes(mod, 23 + k, loose=True) for k in range(3)])
    b = np.stack([_kernel_lanes(mod, 26 + k) for k in range(3)])
    _same(f.mul(_port(a), _port(b)), jpallas.mul_stacked(jf, a, b, interpret=True))


def test_np0_is_the_low_word_of_nprime(kfields):
    f, jf, mod = kfields
    assert cuda_fp.np0(mod) * mod % (1 << 32) == (1 << 32) - 1
    words = cuda_fp._field_words(f)
    if isinstance(f, fp.MontField):
        nprime = np.asarray(jf.nprime).astype(np.int64)
        assert int(words[8]) == int(nprime[0]) | (int(nprime[1]) << 16)
        assert int(words[9]) == 0
    else:
        assert int(words[9]) == 1
    assert sum(int(w) << (32 * i) for i, w in enumerate(words[:8])) == mod


def test_pow_mode_picks_by_exponent(kfields):
    """Kernel G's mode for a launch (ops/cuda_fp.pow_mode): the safegcd
    inverse for m - 2 (every kernel field is a prime above 2^253),
    secp256k1's square-root chain for (p + 1) / 4 on its p only, the
    window loop for every other exponent."""
    f, _, mod = kfields
    assert cuda_fp.pow_mode(f, mod - 2) == cuda_fp.INVERSE
    sqrt = cuda_fp.SQRT if isinstance(f, fp.SolinasField) else cuda_fp.WINDOW
    assert cuda_fp.pow_mode(f, (mod + 1) // 4) == sqrt
    for e in (1, 3, 65537, mod - 1, mod - 3, (mod - 1) // 2):
        assert cuda_fp.pow_mode(f, e) == cuda_fp.WINDOW


@pytest.mark.parametrize("mod", [(1 << 255) + 1, 3 * R, SM2_P * 3 % (1 << 256) | 1],
                         ids=["2^255+1", "3r", "odd composite near 2^256"])
def test_pow_mode_inverse_needs_a_prime(mod):
    """m - 2 is an inverse's exponent only for a prime m: a modulus that
    is not one of the kernels' five primes keeps the window loop."""
    assert cuda_fp.pow_mode(fp.MontField(mod), mod - 2) == cuda_fp.WINDOW


def test_inv_words_of_the_kernel_fields(kfields):
    """The inverse mode's launch words: struct ModInv30 (9 limbs of 30
    bits, m^-1 mod 2^30) and R^3 mod m for a Montgomery field's domain
    fix-up, zeros for the Solinas field."""
    f, _, mod = kfields
    w = [int(x) for x in cuda_fp._inv_words(f)]
    assert len(w) == 18 and all(x < 1 << 30 for x in w[:9])
    assert sum(x << (30 * i) for i, x in enumerate(w[:9])) == mod
    assert w[9] * mod % (1 << 30) == 1
    r3 = 0 if isinstance(f, fp.SolinasField) else pow(1 << 256, 3, mod)
    assert sum(x << (32 * i) for i, x in enumerate(w[10:])) == r3


def test_fp_kernels_refuse_other_solinas_fields():
    with pytest.raises(ValueError, match="Solinas"):
        cuda_fp._field_words(fp.SolinasField((1 << 256) - 189, kernels=True))


def test_to_rep_of_loose_values_below_2_256():
    """BN254 r has 2r < 2^256: reduce_loose leaves values in [2r, 2^256)
    loose, and to_rep's one product against R^2 makes them canonical, in
    the port (both dispatch modes) and in the JAX package."""
    rng = np.random.default_rng(30)
    vals = [2 * R, 3 * R - 1, 4 * R + 12345, (1 << 256) - 1] + [
        2 * R + int.from_bytes(rng.bytes(32), "big") % ((1 << 256) - 2 * R)
        for _ in range(4)]
    want = _np([v % R * ((1 << 256) % R) % R for v in vals]).astype(np.int64)
    a = _np(vals)
    loose = fp.MontField(R).reduce_loose(_port(a))
    assert any(bigint.from_limbs(loose[:, i].numpy()) >= R for i in range(len(vals)))
    for f in (fp.MontField(R), fp.MontField(R, kernels=True)):
        np.testing.assert_array_equal(f.to_rep(_port(a)).numpy(), want)
    np.testing.assert_array_equal(np.asarray(jfp.MontField(R).to_rep(a)).astype(np.int64), want)


def test_plain_ec_paths_never_reach_the_fp_kernels(monkeypatch):
    """The curve fields are built without kernels, so the plain EC versions
    (the EC kernels' oracles on the card) run plain products only; and a
    kernels field on CPU tensors counts no launch."""
    for cv in (ec.SECP256K1, ec.SM2P256V1):
        assert not cv.fp.kernels and not cv.fn.kernels

    def refuse(*args):
        raise AssertionError("a plain EC path reached the fp kernel dispatch")

    monkeypatch.setattr(fp, "_route", refuse)
    one = torch.ones((16, 2), dtype=torch.int64)
    z = torch.zeros_like(one)
    ec.ecdsa_verify_plain(ec.SECP256K1, one, one, one, z, z)
    ec.sm2_verify_plain(ec.SM2P256V1, one, one, one, z, z)
    monkeypatch.undo()
    before = (cuda_fp.mul.launches, cuda_fp.mul_const.launches,
              cuda_fp.mul_stacked.launches)
    f = fp.MontField(R, kernels=True)
    a = _port(_kernel_lanes(R, 31))
    f.from_rep(f.to_rep(a[None].expand(2, 16, KB)))
    f.mul(a, a)
    assert (cuda_fp.mul.launches, cuda_fp.mul_const.launches,
            cuda_fp.mul_stacked.launches) == before
