"""The port's composed EC route (fisco_bcos_tpu_torch.ops.ec with
route="composed"): the plain versions of kernel G (`_FieldBase.pow_const`
on a kernels=True field) and kernel H (`ec.ladder_plain`) against the JAX
package, and the composed verify and recovery against the fused route's
CPU path and the pure-Python oracle, bit-exact everywhere.

The JAX ladder is too dear on the CPU to run whole in these tests (a
jitted `pallas_ec.ladder_values` at B = 128 takes minutes), so the fast
tests hold its point formulas (`vjac_add`, `vjac_double`, one jit a curve)
to the port's, and `ladder_plain` to a pure-Python transcription of
`ladder_values` (`_ladder_mirror`: the same complete-by-selection
Jacobian formulas on Python ints, lane by lane) and, in affine form, to
`refimpl`; the `slow` tests compare with the JAX kernels in interpret mode
and with the JAX batch entry points."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from fisco_bcos_tpu.ops import ec as jec
from fisco_bcos_tpu.ops import fp as jfp
from fisco_bcos_tpu.ops import pallas_ec, pallas_fp
from fisco_bcos_tpu_torch.crypto import refimpl
from fisco_bcos_tpu_torch.crypto import suite as psuite
from fisco_bcos_tpu_torch.ops import bigint, cuda_ec, cuda_fp, ec, fp
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


C, S = refimpl.SECP256K1, refimpl.SM2P256V1
CURVES = {"secp256k1": (ec.SECP256K1, jec.SECP256K1), "sm2": (ec.SM2P256V1, jec.SM2P256V1)}


def _lane_np(xs) -> np.ndarray:
    return np.ascontiguousarray(bigint.batch_to_limbs(xs).T)


def _lane(xs) -> torch.Tensor:
    return torch.as_tensor(_lane_np(xs).astype(np.int64))


def _ints(t) -> list[int]:
    """[16, B] limbs -> B Python ints."""
    a = np.asarray(t)
    return [bigint.from_limbs(a[:, i]) for i in range(a.shape[1])]


# ---------------------------------------------------------------------------
# kernel G's plain version: pow_const
# ---------------------------------------------------------------------------

POW_FIELDS = {  # name -> (port field, JAX field, the curve's p and n)
    "secp_p": (lambda k: fp.SolinasField(C.p, kernels=k), jfp.SolinasField(C.p), C),
    "secp_n": (lambda k: fp.MontField(C.n, kernels=k), jfp.MontField(C.n), C),
    "sm2_p": (lambda k: fp.MontField(S.p, kernels=k), jfp.MontField(S.p), S),
    "sm2_n": (lambda k: fp.MontField(S.n, kernels=k), jfp.MontField(S.n), S),
}
POW_EXPS = ("1", "2", "0x1234", "(p+1)/4", "n-2", "p-2")
_JAX_POWS: dict = {}


def _exp(name: str, c) -> int:
    return {"1": 1, "2": 2, "0x1234": 0x1234, "(p+1)/4": (c.p + 1) // 4,
            "n-2": c.n - 2, "p-2": c.p - 2}[name]


def _pow_lanes(mod: int) -> np.ndarray:
    rng = np.random.default_rng(50)
    vals = [int.from_bytes(rng.bytes(32), "big") % mod for _ in range(8)]
    vals[:3] = [0, 1, mod - 1]
    return _lane_np(vals)


def _jax_pows(name: str):
    """All six powers of one field's lanes by the JAX field's pow_const
    (the XLA scan), in one jit a field."""
    if name not in _JAX_POWS:
        _, jf, c = POW_FIELDS[name]
        exps = [_exp(e, c) for e in POW_EXPS]
        rep = np.asarray(jf.to_rep(_pow_lanes(jf.n_int)))
        outs = jax.jit(lambda a: [jf.pow_const(a, e) for e in exps])(rep)
        _JAX_POWS[name] = rep, [np.asarray(o).astype(np.int64) for o in outs]
    return _JAX_POWS[name]


@pytest.mark.parametrize("e", POW_EXPS)
@pytest.mark.parametrize("name", sorted(POW_FIELDS))
def test_pow_const_matches_jax(name, e):
    mk, _, c = POW_FIELDS[name]
    rep, outs = _jax_pows(name)
    f = mk(False)
    got = f.pow_const(torch.as_tensor(rep.astype(np.int64)), _exp(e, c))
    np.testing.assert_array_equal(got.numpy(), outs[POW_EXPS.index(e)])
    vals = _ints(f.from_rep(torch.as_tensor(rep.astype(np.int64))))
    assert _ints(f.from_rep(got)) == [pow(v, _exp(e, c), f.n_int) for v in vals]


@pytest.mark.parametrize("name", sorted(POW_FIELDS))
def test_pow_kernels_field_on_cpu_runs_the_plain_loop(name):
    """A kernels=True field sends only CUDA operands to kernel G: on CPU
    tensors, [16, B] or [16, 1], it runs the plain loop and counts no
    launch; the wrapper refuses CPU tensors."""
    mk, _, c = POW_FIELDS[name]
    rep, _ = _jax_pows(name)
    a = torch.as_tensor(rep.astype(np.int64))
    before = cuda_fp.pow_const.launches
    kf = mk(True)
    e = _exp("(p+1)/4", c)
    assert torch.equal(kf.pow_const(a, e), mk(False).pow_const(a, e))
    assert torch.equal(kf.pow_const(a[:, 2:3], e), mk(False).pow_const(a[:, 2:3], e))
    assert cuda_fp.pow_const.launches == before
    with pytest.raises(ValueError):
        cuda_fp.pow_const(kf, a, e)


def test_inv_batch_unwinds_one_stacked_product_a_level(monkeypatch):
    """inv_batch's unwind is one [2, 16, w] product a level, as the JAX
    field's (mul_stacked on a kernels=True field); the tree's root is one
    [16, 1] power."""
    f = fp.MontField(C.n, kernels=True)
    seen = []
    real = fp._route

    def spy(kernel, field, a, b):
        seen.append((kernel, tuple(a.shape)))
        return real(kernel, field, a, b)

    monkeypatch.setattr(fp, "_route", spy)
    rep = f.to_rep(torch.as_tensor(_pow_lanes(C.n).astype(np.int64)))
    seen.clear()
    inv = f.inv_batch(rep)
    stacked = [s for k, s in seen if k == "mul_stacked"]
    assert stacked == [(2, 16, 1), (2, 16, 2), (2, 16, 4)]
    vals = _ints(f.from_rep(rep))
    assert _ints(f.from_rep(inv)) == [pow(v, -1, C.n) if v else 0 for v in vals]


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(POW_FIELDS))
def test_pow_const_matches_pallas_interpret(name):
    mk, jf, c = POW_FIELDS[name]
    rng = np.random.default_rng(51)
    vals = [int.from_bytes(rng.bytes(32), "big") % jf.n_int for _ in range(128)]
    vals[:3] = [0, 1, jf.n_int - 1]
    rep = np.asarray(jf.to_rep(_lane_np(vals)))
    for e in ((c.p + 1) // 4, c.n - 2):
        want = pallas_fp.pow_const(jf, rep, e, interpret=True)
        got = mk(False).pow_const(torch.as_tensor(rep.astype(np.int64)), e)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


# ---------------------------------------------------------------------------
# point formulas: ec.jac_add / jac_double against pallas_ec's
# ---------------------------------------------------------------------------

def _jax_ctx(jf):
    sol = isinstance(jf, jfp.SolinasField)
    col = lambda v: jnp.asarray(v)[:, None]  # noqa: E731
    return pallas_ec.FieldCtx(jf, col(jf.limbs), None if sol else col(jf.nprime),
                              None if sol else col(jf.one_m))


def _jac(cv, pts, zs):
    """Affine points (ints, None = infinity) and Z values -> packed
    Jacobian [3, 16, B] int64 in field rep: (x z^2, y z^3, z), zeros for
    None, or (x, y, 0) when z is given as ('inf', x, y)."""
    p, f = cv.params.p, cv.fp
    cols = []
    for P, z in zip(pts, zs):
        if isinstance(z, tuple):  # Z = 0 with nonzero X and Y
            X, Y, Z = z[1], z[2], 0
        elif P is None:
            X = Y = Z = 0
        else:
            X, Y, Z = P[0] * z * z % p, P[1] * z ** 3 % p, z
        cols.append([f.encode_int(v) for v in (X, Y, Z)])
    return torch.as_tensor(np.stack([np.stack([c[i] for c in cols], axis=1)
                                     for i in range(3)]).astype(np.int64))


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_point_ops_match_pallas_ec(curve):
    """Generic, doubling (P = Q in other Z), P = -Q, P or Q at infinity,
    both, and a Z = 0 point with nonzero X and Y; against vjac_add and
    vjac_double, one jit a curve."""
    cv, jcv = CURVES[curve]
    c = cv.params
    G = (c.gx, c.gy)
    A, B2 = refimpl.ec_mul(c, 5, G), refimpl.ec_mul(c, 11, G)
    negA = (A[0], c.p - A[1])
    P_pts = [A, A, A, None, A, None, None, B2]
    Q_pts = [B2, A, negA, A, None, None, B2, A]
    P_z = [3, 7, 2, 1, 5, 1, ("inf", 9, 4), 2]
    Q_z = [5, 13, 6, 4, 1, 1, 3, ("inf", 8, 3)]
    P, Q = _jac(cv, P_pts, P_z), _jac(cv, Q_pts, Q_z)
    ctx = _jax_ctx(jcv.fp)
    fn = jax.jit(lambda p, q: (
        pallas_ec.vjac_add(ctx, p, q, jcv.a_is_zero, jcv.a_is_minus3),
        pallas_ec.vjac_double(ctx, p, jcv.a_is_zero, jcv.a_is_minus3)))
    jadd, jdbl = fn(P.numpy().astype(np.uint32), Q.numpy().astype(np.uint32))
    np.testing.assert_array_equal(ec.jac_add(cv, P, Q).numpy(), np.asarray(jadd).astype(np.int64))
    np.testing.assert_array_equal(ec.jac_double(cv, P).numpy(),
                                  np.asarray(jdbl).astype(np.int64))
    # the cases did occur: lane 1 doubled, lane 2 cancelled to zeros
    out = ec.jac_add(cv, P, Q)
    assert not out[:, :, 2].any() and out[2, :, 1].any()


# ---------------------------------------------------------------------------
# kernel H's plain version: ladder_plain
# ---------------------------------------------------------------------------

class _IntField:
    """A field on Python ints in the port's rep (Montgomery: a R mod p)."""

    def __init__(self, f):
        self.p = f.n_int
        self.rinv = pow(1 << 256, -1, self.p) if isinstance(f, fp.MontField) else 1
        self.one = bigint.from_limbs(f.encode_int(1))

    def mul(self, a, b):
        return a * b * self.rinv % self.p

    def add(self, a, b):
        return (a + b) % self.p

    def sub(self, a, b):
        return (a - b) % self.p

    def neg(self, a):
        return (-a) % self.p


def _mirror_double(F, P, a_zero):
    X, Y, Z = P
    if a_zero:
        M = 3 * F.mul(X, X) % F.p
    else:
        ZZ = F.mul(Z, Z)
        M = 3 * F.mul(F.sub(X, ZZ), F.add(X, ZZ)) % F.p
    YY = F.mul(Y, Y)
    S4 = 4 * F.mul(X, YY) % F.p
    X3 = F.sub(F.mul(M, M), 2 * S4 % F.p)
    Y3 = F.sub(F.mul(M, F.sub(S4, X3)), 8 * F.mul(YY, YY) % F.p)
    return X3, Y3, F.mul(F.add(Y, Y), Z)


def _mirror_add(F, P, Q, a_zero):
    """pallas_ec.vjac_add's selection: P = inf -> Q, Q = inf -> P, then
    doubling or zeros when H = 0, else the generic sum."""
    (X1, Y1, Z1), (X2, Y2, Z2) = P, Q
    if Z1 == 0:
        return Q
    if Z2 == 0:
        return P
    U1, U2 = F.mul(X1, F.mul(Z2, Z2)), F.mul(X2, F.mul(Z1, Z1))
    S1 = F.mul(F.mul(Y1, Z2), F.mul(Z2, Z2))
    S2 = F.mul(F.mul(Y2, Z1), F.mul(Z1, Z1))
    H, R = F.sub(U2, U1), F.sub(S2, S1)
    if H == 0:
        return _mirror_double(F, P, a_zero) if R == 0 else (0, 0, 0)
    HH = F.mul(H, H)
    HHH, V = F.mul(H, HH), F.mul(U1, HH)
    X3 = F.sub(F.sub(F.mul(R, R), HHH), F.add(V, V))
    Y3 = F.sub(F.mul(R, F.sub(V, X3)), F.mul(S1, HHH))
    return X3, Y3, F.mul(F.mul(Z1, Z2), H)


def _ladder_mirror(cv, nsteps, gts, digs, negs, q_planes):
    """pallas_ec.ladder_values on Python ints, lane by lane -> [3][B]."""
    F, a0 = _IntField(cv.fp), cv.a_is_zero
    n_pairs, B = gts.shape[0], q_planes.shape[-1]
    g = [[(bigint.from_limbs(gts[p, k, :16]), bigint.from_limbs(gts[p, k, 16:]))
          for k in range(16)] for p in range(n_pairs)]
    qp = [[_ints(q_planes[p, i]) for i in range(2)] for p in range(n_pairs)]
    out = [[], [], []]
    for lane in range(B):
        tables = []
        for p in range(n_pairs):
            q1 = (qp[p][0][lane], qp[p][1][lane], F.one)
            t = [(0, 0, 0), q1]
            for _ in range(14):
                t.append(_mirror_add(F, t[-1], q1, a0))
            tables.append(t)
        acc = (0, 0, 0)
        for r in range(nsteps):
            for _ in range(4):
                acc = _mirror_double(F, acc, a0)
            for p in range(n_pairs):
                d = int(digs[2 * p, r, lane])
                gx, gy = g[p][d]
                if negs[2 * p, lane]:
                    gy = F.neg(gy)
                acc = _mirror_add(F, acc, (gx, gy, F.one) if d else (0, 0, 0), a0)
                X, Y, Z = tables[p][int(digs[2 * p + 1, r, lane])]
                if negs[2 * p + 1, lane]:
                    Y = F.neg(Y)
                acc = _mirror_add(F, acc, (X, Y, Z), a0)
        for i in range(3):
            out[i].append(acc[i])
    return out


def _ladder_case(cv, seed: int, n: int = 16):
    """vectors.ladder_lanes through ec.ladder_inputs, the sign flags of
    lanes 9, 13 and 15 flipped -> (operands, k1, k2, qx, qy, flipped)."""
    c, f = cv.params, cv.fp
    k1, k2, qx, qy = vectors.ladder_lanes(c, n, seed)
    ops = ec.ladder_inputs(cv, _lane(k1), _lane(k2), f.to_rep(_lane(qx)), f.to_rep(_lane(qy)))
    nsteps, gts, digs, negs, qp = ops
    flipped = [9, 13, 15]
    negs = negs.clone()
    negs[:, flipped] ^= 1
    return (nsteps, gts, digs, negs, qp), k1, k2, qx, qy, flipped


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_ladder_plain_matches_mirror_and_oracle(curve):
    """ladder_plain's Jacobian limbs equal the transcription of
    ladder_values on every lane (off-curve Q and flipped flags included);
    in affine form they equal k1 G + k2 Q by refimpl on every on-curve
    lane with its split's own flags."""
    cv, _ = CURVES[curve]
    c, f = cv.params, cv.fp
    ops, k1, k2, qx, qy, flipped = _ladder_case(cv, 60)
    got = ec.ladder_plain(cv, *ops)
    want = _ladder_mirror(cv, *ops)
    for i in range(3):
        assert _ints(got[i]) == want[i], ("XYZ"[i], curve)
    X, Y, Z = (_ints(f.from_rep(got[i])) for i in range(3))
    checked = 0
    for i in range(len(k1)):
        if i == 5 or i in flipped:
            continue
        pt = refimpl.ec_add(c, refimpl.ec_mul(c, k1[i], (c.gx, c.gy)),
                            refimpl.ec_mul(c, k2[i], (qx[i], qy[i])))
        if Z[i] == 0:
            assert pt is None, i
        else:
            zi = pow(Z[i], -1, c.p)
            assert (X[i] * zi * zi % c.p, Y[i] * zi ** 3 % c.p) == pt, i
        checked += 1
    assert checked == 12
    assert [i for i in range(len(k1)) if Z[i] == 0] == [2, 4, 8]  # 0, G - G, G - G
    # lane 5's Q table holds Z = 0 entries with nonzero X and Y
    tq = ec._q_window_table(cv, ops[4][0, 0], ops[4][0, 1])
    zero_z = [k for k in range(1, 16) if not tq[k, 2, :, 5].any()]
    assert zero_z and all(tq[k, :2, :, 5].any() for k in zero_z)


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_edge_lanes_reach_the_g_add_doubling_and_cancellation(curve):
    """Lanes 7 and 8 of ec.LADDER_EDGES: the only nonzero digits are the
    last two steps' (G: 1, 1; Q: 1, 0; flags clear), so the last G add
    meets an accumulator 16 (G + Q) = G (the doubling) and -G (the
    cancellation); the ladder gives 2G and infinity."""
    cv, _ = CURVES[curve]
    c, f = cv.params, cv.fp
    k1, k2, qx, qy = vectors.ladder_lanes(c, 9, 63)
    assert len(ec.LADDER_EDGES) == 9
    nsteps, gts, digs, negs, qp = ops = ec.ladder_inputs(
        cv, _lane(k1), _lane(k2), f.to_rep(_lane(qx)), f.to_rep(_lane(qy)))
    G = (c.gx, c.gy)
    for j, meets in ((7, G), (8, (c.gx, c.p - c.gy))):
        gq = refimpl.ec_add(c, G, (qx[j], qy[j]))
        assert refimpl.ec_mul(c, 16, gq) == meets, j
        d = digs[:, :, j]
        assert d[0, -2:].tolist() == [1, 1] and d[1, -2:].tolist() == [1, 0], j
        assert not d[:, :-2].any() and not d[2:].any() and not negs[:, j].any(), j
    X, Y, Z = (_ints(f.from_rep(t)) for t in ec.ladder_plain(cv, *ops))
    zi = pow(Z[7], -1, c.p)
    assert (X[7] * zi * zi % c.p, Y[7] * zi ** 3 % c.p) == refimpl.ec_mul(c, 2, G)
    assert Z[8] == 0


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_ladder_inputs_match_jax(curve):
    """The ladder's operands as the JAX package builds them for
    pallas_ec.ladder (fisco_bcos_tpu/ops/ec.py:321-330 and 416-427)."""
    cv, jcv = CURVES[curve]
    c = cv.params
    k1, k2, qx, qy = vectors.ladder_lanes(c, 16, 61)
    qxr, qyr = np.asarray(jcv.fp.to_rep(_lane_np(qx))), np.asarray(jcv.fp.to_rep(_lane_np(qy)))
    nsteps, gts, digs, negs, qp = ec.ladder_inputs(
        cv, _lane(k1), _lane(k2), torch.as_tensor(qxr.astype(np.int64)),
        torch.as_tensor(qyr.astype(np.int64)))
    if cv.has_endo:
        a1, s1, a2, s2 = jec._glv_split_device(jcv, _lane_np(k1))
        b1, t1, b2, t2 = jec._glv_split_device(jcv, _lane_np(k2))
        d = lambda m: np.asarray(jfp.window_digits(m, 4))[:34][::-1]  # noqa: E731
        jdigs = np.stack([d(a1), d(b1), d(a2), d(b2)])
        jnegs = np.stack([s1, t1, s2, t2]).astype(np.int32)
        qlx = np.asarray(jcv.fp.mul(qxr, jfp._col(jcv.beta_rep)))
        jq = np.stack([np.stack([qxr, qyr]), np.stack([qlx, qyr])])
        jgts = np.stack([jcv.g_table, jcv.g_table_endo])
    else:
        d = lambda m: np.asarray(jfp.window_digits(m, 4))[::-1]  # noqa: E731
        jdigs = np.stack([d(_lane_np(k1)), d(_lane_np(k2))])
        jnegs = np.zeros((2, len(k1)), np.int32)
        jq = np.stack([qxr, qyr])[None]
        jgts = np.asarray(jcv.g_table)[None]
    assert nsteps == jdigs.shape[1]
    np.testing.assert_array_equal(digs.numpy(), jdigs.astype(np.int32))
    np.testing.assert_array_equal(negs.numpy(), jnegs)
    np.testing.assert_array_equal(qp.numpy(), jq.astype(np.int64))
    np.testing.assert_array_equal(gts.numpy(), jgts.astype(np.int64))


@pytest.mark.slow
@pytest.mark.parametrize("curve", sorted(CURVES))
def test_ladder_plain_matches_pallas_interpret(curve):
    """Jacobian bit-exact against the JAX ladder kernel itself, in
    interpret mode at one 128-lane block (its smallest)."""
    cv, jcv = CURVES[curve]
    ops, *_ = _ladder_case(cv, 62, n=128)
    nsteps, gts, digs, negs, qp = ops
    want = pallas_ec.ladder(jcv.fp, jcv.a_is_zero, jcv.a_is_minus3, nsteps,
                            gts.numpy().astype(np.uint32), digs.numpy().astype(np.uint32),
                            negs.numpy().astype(np.uint32), qp.numpy().astype(np.uint32),
                            interpret=True)
    np.testing.assert_array_equal(ec.ladder_plain(cv, *ops).numpy(),
                                  np.asarray(want).astype(np.int64))


# ---------------------------------------------------------------------------
# the composed route on the CPU
# ---------------------------------------------------------------------------

KEYS = ("e", "r", "s", "qx", "qy")


def _ecdsa_vectors():
    """32 lanes: every corruption of signed_vectors (r = 0, s = n, v = 4,
    digest, off-curve key, s = 0, v ^ 2, key (0, 0)) and the ladder
    collisions (key +-G, e = +-r)."""
    return vectors.signed_vectors(29, tag=31) + vectors.collision_vectors()


def test_composed_verify_matches_fused_and_oracle():
    vs = _ecdsa_vectors()
    args = [vectors.limbs([d[k] for d in vs]) for k in KEYS]
    got = ec.ecdsa_verify_batch(ec.SECP256K1, *args, route="composed")
    assert got.tolist() == ec.ecdsa_verify_batch(ec.SECP256K1, *args).tolist()
    want = [refimpl.ecdsa_verify(C, (d["qx"], d["qy"]), d["e"].to_bytes(32, "big"),
                                 d["r"], d["s"]) for d in vs]
    assert got.tolist() == want and any(want) and not all(want)


def test_composed_recover_matches_fused_and_oracle():
    vs = _ecdsa_vectors()
    args = [vectors.limbs([d[k] for d in vs]) for k in "ers"]
    v = torch.tensor([d["v"] for d in vs])
    qx, qy, ok = ec.ecdsa_recover_batch(ec.SECP256K1, *args, v, route="composed")
    fx, fy, fok = ec.ecdsa_recover_batch(ec.SECP256K1, *args, v)
    assert torch.equal(qx, fx) and torch.equal(qy, fy) and torch.equal(ok, fok)
    for i, d in enumerate(vs):
        Q = refimpl.ecdsa_recover(C, d["e"].to_bytes(32, "big"), d["r"], d["s"], d["v"])
        got = (bigint.from_limbs(qx[i].numpy()), bigint.from_limbs(qy[i].numpy()))
        assert (got if ok[i] else None) == Q, i
    assert ok.any() and not ok.all()


def test_composed_sm2_verify_matches_fused_and_oracle():
    """Every SM2 corruption (r = 0, s >= n, s = n - r so t = 0, digest,
    another key, off-curve key, key (0, 0), qx >= p) and the collision
    keys +-2G."""
    vs = vectors.sm2_vectors(30, tag=32) + vectors.sm2_collision_vectors()
    args = [vectors.limbs([d[k] for d in vs]) for k in KEYS]
    got = ec.sm2_verify_batch(ec.SM2P256V1, *args, route="composed")
    assert got.tolist() == ec.sm2_verify_batch(ec.SM2P256V1, *args).tolist()
    want = [vectors.sm2_verifies(d) for d in vs]
    assert got.tolist() == want
    assert want.count(False) == len(vectors.SM2_CORRUPTIONS)


def test_composed_route_on_cpu_launches_nothing_and_routes_are_checked():
    before = (cuda_ec.ladder.launches, cuda_fp.pow_const.launches, cuda_fp.mul.launches)
    vs = vectors.sm2_vectors(2, tag=33)
    args = [vectors.limbs([d[k] for d in vs]) for k in KEYS]
    assert ec.sm2_verify_batch(ec.SM2P256V1, *args, route="composed").tolist() == [True, False]
    assert (cuda_ec.ladder.launches, cuda_fp.pow_const.launches,
            cuda_fp.mul.launches) == before
    for cv in (ec.SECP256K1, ec.SM2P256V1):
        assert cv.composed.fp.kernels and cv.composed.fn.kernels
        assert not cv.fp.kernels and not cv.fn.kernels
        assert cv.composed.fp.n_int == cv.fp.n_int and cv.composed.fn.n_int == cv.fn.n_int
    with pytest.raises(ValueError, match="route"):
        ec.sm2_verify_batch(ec.SM2P256V1, *args, route="xla")
    with pytest.raises(ValueError, match="route"):
        psuite.make_suite(device="cpu", ec_route="pallas")
    with pytest.raises(ValueError):
        cuda_ec.ladder(ec.SECP256K1, 34, *(torch.zeros(1) for _ in range(4)))


@pytest.mark.slow
def test_composed_route_matches_jax_batch():
    vs = _ecdsa_vectors()[:8]
    rows = {k: bigint.batch_to_limbs([d[k] for d in vs]) for k in KEYS}
    t = {k: torch.as_tensor(v.astype(np.int64)) for k, v in rows.items()}
    want = np.asarray(jec.ecdsa_verify_batch(jec.SECP256K1, *(rows[k] for k in KEYS)))
    got = ec.ecdsa_verify_batch(ec.SECP256K1, *(t[k] for k in KEYS), route="composed")
    assert got.tolist() == want.tolist()
    v = np.array([d["v"] for d in vs], np.uint32)
    jx, jy, jok = jec.ecdsa_recover_batch(jec.SECP256K1, rows["e"], rows["r"], rows["s"], v)
    qx, qy, ok = ec.ecdsa_recover_batch(ec.SECP256K1, t["e"], t["r"], t["s"],
                                        torch.as_tensor(v.astype(np.int64)), route="composed")
    assert ok.tolist() == np.asarray(jok).tolist()
    np.testing.assert_array_equal(qx.numpy(), np.asarray(jx).astype(np.int64))
    np.testing.assert_array_equal(qy.numpy(), np.asarray(jy).astype(np.int64))
    sv = vectors.sm2_vectors(8, tag=34)
    srows = [bigint.batch_to_limbs([d[k] for d in sv]) for k in KEYS]
    want = np.asarray(jec.sm2_verify_batch(jec.SM2P256V1, *srows))
    got = ec.sm2_verify_batch(ec.SM2P256V1, *(torch.as_tensor(r.astype(np.int64))
                                              for r in srows), route="composed")
    assert got.tolist() == want.tolist()
