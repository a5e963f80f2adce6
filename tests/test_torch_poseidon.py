"""The port's ZK plane (fisco_bcos_tpu_torch.zk: the Poseidon oracle copy,
the batched tensor path, Poseidon-Merkle trees and the suite's
poseidon_batch) against the JAX package's, bit-exact (tolerance 0: field
arithmetic), on the CPU in the 128 and 512 buckets. Byte strings cross
between the two packages; no tensor does."""

import numpy as np
import pytest
import torch

from fisco_bcos_tpu.crypto import suite as jsuite
from fisco_bcos_tpu.zk import merkle as jmerkle
from fisco_bcos_tpu.zk import poseidon as jref
from fisco_bcos_tpu.zk import poseidon_jax as pj
from fisco_bcos_tpu_torch.crypto import suite as psuite
from fisco_bcos_tpu_torch.ops import cuda_fp, fp
from fisco_bcos_tpu_torch.zk import merkle, poseidon, poseidon_torch as pt


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These tests run thousands of small tensor ops: one intra-op thread,
    so that test workers sharing the cores do not stall at every op's
    thread barrier."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the published poseidonperm_x5_254_3 vector and first round constant, as
# tests/test_zk_poseidon.py pins them for the JAX package
PINNED_PERM_012 = [
    0x115CC0F5E7D690413DF64C6B9662E9CF2A3617F2743245519E19607A4417189A,
    0x0FCA49B798923AB0239DE1C9E7A4A9A2210312B6A2F616D18B5A87F9B628AE29,
    0x0E7AE82E40091E63CBD4F16A6D16310B3729D4B6E138FCF54110E2867045A30C,
]
PINNED_RC0 = 0x0EE9A592BA9A9518D05986D656F40C2114C4993C11BB29938D21D47304CD8E6E
ZERO, ONES = b"\x00" * 32, b"\xff" * 32


def _pairs(n: int, seed: int):
    rng = np.random.default_rng(seed)
    lefts = [rng.bytes(32) for _ in range(n)]
    rights = [rng.bytes(32) for _ in range(n)]
    lefts[0], rights[0] = ZERO, ONES
    if n > 1:
        lefts[-1], rights[-1] = ONES, ZERO
    return lefts, rights


def _cpu_suite(**kw):
    return psuite.make_suite(device="cpu", **kw)


@pytest.fixture
def routes(monkeypatch):
    """Count the fp products by the kernel they route to (on the CPU each
    runs its plain version, so no launch counter moves)."""
    seen = {"mul": 0, "mul_stacked": 0, "mul_const": 0}
    route = fp._route

    def counting(kernel, field, a, b):
        seen[kernel] += 1
        return route(kernel, field, a, b)

    monkeypatch.setattr(fp, "_route", counting)
    return seen


def test_oracle_copy_is_pinned_and_equals_jax():
    assert poseidon.permute([0, 1, 2]) == PINNED_PERM_012
    rc, mds = poseidon.params()
    assert rc[0] == PINNED_RC0
    assert (rc, mds) == jref.params()
    assert (poseidon.P, poseidon.T, poseidon.R_F, poseidon.R_P) == (
        jref.P, jref.T, jref.R_F, jref.R_P)
    a, b = _pairs(3, 1)
    assert poseidon.hash2_batch_host(a, b) == jref.hash2_batch_host(a, b)


def test_schedule_and_limb_plumbing_match_jax():
    assert pt.BUCKETS == pj.BUCKETS and pt.CHUNK == pj.CHUNK
    for got, want in zip(pt._consts(), pj._consts()):
        np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64))
    vals = _pairs(130, 7)[0]
    np.testing.assert_array_equal(pt.bytes_to_limbs(vals), pj.bytes_to_limbs(vals))
    assert pt.limbs_to_bytes(pt.bytes_to_limbs(vals)) == vals
    for n in (1, 128, 129, 65536):
        assert pt._bucket(n) == pj._bucket(n)


@pytest.mark.parametrize("n", [1, 3, 126, 129])
def test_hash2_batch_matches_jax(n):
    """1, 3 and 126 pad into the 128 bucket, 129 into 512; random 256-bit
    inputs mostly exceed r, and the 00..00 / ff..ff edges ride along."""
    lefts, rights = _pairs(n, n)
    got = pt.hash2_batch(lefts, rights, device="cpu")
    assert got == pj.hash2_batch(lefts, rights)
    assert got[:3] == poseidon.hash2_batch_host(lefts[:3], rights[:3])


def test_hash2_batch_over_two_chunks(monkeypatch, routes):
    lefts, rights = _pairs(200, 5)
    monkeypatch.setattr(pt, "CHUNK", 128)
    assert pt.hash2_batch(lefts, rights, device="cpu") == pj.hash2_batch(lefts, rights)
    assert routes == {k: 2 * v for k, v in pt.LAUNCHES_PER_CHUNK.items()}


def test_products_per_chunk_route_as_the_jax_path(routes):
    """171 mul (57 partial rounds x 3 S-box products), 90 mul_stacked
    (8 full rounds x (3 S-box + 1 MDS) + 57 MDS + 1 to_rep) and 1
    mul_const (from_rep), as fisco_bcos_tpu/zk/poseidon_jax.py's
    multiplies reach pallas_fp."""
    assert pt.LAUNCHES_PER_CHUNK == {"mul": 171, "mul_stacked": 90, "mul_const": 1}
    before = (cuda_fp.mul.launches, cuda_fp.mul_stacked.launches,
              cuda_fp.mul_const.launches)
    lefts, rights = _pairs(5, 9)
    assert pt.hash2_batch(lefts, rights, device="cpu") == poseidon.hash2_batch_host(
        lefts, rights)
    assert routes == pt.LAUNCHES_PER_CHUNK
    assert (cuda_fp.mul.launches, cuda_fp.mul_stacked.launches,
            cuda_fp.mul_const.launches) == before  # CPU tensors launch nothing


def test_plain_path_equals_routed_path_on_cpu(routes):
    lefts, rights = _pairs(4, 10)
    plain = pt.hash2_batch(lefts, rights, device="cpu", plain=True)
    assert sum(routes.values()) == 0
    assert plain == pt.hash2_batch(lefts, rights, device="cpu")
    assert pt.field(kernels=False).kernels is False and pt.field().kernels is True


def _tampered(levels, leaves, root):
    """A leaf, a sibling and the root tampered, one proof each."""
    flip = lambda b: bytes([b[0] ^ 1]) + b[1:]  # noqa: E731
    out = []
    if len(levels) > 1:
        p = merkle.proof_from_levels(levels, 0)
        out.append((flip(leaves[0]), p, root))
        left, right, pos = p[0]
        p2 = [(left, flip(right), pos) if pos == 0 else (flip(left), right, pos)] + p[1:]
        out.append((leaves[0], p2, root))
    out.append((leaves[-1], merkle.proof_from_levels(levels, len(leaves) - 1), flip(root)))
    return out


@pytest.mark.parametrize("n", [1, 2, 3, 13, 130])
def test_merkle_with_poseidon_batch_matches_jax(n):
    rng = np.random.default_rng(100 + n)
    leaves = [rng.bytes(32) for _ in range(n)]
    leaves[0] = ONES  # above r: canonicalized on entry
    suite = _cpu_suite()
    levels = merkle.build_levels(leaves, hasher=suite.poseidon_batch)
    jlevels = jmerkle.build_levels(leaves, hasher=pj.hash2_batch)
    assert levels == jlevels
    root = levels[-1][0]
    idx = sorted({0, n // 2, n - 1} | set(range(0, n, max(1, n // 8))))[:12]
    items = [(leaves[i], merkle.proof_from_levels(levels, i), root) for i in idx]
    items += _tampered(levels, leaves, root)
    got = merkle.verify_batch(items, hasher=suite.poseidon_batch)
    want = jmerkle.verify_batch(items, hasher=pj.hash2_batch)
    assert got.tolist() == want.tolist()
    assert got.tolist() == [True] * len(idx) + [False] * (len(items) - len(idx))
    doc = merkle.proof_json(items[0][1])
    assert doc == jmerkle.proof_json(items[0][1])
    assert merkle.proof_from_json(doc) == items[0][1]


@pytest.mark.parametrize("backend,min_batch,n", [
    ("host", 512, 600), ("device", 512, 1), ("auto", 4, 3), ("auto", 4, 4),
    ("auto", 512, 0)])
def test_poseidon_batch_gating_matches_jax(monkeypatch, backend, min_batch, n):
    calls = []
    monkeypatch.setattr(poseidon, "hash2_batch_host",
                        lambda a, b: calls.append(("port", "host")) or [ZERO] * len(a))
    monkeypatch.setattr(pt, "hash2_batch",
                        lambda a, b, device: calls.append(("port", "device")) or [ZERO] * len(a))
    monkeypatch.setattr(jref, "hash2_batch_host",
                        lambda a, b: calls.append(("jax", "host")) or [ZERO] * len(a))
    monkeypatch.setattr(pj, "hash2_batch",
                        lambda a, b: calls.append(("jax", "device")) or [ZERO] * len(a))
    lefts, rights = [ZERO] * n, [ONES] * n
    port = _cpu_suite(backend=backend, device_min_batch=min_batch)
    ref = jsuite.CryptoSuite(backend=backend, device_min_batch=min_batch)
    assert port.poseidon_batch(lefts, rights) == ref.poseidon_batch(lefts, rights)
    assert [c[1] for c in calls if c[0] == "port"] == [c[1] for c in calls if c[0] == "jax"]
    assert len(calls) == (2 if n else 0)


def test_poseidon_batch_edges_and_no_card():
    suite = _cpu_suite()
    assert suite.poseidon_batch([], []) == []
    with pytest.raises(ValueError):
        suite.poseidon_batch([ZERO], [])
    r = poseidon.P
    vals = [(r - 1).to_bytes(32, "big"), r.to_bytes(32, "big"), (r + 1).to_bytes(32, "big")]
    assert suite.poseidon_batch(vals, vals[::-1]) == poseidon.hash2_batch_host(vals, vals[::-1])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            psuite.make_suite().poseidon_batch([ZERO], [ZERO])
