"""The port's CUDA kernels (slice 1: recover, verify, Keccak, the Keccak
Merkle tree; the SM chain: SM3, the SM3 Merkle tree, SM2 verify; the ZK
plane: the standalone field multiplies under batched Poseidon; the
composed EC route: the pow and ladder kernels) against their plain
PyTorch versions, on the card. Marked `cuda`; every test skips (inside the fixture) where
torch.cuda.is_available() is false. On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerance: bit-exact everywhere (integer crypto).
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from fisco_bcos_tpu_torch.crypto import refimpl
from fisco_bcos_tpu_torch.crypto.suite import make_suite
from fisco_bcos_tpu_torch.ops import (bigint, cuda_ec, cuda_fp, cuda_hash, cuda_merkle,
                                      cuda_sm3, cuda_verify, ec, fp, keccak, merkle, sm3)
from fisco_bcos_tpu_torch.zk import poseidon, poseidon_torch
import test_torch_vectors as vectors  # tests/ is on sys.path under pytest

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _lane(xs, dev):
    return torch.as_tensor(bigint.batch_to_limbs(xs).astype(np.int64),
                           device=dev).T.contiguous()


def _vectors():
    return vectors.signed_vectors(24, tag=9) + vectors.collision_vectors()


def test_recover_kernel_matches_plain_and_oracle(dev):
    vs = _vectors() + vectors.ecdsa_edge_lanes()[0]
    e, r, s = (_lane([d[k] for d in vs], dev) for k in "ers")
    v = torch.tensor([d["v"] for d in vs], device=dev)
    qx, qy, ok = cuda_verify.ecdsa_recover(e, r, s, v)
    px, py, pok = ec.ecdsa_recover_plain(ec.SECP256K1, e, r, s, v)
    assert torch.equal(ok.bool(), pok)
    assert torch.equal(qx.long(), px) and torch.equal(qy.long(), py)
    for i, d in enumerate(vs):
        Q = refimpl.ecdsa_recover(refimpl.SECP256K1, d["e"].to_bytes(32, "big"),
                                  d["r"], d["s"], d["v"])
        got = (bigint.from_limbs(qx[:, i].cpu()), bigint.from_limbs(qy[:, i].cpu()))
        assert (got if ok[i] else None) == Q, i


def test_verify_kernel_matches_plain_and_oracle(dev):
    vs = _vectors() + vectors.ecdsa_edge_lanes()[1]
    args = [_lane([d[k] for d in vs], dev) for k in ("e", "r", "s", "qx", "qy")]
    ok = cuda_verify.ecdsa_verify(*args)
    assert torch.equal(ok.bool(), ec.ecdsa_verify_plain(ec.SECP256K1, *args))
    ref = [refimpl.ecdsa_verify(refimpl.SECP256K1, (d["qx"], d["qy"]),
                                d["e"].to_bytes(32, "big"), d["r"], d["s"])
           for d in vs]
    assert ok.bool().tolist() == ref


def test_keccak_kernel_matches_plain(dev):
    rng = np.random.default_rng(3)
    lens = [0, 1, 135, 136, 137, 271, 272, 1000] + list(rng.integers(0, 1200, 56))
    msgs = [bytes(rng.integers(0, 256, int(n), dtype=np.uint8)) for n in lens]
    blocks, nvalid = keccak.pad_batch_np(msgs)
    b, nv = torch.as_tensor(blocks, device=dev), torch.as_tensor(nvalid, device=dev)
    got = cuda_hash.keccak256_varlen(b, nv)
    assert torch.equal(got, keccak.keccak256_varlen_plain(b, nv))
    assert [bytes(x) for x in got.cpu().numpy()] == [refimpl.keccak256(m) for m in msgs]


@pytest.mark.parametrize("B", [1, 129, 513])
def test_keccak_kernel_length_order_edges(dev, B):
    """The length-ordered kernel at B not a multiple of its 256-thread
    blocks, on mixed lengths with nvalid of -1, 0 and above nblocks
    (clamped to [0, nblocks], as the plain version masks), against
    keccak256_varlen_plain and, where nvalid is the message's own,
    refimpl."""
    rng = np.random.default_rng(B)
    msgs = [rng.bytes(int(n)) for n in rng.integers(0, 4 * 136, B)]
    blocks, nvalid = keccak.pad_batch_np(msgs)
    own = nvalid.copy()
    tweak = rng.integers(0, 4, B)
    nvalid[tweak == 1] = -1
    nvalid[tweak == 2] = 0
    nvalid[tweak == 3] = blocks.shape[1] + 5
    if B == 1:
        nvalid[0] = own[0]
    b, nv = torch.as_tensor(blocks, device=dev), torch.as_tensor(nvalid, device=dev)
    n0 = cuda_hash.keccak256_varlen.launches
    got = cuda_hash.keccak256_varlen(b, nv)
    assert cuda_hash.keccak256_varlen.launches == n0 + 1
    assert torch.equal(got, keccak.keccak256_varlen_plain(b, nv))
    clamped = np.clip(nvalid, 0, blocks.shape[1])
    for i in np.flatnonzero(clamped == own):
        assert bytes(got[i].cpu().numpy()) == refimpl.keccak256(msgs[i]), i
    assert not got[torch.as_tensor(clamped == 0, device=dev)].any()


def test_keccak_kernel_one_block_keys(dev):
    """The address hash's shape: equal 64-byte one-block messages."""
    rng = np.random.default_rng(7)
    msgs = [rng.bytes(64) for _ in range(3000)]
    blocks, nvalid = keccak.pad_batch_np(msgs)
    b, nv = torch.as_tensor(blocks, device=dev), torch.as_tensor(nvalid, device=dev)
    got = cuda_hash.keccak256_varlen(b, nv)
    assert [bytes(x) for x in got.cpu().numpy()] == [refimpl.keccak256(m) for m in msgs]


# the host harness's tree sizes (tests/test_torch_csrc_host.py), and n = 1
MERKLE_NS = [1, 2, 15, 16, 17, 255, 256, 257, 4095, 4096, 4097, 65537]


def _plain_root(leaves: torch.Tensor, n: int, alg: str) -> torch.Tensor:
    """The plain tree over the first n rows, on the leaves' device."""
    nb = max(16, 1 << (n - 1).bit_length())
    padded = torch.zeros((nb, 32), dtype=torch.uint8, device=leaves.device)
    padded[:n] = leaves[:n]
    return merkle.merkle_root_bucketed_plain(padded, n, alg)


@pytest.mark.parametrize("n", MERKLE_NS)
@pytest.mark.parametrize("alg", ["keccak256", "sm3"])
def test_merkle_kernel_matches_plain(dev, alg, n):
    """The tree kernel of each hash, one launch a tree (none at n = 1),
    against the plain tree and, up to 4,097 leaves, merkle_levels_host."""
    rng = np.random.default_rng(n)
    leaves = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    lt = torch.as_tensor(leaves, device=dev)
    tree = cuda_merkle.TREES[alg]
    n0 = tree.launches
    got = cuda_merkle.merkle_root(lt, n, alg)
    assert tree.launches == n0 + (n > 1)
    assert torch.equal(got, _plain_root(lt, n, alg))
    if n <= 4097:
        assert bytes(got.cpu().numpy()) == merkle.merkle_levels_host(
            [bytes(x) for x in leaves], alg)[-1][0]


@pytest.mark.parametrize("n", MERKLE_NS[1:])
@pytest.mark.parametrize("alg", ["keccak256", "sm3"])
def test_merkle_kernel_reads_rows_past_n_as_zero(dev, alg, n):
    rng = np.random.default_rng(100 + n)
    leaves = torch.as_tensor(rng.integers(0, 256, (n + 24, 32), dtype=np.uint8), device=dev)
    got = cuda_merkle.merkle_root(leaves, n, alg)
    assert torch.equal(got, cuda_merkle.merkle_root(leaves[:n].contiguous(), n, alg))
    assert torch.equal(got, _plain_root(leaves, n, alg))
    if n <= 257:
        assert bytes(got.cpu().numpy()) == merkle.merkle_levels_host(
            [bytes(x) for x in leaves[:n].cpu().numpy()], alg)[-1][0]


@pytest.mark.parametrize("n", [65536, 4097])
@pytest.mark.parametrize("alg", ["keccak256", "sm3"])
def test_merkle_kernel_repeats_give_one_root(dev, alg, n):
    """100 launches on the same leaves: the arrival order differs from
    launch to launch, the root must not (a race in the arrival counters
    would show as a rare other root)."""
    lt = torch.as_tensor(np.random.default_rng(300 + n).integers(0, 256, (n, 32),
                                                                  dtype=np.uint8), device=dev)
    roots = torch.stack([cuda_merkle.merkle_root(lt, n, alg) for _ in range(100)])
    assert torch.equal(roots, _plain_root(lt, n, alg).expand(100, 32))


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    z = torch.zeros((16, 8), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        cuda_verify.ecdsa_verify(z.cpu(), z, z, z, z)
    with pytest.raises(ValueError):
        cuda_verify.ecdsa_verify(z[:8], z[:8], z[:8], z[:8], z[:8])
    with pytest.raises(ValueError):
        cuda_hash.keccak256_varlen(torch.zeros((4, 1, 100), dtype=torch.uint8,
                                               device=dev),
                                   torch.ones(4, device=dev))


def test_suite_on_card_matches_cpu_path(dev):
    vs = vectors.signed_vectors(12, tag=11)
    digests = [d["e"].to_bytes(32, "big") for d in vs]
    sigs = [d["r"].to_bytes(32, "big") + d["s"].to_bytes(32, "big")
            + bytes([d["v"] % 256]) for d in vs]
    pubs = [d["qx"].to_bytes(32, "big") + d["qy"].to_bytes(32, "big") for d in vs]
    gpu, cpu = make_suite(), make_suite(device="cpu")
    assert (gpu.verify_batch(digests, sigs, pubs)
            == cpu.verify_batch(digests, sigs, pubs)).all()
    ga, gok = gpu.recover_addresses(digests, sigs)
    ca, cok = cpu.recover_addresses(digests, sigs)
    assert ga == ca and (gok == cok).all()
    assert gpu.hash_batch(digests) == cpu.hash_batch(digests)
    assert gpu.merkle_root(digests) == cpu.merkle_root(digests)


def test_sm3_kernel_matches_plain_and_oracle(dev):
    rng = np.random.default_rng(4)
    lens = [0, 1, 55, 56, 63, 64, 119, 120, 1000] + list(rng.integers(0, 1200, 55))
    msgs = [bytes(rng.integers(0, 256, int(n), dtype=np.uint8)) for n in lens]
    blocks, nvalid = sm3.pad_batch_np(msgs)
    nvalid[3] = 0
    b, nv = torch.as_tensor(blocks, device=dev), torch.as_tensor(nvalid, device=dev)
    got = cuda_sm3.sm3_varlen(b, nv)
    assert torch.equal(got, sm3.sm3_varlen_plain(b, nv))
    want = [refimpl.sm3(m) for m in msgs]
    assert [bytes(x) for i, x in enumerate(got.cpu().numpy()) if i != 3] == want[:3] + want[4:]
    # the senders' keys' shape: equal 64-byte messages, two blocks each
    # (one length, so no block sorts), B not a multiple of a block's 256
    keys = [rng.bytes(64) for _ in range(3000)]
    blocks, nvalid = sm3.pad_batch_np(keys)
    got = cuda_sm3.sm3_varlen(torch.as_tensor(blocks, device=dev),
                              torch.as_tensor(nvalid, device=dev))
    assert [bytes(x) for x in got.cpu().numpy()] == [refimpl.sm3(m) for m in keys]


def _sm3_ragged(B: int, seed: int):
    """B messages of 3-18 blocks (the SM block's tx encodings' spread), with
    nvalid -1, 0 and above nblocks on a quarter of them each -> (messages,
    blocks, nvalid, the padded block counts)."""
    rng = np.random.default_rng(seed)
    msgs = [rng.bytes(int(n)) for n in rng.integers(120, 18 * 64 - 8, B)]
    blocks, nvalid = sm3.pad_batch_np(msgs)
    own = nvalid.copy()
    tweak = rng.integers(0, 4, B)
    nvalid[tweak == 1] = -1
    nvalid[tweak == 2] = 0
    nvalid[tweak == 3] = blocks.shape[1] + 5
    if B == 1:
        nvalid[0] = own[0]
    return msgs, blocks, nvalid, own


@pytest.mark.parametrize("B", [1, 129, 513, 65537])
def test_sm3_kernel_length_order_edges(dev, B):
    """The length-ordered kernel at B not a multiple of its blocks' 512
    messages nor of 32, on mixed lengths with nvalid of -1, 0 and above
    nblocks (clamped to [0, nblocks], as the plain version masks), against
    sm3_varlen_plain; where nvalid is the message's own, up to 64 messages
    against refimpl; where it is none, the IV."""
    msgs, blocks, nvalid, own = _sm3_ragged(B, B)
    b, nv = torch.as_tensor(blocks, device=dev), torch.as_tensor(nvalid, device=dev)
    n0 = cuda_sm3.sm3_varlen.launches
    got = cuda_sm3.sm3_varlen(b, nv)
    assert cuda_sm3.sm3_varlen.launches == n0 + 1
    assert torch.equal(got, sm3.sm3_varlen_plain(b, nv))
    clamped = np.clip(nvalid, 0, blocks.shape[1])
    for i in np.flatnonzero(clamped == own)[:64]:
        assert bytes(got[i].cpu().numpy()) == refimpl.sm3(msgs[i]), i
    iv = sm3.IV.astype(">u4").tobytes()
    assert all(bytes(x) == iv for x in got[torch.as_tensor(clamped == 0, device=dev)].cpu().numpy())


def test_sm3_kernel_repeated_launches(dev):
    """65,536 messages of 3-18 blocks in 50 launches, each bit-exact
    against sm3_varlen_plain: ranks within a length come from atomicAdd,
    so the slot a message takes varies between launches."""
    _, blocks, _, own = _sm3_ragged(65536, 11)
    b, nv = torch.as_tensor(blocks, device=dev), torch.as_tensor(own, device=dev)
    want = sm3.sm3_varlen_plain(b, nv)
    assert sum(int((cuda_sm3.sm3_varlen(b, nv) != want).any(1).sum()) for _ in range(50)) == 0


@pytest.mark.parametrize("n", [1, 2, 17, 300, 4097])
def test_merkle_sm3_kernel_matches_plain(dev, n):
    rng = np.random.default_rng(200 + n)
    leaves = rng.integers(0, 256, (n + 7, 32), dtype=np.uint8)
    lt = torch.as_tensor(leaves, device=dev)
    got = cuda_merkle.merkle_root(lt, n, "sm3")  # rows past n read as zero
    assert torch.equal(got.cpu(), merkle.merkle_root(torch.as_tensor(leaves[:n]), "sm3"))
    if n <= 300:
        assert bytes(got.cpu().numpy()) == merkle.merkle_levels_host(
            [bytes(x) for x in leaves[:n]], "sm3")[-1][0]


def test_sm2_kernel_matches_plain_and_oracle(dev):
    vs = vectors.sm2_vectors(24, tag=12) + vectors.sm2_collision_vectors()
    args = [_lane([d[k] for d in vs], dev) for k in ("e", "r", "s", "qx", "qy")]
    ok = cuda_verify.sm2_verify(*args)
    assert torch.equal(ok.bool(), ec.sm2_verify_plain(ec.SM2P256V1, *args))
    assert ok.bool().tolist() == [vectors.sm2_verifies(d) for d in vs]


def test_sm_suite_on_card_matches_cpu_path(dev):
    vs = vectors.sm2_vectors(12, tag=13)
    digests = [d["e"].to_bytes(32, "big") for d in vs]
    pubs = [d["qx"].to_bytes(32, "big") + d["qy"].to_bytes(32, "big") for d in vs]
    sigs = [d["r"].to_bytes(32, "big") + d["s"].to_bytes(32, "big") + p
            for d, p in zip(vs, pubs)]
    gpu, cpu = make_suite(sm_crypto=True), make_suite(sm_crypto=True, device="cpu")
    assert (gpu.verify_batch(digests, sigs, pubs)
            == cpu.verify_batch(digests, sigs, pubs)).all()
    ga, gok = gpu.recover_addresses(digests, sigs)
    ca, cok = cpu.recover_addresses(digests, sigs)
    assert ga == ca and (gok == cok).all() and gok.any()
    assert gpu.hash_batch(digests) == cpu.hash_batch(digests)
    assert gpu.merkle_root(digests) == cpu.merkle_root(digests)


# -- kernels D, E, F: the standalone field multiplies (csrc/fp.cu) ----------

FP_FIELDS = {
    "bn254_r": (fp.MontField, poseidon.P),
    "secp_p": (fp.SolinasField, refimpl.SECP256K1.p),
    "secp_n": (fp.MontField, refimpl.SECP256K1.n),
    "sm2_p": (fp.MontField, refimpl.SM2P256V1.p),
    "sm2_n": (fp.MontField, refimpl.SM2P256V1.n),
}


def _fp_lanes(mod, B, seed, dev, loose=False):
    """B seeded canonical lanes, edge lanes 0, 1, n - 1 and R mod n first;
    loose=True puts values in [min(2n, n), 2^256) in every eighth lane."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "big") % mod for _ in range(B)]
    vals[:4] = [0, 1, mod - 1, (1 << 256) % mod]
    if loose:
        lo = min(2 * mod, (1 << 256) - 1)
        for i in range(7, B, 8):
            vals[i] = lo + int.from_bytes(rng.bytes(32), "big") % ((1 << 256) - lo)
    return _lane(vals, dev)


@pytest.mark.parametrize("name", sorted(FP_FIELDS))
def test_fp_kernels_match_plain(dev, name):
    mk, mod = FP_FIELDS[name]
    f = mk(mod)
    B = 4096
    a, b = _fp_lanes(mod, B, 1, dev, loose=True), _fp_lanes(mod, B, 2, dev)
    n0 = (cuda_fp.mul.launches, cuda_fp.mul_const.launches, cuda_fp.mul_stacked.launches)
    assert torch.equal(cuda_fp.mul(f, a, b), f.mul_plain(a, b))
    c = b[:, 5:6].contiguous()
    assert torch.equal(cuda_fp.mul_const(f, a, c), f.mul_plain(a, c))
    a3 = torch.stack([a, b, a.flip(-1)])
    b3 = torch.stack([b, b.flip(-1), b]).contiguous()
    assert torch.equal(cuda_fp.mul_stacked(f, a3, b3), f.mul_plain(a3, b3))
    assert (cuda_fp.mul.launches, cuda_fp.mul_const.launches,
            cuda_fp.mul_stacked.launches) == tuple(x + 1 for x in n0)


def test_poseidon_batch_on_card_matches_plain_and_oracle(dev):
    rng = np.random.default_rng(41)
    lefts = [rng.bytes(32) for _ in range(4096)]
    rights = [rng.bytes(32) for _ in range(4096)]
    lefts[0], rights[0] = b"\x00" * 32, b"\xff" * 32
    counters = (cuda_fp.mul, cuda_fp.mul_stacked, cuda_fp.mul_const)
    for fn in counters:
        fn.launches = 0
    got = make_suite().poseidon_batch(lefts, rights)
    assert [fn.launches for fn in counters] == [
        poseidon_torch.LAUNCHES_PER_CHUNK[k] for k in ("mul", "mul_stacked", "mul_const")]
    assert got == poseidon_torch.hash2_batch(lefts, rights, device=dev, plain=True)
    assert got[:16] == poseidon.hash2_batch_host(lefts[:16], rights[:16])


def test_fp_wrappers_reject_what_the_kernels_do_not_take(dev):
    f = fp.MontField(poseidon.P, kernels=True)
    a = torch.zeros((16, 8), dtype=torch.int64, device=dev)
    bad = {"dtype": a.int(), "shape": a[:8].contiguous(), "device": a.cpu(),
           "layout": torch.zeros((8, 16), dtype=torch.int64, device=dev).t()}
    for b in bad.values():
        with pytest.raises(ValueError):
            cuda_fp.mul(f, a, b)
    with pytest.raises(ValueError):
        cuda_fp.mul_const(f, a, a)  # not a [16, 1] column
    with pytest.raises(ValueError):
        cuda_fp.mul_stacked(f, a, a)  # not [K, 16, B]
    with pytest.raises(ValueError):
        cuda_fp.mul(fp.SolinasField((1 << 256) - 189), a, a)


# -- kernels G and H: the composed EC route (csrc/fp.cu pow, csrc/ladder.cu) --

@pytest.mark.parametrize("name", sorted(FP_FIELDS))
def test_pow_kernel_matches_plain(dev, name):
    """Every mode of kernel G against the plain window loop at [16, 1]
    (the root of a batched inversion), [16, 3] and [16, 16,384] (edges 0,
    1, n - 1, R mod n first), through a kernels=True field: the inverse at
    m - 2, secp256k1's square root at (p+1)/4, the window loop at the
    other exponents. One launch a call, whatever the mode."""
    mk, mod = FP_FIELDS[name]
    f, kf = mk(mod), mk(mod, kernels=True)
    a = _fp_lanes(mod, 16384, 3, dev)
    modes = set()
    for e in (1, 0x1234, (mod + 1) // 4, mod - 2):
        modes.add(cuda_fp.pow_mode(f, e))
        want = f.pow_const(a, e)
        for B in (1, 3, 16384):
            x = a[:, 2:2 + B].contiguous() if B == 1 else a[:, :B].contiguous()
            n0 = cuda_fp.pow_const.launches
            got = kf.pow_const(x, e)
            assert cuda_fp.pow_const.launches == n0 + 1
            assert torch.equal(got, want[:, 2:3] if B == 1 else want[:, :B]), (e, B)
    want_modes = {cuda_fp.WINDOW, cuda_fp.INVERSE} | (
        {cuda_fp.SQRT} if name == "secp_p" else set())
    assert modes == want_modes


@pytest.mark.parametrize("name", sorted(FP_FIELDS))
def test_pow_kernel_generic_exponents_take_the_window_loop(dev, name):
    """65,537 and a seeded 256-bit exponent are no inverse and no square
    root: the window mode, bit-exact against the plain loop at [16, 1] and
    [16, 4,096]."""
    mk, mod = FP_FIELDS[name]
    f = mk(mod)
    a = _fp_lanes(mod, 4096, 4, dev)
    rng = np.random.default_rng(5)
    for e in (65537, int.from_bytes(rng.bytes(32), "big") | 1 << 255):
        assert cuda_fp.pow_mode(f, e) == cuda_fp.WINDOW
        assert torch.equal(cuda_fp.pow_const(f, a, e), f.pow_const(a, e))
        one = a[:, 5:6].contiguous()
        assert torch.equal(cuda_fp.pow_const(f, one, e), f.pow_const(one, e))


@pytest.mark.parametrize("curve", ["secp256k1", "sm2"])
def test_ladder_kernel_matches_plain(dev, curve):
    """Jacobian bit-exact at 300 lanes (a ragged last block) with
    vectors.ladder_lanes' adversarial lanes and every fourth lane's sign
    flags flipped."""
    cv = ec.SECP256K1 if curve == "secp256k1" else ec.SM2P256V1
    k1, k2, qx, qy = vectors.ladder_lanes(cv.params, 300, 70)
    f = cv.fp
    nsteps, gts, digs, negs, qp = ec.ladder_inputs(
        cv, _lane(k1, dev), _lane(k2, dev), f.to_rep(_lane(qx, dev)), f.to_rep(_lane(qy, dev)))
    negs = negs.clone()
    negs[:, 9::4] ^= 1
    n0 = cuda_ec.ladder.launches
    got = cuda_ec.ladder(cv, nsteps, gts, digs, negs, qp)
    assert cuda_ec.ladder.launches == n0 + 1
    assert torch.equal(got, ec.ladder_plain(cv, nsteps, gts, digs, negs, qp))


@pytest.mark.parametrize("sm", [False, True], ids=["ecdsa", "sm"])
def test_composed_route_on_card_matches_fused(dev, sm):
    """make_suite(ec_route="composed") on the card: the same verdicts and
    senders as the fused route, through the ladder kernel and not the
    fused EC kernels."""
    if sm:
        vs = vectors.sm2_vectors(24, tag=14) + vectors.sm2_collision_vectors()
        sigs = [d["r"].to_bytes(32, "big") + d["s"].to_bytes(32, "big")
                + d["qx"].to_bytes(32, "big") + d["qy"].to_bytes(32, "big")
                for d in vs]
    else:
        vs = vectors.signed_vectors(24, tag=15) + vectors.collision_vectors()
        sigs = [d["r"].to_bytes(32, "big") + d["s"].to_bytes(32, "big")
                + bytes([d["v"] % 256]) for d in vs]
    digests = [d["e"].to_bytes(32, "big") for d in vs]
    pubs = [d["qx"].to_bytes(32, "big") + d["qy"].to_bytes(32, "big") for d in vs]
    fused = make_suite(sm_crypto=sm)
    composed = make_suite(sm_crypto=sm, ec_route="composed")
    want_ok = fused.verify_batch(digests, sigs, pubs)
    want_addr = fused.recover_addresses(digests, sigs)
    n_fused = (cuda_verify.ecdsa_recover.launches, cuda_verify.ecdsa_verify.launches,
               cuda_verify.sm2_verify.launches)
    n_ladder = cuda_ec.ladder.launches
    assert (composed.verify_batch(digests, sigs, pubs) == want_ok).all()
    got_addr = composed.recover_addresses(digests, sigs)
    assert got_addr[0] == want_addr[0] and (got_addr[1] == want_addr[1]).all()
    assert (cuda_verify.ecdsa_recover.launches, cuda_verify.ecdsa_verify.launches,
            cuda_verify.sm2_verify.launches) == n_fused
    assert cuda_ec.ladder.launches == n_ladder + 2
    assert want_ok.any() and not want_ok.all()


def test_pow_and_ladder_wrappers_reject_what_the_kernels_do_not_take(dev):
    f = fp.MontField(refimpl.SECP256K1.n)
    a = torch.zeros((16, 8), dtype=torch.int64, device=dev)
    for bad in (a.int(), a[:8].contiguous(), a.cpu()):
        with pytest.raises(ValueError):
            cuda_fp.pow_const(f, bad, 3)
    for e in (0, 1 << 256):
        with pytest.raises(ValueError):
            cuda_fp.pow_const(f, a, e)
    cv = ec.SECP256K1
    k = _lane([1] * 8, dev)
    ops = list(ec.ladder_inputs(cv, k, k, cv.fp.to_rep(k), cv.fp.to_rep(k)))
    assert cuda_ec.ladder(cv, *ops).shape == (3, 16, 8)
    bad = {1: ops[1][:1].contiguous(), 2: ops[2].long(), 3: ops[3][:, :4].contiguous(),
           4: ops[4].cpu()}
    for i, t in bad.items():
        with pytest.raises(ValueError):
            cuda_ec.ladder(cv, *(t if j == i else o for j, o in enumerate(ops)))
    with pytest.raises(ValueError):
        cuda_ec.ladder(cv, 65, *ops[1:])
    other = copy.copy(cv)
    other.params = dataclasses.replace(cv.params, name="other")
    with pytest.raises(ValueError, match="no kernel"):
        cuda_ec.ladder(other, *ops)
