"""The port's CUDA kernels (slice 1: recover, verify, Keccak, Keccak
Merkle level; the SM chain: SM3, SM3 Merkle level, SM2 verify) against
their plain PyTorch versions, on the card. Marked `cuda`; every test skips (inside the fixture) where
torch.cuda.is_available() is false. On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerance: bit-exact everywhere (integer crypto).
"""

import numpy as np
import pytest
import torch

from fisco_bcos_tpu_torch.crypto import refimpl
from fisco_bcos_tpu_torch.crypto.suite import make_suite
from fisco_bcos_tpu_torch.ops import (bigint, cuda_hash, cuda_merkle, cuda_sm3,
                                      cuda_verify, ec, keccak, merkle, sm3)
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
    vs = _vectors()
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
    vs = _vectors()
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


@pytest.mark.parametrize("n", [1, 2, 17, 4097])
def test_merkle_kernel_matches_plain(dev, n):
    rng = np.random.default_rng(n)
    leaves = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    got = cuda_merkle.merkle_root(torch.as_tensor(leaves, device=dev), n)
    plain = merkle.merkle_root(torch.as_tensor(leaves))
    assert torch.equal(got.cpu(), plain)
    if n <= 17:
        assert bytes(got.cpu().numpy()) == merkle.merkle_levels_host(
            [bytes(x) for x in leaves])[-1][0]


@pytest.mark.parametrize("n", [2, 17, 40])
def test_merkle_kernel_reads_rows_past_n_as_zero(dev, n):
    rng = np.random.default_rng(100 + n)
    leaves = torch.as_tensor(rng.integers(0, 256, (64, 32), dtype=np.uint8), device=dev)
    got = cuda_merkle.merkle_root(leaves, n)
    assert torch.equal(got, cuda_merkle.merkle_root(leaves[:n].contiguous(), n))
    assert bytes(got.cpu().numpy()) == merkle.merkle_levels_host(
        [bytes(x) for x in leaves[:n].cpu().numpy()])[-1][0]


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
