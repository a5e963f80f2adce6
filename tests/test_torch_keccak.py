"""Port's plain Keccak-256 (fisco_bcos_tpu_torch.ops.keccak, the plain
version of kernel 3) against the JAX package, bit-exact: the XLA varlen
path on mixed lengths across the rate edges, and the Pallas kernel in
interpret mode on a single-block batch (as tests/test_pallas_hash.py
runs it)."""

import numpy as np
import pytest
import torch

from fisco_bcos_tpu.ops import keccak as jkeccak
from fisco_bcos_tpu.ops import pallas_hash
from fisco_bcos_tpu_torch.crypto import refimpl
from fisco_bcos_tpu_torch.ops import keccak


def _msgs(seed, n, maxlen):
    rng = np.random.default_rng(seed)
    return [rng.bytes(int(k)) for k in rng.integers(0, maxlen, n)]


def test_pad_batch_matches_per_message_pad():
    msgs = _msgs(1, 20, 400) + [b"", b"x" * 135, b"y" * 136, b"z" * 271]
    blocks, nvalid = keccak.pad_batch_np(msgs)
    for i, m in enumerate(msgs):
        p = jkeccak.pad_message_np(m)
        assert nvalid[i] == p.shape[0]
        np.testing.assert_array_equal(blocks[i, :p.shape[0]], p)
        assert not blocks[i, p.shape[0]:].any()


def test_varlen_matches_jax_xla_path():
    msgs = _msgs(2, 24, 420) + [b"", b"a" * 135, b"b" * 136, b"c" * 137]
    blocks, nvalid = keccak.pad_batch_np(msgs)
    want = np.asarray(jkeccak._keccak256_varlen_impl(blocks, nvalid, blocks.shape[1]))
    got = keccak.keccak256_varlen(torch.as_tensor(blocks), torch.as_tensor(nvalid))
    np.testing.assert_array_equal(got.numpy(), want)
    assert [bytes(x) for x in want] == [refimpl.keccak256(m) for m in msgs]


def test_single_block_matches_pallas_interpret():
    msgs = _msgs(31, 30, 100) + [b""]
    blocks, nvalid = keccak.pad_batch_np(msgs)
    want = np.asarray(pallas_hash.keccak256_varlen_fused(blocks, nvalid, interpret=True))
    got = keccak.keccak256_varlen_plain(torch.as_tensor(blocks), torch.as_tensor(nvalid))
    np.testing.assert_array_equal(got.numpy(), want)


def test_short_nvalid_masks_trailing_blocks():
    """A message shorter than the bucket stops absorbing (nvalid mask),
    including nvalid = 0 (state stays zero)."""
    msgs = _msgs(4, 6, 300)
    blocks, nvalid = keccak.pad_batch_np(msgs)
    nvalid[0] = 0
    want = np.asarray(jkeccak._keccak256_varlen_impl(blocks, nvalid, blocks.shape[1]))
    got = keccak.keccak256_varlen_plain(torch.as_tensor(blocks), torch.as_tensor(nvalid))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want[0].any()


@pytest.mark.parametrize("n", [1, 7, 64])
def test_batch_np_on_cpu_matches_oracle(n):
    msgs = _msgs(10 + n, n, 700)
    out = keccak.keccak256_batch_np(msgs, device="cpu")
    assert [bytes(x) for x in out] == [refimpl.keccak256(m) for m in msgs]
