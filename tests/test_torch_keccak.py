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


# -- the batch packed by length class ----------------------------------------
BIG = (0, 1, 55, 56, 63, 64, 135, 136, 137, 1000, 5000, 20000, 100_000, 700_000,
       2_359_325, 3_000_000)


def big_batch(seed: int) -> list[bytes]:
    """0 B to 3 MB, as a block's state changeset spans them (its tx-hash
    list row is 2,359,325 B at 65,536 txs), amid many short messages."""
    rng = np.random.default_rng(seed)
    lens = list(BIG) + [int(k) for k in rng.integers(0, 300, 40)]
    rng.shuffle(lens)
    return [rng.bytes(k) for k in lens]


def check_packing(mod, msgs, block_bytes: int) -> int:
    """pack_batch_np's classes against the per-message pad: every row in
    exactly one class, a class's rows of 2^(c-1) + 1 to 2^c blocks (one
    block for class 0), each row its own padded message then zeros, and
    the padded blocks under twice the blocks needed. -> the classes."""
    packed = mod.pack_batch_np(msgs)
    seen = np.concatenate([rows for rows, _, _ in packed])
    assert sorted(seen.tolist()) == list(range(len(msgs)))
    padded = needed = 0
    for rows, blocks, nvalid in packed:
        assert blocks.shape == (len(rows), int(nvalid.max()), block_bytes)
        lo, hi = int(nvalid.min()), int(nvalid.max())
        c = (hi - 1).bit_length()
        assert (c == 0 and hi == 1) or 2 ** (c - 1) < lo <= hi <= 2 ** c
        for k, i in enumerate(rows.tolist()):
            p = mod.pad_message_np(msgs[i])
            assert nvalid[k] == p.shape[0]
            np.testing.assert_array_equal(blocks[k, :p.shape[0]], p)
            assert not blocks[k, p.shape[0]:].any()
        padded += blocks.shape[0] * blocks.shape[1]
        needed += int(nvalid.sum())
    assert padded < 2 * needed
    return len(packed)


def hash_by_class(monkeypatch, mod, name: str, host_hash, unpad):
    """Count mod.<name> calls (one a class) and record their shapes; a
    class wider than 16 blocks is hashed by the native host hash of each
    row's unpadded message (the plain version takes ~65 ms a block on this
    CPU), the rest by the plain version."""
    plain = getattr(mod, name)
    calls = []

    def counted(blocks, nvalid):
        calls.append(tuple(blocks.shape))
        if blocks.shape[1] <= 16:
            return plain(blocks, nvalid)
        b, nv = blocks.numpy(), nvalid.numpy()
        return torch.as_tensor(np.stack([np.frombuffer(host_hash(unpad(b[k], int(nv[k]))),
                                                       np.uint8) for k in range(len(nv))]))

    monkeypatch.setattr(mod, name, counted)
    return calls


def keccak_unpad(blocks: np.ndarray, nvalid: int) -> bytes:
    """The message of a row of Keccak-padded blocks: strip 0x01 0* 0x80."""
    flat = blocks[:nvalid].reshape(-1).copy()
    flat[-1] ^= 0x80
    end = int(np.flatnonzero(flat)[-1])
    assert flat[end] == 0x01
    return flat[:end].tobytes()


def test_pack_by_length_class_bounds_the_padding():
    msgs = big_batch(5)
    assert check_packing(keccak, msgs, keccak.RATE_BYTES) == 9


def test_batch_np_hashes_a_class_a_launch_in_input_order(monkeypatch):
    """keccak256_batch_np over 0 B to 3 MB: one keccak256_varlen call a
    length class, each padded only to its own longest message, digests in
    input order equal to refimpl's (the native hash's for the messages
    of more than 100 KB, which test_torch_native holds to refimpl)."""
    from fisco_bcos_tpu_torch.crypto import nativehash

    msgs = big_batch(6)
    host = nativehash.host_hash("keccak256")
    calls = hash_by_class(monkeypatch, keccak, "keccak256_varlen", host, keccak_unpad)
    out = keccak.keccak256_batch_np(msgs, device="cpu")
    assert len(calls) == len(keccak.pack_batch_np(msgs))
    assert max(c[1] for c in calls) == len(max(msgs, key=len)) // 136 + 1
    want = [refimpl.keccak256(m) if len(m) <= 100_000 else host(m) for m in msgs]
    assert [bytes(x) for x in out] == want
    assert host(msgs[0] * 3) == refimpl.keccak256(msgs[0] * 3)
