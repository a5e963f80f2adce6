"""Port's plain SM3 (fisco_bcos_tpu_torch.ops.sm3, the plain version of
kernel A) against the pure-Python oracle and the JAX package, bit-exact:
the XLA varlen path on lengths that cross the padding edges (at most 4
blocks, to keep the XLA compile short) and the SM3 constants the kernels
read. The Pallas SM3 kernel is not run in interpret mode: its run takes
many minutes on the CPU, which is why tests/test_pallas_hash.py skips it
too."""

import numpy as np
import pytest
import torch

from fisco_bcos_tpu.ops import sm3 as jsm3
from fisco_bcos_tpu_torch.crypto import refimpl
from fisco_bcos_tpu_torch.ops import consts, cuda_sm3, sm3

import test_torch_keccak as tk  # tests/ is on sys.path under pytest

EDGES = [0, 1, 55, 56, 63, 64, 119, 120, 200]


def _msgs(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.bytes(int(k)) for k in lens]


def test_pad_batch_matches_jax_per_message_pad():
    msgs = _msgs(1, EDGES + [300, 1000])
    blocks, nvalid = sm3.pad_batch_np(msgs)
    for i, m in enumerate(msgs):
        p = jsm3.pad_message_np(m)
        np.testing.assert_array_equal(sm3.pad_message_np(m), p)
        assert nvalid[i] == p.shape[0]
        np.testing.assert_array_equal(blocks[i, :p.shape[0]], p)
        assert not blocks[i, p.shape[0]:].any()


def test_plain_matches_oracle_and_jax_xla_path():
    msgs = _msgs(2, EDGES)
    want = np.asarray(jsm3.sm3_batch_np(msgs))
    got = sm3.sm3_batch_np(msgs, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert [bytes(x) for x in got] == [refimpl.sm3(m) for m in msgs]
    assert refimpl.sm3(b"abc").hex() == (
        "66c7f0f462eeedd9d1f2d46bdc10e4e24167c4875cf2f7a2297da02b8f4ba8e0")


def test_short_nvalid_masks_trailing_blocks():
    """A message stops after its nvalid blocks, nvalid = 0 included (the
    state stays the IV), as the JAX varlen mask does."""
    msgs = _msgs(3, [10, 70, 130, 200])
    blocks, nvalid = sm3.pad_batch_np(msgs)
    nvalid[0], nvalid[2] = 0, 1
    want = np.asarray(jsm3._sm3_varlen_impl(blocks, nvalid, blocks.shape[1]))
    got = sm3.sm3_varlen_plain(torch.as_tensor(blocks), torch.as_tensor(nvalid))
    np.testing.assert_array_equal(got.numpy(), want)
    assert bytes(want[0]) == sm3.IV.astype(">u4").tobytes()


def test_sm3_constants_match_jax_and_the_kernel_block():
    jc = consts.consts_from_jax({**consts.derive_np(), "sm3_iv": jsm3._IV,
                                 "sm3_tjrot": jsm3._TJROT})
    mine = consts.derive_consts()
    for k in ("sm3_iv", "sm3_tjrot"):
        assert torch.equal(jc[k], mine[k]), k
    words = consts.kernel_words(jc)["sm3"]
    assert words.dtype == np.uint32 and words.shape == (72,)
    np.testing.assert_array_equal(words[:8], jsm3._IV)
    np.testing.assert_array_equal(words[8:], jsm3._TJROT)


@pytest.mark.parametrize("n", [1, 7, 64])
def test_batch_np_on_cpu_matches_oracle(n):
    msgs = _msgs(10 + n, np.random.default_rng(n).integers(0, 700, n))
    out = sm3.sm3_batch_np(msgs, device="cpu")
    assert [bytes(x) for x in out] == [refimpl.sm3(m) for m in msgs]


def test_cpu_tensors_take_the_plain_version():
    before = cuda_sm3.sm3_varlen.launches
    blocks, nvalid = sm3.pad_batch_np([b"abc"])
    out = sm3.sm3_varlen(torch.as_tensor(blocks), torch.as_tensor(nvalid))
    assert bytes(out[0].numpy()) == refimpl.sm3(b"abc")
    assert cuda_sm3.sm3_varlen.launches == before
    with pytest.raises(ValueError):
        cuda_sm3.sm3_varlen(torch.as_tensor(blocks), torch.as_tensor(nvalid))


# -- the batch packed by length class ----------------------------------------
def sm3_unpad(blocks: np.ndarray, nvalid: int) -> bytes:
    """The message of a row of SM3-padded blocks: its bit length is the
    last 8 bytes."""
    flat = blocks[:nvalid].reshape(-1)
    n = int.from_bytes(flat[-8:].tobytes(), "big") // 8
    assert flat[n] == 0x80
    return flat[:n].tobytes()


def test_pack_by_length_class_bounds_the_padding():
    assert tk.check_packing(sm3, tk.big_batch(7), sm3.BLOCK_BYTES) == 10


def test_batch_np_hashes_a_class_a_launch_in_input_order(monkeypatch):
    """sm3_batch_np over 0 B to 3 MB: one sm3_varlen call a length class,
    digests in input order equal to refimpl's (the native hash's past
    100 KB)."""
    from fisco_bcos_tpu_torch.crypto import nativehash

    msgs = tk.big_batch(8)
    host = nativehash.host_hash("sm3")
    calls = tk.hash_by_class(monkeypatch, sm3, "sm3_varlen", host, sm3_unpad)
    out = sm3.sm3_batch_np(msgs, device="cpu")
    assert len(calls) == len(sm3.pack_batch_np(msgs))
    want = [refimpl.sm3(m) if len(m) <= 100_000 else host(m) for m in msgs]
    assert [bytes(x) for x in out] == want
