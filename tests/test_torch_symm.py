"""The port's symmetric ciphers (crypto/symm.py) against the spec vectors
and the JAX package's: SM4 (GB/T 32907) and AES-128 (FIPS-197) single
blocks, the CTR keystream (the port enciphers all of a message's counter
blocks at once in numpy arrays, the JAX package one block at a time) on
seeded lengths and at the counter's wrap, and the sealed envelope across
the two packages.
"""

import numpy as np
import pytest

from fisco_bcos_tpu.crypto import symm as jsymm
from fisco_bcos_tpu_torch.crypto import symm as psymm

ALGS = ("sm4", "aes")
LENGTHS = (0, 1, 15, 16, 17, 4097, 65537)


def _bytes(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def test_sm4_gbt_32907_vector():
    key = bytes.fromhex("0123456789abcdeffedcba9876543210")
    rks = psymm.sm4_key_schedule(key)
    assert rks == jsymm.sm4_key_schedule(key)
    ct = psymm.sm4_encrypt_block(rks, key)
    assert ct.hex() == "681edf34d206965e86b3e94f536e4246"
    words = np.frombuffer(key, dtype=">u4").astype(np.uint32).reshape(4, 1)
    assert psymm._sm4_blocks(rks, words).T.astype(">u4").tobytes() == ct


def test_aes128_fips_197_vector():
    key = bytes(range(16))
    pt = bytes.fromhex("00112233445566778899aabbccddeeff")
    rks = psymm.aes128_key_schedule(key)
    assert rks == jsymm.aes128_key_schedule(key)
    ct = psymm.aes128_encrypt_block(rks, pt)
    assert ct.hex() == "69c4e0d86a7b0430d8cdb78070b4c55a"
    words = np.frombuffer(pt, dtype=">u4").astype(np.uint32).reshape(4, 1)
    assert psymm._aes_blocks(rks, words).T.astype(">u4").tobytes() == ct


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("alg", ALGS)
def test_ctr_matches_the_jax_package(alg, n):
    key, iv, data = _bytes(n, 16), _bytes(n + 1, 16), _bytes(n + 2, n)
    want = jsymm.BlockCipher(alg, key).ctr(iv, data)
    got = psymm.BlockCipher(alg, key).ctr(iv, data)
    assert got == want and len(got) == n
    # CTR is its own inverse
    assert psymm.BlockCipher(alg, key).ctr(iv, got) == data


@pytest.mark.parametrize("alg", ALGS)
def test_ctr_wraps_the_counter_at_2_128(alg):
    """A counter of 2^128 - 1 wraps to 0, as the JAX package's does; and a
    key that is not 16 bytes is hashed to one, as there."""
    data = _bytes(7, 16 * 5 + 3)
    for iv in ((2 ** 128 - 1).to_bytes(16, "big"), (2 ** 64 - 2).to_bytes(16, "big")):
        for key in (_bytes(8, 16), b"a passphrase"):
            assert psymm.BlockCipher(alg, key).ctr(iv, data) == \
                jsymm.BlockCipher(alg, key).ctr(iv, data)


def test_the_keystream_is_the_block_cipher_of_each_counter_across_slices():
    """The keystream is enciphered in slices of _CTR_SLICE blocks: the
    blocks on each side of a slice's edge, and past a wrap inside a
    slice, are the single-block cipher of their counters."""
    c = psymm.BlockCipher("sm4", _bytes(9, 16))
    start = 2 ** 128 - psymm._CTR_SLICE - 2
    n = psymm._CTR_SLICE + 8
    ks = c.keystream(start.to_bytes(16, "big"), 16 * n - 5)
    assert len(ks) == 16 * n - 5
    for i in (0, 1, psymm._CTR_SLICE - 1, psymm._CTR_SLICE, psymm._CTR_SLICE + 1,
              psymm._CTR_SLICE + 2, n - 2):
        ctr = ((start + i) % 2 ** 128).to_bytes(16, "big")
        assert ks[16 * i:16 * i + 16] == c._enc(ctr), i
    assert ks[16 * (n - 1):] == c._enc(((start + n - 1) % 2 ** 128).to_bytes(16, "big"))[:11]


@pytest.mark.parametrize("alg", ALGS)
def test_sealed_envelope_opens_across_the_packages(alg):
    key = _bytes(11, 16)
    p, j = psymm.BlockCipher(alg, key), jsymm.BlockCipher(alg, key)
    for n in (0, 33, 5000):
        pt = _bytes(12 + n, n)
        assert j.open_sealed(p.seal(pt)) == pt
        assert p.open_sealed(j.seal(pt)) == pt
    blob = bytearray(p.seal(b"payload"))
    blob[20] ^= 1
    for c in (p, j):
        with pytest.raises(ValueError, match="authentication failed"):
            c.open_sealed(bytes(blob))
        with pytest.raises(ValueError, match="too short"):
            c.open_sealed(b"\x00" * 47)
    with pytest.raises(ValueError, match="unknown cipher"):
        psymm.BlockCipher("des", key)
