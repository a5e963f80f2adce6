"""Symmetric ciphers: SM4 (GB/T 32907) and AES-128, with CTR mode + HMAC.

Reference counterpart: FISCO-BCOS bcos-crypto/bcos-crypto/encrypt/
(AESCrypto / SM4Crypto via OpenSSL EVP) used by bcos-security's disk
encryption (DataEncryption.h:35-55) and, here, by the SM-TLS record layer
(net/smtls.py). Pure from-spec implementations (no OpenSSL binding).

The single-block functions (`sm4_encrypt_block`, `aes128_encrypt_block`)
are the spec's, one block at a time. `BlockCipher.ctr` computes the same
keystream for all of a message's counter blocks at once: numpy uint32
arrays, one column per block, the S-box and the linear layer folded into
tables (SM4: L(tau(x)) by 16-bit halves; AES: SubBytes + MixColumns by
byte). The
bytes are those of the block functions (tests/test_torch_symm.py holds
them to the spec vectors and to the block-at-a-time CTR).

`seal`/`open_sealed` provide the authenticated envelope the security layer
uses: random IV, CTR keystream, HMAC-SHA256 tag over IV||ciphertext
(encrypt-then-MAC).
"""

from __future__ import annotations

import hashlib
import hmac
import os

import numpy as np

# ---------------------------------------------------------------------------
# SM4
# ---------------------------------------------------------------------------

def _sm4_build_sbox() -> bytes:
    """SM4 S-box from its algebraic definition: affine -> inversion in
    GF(2^8)/(x^8+x^7+x^6+x^5+x^4+x^2+1) -> same affine, with the circulant
    matrix row 0xA7 and constant 0xD3 (checked by the standard test vector).
    """

    def gf_mul(a: int, b: int) -> int:
        r = 0
        for i in range(8):
            if (b >> i) & 1:
                r ^= a << i
        for i in range(15, 7, -1):
            if (r >> i) & 1:
                r ^= 0x1F5 << (i - 8)
        return r & 0xFF

    inv = [0] * 256
    for a in range(1, 256):
        if inv[a]:
            continue
        for x in range(1, 256):
            if gf_mul(a, x) == 1:
                inv[a], inv[x] = x, a
                break

    def affine(x: int) -> int:
        y = 0
        for i in range(8):
            bit = 0
            for j in range(8):
                if (0xA7 >> ((j - i) % 8)) & 1 and (x >> j) & 1:
                    bit ^= 1
            y |= bit << i
        return y ^ 0xD3

    return bytes(affine(inv[affine(x)]) for x in range(256))


_SM4_SBOX = _sm4_build_sbox()
_FK = (0xA3B1BAC6, 0x56AA3350, 0x677D9197, 0xB27022DC)
_CK = tuple(
    sum(((4 * i + j) * 7 % 256) << (24 - 8 * j) for j in range(4))
    for i in range(32))
_M32 = 0xFFFFFFFF


def _rotl(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & _M32


def _sm4_tau(a: int) -> int:
    return (_SM4_SBOX[(a >> 24) & 0xFF] << 24 | _SM4_SBOX[(a >> 16) & 0xFF] << 16
            | _SM4_SBOX[(a >> 8) & 0xFF] << 8 | _SM4_SBOX[a & 0xFF])


def _sm4_l(b: int) -> int:
    return b ^ _rotl(b, 2) ^ _rotl(b, 10) ^ _rotl(b, 18) ^ _rotl(b, 24)


def _sm4_t(a: int) -> int:
    return _sm4_l(_sm4_tau(a))


def _sm4_t_key(a: int) -> int:
    b = _sm4_tau(a)
    return b ^ _rotl(b, 13) ^ _rotl(b, 23)


def sm4_key_schedule(key: bytes) -> list[int]:
    assert len(key) == 16
    mk = [int.from_bytes(key[4 * i:4 * i + 4], "big") for i in range(4)]
    k = [mk[i] ^ _FK[i] for i in range(4)]
    rks = []
    for i in range(32):
        k.append(k[i] ^ _sm4_t_key(k[i + 1] ^ k[i + 2] ^ k[i + 3] ^ _CK[i]))
        rks.append(k[-1])
    return rks


def sm4_encrypt_block(rks: list[int], block: bytes) -> bytes:
    x = [int.from_bytes(block[4 * i:4 * i + 4], "big") for i in range(4)]
    for i in range(32):
        x.append(x[i] ^ _sm4_t(x[i + 1] ^ x[i + 2] ^ x[i + 3] ^ rks[i]))
    return b"".join(v.to_bytes(4, "big") for v in x[35:31:-1])


# T(x) = L(tau(x)) is linear over the four S-box outputs, so it is the XOR
# of two tables indexed by x's high and low 16 bits:
# _SM4_T16[0][h] = L(S(h >> 8) << 24 | S(h & 0xFF) << 16), [1] the low half's
def _sm4_t16() -> np.ndarray:
    t8 = np.array([[_sm4_l(_SM4_SBOX[b] << (24 - 8 * k)) for b in range(256)]
                   for k in range(4)], dtype=np.uint32)
    h = np.arange(1 << 16)
    return np.stack([t8[0][h >> 8] ^ t8[1][h & 0xFF], t8[2][h >> 8] ^ t8[3][h & 0xFF]])


_SM4_T16 = _sm4_t16()


def _sm4_blocks(rks: list[int], words: np.ndarray) -> np.ndarray:
    """SM4 of n blocks: words uint32[4, n] (each block's big-endian words)
    -> uint32[4, n], the ciphertext words."""
    hi, lo = _SM4_T16
    x = [words[0], words[1], words[2], words[3]]
    for i in range(32):
        a = x[1] ^ x[2] ^ x[3] ^ np.uint32(rks[i])
        x = [x[1], x[2], x[3], x[0] ^ np.take(hi, a >> 16) ^ np.take(lo, a & 0xFFFF)]
    return np.stack(x[::-1])


# ---------------------------------------------------------------------------
# AES-128
# ---------------------------------------------------------------------------

def _aes_build_sbox() -> bytes:
    p, q, sbox = 1, 1, bytearray(256)
    while True:
        p = p ^ ((p << 1) & 0xFF) ^ (0x1B if p & 0x80 else 0)
        q ^= q << 1
        q ^= q << 2
        q ^= q << 4
        q &= 0xFF
        if q & 0x80:
            q ^= 0x09
        x = q ^ _rotl8(q, 1) ^ _rotl8(q, 2) ^ _rotl8(q, 3) ^ _rotl8(q, 4)
        sbox[p] = x ^ 0x63
        if p == 1:
            break
    sbox[0] = 0x63
    return bytes(sbox)


def _rotl8(x: int, n: int) -> int:
    return ((x << n) | (x >> (8 - n))) & 0xFF


_AES_SBOX = _aes_build_sbox()
_RCON = [0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36]


def aes128_key_schedule(key: bytes) -> list[bytes]:
    assert len(key) == 16
    words = [key[4 * i:4 * i + 4] for i in range(4)]
    for i in range(4, 44):
        t = words[i - 1]
        if i % 4 == 0:
            t = bytes(_AES_SBOX[b] for b in t[1:] + t[:1])
            t = bytes([t[0] ^ _RCON[i // 4 - 1]]) + t[1:]
        words.append(bytes(a ^ b for a, b in zip(words[i - 4], t)))
    return [b"".join(words[4 * r:4 * r + 4]) for r in range(11)]


def _xtime(a: int) -> int:
    return ((a << 1) ^ 0x1B) & 0xFF if a & 0x80 else a << 1


def aes128_encrypt_block(round_keys: list[bytes], block: bytes) -> bytes:
    s = bytearray(a ^ b for a, b in zip(block, round_keys[0]))
    for rnd in range(1, 11):
        s = bytearray(_AES_SBOX[b] for b in s)  # SubBytes
        # ShiftRows (state is column-major: byte r + 4c)
        s = bytearray(s[(i + 4 * (i % 4)) % 16] for i in range(16))
        if rnd < 10:  # MixColumns
            out = bytearray(16)
            for c in range(4):
                col = s[4 * c:4 * c + 4]
                for r in range(4):
                    out[4 * c + r] = (_xtime(col[r]) ^ _xtime(col[(r + 1) % 4])
                                      ^ col[(r + 1) % 4] ^ col[(r + 2) % 4]
                                      ^ col[(r + 3) % 4])
            s = out
        s = bytearray(a ^ b for a, b in zip(s, round_keys[rnd]))
    return bytes(s)


def _aes_te() -> np.ndarray:
    """The four round tables over big-endian column words: _AES_TE[r][b] is
    S(b) placed at row r of a column, mixed (MixColumns' column r)."""
    te = np.zeros((4, 256), dtype=np.uint32)
    for b in range(256):
        s = _AES_SBOX[b]
        s2 = _xtime(s)
        col = (s2, s, s, s2 ^ s)   # rows 0-3 of MixColumns applied to (s,0,0,0)
        w = (col[0] << 24) | (col[1] << 16) | (col[2] << 8) | col[3]
        for r in range(4):
            te[r][b] = ((w >> (8 * r)) | (w << (32 - 8 * r))) & _M32
    return te


_AES_TE = _aes_te()
_AES_S32 = np.frombuffer(_AES_SBOX, dtype=np.uint8).astype(np.uint32)


def _aes_blocks(round_keys: list[bytes], words: np.ndarray) -> np.ndarray:
    """AES-128 of n blocks: words uint32[4, n] (each block's four big-endian
    column words) -> uint32[4, n]."""
    rk = [np.frombuffer(k, dtype=">u4").astype(np.uint32) for k in round_keys]
    te0, te1, te2, te3 = _AES_TE
    s = [words[c] ^ rk[0][c] for c in range(4)]
    for rnd in range(1, 10):
        s = [te0[s[c] >> 24] ^ te1[(s[(c + 1) % 4] >> 16) & 0xFF]
             ^ te2[(s[(c + 2) % 4] >> 8) & 0xFF] ^ te3[s[(c + 3) % 4] & 0xFF]
             ^ rk[rnd][c] for c in range(4)]
    sb = _AES_S32
    return np.stack([(sb[s[c] >> 24] << 24) ^ (sb[(s[(c + 1) % 4] >> 16) & 0xFF] << 16)
                     ^ (sb[(s[(c + 2) % 4] >> 8) & 0xFF] << 8) ^ sb[s[(c + 3) % 4] & 0xFF]
                     ^ rk[10][c] for c in range(4)])


# ---------------------------------------------------------------------------
# CTR mode + authenticated envelope
# ---------------------------------------------------------------------------

def _counter_words(iv: bytes, n: int) -> np.ndarray:
    """The big-endian words of counter blocks iv, iv + 1, ..., iv + n - 1,
    mod 2^128 -> uint32[4, n]."""
    hi = np.full(n, int.from_bytes(iv[:8], "big"), dtype=np.uint64)
    lo0 = np.uint64(int.from_bytes(iv[8:], "big"))
    lo = lo0 + np.arange(n, dtype=np.uint64)    # wraps mod 2^64
    hi += (lo < lo0).astype(np.uint64)          # the carry; hi wraps mod 2^64
    m = np.uint64(_M32)
    return np.stack([(hi >> np.uint64(32)), hi & m, lo >> np.uint64(32), lo & m]
                    ).astype(np.uint32)


_CTR_SLICE = 16384   # counter blocks enciphered together (256 KiB of keystream)


class BlockCipher:
    def __init__(self, algorithm: str, key: bytes):
        self.algorithm = algorithm
        key = hashlib.sha256(key).digest()[:16] if len(key) != 16 else key
        self.key = key
        if algorithm == "sm4":
            self._rks = sm4_key_schedule(key)
            self._enc = lambda b: sm4_encrypt_block(self._rks, b)
            self._blocks = lambda w: _sm4_blocks(self._rks, w)
        elif algorithm == "aes":
            self._rks = aes128_key_schedule(key)
            self._enc = lambda b: aes128_encrypt_block(self._rks, b)
            self._blocks = lambda w: _aes_blocks(self._rks, w)
        else:
            raise ValueError(f"unknown cipher {algorithm!r}")

    def keystream(self, iv: bytes, nbytes: int) -> bytes:
        """The CTR keystream's first nbytes: every counter block enciphered
        at once (counter iv, iv + 1, ... mod 2^128)."""
        assert len(iv) == 16
        n = -(-nbytes // 16)
        ctr = int.from_bytes(iv, "big")
        parts = []
        for at in range(0, n, _CTR_SLICE):   # slices that stay in cache
            first = ((ctr + at) % (1 << 128)).to_bytes(16, "big")
            out = self._blocks(_counter_words(first, min(_CTR_SLICE, n - at)))
            parts.append(out.T.astype(">u4").tobytes())
        return b"".join(parts)[:nbytes]

    def ctr(self, iv: bytes, data: bytes) -> bytes:
        ks = np.frombuffer(self.keystream(iv, len(data)), dtype=np.uint8)
        return (np.frombuffer(data, dtype=np.uint8) ^ ks).tobytes()

    # -- authenticated envelope (encrypt-then-MAC) -------------------------
    def seal(self, plaintext: bytes) -> bytes:
        iv = os.urandom(16)
        ct = self.ctr(iv, plaintext)
        tag = hmac.new(self.key, iv + ct, hashlib.sha256).digest()
        return iv + ct + tag

    def open_sealed(self, blob: bytes) -> bytes:
        if len(blob) < 48:
            raise ValueError("sealed blob too short")
        iv, ct, tag = blob[:16], blob[16:-32], blob[-32:]
        want = hmac.new(self.key, iv + ct, hashlib.sha256).digest()
        if not hmac.compare_digest(tag, want):
            raise ValueError("authentication failed")
        return self.ctr(iv, ct)
