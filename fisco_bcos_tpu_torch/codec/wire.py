"""Deterministic binary wire codec for protocol objects.

The reference serialises protocol structs with Tars IDL
(FISCO-BCOS bcos-tars-protocol/bcos-tars-protocol/tars/*.tars — 26 IDL
files compiled to C++). A new framework needs the *property* that format
provides — canonical, versioned, lazily-decodable bytes whose hash is the
object identity — not Tars itself. This codec is a minimal deterministic
TLV-free layout: fields are written in declaration order, integers as
fixed-width big-endian, byte strings with u32 length prefixes, lists with u32
count prefixes. One encoding per value (no optional-field ambiguity), so
hash(encode(x)) is well-defined across nodes and CPU/TPU paths.

Batch-friendly: encoded transactions are contiguous byte strings that the
TPU hash kernels consume directly (ops.keccak.keccak256_batch_np), so
"hash 64k txs" is one device call rather than 64k EVP invocations
(bcos-crypto/bcos-crypto/hasher/OpenSSLHasher.h:23).
"""

from __future__ import annotations

import io
import struct


class Writer:
    __slots__ = ("_b",)

    def __init__(self):
        self._b = io.BytesIO()

    def u8(self, v: int) -> "Writer":
        self._b.write(struct.pack(">B", v))
        return self

    def u16(self, v: int) -> "Writer":
        self._b.write(struct.pack(">H", v))
        return self

    def u32(self, v: int) -> "Writer":
        self._b.write(struct.pack(">I", v))
        return self

    def i64(self, v: int) -> "Writer":
        self._b.write(struct.pack(">q", v))
        return self

    def u64(self, v: int) -> "Writer":
        self._b.write(struct.pack(">Q", v))
        return self

    def u256(self, v: int) -> "Writer":
        self._b.write(v.to_bytes(32, "big"))
        return self

    def raw(self, v: bytes) -> "Writer":
        self._b.write(v)
        return self

    def blob(self, v: bytes) -> "Writer":
        self.u32(len(v))
        self._b.write(v)
        return self

    def text(self, v: str) -> "Writer":
        return self.blob(v.encode())

    def seq(self, items, fn) -> "Writer":
        self.u32(len(items))
        for it in items:
            fn(self, it)
        return self

    def bytes(self) -> bytes:
        return self._b.getvalue()


class Reader:
    __slots__ = ("_v", "_o")

    def __init__(self, data: bytes):
        self._v = data
        self._o = 0

    def _take(self, n: int) -> bytes:
        if self._o + n > len(self._v):
            raise ValueError("wire: truncated input")
        out = self._v[self._o : self._o + n]
        self._o += n
        return out

    def u8(self) -> int:
        return self._take(1)[0]

    def u16(self) -> int:
        return struct.unpack(">H", self._take(2))[0]

    def u32(self) -> int:
        return struct.unpack(">I", self._take(4))[0]

    def i64(self) -> int:
        return struct.unpack(">q", self._take(8))[0]

    def u64(self) -> int:
        return struct.unpack(">Q", self._take(8))[0]

    def u256(self) -> int:
        return int.from_bytes(self._take(32), "big")

    def raw(self, n: int) -> bytes:
        return self._take(n)

    def blob(self) -> bytes:
        return self._take(self.u32())

    def text(self) -> str:
        return self.blob().decode()

    def seq(self, fn) -> list:
        return [fn(self) for _ in range(self.u32())]

    def done(self) -> bool:
        return self._o == len(self._v)

    def remaining(self) -> bytes:
        return self._v[self._o :]
