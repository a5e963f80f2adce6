"""SCALE codec (Simple Concatenated Aggregate Little-Endian).

Reference counterpart: FISCO-BCOS bcos-codec/bcos-codec/scale/
(ScaleEncoderStream.h / ScaleDecoderStream.h) — used by the reference for
WASM-contract parameter marshalling (the liquid/WBC toolchain speaks SCALE).

Implements the standard SCALE forms from the public spec: fixed-width
little-endian integers, compact (LEB-like 2-bit-mode) integers, booleans,
Option<T>, Vec<T>, strings (compact-length UTF-8), fixed tuples/structs,
and Result-style enum tags. Pure host-side marshalling.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence


class ScaleError(ValueError):
    pass


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

class Encoder:
    __slots__ = ("_out",)

    def __init__(self):
        self._out = bytearray()

    def bytes(self) -> bytes:
        return bytes(self._out)

    # fixed-width ints, little-endian
    def uint(self, v: int, nbytes: int) -> "Encoder":
        if not 0 <= v < 1 << (8 * nbytes):
            raise ScaleError(f"u{8*nbytes} out of range: {v}")
        self._out += v.to_bytes(nbytes, "little")
        return self

    def int_(self, v: int, nbytes: int) -> "Encoder":
        lim = 1 << (8 * nbytes - 1)
        if not -lim <= v < lim:
            raise ScaleError(f"i{8*nbytes} out of range: {v}")
        self._out += (v % (1 << (8 * nbytes))).to_bytes(nbytes, "little")
        return self

    def u8(self, v):
        return self.uint(v, 1)

    def u16(self, v):
        return self.uint(v, 2)

    def u32(self, v):
        return self.uint(v, 4)

    def u64(self, v):
        return self.uint(v, 8)

    def u128(self, v):
        return self.uint(v, 16)

    def u256(self, v):
        return self.uint(v, 32)

    def boolean(self, v: bool) -> "Encoder":
        self._out.append(1 if v else 0)
        return self

    def compact(self, v: int) -> "Encoder":
        """Compact integer: 2-bit mode tag in the low bits."""
        if v < 0:
            raise ScaleError("compact is unsigned")
        if v < 1 << 6:
            self._out.append(v << 2)
        elif v < 1 << 14:
            self._out += ((v << 2) | 0b01).to_bytes(2, "little")
        elif v < 1 << 30:
            self._out += ((v << 2) | 0b10).to_bytes(4, "little")
        else:
            data = v.to_bytes((v.bit_length() + 7) // 8, "little")
            if len(data) > 67:
                raise ScaleError("compact too large")
            self._out.append(((len(data) - 4) << 2) | 0b11)
            self._out += data
        return self

    def raw(self, b: bytes) -> "Encoder":
        self._out += b
        return self

    def byte_vec(self, b: bytes) -> "Encoder":
        """Vec<u8>: compact length + raw bytes (also SCALE strings)."""
        return self.compact(len(b)).raw(b)

    def string(self, s: str) -> "Encoder":
        return self.byte_vec(s.encode())

    def option(self, v: Optional[Any], enc: Callable[["Encoder", Any], Any]
               ) -> "Encoder":
        if v is None:
            self._out.append(0)
        else:
            self._out.append(1)
            enc(self, v)
        return self

    def vec(self, items: Sequence[Any], enc: Callable[["Encoder", Any], Any]
            ) -> "Encoder":
        self.compact(len(items))
        for it in items:
            enc(self, it)
        return self

    def enum(self, tag: int) -> "Encoder":
        return self.u8(tag)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

class Decoder:
    __slots__ = ("_b", "_o")

    def __init__(self, data: bytes):
        self._b = data
        self._o = 0

    def _take(self, n: int) -> bytes:
        if self._o + n > len(self._b):
            raise ScaleError("truncated SCALE data")
        out = self._b[self._o:self._o + n]
        self._o += n
        return out

    def remaining(self) -> int:
        return len(self._b) - self._o

    def uint(self, nbytes: int) -> int:
        return int.from_bytes(self._take(nbytes), "little")

    def int_(self, nbytes: int) -> int:
        v = self.uint(nbytes)
        if v >= 1 << (8 * nbytes - 1):
            v -= 1 << (8 * nbytes)
        return v

    def u8(self):
        return self.uint(1)

    def u16(self):
        return self.uint(2)

    def u32(self):
        return self.uint(4)

    def u64(self):
        return self.uint(8)

    def u128(self):
        return self.uint(16)

    def u256(self):
        return self.uint(32)

    def boolean(self) -> bool:
        v = self._take(1)[0]
        if v > 1:
            raise ScaleError(f"bad bool byte: {v}")
        return v == 1

    def compact(self) -> int:
        first = self._take(1)[0]
        mode = first & 0b11
        if mode == 0b00:
            return first >> 2
        if mode == 0b01:
            return (first | (self._take(1)[0] << 8)) >> 2
        if mode == 0b10:
            rest = self._take(3)
            return (first | int.from_bytes(rest, "little") << 8) >> 2
        n = (first >> 2) + 4
        return int.from_bytes(self._take(n), "little")

    def byte_vec(self) -> bytes:
        return self._take(self.compact())

    def string(self) -> str:
        return self.byte_vec().decode()

    def option(self, dec: Callable[["Decoder"], Any]) -> Optional[Any]:
        tag = self._take(1)[0]
        if tag == 0:
            return None
        if tag != 1:
            raise ScaleError(f"bad option tag: {tag}")
        return dec(self)

    def vec(self, dec: Callable[["Decoder"], Any]) -> list[Any]:
        return [dec(self) for _ in range(self.compact())]

    def enum(self) -> int:
        return self.u8()
