"""Solidity contract-ABI codec.

Reference counterpart: FISCO-BCOS bcos-codec/bcos-codec/abi/
ContractABICodec.h (+ ContractABIType.h) — encode/decode of Solidity
function arguments and event data for the executor's precompiles and the
SDK's tx builders.

Implements the canonical Solidity ABI v2 layout from the public spec:
32-byte head slots, dynamic types deferred to the tail with offset heads,
function selectors as keccak256(signature)[:4]. Type grammar supported:
``uint<N>/int<N>/bool/address/bytes<N>/bytes/string``, fixed arrays
``T[k]``, dynamic arrays ``T[]``, and tuples ``(T1,T2,...)`` (arbitrarily
nested).

This is host-side plumbing (argument marshalling, not a hot loop); the
hashing it needs routes through the suite's Keccak (device-batchable when
selectors are computed in bulk by the SDK).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Sequence

WORD = 32
_UINT_RE = re.compile(r"^uint(\d+)?$")
_INT_RE = re.compile(r"^int(\d+)?$")
_BYTES_RE = re.compile(r"^bytes(\d+)$")
_ARRAY_RE = re.compile(r"^(.*)\[(\d*)\]$")


class ABIError(ValueError):
    pass


@dataclass(frozen=True)
class _Type:
    kind: str  # uint | int | bool | address | bytesN | bytes | string | array | tuple
    bits: int = 0  # uint/int width, bytesN length
    elem: "_Type | None" = None  # array element
    count: int = -1  # fixed array length; -1 = dynamic
    members: tuple["_Type", ...] = ()  # tuple members

    @property
    def dynamic(self) -> bool:
        if self.kind in ("bytes", "string"):
            return True
        if self.kind == "array":
            return self.count < 0 or self.elem.dynamic  # type: ignore[union-attr]
        if self.kind == "tuple":
            return any(m.dynamic for m in self.members)
        return False

    def head_words(self) -> int:
        """Number of 32-byte words this type occupies in the head."""
        if self.dynamic:
            return 1
        if self.kind == "array":
            return self.count * self.elem.head_words()  # type: ignore[union-attr]
        if self.kind == "tuple":
            return sum(m.head_words() for m in self.members)
        return 1


def parse_type(s: str) -> _Type:
    s = s.strip()
    m = _ARRAY_RE.match(s)
    if m:
        elem = parse_type(m.group(1))
        count = int(m.group(2)) if m.group(2) else -1
        return _Type("array", elem=elem, count=count)
    if s.startswith("(") and s.endswith(")"):
        return _Type("tuple", members=tuple(
            parse_type(p) for p in _split_tuple(s[1:-1])))
    if s == "bool":
        return _Type("bool")
    if s == "address":
        return _Type("address")
    if s == "bytes":
        return _Type("bytes")
    if s == "string":
        return _Type("string")
    m = _BYTES_RE.match(s)
    if m:
        n = int(m.group(1))
        if not 1 <= n <= 32:
            raise ABIError(f"bad bytesN width: {s}")
        return _Type("bytesN", bits=n)
    m = _UINT_RE.match(s)
    if m:
        bits = int(m.group(1) or 256)
        if bits % 8 or not 8 <= bits <= 256:
            raise ABIError(f"bad uint width: {s}")
        return _Type("uint", bits=bits)
    m = _INT_RE.match(s)
    if m:
        bits = int(m.group(1) or 256)
        if bits % 8 or not 8 <= bits <= 256:
            raise ABIError(f"bad int width: {s}")
        return _Type("int", bits=bits)
    raise ABIError(f"unknown ABI type: {s!r}")


def _split_tuple(s: str) -> list[str]:
    parts, depth, cur = [], 0, []
    for ch in s:
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
            continue
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        cur.append(ch)
    if cur or not parts:
        parts.append("".join(cur))
    return [p for p in parts if p]


def canonical(s: str) -> str:
    """Canonical signature form of a type (uint -> uint256 etc.)."""
    t = parse_type(s)

    def fmt(t: _Type) -> str:
        if t.kind == "uint":
            return f"uint{t.bits}"
        if t.kind == "int":
            return f"int{t.bits}"
        if t.kind == "bytesN":
            return f"bytes{t.bits}"
        if t.kind == "array":
            return fmt(t.elem) + (f"[{t.count}]" if t.count >= 0 else "[]")
        if t.kind == "tuple":
            return "(" + ",".join(fmt(m) for m in t.members) + ")"
        return t.kind

    return fmt(t)


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------

def _enc_word_int(v: int, bits: int, signed: bool) -> bytes:
    lim = 1 << bits
    if signed:
        if not -(lim >> 1) <= v < (lim >> 1):
            raise ABIError(f"int{bits} out of range: {v}")
        v %= 1 << 256
    else:
        if not 0 <= v < lim:
            raise ABIError(f"uint{bits} out of range: {v}")
    return v.to_bytes(WORD, "big")


def _encode_one(t: _Type, v: Any) -> bytes:
    if t.kind == "uint":
        return _enc_word_int(int(v), t.bits, False)
    if t.kind == "int":
        return _enc_word_int(int(v), t.bits, True)
    if t.kind == "bool":
        return (1 if v else 0).to_bytes(WORD, "big")
    if t.kind == "address":
        b = bytes.fromhex(v[2:] if isinstance(v, str) and v.startswith("0x")
                          else v) if isinstance(v, str) else bytes(v)
        if len(b) != 20:
            raise ABIError(f"address must be 20 bytes, got {len(b)}")
        return b.rjust(WORD, b"\x00")
    if t.kind == "bytesN":
        b = bytes(v)
        if len(b) != t.bits:
            raise ABIError(f"bytes{t.bits} got {len(b)} bytes")
        return b.ljust(WORD, b"\x00")
    if t.kind in ("bytes", "string"):
        b = v.encode() if isinstance(v, str) else bytes(v)
        padded = b.ljust((len(b) + WORD - 1) // WORD * WORD, b"\x00")
        return len(b).to_bytes(WORD, "big") + padded
    if t.kind == "array":
        items = list(v)
        if t.count >= 0:
            if len(items) != t.count:
                raise ABIError(f"fixed array wants {t.count}, got {len(items)}")
            return _encode_seq([t.elem] * t.count, items)
        return (len(items).to_bytes(WORD, "big")
                + _encode_seq([t.elem] * len(items), items))
    if t.kind == "tuple":
        return _encode_seq(list(t.members), list(v))
    raise ABIError(f"cannot encode {t}")


def _encode_seq(types: Sequence[_Type], values: Sequence[Any]) -> bytes:
    if len(types) != len(values):
        raise ABIError(f"arity mismatch: {len(types)} types, {len(values)} values")
    head_size = sum(t.head_words() for t in types) * WORD
    heads: list[bytes] = []
    tails: list[bytes] = []
    tail_off = head_size
    for t, v in zip(types, values):
        if t.dynamic:
            heads.append(tail_off.to_bytes(WORD, "big"))
            enc = _encode_one(t, v)
            tails.append(enc)
            tail_off += len(enc)
        else:
            heads.append(_encode_one(t, v))
    return b"".join(heads) + b"".join(tails)


def encode(types: Sequence[str], values: Sequence[Any]) -> bytes:
    """ABI-encode values against a list of type strings."""
    return _encode_seq([parse_type(t) for t in types], values)


def selector(signature: str, hash_fn) -> bytes:
    """4-byte function selector; hash_fn is the suite hash (keccak/sm3)."""
    name, _, args = signature.partition("(")
    args = args.rstrip(")")
    canon = name + "(" + ",".join(
        canonical(a) for a in _split_tuple(args)) + ")"
    return hash_fn(canon.encode())[:4]


def encode_call(signature: str, values: Sequence[Any], hash_fn) -> bytes:
    """selector || encoded args."""
    _, _, args = signature.partition("(")
    types = _split_tuple(args.rstrip(")"))
    return selector(signature, hash_fn) + encode(types, values)


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

def _dec_word(data: bytes, off: int) -> bytes:
    w = data[off:off + WORD]
    if len(w) != WORD:
        raise ABIError("truncated ABI data")
    return w


def _decode_one(t: _Type, data: bytes, off: int) -> tuple[Any, int]:
    """Decode one head entry at `off`; returns (value, head_words_consumed)."""
    if t.kind == "uint":
        return int.from_bytes(_dec_word(data, off), "big"), 1
    if t.kind == "int":
        v = int.from_bytes(_dec_word(data, off), "big")
        if v >= 1 << 255:
            v -= 1 << 256
        return v, 1
    if t.kind == "bool":
        return _dec_word(data, off)[-1] != 0, 1
    if t.kind == "address":
        return _dec_word(data, off)[12:], 1
    if t.kind == "bytesN":
        return _dec_word(data, off)[:t.bits], 1
    if t.dynamic:
        tail = int.from_bytes(_dec_word(data, off), "big")
        return _decode_tail(t, data, tail), 1
    if t.kind == "array":  # static array
        out = []
        o = off
        for _ in range(t.count):
            v, used = _decode_one(t.elem, data, o)
            out.append(v)
            o += used * WORD
        return out, t.count * t.elem.head_words()
    if t.kind == "tuple":  # static tuple
        out = []
        o = off
        used_total = 0
        for m in t.members:
            v, used = _decode_one(m, data, o)
            out.append(v)
            o += used * WORD
            used_total += used
        return tuple(out), used_total
    raise ABIError(f"cannot decode {t}")


def _decode_tail(t: _Type, data: bytes, off: int) -> Any:
    if t.kind in ("bytes", "string"):
        n = int.from_bytes(_dec_word(data, off), "big")
        b = data[off + WORD:off + WORD + n]
        if len(b) != n:
            raise ABIError("truncated dynamic bytes")
        return b.decode() if t.kind == "string" else b
    if t.kind == "array":
        if t.count < 0:
            n = int.from_bytes(_dec_word(data, off), "big")
            base = off + WORD
        else:
            n = t.count
            base = off
        vals, _ = _decode_rel([t.elem] * n, data, base)
        return vals
    if t.kind == "tuple":
        vals, _ = _decode_rel(list(t.members), data, off)
        return tuple(vals)
    raise ABIError(f"cannot decode tail {t}")


def _decode_rel(types: Sequence[_Type], data: bytes, base: int
                ) -> tuple[list[Any], int]:
    """Decode a head sequence whose dynamic offsets are relative to base."""
    out = []
    o = base
    for t in types:
        if t.dynamic:
            rel = int.from_bytes(_dec_word(data, o), "big")
            out.append(_decode_tail(t, data, base + rel))
            o += WORD
        else:
            v, used = _decode_one(t, data, o)
            out.append(v)
            o += used * WORD
    return out, o - base


def decode(types: Sequence[str], data: bytes) -> list[Any]:
    """ABI-decode a buffer against a list of type strings."""
    vals, _ = _decode_rel([parse_type(t) for t in types], data, 0)
    return vals


def decode_output(signature_types: Sequence[str], data: bytes) -> list[Any]:
    return decode(signature_types, data)
