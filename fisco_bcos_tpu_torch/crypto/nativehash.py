"""Native host-path hashing — ctypes binding to native/nevm's C++
Keccak-256 / SM3.

The reference hashes through OpenSSL EVP everywhere
(FISCO-BCOS bcos-crypto/bcos-crypto/hasher/OpenSSLHasher.h:23); this
framework's DEVICE batches hash on the card (ops.keccak / ops.sm3), but
below-threshold host-path hashing (single tx hashes, header hashes,
address derivation, test fixtures) ran on the pure-Python reference
implementation. These bindings give the host path native speed while
`crypto.refimpl` stays the untouched pure-Python oracle the golden tests
compare every implementation against.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Callable, Optional

_BUF32 = ctypes.c_uint8 * 32

_fns: dict = {}
_loaded = False
_lock = threading.Lock()


def _load() -> dict:
    global _loaded
    with _lock:  # _loaded flips only AFTER binding: a concurrent first
        if _loaded:  # caller can never observe a half-initialized state
            return _fns
        from ..executor import nevm

        lib = nevm.load_library()
        if lib is not None:
            try:
                for name in ("nevm_keccak256", "nevm_sm3"):
                    fn = getattr(lib, name)
                    fn.argtypes = [ctypes.c_char_p, ctypes.c_uint64, _BUF32]
                    fn.restype = None
                _fns["keccak256"] = lib.nevm_keccak256
                _fns["sm3"] = lib.nevm_sm3
            except AttributeError:  # library build without the exports
                _fns.clear()
            try:  # batch exports bind separately: an older library that
                # lacks them must KEEP the native singles (host_hash_batch
                # falls back to a per-message loop on its own)
                u64p = ctypes.POINTER(ctypes.c_uint64)
                u8p = ctypes.POINTER(ctypes.c_uint8)
                for name in ("nevm_keccak256_batch", "nevm_sm3_batch"):
                    fn = getattr(lib, name)
                    fn.argtypes = [ctypes.c_char_p, u64p, ctypes.c_uint64,
                                   u8p]
                    fn.restype = None
                _fns["keccak256_batch"] = lib.nevm_keccak256_batch
                _fns["sm3_batch"] = lib.nevm_sm3_batch
            except AttributeError:
                pass
        _loaded = True
        return _fns


def _wrap(name: str) -> Optional[Callable[[bytes], bytes]]:
    fn = _load().get(name)
    if fn is None:
        return None

    def h(data) -> bytes:
        out = _BUF32()
        # bytes() coercion: match refimpl's acceptance of bytearray/
        # memoryview (c_char_p takes only bytes)
        fn(data if isinstance(data, bytes) else bytes(data), len(data), out)
        return bytes(out)

    return h


def keccak256() -> Optional[Callable[[bytes], bytes]]:
    """-> native keccak256(data)->digest, or None when unavailable."""
    return _wrap("keccak256")


def sm3() -> Optional[Callable[[bytes], bytes]]:
    """-> native sm3(data)->digest, or None when unavailable."""
    return _wrap("sm3")


def _wrap_batch(name: str) -> Optional[Callable]:
    fn = _load().get(name)
    if fn is None:
        return None

    def h(msgs) -> list[bytes]:
        n = len(msgs)
        if n == 0:
            return []
        flat = b"".join(bytes(m) if not isinstance(m, bytes) else m
                        for m in msgs)
        offs = (ctypes.c_uint64 * (n + 1))()
        pos = 0
        for i, m in enumerate(msgs):
            offs[i] = pos
            pos += len(m)
        offs[n] = pos
        out = (ctypes.c_uint8 * (32 * n))()
        fn(flat, offs, n, out)
        raw = bytes(out)
        return [raw[32 * i:32 * i + 32] for i in range(n)]

    return h


def keccak256_batch() -> Optional[Callable]:
    """-> native batch keccak(msgs)->[digest], one FFI crossing, or None."""
    return _wrap_batch("keccak256_batch")


def sm3_batch() -> Optional[Callable]:
    return _wrap_batch("sm3_batch")


def host_hash_batch(alg: str) -> Callable:
    """Batched host-path hashing for `alg`: one native call per batch when
    available, else a per-message loop over host_hash."""
    fn = (keccak256_batch() if alg == "keccak256" else
          sm3_batch() if alg == "sm3" else None)
    if fn is not None:
        return fn
    single = host_hash(alg)
    return lambda msgs: [single(m) for m in msgs]


def host_hash(alg: str) -> Callable[[bytes], bytes]:
    """Host-path hash for `alg` ("keccak256" | "sm3"): native when the
    library is loadable, pure-Python refimpl otherwise. The single place
    the native-or-oracle fallback policy lives."""
    from . import refimpl

    if alg == "keccak256":
        return keccak256() or refimpl.keccak256
    if alg == "sm3":
        return sm3() or refimpl.sm3
    raise ValueError(f"unknown hash alg {alg!r}")
