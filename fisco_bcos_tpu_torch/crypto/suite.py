"""Batch-first CryptoSuite of the port: the default chain (secp256k1 +
Keccak-256) and the SM chain (SM2 + SM3, GB/T 32918 / 32905) on PyTorch
and the CUDA kernels.

Counterpart of fisco_bcos_tpu/crypto/suite.py, with the same batch API:

    verify_batch(hashes, sigs, pubs)  -> bool[N]
    recover_batch(hashes, sigs)       -> (pubs[N], ok[N])
    recover_addresses(hashes, sigs)   -> (addresses[N], ok[N])
    hash_batch(msgs)                  -> digest[N]
    merkle_root(leaves)               -> digest
    poseidon_batch(lefts, rights)     -> digest[N]   (BN254 Poseidon, ZK plane)

`backend` keeps the JAX suite's meaning: "device" always takes the tensor
path, "host" always the host path, "auto" the tensor path at or above
`device_min_batch`. The host path is the JAX suite's: the native libraries
(`crypto/nativehash.py` for hashing, `crypto/nativeec.py` for signing,
verify and recovery), with the pure-Python `refimpl` as the fallback where
a library is absent; `refimpl` stays the oracle the tests hold every path
to. The tensor path
runs on `device`: on "cuda" it launches the kernels, on "cpu" it runs
their plain PyTorch versions (what the CPU tests use). A suite on "cuda"
raises when there is no card; it never drops to the CPU.

`ec_route` picks the EC route of verify and recovery (ops/ec.py):
"fused", one whole-signature kernel per batch (the JAX package with
FBTPU_FUSED_VERIFY=1), or "composed", the fp, pow and ladder kernels (the
JAX package's default on a TPU). Both give the same results.

Device batches keep the JAX suite's padding: up to CHUNK rows pad to the
next of BUCKETS, larger batches run as CHUNK-sized calls.

`mesh_devices` keeps the JAX suite's meaning on one device: with fewer
than two cards the suite runs unsharded. Sharding over several cards is
not ported and raises.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch

from . import nativeec, nativehash, refimpl
from ..ops import bigint, ec, keccak, merkle, sm3
from ..zk import poseidon, poseidon_torch

DIGEST = 32
BUCKETS = (8, 64, 512, 4096, 16384, 65536)
CHUNK = 16384
_ZERO32 = b"\x00" * 32


def _bucket(n: int) -> int:
    for b in BUCKETS:
        if n <= b:
            return b
    return ((n + BUCKETS[-1] - 1) // BUCKETS[-1]) * BUCKETS[-1]


def _chunks(n: int) -> list[tuple[int, int]]:
    """[(offset, length)] covering n in CHUNK-sized pieces."""
    return [(o, min(CHUNK, n - o)) for o in range(0, n, CHUNK)]


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    if a.shape[0] == n:
        return a
    pad = np.zeros((n - a.shape[0],) + a.shape[1:], a.dtype)
    return np.concatenate([a, pad], axis=0)


def _limbs_of(values: Sequence[bytes]) -> np.ndarray:
    """Big-endian byte strings -> [N, 16] limbs of their integer values
    (int.from_bytes semantics; rows of exactly 32 bytes skip the ints)."""
    if all(len(v) == 32 for v in values):
        return bigint.rows_to_limbs(b"".join(values), len(values))
    return bigint.batch_to_limbs([int.from_bytes(v, "big") for v in values])


@dataclasses.dataclass(frozen=True)
class KeyPair:
    """Node/account key pair. The secret stays on the host."""

    secret: int
    pub: tuple[int, int]
    suite: "CryptoSuite"

    @property
    def pub_bytes(self) -> bytes:
        return self.pub[0].to_bytes(32, "big") + self.pub[1].to_bytes(32, "big")

    @property
    def address(self) -> bytes:
        return self.suite.address_of_pub(self.pub_bytes)


class CryptoSuite:
    """secp256k1 + Keccak-256 ("ecdsa") or SM2 + SM3 ("sm") with
    batch-native tensor paths. An SM signature is r | s | pub (128 bytes):
    its recovery is a verify against the embedded key."""

    def __init__(self, kind: str = "ecdsa", backend: str = "device",
                 device: str | torch.device = "cuda",
                 device_min_batch: int = 512,
                 mesh_devices: int | None = None,
                 ec_route: str = "fused"):
        if kind not in ("ecdsa", "sm"):
            raise ValueError(f"unknown crypto suite kind: {kind}")
        if backend not in ("device", "host", "auto"):
            raise ValueError(f"unknown backend: {backend}")
        if ec_route not in ec.ROUTES:
            raise ValueError(f"unknown EC route: {ec_route}")
        self.ec_route = ec_route
        self.kind = kind
        self.backend = backend
        self.device = torch.device(device)
        if (backend != "host" and self.device.type == "cuda"
                and not torch.cuda.is_available()):
            raise RuntimeError(
                "CryptoSuite(device='cuda'): no CUDA device is available; "
                "pass device='cpu' to run the plain PyTorch path")
        self.device_min_batch = device_min_batch
        # as the JAX suite's mesh (parallel/mesh.local_mesh): with fewer than
        # two devices the suite runs unsharded, buckets and all
        self.mesh_devices = mesh_devices or 0
        if (self.mesh_devices >= 2 and backend != "host"
                and self.device.type == "cuda" and torch.cuda.device_count() >= 2):
            raise NotImplementedError(
                "mesh_devices >= 2 on several GPUs: sharding is the "
                "multi-GPU slice queued in ROADMAP.md")
        # the per-kind parts, chosen once: hashes, signing, verify, recovery
        if kind == "ecdsa":
            self.curve = ec.SECP256K1
            self.params = refimpl.SECP256K1
            self.hash_name = "keccak256"
            self._host_hash = nativehash.host_hash("keccak256")
            self._host_hash_batch = nativehash.host_hash_batch("keccak256")
            self.signature_size = 65  # r(32) | s(32) | v(1)
            self._hash_np = keccak.keccak256_batch_np
            self._sign = _sign_ecdsa
            self._verify_lanes = ec.ecdsa_verify_batch
            self._verify_native = nativeec.ecdsa_verify_batch
            self._verify_host = functools.partial(refimpl.ecdsa_verify, self.params)
            self._recover = self._recover_ecdsa
            self._addresses_device = self._ecdsa_addresses
        else:
            self.curve = ec.SM2P256V1
            self.params = refimpl.SM2P256V1
            self.hash_name = "sm3"
            self._host_hash = nativehash.host_hash("sm3")
            self._host_hash_batch = nativehash.host_hash_batch("sm3")
            self.signature_size = 128  # r(32) | s(32) | pub(64)
            self._hash_np = sm3.sm3_batch_np
            self._sign = _sign_sm
            self._verify_lanes = ec.sm2_verify_batch
            self._verify_native = nativeec.sm2_verify_batch
            self._verify_host = refimpl.sm2_verify
            self._recover = self._recover_embedded
            self._addresses_device = self._sm_addresses

    def __repr__(self):
        return (f"CryptoSuite({self.kind}, backend={self.backend}, device={self.device}, "
                f"ec_route={self.ec_route})")

    # -- hashing -----------------------------------------------------------
    def hash(self, data: bytes) -> bytes:
        return self._host_hash(data)

    def hash_batch(self, msgs: Sequence[bytes]) -> list[bytes]:
        """Batched Keccak-256 or SM3: one kernel launch a length class
        (ops.keccak.length_classes); the host path crosses the FFI once."""
        if not msgs:
            return []
        if not self._use_device(len(msgs)):
            return self._host_hash_batch(msgs)
        return [bytes(row) for row in self._hash_np(list(msgs), device=self.device)]

    def poseidon_batch(self, lefts: Sequence[bytes],
                       rights: Sequence[bytes]) -> list[bytes]:
        """Batched Poseidon arity-2 compression over the BN254 scalar field
        (zk/poseidon.py oracle, zk/poseidon_torch.py tensor path), the hash
        the ZK proof plane builds its Merkle trees from (zk/merkle.py).
        Inputs are 32-byte big-endian values (reduced mod r on entry);
        outputs are canonical field elements. Gated as hash_batch is."""
        n = len(lefts)
        if len(rights) != n:
            raise ValueError("poseidon_batch: lefts and rights differ in length")
        if n == 0:
            return []
        if not self._use_device(n):
            return poseidon.hash2_batch_host(lefts, rights)
        return poseidon_torch.hash2_batch(lefts, rights, device=self.device)

    def merkle_root(self, leaves: Sequence[bytes]) -> bytes:
        """Width-16 Merkle root (the suite's hash) over 32-byte digests."""
        if len(leaves) == 0:
            return b"\x00" * DIGEST
        if not self._use_device(len(leaves)):
            return merkle.merkle_levels_host(list(leaves), self.hash_name)[-1][0]
        arr = np.frombuffer(bytearray(b"".join(leaves)), np.uint8).reshape(
            len(leaves), DIGEST)
        root = merkle.merkle_root(torch.as_tensor(arr, device=self.device),
                                  self.hash_name)
        return bytes(root.cpu().numpy())

    # -- keys and signing (host, single) -----------------------------------
    def generate_keypair(self, seed: bytes | None = None) -> KeyPair:
        secret, pub = refimpl.keygen(self.params, seed)
        return KeyPair(secret, pub, self)

    def keypair_from_secret(self, secret: int) -> KeyPair:
        pub = refimpl.ec_mul(self.params, secret, (self.params.gx, self.params.gy))
        return KeyPair(secret, pub, self)

    def address_of_pub(self, pub_bytes: bytes) -> bytes:
        """Right-160 bits of H(pubkey)."""
        return self._host_hash(pub_bytes)[12:]

    def sign(self, kp, digest: bytes) -> bytes:
        if hasattr(kp, "sign_digest"):  # HSM-backed: the secret stays inside
            return kp.sign_digest(digest)
        return self._sign(kp, digest)

    # -- verification / recovery (batch-native) ----------------------------
    def verify(self, pub_bytes: bytes, digest: bytes, sig: bytes) -> bool:
        return bool(self.verify_batch([digest], [sig], [pub_bytes])[0])

    def recover(self, digest: bytes, sig: bytes) -> bytes | None:
        pubs, ok = self.recover_batch([digest], [sig])
        return pubs[0] if ok[0] else None

    def _use_device(self, n: int) -> bool:
        if self.backend == "host":
            return False
        if self.backend == "device":
            return True
        return n >= self.device_min_batch

    def _bucket_for(self, n: int) -> int:
        return _bucket(n)

    def _sig_rows(self, sigs: Sequence[bytes]):
        """(r rows, s rows, v ids): malformed (short) signatures become
        r = s = 0 and v = 255, which every path rejects."""
        ok = [len(g) >= self.signature_size for g in sigs]
        rs = [g[:32] if k else _ZERO32 for g, k in zip(sigs, ok)]
        ss = [g[32:64] if k else _ZERO32 for g, k in zip(sigs, ok)]
        vs = [g[64] if len(g) >= 65 else 255 for g in sigs]
        return rs, ss, vs

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a.astype(np.int32), device=self.device)

    def _padded_calls(self, fn, arrays):
        """Run fn over row-padded pieces of arrays; -> [(length, result)]."""
        n = arrays[0].shape[0]
        if n <= CHUNK:
            b = self._bucket_for(n)
            return [(n, fn(*(self._tensor(_pad_rows(a, b)) for a in arrays)))]
        return [(ln, fn(*(self._tensor(_pad_rows(a[o:o + ln], CHUNK))
                          for a in arrays)))
                for o, ln in _chunks(n)]

    def verify_batch(self, digests: Sequence[bytes], sigs: Sequence[bytes],
                     pubs: Sequence[bytes]) -> np.ndarray:
        """-> bool[N]. pubs are 64-byte uncompressed keys; a trailing v
        byte (ecdsa) or embedded key (sm) on a signature is ignored."""
        n = len(digests)
        if len(sigs) != n or len(pubs) != n:
            raise ValueError("verify_batch: digests, sigs and pubs differ in length")
        if n == 0:
            return np.zeros((0,), bool)
        rs, ss, _ = self._sig_rows(sigs)
        if not self._use_device(n):
            native = self._verify_native(
                [int.from_bytes(d, "big") for d in digests],
                [int.from_bytes(r, "big") for r in rs],
                [int.from_bytes(s, "big") for s in ss],
                [int.from_bytes(p[:32], "big") for p in pubs],
                [int.from_bytes(p[32:64], "big") for p in pubs])
            if native is not None:
                return np.array(native, dtype=bool)
            return np.array([self._verify_host(
                (int.from_bytes(p[:32], "big"), int.from_bytes(p[32:64], "big")),
                d, int.from_bytes(r, "big"), int.from_bytes(s, "big"))
                for d, r, s, p in zip(digests, rs, ss, pubs)], dtype=bool)
        arrays = [_limbs_of(digests), _limbs_of(rs), _limbs_of(ss),
                  _limbs_of([p[:32] for p in pubs]),
                  _limbs_of([p[32:64] for p in pubs])]
        parts = self._padded_calls(
            lambda *a: self._verify_lanes(self.curve, *a, route=self.ec_route), arrays)
        return np.concatenate([ok[:ln].cpu().numpy() for ln, ok in parts])

    def _recover_device(self, digests, sigs):
        """Device recovery -> (qx, qy [N, 16] int64 tensors, ok bool[N])
        on self.device."""
        rs, ss, vs = self._sig_rows(sigs)
        arrays = [_limbs_of(digests), _limbs_of(rs), _limbs_of(ss),
                  np.array(vs, np.int32)]
        parts = self._padded_calls(
            lambda e, r, s, v: ec.ecdsa_recover_batch(self.curve, e, r, s, v,
                                                      route=self.ec_route),
            arrays)
        return tuple(torch.cat([p[k][:ln] for ln, p in parts])
                     for k in range(3))

    def _recover_host(self, digests, sigs):
        rs, ss, vs = self._sig_rows(sigs)
        if all(len(d) == 32 for d in digests):
            # 32-byte digests and signature halves are the count x 32
            # big-endian rows the library reads: no int round trips
            native = nativeec.ecdsa_recover_batch_rows(
                b"".join(digests), b"".join(rs), b"".join(ss), bytes(vs))
        else:
            native = nativeec.ecdsa_recover_batch(
                [int.from_bytes(d, "big") for d in digests],
                [int.from_bytes(r, "big") for r in rs],
                [int.from_bytes(s, "big") for s in ss], vs)
        if native is not None:
            return native[0], np.array(native[1], dtype=bool)
        out, okl = [], []
        for d, r, s, v in zip(digests, rs, ss, vs):
            Q = refimpl.ecdsa_recover(self.params, d, int.from_bytes(r, "big"),
                                      int.from_bytes(s, "big"), v)
            okl.append(Q is not None)
            out.append(Q[0].to_bytes(32, "big") + Q[1].to_bytes(32, "big")
                       if Q is not None else None)
        return out, np.array(okl, dtype=bool)

    def recover_batch(self, digests: Sequence[bytes], sigs: Sequence[bytes]
                      ) -> tuple[list[bytes | None], np.ndarray]:
        """-> (64-byte pub keys (None where invalid), ok[N])."""
        n = len(digests)
        if len(sigs) != n:
            raise ValueError("recover_batch: digests and sigs differ in length")
        if n == 0:
            return [], np.zeros((0,), bool)
        return self._recover(digests, sigs)

    def _recover_embedded(self, digests, sigs):
        """SM: a verify against the key each signature carries (zero for a
        short signature)."""
        pubs = [g[64:128] if len(g) >= 128 else bytes(64) for g in sigs]
        ok = self.verify_batch(digests, sigs, pubs)
        return [p if o else None for p, o in zip(pubs, ok)], ok

    def _recover_ecdsa(self, digests, sigs):
        if not self._use_device(len(digests)):
            return self._recover_host(digests, sigs)
        qx, qy, ok = self._recover_device(digests, sigs)
        ok = ok.cpu().numpy()
        rows = np.concatenate([bigint.limbs_to_rows(qx.cpu().numpy()),
                               bigint.limbs_to_rows(qy.cpu().numpy())], axis=1)
        return [bytes(row) if o else None for row, o in zip(rows, ok)], ok

    def recover_addresses(self, digests: Sequence[bytes], sigs: Sequence[bytes]
                          ) -> tuple[list[bytes | None], np.ndarray]:
        """Sender addresses (right-160 of H(pub)) for a tx batch, None
        where the signature is invalid. The device path hashes the keys on
        the device too (kernel 3, or kernel A for SM)."""
        n = len(digests)
        if len(sigs) != n:
            raise ValueError("recover_addresses: digests and sigs differ in length")
        if n == 0 or not self._use_device(n):
            pubs, ok = self.recover_batch(digests, sigs)
            return [self.address_of_pub(p) if p is not None else None
                    for p in pubs], ok
        return self._addresses_device(digests, sigs)

    def _ecdsa_addresses(self, digests, sigs):
        """Recover on the device, then Keccak of the keys where they lie."""
        qx, qy, ok = self._recover_device(digests, sigs)
        digest = keccak.keccak256_varlen(pub_blocks(qx, qy),
                                         torch.ones_like(ok, dtype=torch.int32))
        addrs = digest[:, 12:].cpu().numpy()
        ok = ok.cpu().numpy()
        return [bytes(a) if o else None for a, o in zip(addrs, ok)], ok

    def _sm_addresses(self, digests, sigs):
        """Verify against the embedded keys, then SM3 of the valid keys
        (two blocks each) in one kernel launch."""
        pubs, ok = self._recover_embedded(digests, sigs)
        valid = np.flatnonzero(ok)
        out: list[bytes | None] = [None] * len(pubs)
        if valid.size:
            keys = np.frombuffer(b"".join(pubs[i] for i in valid), np.uint8)
            blocks = np.tile(sm3.pad_message_np(bytes(64)).reshape(-1), (valid.size, 1))
            blocks[:, :64] = keys.reshape(valid.size, 64)
            digest = sm3.sm3_varlen(
                torch.as_tensor(blocks.reshape(valid.size, 2, sm3.BLOCK_BYTES),
                                device=self.device),
                torch.full((valid.size,), 2, dtype=torch.int32, device=self.device))
            for i, a in zip(valid, digest[:, 12:].cpu().numpy()):
                out[i] = bytes(a)
        return out, ok

def pub_blocks(qx: torch.Tensor, qy: torch.Tensor) -> torch.Tensor:
    """Affine keys [N, 16] limbs -> [N, 1, 136] Keccak-padded blocks of
    the 64-byte big-endian encodings x || y, built where the keys lie."""
    limbs = torch.cat([qx.flip(-1), qy.flip(-1)], dim=-1)  # big-endian limbs
    be = torch.stack([limbs >> 8, limbs & 0xFF], dim=-1).reshape(-1, 64)
    blocks = torch.zeros((be.shape[0], keccak.RATE_BYTES), dtype=torch.uint8,
                         device=be.device)
    blocks[:, :64] = be.to(torch.uint8)
    blocks[:, 64] = 0x01
    blocks[:, -1] = 0x80
    return blocks[:, None, :]


def _sign_ecdsa(kp: KeyPair, digest: bytes) -> bytes:
    """Native EC with the RFC 6979 nonce from the oracle: byte-exact with
    refimpl.ecdsa_sign, which stays the fallback."""
    sig = nativeec.ecdsa_sign(kp.secret, digest)
    r, s, v = sig if sig is not None else \
        refimpl.ecdsa_sign(refimpl.SECP256K1, kp.secret, digest)
    return r.to_bytes(32, "big") + s.to_bytes(32, "big") + bytes([v])


def _sign_sm(kp: KeyPair, digest: bytes) -> bytes:
    sig = nativeec.sm2_sign(kp.secret, digest)
    r, s = sig if sig is not None else refimpl.sm2_sign(kp.secret, digest)
    return r.to_bytes(32, "big") + s.to_bytes(32, "big") + kp.pub_bytes


def make_suite(sm_crypto: bool = False, **kw) -> CryptoSuite:
    """chain.sm_crypto -> suite selection."""
    return CryptoSuite("sm" if sm_crypto else "ecdsa", **kw)
