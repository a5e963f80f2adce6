"""Disk encryption: node-key files + storage values at rest.

Reference counterpart: FISCO-BCOS bcos-security/bcos-security/
DataEncryption.h:35-55 (`decryptFile` for node.key, `encrypt`/`decrypt`
hooked into the storage value path) and KeyCenter.cpp (fetch the data key
from an external key-management service), configured by the
`storage_security.*` section (bcos-tool/bcos-tool/NodeConfig.cpp:579-606).

The data key is obtained from a KeyCenter (external KMS seam; the local
implementation derives it from a passphrase) and drives an authenticated
SM4/AES-CTR envelope (crypto.symm). `EncryptedStorage` wraps any
TransactionalStorage and transparently seals every value — the same
layering as the reference's encryption hook inside its storage builders.
"""

from __future__ import annotations

import hashlib
import os
from typing import Iterator, Optional

from ..crypto.symm import BlockCipher
from ..storage.interface import ChangeSet, Entry, TransactionalStorage


class KeyCenter:
    """Data-key provider seam (reference: KeyCenter service client).

    The local implementation derives the data key from a passphrase
    (scrypt); a networked KMS implements `data_key` the same way.
    """

    def __init__(self, passphrase: bytes, salt: bytes = b"fisco-bcos-tpu"):
        self._pass = passphrase
        self._salt = salt

    def data_key(self) -> bytes:
        return hashlib.scrypt(self._pass, salt=self._salt, n=2 ** 12, r=8,
                              p=1, dklen=16)


class DataEncryption:
    """File/value encryption driven by the KeyCenter's data key."""

    def __init__(self, key_center: KeyCenter, algorithm: str = "aes"):
        self.cipher = BlockCipher(algorithm, key_center.data_key())

    # -- values ------------------------------------------------------------
    def encrypt(self, data: bytes) -> bytes:
        return self.cipher.seal(data)

    def decrypt(self, data: bytes) -> bytes:
        return self.cipher.open_sealed(data)

    # -- files (node.key protection; DataEncryption::decryptFile) ----------
    def encrypt_file(self, src_path: str, dst_path: Optional[str] = None) -> str:
        dst_path = dst_path or src_path + ".enc"
        with open(src_path, "rb") as f:
            blob = self.encrypt(f.read())
        tmp = dst_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, dst_path)
        return dst_path

    def decrypt_file(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return self.decrypt(f.read())


class EncryptedStorage(TransactionalStorage):
    """Transparent value encryption over any transactional backend."""

    def __init__(self, backend: TransactionalStorage, enc: DataEncryption):
        self.backend = backend
        self.enc = enc

    def get(self, table: str, key: bytes) -> Optional[bytes]:
        raw = self.backend.get(table, key)
        return self.enc.decrypt(raw) if raw is not None else None

    def set(self, table: str, key: bytes, value: bytes) -> None:
        self.backend.set(table, key, self.enc.encrypt(value))

    def remove(self, table: str, key: bytes) -> None:
        self.backend.remove(table, key)

    def keys(self, table: str, prefix: bytes = b"") -> Iterator[bytes]:
        return self.backend.keys(table, prefix)

    def prepare(self, block_number: int, changes: ChangeSet) -> None:
        sealed: ChangeSet = {}
        for tk, e in changes.items():
            sealed[tk] = e if e.deleted else Entry(self.enc.encrypt(e.value),
                                                  e.status)
        self.backend.prepare(block_number, sealed)

    def commit(self, block_number: int) -> None:
        self.backend.commit(block_number)

    def rollback(self, block_number: int) -> None:
        self.backend.rollback(block_number)

    def close(self) -> None:
        self.backend.close()
