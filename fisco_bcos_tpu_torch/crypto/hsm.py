"""HSM crypto seam (hardware security module signing/verification).

Reference counterpart: FISCO-BCOS bcos-crypto/bcos-crypto/signature/
hsmSM2/HsmSM2Crypto.cpp (SM2 via the hsm-crypto SDF library, selected by
`security.enable_hsm` + key-index config, NodeConfig.cpp:549-556) and the
HSM CryptoSuite variant in libinitializer/ProtocolInitializer.cpp:118.

`HsmProvider` is the SDF seam: deployments with a hardware module register
a provider implementing key-index based sign/verify; `SoftHsmProvider`
is the bundled software emulation (keys held in a sealed keystore file),
which lets the HSM code path — key-index indirection, provider dispatch,
suite selection — run and be tested without hardware, mirroring how the
reference gates real hardware behind the hsm-crypto dependency.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from . import refimpl
from .symm import BlockCipher


class HsmProvider:
    """SDF-shaped interface: operations by key index, secrets stay inside."""

    def sign(self, key_index: int, digest: bytes) -> bytes:
        raise NotImplementedError

    def verify(self, key_index: int, digest: bytes, sig: bytes) -> bool:
        raise NotImplementedError

    def public_key(self, key_index: int) -> bytes:
        raise NotImplementedError


class SoftHsmProvider(HsmProvider):
    """Software HSM: SM2 keys in an encrypted keystore file."""

    def __init__(self, keystore_path: str, passphrase: bytes):
        self.path = keystore_path
        self.cipher = BlockCipher("sm4", passphrase)
        self._keys: dict[int, int] = {}
        if os.path.exists(keystore_path):
            blob = open(keystore_path, "rb").read()
            data = json.loads(self.cipher.open_sealed(blob))
            self._keys = {int(k): int(v) for k, v in data.items()}

    def _save(self) -> None:
        blob = self.cipher.seal(json.dumps(
            {str(k): str(v) for k, v in self._keys.items()}).encode())
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, self.path)

    def generate_key(self, key_index: int) -> bytes:
        secret, _ = refimpl.keygen(refimpl.SM2P256V1)
        self._keys[key_index] = secret
        self._save()
        return self.public_key(key_index)

    def public_key(self, key_index: int) -> bytes:
        secret = self._keys[key_index]
        pub = refimpl.ec_mul(refimpl.SM2P256V1, secret,
                             (refimpl.SM2P256V1.gx, refimpl.SM2P256V1.gy))
        return pub[0].to_bytes(32, "big") + pub[1].to_bytes(32, "big")

    def sign(self, key_index: int, digest: bytes) -> bytes:
        secret = self._keys[key_index]
        r, s = refimpl.sm2_sign(secret, digest)
        return (r.to_bytes(32, "big") + s.to_bytes(32, "big")
                + self.public_key(key_index))

    def verify(self, key_index: int, digest: bytes, sig: bytes) -> bool:
        pub_b = self.public_key(key_index)
        pub = (int.from_bytes(pub_b[:32], "big"),
               int.from_bytes(pub_b[32:], "big"))
        return refimpl.sm2_verify(pub, digest,
                                  int.from_bytes(sig[:32], "big"),
                                  int.from_bytes(sig[32:64], "big"))


class HsmKeyPair:
    """KeyPair-shaped adapter: CryptoSuite.sign() works unchanged while the
    secret never leaves the provider (suite kind must be 'sm')."""

    def __init__(self, provider: HsmProvider, key_index: int, suite):
        self.provider = provider
        self.key_index = key_index
        self.suite = suite
        self.pub_bytes = provider.public_key(key_index)
        self.secret: Optional[int] = None  # intentionally absent

    @property
    def address(self) -> bytes:
        return self.suite.address_of_pub(self.pub_bytes)

    def sign_digest(self, digest: bytes) -> bytes:
        return self.provider.sign(self.key_index, digest)
