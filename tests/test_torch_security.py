"""The port's disk encryption (security/dataencrypt.py) against the JAX
package's: tests/test_ha_security.py's cipher and encryption cases on the
port (the SM4 and AES vectors, the seal round trip and its tamper check,
node-key files and EncryptedStorage over a WAL), then the two packages
across each other: the KeyCenter's data key, sealed values and files, and
a WAL directory of sealed values written by either package read by the
other."""

import pytest

from fisco_bcos_tpu.security import DataEncryption as JDataEncryption
from fisco_bcos_tpu.security import EncryptedStorage as JEncryptedStorage
from fisco_bcos_tpu.security import KeyCenter as JKeyCenter
from fisco_bcos_tpu.storage.interface import Entry as JEntry
from fisco_bcos_tpu.storage.wal import WalStorage as JWalStorage
from fisco_bcos_tpu_torch.crypto.symm import (BlockCipher, aes128_encrypt_block,
                                              aes128_key_schedule, sm4_encrypt_block,
                                              sm4_key_schedule)
from fisco_bcos_tpu_torch.security import DataEncryption, EncryptedStorage, KeyCenter
from fisco_bcos_tpu_torch.storage.interface import Entry
from fisco_bcos_tpu_torch.storage.wal import WalStorage

PACKAGES = {
    "jax": (JDataEncryption, JEncryptedStorage, JKeyCenter, JEntry, JWalStorage),
    "port": (DataEncryption, EncryptedStorage, KeyCenter, Entry, WalStorage),
}


def test_sm4_standard_vector():
    key = bytes.fromhex("0123456789abcdeffedcba9876543210")
    pt = bytes.fromhex("0123456789abcdeffedcba9876543210")
    ct = sm4_encrypt_block(sm4_key_schedule(key), pt)
    assert ct.hex() == "681edf34d206965e86b3e94f536e4246"


def test_aes128_nist_vector():
    key = bytes.fromhex("000102030405060708090a0b0c0d0e0f")
    pt = bytes.fromhex("00112233445566778899aabbccddeeff")
    ct = aes128_encrypt_block(aes128_key_schedule(key), pt)
    assert ct.hex() == "69c4e0d86a7b0430d8cdb78070b4c55a"


@pytest.mark.parametrize("alg", ["sm4", "aes"])
def test_seal_roundtrip_and_tamper(alg):
    c = BlockCipher(alg, b"some-passphrase")
    msg = b"node.key material" * 7
    blob = c.seal(msg)
    assert c.open_sealed(blob) == msg
    bad = bytearray(blob)
    bad[20] ^= 1
    with pytest.raises(ValueError):
        c.open_sealed(bytes(bad))


def test_data_encryption_files_and_storage(tmp_path):
    enc = DataEncryption(KeyCenter(b"pw"), algorithm="aes")
    src = tmp_path / "node.key"
    src.write_bytes(b"secret-key-bytes")
    out = enc.encrypt_file(str(src))
    assert out.endswith(".enc")
    assert b"secret-key-bytes" not in (tmp_path / "node.key.enc").read_bytes()
    assert enc.decrypt_file(out) == b"secret-key-bytes"

    st = EncryptedStorage(WalStorage(str(tmp_path / "db")), enc)
    st.set("t", b"k", b"plaintext-value")
    assert st.get("t", b"k") == b"plaintext-value"
    assert st.backend.get("t", b"k") != b"plaintext-value"   # sealed at rest
    st.prepare(1, {("t", b"k2"): Entry(b"v2")})
    st.commit(1)
    assert st.get("t", b"k2") == b"v2"
    st.close()

    st2 = EncryptedStorage(WalStorage(str(tmp_path / "db")),
                           DataEncryption(KeyCenter(b"wrong")))
    with pytest.raises(ValueError):
        st2.get("t", b"k")
    st2.close()


@pytest.mark.parametrize("salt", [b"fisco-bcos-tpu", b"other-salt"])
def test_the_data_key_is_the_jax_packages(salt):
    assert KeyCenter(b"pw", salt).data_key() == JKeyCenter(b"pw", salt).data_key()


@pytest.mark.parametrize("alg", ["aes", "sm4"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_values_and_files_sealed_by_either_package_open_in_the_other(tmp_path, alg, writer,
                                                                    reader):
    wenc = PACKAGES[writer][0](PACKAGES[writer][2](b"pw"), algorithm=alg)
    renc = PACKAGES[reader][0](PACKAGES[reader][2](b"pw"), algorithm=alg)
    for msg in (b"", b"x", b"node.key bytes" * 100):
        assert renc.decrypt(wenc.encrypt(msg)) == msg
    src = tmp_path / "node.smtls"
    src.write_bytes(b"credential" * 33)
    assert renc.decrypt_file(wenc.encrypt_file(str(src))) == b"credential" * 33
    bad = bytearray(wenc.encrypt(b"value"))
    bad[-1] ^= 1
    with pytest.raises(ValueError):
        renc.decrypt(bytes(bad))


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_an_encrypted_wal_written_by_either_package_reads_in_the_other(tmp_path, writer,
                                                                      reader):
    Enc, Store, Key, Ent, Wal = PACKAGES[writer]
    st = Store(Wal(str(tmp_path / "db")), Enc(Key(b"pw")))
    st.set("t", b"k", b"direct")
    st.prepare(1, {("t", b"a"): Ent(b"A" * 300), ("t", b"b"): Ent(b"B")})
    st.commit(1)
    st.close()
    Enc, Store, Key, Ent, Wal = PACKAGES[reader]
    st = Store(Wal(str(tmp_path / "db")), Enc(Key(b"pw")))
    try:
        assert [st.get("t", k) for k in (b"k", b"a", b"b")] == [b"direct", b"A" * 300, b"B"]
        assert sorted(st.keys("t")) == [b"a", b"b", b"k"]
    finally:
        st.close()
