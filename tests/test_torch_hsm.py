"""The port's soft HSM (crypto/hsm.py) against the JAX package's:
tests/test_wasm_hsm.py's HSM cases on the port (SoftHsmProvider sign and
verify, the keystore's reopen and wrong-pin refusal, HsmKeyPair signing
through the suite), then the two packages across each other: a keystore
sealed by either opens in the other with the same keys, and each
package's suite verifies the other's HSM signatures."""

import pytest

from fisco_bcos_tpu.crypto.hsm import HsmKeyPair as JHsmKeyPair
from fisco_bcos_tpu.crypto.hsm import SoftHsmProvider as JSoftHsmProvider
from fisco_bcos_tpu.crypto.suite import make_suite as jmake_suite
from fisco_bcos_tpu_torch.crypto.hsm import HsmKeyPair, SoftHsmProvider
from fisco_bcos_tpu_torch.crypto.suite import make_suite


def test_soft_hsm_sign_verify(tmp_path):
    prov = SoftHsmProvider(str(tmp_path / "keystore"), b"pin1234")
    pub = prov.generate_key(1)
    assert len(pub) == 64
    suite = make_suite(sm_crypto=True, backend="host")
    digest = suite.hash(b"hsm message")
    sig = prov.sign(1, digest)
    assert prov.verify(1, digest, sig)
    assert suite.verify(pub, digest, sig)   # the suite verifies HSM signatures

    kp = HsmKeyPair(prov, 1, suite)
    assert kp.secret is None and kp.pub_bytes == pub
    assert kp.address == suite.address_of_pub(pub)
    assert suite.verify(pub, digest, kp.sign_digest(digest))

    # the keystore survives a reopen with the right pin, refuses a wrong one
    assert SoftHsmProvider(str(tmp_path / "keystore"), b"pin1234").public_key(1) == pub
    with pytest.raises(ValueError):
        SoftHsmProvider(str(tmp_path / "keystore"), b"wrong")


def test_hsm_sign_through_suite(tmp_path):
    prov = SoftHsmProvider(str(tmp_path / "ks2"), b"pin")
    prov.generate_key(7)
    suite = make_suite(sm_crypto=True, backend="host")
    kp = HsmKeyPair(prov, 7, suite)
    digest = suite.hash(b"via-suite")
    sig = suite.sign(kp, digest)   # dispatched to the provider
    assert suite.verify(kp.pub_bytes, digest, sig)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_a_keystore_of_either_package_opens_in_the_other(tmp_path, writer, reader):
    provs = {"jax": JSoftHsmProvider, "port": SoftHsmProvider}
    suites = {"jax": jmake_suite(sm_crypto=True, backend="host"),
              "port": make_suite(sm_crypto=True, backend="host")}
    kps = {"jax": JHsmKeyPair, "port": HsmKeyPair}
    w = provs[writer](str(tmp_path / "ks"), b"pin")
    pubs = {i: w.generate_key(i) for i in (1, 5, 9)}
    r = provs[reader](str(tmp_path / "ks"), b"pin")
    assert {i: r.public_key(i) for i in pubs} == pubs
    digest = suites[reader].hash(b"cross-package")
    for i, pub in pubs.items():
        sig = suites[reader].sign(kps[reader](r, i, suites[reader]), digest)
        assert suites[writer].verify(pub, digest, sig)
        assert w.verify(i, digest, sig) and r.verify(i, digest, w.sign(i, digest))
    with pytest.raises(ValueError):
        provs[reader](str(tmp_path / "ks"), b"wrong")
