"""The port's native host oracles (crypto/nativehash.py, crypto/nativeec.py,
utils/nativelib.py, executor/nevm.load_library) against the JAX
package's and the pure-Python `refimpl`, exactly, and the port suite's
host path wired through them as the JAX suite's is: hash, host
hash_batch, sign (byte-exact, the RFC 6979 nonce from the oracle), host
verify and recovery. Also the source-hash refusal of a drifted binary and
the port's rebuild of a library that will not load."""

import ctypes
import hashlib
import os

import numpy as np
import pytest

from fisco_bcos_tpu.crypto import nativeec as j_nativeec
from fisco_bcos_tpu.crypto import nativehash as j_nativehash
from fisco_bcos_tpu.crypto.suite import make_suite as j_make_suite
from fisco_bcos_tpu.utils import nativelib as j_nativelib
from fisco_bcos_tpu_torch.crypto import nativeec, nativehash, refimpl
from fisco_bcos_tpu_torch.crypto.suite import make_suite
from fisco_bcos_tpu_torch.executor import nevm
from fisco_bcos_tpu_torch.utils import nativelib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIBS = ("nevm", "ncrypto")


def _msgs(seed: int, n: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    lens = [0, 1, 55, 56, 63, 64, 135, 136, 137, 271, 272, 512] + [
        int(x) for x in rng.integers(0, 2000, n)]
    return [rng.bytes(k) for k in lens] + [rng.bytes(100_000)]


def test_libraries_load():
    assert nevm.available() and nativeec.available()
    assert nativehash.keccak256() is not None and nativehash.sm3_batch() is not None


@pytest.mark.parametrize("name", LIBS)
def test_source_hash_refuses_a_drifted_source(name, tmp_path, monkeypatch):
    """Both packages' check_src_hash accept the shipped binary against its
    source, refuse it against a drifted source, and allow it only under
    FBTPU_NATIVE_ALLOW_STALE=1."""
    lib = ctypes.CDLL(os.path.join(REPO, "native", "build", f"lib{name}.so"))
    src = nativelib.source_path(name)
    assert src == os.path.join(REPO, "native", name, f"{name}.cpp")
    drifted = tmp_path / f"{name}.cpp"
    drifted.write_bytes(open(src, "rb").read() + b"// drifted\n")
    monkeypatch.delenv("FBTPU_NATIVE_ALLOW_STALE", raising=False)
    for check in (nativelib.check_src_hash, j_nativelib.check_src_hash):
        assert check(lib, name, src)
        assert not check(lib, name, str(drifted))
    monkeypatch.setenv("FBTPU_NATIVE_ALLOW_STALE", "1")
    for check in (nativelib.check_src_hash, j_nativelib.check_src_hash):
        assert check(lib, name, str(drifted))


def test_a_library_that_is_refused_is_built_from_source(tmp_path, monkeypatch):
    """open_library: a path that does not load, and a library that loads
    but is not nevm's (unstamped for it), both give the library built from
    native/nevm/nevm.cpp into the build directory, stamped with the
    source's hash; the build is reused while the source is unchanged."""
    monkeypatch.setattr(nativelib, "BUILD_DIR", str(tmp_path))
    monkeypatch.delenv("FBTPU_NATIVE_ALLOW_STALE", raising=False)
    want = hashlib.sha256(open(nativelib.source_path("nevm"), "rb").read()).hexdigest()
    lib = nativelib.open_library("nevm", str(tmp_path / "missing.so"))
    built = tmp_path / "libnevm.so"
    assert lib is not None and built.exists()
    assert nativelib._stamp(lib, "nevm") == want
    mtime = built.stat().st_mtime_ns
    other = os.path.join(REPO, "native", "build", "libncrypto.so")
    lib = nativelib.open_library("nevm", other)
    assert nativelib._stamp(lib, "nevm") == want
    assert built.stat().st_mtime_ns == mtime  # reused, not rebuilt
    out = (ctypes.c_uint8 * 32)()
    lib.nevm_keccak256.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint8 * 32]
    lib.nevm_keccak256(b"abc", 3, out)
    assert bytes(out) == refimpl.keccak256(b"abc")


@pytest.mark.parametrize("alg", ["keccak256", "sm3"])
def test_nativehash_matches_jax_and_refimpl(alg):
    msgs = _msgs(3, 48)
    oracle = refimpl.keccak256 if alg == "keccak256" else refimpl.sm3
    want = [oracle(m) for m in msgs]
    assert [nativehash.host_hash(alg)(m) for m in msgs] == want
    assert [nativehash.host_hash(alg)(bytearray(m)) for m in msgs[:4]] == want[:4]
    assert nativehash.host_hash_batch(alg)(msgs) == want
    assert j_nativehash.host_hash_batch(alg)(msgs) == want
    assert nativehash.host_hash_batch(alg)([]) == []


def _signed(params, n: int, sm: bool):
    rows = []
    for i in range(n):
        sk, pub = refimpl.keygen(params, bytes([i + 5]) * 24)
        d = (refimpl.sm3 if sm else refimpl.keccak256)(b"native-%d" % i)
        rows.append((sk, pub, d))
    return rows


@pytest.mark.parametrize("sm", [False, True], ids=["ecdsa", "sm"])
def test_nativeec_signs_verifies_and_recovers_as_jax_and_refimpl(sm):
    params = refimpl.SM2P256V1 if sm else refimpl.SECP256K1
    rows = _signed(params, 12, sm)
    sigs = []
    for sk, pub, d in rows:
        if sm:
            got = nativeec.sm2_sign(sk, d)
            assert got == j_nativeec.sm2_sign(sk, d) == refimpl.sm2_sign(sk, d)
            sigs.append((*got, 0))
        else:
            got = nativeec.ecdsa_sign(sk, d)
            assert got == j_nativeec.ecdsa_sign(sk, d) == refimpl.ecdsa_sign(params, sk, d)
            sigs.append(got)
    es = [int.from_bytes(d, "big") for _, _, d in rows]
    rs = [s[0] for s in sigs]
    ss = [s[1] for s in sigs]
    ss[3] = params.n - 1          # a bad lane
    rs[5] = 0                     # r = 0
    qx = [p[0] for _, p, _ in rows]
    qy = [p[1] for _, p, _ in rows]
    qy[7] ^= 1                    # a key off the curve
    verify = "sm2_verify_batch" if sm else "ecdsa_verify_batch"
    got = getattr(nativeec, verify)(es, rs, ss, qx, qy)
    assert got == getattr(j_nativeec, verify)(es, rs, ss, qx, qy)
    if sm:
        want = [refimpl.sm2_verify((x, y), d, r, s)
                for x, y, (_, _, d), r, s in zip(qx, qy, rows, rs, ss)]
    else:
        want = [refimpl.ecdsa_verify(params, (x, y), d, r, s)
                for x, y, (_, _, d), r, s in zip(qx, qy, rows, rs, ss)]
    assert got == want and sum(want) == 9
    if sm:
        return
    vs = [s[2] for s in sigs]
    vs[9] = 4
    pubs, ok = nativeec.ecdsa_recover_batch(es, rs, ss, vs)
    assert (pubs, ok) == j_nativeec.ecdsa_recover_batch(es, rs, ss, vs)
    rows_door = nativeec.ecdsa_recover_batch_rows(
        b"".join(d for _, _, d in rows), b"".join(r.to_bytes(32, "big") for r in rs),
        b"".join(s.to_bytes(32, "big") for s in ss), bytes(vs))
    assert rows_door == (pubs, ok)
    for (_, _, d), r, s, v, p, o in zip(rows, rs, ss, vs, pubs, ok):
        q = refimpl.ecdsa_recover(params, d, r, s, v)
        assert o == (q is not None)
        assert p == (q[0].to_bytes(32, "big") + q[1].to_bytes(32, "big") if q else None)
    with pytest.raises(ValueError):
        nativeec.ecdsa_verify_batch(es, rs[:-1], ss, qx, qy)


@pytest.mark.parametrize("sm", [False, True], ids=["ecdsa", "sm"])
def test_port_suite_host_path_equals_the_jax_suite(sm):
    """The port suite on "host" (native) and the JAX suite on "host", on
    the same keys and digests: signatures byte-exact, hashes, verdicts,
    recovered keys and addresses equal, short and tampered lanes
    included; and the port's signature equals refimpl's."""
    port, jax = make_suite(sm, backend="host"), j_make_suite(sm, backend="host")
    kps = [port.generate_keypair(bytes([i + 3]) * 20) for i in range(6)]
    jkps = [jax.generate_keypair(bytes([i + 3]) * 20) for i in range(6)]
    assert [k.pub_bytes for k in kps] == [k.pub_bytes for k in jkps]
    msgs = _msgs(11, 16)
    assert port.hash_batch(msgs) == jax.hash_batch(msgs)
    assert [port.hash(m) for m in msgs[:8]] == [jax.hash(m) for m in msgs[:8]]
    digests = [port.hash(b"host-%d" % i) for i in range(6)]
    sigs = [port.sign(k, d) for k, d in zip(kps, digests)]
    assert sigs == [jax.sign(k, d) for k, d in zip(jkps, digests)]
    for k, d, sig in zip(kps, digests, sigs):
        if sm:
            r, s = refimpl.sm2_sign(k.secret, d)
            assert sig == r.to_bytes(32, "big") + s.to_bytes(32, "big") + k.pub_bytes
        else:
            r, s, v = refimpl.ecdsa_sign(refimpl.SECP256K1, k.secret, d)
            assert sig == r.to_bytes(32, "big") + s.to_bytes(32, "big") + bytes([v])
    sigs[2] = sigs[2][:10] + b"\x77" + sigs[2][11:]
    sigs[4] = sigs[4][:17]
    pubs = [k.pub_bytes for k in kps]
    got = port.verify_batch(digests, sigs, pubs)
    assert got.tolist() == jax.verify_batch(digests, sigs, pubs).tolist()
    assert got.tolist() == [True, True, False, True, False, True]
    rec = port.recover_batch(digests, sigs)
    jrec = jax.recover_batch(digests, sigs)
    assert rec[0] == jrec[0] and rec[1].tolist() == jrec[1].tolist()
    addrs = port.recover_addresses(digests, sigs)
    assert addrs[0] == jax.recover_addresses(digests, sigs)[0]
    assert port.merkle_root(digests) == jax.merkle_root(digests)


def test_port_suite_host_path_takes_the_native_libraries(monkeypatch):
    """With refimpl's hash, sign, verify and recover made to raise, the
    port's host suite still answers: each goes through the libraries."""
    def refuse(*a, **k):
        raise AssertionError("refimpl called on the native host path")

    suite = make_suite(backend="host")
    sm = make_suite(True, backend="host")
    kp, skp = suite.generate_keypair(b"n" * 20), sm.generate_keypair(b"m" * 20)
    for name in ("keccak256", "sm3", "ecdsa_sign", "sm2_sign", "ecdsa_verify",
                 "sm2_verify", "ecdsa_recover"):
        monkeypatch.setattr(refimpl, name, refuse)
    d = suite.hash(b"native route")
    sig, ssig = suite.sign(kp, d), sm.sign(skp, d)
    assert suite.verify(kp.pub_bytes, d, sig) and sm.verify(skp.pub_bytes, d, ssig)
    assert suite.recover(d, sig) == kp.pub_bytes
    assert suite.recover_addresses([d], [sig])[0] == [kp.address]
    assert sm.hash_batch([b"a", b"b"]) == [sm.hash(b"a"), sm.hash(b"b")]
