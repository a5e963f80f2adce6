"""The port's seal judge (consensus/qc.py verify_spans, with crypto/agg.py
and crypto/bn254.py) against the JAX package's, exactly: one span of
legacy multi-seal and cert-mode headers on both chains (and aggregate
ones on the default chain), with headers below quorum, corrupted and
foreign seals, a tampered aggregate, malformed carriage and stale sealer
sets, judged in one verify_batch on
the port's CPU tensor path and on the JAX package's host suite. The
verdict vectors must be identical and equal to the expected ones.
"""

import pytest
import torch

import test_torch_columnar as frames  # tests/ is on sys.path under pytest
from test_torch_lane import CountingSuite
from fisco_bcos_tpu.consensus import qc as jqc
from fisco_bcos_tpu.crypto import agg as jagg
from fisco_bcos_tpu.protocol import BlockHeader as JHeader
from fisco_bcos_tpu_torch.consensus import qc as pqc
from fisco_bcos_tpu_torch.crypto import agg as pagg
from fisco_bcos_tpu_torch.protocol import BlockHeader as PHeader


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def roster(kind: str, seed: int = 1):
    """Four sealers on the JAX host suite, sorted by key."""
    _, jax = frames.suites(kind)
    kps = [jax.generate_keypair(bytes([seed + i]) * 8) for i in range(4)]
    return sorted(kps, key=lambda kp: kp.pub_bytes)


def span(kind: str):
    """-> (JAX headers, expected verdicts, the local sealer set, the
    aggregate key seeds)."""
    _, jax = frames.suites(kind)
    kps, foreign = roster(kind), roster(kind, seed=40)
    local = [kp.pub_bytes for kp in kps]
    secrets = [jagg.derive_secret(kp.secret.to_bytes(32, "big")) for kp in kps]
    headers, want = [], []

    def header(sealer_list=None):
        h = JHeader(number=100 + len(headers), timestamp=7 * len(headers),
                    sealer_list=list(sealer_list or local))
        return h, h.hash(jax)

    def seals(idxs, hh, keys=kps, bad=()):
        out = [(i, jax.sign(keys[i], hh)) for i in idxs]
        return [(i, bytes([s[0] ^ 1]) + s[1:] if k in bad else s)
                for k, (i, s) in enumerate(out)]

    def add(h, ok):
        headers.append(h)
        want.append(ok)

    # legacy multi-seal headers
    for idxs, bad, ok in (((0, 1, 2, 3), (), True), ((0, 2, 3), (), True),
                          ((1, 3), (), False), ((0, 1, 2, 3), (2,), True),
                          ((0, 1, 2, 3), (0, 3), False)):
        h, hh = header()
        h.signature_list = seals(idxs, hh, bad=bad)
        add(h, ok)
    h, hh = header()                                    # one sealer counted twice
    h.signature_list = seals((0, 1), hh) + seals((0,), hh)
    add(h, False)
    h, hh = header(sealer_list=[kp.pub_bytes for kp in foreign])   # stale set
    h.signature_list = seals((0, 1, 2, 3), hh, keys=foreign)
    add(h, False)
    # cert-mode certificates
    for idxs, bad, ok in (((0, 1, 2, 3), (), True), ((1, 2, 3), (), True),
                          ((0, 1), (), False), ((0, 1, 2), (1,), False)):
        h, hh = header()
        jqc.attach(h, jqc.mint_cert(seals(idxs, hh, bad=bad), 4))
        add(h, ok)
    h, hh = header()                                    # payload one seal short
    cert = jqc.mint_cert(seals((0, 1, 2), hh), 4)
    cert.payload = cert.payload[:-jax.signature_size]
    jqc.attach(h, cert)
    add(h, False)
    h, hh = header()                                    # seals by a foreign set
    jqc.attach(h, jqc.mint_cert(seals((0, 1, 2), hh, keys=foreign), 4))
    add(h, False)
    h, hh = header(sealer_list=[kp.pub_bytes for kp in foreign])   # stale set
    jqc.attach(h, jqc.mint_cert(seals((0, 1, 2), hh, keys=foreign), 4))
    add(h, False)
    h, hh = header()                                    # sentinel beside a seal
    jqc.attach(h, jqc.mint_cert(seals((0, 1, 2), hh), 4))
    h.signature_list += seals((3,), hh)
    add(h, False)
    # aggregate certificates, on the default chain only: a BLS pairing check
    # costs ~0.5 s and does not depend on the chain
    aggregates = ((0, 1, 3), False, True), ((0, 1, 2), True, False)
    for idxs, tamper, ok in aggregates if kind == "ecdsa" else ():
        h, hh = header()
        sig = jagg.aggregate_sigs([jagg.sign(secrets[i], hh) for i in idxs])
        if tamper:
            sig = jagg.g1_to_bytes(jagg.hash_to_g1(b"tampered"))
        jqc.attach(h, jqc.mint_aggregate(idxs, sig, 4))
        add(h, ok)
    seeds = [(kp.pub_bytes, kp.secret.to_bytes(32, "big")) for kp in kps]
    return headers, want, local, seeds


@pytest.mark.parametrize("kind", frames.CHAINS)
def test_verify_spans_matches_jax(kind):
    port, jax = frames.suites(kind)
    jheaders, want, local, seeds = span(kind)
    pheaders = [PHeader.decode(h.encode()) for h in jheaders]
    counting = CountingSuite(port)
    agg = kind == "ecdsa"
    got = pqc.verify_spans(pheaders, local, counting,
                           agg_registry=pagg.AggKeyRegistry.from_seeds(seeds) if agg else None)
    jgot = jqc.verify_spans(jheaders, local, jax,
                            agg_registry=jagg.AggKeyRegistry.from_seeds(seeds) if agg else None)
    assert list(got) == list(jgot) == want
    # every lane of the legacy headers that reach quorum structurally and
    # of the well-formed certificates, in one verify_batch
    assert counting.calls["verify"] == [(4 + 3 + 4 + 4) + (4 + 3 + 3 + 3)]
    if agg:   # no registry: aggregate headers fail
        assert list(pqc.verify_spans(pheaders[-2:], local, port)) == [False, False]


def test_certificate_wire_form_and_bitmaps_match_jax():
    for cert in (jqc.mint_cert([(2, b"\x02" * 65), (0, b"\x00" * 65)], 4),
                 jqc.mint_aggregate([0, 1, 3], b"\x05" * 64, 12)):
        raw = cert.encode()
        pcert = pqc.QuorumCert.decode(raw)
        assert pcert.encode() == raw and pcert.signer_count() == cert.signer_count()
    for idxs, n in (([0, 3], 4), ([1, 8, 9], 12), ([], 1)):
        bm = pqc.bitmap_from_idxs(idxs, n)
        assert bm == jqc.bitmap_from_idxs(idxs, n)
        assert pqc.idxs_from_bitmap(bm, n) == jqc.idxs_from_bitmap(bm, n) == idxs
    with pytest.raises(pqc.QCFormatError):
        pqc.QuorumCert.decode(b"\x02\x01" + raw[2:])
    with pytest.raises(ValueError):
        pqc.bitmap_from_idxs([4], 4)
