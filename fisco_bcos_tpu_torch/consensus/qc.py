"""Quorum certificates: one verifiable object per block instead of 2f+1
loose commit seals, checked as ONE crypto-lane batch at every hop.

A `QuorumCert` is minted by the PBFT engine the moment a checkpoint
quorum lands (pbft/engine.py _flush_checkpoint_commits) and travels INSIDE
`BlockHeader.signature_list` as a single sentinel entry
`(QC_SENTINEL, cert.encode())` — signature_list is outside the signed
header identity (protocol/types.py encode_core), so minting at commit
time never changes the header hash, and the i64-index wire form decodes
unchanged on nodes that have never heard of certificates (they just fail
the quorum check, exactly like any unknown seal — mixed-mode clusters and
legacy replay both keep working).

Two certificate modes, version-flagged on the wire:
  * cert      — signer bitmap + the quorum's ECDSA seals concatenated in
                bitmap order.  Verified by merging every cert's signatures
                into the SAME `suite.verify_batch` call that judges legacy
                multi-seal headers — the whole span costs one lane call.
  * aggregate — signer bitmap + ONE 64-byte BLS point (crypto/agg.py):
                sum of the quorum's G1 seals, verified with a single
                pairing-product check against PoP-registered keys.

`verify_spans` is THE seal judge: sync range replay, snapshot install and
the light client all call it, so admission rules (local sealer set only,
bitmap bounds, popcount quorum, stale-set rejection, malformed-sentinel
rejection) can never diverge between hops.  Legacy multi-seal headers ride
the same call with the historical dedup-by-index + distinct-sealer-quorum
rules.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from ..codec.wire import Reader, Writer
from ..crypto import agg
from ..protocol.types import prefill_hashes
from ..utils.metrics import REGISTRY

# signature_list sentinel index marking a certificate entry (legal because
# the codec writes indexes as i64; real sealer indexes are >= 0)
QC_SENTINEL = -1
QC_WIRE_VERSION = 1

MODE_CERT = 1        # bitmap + concatenated ECDSA seals (lane-batched)
MODE_AGGREGATE = 2   # bitmap + one aggregated BLS G1 point

MODE_NAMES = {MODE_CERT: "cert", MODE_AGGREGATE: "aggregate"}


class QCFormatError(ValueError):
    """Structurally invalid certificate carriage (NOT a legacy header):
    sentinel mixed with other entries, undecodable blob, unknown wire
    version/mode.  Verifiers treat the header as unauthenticated — they
    never fall back to reading the blob as legacy seals."""


@dataclass
class QuorumCert:
    """Deliberately minimal wire form: a certificate travels INSIDE the
    header it certifies and its signatures are over that header's hash,
    so height/hash binding fields would be redundant bytes — the whole
    point is shipping less than 2f+1 loose seals."""

    mode: int
    bitmap: bytes
    payload: bytes

    def encode(self) -> bytes:
        return (Writer().u8(QC_WIRE_VERSION).u8(self.mode)
                .blob(self.bitmap).blob(self.payload).bytes())

    @classmethod
    def decode(cls, raw: bytes) -> "QuorumCert":
        try:
            r = Reader(raw)
            version, mode = r.u8(), r.u8()
            bitmap, payload = r.blob(), r.blob()
            if r.remaining():
                raise ValueError("trailing bytes")
        except Exception as exc:  # truncated / junk blob
            raise QCFormatError(f"undecodable certificate: {exc}") from exc
        if version != QC_WIRE_VERSION:
            raise QCFormatError(f"unknown certificate wire version {version}")
        if mode not in MODE_NAMES:
            raise QCFormatError(f"unknown certificate mode {mode}")
        return cls(mode, bitmap, payload)

    def signer_count(self) -> int:
        return sum(bin(b).count("1") for b in self.bitmap)


# -- bitmap helpers ---------------------------------------------------------

def bitmap_from_idxs(idxs: Sequence[int], n: int) -> bytes:
    out = bytearray((n + 7) // 8)
    for i in idxs:
        if not 0 <= i < n:
            raise ValueError(f"signer index {i} outside sealer set of {n}")
        out[i // 8] |= 1 << (i % 8)
    return bytes(out)


def idxs_from_bitmap(bitmap: bytes, n: int) -> Optional[list[int]]:
    """Set bits as sorted indexes, or None if the bitmap is oversized or
    claims a signer outside the local sealer set."""
    if len(bitmap) != (n + 7) // 8:
        return None
    idxs = [i for i in range(len(bitmap) * 8) if bitmap[i // 8] >> (i % 8) & 1]
    if idxs and idxs[-1] >= n:
        return None
    return idxs


# -- mint / carry -----------------------------------------------------------

def mint_cert(idx_seals: Sequence[tuple[int, bytes]], n: int) -> QuorumCert:
    """ECDSA multi-seal certificate: seals concatenated in ascending
    signer-index order (the bitmap IS the index list, so per-seal index
    framing disappears from the wire)."""
    pairs = sorted(idx_seals)
    return QuorumCert(MODE_CERT,
                      bitmap_from_idxs([i for i, _ in pairs], n),
                      b"".join(s for _, s in pairs))


def mint_aggregate(idxs: Sequence[int], agg_sig: bytes, n: int) -> QuorumCert:
    return QuorumCert(MODE_AGGREGATE, bitmap_from_idxs(idxs, n), agg_sig)


def attach(header, cert: QuorumCert) -> None:
    header.signature_list = [(QC_SENTINEL, cert.encode())]


def extract(header) -> Optional[QuorumCert]:
    """The header's certificate, None for a legacy multi-seal header, or
    QCFormatError for malformed carriage (a sentinel entry must be the
    ONLY entry — padding a certificate with loose seals, or vice versa,
    is exactly the mixed-form ambiguity attack this refuses to parse)."""
    entries = header.signature_list
    if not any(idx == QC_SENTINEL for idx, _ in entries):
        return None
    if len(entries) != 1:
        raise QCFormatError("certificate sentinel mixed with other seals")
    return QuorumCert.decode(entries[0][1])


def seal_wire_bytes(header) -> int:
    """Wire bytes the commit-seal carriage adds to this header — the exact
    encode() minus encode_core() delta, which is what every hop ships."""
    return len(header.encode()) - len(header.encode_core())


# -- the one span verifier --------------------------------------------------

def collect_legacy(header, sealer_set: list[bytes], quorum: int,
                   check_sealer_list: bool
                   ) -> Optional[tuple[list[int], list[bytes]]]:
    """Legacy multi-seal admission: (sorted idxs, seals) deduplicated by
    sealer index, or None if the header can't reach quorum structurally.
    One rule set for sync, snapshot and the light client (sync's historic
    `_collect_seals` contract; the light client skips the sealer-list
    equality check because it configures its own roster)."""
    if check_sealer_list and list(header.sealer_list) != sealer_set:
        return None
    n = len(sealer_set)
    by_idx: dict[int, bytes] = {}
    for idx, seal in header.signature_list:
        if 0 <= idx < n:
            by_idx.setdefault(idx, seal)
    if len(by_idx) < quorum:
        return None
    idxs = sorted(by_idx)
    return idxs, [by_idx[i] for i in idxs]


def verify_spans(headers: Sequence, sealer_set: list[bytes], suite,
                 quorum: Optional[int] = None, *, agg_registry=None,
                 check_sealer_list: bool = True) -> np.ndarray:
    """-> bool[len(headers)]: every header's commit-seal quorum judged in
    ONE `suite.verify_batch` call for the whole span — legacy multi-seal
    headers and cert-mode certificates merge into the same batch;
    aggregate certificates cost one pairing check each.  All judging is
    against the LOCAL `sealer_set` (never peer-supplied rosters), so a
    certificate minted under a stale or foreign sealer set fails here."""
    n = len(sealer_set)
    if quorum is None:
        quorum = 2 * ((n - 1) // 3) + 1
    prefill_hashes(headers, lambda h: h.encode_core(), suite)
    out = np.zeros(len(headers), bool)
    digests: list[bytes] = []
    sigs: list[bytes] = []
    pubs: list[bytes] = []
    # (header i, start, count, need, is_cert)
    spans: list[tuple[int, int, int, int, bool]] = []
    aggs: list[tuple[int, list, bytes, bytes]] = []
    for i, header in enumerate(headers):
        hh = header.hash(suite)
        try:
            cert = extract(header)
        except QCFormatError:
            REGISTRY.inc("bcos_consensus_cert_reject_total",
                         labels={"why": "malformed"})
            continue
        if cert is None:
            collected = collect_legacy(header, sealer_set, quorum,
                                       check_sealer_list)
            if collected is None:
                continue
            idxs, hseals = collected
            spans.append((i, len(digests), len(idxs), quorum, False))
            digests.extend([hh] * len(idxs))
            sigs.extend(hseals)
            pubs.extend(sealer_set[j] for j in idxs)
            continue
        # -- certificate admission (shared by both modes) --
        if check_sealer_list and list(header.sealer_list) != sealer_set:
            REGISTRY.inc("bcos_consensus_cert_reject_total",
                         labels={"why": "sealer-set"})
            continue
        idxs = idxs_from_bitmap(cert.bitmap, n)
        if idxs is None or len(idxs) < quorum:
            REGISTRY.inc("bcos_consensus_cert_reject_total",
                         labels={"why": "bitmap"})
            continue
        if cert.mode == MODE_CERT:
            ssz = suite.signature_size
            if len(cert.payload) != ssz * len(idxs):
                REGISTRY.inc("bcos_consensus_cert_reject_total",
                             labels={"why": "payload-size"})
                continue
            # a certificate is a minted artifact: EVERY claimed signer must
            # check out (need = count, stricter than the legacy >= quorum —
            # a bitmap claiming signers who never signed is a forgery even
            # when enough genuine seals ride along)
            spans.append((i, len(digests), len(idxs), len(idxs), True))
            digests.extend([hh] * len(idxs))
            sigs.extend(cert.payload[k * ssz:(k + 1) * ssz]
                        for k in range(len(idxs)))
            pubs.extend(sealer_set[j] for j in idxs)
        else:  # MODE_AGGREGATE
            if agg_registry is None:
                REGISTRY.inc("bcos_consensus_cert_reject_total",
                             labels={"why": "no-registry"})
                continue
            apubs = [agg_registry.pub_for(sealer_set[j]) for j in idxs]
            if any(p is None for p in apubs):
                # unregistered key = no proof of possession = rogue-key
                # surface; refuse to aggregate it
                REGISTRY.inc("bcos_consensus_cert_reject_total",
                             labels={"why": "unregistered-key"})
                continue
            aggs.append((i, apubs, hh, cert.payload))
    if sigs:
        ok = np.asarray(suite.verify_batch(digests, sigs, pubs))
        for i, start, count, need, is_cert in spans:
            out[i] = int(ok[start:start + count].sum()) >= need
            if is_cert:
                REGISTRY.inc("bcos_consensus_cert_verify_total",
                             labels={"mode": "cert",
                                     "ok": str(bool(out[i])).lower()})
    for i, apubs, hh, payload in aggs:
        out[i] = agg.verify_aggregate(apubs, hh, payload)
        REGISTRY.inc("bcos_consensus_cert_verify_total",
                     labels={"mode": "aggregate",
                             "ok": str(bool(out[i])).lower()})
    return out
