"""Verifiable proof serving — render once at commit, verify N as one call.

Three jobs:

  * `render_block_proofs` — at commit time (riding the QueryCache
    prime path, off the consensus thread) build the block's tx and
    receipt Merkle levels ONCE and cache every transaction's full
    `getProof` response, so steady-state proof hits cost zero tree walks
    and zero hashing.
  * `verify_inclusion_batch` — check N width-16 ledger proofs (tx,
    receipt, state-changeset) with ONE batched hash call: every level's
    node group is known up front, so the hashes are independent and the
    chain linkage (sibling-slot equality level to level, last digest ==
    root) is pure host comparison. This is the `verifyProofs` RPC body
    and the light client's per-span verification.
  * `ZkPlane` — the node-attached counter surface behind `bcos_zk_*`
    metrics and the `getSystemStatus` "zk" section.

Trust model (README "ZK proof plane"): txsRoot/receiptsRoot proofs bind
to quorum-sealed headers — full light-client strength. State proofs bind
to `state_root`, which is the root of the block's OWN changeset (deliberately
not cumulative), so a state proof shows "this block
wrote key K := V", not "K = V now".
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..analysis import lockcheck as lc
from ..ops import merkle as m
from ..utils.log import LOG, badge

# width-16 proof level: (siblings[WIDTH], position) — ops.merkle shape


def _hex(b: bytes) -> str:
    return "0x" + b.hex()


def _unhex(s: str) -> bytes:
    return bytes.fromhex(s[2:] if s.startswith("0x") else s)


def w16_proof_json(proof) -> list[dict]:
    return [{"siblings": [_hex(s) for s in sibs], "index": pos}
            for sibs, pos in proof]


def w16_proof_from_json(doc: Sequence[dict]) -> list:
    return [([_unhex(s) for s in lvl["siblings"]], int(lvl["index"]))
            for lvl in doc]


def verify_inclusion_batch(suite, items: Sequence[tuple]) -> np.ndarray:
    """-> bool[N] for items of (leaf, w16_proof, root).

    One `suite.hash_batch` over every item's every level node (the call
    that rides the crypto lane), then host-side linkage: leaf sits in its
    claimed sibling slot, each level's digest fills the next level's
    slot, the final digest equals the root. An empty proof asserts
    leaf == root (single-leaf tree)."""
    nodes: list[bytes] = []
    for _leaf, proof, _root in items:
        for sibs, _pos in proof:
            nodes.append(b"".join(sibs))
    digests = list(suite.hash_batch(nodes)) if nodes else []
    ok = np.zeros(len(items), bool)
    off = 0
    for i, (leaf, proof, root) in enumerate(items):
        cur = leaf
        good = True
        for sibs, pos in proof:
            if not (0 <= pos < len(sibs)) or sibs[pos] != cur:
                good = False
            cur = digests[off]
            off += 1
        ok[i] = good and cur == root
    return ok


# -- commit-time rendering ---------------------------------------------------

def render_block_proofs(node, cache, number: int, gen: int) -> int:
    """Render every tx's `getProof` response for a committed block into
    the query cache: both trees' levels built once, receipts hashed in
    one batch, one cache entry per tx hash. Returns entries rendered."""
    ledger = node.ledger
    hashes = ledger.tx_hashes_by_number(number)
    if not hashes:
        return 0
    header = ledger.header_by_number(number)
    if header is None:
        return 0
    receipts = [ledger.receipt(h) for h in hashes]
    if any(rc is None for rc in receipts):
        return 0  # raced a prune/rollback; serve on demand instead
    from ..protocol import prefill_hashes
    prefill_hashes(receipts, lambda rc: rc.encode(), node.suite)
    alg = node.suite.hash_name
    tx_levels = m.merkle_levels_host(hashes, alg)
    rc_levels = m.merkle_levels_host([rc.hash(node.suite)
                                      for rc in receipts], alg)
    for i, h in enumerate(hashes):
        doc = {
            "blockNumber": number,
            "txHash": _hex(h),
            "txsRoot": _hex(header.txs_root),
            "txProof": w16_proof_json(m.proof_from_levels(tx_levels, i)),
            "receiptsRoot": _hex(header.receipts_root),
            "receiptProof": w16_proof_json(
                m.proof_from_levels(rc_levels, i)),
        }
        cache.put(("proof", h), doc, gen)
    return len(hashes)


def render_proof_doc(ledger, tx_hash: bytes) -> Optional[dict]:
    """Cold-path (cache miss) render of one tx's proof document — the
    per-request tree walk the commit-time prime exists to avoid."""
    rc = ledger.receipt(tx_hash)
    if rc is None:
        return None
    tp = ledger.tx_proof(tx_hash)
    rp = ledger.receipt_proof(tx_hash)
    if tp is None or rp is None:
        return None  # body rows raced a prune sweep mid-request
    return {
        "blockNumber": rc.block_number,
        "txHash": _hex(tx_hash),
        "txsRoot": _hex(tp[1]),
        "txProof": w16_proof_json(tp[0]),
        "receiptsRoot": _hex(rp[1]),
        "receiptProof": w16_proof_json(rp[0]),
    }


# -- node-attached counters (bcos_zk_* / getSystemStatus) --------------------

class ZkPlane:
    """Per-node ZK proof-plane bookkeeping: commit-time render counts,
    proof cache hit rate, batched-verify volume. Group-labeled via the
    node's metrics view."""

    def __init__(self, node):
        self.node = node
        self._reg = node.metrics_view
        self._lock = lc.make_lock("zk.plane")
        self._rendered = 0
        self._hits = 0
        self._misses = 0
        self._verified = 0
        self._verify_calls = 0

    def prime(self, number: int, gen: int, cache) -> None:
        try:
            n = render_block_proofs(self.node, cache, number, gen)
        except Exception:  # noqa: BLE001 — priming is best-effort
            LOG.exception(badge("ZK", "proof-prime-failed", number=number))
            return
        if n:
            with self._lock:
                self._rendered += n
            self._reg.inc("bcos_zk_proofs_rendered_total", n)

    def note_proof(self, hit: bool) -> None:
        with self._lock:
            if hit:
                self._hits += 1
            else:
                self._misses += 1
        self._reg.inc("bcos_zk_proof_cache_hits_total" if hit
                      else "bcos_zk_proof_cache_misses_total")

    def note_verified(self, n: int, ok: int) -> None:
        with self._lock:
            self._verified += n
            self._verify_calls += 1
        self._reg.inc("bcos_zk_proofs_verified_total", n)
        self._reg.inc("bcos_zk_verify_calls_total")
        self._reg.observe("bcos_zk_verify_batch_size", n,
                          buckets=(1, 8, 64, 512, 4096, 16384, 65536))

    def stats(self) -> dict:
        with self._lock:
            total = self._hits + self._misses
            return {
                "proofsRendered": self._rendered,
                "proofHits": self._hits,
                "proofMisses": self._misses,
                "proofHitRate": round(self._hits / total, 4)
                if total else 0.0,
                "proofsVerified": self._verified,
                "verifyCalls": self._verify_calls,
            }
