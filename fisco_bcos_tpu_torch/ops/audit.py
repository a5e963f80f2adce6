"""Invariant auditor — the `getAuditReport` RPC behind every chaos run.

Fault-injection tests used to assert only "the nodes converged" — which a
silently-corrupted replica can pass by being wrong in unison. After every
chaos/partition/Byzantine/failpoint run (and on operator demand), this
auditor re-derives the structural invariants from the durable state:

  * chain coherence: contiguous headers from the scan floor to the head,
    each linked to its parent by hash;
  * storage coherence: the backend's own audit (disk engine: CURRENT ->
    readable manifest -> every referenced segment present, WAL floor sane;
    WAL backend: the full log parses record-by-record to EOF);
  * nonce-filter consistency: every nonce the ledger committed inside the
    replay-protection window is present in the txpool's rolling filter (a
    hole re-admits a replayed tx);
  * cross-group conservation (multi-group processes): the xshard outbox/
    inbox books balance — every DONE outbox intent has exactly its credit
    in the destination inbox, no inbox credit exists without a matching
    outbox intent (no minting), no ABORTED (refunded) intent was ALSO
    credited (no double-spend), and pending markers mirror PENDING status.

Every check returns `{name, ok, detail}`; the report's top-level `ok` is
the conjunction. Served by the `getAuditReport` RPC method (rpc/server.py)
and asserted clean by tests/test_faults.py and `sanitize_ci.sh --faults`.
"""

from __future__ import annotations

import time

# live-node audits race in-flight commits (the txpool filter is fed by an
# ASYNC commit notification; a cross-group transfer's legs commit on
# different groups): a failing check is re-run after short settles and
# only reported if it PERSISTS — real corruption does, a commit landing
# between two reads does not
_SETTLE_RETRIES = 4
_SETTLE_S = 0.1


def _check(name: str, ok: bool, detail: str = "") -> dict:
    return {"name": name, "ok": bool(ok), "detail": detail}


def _chain_check(node, max_blocks: int) -> dict:
    ledger, suite = node.ledger, node.suite
    head = ledger.current_number()
    if head < 0:
        return _check("chain", True, "empty chain")
    floor = max(0, head - max_blocks)
    prev = ledger.header_by_number(floor)
    if prev is None:
        return _check("chain", False, f"missing header {floor}")
    for n in range(floor + 1, head + 1):
        h = ledger.header_by_number(n)
        if h is None:
            return _check("chain", False, f"missing header {n}")
        if not h.parent_info or h.parent_info[0].hash != prev.hash(suite):
            return _check("chain", False, f"parent link broken at {n}")
        prev = h
    return _check("chain", True, f"headers {floor}..{head} linked")


def _storage_check(node) -> dict:
    audit = getattr(node.storage, "audit", None)
    if not callable(audit):
        return _check("storage", True,
                      f"{type(node.storage).__name__}: no audit surface")
    try:
        problems = audit()
    except Exception as exc:  # noqa: BLE001 — a crashed audit IS a finding
        return _check("storage", False, f"audit raised: {exc!r}")
    return _check("storage", not problems, "; ".join(problems) or "coherent")


def _nonce_check(node, max_blocks: int) -> dict:
    window = min(max_blocks, node.config.block_limit_range)
    missing = 0
    for attempt in range(_SETTLE_RETRIES):
        if attempt:
            time.sleep(_SETTLE_S)  # let the async commit notify drain
        head = node.ledger.current_number()
        known = node.txpool.known_nonces()
        missing = 0
        for n in range(max(1, head - window + 1), head + 1):
            try:
                nonces = node.ledger.nonces_by_number(n)
            except Exception:  # pruned below the checkpoint floor
                continue
            for nonce in nonces:
                if nonce and nonce not in known:
                    missing += 1
        if missing == 0:
            break
    return _check("nonce_filter", missing == 0,
                  f"{missing} committed nonce(s) absent from the filter"
                  if missing else f"window of {window} block(s) consistent")


def audit_node(node, max_blocks: int = 256) -> dict:
    """Single-node report: chain / storage / nonce-filter coherence."""
    checks = [
        _chain_check(node, max_blocks),
        _storage_check(node),
        _nonce_check(node, max_blocks),
    ]
    return {
        "ok": all(c["ok"] for c in checks),
        "group": node.config.group_id,
        "blockNumber": node.ledger.current_number(),
        "health": node.health.snapshot() if getattr(node, "health", None)
        else None,
        "checks": checks,
    }


# -- cross-group conservation over the xshard outbox/inbox -----------------

def audit_cross_group(mgr) -> dict:
    """Conservation over every group pair's transfer books. `mgr` is the
    GroupManager (or anything with .groups() / .node(gid)). A transfer
    whose legs are committing on two groups DURING the scan can look
    momentarily inconsistent — problems must persist across settles to
    be reported."""
    out = _audit_cross_group_once(mgr)
    for _ in range(_SETTLE_RETRIES - 1):
        if out["ok"]:
            return out
        time.sleep(_SETTLE_S)
        out = _audit_cross_group_once(mgr)
    return out


def _audit_cross_group_once(mgr) -> dict:
    from ..executor import precompiled as pc

    problems: list[str] = []
    outbox: dict[tuple[str, bytes], dict] = {}
    inbox: dict[tuple[str, bytes], dict] = {}
    pend: set[tuple[str, bytes]] = set()
    nodes = {}
    for gid in mgr.groups():
        node = mgr.node(gid)
        if node is None:
            continue
        nodes[gid] = node
        for xid in node.storage.keys(pc.T_XSHARD_OUT):
            raw = node.storage.get(pc.T_XSHARD_OUT, xid)
            if raw is not None:
                outbox[(gid, xid)] = pc.decode_intent(raw)
        for xid in node.storage.keys(pc.T_XSHARD_IN):
            raw = node.storage.get(pc.T_XSHARD_IN, xid)
            if raw is not None:
                inbox[(gid, xid)] = pc.decode_inbox_record(raw)
        for xid in node.storage.keys(pc.T_XSHARD_PEND):
            pend.add((gid, xid))

    for (gid, xid), intent in outbox.items():
        dst_gid, tag = intent["dst_group"], xid.hex()[:16]
        credited = inbox.get((dst_gid, xid))
        if intent["status"] == pc.XS_DONE:
            if dst_gid in nodes and credited is None:
                problems.append(f"{gid}/{tag}: DONE but never credited "
                                f"on {dst_gid}")
            elif credited is not None and (
                    credited["amount"] != intent["amount"]
                    or credited["dst"] != intent["dst"]
                    or credited["src_group"] != gid):
                problems.append(f"{gid}/{tag}: credit terms mismatch")
        elif intent["status"] == pc.XS_ABORTED and credited is not None:
            problems.append(f"{gid}/{tag}: refunded on {gid} AND credited "
                            f"on {dst_gid} — value minted")
        if ((gid, xid) in pend) != (intent["status"] == pc.XS_PENDING):
            problems.append(f"{gid}/{tag}: pending marker disagrees with "
                            f"status {intent['status']}")
    for (gid, xid), credited in inbox.items():
        src = credited["src_group"]
        tag = xid.hex()[:16]
        if src not in nodes:
            continue  # source group not hosted here: unverifiable
        intent = outbox.get((src, xid))
        if intent is None:
            problems.append(f"{gid}/{tag}: inbox credit without any "
                            f"outbox intent on {src} — value minted")
        elif intent["amount"] != credited["amount"]:
            problems.append(f"{gid}/{tag}: credited amount differs from "
                            "the escrowed amount")
    for gid, xid in pend:
        if (gid, xid) not in outbox:
            problems.append(f"{gid}/{xid.hex()[:16]}: dangling pending "
                            "marker (no outbox intent)")

    return {"ok": not problems,
            "outbox": len(outbox), "inbox": len(inbox),
            "pending": len(pend), "problems": problems}


def audit_report(node, max_blocks: int = 256) -> dict:
    """The full `getAuditReport` document for one serving node: its own
    invariants plus (when it is one group of a multi-group process) the
    cross-group conservation section."""
    report = audit_node(node, max_blocks=max_blocks)
    reg = getattr(node, "group_registry", None)
    if reg is not None:
        xg = audit_cross_group(reg)
        report["crossGroup"] = xg
        report["ok"] = report["ok"] and xg["ok"]
    return report
