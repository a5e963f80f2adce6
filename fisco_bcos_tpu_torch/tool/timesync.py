"""Peer clock-skew maintenance (median-of-offsets time alignment).

Reference counterpart: FISCO-BCOS bcos-tool/bcos-tool/
NodeTimeMaintenance.cpp — each peer's advertised UTC time yields an
offset vs local time; the node tracks one offset per peer, takes the
MEDIAN as its alignment, warns when a peer (or the median — i.e. we
ourselves) drifts beyond the hard bound, and exposes ``aligned_time``
for timestamp validation so a chain tolerates drifting member clocks
without trusting any single one.

Wire-in point: block-sync status gossip carries the sender's clock
(sync/sync.py), mirroring the reference's BlockSync status path; the
sealer stamps proposals with ``aligned_time`` and PBFT's proposal
timestamp sanity check compares against it.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ..utils.log import LOG, badge

#: ignore sub-threshold offset changes from a peer (3 min, as reference)
MIN_TIME_OFFSET_MS = 3 * 60 * 1000
#: warn when a peer (or our median) is off by more than this (30 min)
MAX_TIME_OFFSET_MS = 30 * 60 * 1000


def utc_ms() -> int:
    return int(time.time() * 1000)


class NodeTimeMaintenance:
    """Median peer-clock alignment (NodeTimeMaintenance.cpp semantics)."""

    def __init__(self, min_offset_ms: int = MIN_TIME_OFFSET_MS,
                 max_offset_ms: int = MAX_TIME_OFFSET_MS):
        self._offsets: dict[bytes, int] = {}
        self._median = 0
        self._lock = threading.Lock()
        self.min_offset_ms = min_offset_ms
        self.max_offset_ms = max_offset_ms

    def update_peer_time(self, node_id: bytes, peer_time_ms: int,
                         local_time_ms: Optional[int] = None) -> None:
        """Record a peer's advertised clock (from status gossip)."""
        now = utc_ms() if local_time_ms is None else local_time_ms
        offset = peer_time_ms - now
        with self._lock:
            old = self._offsets.get(node_id)
            if old is not None and abs(old - offset) <= self.min_offset_ms:
                return  # jitter below threshold: keep the old estimate
            self._offsets[node_id] = offset
        if abs(offset) > self.max_offset_ms:
            LOG.warning(badge("TIMESYNC", "peer-clock-far-off",
                              peer=node_id[:4].hex(), offset_ms=offset))
        self._recompute()

    def forget_peer(self, node_id: bytes) -> None:
        with self._lock:
            self._offsets.pop(node_id, None)
        self._recompute()

    def _recompute(self) -> None:
        with self._lock:
            offs = sorted(self._offsets.values())
        if not offs:
            median = 0
        else:
            mid = len(offs) // 2
            median = (offs[mid] if len(offs) % 2
                      else (offs[mid] + offs[mid - 1]) // 2)
        if abs(median) >= self.max_offset_ms:
            # majority of peers disagree with us: OUR clock is suspect
            LOG.warning(badge("TIMESYNC", "local-clock-suspect",
                              median_offset_ms=median,
                              peers=len(offs)))
        with self._lock:
            self._median = median

    def median_offset_ms(self) -> int:
        with self._lock:
            return self._median

    def aligned_time_ms(self) -> int:
        """Local clock corrected by the peer-median offset — use for
        proposal timestamps and timestamp tolerance checks."""
        with self._lock:
            median = self._median
        return utc_ms() + median
