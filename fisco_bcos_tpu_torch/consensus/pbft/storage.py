"""Durable PBFT consensus log: crash recovery for in-flight rounds.

Reference counterpart: FISCO-BCOS bcos-pbft/bcos-pbft/pbft/storage/
LedgerStorage.cpp (persists consensus state per phase) replayed by
``PBFTEngine::initState`` (PBFTEngine.h:76) on restart. Here the log lives
in a dedicated table of the node's (WAL-backed) storage, written at each
phase transition on the engine's single worker thread:

  * the accepted/created pre-prepare packet plus the FULL proposal block
    (transactions materialised from the pool at persist time — after a
    restart the in-memory txpool is empty, so the block must carry its own
    txs to be executable);
  * this node's own prepare / commit votes (checkpoint seals are NOT
    persisted — a restarted node deterministically re-executes at commit
    quorum and regenerates its seal);
  * the current view (written on view entry, with stale height records
    cleared — a carried proposal re-enters the new view under a new hash).

On ``PBFTEngine.start()`` the engine replays the log for the next expected
height, rebroadcasts its own packets (receivers deduplicate), and asks peers
for their cached round state with a RECOVER_REQ — so a round that already
reached prepare quorum can finish without a view change even if a quorum of
nodes restarted mid-round.
"""

from __future__ import annotations


from ...storage.interface import StorageInterface

T_PBFT = "c_pbft_log"

K_VIEW = b"view"
# per-height record parts, each keyed <tag><be8(number)>
TAG_PREPREPARE = b"pp"
TAG_BLOCK = b"bk"
TAG_PREPARE = b"pv"
TAG_COMMIT = b"cv"
_TAGS = (TAG_PREPREPARE, TAG_BLOCK, TAG_PREPARE, TAG_COMMIT)


def _be8(n: int) -> bytes:
    return n.to_bytes(8, "big")


class PBFTLog:
    def __init__(self, storage: StorageInterface):
        self.storage = storage

    # -- view --------------------------------------------------------------
    def save_view(self, view: int) -> None:
        self.storage.set(T_PBFT, K_VIEW, _be8(view))

    def load_view(self) -> int:
        v = self.storage.get(T_PBFT, K_VIEW)
        return int.from_bytes(v, "big") if v else 0

    # -- per-height record -------------------------------------------------
    def save_proposal(self, number: int, preprepare: bytes,
                      full_block: bytes) -> None:
        self.storage.set_batch(T_PBFT, [
            (TAG_PREPREPARE + _be8(number), preprepare),
            (TAG_BLOCK + _be8(number), full_block),
        ])

    def save_packet(self, number: int, tag: bytes, packet: bytes) -> None:
        self.storage.set(T_PBFT, tag + _be8(number), packet)

    def load_height(self, number: int) -> dict[bytes, bytes]:
        """-> {tag: bytes} for the parts present at this height."""
        out: dict[bytes, bytes] = {}
        for tag in _TAGS:
            v = self.storage.get(T_PBFT, tag + _be8(number))
            if v is not None:
                out[tag] = v
        return out

    def prune(self, upto: int) -> None:
        """Drop all per-height records for heights <= upto."""
        self.storage.remove_batch(T_PBFT, [
            k for tag in _TAGS for k in self.storage.keys(T_PBFT, tag)
            if int.from_bytes(k[len(tag):], "big") <= upto])

    def clear_heights(self) -> None:
        """Drop ALL per-height records (view change: every cached round is
        discarded, and a carried proposal re-enters with a new hash)."""
        self.storage.remove_batch(T_PBFT, [
            k for tag in _TAGS for k in self.storage.keys(T_PBFT, tag)])
