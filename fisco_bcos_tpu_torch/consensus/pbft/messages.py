"""PBFT message model: signed consensus packets.

Reference counterpart: FISCO-BCOS bcos-pbft/bcos-pbft/pbft/protocol/ —
`PBFTBaseMessage` (interfaces/PBFTBaseMessageInterface.h; verifySignature at
PBFTBaseMessage.h:103) and the protobuf codec `PBFTCodec.cpp:47` which signs
every outgoing packet with the node key. Here the deterministic wire codec
replaces protobuf, and signature *verification* is batch-first: the engine
drains its inbox and pushes all pending packet signatures through one
`suite.verify_batch` call (the reference verifies one-at-a-time inside the
single consensus worker, PBFTEngine.cpp:732 checkSignature).

Packet identity = H(core encoding); the signature covers that digest.
`proposal_hash` meaning per type:
  PRE_PREPARE / PREPARE / COMMIT : proposal header hash (pre-execution)
  CHECKPOINT                     : executed header hash — the signature is
                                   simultaneously the commit seal that lands
                                   in BlockHeader.signature_list
  VIEW_CHANGE / NEW_VIEW         : latest committed block hash
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Optional

from ...codec.wire import Reader, Writer


class PacketType(enum.IntEnum):
    PRE_PREPARE = 0
    PREPARE = 1
    COMMIT = 2
    VIEW_CHANGE = 3
    NEW_VIEW = 4
    CHECKPOINT = 5
    # round-state recovery after a crash/restart (the reference's
    # RecoverRequest/RecoverResponse consensus-status exchange): REQ asks
    # peers for their cached packets at a height; RESP carries them packed.
    RECOVER_REQ = 6
    RECOVER_RESP = 7


@dataclasses.dataclass
class PBFTMessage:
    packet_type: int = 0
    view: int = 0
    number: int = 0  # block index this packet is about
    timestamp: int = 0  # ms
    from_idx: int = 0  # sender's index in the consensus node list
    proposal_hash: bytes = b""
    payload: bytes = b""  # PRE_PREPARE: block bytes; NEW_VIEW: proofs
    signature: bytes = b""

    _hash: Optional[bytes] = dataclasses.field(default=None, repr=False)

    def encode_core(self) -> bytes:
        w = Writer()
        (w.u8(self.packet_type).u64(self.view).i64(self.number)
         .i64(self.timestamp).i64(self.from_idx).blob(self.proposal_hash)
         .blob(self.payload))
        return w.bytes()

    def encode(self) -> bytes:
        return Writer().blob(self.encode_core()).blob(self.signature).bytes()

    @classmethod
    def decode(cls, data: bytes) -> "PBFTMessage":
        r = Reader(data)
        core, sig = r.blob(), r.blob()
        c = Reader(core)
        return cls(packet_type=c.u8(), view=c.u64(), number=c.i64(),
                   timestamp=c.i64(), from_idx=c.i64(),
                   proposal_hash=c.blob(), payload=c.blob(), signature=sig)

    def hash(self, suite) -> bytes:
        if self._hash is None:
            self._hash = suite.hash(self.encode_core())
        return self._hash

    def sign(self, suite, keypair) -> "PBFTMessage":
        self.signature = suite.sign(keypair, self.hash(suite))
        return self


def make_packet(packet_type: PacketType, view: int, number: int,
                from_idx: int, proposal_hash: bytes = b"",
                payload: bytes = b"") -> PBFTMessage:
    return PBFTMessage(packet_type=int(packet_type), view=view, number=number,
                       timestamp=int(time.time() * 1000), from_idx=from_idx,
                       proposal_hash=proposal_hash, payload=payload)


def pack_messages(msgs: list[PBFTMessage]) -> bytes:
    return Writer().seq(msgs, lambda w, m: w.blob(m.encode())).bytes()


def unpack_messages(data: bytes,
                    max_count: Optional[int] = None) -> list[PBFTMessage]:
    """Decode a packed message list; `max_count` bounds the DECODE itself
    (a Byzantine sender controls the count prefix — materialising millions
    of junk messages before any cap would be the DoS)."""
    r = Reader(data)
    count = r.u32()
    if max_count is not None and count > max_count:
        raise ValueError(f"packed message count {count} > cap {max_count}")
    return [PBFTMessage.decode(r.blob()) for _ in range(count)]
