"""Module routing IDs for the per-node message bus.

Reference counterpart: the ModuleID enum in
FISCO-BCOS bcos-framework/bcos-framework/protocol/Protocol.h:69-92 —
every P2P payload is tagged (groupID, moduleID) and the FrontService
dispatches it to the module registered under that ID
(bcos-front/bcos-front/FrontService.cpp:511, registration in
libinitializer/FrontServiceInitializer.cpp:89-155). Values mirror the
reference's so wire traces read the same.
"""

from __future__ import annotations

import enum


class ModuleID(enum.IntEnum):
    PBFT = 1000
    Raft = 1001
    BlockSync = 2000
    TxsSync = 2001
    ConsTxsSync = 2002
    SnapshotSync = 2003  # manifest/chunk fetch for snap-sync (snapshot/)
    AMOP = 3000
    LIGHTNODE_GET_BLOCK = 4000
    LIGHTNODE_GET_TRANSACTIONS = 4001
    LIGHTNODE_GET_RECEIPTS = 4002
    LIGHTNODE_GET_STATUS = 4003
    LIGHTNODE_SEND_TRANSACTION = 4004
    LIGHTNODE_CALL = 4005
    LIGHTNODE_GET_ABI = 4006
