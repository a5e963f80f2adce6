"""Ledger: chain data schema on storage (bcos-ledger counterpart)."""

from .ledger import (
    ConsensusNode,
    GENESIS_EXTRA,
    Ledger,
    LedgerConfig,
    SYS_CONFIG,
    SYS_CONSENSUS,
)

__all__ = ["ConsensusNode", "Ledger", "LedgerConfig", "SYS_CONFIG",
           "SYS_CONSENSUS", "GENESIS_EXTRA"]
