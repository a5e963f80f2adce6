"""Protocol objects and the batch identity pipeline."""

from .types import (
    Block,
    BlockHeader,
    LogEntry,
    ParentInfo,
    Receipt,
    Transaction,
    TransactionStatus,
    batch_hash,
    batch_recover_senders,
    prefill_hashes,
)

__all__ = [
    "Block",
    "BlockHeader",
    "LogEntry",
    "ParentInfo",
    "Receipt",
    "Transaction",
    "TransactionStatus",
    "batch_hash",
    "batch_recover_senders",
    "prefill_hashes",
]
