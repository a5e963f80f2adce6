"""Protocol objects and the batch identity pipeline."""

from .types import (Block, BlockHeader, Receipt, Transaction, batch_hash,
                    batch_recover_senders, prefill_hashes)

__all__ = ["Block", "BlockHeader", "Receipt", "Transaction", "batch_hash",
           "batch_recover_senders", "prefill_hashes"]
