"""Sealer: batches pending txs into block proposals (bcos-sealer)."""

from .sealer import Sealer

__all__ = ["Sealer"]
