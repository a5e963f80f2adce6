"""Transaction pool: pending store + batch validator (bcos-txpool)."""

from .ingest import IngestLane, LaneStopped, TxPoolIsFull
from .txpool import TxPool, TxSubmitResult

__all__ = ["IngestLane", "LaneStopped", "TxPool", "TxPoolIsFull",
           "TxSubmitResult"]
