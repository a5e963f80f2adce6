"""Transaction execution engine (bcos-executor counterpart).

Round-1 scope: precompiled system contracts + serial/DAG dispatch; the EVM
interpreter slots in behind the same `execute_transaction` seam.
"""

from .executor import TransactionExecutor
from .precompiled import PRECOMPILED_REGISTRY, PrecompileError

__all__ = ["TransactionExecutor", "PRECOMPILED_REGISTRY", "PrecompileError"]
