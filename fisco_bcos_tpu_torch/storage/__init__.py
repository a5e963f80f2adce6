"""Storage stack: transactional KV with 2PC and the state overlay.

Counterpart of FISCO-BCOS TransactionalStorageInterface (asyncPrepare/
asyncCommit/asyncRollback, bcos-framework/bcos-framework/storage/
StorageInterface.h:126-141) and bcos-table's StateStorage. The port has
the in-memory backend; the persistent engines (WAL, disk, key pages) and
the namespaced view are not ported yet (ROADMAP.md).
"""

from .carry import storage_from_jax
from .interface import Entry, StorageInterface, TransactionalStorage
from .memory import MemoryStorage
from .state import StateStorage

__all__ = ["Entry", "MemoryStorage", "StateStorage", "StorageInterface",
           "TransactionalStorage", "storage_from_jax"]
