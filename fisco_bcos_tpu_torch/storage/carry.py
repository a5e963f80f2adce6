"""Carry a chain's committed rows from the JAX package's storage into the
port's.

The counterpart, for chain state, of `ops.consts.consts_from_jax`: a
chain that the JAX ledger started (genesis plus blocks) continues on the
port. The caller reads the JAX `MemoryStorage`'s rows as plain bytes
(`{t: {k: st.get(t, k) for k in st.keys(t)} for t in st.tables()}`), so
this module imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Mapping

from .memory import MemoryStorage


def storage_from_jax(tables: Mapping[str, Mapping[bytes, bytes]]
                     ) -> MemoryStorage:
    """-> a port MemoryStorage holding exactly `tables`' rows."""
    st = MemoryStorage()
    for table, rows in tables.items():
        for key, value in rows.items():
            if not isinstance(key, bytes) or not isinstance(value, bytes):
                raise TypeError(f"storage_from_jax: row {table!r}/{key!r} "
                                f"is not bytes -> bytes")
            st.set(table, key, value)
    return st
