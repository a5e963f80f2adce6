"""Structural contracts — the framework's C++20-concepts analogue.

Reference counterpart: FISCO-BCOS concepts/bcos-concepts/ (ByteBuffer,
Serialize, Hash, ledger/transaction-pool concepts) — compile-time duck
typing that lets the header-only lightnode stack and the Tars proxies
interchange implementations. Python's structural equivalent is
`typing.Protocol` with `runtime_checkable`: the same duck-typed seams
(in-process object vs service proxy) declared once and checkable both
statically (mypy) and at runtime (isinstance in tests/wiring).

These protocols document the EXACT surface each consumer relies on, so a
split-service proxy (services/*_service.py) provably satisfies what the
in-process object provides.
"""

from __future__ import annotations

from typing import Iterator, Optional, Protocol, Sequence, runtime_checkable


@runtime_checkable
class Serializable(Protocol):
    """bcos-concepts Serialize: objects with a deterministic wire form."""

    def encode(self) -> bytes: ...


@runtime_checkable
class Hashable(Protocol):
    """bcos-concepts Hash: suite-parameterised content digest."""

    def hash(self, suite) -> bytes: ...


@runtime_checkable
class KVReadable(Protocol):
    """Minimal read surface of StorageInterface (bcos-concepts ByteBuffer
    consumers read through exactly this)."""

    def get(self, table: str, key: bytes) -> Optional[bytes]: ...

    def keys(self, table: str, prefix: bytes = b"") -> Iterator[bytes]: ...


@runtime_checkable
class KVWritable(KVReadable, Protocol):
    def set(self, table: str, key: bytes, value: bytes) -> None: ...

    def remove(self, table: str, key: bytes) -> None: ...


@runtime_checkable
class LedgerReader(Protocol):
    """The query surface sync/RPC/lightnode consume (concepts/ledger/)."""

    def current_number(self) -> int: ...

    def header_by_number(self, n: int): ...

    def tx_hashes_by_number(self, n: int) -> list[bytes]: ...

    def transaction(self, h: bytes): ...

    def receipt(self, h: bytes): ...


@runtime_checkable
class TxPoolLike(Protocol):
    """The pool surface sealer/PBFT/scheduler consume
    (concepts/transaction-pool/)."""

    def submit_batch(self, txs: Sequence) -> list: ...

    def seal(self, max_txs: int): ...

    def unseal(self, hashes: Sequence[bytes]) -> None: ...

    def fill_block(self, tx_hashes: Sequence[bytes]): ...

    def verify_proposal(self, block) -> bool: ...

    def pending_count(self) -> int: ...

    def on_block_committed(self, number: int, tx_hashes, nonces) -> None: ...


@runtime_checkable
class FrontLike(Protocol):
    """The message-bus surface consensus/sync/AMOP bind to."""

    def register_module(self, module: int, handler) -> None: ...

    def send(self, module: int, dst: bytes, payload: bytes) -> bool: ...

    def broadcast(self, module: int, payload: bytes) -> None: ...

    def peers(self) -> list[bytes]: ...
