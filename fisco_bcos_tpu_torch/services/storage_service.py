"""Storage as a service: remote TransactionalStorage over service RPC.

Reference counterpart: Max-mode's distributed storage plane — the node's
modules talk to storage through TransactionalStorageInterface while the
bytes live elsewhere (TiKVStorage.h:50-105 speaks to a TiKV cluster; in
Pro, RocksDB lives in the node but other services reach it via the storage
service). `StorageServer` exposes any local backend (WAL, native bcoskv,
KeyPage-wrapped) over the wire; `RemoteStorage` is a drop-in
TransactionalStorage for schedulers/executors running in other processes.

2PC across the wire preserves the contract: prepare ships the whole
changeset in one frame; commit/rollback are idempotent single calls.
"""

from __future__ import annotations

from typing import Iterator, Optional

from ..codec.wire import Reader, Writer
from ..storage.interface import ChangeSet, Entry, EntryStatus, TransactionalStorage
from .rpc import ServiceClient, ServiceServer


def _write_changeset(w: Writer, changes: ChangeSet) -> None:
    w.u32(len(changes))
    for (table, key), e in changes.items():
        w.text(table).blob(key).u8(1 if e.deleted else 0).blob(e.value)


def _read_changeset(r: Reader) -> ChangeSet:
    out: ChangeSet = {}
    for _ in range(r.u32()):
        table, key, deleted, value = r.text(), r.blob(), r.u8(), r.blob()
        out[(table, key)] = Entry(
            value, EntryStatus.DELETED if deleted else EntryStatus.NORMAL)
    return out


class StorageServer:
    def __init__(self, backend: TransactionalStorage,
                 host: str = "127.0.0.1", port: int = 0, tls_ctx=None):
        self.backend = backend
        self.server = ServiceServer("storage", host, port, tls_ctx=tls_ctx)
        s = self.server
        s.register("get", self._get)
        s.register("set", self._set)
        s.register("remove", self._remove)
        s.register("keys", self._keys)
        s.register("get_batch", self._get_batch)
        s.register("prepare", self._prepare)
        s.register("commit", self._commit)
        s.register("rollback", self._rollback)

    @property
    def port(self) -> int:
        return self.server.port

    def start(self) -> None:
        self.server.start()

    def stop(self) -> None:
        self.server.stop()

    # -- handlers ----------------------------------------------------------
    def _get(self, r: Reader, w: Writer) -> None:
        v = self.backend.get(r.text(), r.blob())
        w.u8(1 if v is not None else 0).blob(v or b"")

    def _set(self, r: Reader, w: Writer) -> None:
        self.backend.set(r.text(), r.blob(), r.blob())

    def _remove(self, r: Reader, w: Writer) -> None:
        self.backend.remove(r.text(), r.blob())

    def _keys(self, r: Reader, w: Writer) -> None:
        ks = list(self.backend.keys(r.text(), r.blob()))
        w.seq(ks, lambda ww, k: ww.blob(k))

    def _get_batch(self, r: Reader, w: Writer) -> None:
        table = r.text()
        ks = r.seq(lambda rr: rr.blob())
        vs = self.backend.get_batch(table, ks)
        w.seq(vs, lambda ww, v: (ww.u8(1 if v is not None else 0),
                                 ww.blob(v or b"")))

    def _prepare(self, r: Reader, w: Writer) -> None:
        number = r.i64()
        self.backend.prepare(number, _read_changeset(r))

    def _commit(self, r: Reader, w: Writer) -> None:
        self.backend.commit(r.i64())

    def _rollback(self, r: Reader, w: Writer) -> None:
        self.backend.rollback(r.i64())


class RemoteStorage(TransactionalStorage):
    def __init__(self, host: str, port: int, timeout: float = 30.0,
                 tls_ctx=None):
        self.client = ServiceClient(host, port, timeout, tls_ctx=tls_ctx)

    def get(self, table: str, key: bytes) -> Optional[bytes]:
        r = self.client.call("get", lambda w: w.text(table).blob(key))
        return r.blob() if r.u8() else None

    def set(self, table: str, key: bytes, value: bytes) -> None:
        self.client.call("set",
                         lambda w: w.text(table).blob(key).blob(value))

    def remove(self, table: str, key: bytes) -> None:
        self.client.call("remove", lambda w: w.text(table).blob(key))

    def keys(self, table: str, prefix: bytes = b"") -> Iterator[bytes]:
        r = self.client.call("keys", lambda w: w.text(table).blob(prefix))
        return iter(r.seq(lambda rr: rr.blob()))

    def get_batch(self, table: str, ks) -> list:
        ks = list(ks)
        r = self.client.call(
            "get_batch",
            lambda w: (w.text(table), w.seq(ks, lambda ww, k: ww.blob(k))))
        out = []
        for _ in range(r.u32()):
            flag = r.u8()
            v = r.blob()
            out.append(v if flag else None)
        return out

    def prepare(self, block_number: int, changes: ChangeSet) -> None:
        self.client.call(
            "prepare",
            lambda w: (w.i64(block_number), _write_changeset(w, changes)))

    def commit(self, block_number: int) -> None:
        self.client.call("commit", lambda w: w.i64(block_number))

    def rollback(self, block_number: int) -> None:
        self.client.call("rollback", lambda w: w.i64(block_number))

    def close(self) -> None:
        self.client.close()
