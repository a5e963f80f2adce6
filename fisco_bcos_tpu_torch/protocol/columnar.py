"""Columnar transaction substrate — wire bytes to batch arrays, no per-tx
Python objects on the hot path.

The JAX package's GIL attribution proved its ~5k-TPS solo ceiling is per-tx
MARSHALLING, not slow logic: ~58% of attributed GIL time sat at the
`ecdsa_recover_batch` FFI call site and ~24% at native hashing — both
already GIL-releasing — while the Python side burned ~0.19 ms/tx building
`Transaction` dataclasses (15 `__setattr__` cache-invalidation hooks per
construction), two `Reader` walks, and per-field bytes copies for every
wire frame. The architectural model is the Blockchain Machine's
network-attached validate pipeline (arxiv 2104.06968) and the FPGA verify
engine's batch framing (arxiv 2112.02229): a transaction stays an ARRAY
ROW — offsets into one shared byte arena plus fixed-width numeric
columns — from the wire through hashing, recovery, admission and sealing.
A Python object materialises only when something OUTSIDE the hot path
asks for one, as a lazy `TxView` backed by the column slices (and even
that is a 7-slot shim, not a dataclass).

Layout contract (must stay byte-identical with `Transaction`):

    frame    = blob(unsigned) ++ blob(signature) ++ i64(import_time)
               ++ u32(attribute)
    unsigned = u16(version) text(chain_id) text(group_id) i64(block_limit)
               text(nonce) blob(to) blob(input) text(abi)

`decode_columns` parses N frames in one pass with `struct.unpack_from`
directly against the arena — no Reader objects, no intermediate bytes.
Re-encoding an admitted row is an arena slice: byte-identical to the
input frame by construction. Frames that are NOT canonical (trailing
garbage, padded inner blob) fall back to `Transaction.decode` per row so
hash identity stays canonical for any wire variant, exactly like the
object path; frames that do not parse at all are isolated per row
(`decode_ok[i] = False`) instead of failing the batch.
"""

from __future__ import annotations

import struct
from typing import Optional, Sequence

import numpy as np

from .types import Transaction

_U16 = struct.Struct(">H")
_U32 = struct.Struct(">I")
_I64 = struct.Struct(">q")


class TxView:
    """Lazy transaction view over one `TxColumns` row.

    Duck-compatible with the `Transaction` surface the node actually uses
    downstream of admission (sealer, executor, ledger prewrite, gossip,
    RPC rendering): payload fields are properties decoding straight from
    the arena, `encode()` is an arena slice, and the `_hash`/`_sender`
    identity caches follow the same protocol as the dataclass (the batch
    pipeline in protocol.types reads and fills them by attribute).

    Views are IMMUTABLE — the columnar contract is that admitted bytes
    are canonical; anything that needs to mutate a tx materialises a real
    `Transaction` via `to_transaction()` first.
    """

    __slots__ = ("_c", "_i", "_hash", "_sender", "_otrace")

    def __init__(self, cols: "TxColumns", i: int,
                 h: Optional[bytes] = None,
                 sender: Optional[bytes] = None):
        self._c = cols
        self._i = i
        self._hash = h
        self._sender = sender
        self._otrace = None

    # -- identity (same lazy-cache protocol as Transaction; the column is
    # the shared cache, so a view created before the batch fill still sees
    # it, and a view that computes solo publishes back) -------------------
    def hash(self, suite) -> bytes:
        if self._hash is None:
            self._hash = self._c.hashes[self._i]
        if self._hash is None:
            self._hash = self._c.hashes[self._i] = \
                suite.hash(self.encode_unsigned())
        return self._hash

    def sender(self, suite) -> Optional[bytes]:
        if self._sender is None:
            self._sender = self._c.senders[self._i]
        if self._sender is None:
            addrs, _ = suite.recover_addresses([self.hash(suite)],
                                               [self.signature])
            self._sender = self._c.senders[self._i] = addrs[0]
        return self._sender

    def set_sender(self, addr: bytes) -> None:
        self._sender = addr
        self._c.senders[self._i] = addr

    # -- encoding: arena slices, byte-identical to the wire input ----------
    def encode(self) -> bytes:
        c = self._c
        return c.arena[c.wire_off[self._i]:c.wire_end[self._i]]

    def encode_unsigned(self) -> bytes:
        c = self._c
        return c.arena[c.unsig_off[self._i]:c.unsig_end[self._i]]

    # -- payload fields -----------------------------------------------------
    @property
    def version(self) -> int:
        return int(self._c.version[self._i])

    @property
    def chain_id(self) -> str:
        return self._c.chain_id[self._i]

    @property
    def group_id(self) -> str:
        return self._c.group_id[self._i]

    @property
    def block_limit(self) -> int:
        return int(self._c.block_limit[self._i])

    @property
    def nonce(self) -> str:
        return self._c.nonce[self._i]

    @property
    def to(self) -> bytes:
        c = self._c
        return c.arena[c.to_off[self._i]:c.to_end[self._i]]

    @property
    def input(self) -> bytes:
        c = self._c
        return c.arena[c.in_off[self._i]:c.in_end[self._i]]

    @property
    def abi(self) -> str:
        c = self._c
        return c.arena[c.abi_off[self._i]:c.abi_end[self._i]].decode()

    @property
    def signature(self) -> bytes:
        c = self._c
        return c.arena[c.sig_off[self._i]:c.sig_end[self._i]]

    @property
    def import_time(self) -> int:
        return int(self._c.import_time[self._i])

    @property
    def attribute(self) -> int:
        return int(self._c.attribute[self._i])

    def to_transaction(self) -> Transaction:
        """Materialise a full Transaction (identity caches primed)."""
        tx = Transaction.decode(self.encode())
        tx._hash = self._hash or self._c.hashes[self._i]
        tx._sender = self._sender or self._c.senders[self._i]
        return tx

    def __repr__(self) -> str:  # debugging aid, never on the hot path
        h = self._hash.hex()[:8] if self._hash else "?"
        return f"TxView(row={self._i}, hash={h})"


class TxColumns:
    """A decoded batch of transactions as columns over one byte arena.

    Offsets are int64 numpy arrays; fixed-width fields (version,
    block_limit, import_time, attribute) are numeric columns so admission
    prechecks vectorise. Identity columns (`hashes`, `senders`) start
    unset and are filled by ONE `suite.hash_batch` / `recover_addresses`
    call over the whole batch (`ensure_hashes` / `ensure_senders`) — the
    same two native entry points the object path uses, minus the N
    dataclass constructions around them.
    """

    __slots__ = (
        "arena", "n",
        "wire_off", "wire_end", "unsig_off", "unsig_end",
        "sig_off", "sig_end", "to_off", "to_end", "in_off", "in_end",
        "abi_off", "abi_end",
        "version", "block_limit", "import_time", "attribute",
        "chain_id", "group_id", "nonce",
        "hashes", "senders", "decode_ok", "fallback", "_views",
    )

    def __len__(self) -> int:
        return self.n

    # -- per-row accessors --------------------------------------------------
    def signature(self, i: int) -> bytes:
        tx = self.fallback.get(i)
        if tx is not None:
            return tx.signature
        return self.arena[self.sig_off[i]:self.sig_end[i]]

    def wire(self, i: int) -> bytes:
        tx = self.fallback.get(i)
        if tx is not None:
            return tx.encode()
        return self.arena[self.wire_off[i]:self.wire_end[i]]

    def unsigned(self, i: int) -> bytes:
        tx = self.fallback.get(i)
        if tx is not None:
            return tx.encode_unsigned()
        return self.arena[self.unsig_off[i]:self.unsig_end[i]]

    def band(self, i: int) -> int:
        """Client-declared priority band (attribute word's top byte)."""
        return (int(self.attribute[i]) >> 24) & 0xFF

    # -- batch identity ------------------------------------------------------
    def ensure_hashes(self, suite) -> list:
        """Fill the hash column with ONE batched hash over the unsigned
        regions (arena slices; fallback rows contribute their canonical
        re-encode). Undecodable rows stay None."""
        todo = [i for i in range(self.n)
                if self.hashes[i] is None and self.decode_ok[i]]
        if todo:
            digests = suite.hash_batch([self.unsigned(i) for i in todo])
            for i, d in zip(todo, digests):
                self.hashes[i] = d
                tx = self.fallback.get(i)
                if tx is not None:
                    tx._hash = d
        return self.hashes

    def ensure_senders(self, suite, rows: Optional[Sequence[int]] = None
                       ) -> np.ndarray:
        """Recover senders for `rows` (default: every decodable row) in
        ONE `recover_addresses` call; -> bool mask over ALL n rows (True
        where the row now has a recovered sender). Per-row failure
        isolation comes from the suite: an invalid signature yields
        ok=False for ITS slot only."""
        self.ensure_hashes(suite)
        if rows is None:
            rows = [i for i in range(self.n) if self.decode_ok[i]]
        todo = [i for i in rows if self.senders[i] is None
                and self.decode_ok[i]]
        out = np.zeros(self.n, bool)
        if todo:
            addrs, ok = suite.recover_addresses(
                [self.hashes[i] for i in todo],
                [self.signature(i) for i in todo])
            for j, i in enumerate(todo):
                if ok[j] and addrs[j] is not None:
                    self.senders[i] = addrs[j]
                    tx = self.fallback.get(i)
                    if tx is not None:
                        tx._sender = addrs[j]
        for i in rows:
            out[i] = self.senders[i] is not None
        return out

    # -- views ---------------------------------------------------------------
    def view(self, i: int):
        """The row's lazy tx object — a `TxView`, or the materialised
        `Transaction` for non-canonical fallback rows (which IS the full
        API already). Cached: the pool holds one object per admitted row."""
        v = self._views.get(i)
        if v is None:
            v = self.fallback.get(i)
            if v is None:
                if not self.decode_ok[i]:
                    raise ValueError(f"columnar row {i} failed decode")
                v = TxView(self, i, self.hashes[i], self.senders[i])
            self._views[i] = v
        return v

    def views(self) -> list:
        return [self.view(i) for i in range(self.n) if self.decode_ok[i]]


def _parse_row(cols: TxColumns, i: int, arena: bytes, base: int,
               end: int) -> bool:
    """Parse one wire frame at arena[base:end) into row i's columns.
    -> True when the frame is CANONICAL (fully consumed, no padding);
    raises on malformed input. Offsets land directly in the column
    arrays — no intermediate objects."""
    # outer: blob(unsigned) blob(sig) i64(import_time) u32(attribute)
    if base + 4 > end:
        raise ValueError("wire: truncated input")
    (ulen,) = _U32.unpack_from(arena, base)
    uoff = base + 4
    uend = uoff + ulen
    if uend + 4 > end:
        raise ValueError("wire: truncated input")
    (slen,) = _U32.unpack_from(arena, uend)
    soff = uend + 4
    send_ = soff + slen
    if send_ + 12 > end:
        raise ValueError("wire: truncated input")
    (import_time,) = _I64.unpack_from(arena, send_)
    (attribute,) = _U32.unpack_from(arena, send_ + 8)
    canonical = (send_ + 12 == end)

    # inner: u16 version, text chain, text group, i64 limit, text nonce,
    #        blob to, blob input, text abi
    o = uoff
    if o + 2 > uend:
        raise ValueError("wire: truncated input")
    (version,) = _U16.unpack_from(arena, o)
    o += 2

    def _span(o: int) -> tuple[int, int]:
        if o + 4 > uend:
            raise ValueError("wire: truncated input")
        (ln,) = _U32.unpack_from(arena, o)
        if o + 4 + ln > uend:
            raise ValueError("wire: truncated input")
        return o + 4, o + 4 + ln

    cid_o, cid_e = _span(o)
    gid_o, gid_e = _span(cid_e)
    o = gid_e
    if o + 8 > uend:
        raise ValueError("wire: truncated input")
    (block_limit,) = _I64.unpack_from(arena, o)
    non_o, non_e = _span(o + 8)
    to_o, to_e = _span(non_e)
    in_o, in_e = _span(to_e)
    abi_o, abi_e = _span(in_e)
    canonical = canonical and (abi_e == uend)

    cols.wire_off[i], cols.wire_end[i] = base, end
    cols.unsig_off[i], cols.unsig_end[i] = uoff, uend
    cols.sig_off[i], cols.sig_end[i] = soff, send_
    cols.to_off[i], cols.to_end[i] = to_o, to_e
    cols.in_off[i], cols.in_end[i] = in_o, in_e
    cols.abi_off[i], cols.abi_end[i] = abi_o, abi_e
    cols.version[i] = version
    cols.block_limit[i] = block_limit
    cols.import_time[i] = import_time
    cols.attribute[i] = attribute
    # the decoded strings are the only per-row Python allocations left on
    # this path: nonce feeds the pool's str-keyed replay filter, and
    # chain/group are interned through a per-batch cache so a homogeneous
    # batch shares two str objects total (bcosflow hot-loop-alloc
    # baseline: justified, see tools/bcosflow_baseline.txt)
    cols.chain_id[i] = arena[cid_o:cid_e]
    cols.group_id[i] = arena[gid_o:gid_e]
    cols.nonce[i] = arena[non_o:non_e].decode()
    return canonical


def decode_columns(wires: Sequence[bytes]) -> TxColumns:
    """Decode N wire frames into columns over one shared arena.

    Per-slice failure isolation: a frame that does not parse marks ITS
    row `decode_ok=False` and never poisons the batch; a frame that
    parses but is non-canonical (trailing/padded bytes) round-trips
    through `Transaction.decode` into `fallback` so its re-encode and
    hash identity match the object path byte-for-byte.
    """
    n = len(wires)
    cols = TxColumns()
    cols.n = n
    cols.arena = b"".join(wires)
    z = lambda dt: np.zeros(n, dtype=dt)  # noqa: E731 — column factory
    cols.wire_off, cols.wire_end = z(np.int64), z(np.int64)
    cols.unsig_off, cols.unsig_end = z(np.int64), z(np.int64)
    cols.sig_off, cols.sig_end = z(np.int64), z(np.int64)
    cols.to_off, cols.to_end = z(np.int64), z(np.int64)
    cols.in_off, cols.in_end = z(np.int64), z(np.int64)
    cols.abi_off, cols.abi_end = z(np.int64), z(np.int64)
    cols.version = z(np.int64)
    cols.block_limit = z(np.int64)
    cols.import_time = z(np.int64)
    cols.attribute = z(np.int64)
    cols.chain_id = [""] * n
    cols.group_id = [""] * n
    cols.nonce = [""] * n
    cols.hashes = [None] * n
    cols.senders = [None] * n
    cols.decode_ok = np.zeros(n, bool)
    cols.fallback = {}
    cols._views = {}

    interned: dict[bytes, str] = {}
    arena = cols.arena
    base = 0
    for i, w in enumerate(wires):
        end = base + len(w)
        try:
            canonical = _parse_row(cols, i, arena, base, end)
            cols.decode_ok[i] = True
            if not canonical:
                # keep identity canonical for padded/garbage-tailed
                # variants: same re-serialise-from-fields behavior as
                # Transaction.decode on non-canonical input
                cols.fallback[i] = Transaction.decode(arena[base:end])
            else:
                for col in (cols.chain_id, cols.group_id):
                    raw = col[i]
                    s = interned.get(raw)
                    if s is None:
                        s = interned[raw] = raw.decode()
                    col[i] = s
        except Exception:
            try:  # last chance: the object decoder may still accept it
                cols.fallback[i] = Transaction.decode(arena[base:end])
                cols.decode_ok[i] = True
                cols.chain_id[i] = cols.fallback[i].chain_id
                cols.group_id[i] = cols.fallback[i].group_id
                cols.nonce[i] = cols.fallback[i].nonce
                cols.block_limit[i] = cols.fallback[i].block_limit
                cols.attribute[i] = cols.fallback[i].attribute
            except Exception:
                cols.decode_ok[i] = False
        base = end
    return cols


def columns_from_transactions(txs: Sequence[Transaction]) -> TxColumns:
    """Columns over already-decoded txs (bench A/B + worker-side reuse):
    encodes each once (cached for decoded txs) and re-parses into the
    arena — identity caches carry over."""
    cols = decode_columns([t.encode() for t in txs])
    for i, t in enumerate(txs):
        if t._hash is not None:
            cols.hashes[i] = t._hash
        if t._sender is not None:
            cols.senders[i] = t._sender
    return cols
