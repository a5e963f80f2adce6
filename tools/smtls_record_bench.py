#!/usr/bin/env python3
"""Throughput of the SM-TLS record path (net/smtls.py), on the host's CPU.

Two ways to compute the same record bytes:

- "block": the JAX package's way, one SM4 block per counter
  (`symm.sm4_encrypt_block`) and the HMAC over the pure-Python
  `refimpl.sm3`; this script carries that loop itself, over the port's
  copies of those functions, so it imports nothing of the JAX package;
- "port": the port's `SMSocket` path, `BlockCipher.ctr` (every counter
  block of a record at once, numpy) and `_hmac_sm3` over the native SM3.

Each size's record is sealed (encrypt, tag) and opened (check the tag,
decrypt) by both; the bytes must be equal. Then a port record stream runs
through a real SMSocket pair (send thread, recv loop). Prints one line per
case (MB/s of plaintext, sealed and opened), the card line of nvidia-smi
where there is one (the numbers are the host CPU's), and one JSON object.

    python3 tools/smtls_record_bench.py [--sizes 1024,65536,1048576]
"""

from __future__ import annotations

import argparse
import json
import socket
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from fisco_bcos_tpu_torch.crypto import refimpl, symm  # noqa: E402
from fisco_bcos_tpu_torch.net import smtls  # noqa: E402

KEY, MAC = bytes(range(16)), bytes(range(32, 64))
BLOCK_MAX = 65536   # the block-at-a-time path runs at ~0.1-0.2 MB/s: sizes up to this


def block_ctr(rks, iv: bytes, data: bytes) -> bytes:
    """The JAX package's BlockCipher.ctr: one block a counter."""
    out = bytearray()
    counter = int.from_bytes(iv, "big")
    for off in range(0, len(data), 16):
        ks = symm.sm4_encrypt_block(rks, counter.to_bytes(16, "big"))
        out += bytes(a ^ b for a, b in zip(data[off:off + 16], ks))
        counter = (counter + 1) % (1 << 128)
    return bytes(out)


def block_hmac(key: bytes, msg: bytes) -> bytes:
    """The JAX package's _hmac_sm3: over the pure-Python SM3."""
    key = key.ljust(64, b"\x00")
    inner = refimpl.sm3(bytes(k ^ 0x36 for k in key) + msg)
    return refimpl.sm3(bytes(k ^ 0x5C for k in key) + inner)


def records(way: str):
    """(seal, open) of one record body (seq | ct | tag), as SMSocket frames it."""
    if way == "block":
        rks = symm.sm4_key_schedule(KEY)
        ctr, tag = (lambda iv, d: block_ctr(rks, iv, d)), block_hmac
    else:
        c = symm.BlockCipher("sm4", KEY)
        ctr, tag = c.ctr, smtls._hmac_sm3

    def seal(seq: int, data: bytes) -> bytes:
        s = struct.pack(">Q", seq)
        ct = ctr(s + bytes(8), data)
        return s + ct + tag(MAC, s + ct)

    def open_(rec: bytes) -> bytes:
        s, ct, t = rec[:8], rec[8:-32], rec[-32:]
        if tag(MAC, s + ct) != t:
            raise ValueError("tag mismatch")
        return ctr(s + bytes(8), ct)

    return seal, open_


def timed(fn, reps: int) -> float:
    fn()   # warm: the native SM3 loads (or builds) on its first call
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return (time.perf_counter() - t0) / reps, out


def socket_stream(size: int, count: int) -> float:
    """MB/s of plaintext through a port SMSocket pair: one thread sends
    `count` records of `size` bytes, the caller receives them."""
    a, b = socket.socketpair()
    tx = smtls.SMSocket(a, KEY, KEY, MAC, MAC, "sm4", "bench", None)
    rx = smtls.SMSocket(b, KEY, KEY, MAC, MAC, "sm4", "bench", None)
    data = bytes(i & 0xFF for i in range(size))
    t0 = time.perf_counter()
    th = threading.Thread(target=lambda: [tx.sendall(data) for _ in range(count)])
    th.start()
    got = 0
    while got < size * count:
        got += len(rx.recv(1 << 20))
    th.join()
    dt = time.perf_counter() - t0
    tx.close()
    rx.close()
    return size * count / dt / 1e6


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip() or "no card"
    except (OSError, subprocess.SubprocessError):
        return "no card"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default="1024,65536,1048576")
    args = ap.parse_args()
    rows = []
    for size in (int(x) for x in args.sizes.split(",")):
        data = bytes((7 * i) & 0xFF for i in range(size))
        row = {"bytes": size}
        sealed = {}
        for way in ("block", "port"):
            if way == "block" and size > BLOCK_MAX:
                continue
            seal, open_ = records(way)
            reps = max(1, min(200, (1 << 22) // size)) if way == "port" else 1
            t_seal, rec = timed(lambda: seal(3, data), reps)
            t_open, back = timed(lambda: open_(rec), reps)
            if back != data:
                print(f"smtls_record_bench: the {way} record does not open", file=sys.stderr)
                return 1
            sealed[way] = rec
            row[f"{way}_seal_MBps"] = size / t_seal / 1e6
            row[f"{way}_open_MBps"] = size / t_open / 1e6
        if len(sealed) == 2 and sealed["block"] != sealed["port"]:
            print("smtls_record_bench: the two ways seal different bytes", file=sys.stderr)
            return 1
        row["socket_MBps"] = socket_stream(size, max(1, min(64, (1 << 24) // size)))
        rows.append(row)
        print(f"[smtls] {size} B records: " + ", ".join(
            f"{k} {v:.4f}" for k, v in row.items() if k != "bytes"))
    print(card_line())
    print(json.dumps({"smtls_records": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
