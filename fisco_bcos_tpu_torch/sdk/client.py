"""Client SDK: JSON-RPC client + transaction assembly/signing.

Reference counterpart: FISCO-BCOS bcos-sdk/bcos-cpp-sdk/ — `Sdk`
(Sdk.h:34-49) bundling a jsonrpc client over the WS service with the tx
builders under utilities/transaction/. Here the transport is HTTP/1.1
with KEEP-ALIVE against `rpc.JsonRpcServer`'s event-loop
edge: each client thread holds one persistent connection (http.client),
so a polling client pays the TCP handshake once, not per request.
Connection resets (a loaded 2-core host sheds accepts under burst) are
retried a bounded number of times — safe for every method here because
queries are idempotent and `sendTransaction` dedups by tx hash in the
pool. `request_batch` posts one JSON-RPC 2.0 batch body.
`TransactionBuilder` mirrors the reference's
TransactionBuilder::createSignedTransaction (sign-and-encode against a
CryptoSuite keypair, auto nonce + blockLimit).
"""

from __future__ import annotations

import http.client
import itertools
import json
import secrets
import threading
import time
import urllib.parse
from typing import Any, Optional

from ..crypto.suite import CryptoSuite
from ..protocol import Transaction


class RpcCallError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(f"rpc error {code}: {message}")
        self.code = code


class SdkClient:
    def __init__(self, url: str, group: str = "group0",
                 node_name: str = "", timeout: float = 60.0,
                 keepalive: bool = True, retries: int = 2,
                 api_key: str = ""):
        self.url = url
        self.group = group
        self.node_name = node_name
        self.timeout = timeout
        self.keepalive = keepalive
        self.retries = max(0, int(retries))
        # edge admission identity (rpc/admission.py): clients behind one
        # NAT/host present an x-api-key so their budgets don't pool
        self.api_key = api_key
        u = urllib.parse.urlsplit(url)
        self._host = u.hostname or "127.0.0.1"
        self._port = u.port or (443 if u.scheme == "https" else 80)
        self._path = u.path or "/"
        # honor the scheme: the urllib transport this replaced spoke TLS
        # for https:// URLs; silently downgrading would leak payloads
        self._conn_cls = (http.client.HTTPSConnection
                          if u.scheme == "https"
                          else http.client.HTTPConnection)
        self._seq = itertools.count(1)
        self._tl = threading.local()  # per-thread persistent connection

    # -- transport ---------------------------------------------------------
    def _drop_conn(self) -> None:
        conn = getattr(self._tl, "conn", None)
        if conn is not None:
            try:
                conn.close()
            except Exception:
                pass
        self._tl.conn = None

    def close(self) -> None:
        self._drop_conn()

    def _post(self, body: bytes) -> bytes:
        headers = {"Content-Type": "application/json"}
        if self.api_key:
            headers["X-Api-Key"] = self.api_key
        if not self.keepalive:
            headers["Connection"] = "close"
        last: Optional[BaseException] = None
        for attempt in range(self.retries + 1):
            conn = getattr(self._tl, "conn", None)
            if conn is None:
                conn = self._conn_cls(self._host, self._port,
                                      timeout=self.timeout)
                self._tl.conn = conn
            try:
                conn.request("POST", self._path, body=body, headers=headers)
                resp = conn.getresponse()
                data = resp.read()
                if not self.keepalive or resp.will_close:
                    self._drop_conn()
                if resp.status != 200:
                    # the edge's plain-text shed responses (400/405/413/
                    # 431) are not JSON — surface the status instead of
                    # letting json.loads raise an opaque decode error
                    raise RpcCallError(
                        -32000, f"HTTP {resp.status}: "
                                f"{data[:200].decode('latin-1')}")
                return data
            except (TimeoutError, http.client.ResponseNotReady) as exc:
                # a timed-out call may still land server-side; retrying
                # would double the caller's wait — surface it
                self._drop_conn()
                raise exc
            except (http.client.HTTPException, ConnectionError,
                    OSError) as exc:
                # bounded retry-on-reset: under 8-way load on a small host
                # the kernel can reset a connection mid-exchange; queries
                # are idempotent and sendTransaction dedups by hash, so a
                # clean re-POST on a FRESH connection is safe
                self._drop_conn()
                last = exc
                if attempt < self.retries:
                    time.sleep(0.05 * (attempt + 1))
        raise last  # type: ignore[misc]

    # -- raw jsonrpc -------------------------------------------------------
    def request(self, method: str, params: list) -> Any:
        body = json.dumps({"jsonrpc": "2.0", "id": next(self._seq),
                           "method": method, "params": params}).encode()
        out = json.loads(self._post(body))
        if "error" in out:
            raise RpcCallError(out["error"]["code"], out["error"]["message"])
        return out.get("result")

    def request_batch(self, calls: list) -> list:
        """POST one JSON-RPC 2.0 batch body; `calls` is a list of
        (method, params). Returns the per-entry response objects in
        request order (each carries its own result OR error — a batch
        never raises on a per-entry error)."""
        entries = [{"jsonrpc": "2.0", "id": next(self._seq),
                    "method": m, "params": p} for m, p in calls]
        raw = self._post(json.dumps(entries).encode())
        if not raw:
            return []  # notification-only batch
        out = json.loads(raw)
        if isinstance(out, dict):  # whole-batch error (parse/empty/cap)
            err = out.get("error", {})
            raise RpcCallError(err.get("code", -32603),
                               err.get("message", "batch error"))
        return out

    def _grouped(self, method: str, *params) -> Any:
        return self.request(method, [self.group, self.node_name, *params])

    # -- convenience API (JsonRpcInterface.cpp:16-71 surface) --------------
    def send_transaction(self, tx: Transaction, require_proof: bool = False,
                         wait: bool = True) -> dict:
        return self._grouped("sendTransaction", "0x" + tx.encode().hex(),
                             require_proof, wait)

    def call(self, to: bytes, data: bytes) -> dict:
        return self._grouped("call", "0x" + to.hex(), "0x" + data.hex())

    def get_block_number(self) -> int:
        return self._grouped("getBlockNumber")

    def get_block_by_number(self, number: int, only_header: bool = False,
                            only_tx_hash: bool = False) -> Optional[dict]:
        return self._grouped("getBlockByNumber", number, only_header,
                             only_tx_hash)

    def get_block_by_hash(self, block_hash: str,
                          only_header: bool = False) -> Optional[dict]:
        return self._grouped("getBlockByHash", block_hash, only_header)

    def get_transaction(self, tx_hash: str,
                        require_proof: bool = False) -> Optional[dict]:
        return self._grouped("getTransaction", tx_hash, require_proof)

    def get_transaction_receipt(self, tx_hash: str,
                                require_proof: bool = False) -> Optional[dict]:
        return self._grouped("getTransactionReceipt", tx_hash, require_proof)

    def get_sealer_list(self) -> list:
        return self._grouped("getSealerList")

    def get_sync_status(self) -> dict:
        return self._grouped("getSyncStatus")

    def get_consensus_status(self) -> dict:
        return self._grouped("getConsensusStatus")

    def get_system_config(self, key: str) -> dict:
        return self._grouped("getSystemConfigByKey", key)

    def get_total_transaction_count(self) -> dict:
        return self._grouped("getTotalTransactionCount")

    def get_pending_tx_size(self) -> int:
        return self._grouped("getPendingTxSize")

    def get_group_info(self) -> dict:
        return self.request("getGroupInfo", [self.group])


class TransactionBuilder:
    """Sign-and-encode helper (reference TransactionBuilder semantics)."""

    def __init__(self, suite: CryptoSuite, client: Optional[SdkClient] = None,
                 chain_id: str = "chain0", group_id: str = "group0",
                 block_limit_offset: int = 500):
        self.suite = suite
        self.client = client
        self.chain_id = chain_id
        self.group_id = group_id
        self.block_limit_offset = block_limit_offset

    def build(self, keypair, to: bytes, data: bytes, abi: str = "",
              nonce: Optional[str] = None,
              block_limit: Optional[int] = None) -> Transaction:
        if block_limit is None:
            current = self.client.get_block_number() if self.client else 0
            block_limit = current + self.block_limit_offset
        if nonce is None:
            nonce = secrets.token_hex(16)
        tx = Transaction(chain_id=self.chain_id, group_id=self.group_id,
                         block_limit=block_limit, nonce=nonce, to=to,
                         input=data, abi=abi)
        return tx.sign(self.suite, keypair)

    def send(self, keypair, to: bytes, data: bytes, **kw) -> dict:
        assert self.client is not None, "builder needs a client to send"
        return self.client.send_transaction(self.build(keypair, to, data,
                                                       **kw))
