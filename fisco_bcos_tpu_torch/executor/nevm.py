"""Native EVM frame runner — ctypes host bridge to native/nevm/nevm.cpp.

The architecture mirrors the reference's evmone-behind-EVMC split
(FISCO-BCOS bcos-executor/src/vm/VMFactory.h:46-64 creates the VM,
vm/HostContext.cpp exposes state): the C++ interpreter executes one call
frame's bytecode; this module supplies the host callback table that routes
storage reads/writes, balances, code lookup, logs, sub-calls, creates and
selfdestruct back into the Python ``EVM`` object — which keeps the
savepoint/rollback, precompile and DMC-routing logic it already has. The
native and pure-Python interpreters are interchangeable per frame
(``EVM._run`` picks at runtime), so gas and results must match exactly;
tests/test_nevm.py holds the equivalence suite.

Callback-buffer lifetimes: the interpreter copies every buffer a callback
hands back before the callback's Python frame is released; `_Host` pins the
most recent buffers on itself anyway (`_keep`) out of caution.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

from ..protocol import LogEntry

_LIB_ENV = "FBTPU_NEVM_LIB"
_DEFAULT_LIB = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native", "build", "libnevm.so")

_SLOAD = ctypes.CFUNCTYPE(ctypes.c_int32, ctypes.c_void_p,
                          ctypes.POINTER(ctypes.c_uint8),
                          ctypes.POINTER(ctypes.c_uint8))
_SSTORE = ctypes.CFUNCTYPE(ctypes.c_int32, ctypes.c_void_p,
                           ctypes.POINTER(ctypes.c_uint8),
                           ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32)
_BALANCE = ctypes.CFUNCTYPE(ctypes.c_int32, ctypes.c_void_p,
                            ctypes.POINTER(ctypes.c_uint8),
                            ctypes.POINTER(ctypes.c_uint8))
_GETCODE = ctypes.CFUNCTYPE(ctypes.c_int32, ctypes.c_void_p,
                            ctypes.POINTER(ctypes.c_uint8),
                            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                            ctypes.POINTER(ctypes.c_uint64))
_LOG = ctypes.CFUNCTYPE(ctypes.c_int32, ctypes.c_void_p,
                        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
                        ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64)
_CALL = ctypes.CFUNCTYPE(ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32,
                         ctypes.POINTER(ctypes.c_uint8),
                         ctypes.POINTER(ctypes.c_uint8),
                         ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64,
                         ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
                         ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                         ctypes.POINTER(ctypes.c_uint64))
_CREATE = ctypes.CFUNCTYPE(ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32,
                           ctypes.POINTER(ctypes.c_uint8),
                           ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64,
                           ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                           ctypes.POINTER(ctypes.c_int64),
                           ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                           ctypes.POINTER(ctypes.c_uint64),
                           ctypes.POINTER(ctypes.c_uint8))
_SELFDESTRUCT = ctypes.CFUNCTYPE(ctypes.c_int32, ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_uint8))
_ACCESS_ACCT = ctypes.CFUNCTYPE(ctypes.c_int32, ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_uint8),
                                ctypes.c_int32,
                                ctypes.POINTER(ctypes.c_int64))
_SLOAD_COST = ctypes.CFUNCTYPE(ctypes.c_int32, ctypes.c_void_p,
                               ctypes.POINTER(ctypes.c_uint8),
                               ctypes.POINTER(ctypes.c_int64))
_SSTORE_GAS = ctypes.CFUNCTYPE(ctypes.c_int32, ctypes.c_void_p,
                               ctypes.POINTER(ctypes.c_uint8),
                               ctypes.POINTER(ctypes.c_uint8),
                               ctypes.c_int32,
                               ctypes.POINTER(ctypes.c_int64))
_TLOAD = ctypes.CFUNCTYPE(ctypes.c_int32, ctypes.c_void_p,
                          ctypes.POINTER(ctypes.c_uint8),
                          ctypes.POINTER(ctypes.c_uint8))
_TSTORE = ctypes.CFUNCTYPE(ctypes.c_int32, ctypes.c_void_p,
                           ctypes.POINTER(ctypes.c_uint8),
                           ctypes.POINTER(ctypes.c_uint8))


class _NevmHost(ctypes.Structure):
    _fields_ = [
        ("ctx", ctypes.c_void_p),
        ("sload", _SLOAD),
        ("sstore", _SSTORE),
        ("balance", _BALANCE),
        ("get_code", _GETCODE),
        ("do_log", _LOG),
        ("do_call", _CALL),
        ("do_create", _CREATE),
        ("selfdestruct", _SELFDESTRUCT),
        ("access_account", _ACCESS_ACCT),
        ("sload_cost", _SLOAD_COST),
        ("sstore_gas", _SSTORE_GAS),
        ("tload", _TLOAD),
        ("tstore", _TSTORE),
    ]


class _NevmEnv(ctypes.Structure):
    _fields_ = [
        ("origin", ctypes.c_uint8 * 20),
        ("coinbase", ctypes.c_uint8 * 20),
        ("gas_price", ctypes.c_uint64),
        ("block_number", ctypes.c_int64),
        ("timestamp_ms", ctypes.c_int64),
        ("gas_limit", ctypes.c_int64),
        ("chain_id", ctypes.c_uint64),
        ("sm_crypto", ctypes.c_int32),
    ]


class _NevmResult(ctypes.Structure):
    _fields_ = [
        ("status", ctypes.c_int32),
        ("gas_left", ctypes.c_int64),
        ("output", ctypes.POINTER(ctypes.c_uint8)),
        ("output_len", ctypes.c_uint64),
        ("error", ctypes.c_char * 64),
    ]


_lib = None
_lib_lock = threading.Lock()
_lib_failed = False


def load_library():
    """-> loaded CDLL or None (missing/unbuildable library is non-fatal:
    the Python interpreter remains the fallback)."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lib_lock:
        if _lib is not None or _lib_failed:
            return _lib
        path = os.environ.get(_LIB_ENV, _DEFAULT_LIB)
        try:
            # the port's loader: a prebuilt library that does not load or
            # is stale against nevm.cpp is rebuilt from it into the
            # package's _build/ (utils/nativelib.open_library)
            from ..utils.nativelib import open_library
            lib = open_library("nevm", path)
            if lib is None:
                _lib_failed = True
                return None
            lib.nevm_execute.restype = ctypes.c_int32
            lib.nevm_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
            lib.nevm_free.restype = None
            _lib = lib
        except OSError:
            _lib_failed = True
    return _lib


def available() -> bool:
    return load_library() is not None


def _u8(data: bytes):
    return (ctypes.c_uint8 * len(data)).from_buffer_copy(data) if data \
        else ctypes.cast(None, ctypes.POINTER(ctypes.c_uint8))


def _bytes_at(ptr, n: int) -> bytes:
    return ctypes.string_at(ptr, n) if n else b""


_BM_CACHE_MAX = 256
_bm_cache: dict = {}
_bm_lock = threading.Lock()


def _jd_bitmap(code: bytes, dests) -> bytes:
    """JUMPDEST bitmap for the native interpreter, cached per code blob
    (parallels evm.py's _jd_cache — same evmone-style analysis reuse)."""
    with _bm_lock:
        bm = _bm_cache.get(code)
        if bm is not None:
            return bm
    out = bytearray((len(code) + 7) // 8)
    for d in dests:
        out[d // 8] |= 1 << (d % 8)
    bm = bytes(out)
    with _bm_lock:
        if len(_bm_cache) >= _BM_CACHE_MAX:
            _bm_cache.pop(next(iter(_bm_cache)))
        _bm_cache[code] = bm
    return bm


class _Host:
    """Callback closure set for one native frame. Instances are POOLED per
    thread (ctypes CFUNCTYPE construction is the dominant per-call cost for
    small contracts): `bind` rebinds the per-frame fields, the 8 C wrappers
    are built once per instance. Any Python exception raised in a callback
    is captured and surfaced as host-error status; the native side aborts
    the frame immediately."""

    def __init__(self):
        from . import evm as evm_mod

        self._evm_mod = evm_mod
        self.evm = None
        self.state = None
        self.env = None
        self.caller = b""
        self.address = b""
        self.value = 0
        self.depth = 0
        self.static = False
        self.logs: list = []
        self.exc: Optional[BaseException] = None
        self._keep: list = []  # pin callback-returned buffers

        self.c_sload = _SLOAD(self._sload)
        self.c_sstore = _SSTORE(self._sstore)
        self.c_balance = _BALANCE(self._balance)
        self.c_get_code = _GETCODE(self._get_code)
        self.c_log = _LOG(self._log)
        self.c_call = _CALL(self._call)
        self.c_create = _CREATE(self._create)
        self.c_selfdestruct = _SELFDESTRUCT(self._selfdestruct)
        self.c_access_account = _ACCESS_ACCT(self._access_account)
        self.c_sload_cost = _SLOAD_COST(self._sload_cost)
        self.c_sstore_gas = _SSTORE_GAS(self._sstore_gas)
        self.c_tload = _TLOAD(self._tload)
        self.c_tstore = _TSTORE(self._tstore)
        self.table = _NevmHost(
            ctx=None, sload=self.c_sload, sstore=self.c_sstore,
            balance=self.c_balance, get_code=self.c_get_code,
            do_log=self.c_log, do_call=self.c_call,
            do_create=self.c_create, selfdestruct=self.c_selfdestruct,
            access_account=self.c_access_account,
            sload_cost=self.c_sload_cost, sstore_gas=self.c_sstore_gas,
            tload=self.c_tload, tstore=self.c_tstore)

    def bind(self, evm, state, env, caller, address, value, depth, static):
        self.evm = evm
        self.state = state
        self.env = env
        self.caller = caller
        self.address = address
        self.value = value
        self.depth = depth
        self.static = static
        self.logs = []
        self.exc = None
        self._keep = []

    def unbind(self):
        self.evm = self.state = self.env = None
        self.logs = []
        self._keep = []

    # -- callbacks (direct try/except bodies: no per-op closure churn) -----
    def _store_key(self, slot: bytes) -> bytes:
        return self.address + slot

    def _sload(self, _ctx, slot, out):
        try:
            raw = self.state.get(self._evm_mod.T_STORE,
                                 self._store_key(_bytes_at(slot, 32)))
            if not raw:
                return 0
            ctypes.memmove(out, raw.rjust(32, b"\x00"), 32)
            return 1
        except BaseException as exc:  # noqa: BLE001 — surfaced to caller
            self.exc = exc
            return -1

    def _access_account(self, _ctx, addr, surcharge_only, cost_out):
        try:
            a = _bytes_at(addr, 20)
            acc = self.evm.access()
            cost_out[0] = (acc.account_surcharge(a) if surcharge_only
                           else acc.account_cost(a))
            return 0
        except BaseException as exc:  # noqa: BLE001
            self.exc = exc
            return -1

    def _sload_cost(self, _ctx, slot, cost_out):
        try:
            cost_out[0] = self.evm.access().slot_cost(
                self.address, _bytes_at(slot, 32))
            return 0
        except BaseException as exc:  # noqa: BLE001
            self.exc = exc
            return -1

    def _sstore_gas(self, _ctx, slot, val, val_zero, cost_out):
        try:
            slot_b = _bytes_at(slot, 32)
            raw = self.state.get(self._evm_mod.T_STORE,
                                 self.address + slot_b)
            current = int.from_bytes(raw, "big") if raw else 0
            new = 0 if val_zero else int.from_bytes(_bytes_at(val, 32),
                                                    "big")
            acc = self.evm.access()
            orig = acc.note_original(self.address, slot_b, current)
            cost_out[0] = acc.sstore_gas(current, orig, new,
                                         self.address, slot_b)
            return 0
        except BaseException as exc:  # noqa: BLE001
            self.exc = exc
            return -1

    def _tload(self, _ctx, slot, out):
        try:
            v = self.evm.access().tload(self.address, _bytes_at(slot, 32))
            ctypes.memmove(out, v.to_bytes(32, "big"), 32)
            return 0
        except BaseException as exc:  # noqa: BLE001
            self.exc = exc
            return -1

    def _tstore(self, _ctx, slot, val):
        try:
            self.evm.access().tstore(
                self.address, _bytes_at(slot, 32),
                int.from_bytes(_bytes_at(val, 32), "big"))
            return 0
        except BaseException as exc:  # noqa: BLE001
            self.exc = exc
            return -1

    def _sstore(self, _ctx, slot, val, val_zero):
        try:
            key = self._store_key(_bytes_at(slot, 32))
            old = self.state.get(self._evm_mod.T_STORE, key)
            if val_zero:
                if old:
                    self.state.remove(self._evm_mod.T_STORE, key)
            else:
                self.state.set(self._evm_mod.T_STORE, key,
                               _bytes_at(val, 32))
            return 1 if old else 0
        except BaseException as exc:  # noqa: BLE001
            self.exc = exc
            return -1

    def _balance(self, _ctx, addr, out):
        try:
            v = self.evm.balance_of(self.state, _bytes_at(addr, 20))
            ctypes.memmove(out, v.to_bytes(32, "big"), 32)
            return 0
        except BaseException as exc:  # noqa: BLE001
            self.exc = exc
            return -1

    def _get_code(self, _ctx, addr, code_out, len_out):
        try:
            code = self.evm.get_code(self.state, _bytes_at(addr, 20))
            buf = _u8(code)
            self._keep = [buf]  # valid until the next callback
            code_out[0] = ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8))
            len_out[0] = len(code)
            return 0
        except BaseException as exc:  # noqa: BLE001
            self.exc = exc
            return -1

    def _log(self, _ctx, topics, ntopics, data, data_len):
        try:
            raw = _bytes_at(topics, 32 * ntopics) if ntopics else b""
            self.logs.append(LogEntry(
                address=self.address,
                topics=[raw[32 * i:32 * i + 32] for i in range(ntopics)],
                data=_bytes_at(data, data_len)))
            return 0
        except BaseException as exc:  # noqa: BLE001
            self.exc = exc
            return -1

    def _call(self, _ctx, kind, to, value, input_, input_len, gas,
              gas_left_out, out, out_len_out):
        try:
            to_b = _bytes_at(to, 20)
            v = int.from_bytes(_bytes_at(value, 32), "big")
            args = _bytes_at(input_, input_len)
            e = self.evm
            if kind == 0xF1:  # CALL
                res = e.execute_message(self.state, self.env, self.address,
                                        to_b, v, args, gas, self.depth + 1,
                                        self.static)
            elif kind == 0xF2:  # CALLCODE
                res = e._call_with_code(self.state, self.env, self.address,
                                        self.address, v, args, gas,
                                        self.depth + 1, self.static,
                                        e.get_code(self.state, to_b))
            elif kind == 0xF4:  # DELEGATECALL
                res = e._call_with_code(self.state, self.env, self.caller,
                                        self.address, self.value, args, gas,
                                        self.depth + 1, self.static,
                                        e.get_code(self.state, to_b))
            else:  # STATICCALL
                res = e.execute_message(self.state, self.env, self.address,
                                        to_b, 0, args, gas, self.depth + 1,
                                        True)
            self.logs.extend(res.logs)
            buf = _u8(res.output)
            self._keep = [buf]
            out[0] = ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8))
            out_len_out[0] = len(res.output)
            gas_left_out[0] = res.gas_left
            return 1 if res.success else 0
        except BaseException as exc:  # noqa: BLE001
            self.exc = exc
            return -1

    def _create(self, _ctx, is_create2, value, init, init_len, salt, gas,
                gas_left_out, out, out_len_out, addr_out):
        try:
            v = int.from_bytes(_bytes_at(value, 32), "big")
            initcode = _bytes_at(init, init_len)
            salt_i = int.from_bytes(_bytes_at(salt, 32), "big") \
                if is_create2 else None
            res = self.evm.create(self.state, self.env, self.address, v,
                                  initcode, gas, self.depth + 1, salt_i)
            self.logs.extend(res.logs)
            buf = _u8(res.output)
            self._keep = [buf]
            out[0] = ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8))
            out_len_out[0] = len(res.output)
            gas_left_out[0] = res.gas_left
            if res.success and len(res.create_address) == 20:
                ctypes.memmove(addr_out, res.create_address, 20)
            return 1 if res.success else 0
        except BaseException as exc:  # noqa: BLE001
            self.exc = exc
            return -1

    def _selfdestruct(self, _ctx, heir):
        try:
            self.evm.do_selfdestruct(self.state, self.address,
                                     _bytes_at(heir, 20))
            return 0
        except BaseException as exc:  # noqa: BLE001
            self.exc = exc
            return -1


_tls = threading.local()


def _acquire_host() -> "_Host":
    pool = getattr(_tls, "pool", None)
    if pool is None:
        pool = _tls.pool = []
    return pool.pop() if pool else _Host()


def _release_host(host: "_Host") -> None:
    host.unbind()
    if len(_tls.pool) < 64:  # bound: one per nesting depth in practice
        _tls.pool.append(host)


def run_frame(evm, state, env, code: bytes, caller: bytes, address: bytes,
              value: int, calldata: bytes, gas: int, depth: int,
              static: bool, jumpdests):
    """Execute one frame natively; -> EVMResult (mirrors EVM._run)."""
    from .evm import EVMResult

    lib = load_library()
    host = _acquire_host()
    host.bind(evm, state, env, caller, address, value, depth, static)
    table = host.table
    cenv = _NevmEnv(
        origin=(ctypes.c_uint8 * 20)(*env.origin[:20].ljust(20, b"\x00")),
        coinbase=(ctypes.c_uint8 * 20)(*env.coinbase[:20].ljust(20, b"\x00")),
        gas_price=env.gas_price, block_number=env.block_number,
        timestamp_ms=env.timestamp, gas_limit=env.gas_limit,
        chain_id=env.chain_id,
        sm_crypto=1 if getattr(evm.suite, "kind", "ecdsa") == "sm" else 0)
    result = _NevmResult()
    bm = _jd_bitmap(code, jumpdests)
    try:
        lib.nevm_execute(
            ctypes.byref(table), ctypes.byref(cenv),
            _u8(code), ctypes.c_uint64(len(code)), _u8(bm),
            _u8(calldata), ctypes.c_uint64(len(calldata)),
            _u8(caller[:20].ljust(20, b"\x00")),
            _u8(address[:20].ljust(20, b"\x00")),
            _u8((value & ((1 << 256) - 1)).to_bytes(32, "big")),
            ctypes.c_int64(gas), ctypes.c_int32(1 if static else 0),
            ctypes.byref(result))
        logs, exc = host.logs, host.exc
    finally:
        _release_host(host)
    output = _bytes_at(result.output, result.output_len)
    if result.output:
        lib.nevm_free(result.output)
    if result.status == 4 and exc is not None:
        # a host callback raised: real errors (storage failures etc.)
        # propagate exactly as they would from the Python interpreter
        raise exc
    if result.status == 5:
        # the catch-all backstop fired inside the interpreter: this is a
        # native bug, never a consensus result — fail loudly, don't let it
        # masquerade as a deterministic tx failure
        err = result.error.decode(errors="replace")
        raise RuntimeError(f"native EVM internal error: {err}")
    if result.status == 0:
        return EVMResult(True, output, result.gas_left, logs)
    err = result.error.decode(errors="replace")
    if result.status == 1:
        return EVMResult(False, output, result.gas_left, [], error="revert")
    return EVMResult(False, b"", 0, [],
                     error=err or "native frame error")
