"""WASM contract engine seam (gated; EVM is the primary VM).

Reference counterpart: the reference gates a WASM VM behind `WITH_WASM`
(cmake/Options.cmake) — BCOS-WASM/wabt interpreter plus
vm/gas_meter/GasInjector.cpp (instruction-level gas injection into the
module before execution) and SCALE-encoded parameters (liquid/WBC
toolchain, bcos-codec/scale/).

This module is the same seam: a `WasmEngine` interface the executor
dispatches to for WASM-attribute transactions, parameter marshalling via
the framework's SCALE codec, and `GasMeteredModule` — the gas-injection
pass over a parsed module's instruction stream. Execution runs on a
pluggable backend (`set_backend`); the default is the in-tree structured
stack-machine interpreter (`wasm_interp`), which charges the metering
plan's per-opcode costs as it runs. Setting the backend to None gates
execution off (`WasmUnavailable`), like a reference build compiled without
WITH_WASM.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..codec import scale

WASM_MAGIC = b"\x00asm"


class WasmUnavailable(RuntimeError):
    def __init__(self):
        super().__init__(
            "WASM execution disabled (backend set to None — the "
            "reference's WITH_WASM=OFF); restore one via "
            "WasmEngine.set_backend / use_interpreter")


def is_wasm(code: bytes) -> bool:
    return code[:4] == WASM_MAGIC


class GasMeteredModule:
    """Instruction-level gas accounting plan for a WASM module.

    Mirrors GasInjector: walk the code section, split it into straight-line
    metering blocks at control-flow boundaries, and record the static cost
    of each block (the backend charges a block's cost when entering it).
    """

    # opcode classes -> unit costs (GasInjector's Metric table shape)
    BRANCH_OPS = frozenset((0x02, 0x03, 0x04, 0x05, 0x0B, 0x0C, 0x0D, 0x0E,
                            0x0F, 0x10, 0x11))
    COST_DEFAULT = 1
    COST_CALL = 5
    COST_MEM = 3

    def __init__(self, code: bytes):
        if not is_wasm(code):
            raise ValueError("not a wasm module")
        self.code = code
        self.blocks: list[tuple[int, int]] = []  # (offset, static_cost)
        try:
            self._plan()
        except IndexError as exc:  # truncated/malformed sections
            raise ValueError("malformed wasm module") from exc

    def _plan(self) -> None:
        # section scan: find code section (id 10), then cost per block
        data = self.code
        off = 8  # magic + version
        code_payload = None
        while off < len(data):
            sec_id = data[off]
            off += 1
            size, off = self._leb(data, off)
            if sec_id == 10:
                code_payload = (off, size)
            off += size
        if code_payload is None:
            return
        start, size = code_payload
        off = start
        nfuncs, off = self._leb(data, off)
        for _ in range(nfuncs):
            body_size, off = self._leb(data, off)
            end = off + body_size
            nlocals, p = self._leb(data, off)
            for _ in range(nlocals):
                _, p = self._leb(data, p)
                p += 1
            block_start, cost = p, 0
            while p < end:
                op = data[p]
                if op in self.BRANCH_OPS:
                    self.blocks.append((block_start, cost))
                    block_start, cost = p + 1, 0
                cost += (self.COST_CALL if op in (0x10, 0x11)
                         else self.COST_MEM if 0x28 <= op <= 0x3E
                         else self.COST_DEFAULT)
                p += 1 + self._imm_len(data, p)
            self.blocks.append((block_start, cost))
            off = end

    @staticmethod
    def _leb(data: bytes, off: int) -> tuple[int, int]:
        result = shift = 0
        while True:
            b = data[off]
            off += 1
            result |= (b & 0x7F) << shift
            if not b & 0x80:
                return result, off
            shift += 7

    @classmethod
    def _imm_len(cls, data: bytes, p: int) -> int:
        """Exact immediate width for the cost walk (wasm MVP opcodes)."""
        op = data[p]

        def leb_end(q: int) -> int:
            while data[q] & 0x80:
                q += 1
            return q + 1

        if op in (0x02, 0x03, 0x04):  # block/loop/if: blocktype immediate
            bt = data[p + 1]
            if bt == 0x40 or 0x7C <= bt <= 0x7F:  # empty / valtype
                return 1
            return leb_end(p + 1) - (p + 1)  # type-index (signed LEB)
        if op == 0x0E:  # br_table: vec(label) + default label
            q = p + 1
            count_start = q
            count = 0
            shift = 0
            while True:
                b = data[q]
                count |= (b & 0x7F) << shift
                shift += 7
                q += 1
                if not b & 0x80:
                    break
            for _ in range(count + 1):
                q = leb_end(q)
            return q - p - 1
        if op == 0x11:  # call_indirect: type idx + table idx
            q = leb_end(p + 1)
            return leb_end(q) - (p + 1)
        if op in (0x3F, 0x40):  # memory.size/grow: one byte
            return 1
        if op in (0x41, 0x42) or 0x20 <= op <= 0x24 or op in (0x0C, 0x0D,
                                                              0x10, 0x25,
                                                              0x26):
            return leb_end(p + 1) - (p + 1)  # single LEB immediate
        if op == 0x43:
            return 4
        if op == 0x44:
            return 8
        if 0x28 <= op <= 0x3E:  # memarg: align + offset LEBs
            q = leb_end(p + 1)
            return leb_end(q) - (p + 1)
        return 0

    def static_cost(self) -> int:
        return sum(c for _, c in self.blocks)


def _bundled_backend(code: bytes, func: str, args: bytes, gas: int,
                     module=None, host=None) -> tuple[bytes, int]:
    """Default runtime: the in-tree interpreter (wasm_interp). `host` is a
    WasmHostContext-like object exposing funcs() (env imports) and
    bind(instance, args) / output for contract I/O. Failure exceptions get
    a `gas_left` attribute so receipts can charge the gas actually burned."""
    from .wasm_interp import Instance, Module, WasmTrap, WasmRevertError

    inst = Instance(Module(code), (host.funcs() if host else {}), gas)
    if host is not None:
        host.bind(inst, args)
    try:
        results = inst.invoke(func, [])
    except (WasmTrap, WasmRevertError) as exc:
        exc.gas_left = inst.gas
        raise
    if host is not None:
        out = host.output
    else:
        out = b"".join(int(r).to_bytes(8, "little") for r in results)
    return out, inst.gas


# backend: callable(code, func, args, gas, module[, host]) -> (out, gas_left)
_BACKEND: Optional[Callable] = _bundled_backend


class WasmEngine:
    """Executor-facing engine: validate + meter + (backend) execute."""

    @staticmethod
    def set_backend(backend: Optional[Callable]) -> None:
        global _BACKEND
        _BACKEND = backend

    @staticmethod
    def use_interpreter() -> None:
        """Restore the default in-tree interpreter backend."""
        global _BACKEND
        _BACKEND = _bundled_backend

    @staticmethod
    def available() -> bool:
        return _BACKEND is not None

    def execute(self, code: bytes, func: str, args: bytes, gas: int,
                host=None) -> tuple[bytes, int]:
        """args/return are SCALE-encoded (codec.scale), as the reference's
        liquid contracts expect."""
        if _BACKEND is None:
            raise WasmUnavailable()
        # the bundled interpreter validates in Module() and meters itself;
        # only external backends consume the injection-style gas plan
        module = (None if _BACKEND is _bundled_backend
                  else GasMeteredModule(code))
        if host is None:
            return _BACKEND(code, func, args, gas, module)
        return _BACKEND(code, func, args, gas, module, host=host)

    @staticmethod
    def encode_args(builder) -> bytes:
        enc = scale.Encoder()
        builder(enc)
        return enc.bytes()
