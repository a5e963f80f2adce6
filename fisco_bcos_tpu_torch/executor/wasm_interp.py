"""Bundled WASM interpreter — the runtime backend behind the WasmEngine seam.

Reference counterpart: the reference executes WASM ("liquid") contracts with
the BCOS-WASM/wabt interpreter after GasInjector.cpp injects instruction-
level gas accounting (FISCO-BCOS bcos-executor/src/vm/gas_meter/
GasInjector.cpp). Here the two halves fuse: a compact structured-control
stack machine that charges the SAME per-opcode costs the GasMeteredModule
plan records (call=5, memory=3, default=1) as it executes, trapping with
WasmOutOfGas the instant the budget goes negative — semantically the
injected-counter scheme without rewriting the module bytes.

Scope: the WASM MVP integer subset — full structured control flow
(block/loop/if/else/br/br_if/br_table/call/call_indirect/return), i32/i64
arithmetic/compare/convert, linear memory with bounds checks, globals,
tables, data/element segments, host imports. Floats trap (consortium
contracts are integer programs; determinism across hosts is a consensus
requirement and float NaN bit-patterns are not worth it).

Host interface: imports from module "env"; each host function is a Python
callable taking (instance, *i32_args). The executor binds contract I/O
(input/output/storage/caller/revert/log) through `WasmHostContext` in
executor.py.
"""

from __future__ import annotations

from typing import Callable, Optional

from .wasm import GasMeteredModule, is_wasm

PAGE = 65536
MAX_PAGES = 256  # 16 MiB cap per instance
MAX_TABLE_ELEMS = 65536
MAX_CALL_DEPTH = 128

COST_DEFAULT = GasMeteredModule.COST_DEFAULT
COST_CALL = GasMeteredModule.COST_CALL
COST_MEM = GasMeteredModule.COST_MEM
COST_GROW_PAGE = 256

M32 = 0xFFFFFFFF
M64 = 0xFFFFFFFFFFFFFFFF


class WasmTrap(RuntimeError):
    """Deterministic trap: unreachable, OOB access, div by zero, etc."""


class WasmOutOfGas(WasmTrap):
    def __init__(self):
        super().__init__("out of gas")


class WasmRevertError(RuntimeError):
    """Host-initiated revert carrying contract-supplied data."""

    def __init__(self, data: bytes):
        super().__init__("wasm revert")
        self.data = data


def _s32(v: int) -> int:
    return v - (1 << 32) if v & 0x80000000 else v


def _s64(v: int) -> int:
    return v - (1 << 64) if v & (1 << 63) else v


def _leb_u(data: bytes, off: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = data[off]
        off += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, off
        shift += 7


def _leb_s(data: bytes, off: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = data[off]
        off += 1
        result |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            if b & 0x40:
                result |= -1 << shift
            return result, off


class Module:
    """Parsed module sections (trusting-but-trapping: structural errors
    raise ValueError at parse, dynamic errors trap at run time)."""

    def __init__(self, code: bytes):
        if not is_wasm(code):
            raise ValueError("not a wasm module")
        self.raw = code
        self.types: list[tuple[list[int], list[int]]] = []
        self.imports: list[tuple[str, str, int]] = []  # (mod, name, typeidx)
        self.funcs: list[int] = []  # local funcs -> typeidx
        self.tables: list[list[Optional[int]]] = []
        self.mem_min = 0
        self.mem_max: Optional[int] = None
        self.globals: list[list] = []  # [valtype, mutable, value-initexpr]
        self.exports: dict[str, tuple[int, int]] = {}  # name -> (kind, idx)
        self.start: Optional[int] = None
        self.codes: list[tuple[list[int], int, int]] = []  # (locals, s, e)
        self.datas: list[tuple[bytes, int]] = []  # (initexpr-offset-bytes...)
        self.elems: list[tuple[bytes, list[int]]] = []
        self._parse()

    def _parse(self) -> None:
        data = self.raw
        off = 8
        try:
            while off < len(data):
                sec = data[off]
                off += 1
                size, off = _leb_u(data, off)
                end = off + size
                if sec == 1:
                    self._parse_types(data, off)
                elif sec == 2:
                    self._parse_imports(data, off)
                elif sec == 3:
                    n, p = _leb_u(data, off)
                    for _ in range(n):
                        t, p = _leb_u(data, p)
                        self.funcs.append(t)
                elif sec == 4:
                    n, p = _leb_u(data, off)
                    for _ in range(n):
                        if data[p] != 0x70:
                            raise ValueError("only funcref tables")
                        p += 1
                        flag = data[p]
                        p += 1
                        mn, p = _leb_u(data, p)
                        if flag & 1:
                            _, p = _leb_u(data, p)
                        if mn > MAX_TABLE_ELEMS:
                            raise ValueError("table min exceeds cap")
                        self.tables.append([None] * mn)
                elif sec == 5:
                    n, p = _leb_u(data, off)
                    if n >= 1:
                        flag = data[p]
                        p += 1
                        self.mem_min, p = _leb_u(data, p)
                        if flag & 1:
                            self.mem_max, p = _leb_u(data, p)
                elif sec == 6:
                    self._parse_globals(data, off)
                elif sec == 7:
                    n, p = _leb_u(data, off)
                    for _ in range(n):
                        ln, p = _leb_u(data, p)
                        name = data[p:p + ln].decode()
                        p += ln
                        kind = data[p]
                        p += 1
                        idx, p = _leb_u(data, p)
                        self.exports[name] = (kind, idx)
                elif sec == 8:
                    self.start, _ = _leb_u(data, off)
                elif sec == 9:
                    self._parse_elems(data, off)
                elif sec == 10:
                    self._parse_code(data, off)
                elif sec == 11:
                    self._parse_datas(data, off)
                off = end
        except (IndexError, UnicodeDecodeError) as exc:
            raise ValueError("malformed wasm module") from exc
        if len(self.funcs) != len(self.codes):
            raise ValueError("function/code section mismatch")

    def _parse_types(self, data, p):
        n, p = _leb_u(data, p)
        for _ in range(n):
            if data[p] != 0x60:
                raise ValueError("bad functype")
            p += 1
            np_, p = _leb_u(data, p)
            params = list(data[p:p + np_])
            p += np_
            nr, p = _leb_u(data, p)
            results = list(data[p:p + nr])
            p += nr
            self.types.append((params, results))

    def _parse_imports(self, data, p):
        n, p = _leb_u(data, p)
        for _ in range(n):
            ml, p = _leb_u(data, p)
            mod = data[p:p + ml].decode()
            p += ml
            nl, p = _leb_u(data, p)
            name = data[p:p + nl].decode()
            p += nl
            kind = data[p]
            p += 1
            if kind != 0x00:
                raise ValueError("only function imports supported")
            t, p = _leb_u(data, p)
            self.imports.append((mod, name, t))

    def _parse_globals(self, data, p):
        n, p = _leb_u(data, p)
        for _ in range(n):
            vt = data[p]
            mut = data[p + 1]
            p += 2
            val, p = self._const_expr(data, p)
            self.globals.append([vt, mut, val])

    def _const_expr(self, data, p) -> tuple[int, int]:
        op = data[p]
        p += 1
        if op == 0x41:
            v, p = _leb_s(data, p)
            v &= M32
        elif op == 0x42:
            v, p = _leb_s(data, p)
            v &= M64
        elif op == 0x23:
            gi, p = _leb_u(data, p)
            v = self.globals[gi][2]
        else:
            raise ValueError(f"unsupported init expr op {op:#x}")
        if data[p] != 0x0B:
            raise ValueError("init expr must end")
        return v, p + 1

    def _parse_elems(self, data, p):
        n, p = _leb_u(data, p)
        for _ in range(n):
            flag, p = _leb_u(data, p)
            if flag != 0:
                raise ValueError("only active table-0 element segments")
            offset, p = self._const_expr(data, p)
            cnt, p = _leb_u(data, p)
            idxs = []
            for _ in range(cnt):
                fi, p = _leb_u(data, p)
                idxs.append(fi)
            self.elems.append((offset.to_bytes(8, "little"), idxs))

    def _parse_code(self, data, p):
        n, p = _leb_u(data, p)
        for _ in range(n):
            size, p = _leb_u(data, p)
            end = p + size
            nl, q = _leb_u(data, p)
            locals_: list[int] = []
            for _ in range(nl):
                cnt, q = _leb_u(data, q)
                vt = data[q]
                q += 1
                locals_.extend([vt] * cnt)
            self.codes.append((locals_, q, end))
            p = end

    def _parse_datas(self, data, p):
        n, p = _leb_u(data, p)
        for _ in range(n):
            flag, p = _leb_u(data, p)
            if flag != 0:
                raise ValueError("only active memory-0 data segments")
            offset, p = self._const_expr(data, p)
            ln, p = _leb_u(data, p)
            self.datas.append((data[p:p + ln], offset))
            p += ln

    def func_type(self, fidx: int) -> tuple[list[int], list[int]]:
        ni = len(self.imports)
        if fidx < ni:
            return self.types[self.imports[fidx][2]]
        return self.types[self.funcs[fidx - ni]]


def _scan_control(data: bytes, start: int, end: int
                  ) -> tuple[dict[int, int], dict[int, int]]:
    """Match block/loop/if offsets to their end (and if -> else)."""
    end_of: dict[int, int] = {}
    else_of: dict[int, int] = {}
    stack: list[int] = []
    p = start
    while p < end:
        op = data[p]
        if op in (0x02, 0x03, 0x04):
            stack.append(p)
        elif op == 0x05 and stack:
            else_of[stack[-1]] = p
        elif op == 0x0B and stack:
            end_of[stack.pop()] = p
        p += 1 + GasMeteredModule._imm_len(data, p)
    return end_of, else_of


class _Label:
    __slots__ = ("is_loop", "pc", "end_pc", "height", "arity")

    def __init__(self, is_loop, pc, end_pc, height, arity):
        self.is_loop = is_loop
        self.pc = pc  # br target for loops (body start)
        self.end_pc = end_pc
        self.height = height
        self.arity = arity


HostFunc = Callable[..., Optional[int]]


class Instance:
    """One instantiated module: memory, globals, tables + the gas budget."""

    def __init__(self, module: Module, host: dict[str, HostFunc]
                 | None = None, gas: int = 1_000_000):
        self.m = module
        self.gas = gas
        self.host: list[HostFunc] = []
        for mod, name, _t in module.imports:
            fn = (host or {}).get(name)
            if fn is None:
                raise WasmTrap(f"unresolved import {mod}.{name}")
            self.host.append(fn)
        # declared minimums are attacker-controlled module bytes: cap them
        # BEFORE allocating, or one deploy tx could OOM the node
        if module.mem_min > MAX_PAGES:
            raise WasmTrap(f"memory min {module.mem_min} pages exceeds the "
                           f"{MAX_PAGES}-page cap")
        if any(len(t) > MAX_TABLE_ELEMS for t in module.tables):
            raise WasmTrap("table size exceeds cap")
        self.memory = bytearray(module.mem_min * PAGE)
        self.globals = [g[2] for g in module.globals]
        self.tables = [list(t) for t in module.tables]
        for off_bytes, idxs in module.elems:
            off = int.from_bytes(off_bytes, "little")
            if off + len(idxs) > len(self.tables[0]):
                raise WasmTrap("element segment out of bounds")
            self.tables[0][off:off + len(idxs)] = idxs
        for blob, off in module.datas:
            if off + len(blob) > len(self.memory):
                raise WasmTrap("data segment out of bounds")
            self.memory[off:off + len(blob)] = blob
        self._ctrl: dict[int, tuple[dict, dict]] = {}
        self.depth = 0
        if module.start is not None:
            self._call(module.start, [])

    # -- gas ---------------------------------------------------------------
    def charge(self, c: int) -> None:
        self.gas -= c
        if self.gas < 0:
            self.gas = 0
            raise WasmOutOfGas()

    # -- memory helpers (host functions use these too) ---------------------
    def mem_read(self, addr: int, n: int) -> bytes:
        if addr < 0 or n < 0 or addr + n > len(self.memory):
            raise WasmTrap("memory access out of bounds")
        return bytes(self.memory[addr:addr + n])

    def mem_write(self, addr: int, blob: bytes) -> None:
        if addr < 0 or addr + len(blob) > len(self.memory):
            raise WasmTrap("memory access out of bounds")
        self.memory[addr:addr + len(blob)] = blob

    # -- invocation --------------------------------------------------------
    def invoke(self, name: str, args: list[int] | None = None) -> list[int]:
        exp = self.m.exports.get(name)
        if exp is None or exp[0] != 0:
            raise WasmTrap(f"no exported function {name!r}")
        return self._call(exp[1], list(args or []))

    def _call(self, fidx: int, args: list[int]) -> list[int]:
        ni = len(self.m.imports)
        params, results = self.m.func_type(fidx)
        if len(args) != len(params):
            raise WasmTrap(f"arity mismatch calling func {fidx}")
        if fidx < ni:
            self.charge(COST_CALL)
            r = self.host[fidx](self, *args)
            if len(results) == 0:
                return []
            return [int(r) & (M64 if results[0] == 0x7E else M32)]
        self.depth += 1
        if self.depth > MAX_CALL_DEPTH:
            self.depth -= 1
            raise WasmTrap("call stack exhausted")
        try:
            return self._run(fidx - ni, args, len(results))
        finally:
            self.depth -= 1

    def _block_arity(self, data: bytes, p: int) -> int:
        bt = data[p]
        if bt == 0x40:
            return 0
        if 0x7C <= bt <= 0x7F:
            return 1
        ti, _ = _leb_s(data, p)
        return len(self.m.types[ti][1])

    # -- the interpreter loop ---------------------------------------------
    def _run(self, code_idx: int, args: list[int], nresults: int
             ) -> list[int]:
        data = self.m.raw
        locals_types, start, end = self.m.codes[code_idx]
        if (start, end) not in self._ctrl:
            self._ctrl[(start, end)] = _scan_control(data, start, end)
        end_of, else_of = self._ctrl[(start, end)]
        loc = args + [0] * len(locals_types)
        st: list[int] = []
        labels: list[_Label] = []
        imm_len = GasMeteredModule._imm_len
        pc = start

        def do_br(lvl: int) -> int:
            tgt = labels[-1 - lvl]
            if tgt.is_loop:
                del labels[len(labels) - lvl:]
                del st[tgt.height:]
                return tgt.pc
            vals = st[len(st) - tgt.arity:] if tgt.arity else []
            del labels[len(labels) - 1 - lvl:]
            del st[tgt.height:]
            st.extend(vals)
            return tgt.end_pc + 1

        while pc < end:
            op = data[pc]
            self.charge(COST_CALL if op in (0x10, 0x11)
                        else COST_MEM if 0x28 <= op <= 0x40
                        else COST_DEFAULT)
            npc = pc + 1 + imm_len(data, pc)

            if op == 0x00:
                raise WasmTrap("unreachable")
            elif op == 0x01:  # nop
                pass
            elif op in (0x02, 0x03):  # block / loop
                arity = self._block_arity(data, pc + 1)
                body = npc
                labels.append(_Label(op == 0x03, body, end_of[pc],
                                     len(st), arity))
            elif op == 0x04:  # if
                arity = self._block_arity(data, pc + 1)
                cond = st.pop()
                labels.append(_Label(False, 0, end_of[pc], len(st), arity))
                if not cond:
                    els = else_of.get(pc)
                    npc = (els + 1) if els is not None else end_of[pc]
            elif op == 0x05:  # else reached inline: true arm done
                npc = labels[-1].end_pc  # its end pops the label
            elif op == 0x0B:  # end
                if labels:
                    labels.pop()
                else:
                    break  # function end
            elif op == 0x0C:  # br
                lvl, _ = _leb_u(data, pc + 1)
                npc = do_br(lvl)
            elif op == 0x0D:  # br_if
                lvl, _ = _leb_u(data, pc + 1)
                if st.pop():
                    npc = do_br(lvl)
            elif op == 0x0E:  # br_table
                q = pc + 1
                cnt, q = _leb_u(data, q)
                targets = []
                for _ in range(cnt):
                    t, q = _leb_u(data, q)
                    targets.append(t)
                dflt, q = _leb_u(data, q)
                i = _s32(st.pop())
                lvl = targets[i] if 0 <= i < cnt else dflt
                npc = do_br(lvl)
            elif op == 0x0F:  # return
                break
            elif op == 0x10:  # call
                fi, _ = _leb_u(data, pc + 1)
                params, _res = self.m.func_type(fi)
                cargs = st[len(st) - len(params):] if params else []
                del st[len(st) - len(params):]
                st.extend(self._call(fi, cargs))
            elif op == 0x11:  # call_indirect
                ti, q = _leb_u(data, pc + 1)
                elem = st.pop()
                if not self.tables or not (0 <= elem < len(self.tables[0])):
                    raise WasmTrap("undefined table element")
                fi = self.tables[0][elem]
                if fi is None:
                    raise WasmTrap("uninitialized table element")
                if self.m.func_type(fi) != self.m.types[ti]:
                    raise WasmTrap("indirect call type mismatch")
                params, _res = self.m.func_type(fi)
                cargs = st[len(st) - len(params):] if params else []
                del st[len(st) - len(params):]
                st.extend(self._call(fi, cargs))
            elif op == 0x1A:  # drop
                st.pop()
            elif op == 0x1B:  # select
                c = st.pop()
                b = st.pop()
                a = st.pop()
                st.append(a if c else b)
            elif op == 0x20:  # local.get
                i, _ = _leb_u(data, pc + 1)
                st.append(loc[i])
            elif op == 0x21:  # local.set
                i, _ = _leb_u(data, pc + 1)
                loc[i] = st.pop()
            elif op == 0x22:  # local.tee
                i, _ = _leb_u(data, pc + 1)
                loc[i] = st[-1]
            elif op == 0x23:  # global.get
                i, _ = _leb_u(data, pc + 1)
                st.append(self.globals[i])
            elif op == 0x24:  # global.set
                i, _ = _leb_u(data, pc + 1)
                if not self.m.globals[i][1]:
                    raise WasmTrap("assignment to immutable global")
                self.globals[i] = st.pop()
            elif 0x28 <= op <= 0x35:  # loads
                self._load(data, pc, st)
            elif 0x36 <= op <= 0x3E:  # stores
                self._store(data, pc, st)
            elif op == 0x3F:  # memory.size
                st.append(len(self.memory) // PAGE)
            elif op == 0x40:  # memory.grow
                delta = st.pop()
                cur = len(self.memory) // PAGE
                limit = min(self.mem_limit(), MAX_PAGES)
                if delta < 0 or cur + delta > limit:
                    st.append(M32)  # -1
                else:
                    self.charge(COST_GROW_PAGE * delta)
                    self.memory.extend(bytes(delta * PAGE))
                    st.append(cur)
            elif op == 0x41:  # i32.const
                v, _ = _leb_s(data, pc + 1)
                st.append(v & M32)
            elif op == 0x42:  # i64.const
                v, _ = _leb_s(data, pc + 1)
                st.append(v & M64)
            elif 0x43 <= op <= 0x44:
                raise WasmTrap("float opcodes unsupported (deterministic "
                               "integer subset)")
            elif 0x45 <= op <= 0xBF:
                self._numeric(op, st)
            else:
                raise WasmTrap(f"unsupported opcode {op:#x}")
            pc = npc

        return st[len(st) - nresults:] if nresults else []

    def mem_limit(self) -> int:
        return self.mem_max_pages if self.mem_max_pages is not None \
            else MAX_PAGES

    @property
    def mem_max_pages(self) -> Optional[int]:
        return self.m.mem_max

    # -- memory ops --------------------------------------------------------
    _LOAD = {  # op: (nbytes, signed, is64)
        0x28: (4, False, False), 0x29: (8, False, True),
        0x2C: (1, True, False), 0x2D: (1, False, False),
        0x2E: (2, True, False), 0x2F: (2, False, False),
        0x30: (1, True, True), 0x31: (1, False, True),
        0x32: (2, True, True), 0x33: (2, False, True),
        0x34: (4, True, True), 0x35: (4, False, True),
    }
    _STORE = {  # op: nbytes
        0x36: 4, 0x37: 8, 0x3A: 1, 0x3B: 2, 0x3C: 1, 0x3D: 2, 0x3E: 4,
    }

    def _memarg(self, data, pc) -> int:
        q = pc + 1
        _align, q = _leb_u(data, q)
        offset, _ = _leb_u(data, q)
        return offset

    def _load(self, data, pc, st) -> None:
        spec = self._LOAD.get(data[pc])
        if spec is None:
            raise WasmTrap(f"float memory op {data[pc]:#x} unsupported")
        n, signed, is64 = spec
        addr = _s32(st.pop()) + self._memarg(data, pc)
        raw = self.mem_read(addr, n)
        v = int.from_bytes(raw, "little", signed=signed)
        st.append(v & (M64 if is64 else M32))

    def _store(self, data, pc, st) -> None:
        n = self._STORE.get(data[pc])
        if n is None:
            raise WasmTrap(f"float memory op {data[pc]:#x} unsupported")
        val = st.pop()
        addr = _s32(st.pop()) + self._memarg(data, pc)
        self.mem_write(addr, (val & ((1 << (8 * n)) - 1)).to_bytes(n, "little"))

    # -- numeric ops -------------------------------------------------------
    def _numeric(self, op: int, st: list[int]) -> None:
        if op == 0x45:  # i32.eqz
            st.append(1 if st.pop() == 0 else 0)
        elif 0x46 <= op <= 0x4F:
            b, a = st.pop(), st.pop()
            st.append(_cmp(op - 0x46, a, b, 32))
        elif op == 0x50:  # i64.eqz
            st.append(1 if st.pop() == 0 else 0)
        elif 0x51 <= op <= 0x5A:
            b, a = st.pop(), st.pop()
            st.append(_cmp(op - 0x51, a, b, 64))
        elif 0x67 <= op <= 0x78:
            self._iarith(op - 0x67, st, 32)
        elif 0x79 <= op <= 0x8A:
            self._iarith(op - 0x79, st, 64)
        elif op == 0xA7:  # i32.wrap_i64
            st.append(st.pop() & M32)
        elif op == 0xAC:  # i64.extend_i32_s
            st.append(_s32(st.pop()) & M64)
        elif op == 0xAD:  # i64.extend_i32_u
            st.append(st.pop() & M32)
        else:
            raise WasmTrap(f"unsupported numeric opcode {op:#x}")

    def _iarith(self, rel: int, st: list[int], bits: int) -> None:
        mask = M64 if bits == 64 else M32
        sgn = _s64 if bits == 64 else _s32
        if rel == 0:  # clz
            v = st.pop()
            st.append(bits - v.bit_length() if v else bits)
            return
        if rel == 1:  # ctz
            v = st.pop()
            st.append((v & -v).bit_length() - 1 if v else bits)
            return
        if rel == 2:  # popcnt
            st.append(bin(st.pop()).count("1"))
            return
        b, a = st.pop(), st.pop()
        if rel == 3:
            r = a + b
        elif rel == 4:
            r = a - b
        elif rel == 5:
            r = a * b
        elif rel == 6:  # div_s
            sa, sb = sgn(a), sgn(b)
            if sb == 0:
                raise WasmTrap("integer divide by zero")
            q = abs(sa) // abs(sb)
            r = -q if (sa < 0) != (sb < 0) else q
            if r == 1 << (bits - 1):
                raise WasmTrap("integer overflow")
        elif rel == 7:  # div_u
            if b == 0:
                raise WasmTrap("integer divide by zero")
            r = a // b
        elif rel == 8:  # rem_s
            sa, sb = sgn(a), sgn(b)
            if sb == 0:
                raise WasmTrap("integer divide by zero")
            r = abs(sa) % abs(sb)
            if sa < 0:
                r = -r
        elif rel == 9:  # rem_u
            if b == 0:
                raise WasmTrap("integer divide by zero")
            r = a % b
        elif rel == 10:
            r = a & b
        elif rel == 11:
            r = a | b
        elif rel == 12:
            r = a ^ b
        elif rel == 13:
            r = a << (b % bits)
        elif rel == 14:  # shr_s
            r = sgn(a) >> (b % bits)
        elif rel == 15:  # shr_u
            r = a >> (b % bits)
        elif rel == 16:  # rotl
            k = b % bits
            r = (a << k) | (a >> (bits - k)) if k else a
        elif rel == 17:  # rotr
            k = b % bits
            r = (a >> k) | (a << (bits - k)) if k else a
        else:
            raise WasmTrap("bad arith op")
        st.append(r & mask)


def _cmp(rel: int, a: int, b: int, bits: int) -> int:
    sgn = _s64 if bits == 64 else _s32
    if rel == 0:
        return 1 if a == b else 0
    if rel == 1:
        return 1 if a != b else 0
    if rel == 2:
        return 1 if sgn(a) < sgn(b) else 0
    if rel == 3:
        return 1 if a < b else 0
    if rel == 4:
        return 1 if sgn(a) > sgn(b) else 0
    if rel == 5:
        return 1 if a > b else 0
    if rel == 6:
        return 1 if sgn(a) <= sgn(b) else 0
    if rel == 7:
        return 1 if a <= b else 0
    if rel == 8:
        return 1 if sgn(a) >= sgn(b) else 0
    return 1 if a >= b else 0
