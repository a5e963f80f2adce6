"""ExecPool — out-of-process execution workers behind the Scheduler seam.

Even with columnar admission, a node's execute stage serialises Python
opcode work
behind every other plane in the process: precompile dispatch, EVM
interpreter loops and receipt construction all hold THE one GIL that
ingest, crypto-lane host code, consensus and the RPC edge also need.
`services/executor_service.py` already proved the seam — ship encoded
txs, get back encoded receipts plus the state changeset, keep the 2PC
commit parent-side — but as a TCP service it targets Max-mode scale-out.
This module promotes the same seam to a LOCAL pool of spawn()ed worker
processes under the Scheduler (the Blockchain Machine's move of keeping
the ordering/commit plane on the host while the execution engine runs on
its own silicon, arxiv 2104.06968):

  * Each worker is a `multiprocessing` spawn process holding its own
    host-backend CryptoSuite + TransactionExecutor — a fresh interpreter
    with its OWN GIL, so execute no longer taxes the parent's.
  * Blocks ship as the raw wire frames the columnar substrate already
    has (`protocol.columnar` decodes them worker-side into views — the
    worker never builds per-tx dataclasses either), plus the
    admission-recovered senders so no worker re-runs signature recovery.
  * State reads are served BY THE PARENT over the pipe: the worker's
    StateStorage backend is a pipe proxy with a per-block cache. The
    protocol is stateless per block — no mirror to invalidate across
    speculative drops, 2PC rollbacks or snap-sync installs, which is
    exactly the class of bug a cached-mirror design breeds. The parent
    pump thread mostly sleeps in poll() (GIL released); each miss costs
    a dict/overlay lookup.
  * The 2PC, the roots and `ledger.prewrite_block` stay parent-side:
    `state_root` covers the prewrite rows (tx bodies, receipts, nonces)
    that only the parent can write, and the roots' hash batches and trees
    run on the parent's suite (the card) — moving them would ship the
    whole ledger for no GIL relief.
  * A worker's suite is the host suite on the CPU: it never initialises
    CUDA (a context in each worker would cost card memory and change
    nothing), and answers a PING with whether torch.cuda is initialised
    in it, so a caller can check that. Whatever starts a pool keeps its
    `__main__` module's top level free of CUDA work: a spawned child
    re-imports it.

Failure model: a worker dying mid-block
(SIGKILL, OOM) fails only that EXEC — the scheduler falls back to
in-process execution for the block, the health plane flags
`scheduler.exec_worker` degraded, and the health ticker's probe respawns
the worker and clears the fault. Chain correctness never depends on the
pool: it is a pure offload.

With `workers > 1`, a block whose txs ALL carry conflict-key sets (the
same analysis DAG waves use) is sharded across workers by union-find
over conflict keys — disjoint shards touch disjoint state, so receipts
and changesets merge without coordination. Any opaque tx (no conflict
keys => must serialise) sends the whole block to one worker.
"""

from __future__ import annotations

import sys
import threading
import time
from multiprocessing import get_context
from typing import Optional, Sequence

from ..codec.wire import Reader, Writer
from ..utils.log import LOG, badge, metric

# frame kinds (u8) — parent->worker: EXEC, READ_RESP, KEYS_RESP, PING;
# worker->parent: READ, KEYS, DONE, ERR, PONG
K_EXEC, K_READ, K_READ_RESP, K_KEYS, K_KEYS_RESP = 0, 1, 2, 3, 4
K_DONE, K_ERR, K_PING, K_PONG = 5, 6, 7, 8

EXEC_TIMEOUT = 120.0  # generous: a worker that can't finish a block in
#                       this long is treated exactly like a dead one
# a respawned worker answers its first PING only after it has imported
# torch and the package: seconds, more on a loaded host (7-11 s for two at
# once on an H100 machine's host); a shorter bound fails every probe and
# the next respawns the worker again before it is up
PING_TIMEOUT = 60.0


# ---------------------------------------------------------------------------
# worker-side (runs in the spawned child process)
# ---------------------------------------------------------------------------

class _PipeBackend:
    """Worker-side StateStorage backend: reads resolve over the pipe
    against the parent's live block backend (committed storage + the
    speculative changeset stack). Per-block cache — the protocol is
    stateless across blocks by design (see module docstring)."""

    def __init__(self, conn):
        self._conn = conn
        self._cache: dict = {}

    def get(self, table: str, key: bytes) -> Optional[bytes]:
        tk = (table, key)
        if tk in self._cache:
            return self._cache[tk]
        self._conn.send_bytes(
            Writer().u8(K_READ).text(table).blob(key).bytes())
        r = Reader(self._conn.recv_bytes())
        if r.u8() != K_READ_RESP:
            raise RuntimeError("exec-worker: protocol desync on read")
        found = r.u8()
        val = r.blob() if found else None
        self._cache[tk] = val
        return val

    def keys(self, table: str, prefix: bytes = b""):
        self._conn.send_bytes(
            Writer().u8(K_KEYS).text(table).blob(prefix).bytes())
        r = Reader(self._conn.recv_bytes())
        if r.u8() != K_KEYS_RESP:
            raise RuntimeError("exec-worker: protocol desync on keys")
        return iter(r.seq(lambda rr: rr.blob()))

    def set(self, table: str, key: bytes, value: bytes) -> None:
        raise RuntimeError("exec-worker backend is read-only: writes "
                           "belong in the StateStorage overlay")

    def remove(self, table: str, key: bytes) -> None:
        raise RuntimeError("exec-worker backend is read-only: writes "
                           "belong in the StateStorage overlay")


def _cuda_initialized() -> int:
    """1 if this process holds a CUDA context (torch.cuda initialised)."""
    torch = sys.modules.get("torch")
    return int(torch is not None and torch.cuda.is_initialized())


def _exec_worker_main(conn, sm_crypto: bool) -> None:
    """Worker process entry (spawn target). One loop: EXEC in, DONE out,
    serving nothing else — crashes surface to the parent as a dead pipe."""
    # the worker executes Python opcode work; device backends belong to
    # the parent's crypto lane, and a spawned child must not try to grab
    # an accelerator of its own
    from ..crypto.suite import make_suite
    from ..executor.executor import TransactionExecutor
    from ..protocol.columnar import decode_columns
    from ..services.storage_service import _write_changeset
    from ..storage.state import StateStorage

    suite = make_suite(sm_crypto, backend="host", device="cpu")
    executor = TransactionExecutor(suite)
    while True:
        try:
            frame = conn.recv_bytes()
        except (EOFError, OSError):
            return  # parent went away: exit quietly
        r = Reader(frame)
        kind = r.u8()
        if kind == K_PING:
            conn.send_bytes(Writer().u8(K_PONG).u8(_cuda_initialized()).bytes())
            continue
        if kind != K_EXEC:
            conn.send_bytes(Writer().u8(K_ERR).text(
                f"unexpected frame kind {kind}").bytes())
            continue
        try:
            number = r.i64()
            timestamp = r.i64()
            wires = r.seq(lambda rr: rr.blob())
            senders = r.seq(lambda rr: rr.blob())
            cols = decode_columns(wires)
            txs = []
            for i in range(len(cols)):
                v = cols.view(i)
                if senders[i]:
                    v.set_sender(senders[i])
                txs.append(v)
            state = StateStorage(_PipeBackend(conn))
            receipts = executor.execute_block_dag(
                txs, state, number, timestamp)
            w = Writer().u8(K_DONE)
            w.seq(receipts, lambda ww, rc: ww.blob(rc.encode()))
            _write_changeset(w, state.changeset())
            conn.send_bytes(w.bytes())
        except (EOFError, OSError):
            return
        except Exception as exc:  # noqa: BLE001 — report, stay alive:
            # a poisonous block must not cost a respawn cycle
            try:
                conn.send_bytes(Writer().u8(K_ERR).text(repr(exc)).bytes())
            except OSError:
                return


# ---------------------------------------------------------------------------
# parent-side
# ---------------------------------------------------------------------------

class _Worker:
    __slots__ = ("proc", "conn", "alive", "lock", "busy_s", "blocks", "reads")

    def __init__(self, proc, conn):
        self.proc = proc
        self.conn = conn
        self.alive = True
        self.lock = threading.Lock()  # one EXEC in flight per worker
        self.busy_s = 0.0             # occupancy telemetry
        self.blocks = 0
        self.reads = 0                # K_READ / K_KEYS frames served


class ExecPool:
    """Pool of out-of-process execution workers (see module docstring).

    Pure offload: `execute` returns None on ANY worker trouble and the
    caller (Scheduler._execute_locked) runs the block in-process. The
    health plane is informed either way; its probe respawns the dead."""

    def __init__(self, sm_crypto: bool = False, workers: int = 1,
                 health=None, registry=None):
        self.sm_crypto = bool(sm_crypto)
        self.n = max(1, int(workers))
        self.health = health
        from ..utils.metrics import REGISTRY
        self._reg = registry if registry is not None else REGISTRY
        self._ctx = get_context("spawn")
        self._workers: list[Optional[_Worker]] = [None] * self.n
        self._lock = threading.Lock()  # spawn/respawn bookkeeping
        self._started = False
        self._t_started = 0.0
        self._faulted = False
        self._fallbacks = 0

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        with self._lock:
            if self._started:
                return
            self._started = True
            self._t_started = time.monotonic()
            for i in range(self.n):
                self._spawn_locked(i)
        metric("exec_pool.start", workers=self.n,
               pids=[w.proc.pid for w in self._workers if w])

    def _spawn_locked(self, i: int) -> bool:
        try:
            parent_conn, child_conn = self._ctx.Pipe(duplex=True)
            proc = self._ctx.Process(
                target=_exec_worker_main, args=(child_conn, self.sm_crypto),
                name=f"exec-worker-{i}", daemon=True)
            proc.start()
            child_conn.close()
            self._workers[i] = _Worker(proc, parent_conn)
            return True
        except Exception:
            LOG.exception(badge("EXECPOOL", "spawn-failed", idx=i))
            self._workers[i] = None
            return False

    def stop(self) -> None:
        with self._lock:
            self._started = False
            workers, self._workers = self._workers, [None] * self.n
        for w in workers:
            if w is None:
                continue
            try:
                w.conn.close()
            except OSError:
                pass
            w.proc.terminate()
        for w in workers:
            if w is not None:
                w.proc.join(timeout=5)

    def pids(self) -> list[int]:
        """Live worker PIDs (the chaos smoke SIGKILLs one of these)."""
        with self._lock:
            return [w.proc.pid for w in self._workers
                    if w is not None and w.alive and w.proc.is_alive()]

    def stats(self) -> dict:
        """Worker-occupancy telemetry for node status."""
        wall = max(1e-9, time.monotonic() - self._t_started) \
            if self._t_started else 1e-9
        with self._lock:
            per = [{"pid": w.proc.pid if w else None,
                    "alive": bool(w and w.alive and w.proc.is_alive()),
                    "blocks": w.blocks if w else 0,
                    "busy_s": round(w.busy_s, 4) if w else 0.0,
                    "occupancy": round(min(1.0, w.busy_s / wall), 4)
                    if w else 0.0}
                   for w in self._workers]
        return {"workers": self.n, "fallbacks": self._fallbacks,
                "per_worker": per}

    # -- health ------------------------------------------------------------
    def _mark_dead(self, i: int, w: "_Worker", why: str) -> None:
        w.alive = False
        try:
            w.conn.close()
        except OSError:
            pass
        LOG.error(badge("EXECPOOL", "worker-died", idx=i,
                        pid=w.proc.pid, why=why))
        self._reg.inc("bcos_exec_worker_deaths_total")
        if self.health is not None:
            self._faulted = True
            self.health.degraded("scheduler.exec_worker",
                                 f"worker {i} (pid {w.proc.pid}): {why}",
                                 probe=self.probe_respawn)

    def probe_respawn(self) -> bool:
        """Health-plane probe: respawn any dead worker, verify the pool
        answers pings. True = healed (fault cleared by the ticker)."""
        ok = True
        with self._lock:
            if not self._started:
                return True  # stopped pool is not a fault
            for i, w in enumerate(self._workers):
                if w is not None and w.alive and w.proc.is_alive():
                    continue
                if w is not None and w.proc.is_alive():
                    w.proc.terminate()
                if not self._spawn_locked(i):
                    ok = False
        if not ok:
            return False
        for i, w in enumerate(list(self._workers)):
            if w is None:
                return False
            with w.lock:
                try:
                    w.conn.send_bytes(Writer().u8(K_PING).bytes())
                    if not w.conn.poll(PING_TIMEOUT):
                        raise TimeoutError("ping timeout")
                    if Reader(w.conn.recv_bytes()).u8() != K_PONG:
                        raise RuntimeError("bad pong")
                except Exception:  # noqa: BLE001 — probe verdict only
                    w.alive = False
                    return False
        metric("exec_pool.respawned", workers=self.n)
        return True

    def pipe_reads(self) -> int:
        """State reads the live workers have asked of this process."""
        with self._lock:
            return sum(w.reads for w in self._workers if w is not None)

    def ping(self, timeout: float = PING_TIMEOUT) -> list[Optional[bool]]:
        """PING each worker (a fresh one answers once its imports are
        done): -> whether it holds a CUDA context, one entry a worker.
        None: dead, or not answering within `timeout` (then marked dead,
        as a late PONG would desync its next EXEC)."""
        with self._lock:
            workers = list(enumerate(self._workers))
        out: list[Optional[bool]] = []
        for i, w in workers:
            if w is None or not w.alive:
                out.append(None)
                continue
            with w.lock:
                try:
                    w.conn.send_bytes(Writer().u8(K_PING).bytes())
                    if not w.conn.poll(timeout):
                        raise TimeoutError("ping timeout")
                    r = Reader(w.conn.recv_bytes())
                    if r.u8() != K_PONG:
                        raise RuntimeError("bad pong")
                    out.append(bool(r.u8()))
                except (EOFError, OSError, TimeoutError, RuntimeError) as exc:
                    self._mark_dead(i, w, repr(exc))
                    out.append(None)
        return out

    # -- execution ---------------------------------------------------------
    def execute(self, txs: Sequence, backend, number: int, timestamp: int,
                suite, executor) -> Optional[tuple[list, dict]]:
        """Run a block on the pool. -> (receipts, changeset) or None (any
        worker trouble; caller falls back in-process). `backend` is the
        block's read view (committed storage or the speculative stack);
        `suite`/`executor` are the PARENT's — used only for sender
        backfill and shard planning, never for execution."""
        if not self._started or not txs:
            return None
        # senders ship with the frames so no worker re-runs recovery; the
        # batch call is a no-op when admission already populated them
        # (sync-replayed blocks are the cache-miss case)
        if any(getattr(t, "_sender", None) is None for t in txs):
            from ..protocol import batch_recover_senders
            batch_recover_senders(list(txs), suite)
        shards = self._plan_shards(txs, backend, executor)
        if shards is None or not shards:
            return None
        results: list = [None] * len(shards)
        if len(shards) == 1:
            results[0] = self._run_shard(shards[0][0], shards[0][1], txs,
                                         backend, number, timestamp)
        else:
            threads = []
            for si, (wi, idxs) in enumerate(shards):
                th = threading.Thread(
                    target=lambda si=si, wi=wi, idxs=idxs:
                        results.__setitem__(
                            si, self._run_shard(wi, idxs, txs, backend,
                                                number, timestamp)),
                    name=f"exec-pump-{si}", daemon=True)
                th.start()
                threads.append(th)
            for th in threads:
                th.join()
        if any(r is None for r in results):
            # partial results are DISCARDED whole: receipts/changeset
            # merging with an in-process retry of just the failed shard
            # would have to prove read isolation against the completed
            # shards — the fallback re-executes everything instead
            self._fallbacks += 1
            self._reg.inc("bcos_exec_pool_fallbacks_total")
            return None
        receipts: list = [None] * len(txs)
        changes: dict = {}
        for (wi, idxs), (rcs, cs) in zip(shards, results):
            for j, i in enumerate(idxs):
                receipts[i] = rcs[j]
            changes.update(cs)  # disjoint by conflict-key partitioning
        return receipts, changes

    def _plan_shards(self, txs, backend, executor
                     ) -> Optional[list[tuple[int, list[int]]]]:
        """-> [(worker_idx, [tx indices])] or None (no live worker).
        Single live worker (or any opaque tx) => one shard with every tx;
        otherwise union-find over conflict keys, exactly the disjointness
        DAG waves already rely on."""
        live = [i for i, w in enumerate(self._workers)
                if w is not None and w.alive]
        if not live:
            return None
        if len(live) == 1 or len(txs) < 2:
            return [(live[0], list(range(len(txs))))]
        from ..storage.state import StateStorage
        probe = StateStorage(backend)
        parent: dict[int, int] = {i: i for i in range(len(txs))}

        def find(a: int) -> int:
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        key_owner: dict[bytes, int] = {}
        for i, tx in enumerate(txs):
            try:
                keys = executor._conflict_keys(tx, probe)
            except Exception:  # noqa: BLE001 — analysis only
                keys = None
            if keys is None:  # opaque: must serialise with everything
                return [(live[0], list(range(len(txs))))]
            for k in keys:
                o = key_owner.get(k)
                if o is None:
                    key_owner[k] = i
                else:
                    ra, rb = find(o), find(i)
                    if ra != rb:
                        parent[rb] = ra
        groups: dict[int, list[int]] = {}
        for i in range(len(txs)):
            groups.setdefault(find(i), []).append(i)
        comps = sorted(groups.values(), key=len, reverse=True)
        if len(comps) == 1:
            return [(live[0], list(range(len(txs))))]
        # greedy longest-processing-time assignment onto the live workers
        buckets: list[list[int]] = [[] for _ in live]
        loads = [0] * len(live)
        for comp in comps:
            b = loads.index(min(loads))
            buckets[b].extend(comp)
            loads[b] += len(comp)
        return [(live[b], sorted(idxs))
                for b, idxs in enumerate(buckets) if idxs]

    def _run_shard(self, wi: int, idxs: list[int], txs, backend,
                   number: int, timestamp: int
                   ) -> Optional[tuple[list, dict]]:
        """Ship one shard to worker `wi` and pump its reads until DONE.
        -> (receipts, changeset) aligned with `idxs`, or None."""
        from ..protocol import Receipt
        from ..services.storage_service import _read_changeset
        with self._lock:
            w = self._workers[wi]
        if w is None or not w.alive:
            return None
        t0 = time.monotonic()
        with w.lock:
            if not w.alive:
                return None
            try:
                fr = Writer().u8(K_EXEC).i64(number).i64(timestamp)
                fr.seq([txs[i] for i in idxs],
                       lambda ww, t: ww.blob(t.encode()))
                fr.seq([txs[i] for i in idxs],
                       lambda ww, t: ww.blob(
                           getattr(t, "_sender", None) or b""))
                w.conn.send_bytes(fr.bytes())
                deadline = time.monotonic() + EXEC_TIMEOUT
                while True:
                    if not w.conn.poll(min(1.0, max(0.0, deadline
                                                    - time.monotonic()))):
                        if time.monotonic() >= deadline:
                            raise TimeoutError(
                                f"exec timeout after {EXEC_TIMEOUT}s")
                        if not w.proc.is_alive():
                            raise EOFError("worker process exited")
                        continue
                    r = Reader(w.conn.recv_bytes())
                    kind = r.u8()
                    if kind == K_READ:
                        w.reads += 1
                        table, key = r.text(), r.blob()
                        val = backend.get(table, key)
                        resp = Writer().u8(K_READ_RESP)
                        resp.u8(1 if val is not None else 0)
                        resp.blob(val if val is not None else b"")
                        w.conn.send_bytes(resp.bytes())
                    elif kind == K_KEYS:
                        w.reads += 1
                        table, prefix = r.text(), r.blob()
                        ks = list(backend.keys(table, prefix))
                        resp = Writer().u8(K_KEYS_RESP)
                        resp.seq(ks, lambda ww, k: ww.blob(k))
                        w.conn.send_bytes(resp.bytes())
                    elif kind == K_DONE:
                        receipts = [Receipt.decode(b)
                                    for b in r.seq(lambda rr: rr.blob())]
                        changes = _read_changeset(r)
                        dt = time.monotonic() - t0
                        w.busy_s += dt
                        w.blocks += 1
                        self._reg.observe("bcos_exec_worker_seconds", dt)
                        return receipts, changes
                    elif kind == K_ERR:
                        LOG.error(badge("EXECPOOL", "worker-exec-error",
                                        number=number, error=r.text()))
                        return None  # worker is fine, the block is not:
                        #              fall back without killing it
                    else:
                        raise RuntimeError(f"protocol desync: kind {kind}")
            except (EOFError, OSError, TimeoutError, RuntimeError) as exc:
                self._mark_dead(wi, w, repr(exc))
                return None
