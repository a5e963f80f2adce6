"""CryptoLane — one shared device-facing dispatcher for many crypto callers.

The multi-group thesis (PAPER.md §1: many groups per node; Blockchain
Machine, arXiv:2104.06968; the FPGA ECDSA engine, arXiv:2112.02229): the
wide batch-crypto engine holds ~95k verifies/s at 64k lanes while a single
group's scheduler/ingest stack submits batches of a few hundred — one
orderer can never fill the hardware. This lane is the aggregation point
`txpool/ingest.py` built for transactions, generalized to the CRYPTO plane:

  * every group's `verify_batch` / `recover_batch` / `hash_batch` call
    enqueues (args, Task) into a per-op queue instead of crossing into the
    device/native backend itself;
  * ONE dispatcher thread drains a whole queue per cycle and issues ONE
    base-suite call for the concatenated inputs — G groups' concurrent
    batches merge into a single padded device batch (sharded across chips
    by the base suite's `parallel/mesh.py` wiring when >1 device exists);
  * each caller's Task resolves with exactly its own slice of the merged
    result, so a failed verify in one group's slice never affects another
    group's verdicts — results are positional, not shared.

Merging needs NO coalescing window under load: while one merged call is
in flight on the dispatcher, every other group's request queues behind it
and the next drain takes them all (the same argument as the ingest lane's
in-flight coalescing). An idle lane dispatches a lone request immediately —
no latency tax. An optional `wait_ms` window exists for device deployments
where call latency is low and arrival gaps are wide.

`LaneSuite` wraps a base `CryptoSuite` with this routing and is what a
multi-group `GroupManager` hands each group's Node as its suite; every
other suite method (sign, hash, keygen, merkle_root, ...) delegates to the
base suite unchanged. Ops below `min_batch` ALSO bypass the lane: a host
path's 1-sig consensus verify gains nothing from merging and would pay a
thread hop.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional, Sequence

import numpy as np

from ..analysis import lockcheck as lc
from ..utils import failpoints as fp
from ..utils.log import LOG, badge
from ..utils.metrics import REGISTRY
from ..utils.task import Task

# ops the lane merges; everything else delegates straight to the base suite
# ("poseidon" is the ZK proof plane's batched arity-2 hash — every group's
# proof traffic lands in single device calls exactly like verify/recover)
_OPS = ("verify", "recover", "hash", "poseidon")

# fault sites (utils/failpoints.py): `dispatch` fires inside the per-batch
# try (a clean batch rejection), `dispatcher` fires OUTSIDE it — the
# dispatcher-death path the health plane must surface
fp.register("crypto.lane.dispatch", "crypto.lane.dispatcher")


class _Req:
    __slots__ = ("op", "args", "n", "tag", "task", "t_enq")

    def __init__(self, op: str, args: tuple, n: int, tag: str):
        self.op = op
        self.args = args
        self.n = n
        self.tag = tag          # caller identity (group id) for stats
        self.task: Task = Task()
        self.t_enq = time.monotonic()


class CryptoLane:
    """Merges concurrent batch-crypto calls into single device calls.

    One lane per base suite (per crypto kind). Thread-safe; one dispatcher
    thread, started lazily on first submission.
    """

    def __init__(self, suite, wait_ms: float = 0.0, max_batch: int = 65536,
                 host_workers: int = 0):
        self.suite = suite
        self.wait = max(0.0, float(wait_ms)) / 1000.0
        self.max_batch = max(1, int(max_batch))
        # host-path fan-out: the device path shards a merged batch across
        # chips (parallel/mesh.py), so ONE lane call already uses the
        # whole accelerator — but the native host path is single-core per
        # FFI call, and a lane that serializes G groups' crypto onto one
        # core would UNDO the concurrency the per-group suites had. Large
        # merged host batches are therefore split across a small pool of
        # GIL-releasing native calls (the reference's tbb
        # verify_worker_num fan-out, NodeConfig.cpp:486). 0 = #cores.
        import os as _os
        self.host_workers = host_workers or min(4, _os.cpu_count() or 1)
        self._pool = None  # lazy ThreadPoolExecutor
        self._q: dict[str, deque[_Req]] = {op: deque() for op in _OPS}
        self._cv = lc.make_condition("crypto.lane")
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        # dispatcher-death observers: callback(event, msg) with event
        # "died" / "recovered" — the multi-group manager fans these into
        # every hosted node's health plane (a dead lane starves ALL groups'
        # crypto, it must not die silently)
        self.on_fault: list = []
        self._died = False
        # stats: device calls vs caller requests is the merge ratio; the
        # per-tag request means are what the merged device mean must beat
        # for the lane-merging claim to hold (chain_bench --groups)
        self._device_calls = 0
        self._device_items = 0
        self._requests = 0
        self._merged_calls = 0  # device calls that served >1 request
        self._tag_items: dict[str, int] = {}
        self._tag_requests: dict[str, int] = {}
        self._op_calls: dict[str, int] = {}
        self._op_items: dict[str, int] = {}
        # occupancy telemetry: padding-bucket fill/waste, merge
        # occupancy and dispatch timing per op — the evidence base for the
        # 64k-lane batch advantage claims, served via stats()["occupancy"]
        # (getSystemStatus) and the bcos_lane_* metric series
        self._occ: dict[str, dict] = {}

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        with self._cv:
            if self._thread is not None:
                return
            self._stop = False
            self._thread = threading.Thread(target=self._run,
                                            name="crypto-lane", daemon=True)
            self._thread.start()

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout=10)
        with self._cv:
            leftovers = [r for op in _OPS for r in self._q[op]]
            for op in _OPS:
                self._q[op].clear()
            self._thread = None
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)
        for r in leftovers:
            r.task.reject(RuntimeError("crypto lane stopped"))

    # -- producer ----------------------------------------------------------
    def submit(self, op: str, args: tuple, n: int, tag: str = "") -> Task:
        req = _Req(op, args, n, tag)
        with self._cv:
            if self._stop:
                raise RuntimeError("crypto lane stopped")
            revived = False
            if self._thread is None:
                # lazy start: constructing a lane (e.g. from a config
                # default) must not spawn a thread nobody uses. The same
                # path SELF-HEALS a dead dispatcher: the next submission
                # restarts it and clears the fault
                self._stop = False
                self._thread = threading.Thread(
                    target=self._run, name="crypto-lane", daemon=True)
                self._thread.start()
                revived, self._died = self._died, False
            self._q[op].append(req)
            self._requests += 1
            self._tag_requests[tag] = self._tag_requests.get(tag, 0) + 1
            self._tag_items[tag] = self._tag_items.get(tag, 0) + n
            self._cv.notify_all()
        if revived:
            LOG.warning(badge("CRYPTOLANE", "dispatcher-restarted"))
            self._notify_fault("recovered", "")
        return req.task

    def _notify_fault(self, event: str, msg: str) -> None:
        for cb in list(self.on_fault):
            try:
                cb(event, msg)
            except Exception:  # noqa: BLE001 — observers must not recurse
                LOG.exception(badge("CRYPTOLANE", "fault-observer-failed"))

    # -- dispatcher --------------------------------------------------------
    def _run(self) -> None:
        try:
            self._run_inner()
        except BaseException as exc:
            # the shared dispatcher dying starves EVERY group's crypto:
            # reject whatever is queued (callers unblock with an error
            # instead of hanging to their timeout), mark the thread dead
            # so the next submission revives it, and tell the health plane
            LOG.critical(badge("CRYPTOLANE", "dispatcher-died",
                               error=repr(exc)))
            with self._cv:
                leftovers = [r for op in _OPS for r in self._q[op]]
                for op in _OPS:
                    self._q[op].clear()
                if self._thread is threading.current_thread():
                    self._thread = None
                self._died = True
            # notify BEFORE rejecting: a rejected caller's immediate retry
            # revives the lane and emits "recovered" — that must not land
            # ahead of this "died" (a stale degraded would stick). The
            # observer's probe (dispatcher_ok) self-heals any residual
            # ordering race.
            self._notify_fault("died", repr(exc))
            err = RuntimeError(f"crypto lane dispatcher died: {exc!r}")
            for r in leftovers:
                r.task.reject(err)

    def dispatcher_ok(self) -> bool:
        """True while the dispatcher is alive (or lazily revivable after a
        clean stop) — the health plane's self-healing probe for the
        `crypto.lane` fault, immune to died/recovered event reordering."""
        with self._cv:
            return not self._died

    def _run_inner(self) -> None:
        while True:
            # dispatcher-death injection: fires BEFORE any request is
            # popped, so a killed cycle leaves every queued task for the
            # death handler to reject (no caller left hanging)
            fp.fire("crypto.lane.dispatcher")
            with self._cv:
                while not any(self._q[op] for op in _OPS) and not self._stop:
                    self._cv.wait()
                if self._stop and not any(self._q[op] for op in _OPS):
                    return
                if self.wait > 0.0 and not self._stop:
                    # optional micro-window (device deployments): park
                    # briefly for co-arrivals, early-exit on quiesce
                    deadline = time.monotonic() + self.wait
                    while time.monotonic() < deadline:
                        before = sum(len(self._q[op]) for op in _OPS)
                        self._cv.wait(self.wait / 4.0)
                        if sum(len(self._q[op]) for op in _OPS) == before:
                            break
                batches: list[list[_Req]] = []
                for op in _OPS:
                    batch: list[_Req] = []
                    total = 0
                    while self._q[op] and total < self.max_batch:
                        batch.append(self._q[op].popleft())
                        total += batch[-1].n
                    if batch:
                        batches.append(batch)
            for batch in batches:
                self._dispatch(batch)

    def _dispatch(self, batch: list[_Req]) -> None:
        op = batch[0].op
        t0 = time.perf_counter()
        try:
            fp.fire("crypto.lane.dispatch")
            if op == "verify":
                self._do_verify(batch)
            elif op == "recover":
                self._do_recover(batch)
            elif op == "poseidon":
                self._do_poseidon(batch)
            else:
                self._do_hash(batch)
        except Exception as exc:  # noqa: BLE001 — lane must survive
            LOG.exception(badge("CRYPTOLANE", "dispatch-failed", op=op,
                                n=len(batch)))
            for r in batch:
                r.task.reject(exc)
            return
        dt = time.perf_counter() - t0
        n_items = sum(r.n for r in batch)
        # padding-bucket fill/waste: the device path pads row-bucketed ops
        # up to the next compiled bucket (suite._bucket_for); the padded
        # rows are pure waste the merged batch must amortise — the series
        # operators watch to judge whether traffic fills the 64k lanes
        fill, waste = None, None
        if op in ("verify", "recover"):
            use_device = getattr(self.suite, "_use_device", None)
            bucket_for = getattr(self.suite, "_bucket_for", None)
            if use_device is not None and bucket_for is not None \
                    and use_device(n_items):
                try:
                    bucket = max(1, int(bucket_for(n_items)))
                    fill = n_items / bucket
                    waste = max(0, bucket - n_items)
                except Exception:  # noqa: BLE001 — telemetry only
                    pass
        with self._cv:
            self._device_calls += 1
            self._device_items += n_items
            if len(batch) > 1:
                self._merged_calls += 1
            self._op_calls[op] = self._op_calls.get(op, 0) + 1
            self._op_items[op] = self._op_items.get(op, 0) + n_items
            occ = self._occ.setdefault(op, {
                "calls": 0, "items": 0, "requests": 0, "dispatch_s": 0.0,
                "dispatch_s_max": 0.0, "fill_sum": 0.0, "fill_n": 0,
                "waste_items": 0})
            occ["calls"] += 1
            occ["items"] += n_items
            occ["requests"] += len(batch)
            occ["dispatch_s"] += dt
            occ["dispatch_s_max"] = max(occ["dispatch_s_max"], dt)
            if fill is not None:
                occ["fill_sum"] += fill
                occ["fill_n"] += 1
                occ["waste_items"] += waste
        REGISTRY.inc("bcos_crypto_lane_calls_total")
        REGISTRY.inc("bcos_crypto_lane_items_total", n_items)
        REGISTRY.inc("bcos_crypto_lane_requests_total", len(batch))
        REGISTRY.observe("bcos_crypto_lane_batch_size", n_items,
                         buckets=(1, 8, 64, 512, 4096, 16384, 65536))
        # per-op occupancy series (bcos_lane_*): merge occupancy, batch
        # size, device-dispatch latency, padding fill/waste
        lab = {"op": op}
        REGISTRY.observe("bcos_lane_dispatch_seconds", dt, labels=lab)
        REGISTRY.observe("bcos_lane_merge_requests", len(batch), labels=lab,
                         buckets=(1, 2, 4, 8, 16, 32, 64))
        REGISTRY.observe("bcos_lane_batch_items", n_items, labels=lab,
                         buckets=(1, 8, 64, 512, 4096, 16384, 65536))
        if fill is not None:
            REGISTRY.observe("bcos_lane_bucket_fill", fill, labels=lab,
                             buckets=(0.1, 0.25, 0.5, 0.75, 0.9, 1.0))
            REGISTRY.inc("bcos_lane_bucket_waste_items_total", waste,
                         labels=lab)
        if op == "poseidon":
            # the ZK plane's own series: merge count + batch occupancy
            REGISTRY.inc("bcos_zk_lane_calls_total")
            REGISTRY.inc("bcos_zk_lane_items_total", n_items)
            REGISTRY.inc("bcos_zk_lane_requests_total", len(batch))
            REGISTRY.observe("bcos_zk_poseidon_batch_size", n_items,
                             buckets=(1, 8, 64, 512, 4096, 16384, 65536))

    def _host_chunks(self, n: int) -> Optional[list[tuple[int, int]]]:
        """[(offset, len)] when the merged host batch should fan out
        across the worker pool, else None (device path / small batch)."""
        if self.host_workers < 2 or n < 2 * self.host_workers:
            return None
        use_device = getattr(self.suite, "_use_device", None)
        if use_device is None or use_device(n):
            return None  # device path: mesh sharding owns the fan-out
        per = -(-n // self.host_workers)
        return [(o, min(per, n - o)) for o in range(0, n, per)]

    def _fan_out(self, fn, chunks):
        """Run fn(offset, length) per chunk on the pool, in order."""
        from concurrent.futures import ThreadPoolExecutor

        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                self.host_workers, thread_name_prefix="crypto-lane-w")
        return [f.result() for f in
                [self._pool.submit(fn, o, ln) for o, ln in chunks]]

    def _do_verify(self, batch: list[_Req]) -> None:
        digests, sigs, pubs = [], [], []
        for r in batch:
            d, g, p = r.args
            digests.extend(d)
            sigs.extend(g)
            pubs.extend(p)
        chunks = self._host_chunks(len(digests))
        if chunks:
            parts = self._fan_out(
                lambda o, ln: self.suite.verify_batch(
                    digests[o:o + ln], sigs[o:o + ln], pubs[o:o + ln]),
                chunks)
            ok = np.concatenate([np.asarray(p) for p in parts])
        else:
            ok = np.asarray(self.suite.verify_batch(digests, sigs, pubs))
        off = 0
        for r in batch:
            r.task.resolve(ok[off:off + r.n])
            off += r.n

    def _do_recover(self, batch: list[_Req]) -> None:
        digests, sigs = [], []
        for r in batch:
            d, g = r.args
            digests.extend(d)
            sigs.extend(g)
        chunks = self._host_chunks(len(digests))
        if chunks:
            parts = self._fan_out(
                lambda o, ln: self.suite.recover_batch(
                    digests[o:o + ln], sigs[o:o + ln]), chunks)
            pubs = [p for part in parts for p in part[0]]
            ok = np.concatenate([np.asarray(part[1]) for part in parts])
        else:
            pubs, ok = self.suite.recover_batch(digests, sigs)
            ok = np.asarray(ok)
        off = 0
        for r in batch:
            r.task.resolve((pubs[off:off + r.n], ok[off:off + r.n]))
            off += r.n

    def _do_hash(self, batch: list[_Req]) -> None:
        msgs = []
        for r in batch:
            msgs.extend(r.args[0])
        chunks = self._host_chunks(len(msgs))
        if chunks:
            parts = self._fan_out(
                lambda o, ln: self.suite.hash_batch(msgs[o:o + ln]), chunks)
            out = [h for part in parts for h in part]
        else:
            out = self.suite.hash_batch(msgs)
        off = 0
        for r in batch:
            r.task.resolve(out[off:off + r.n])
            off += r.n

    def _do_poseidon(self, batch: list[_Req]) -> None:
        lefts, rights = [], []
        for r in batch:
            a, b = r.args
            lefts.extend(a)
            rights.extend(b)
        # no host fan-out here: the Poseidon host oracle is pure-Python
        # bigint code that never releases the GIL (unlike the native FFI
        # verify/recover/hash paths _host_chunks exists for), so a pool
        # split would serialize anyway and only add dispatch overhead
        out = self.suite.poseidon_batch(lefts, rights)
        off = 0
        for r in batch:
            r.task.resolve(out[off:off + r.n])
            off += r.n

    # -- introspection -----------------------------------------------------
    def stats(self) -> dict:
        with self._cv:
            calls, items = self._device_calls, self._device_items
            return {
                "device_calls": calls,
                "items_total": items,
                "requests_total": self._requests,
                "merged_calls": self._merged_calls,
                "mean_device_batch": round(items / calls, 2) if calls else 0.0,
                "per_tag_mean_batch": {
                    t: round(self._tag_items[t] / n, 2)
                    for t, n in self._tag_requests.items() if n},
                "per_op": {
                    op: {"calls": c,
                         "mean_batch": round(self._op_items[op] / c, 2)}
                    for op, c in self._op_calls.items() if c},
                "occupancy": {
                    op: {
                        "device_calls": o["calls"],
                        "mean_batch": round(o["items"] / o["calls"], 2),
                        "mean_merge": round(o["requests"] / o["calls"], 2),
                        "dispatch_ms_mean": round(
                            1000.0 * o["dispatch_s"] / o["calls"], 3),
                        "dispatch_ms_max": round(
                            1000.0 * o["dispatch_s_max"], 3),
                        "mean_bucket_fill": round(
                            o["fill_sum"] / o["fill_n"], 3)
                        if o["fill_n"] else None,
                        "bucket_waste_items": o["waste_items"],
                    }
                    for op, o in self._occ.items() if o["calls"]},
                "max_batch": self.max_batch,
            }


class LaneSuite:
    """CryptoSuite facade routing batch ops through a shared CryptoLane.

    Everything not listed here (sign, hash, keygen, merkle_root, address
    derivation, suite attributes) delegates to the lane's base suite. The
    `tag` names this caller (the group id) in the lane's per-tag stats.

    `recover_addresses` is re-implemented (not delegated) so its inner
    recover_batch rides the lane too; the valid keys are then hashed by
    one base-suite hash_batch, which on the device path is one kernel
    launch.
    """

    def __init__(self, lane: CryptoLane, tag: str = "",
                 timeout: float = 120.0):
        self._lane = lane
        self._base = lane.suite
        self._tag = tag
        self._timeout = timeout

    def __getattr__(self, name):
        return getattr(self._base, name)

    def __repr__(self):
        return f"LaneSuite({self._tag or '?'} -> {self._base!r})"

    def _merge(self, n: int) -> bool:
        # tiny host-path calls (1-sig consensus verifies) skip the lane:
        # the thread hop costs more than the merge could save, and the
        # lane's win lives where the base suite would cross into the
        # device/native backend with a real batch
        return n >= 2

    def verify_batch(self, digests: Sequence[bytes], sigs: Sequence[bytes],
                     pubs: Sequence[bytes]):
        n = len(digests)
        if not self._merge(n):
            return self._base.verify_batch(digests, sigs, pubs)
        return self._lane.submit("verify", (list(digests), list(sigs),
                                            list(pubs)), n,
                                 self._tag).result(self._timeout)

    def recover_batch(self, digests: Sequence[bytes],
                      sigs: Sequence[bytes]):
        n = len(digests)
        if not self._merge(n):
            return self._base.recover_batch(digests, sigs)
        return self._lane.submit("recover", (list(digests), list(sigs)), n,
                                 self._tag).result(self._timeout)

    def hash_batch(self, msgs: Sequence[bytes]):
        n = len(msgs)
        if not self._merge(n):
            return self._base.hash_batch(msgs)
        return self._lane.submit("hash", (list(msgs),), n,
                                 self._tag).result(self._timeout)

    def poseidon_batch(self, lefts: Sequence[bytes],
                       rights: Sequence[bytes]):
        n = len(lefts)
        if not self._merge(n):
            return self._base.poseidon_batch(lefts, rights)
        return self._lane.submit("poseidon", (list(lefts), list(rights)),
                                 n, self._tag).result(self._timeout)

    def verify(self, pub_bytes: bytes, digest: bytes, sig: bytes) -> bool:
        return bool(np.asarray(self.verify_batch([digest], [sig],
                                                 [pub_bytes]))[0])

    def recover(self, digest: bytes, sig: bytes):
        pubs, ok = self.recover_batch([digest], [sig])
        return pubs[0] if np.asarray(ok)[0] else None

    def recover_addresses(self, digests: Sequence[bytes],
                          sigs: Sequence[bytes]):
        pubs, ok = self.recover_batch(digests, sigs)
        valid = [i for i, p in enumerate(pubs) if p is not None]
        out: list = [None] * len(pubs)
        if valid:
            for i, d in zip(valid, self._base.hash_batch(
                    [pubs[i] for i in valid])):
                out[i] = d[12:]
        return out, ok
