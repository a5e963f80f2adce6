"""Runtime lock-discipline checker — instrumented locks behind an env gate.

Hot modules construct their locks through the factories here instead of
calling `threading.Lock()` directly (bcoslint rule `raw-lock-in-hot-module`
enforces it):

    from ..analysis import lockcheck as lc
    self._lock = lc.make_rlock("engine.state")
    self._cv = lc.make_condition("crypto.lane")

**Disarmed** (the production state — `BCOS_LOCKCHECK` unset), a factory
returns the plain `threading` primitive: the checker costs NOTHING at
steady state beyond one module-flag branch at each `note_blocking` marker
(same idiom as utils/failpoints.py's disarmed `fire()`).

**Armed** (`BCOS_LOCKCHECK=1`, or `arm()` before the locks are built — the
tier-1 conftest fixture does the former), every checked lock records:

  * the **lock-order graph**: acquiring B while holding A adds edge A->B
    with the acquisition stack captured the first time the edge appears.
    A cycle in the graph is a potential deadlock; an edge that contradicts
    the canonical ranks (analysis/lockorder.py) is an order violation even
    before a full cycle exists.
  * **self-deadlocks**: re-acquiring a non-reentrant checked lock on the
    same thread raises immediately (with the site recorded) instead of
    hanging the suite forever.
  * **blocking-while-locked**: call sites that are about to block (fsync,
    socket sendall, `suite.*_batch`, subprocess waits, sleeps) cross a
    `note_blocking(kind)` marker; if any HOT lock held by the thread does
    not allow that kind (lockorder.HOT_LOCKS), a violation is recorded
    with both stacks.
  * **hold/wait histograms**: `bcos_lock_hold_seconds{lock=...}`,
    `bcos_lock_wait_seconds{lock=...}` and
    `bcos_lock_acquisitions_total{lock=...}` in the metrics registry, so
    an armed soak shows exactly which lock a regression parked on.

`report()` returns the findings; `assert_clean()` raises with a rendered
graph dump when any cycle/violation exists (the conftest fixture and the
sanitize_ci smoke call it). `reset()` clears findings between phases.

Instances are named, not unique: every node's txpool lock is
"txpool.state". Edges between two locks of the SAME name are skipped (an
in-process cluster would otherwise report false self-cycles); genuinely
re-acquiring the same INSTANCE is the self-deadlock check above.
"""

from __future__ import annotations

import os
import threading
import time
import traceback
from typing import Optional

from .lockorder import HOT_LOCKS, RANK

__all__ = [
    "arm", "armed", "assert_clean", "disarm", "dump_graph",
    "make_condition", "make_lock", "make_rlock", "note_blocking",
    "report", "reset",
]

_armed_flag = os.environ.get("BCOS_LOCKCHECK", "") == "1"

_reg = threading.Lock()  # guards every structure below
_edges: dict[tuple[str, str], dict] = {}   # (outer, inner) -> record
_cycles: list[dict] = []
_order_violations: list[dict] = []
_blocking: list[dict] = []
_self_deadlocks: list[dict] = []
_seen_cycles: set[tuple] = set()
_seen_blocking: set[tuple] = set()

_tls = threading.local()  # .held: list[_Held]


def armed() -> bool:
    return _armed_flag


def arm() -> None:
    """Arm the checker. Takes effect for locks constructed AFTERWARDS —
    arm before building the objects under test (the env form arms at
    import, before anything exists)."""
    global _armed_flag
    _armed_flag = True


def disarm() -> None:
    global _armed_flag
    _armed_flag = False


def reset() -> None:
    """Clear findings and the edge graph (between test phases)."""
    with _reg:
        _edges.clear()
        _cycles.clear()
        _order_violations.clear()
        _blocking.clear()
        _self_deadlocks.clear()
        _seen_cycles.clear()
        _seen_blocking.clear()


# -- factories (the ONLY public constructors) ------------------------------

def make_lock(name: str):
    """Checked/plain `threading.Lock` depending on the armed state."""
    if not _armed_flag:
        return threading.Lock()
    return _CheckedLock(name)


def make_rlock(name: str):
    if not _armed_flag:
        return threading.RLock()
    return _CheckedRLock(name)


def make_condition(name: str):
    """Condition over its own (checked) lock — the shape every repo cv
    uses. `wait()` correctly un-tracks the lock for the parked duration."""
    if not _armed_flag:
        return threading.Condition()
    return _CheckedCondition(name)


# -- per-thread held stack -------------------------------------------------

class _Held:
    __slots__ = ("obj", "name", "t_acq", "count")

    def __init__(self, obj, name: str, t_acq: float):
        self.obj = obj
        self.name = name
        self.t_acq = t_acq
        self.count = 1  # RLock reentrancy depth


def _held_stack() -> list:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _stack(skip: int = 2, limit: int = 14) -> list[str]:
    """Compact acquisition stack: innermost last, checker frames dropped."""
    out = []
    for fr in traceback.extract_stack(limit=limit + skip)[:-skip]:
        if "/analysis/lockcheck" in fr.filename.replace("\\", "/"):
            continue
        out.append(f"{os.path.basename(fr.filename)}:{fr.lineno} "
                   f"in {fr.name}")
    return out[-limit:]


# -- graph bookkeeping -----------------------------------------------------

def _find_path(src: str, dst: str) -> Optional[list[str]]:
    """DFS under _reg: a lock-name path src -> ... -> dst, or None."""
    adj: dict[str, list[str]] = {}
    for (a, b) in _edges:
        adj.setdefault(a, []).append(b)
    seen = {src}
    stack = [(src, [src])]
    while stack:
        node, path = stack.pop()
        for nxt in adj.get(node, ()):
            if nxt == dst:
                return path + [nxt]
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _record_edge(outer: str, inner: str) -> None:
    with _reg:
        rec = _edges.get((outer, inner))
        if rec is not None:
            rec["count"] += 1
            return
        stack = _stack()
        _edges[(outer, inner)] = {"count": 1, "stack": stack}
        ra, rb = RANK.get(outer), RANK.get(inner)
        if ra is not None and rb is not None and ra >= rb:
            _order_violations.append({
                "outer": outer, "inner": inner,
                "outer_rank": ra, "inner_rank": rb, "stack": stack})
        # the brand-new edge is the only one that can close a NEW cycle:
        # a path inner -> ... -> outer already in the graph completes it
        back = _find_path(inner, outer)
        if back is not None:
            cyc = back + [inner]
            key = tuple(sorted(set(cyc)))
            if key not in _seen_cycles:
                _seen_cycles.add(key)
                _cycles.append({
                    "path": cyc,
                    "closing_edge": (outer, inner),
                    "stack": stack,
                    "edge_stacks": {
                        f"{a}->{b}": _edges[(a, b)]["stack"]
                        for a, b in zip(back, back[1:] + [inner])
                        if (a, b) in _edges},
                })


def _on_acquired(obj, name: str, held: list, t_wait0: float) -> None:
    now = time.monotonic()
    wait = now - t_wait0
    from ..utils.metrics import REGISTRY
    REGISTRY.inc("bcos_lock_acquisitions_total", labels={"lock": name})
    if wait > 1e-6:
        REGISTRY.observe("bcos_lock_wait_seconds", wait,
                         labels={"lock": name})
    for h in held:
        if h.name != name:
            _record_edge(h.name, name)
    held.append(_Held(obj, name, now))


def _on_released(obj, name: str, held: list) -> None:
    for i in range(len(held) - 1, -1, -1):
        if held[i].obj is obj:
            h = held.pop(i)
            from ..utils.metrics import REGISTRY
            REGISTRY.observe("bcos_lock_hold_seconds",
                            time.monotonic() - h.t_acq,
                            labels={"lock": name})
            return


def _check_self_deadlock(obj, name: str, held: list) -> None:
    for h in held:
        if h.obj is obj:
            stack = _stack()
            with _reg:
                _self_deadlocks.append({"lock": name, "stack": stack})
            raise RuntimeError(
                f"lockcheck: thread re-acquired non-reentrant lock "
                f"{name!r} it already holds (real code would deadlock "
                f"here)\n  " + "\n  ".join(stack))


# -- blocking-while-locked markers ----------------------------------------

def note_blocking(kind: str, detail: str = "") -> None:
    """Marker crossed immediately before a blocking operation (fsync,
    socket sendall, suite batch call, subprocess wait, sleep). Disarmed:
    one flag branch. Armed: records a violation for every HOT lock the
    calling thread holds whose allow-set excludes `kind`."""
    if not _armed_flag:
        return
    held = getattr(_tls, "held", None)
    if not held:
        return
    for h in held:
        allow = HOT_LOCKS.get(h.name)
        if allow is not None and kind not in allow:
            key = (h.name, kind, detail)
            with _reg:
                if key in _seen_blocking:
                    continue
                _seen_blocking.add(key)
                _blocking.append({"lock": h.name, "kind": kind,
                                  "detail": detail, "stack": _stack()})
            from ..utils.metrics import REGISTRY
            REGISTRY.inc("bcos_lock_blocking_violations_total",
                         labels={"lock": h.name, "kind": kind})


# -- checked primitives ----------------------------------------------------

class _CheckedLock:
    """Drop-in threading.Lock with order/self-deadlock/hold tracking."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        held = _held_stack()
        if blocking:
            _check_self_deadlock(self._lock, self.name, held)
        t0 = time.monotonic()
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            _on_acquired(self._lock, self.name, held, t0)
        return ok

    def release(self) -> None:
        _on_released(self._lock, self.name, _held_stack())
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self):
        return f"<CheckedLock {self.name}>"


class _CheckedRLock:
    """Drop-in threading.RLock: reentrant acquires deepen the held entry
    instead of adding edges (a lock cannot order against itself)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.RLock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        held = _held_stack()
        for h in held:
            if h.obj is self._lock:  # reentrant: no edge, no new entry
                if self._lock.acquire(blocking, timeout):
                    h.count += 1
                    return True
                return False
        t0 = time.monotonic()
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            _on_acquired(self._lock, self.name, held, t0)
        return ok

    def release(self) -> None:
        held = _held_stack()
        for h in held:
            if h.obj is self._lock and h.count > 1:
                h.count -= 1
                self._lock.release()
                return
        _on_released(self._lock, self.name, held)
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self):
        return f"<CheckedRLock {self.name}>"


class _CheckedCondition:
    """Drop-in threading.Condition over an internal plain lock. The held
    entry is popped for the parked duration of wait() — a thread blocked
    IN wait has released the lock, so it must neither contribute order
    edges nor count toward blocking-while-locked."""

    def __init__(self, name: str):
        self.name = name
        self._inner = threading.Lock()
        self._cond = threading.Condition(self._inner)

    # lock surface
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        held = _held_stack()
        if blocking:
            _check_self_deadlock(self._inner, self.name, held)
        t0 = time.monotonic()
        ok = self._cond.acquire(blocking, timeout)
        if ok:
            _on_acquired(self._inner, self.name, held, t0)
        return ok

    def release(self) -> None:
        _on_released(self._inner, self.name, _held_stack())
        self._cond.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    # condition surface
    def wait(self, timeout: Optional[float] = None) -> bool:
        held = _held_stack()
        _on_released(self._inner, self.name, held)
        try:
            return self._cond.wait(timeout)
        finally:
            held.append(_Held(self._inner, self.name, time.monotonic()))

    def wait_for(self, predicate, timeout: Optional[float] = None):
        end = None if timeout is None else time.monotonic() + timeout
        result = predicate()
        while not result:
            left = None if end is None else end - time.monotonic()
            if left is not None and left <= 0:
                break
            self.wait(left)
            result = predicate()
        return result

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()

    def __repr__(self):
        return f"<CheckedCondition {self.name}>"


# -- reporting -------------------------------------------------------------

def report() -> dict:
    with _reg:
        return {
            "armed": _armed_flag,
            "edges": {f"{a}->{b}": dict(rec)
                      for (a, b), rec in sorted(_edges.items())},
            "cycles": [dict(c) for c in _cycles],
            "order_violations": [dict(v) for v in _order_violations],
            "blocking": [dict(b) for b in _blocking],
            "self_deadlocks": [dict(s) for s in _self_deadlocks],
        }


def dump_graph() -> str:
    """Human-readable lock-order graph + findings (the README's
    'read the lock-order graph dump' surface)."""
    rep = report()
    lines = ["lock-order graph (outer -> inner, observed count):"]
    for edge, rec in rep["edges"].items():
        lines.append(f"  {edge}  x{rec['count']}")
        for fr in rec["stack"][-4:]:
            lines.append(f"      {fr}")
    for title, key in (("CYCLES", "cycles"),
                       ("ORDER VIOLATIONS", "order_violations"),
                       ("BLOCKING WHILE LOCKED", "blocking"),
                       ("SELF DEADLOCKS", "self_deadlocks")):
        items = rep[key]
        lines.append(f"{title}: {len(items)}")
        for it in items:
            if key == "cycles":
                lines.append("  " + " -> ".join(it["path"]))
            elif key == "order_violations":
                lines.append(f"  {it['outer']} (rank {it['outer_rank']}) "
                             f"taken before {it['inner']} "
                             f"(rank {it['inner_rank']})")
            elif key == "blocking":
                lines.append(f"  {it['kind']} under {it['lock']} "
                             f"({it['detail']})")
            else:
                lines.append(f"  {it['lock']}")
            for fr in it.get("stack", [])[-6:]:
                lines.append(f"      {fr}")
    return "\n".join(lines)


def assert_clean() -> None:
    """Raise AssertionError (with the rendered dump) if any cycle, order
    violation, blocking-while-locked or self-deadlock was recorded."""
    rep = report()
    bad = (rep["cycles"] or rep["order_violations"] or rep["blocking"]
           or rep["self_deadlocks"])
    if bad:
        raise AssertionError("lockcheck found violations\n" + dump_graph())
