"""Deterministic failpoint plane — named fault-injection sites everywhere.

Every subtle crash bug this repo has fixed was found by hand-placing a
`kill -9` or a raise at one edge (WAL append, manifest rename, 2PC commit,
saga legs...). This module makes those edges a PERMANENT, enumerable
surface: code declares a named site once and crosses it with

    from ..utils import failpoints as fp
    fp.fire("storage.wal.append_before_fsync")

which, when the site is DISARMED (the production state), costs exactly one
dict lookup and a branch — nothing is allocated, no lock is taken. Arming a
site attaches an action:

    raise            raise FailpointError (a RuntimeError) at the site
    enospc           raise OSError(ENOSPC) — the disk-full signal, typed so
                     callers' errno handling is exercised for real
    crash            os._exit(137) — the in-process kill -9 (no atexit, no
                     flush, no goodbye), for multi-process chaos runs
    sleep(ms)        delay the crossing (stall/latency injection)
    return_err       fire() returns True; the call site turns that into its
                     own error-return path (dropped frame, refused send)
    one_in(n)        deterministic modulo trigger: every n-th crossing of
                     the site raises FailpointError (not random — a seed
                     cannot make a matrix run unreproducible)

Any action takes an optional `*N` budget suffix (`raise*1`, `enospc*2`):
the site auto-disarms after firing N times — the standard shape for
"inject one fault, then watch the node heal" tests.

Arming surfaces:
  * test API: `arm(name, spec)`, `disarm(name)`, `disarm_all()`, and the
    `armed(name, spec)` context manager;
  * environment: `BCOS_FAILPOINTS="site=action;site2=action"` read at
    import (how chaos harness subprocess nodes get armed at boot);
  * config: the `[failpoints] spec = ...` ini key (same syntax; NodeConfig
    `failpoints` field, armed by Node.__init__);
  * ops endpoint: GET `/failpoints?arm=site=action` / `?disarm=site|all`
    on the RPC edge — TEST BUILDS ONLY, gated on the
    `BCOS_FAILPOINTS_OPS=1` environment variable; the read-only listing
    (GET `/failpoints`) is always served.

Sites self-register via `register(...)` at module import so the whole
surface is enumerable (`list_sites()`) without crossing any of them — the
failpoint matrix test sweeps that list and fails when a new edge forgets
to register.
"""

from __future__ import annotations

import errno as _errno
import os
import threading
import time
from typing import Iterator, Optional

__all__ = [
    "FailpointError", "arm", "arm_spec", "armed", "disarm", "disarm_all",
    "fire", "hits", "list_armed", "list_sites", "ops_arming_enabled",
    "register",
]


class FailpointError(RuntimeError):
    """Raised at an armed site (actions `raise` and `one_in`). Carries the
    site name so tests can assert WHICH edge fired."""

    def __init__(self, site: str):
        super().__init__(f"failpoint {site}")
        self.site = site


class _Action:
    __slots__ = ("kind", "arg", "budget", "spec", "count")

    def __init__(self, kind: str, arg: float, budget: Optional[int],
                 spec: str):
        self.kind = kind
        self.arg = arg
        self.budget = budget  # remaining fires; None = unlimited
        self.spec = spec      # original text, for listings
        self.count = 0        # crossings while armed (one_in modulo base)


_lock = threading.Lock()
_sites: dict[str, int] = {}    # registered site -> fired count
_armed: dict[str, _Action] = {}  # the ONE dict the hot path consults


def register(*names: str) -> None:
    """Declare sites (idempotent). Called at module import by every file
    that crosses them, so `list_sites()` is complete without any crossing."""
    with _lock:
        for n in names:
            _sites.setdefault(n, 0)


def list_sites() -> list[str]:
    with _lock:
        return sorted(_sites)


def hits(name: str) -> int:
    """How many times the site FIRED its action (not mere crossings)."""
    with _lock:
        return _sites.get(name, 0)


def list_armed() -> dict[str, str]:
    with _lock:
        return {n: a.spec for n, a in _armed.items()}


def _parse(spec: str) -> _Action:
    spec = spec.strip()
    body, star, budget_s = spec.partition("*")
    budget = None
    if star:
        budget = int(budget_s)
        if budget <= 0:
            raise ValueError(f"failpoint budget must be > 0: {spec!r}")
    kind, paren, arg_s = body.partition("(")
    kind = kind.strip()
    arg = 0.0
    if paren:
        if not arg_s.endswith(")"):
            raise ValueError(f"bad failpoint action {spec!r}")
        arg = float(arg_s[:-1])
    if kind in ("sleep", "one_in") and not paren:
        raise ValueError(f"{kind} needs an argument: {spec!r}")
    if kind == "one_in" and arg < 1:
        raise ValueError(f"one_in needs n >= 1: {spec!r}")
    if kind not in ("raise", "enospc", "crash", "sleep", "return_err",
                    "one_in"):
        raise ValueError(f"unknown failpoint action {kind!r}")
    return _Action(kind, arg, budget, spec)


def arm(name: str, spec: str) -> None:
    """Arm `name` with an action spec (see module doc). Arming an
    unregistered name is allowed (the site may live in a module not yet
    imported) but it is registered on the spot so listings show it."""
    action = _parse(spec)
    with _lock:
        _sites.setdefault(name, 0)
        _armed[name] = action


def arm_spec(spec: str) -> int:
    """Arm from a `site=action;site2=action` string (env/ini syntax);
    returns how many sites were armed. Empty/blank specs are a no-op."""
    n = 0
    for part in (spec or "").replace(",", ";").split(";"):
        part = part.strip()
        if not part:
            continue
        name, eq, action = part.partition("=")
        if not eq:
            raise ValueError(f"bad failpoint spec entry {part!r} "
                             "(expected site=action)")
        arm(name.strip(), action)
        n += 1
    return n


def disarm(name: str) -> bool:
    with _lock:
        return _armed.pop(name, None) is not None


def disarm_all() -> int:
    with _lock:
        n = len(_armed)
        _armed.clear()
        return n


class armed:
    """Context manager: `with fp.armed("site", "raise*1"): ...` — always
    disarms on exit, even when the armed action fired mid-block."""

    def __init__(self, name: str, spec: str):
        self.name = name
        self.spec = spec

    def __enter__(self) -> "armed":
        arm(self.name, self.spec)
        return self

    def __exit__(self, *exc) -> None:
        disarm(self.name)


def fire(name: str) -> bool:
    """Cross the site. Disarmed (the overwhelmingly common case): one dict
    lookup, returns False. Armed: perform the action — may raise, crash
    the process, sleep, or return True (`return_err`, meaning the caller
    takes its own error path)."""
    action = _armed.get(name)
    if action is None:
        return False
    return _fire_armed(name, action)


def _fire_armed(name: str, action: _Action) -> bool:
    with _lock:
        # the action may have been swapped/disarmed since the racy read
        if _armed.get(name) is not action:
            return False
        action.count += 1
        if action.kind == "one_in" and action.count % int(action.arg):
            return False  # not this crossing
        _sites[name] = _sites.get(name, 0) + 1
        if action.budget is not None:
            action.budget -= 1
            if action.budget <= 0:
                _armed.pop(name, None)
        kind, arg = action.kind, action.arg
    if kind == "sleep":
        time.sleep(arg / 1000.0)
        return False
    if kind == "return_err":
        return True
    if kind == "crash":
        # flush nothing, run nothing: this IS kill -9 from the inside
        os._exit(137)
    if kind == "enospc":
        raise OSError(_errno.ENOSPC, f"failpoint {name}: injected ENOSPC")
    raise FailpointError(name)  # `raise` and a firing `one_in`


def fire_lossy(name: str) -> bool:
    """Cross a TRANSPORT seam: any raising action (raise/one_in/enospc)
    counts as loss — True means "this frame/send vanished". `crash` and
    `sleep` keep their semantics. The one shared definition of
    "a raising action at a transport seam IS loss" for every gateway."""
    try:
        return fire(name)
    except FailpointError:
        return True
    except OSError:
        return True


def ops_arming_enabled() -> bool:
    """Whether the ops endpoint may MUTATE failpoints (test builds only:
    the chaos harness / CI smoke export BCOS_FAILPOINTS_OPS=1; production
    deployments never do, and the listing stays read-only)."""
    return os.environ.get("BCOS_FAILPOINTS_OPS", "") == "1"


def _iter_armed() -> Iterator[tuple[str, str]]:  # pragma: no cover - debug
    with _lock:
        yield from [(n, a.spec) for n, a in _armed.items()]


# environment arming: how subprocess chaos nodes get their faults at boot
if os.environ.get("BCOS_FAILPOINTS"):
    arm_spec(os.environ["BCOS_FAILPOINTS"])
