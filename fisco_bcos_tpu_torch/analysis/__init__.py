"""Lock discipline (lockcheck, lockorder) and the profiler's stage markers.

`lockcheck` gives the txpool, the lanes and memory storage their locks:
plain `threading` primitives unless `BCOS_LOCKCHECK=1` arms the
instrumented drop-ins, whose order graph checks against `lockorder`.
`profiler` is the continuous sampling profiler (folded stacks by thread
role and pipeline stage, per-thread CPU attribution, slow-span bursts, the
flamegraph behind `GET /profile`) with its stage markers; its call sites
import it lazily, so `import analysis` has no side effects.
"""

from . import lockcheck, lockorder  # noqa: F401

__all__ = ["lockcheck", "lockorder"]
