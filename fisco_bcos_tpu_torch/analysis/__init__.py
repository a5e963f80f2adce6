"""Lock discipline (lockcheck, lockorder) and the profiler's stage markers.

`lockcheck` gives the txpool, the lanes and memory storage their locks:
plain `threading` primitives unless `BCOS_LOCKCHECK=1` arms the
instrumented drop-ins, whose order graph checks against `lockorder`.
`profiler` holds only the stage markers and thread roles here.
"""

from . import lockcheck, lockorder  # noqa: F401

__all__ = ["lockcheck", "lockorder"]
