"""Per-stage latency histogram of the write path.

The ingest lane and the txpool feed `bcos_tx_stage_seconds{stage=...}`
with their "ingest" and "crypto" stages through `observe_stage`: the
per-stage decomposition of where a transaction's wall-clock goes. The
block pipeline's stage clock (`BlockTrace`) and the DMC round checksums
(`DmcStepRecorder`) belong to the scheduler and executor and come with
them.
"""

from __future__ import annotations

STAGE_HISTOGRAM = "bcos_tx_stage_seconds"
# stage durations live between "instant" and "a slow block": the default
# time buckets bottom out too low and top out too high
_STAGE_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                  0.25, 0.5, 1.0, 2.5, 5.0)


def observe_stage(stage: str, seconds: float, registry=None) -> None:
    """One observation into the per-stage latency histogram."""
    if registry is None:
        from . import metrics as _m
        registry = _m.REGISTRY
    registry.observe(STAGE_HISTOGRAM, seconds, {"stage": stage},
                     buckets=_STAGE_BUCKETS)
