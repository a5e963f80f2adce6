"""Per-stage latency histogram of the write path.

The ingest lane and the txpool feed `bcos_tx_stage_seconds{stage=...}`
with their "ingest" and "crypto" stages through `observe_stage`: the
per-stage decomposition of where a transaction's wall-clock goes.
`BlockTrace` is the block pipeline's stage clock (the reference's
stage-stamped block lines, bcos-scheduler/src/BlockExecutive.cpp:761-801):
the scheduler stamps fill, execute, roots, consensus_wait, commit and
notify on the trace of each height (`block_trace`, `drop_block_trace`).
Each stamp emits a METRIC line, feeds the histogram for the pipeline's
stages, and is recorded as a span when the block is bound to a sampled
otrace context (else offered to the tracer's slow capture).

`DmcStepRecorder` (bcos-scheduler/src/DmcStepRecorder.cpp) checksums
every DMC message round, so two replicas that diverge can be diffed down
to the first round that differs: the tool a node whose kernels run on a
card needs when a device kernel and the host oracle disagree.
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Optional

from .log import metric
from . import otrace

STAGE_HISTOGRAM = "bcos_tx_stage_seconds"
_HIST_STAGES = frozenset({"consensus_pre", "fill", "execute", "roots",
                          "consensus_wait", "commit", "notify"})
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


class BlockTrace:
    """Per-block stage stamps: trace = BlockTrace(number); trace.stage(
    "seal"); ...; trace.stage("execute"); trace.finish()."""

    def __init__(self, number: int, pipeline: str = "block",
                 owner: str = ""):
        self.number = number
        self.pipeline = pipeline
        self.owner = owner
        self._t0 = time.monotonic()
        self._last = self._t0
        self._stages: list[tuple[str, float]] = []
        self._ctx = None  # otrace.SpanContext bound via bind()

    def bind(self, ctx) -> None:
        """Adopt a transaction's span context: stages from here on are
        recorded as spans of that trace (sealer binds on the leader, the
        PBFT engine binds on replicas from the pre-prepare's envelope
        context)."""
        if ctx is not None and ctx.sampled:
            self._ctx = ctx

    @property
    def ctx(self):
        return self._ctx

    def stage(self, name: str) -> None:
        now = time.monotonic()
        dt = now - self._last
        self._stages.append((name, dt))
        metric(f"trace.{self.pipeline}", number=self.number, stage=name,
               ms=round(dt * 1000, 2),
               total_ms=round((now - self._t0) * 1000, 2))
        if name in _HIST_STAGES:
            observe_stage(name, dt)
        if self._ctx is not None:
            otrace.TRACER.record(
                f"stage.{name}", self._ctx, self._last, now,
                attrs={"number": self.number, "node": self.owner})
        else:
            otrace.TRACER.observe_slow(
                f"stage.{name}", dt,
                attrs={"number": self.number, "node": self.owner})
        self._last = now

    def finish(self) -> dict[str, float]:
        self.stage("finish")
        return {name: dt for name, dt in self._stages}


_block_traces: dict[tuple[str, int], BlockTrace] = {}
_bt_lock = threading.Lock()


def block_trace(number: int, owner: str = "") -> BlockTrace:
    """Shared per-height trace so sealer/consensus/scheduler stamp the same
    object without threading it through every signature. Keyed per
    (owner, number): one node per process stamps `owner=""`-equivalent;
    in-process clusters pass their node label so stamps don't collide."""
    key = (owner, number)
    with _bt_lock:
        tr = _block_traces.get(key)
        if tr is None:
            tr = _block_traces[key] = BlockTrace(number, owner=owner)
            for old in [k for k in _block_traces
                        if k[0] == owner and k[1] < number - 64]:
                del _block_traces[old]
        return tr


def drop_block_trace(number: int, owner: str = "") -> Optional[BlockTrace]:
    with _bt_lock:
        return _block_traces.pop((owner, number), None)


class DmcStepRecorder:
    """Order-independent checksum of each DMC round's message stream.

    Replicas executing the same block must record identical checksums per
    round; the first differing round localises a divergence (scheduler bug,
    nondeterministic executor, device/host kernel mismatch). XOR-combined
    SHA-256 per message makes the checksum independent of intra-round
    arrival order, like the reference's add-based checksum.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._rounds: list[bytes] = []
        self._current = bytes(32)
        self._count = 0

    @staticmethod
    def _digest(ctx: int, seq: int, to: bytes, data: bytes) -> bytes:
        return hashlib.sha256(
            ctx.to_bytes(8, "big") + seq.to_bytes(8, "big")
            + len(to).to_bytes(2, "big") + to + data).digest()

    def record_message(self, ctx: int, seq: int, to: bytes,
                       data: bytes) -> None:
        d = self._digest(ctx, seq, to, data)
        with self._lock:
            self._current = bytes(a ^ b for a, b in zip(self._current, d))
            self._count += 1

    def next_round(self) -> bytes:
        """Close the current round; -> its checksum."""
        with self._lock:
            cksum = self._current
            self._rounds.append(cksum)
            self._current = bytes(32)
            n = self._count
            self._count = 0
        metric("dmc.round_checksum", round=len(self._rounds),
               messages=n, checksum=cksum[:8].hex())
        return cksum

    def checksums(self) -> list[bytes]:
        with self._lock:
            return list(self._rounds)

    def summary(self) -> bytes:
        """One digest over all rounds (order-sensitive across rounds)."""
        h = hashlib.sha256()
        for c in self.checksums():
            h.update(c)
        return h.digest()
