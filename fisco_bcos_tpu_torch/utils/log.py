"""Structured key-value logging + METRIC channel.

Counterpart of the reference's Boost.Log setup with LOG_BADGE/LOG_KV macros
and the machine-readable METRIC channel (FISCO-BCOS bcos-utilities/
bcos-utilities/BoostLog.h, TxPool.cpp:206 metric lines). Python logging with
a key=value formatter; `metric()` emits one flat line per event for offline
scraping (tools/log_extract.sh analogue).
"""

from __future__ import annotations

import logging
import sys
import time

LOG = logging.getLogger("bcos-tpu")
_METRIC = logging.getLogger("bcos-tpu.metric")


def kv(**kw) -> str:
    return ",".join(f"{k}={v}" for k, v in kw.items())


def badge(*names: str, **kw) -> str:
    head = "".join(f"[{n}]" for n in names)
    return head + (": " + kv(**kw) if kw else "")


def metric(event: str, **kw) -> None:
    """METRIC channel: one machine-readable line per event, mirrored into
    the in-process registry (counters + latency histograms) served by the
    Prometheus text export (utils.metrics)."""
    _METRIC.info("METRIC|%s|%d|%s", event, time.time_ns() // 1_000_000, kv(**kw))
    from . import metrics as _m  # local import: metrics never imports log

    name = event.replace(".", "_")
    _m.REGISTRY.inc(f"bcos_{name}_total")
    if "ms" in kw:
        try:
            _m.REGISTRY.observe(f"bcos_{name}_seconds", float(kw["ms"]) / 1e3)
        except (TypeError, ValueError):
            pass
    for gauge_key in ("n", "n_tx", "number"):
        if gauge_key in kw:
            try:
                _m.REGISTRY.set_gauge(f"bcos_{name}_{gauge_key}",
                                      float(kw[gauge_key]))
            except (TypeError, ValueError):
                pass


def _install_handler(h: logging.Handler, level: int) -> logging.Handler:
    h.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname).1s %(name)s %(message)s"))
    root = logging.getLogger("bcos-tpu")
    root.handlers[:] = [h]
    root.setLevel(level)
    root.propagate = False
    return h


def init_log(level: int = logging.INFO, stream=None) -> None:
    _install_handler(logging.StreamHandler(stream or sys.stderr), level)


class ReopenableFileHandler(logging.FileHandler):
    """File handler whose stream can be re-opened in place — the SIGHUP
    logrotate contract of the reference's Boost.Log file sink (the daemon
    installs `reopen` as its SIGHUP action, so `mv log; kill -HUP` rotates
    without dropping or interleaving lines)."""

    def reopen(self) -> None:
        self.acquire()
        try:
            if self.stream:
                self.stream.close()
                self.stream = None  # emit() lazily reopens at self.baseFilename
        finally:
            self.release()


def init_file_log(path: str, level: int = logging.INFO
                  ) -> ReopenableFileHandler:
    return _install_handler(ReopenableFileHandler(path), level)
