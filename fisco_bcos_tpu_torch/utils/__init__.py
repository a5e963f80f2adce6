"""Node utilities: logging, metrics, tasks, failpoints and tracing."""

from .log import LOG, init_log, metric

__all__ = ["LOG", "init_log", "metric"]
