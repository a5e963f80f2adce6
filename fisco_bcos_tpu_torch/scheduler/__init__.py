"""Scheduler: per-block execution orchestration + commit 2PC (bcos-scheduler)."""

from .scheduler import ExecutionResult, Scheduler

__all__ = ["Scheduler", "ExecutionResult"]
