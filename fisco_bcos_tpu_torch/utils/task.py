"""Task — a lightweight continuation/future primitive for async surfaces.

Reference counterpart: FISCO-BCOS libtask/bcos-task/Task.h:19-50 — the
C++20 coroutine `Task<T>` the reference threads through txpool submission
and the RPC layer (`co_await txpool->submitTransaction(...)`,
JsonRpcImpl_2_0.cpp:455). Python's asyncio is the wrong substrate for this
framework's thread-per-worker runtime, so the analogue is a thread-safe
promise: producers resolve once, consumers either block (`result()`),
chain continuations (`then(...)`, run on the resolver's thread), or poll
(`done()`). `Task.gather` mirrors awaiting a batch.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Generic, Optional, Sequence, TypeVar

T = TypeVar("T")


class TaskTimeout(TimeoutError):
    pass


class Task(Generic[T]):
    __slots__ = ("_event", "_lock", "_value", "_error", "_callbacks")

    def __init__(self):
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._value: Optional[T] = None
        self._error: Optional[BaseException] = None
        self._callbacks: list[Callable[["Task[T]"], Any]] = []

    # -- producer ----------------------------------------------------------
    def resolve(self, value: T) -> None:
        self._settle(value, None)

    def reject(self, error: BaseException) -> None:
        self._settle(None, error)

    def _settle(self, value, error) -> None:
        with self._lock:
            if self._event.is_set():
                return  # first settlement wins
            self._value = value
            self._error = error
            callbacks = list(self._callbacks)
            self._callbacks.clear()
            self._event.set()
        for cb in callbacks:
            try:
                cb(self)
            except Exception:
                pass

    # -- consumer ----------------------------------------------------------
    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> T:
        if not self._event.wait(timeout):
            raise TaskTimeout("task not settled in time")
        if self._error is not None:
            raise self._error
        return self._value  # type: ignore[return-value]

    def exception(self, timeout: Optional[float] = None
                  ) -> Optional[BaseException]:
        if not self._event.wait(timeout):
            raise TaskTimeout("task not settled in time")
        return self._error

    def then(self, fn: Callable[["Task[T]"], Any]) -> "Task[T]":
        """Run fn(task) once settled (immediately if already settled; on
        the resolver's thread otherwise). Returns self for chaining."""
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return self
        try:
            fn(self)
        except Exception:
            pass
        return self

    # -- combinators -------------------------------------------------------
    @staticmethod
    def resolved(value: T) -> "Task[T]":
        t: Task[T] = Task()
        t.resolve(value)
        return t

    @staticmethod
    def gather(tasks: Sequence["Task"], timeout: Optional[float] = None
               ) -> list:
        """Block for every task; -> list of results (raises the first
        error encountered, like awaiting a batch)."""
        return [t.result(timeout) for t in tasks]
