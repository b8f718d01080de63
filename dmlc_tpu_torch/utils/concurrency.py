"""Blocking queues with a kill signal — analog of include/dmlc/concurrency.h.

Own copy of the JAX package's ``utils/concurrency.py``:
:class:`ConcurrentBlockingQueue` (concurrency.h:69-141) in FIFO and
priority modes, the highest priority first and FIFO among equals;
``signal_for_kill`` wakes every blocked ``pop`` with None so that worker
threads can exit, and ``resume`` makes the queue usable again.
``Spinlock`` (concurrency.h:25) is ``threading.Lock``: under the
interpreter lock a user-space spin only loses, and the reference documents
its spinlock as a ``std::mutex`` drop-in.
"""

from __future__ import annotations

import heapq
import itertools
import threading
from collections import deque
from typing import Any, Generic, List, Optional, Tuple, TypeVar

T = TypeVar("T")

Spinlock = threading.Lock


class ConcurrentBlockingQueue(Generic[T]):
    """A thread-safe blocking queue, FIFO or priority ordered.

    ``pop`` blocks until an item arrives or :meth:`signal_for_kill` is
    called; after a kill every blocked and later ``pop`` returns None until
    :meth:`resume`.
    """

    FIFO = "fifo"
    PRIORITY = "priority"

    def __init__(self, kind: str = FIFO):
        if kind not in (self.FIFO, self.PRIORITY):
            raise ValueError(f"unknown queue kind {kind!r}")
        self._kind = kind
        self._cv = threading.Condition()
        self._fifo: deque = deque()
        self._heap: List[Tuple[int, int, Any]] = []
        # the tie-breaker: equal priorities stay FIFO and items never compare
        self._seq = itertools.count()
        self._killed = False

    def push(self, value: T, priority: int = 0) -> None:
        with self._cv:
            if self._kind == self.FIFO:
                self._fifo.append(value)
            else:
                heapq.heappush(self._heap, (-priority, next(self._seq), value))
            self._cv.notify()

    def _take(self) -> T:
        return self._fifo.popleft() if self._kind == self.FIFO else heapq.heappop(self._heap)[2]

    def pop(self, timeout: Optional[float] = None) -> Optional[T]:
        """The next item, blocking; None after a kill signal (or a timeout)."""
        with self._cv:
            if not self._cv.wait_for(lambda: self._killed or self._nonempty(), timeout):
                return None
            return None if self._killed else self._take()

    def try_pop(self) -> Optional[T]:
        with self._cv:
            if self._killed or not self._nonempty():
                return None
            return self._take()

    def signal_for_kill(self) -> None:
        """Wake every blocked pop with None (SignalForKill, concurrency.h:120)."""
        with self._cv:
            self._killed = True
            self._cv.notify_all()

    def resume(self) -> None:
        """Clear the kill flag, so that the queue can be used again."""
        with self._cv:
            self._killed = False
            self._cv.notify_all()

    def size(self) -> int:
        with self._cv:
            return len(self._fifo) + len(self._heap)

    def _nonempty(self) -> bool:
        return bool(self._fifo) or bool(self._heap)
