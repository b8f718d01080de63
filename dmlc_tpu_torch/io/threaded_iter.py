"""Producer/consumer prefetch pipeline — analog of include/dmlc/threadediter.h.

Own copy of the JAX package's ``ThreadedIter``, trimmed to the core
contract: one producer thread fills a bounded queue ahead of the consumer,
``before_first`` restarts the epoch, an exception in the producer is
re-raised on the consumer side, and ``destroy`` joins the thread.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable, Deque, Generic, Optional, Tuple, TypeVar

from dmlc_tpu_torch.utils.check import DMLCError

T = TypeVar("T")

# producer signals (threadediter.h:243-247)
_SIG_PRODUCE = 0
_SIG_BEFORE_FIRST = 1
_SIG_DESTROY = 2


class ThreadedIter(Generic[T]):
    """Bounded-queue prefetch iterator with epoch reset.

    ``produce_fn() -> (ok, value)``; ``ok=False`` ends the stream.
    """

    def __init__(
        self,
        produce_fn: Callable[[], Tuple[bool, Optional[T]]],
        before_first_fn: Optional[Callable[[], None]] = None,
        max_capacity: int = 8,
    ):
        self._produce = produce_fn
        self._before_first = before_first_fn
        self._capacity = max(1, int(max_capacity))
        self._lock = threading.Condition()
        self._queue: Deque[T] = deque()
        self._produce_end = False
        self._signal = _SIG_PRODUCE
        self._signal_processed = False
        self._exc: Optional[BaseException] = None
        self._destroyed = False
        self._thread = threading.Thread(target=self._producer_loop, daemon=True)
        self._thread.start()

    def _producer_loop(self) -> None:
        while True:
            with self._lock:
                self._lock.wait_for(
                    lambda: self._signal != _SIG_PRODUCE
                    or (not self._produce_end and len(self._queue) < self._capacity))
                if self._signal == _SIG_DESTROY:
                    self._signal_processed = True
                    self._lock.notify_all()
                    return
                if self._signal == _SIG_BEFORE_FIRST:
                    self._queue.clear()
                    try:
                        if self._before_first is not None:
                            self._before_first()
                        self._produce_end = False
                    except BaseException as exc:  # noqa: BLE001 - rethrown on consumer
                        self._exc = exc
                        self._produce_end = True
                    self._signal = _SIG_PRODUCE
                    self._signal_processed = True
                    self._lock.notify_all()
                    continue
            # run the producer outside the lock (threadediter.h:365 next())
            try:
                ok, value = self._produce()
            except BaseException as exc:  # noqa: BLE001 - captured for consumer
                with self._lock:
                    self._exc = exc
                    self._produce_end = True
                    self._lock.notify_all()
                continue
            with self._lock:
                if ok:
                    self._queue.append(value)  # type: ignore[arg-type]
                else:
                    self._produce_end = True
                self._lock.notify_all()

    def next(self) -> Optional[T]:
        """Pop the next item; None at end of stream. Rethrows producer errors."""
        if self._destroyed:
            raise DMLCError("ThreadedIter: already destroyed")
        with self._lock:
            self._lock.wait_for(lambda: self._queue or self._produce_end)
            if self._queue:
                item = self._queue.popleft()
                self._lock.notify_all()
                return item
            self._check_exc_locked()
            return None

    def before_first(self) -> None:
        """Reset to the epoch start; blocks until the producer acknowledges."""
        with self._lock:
            self._check_exc_locked()
            self._signal = _SIG_BEFORE_FIRST
            self._signal_processed = False
            self._lock.notify_all()
            self._lock.wait_for(lambda: self._signal_processed)
            self._signal_processed = False
            self._check_exc_locked()

    def destroy(self) -> None:
        """Stop and join the producer thread. The producer must not be
        blocked inside ``produce_fn`` on something only the consumer can
        release (callers unblock it first)."""
        if self._destroyed:
            return
        with self._lock:
            self._signal = _SIG_DESTROY
            self._signal_processed = False
            self._lock.notify_all()
        self._thread.join()
        self._destroyed = True

    def _check_exc_locked(self) -> None:
        if self._exc is not None:
            exc, self._exc = self._exc, None
            self._produce_end = True
            raise exc

    @staticmethod
    def from_factory(iterator_factory: Callable[[], Any],
                     max_capacity: int = 8) -> "ThreadedIter":
        """Prefetch over an iterator factory: each epoch calls
        ``iterator_factory()`` for a fresh iterator."""
        state = {"it": iterator_factory()}

        def produce():
            try:
                return True, next(state["it"])
            except StopIteration:
                return False, None

        def before_first():
            state["it"] = iterator_factory()

        return ThreadedIter(produce, before_first, max_capacity=max_capacity)
