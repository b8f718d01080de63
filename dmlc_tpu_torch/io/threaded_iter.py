"""Producer/consumer prefetch pipeline — analog of include/dmlc/threadediter.h.

Own copy of the JAX package's ``ThreadedIter``, trimmed to the core
contract: one producer thread fills a bounded queue ahead of the consumer,
``before_first`` restarts the epoch, an exception in the producer is
re-raised on the consumer side, and ``destroy`` joins the thread.

:class:`OrderedWorkerPool` is the JAX package's pool of the same name,
trimmed to what the block cache's plan-ordered reads use: one serial
source of items, a work function run on a fixed number of threads, at
most ``max_ahead`` items pulled ahead of delivery, delivery in source
order. Its live ``resize`` (autotuning), source restarts and stall
diagnostics are not ported.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable, Deque, Dict, Generic, Optional, Tuple, TypeVar

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


class OrderedWorkerPool(Generic[T]):
    """Serial pull, parallel work, delivery in pull order.

    ``source_factory()`` gives the iterator of items, pulled one at a time
    under a lock, each taking the next sequence number; ``work_fn(item)``
    runs on ``num_workers`` threads at once; :meth:`next` hands the results
    out strictly in sequence order, None at the end. At most ``max_ahead``
    items are pulled and not yet delivered. A ``work_fn`` exception is
    raised by :meth:`next` at its item's position (earlier items deliver
    first), and the pool delivers nothing after it. :meth:`destroy` joins
    the workers."""

    def __init__(self, source_factory: Callable[[], Any], work_fn: Callable[[Any], T],
                 num_workers: int = 2, max_ahead: int = 4):
        self._source = source_factory()
        self._work = work_fn
        self._ahead = max(1, int(max_ahead))
        self._lock = threading.Condition()
        self._pull_lock = threading.Lock()
        self._results: Dict[int, Tuple[str, Any]] = {}
        self._seq = 0    # the next sequence number a pull takes
        self._want = 0   # the next sequence number the consumer gets
        self._produce_end = False
        self._poisoned = False
        self._src_exc: Optional[BaseException] = None
        self._destroyed = False
        self.num_workers = max(1, int(num_workers))
        self._threads = [threading.Thread(target=self._worker_loop, daemon=True)
                         for _ in range(self.num_workers)]
        for t in self._threads:
            t.start()

    def _worker_loop(self) -> None:
        while True:
            with self._lock:
                self._lock.wait_for(lambda: self._destroyed or self._produce_end
                                    or (self._seq - self._want) < self._ahead)
                if self._destroyed or self._produce_end:
                    return
            with self._pull_lock:
                # another worker may have ended the stream while this one waited
                if self._destroyed or self._produce_end:
                    return
                try:
                    item = next(self._source)
                except StopIteration:
                    with self._lock:
                        self._produce_end = True
                        self._lock.notify_all()
                    return
                except BaseException as exc:  # noqa: BLE001 - rethrown on consumer
                    with self._lock:
                        self._src_exc = exc
                        self._produce_end = True
                        self._lock.notify_all()
                    return
                with self._lock:
                    seq = self._seq
                    self._seq += 1
            try:  # the parallel stage, outside every lock
                out = ("ok", self._work(item))
            except BaseException as exc:  # noqa: BLE001 - rethrown in order
                out = ("exc", exc)
            with self._lock:
                self._results[seq] = out
                self._lock.notify_all()

    def next(self) -> Optional[T]:
        """The next result in source order; None at the end of the stream
        (and after a work error was raised)."""
        if self._destroyed:
            raise DMLCError("OrderedWorkerPool: already destroyed")
        if self._poisoned:
            return None
        with self._lock:
            self._lock.wait_for(lambda: self._want in self._results
                                or (self._produce_end and self._want >= self._seq))
            if self._want in self._results:
                kind, value = self._results.pop(self._want)
                self._want += 1
                self._lock.notify_all()  # the window opened: a worker may pull
                if kind == "exc":
                    self._produce_end = True
                    self._poisoned = True
                    raise value
                return value
            if self._src_exc is not None:
                exc, self._src_exc = self._src_exc, None
                raise exc
            return None

    def destroy(self) -> None:
        """Stop and join the workers (a worker inside ``work_fn`` finishes
        its item first)."""
        if self._destroyed:
            return
        with self._lock:
            self._destroyed = True
            self._lock.notify_all()
        for t in self._threads:
            t.join()
