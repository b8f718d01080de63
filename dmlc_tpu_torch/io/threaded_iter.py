"""Producer/consumer prefetch pipeline — analog of include/dmlc/threadediter.h.

Own copy of the JAX package's ``io/threaded_iter.py``.

:class:`ThreadedIter`: one producer thread fills a bounded queue ahead of
the consumer, ``produce_fn(cell) -> (ok, value)`` with ``cell`` a recycled
buffer (:meth:`~ThreadedIter.recycle`) or None, ``ok=False`` ending the
stream; ``before_first`` restarts the epoch, an exception in the producer
is re-raised on the consumer side, ``destroy`` joins the thread, and
:meth:`~ThreadedIter.set_capacity` resizes the queue live.

:class:`OrderedWorkerPool`: one serial source of items, a work function run
on ``num_workers`` threads, at most ``max_ahead`` items pulled ahead of
delivery, delivery in source order. A worker checks the window again under
the pull lock, so no worker that waited its turn pulls past it (a
``DeviceIter`` staging ring with a slot for each of ``max_ahead`` batches
then never starves the oldest). :meth:`~OrderedWorkerPool.resize` and
:meth:`~OrderedWorkerPool.set_max_ahead` change the width and the window
live: growth starts threads that join the same pull and delivery, a
shrink posts exit credits that surplus workers take at their next loop top
(a later grow cancels credits first), a smaller window only gates new
pulls. Sequence numbers, so delivery order and content, do not change.

Both take an opt-in ``restart_policy`` (:mod:`dmlc_tpu_torch.io.resilience`):
a retryable error of the source spends one unit of the budget
(``max_attempts - 1``; :func:`~dmlc_tpu_torch.io.resilience.restart_verdict`),
sleeps the backoff and repositions the source — ``ThreadedIter`` through
``restart_fn(items produced this epoch)`` (``from_factory``: a fresh
iterator fast-forwarded past them), the pool by a fresh ``source_factory()``
fast-forwarded past the items already pulled — and the stream goes on
unchanged. A fatal error, or one past the budget, is raised to the consumer
as before. Restarts count ``producer_restarts`` / ``producer_giveups`` (the
pool: ``<counter_label>_restarts`` / ``_giveups``) as resilience events.

``DMLC_PIPELINE_STALL_TIMEOUT=N`` (seconds, default 0: off) makes a
consumer that waited N seconds on a live producer raise, after publishing
the stall diagnostic as a ``pipeline_stall`` info metric
(:data:`~dmlc_tpu_torch.utils.telemetry.STALL_METRIC`) keyed by component,
pool label and pipeline.

Both run their threads under their creator's telemetry scope
(:mod:`dmlc_tpu_torch.utils.telemetry`), adopted from the first scoped
consumer when they were built outside any (``adopt_scope`` sets it from
outside), and both count the consumer's wait in ``next`` as
``stall_seconds``.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from typing import Any, Callable, Deque, Dict, Generic, Optional, Tuple, TypeVar

from dmlc_tpu_torch.io import resilience as _resilience
from dmlc_tpu_torch.utils import telemetry as _telemetry
from dmlc_tpu_torch.utils.check import DMLCError
from dmlc_tpu_torch.utils.timer import get_time

T = TypeVar("T")

# producer signals (threadediter.h:243-247)
_SIG_PRODUCE = 0
_SIG_BEFORE_FIRST = 1
_SIG_DESTROY = 2


def _fast_forward(it, n: int):
    """Skip the first ``n`` items of a rebuilt source (both restart paths
    replay this way); a source shorter than what was delivered raises."""
    for _ in range(n):
        try:
            next(it)
        except StopIteration:
            raise DMLCError(
                "producer restart: source yielded fewer items than already "
                "delivered — non-deterministic factory?") from None
    return it


def _stall_timeout() -> float:
    """``DMLC_PIPELINE_STALL_TIMEOUT`` in seconds; 0 (the default) waits
    forever."""
    return float(os.environ.get("DMLC_PIPELINE_STALL_TIMEOUT", "0") or 0)


def _restart_budget_dict(policy, used: int) -> dict:
    """The restart budget as data, one shape for both primitives."""
    return {"enabled": policy is not None, "used": used,
            "limit": max(0, policy.max_attempts - 1) if policy is not None else 0}


def _publish_stall_diagnostic(diag: dict) -> None:
    """The stall diagnostic as an info metric keyed by component, pool
    label and pipeline (a pipeline runs several pools)."""
    _telemetry.REGISTRY.info(
        _telemetry.STALL_METRIC, component=diag.get("component", ""),
        label=diag.get("label", ""),
        pipeline=_telemetry.current_scope() or "").set(diag)


class ThreadedIter(Generic[T]):
    """Bounded-queue prefetch iterator with recycling, epoch reset and an
    opt-in bounded producer restart (module docstring)."""

    def __init__(
        self,
        produce_fn: Callable[[Optional[T]], Tuple[bool, Optional[T]]],
        before_first_fn: Optional[Callable[[], None]] = None,
        max_capacity: int = 8,
        restart_fn: Optional[Callable[[int], None]] = None,
        restart_policy: Optional[_resilience.RetryPolicy] = None,
    ):
        self._produce = produce_fn
        self._before_first = before_first_fn
        self._capacity = max(1, int(max_capacity))
        self._lock = threading.Condition()
        self._queue: Deque[T] = deque()
        self._free: Deque[T] = deque()
        self._produce_end = False
        self._signal = _SIG_PRODUCE
        self._signal_processed = False
        self._exc: Optional[BaseException] = None
        self._destroyed = False
        self.stall_seconds = 0.0  # the consumer's wait in next()
        # the restart: without restart_fn the produce callback is simply
        # called again (right only for a producer whose state survives a
        # failed call)
        self._restart_fn = restart_fn
        self._restart_policy = (restart_policy if restart_policy is not None
                                else (_resilience.default_policy() if restart_fn else None))
        self._epoch_produced = 0   # items queued since the epoch start
        self._epoch_restarts = 0   # the budget spent this epoch
        self.restarts = 0
        self.restart_giveups = 0
        self.last_producer_error: Optional[str] = None
        # the producer runs under the creator's scope, adopted from the
        # first scoped consumer when there was none; the loop installs it
        # each item, so an adoption takes effect mid-run
        self._scope = _telemetry.current_scope()
        self._thread = threading.Thread(target=self._producer_loop, daemon=True)
        self._thread.start()

    def _budget_state(self) -> str:
        pol = self._restart_policy
        if pol is None:
            return "producer restart disabled"
        return (f"producer restarts {self._epoch_restarts}/"
                f"{max(0, pol.max_attempts - 1)} used this epoch")

    def _try_restart(self, exc: BaseException) -> bool:
        """A retryable producer error with budget left: back off,
        reposition the source and report True (go on producing)."""
        with self._lock:
            if self._signal != _SIG_PRODUCE:  # a reset or destroy is pending
                return False
            used, produced = self._epoch_restarts, self._epoch_produced
        verdict = _resilience.restart_verdict(self._restart_policy, used, exc)
        if verdict == "giveup":
            self.restart_giveups += 1
            _resilience.record_event("producer_giveups")
            return False
        if verdict != "restart":
            return False
        with self._lock:
            self._epoch_restarts += 1
            self.restarts += 1
        _resilience.record_event("producer_restarts")
        _resilience.restart_backoff(self._restart_policy, used, exc)
        if self._restart_fn is not None:
            self._restart_fn(produced)  # its failure propagates to the caller
        return True

    def adopt_scope(self, label: Optional[str]) -> None:
        """Take ``label`` as the scope if there is none yet."""
        if self._scope is None and label is not None:
            self._scope = label

    def _producer_loop(self) -> None:
        while True:
            _telemetry.set_scope(self._scope)
            cell: Optional[T] = None
            with self._lock:
                self._lock.wait_for(
                    lambda: self._signal != _SIG_PRODUCE
                    or (not self._produce_end
                        and (len(self._queue) < self._capacity or self._free)))
                if self._signal == _SIG_DESTROY:
                    self._signal_processed = True
                    self._lock.notify_all()
                    return
                if self._signal == _SIG_BEFORE_FIRST:
                    # the queued items go to the free list
                    while self._queue:
                        self._free.append(self._queue.popleft())
                    try:
                        if self._before_first is not None:
                            self._before_first()
                        self._produce_end = False
                        self._epoch_produced = 0
                        self._epoch_restarts = 0  # a fresh budget an epoch
                    except BaseException as exc:  # noqa: BLE001 - rethrown on consumer
                        self._exc = exc
                        self._produce_end = True
                    self._signal = _SIG_PRODUCE
                    self._signal_processed = True
                    self._lock.notify_all()
                    continue
                if self._free:
                    cell = self._free.popleft()
            # run the producer outside the lock (threadediter.h:365 next())
            try:
                ok, value = self._produce(cell)
            except BaseException as exc:  # noqa: BLE001 - captured for consumer
                self.last_producer_error = f"{type(exc).__name__}: {exc}"
                try:
                    restarted = self._try_restart(exc)
                except BaseException as exc2:  # noqa: BLE001 - the reposition died
                    restarted, exc = False, exc2
                    self.last_producer_error = f"{type(exc2).__name__}: {exc2}"
                with self._lock:
                    if restarted:
                        if cell is not None:
                            self._free.append(cell)
                        continue
                    self._exc = exc
                    self._produce_end = True
                    self._lock.notify_all()
                continue
            with self._lock:
                if ok:
                    self._queue.append(value)  # type: ignore[arg-type]
                    self._epoch_produced += 1
                else:
                    self._produce_end = True
                    if cell is not None:
                        self._free.append(cell)
                self._lock.notify_all()

    def next(self) -> Optional[T]:
        """Pop the next item; None at end of stream. Rethrows producer errors."""
        if self._destroyed:
            raise DMLCError("ThreadedIter: already destroyed")
        if self._scope is None:
            self._scope = _telemetry.current_scope()
        t0 = get_time()
        timeout = _stall_timeout()
        with self._lock:
            ready = lambda: self._queue or self._produce_end  # noqa: E731
            if timeout > 0:
                if not self._lock.wait_for(ready, timeout=timeout):
                    alive = self._thread.is_alive()
                    _publish_stall_diagnostic({
                        "component": "ThreadedIter", "timeout_seconds": timeout,
                        "producer_alive": alive, "queue_len": len(self._queue),
                        "free_cells": len(self._free),
                        "last_producer_error": self.last_producer_error,
                        "restart_budget": _restart_budget_dict(self._restart_policy,
                                                               self._epoch_restarts)})
                    raise DMLCError(
                        f"pipeline stalled: no item produced in {timeout:.0f}s "
                        f"(producer thread {'alive but blocked' if alive else 'dead'}, "
                        f"queue empty, free cells {len(self._free)}; "
                        f"last producer error: {self.last_producer_error or 'none'}; "
                        f"{self._budget_state()}). A hung device transfer or remote "
                        f"read is the usual cause; unset DMLC_PIPELINE_STALL_TIMEOUT "
                        f"to wait forever")
            else:
                self._lock.wait_for(ready)
            self.stall_seconds += get_time() - t0
            if self._queue:
                item = self._queue.popleft()
                self._lock.notify_all()
                return item
            self._check_exc_locked()
            return None

    def set_capacity(self, max_capacity: int) -> None:
        """Resize the queue live: a larger one lets the producer run further
        ahead at once; a smaller one only gates new production (the queued
        items still deliver)."""
        with self._lock:
            self._capacity = max(1, int(max_capacity))
            self._lock.notify_all()

    def recycle(self, item: T) -> None:
        """Hand a consumed cell back for reuse (threadediter.h:476-488)."""
        with self._lock:
            self._free.append(item)
            self._lock.notify_all()
            self._check_exc_locked()

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
    def from_factory(iterator_factory: Callable[[], Any], max_capacity: int = 8,
                     restart_policy: Optional[_resilience.RetryPolicy] = None
                     ) -> "ThreadedIter":
        """Prefetch over an iterator factory: each epoch calls
        ``iterator_factory()`` for a fresh iterator. With ``restart_policy``
        a retryable error of the iterator builds a fresh one fast-forwarded
        past the items produced (the factory must be deterministic)."""
        state = {"it": iterator_factory()}

        def produce(cell):
            try:
                return True, next(state["it"])
            except StopIteration:
                return False, None

        def before_first():
            state["it"] = iterator_factory()

        def restart(produced: int) -> None:
            state["it"] = _fast_forward(iterator_factory(), produced)

        return ThreadedIter(produce, before_first, max_capacity=max_capacity,
                            restart_fn=restart if restart_policy is not None else None,
                            restart_policy=restart_policy)


class OrderedWorkerPool(Generic[T]):
    """Serial pull, parallel work, delivery in pull order.

    ``source_factory()`` gives the iterator of items, pulled one at a time
    under a lock, each taking the next sequence number; ``work_fn(item)``
    runs on ``num_workers`` threads at once; :meth:`next` hands the results
    out strictly in sequence order, None at the end. At most ``max_ahead``
    items are pulled and not yet delivered. A ``work_fn`` exception is
    raised by :meth:`next` at its item's position (earlier items deliver
    first), and the pool delivers nothing after it; a source exception is
    raised after the items pulled before it. :meth:`destroy` joins the
    workers. ``counter_label`` names the pool's restart counters and its
    stall diagnostic (module docstring)."""

    def __init__(self, source_factory: Callable[[], Any], work_fn: Callable[[Any], T],
                 num_workers: int = 2, max_ahead: int = 4,
                 restart_policy: Optional[_resilience.RetryPolicy] = None,
                 counter_label: str = "producer"):
        self._source_factory = source_factory
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
        self.stall_seconds = 0.0  # the consumer's wait in next()
        self.counter_label = counter_label
        self._restart_policy = restart_policy
        self.restarts = 0
        self.restart_giveups = 0
        self.last_producer_error: Optional[str] = None
        self._scope = _telemetry.current_scope()  # as ThreadedIter's
        # the live width: num_workers is the target, _shrink the exit
        # credits surplus workers take at their next loop top
        self._shrink = 0
        self.num_workers = max(1, int(num_workers))
        self._threads = [threading.Thread(target=self._worker_loop, daemon=True)
                         for _ in range(self.num_workers)]
        for t in self._threads:
            t.start()

    def _budget_state(self) -> str:
        pol = self._restart_policy
        if pol is None:
            return "source restart disabled"
        return f"source restarts {self.restarts}/{max(0, pol.max_attempts - 1)} used"

    def _try_source_restart(self, exc: BaseException) -> bool:
        """Under the pull lock, after a pull raised: a retryable error with
        budget left backs off, rebuilds the source and skips the items
        already pulled, so every sequence number stays valid."""
        verdict = _resilience.restart_verdict(self._restart_policy, self.restarts, exc)
        if verdict == "giveup":
            self.restart_giveups += 1
            _resilience.record_event(f"{self.counter_label}_giveups")
            return False
        if verdict != "restart":
            return False
        used = self.restarts
        self.restarts += 1
        _resilience.record_event(f"{self.counter_label}_restarts")
        _resilience.restart_backoff(self._restart_policy, used, exc)
        with self._lock:
            pulled = self._seq
        self._source = _fast_forward(self._source_factory(), pulled)
        return True

    def _should_wake(self) -> bool:
        """The window has room, or the pool is ending or shrinking."""
        return (self._destroyed or self._produce_end or self._shrink > 0
                or (self._seq - self._want) < self._ahead)

    def _worker_loop(self) -> None:
        while True:
            _telemetry.set_scope(self._scope)
            with self._lock:
                self._lock.wait_for(self._should_wake)
                if self._destroyed or self._produce_end:
                    return
                if self._shrink > 0:
                    # a live shrink: take one exit credit and retire, before
                    # the pull, so a retiring worker holds no item
                    self._shrink -= 1
                    return
            with self._pull_lock:
                with self._lock:
                    # another worker may have ended the stream, or filled
                    # the window, while this one waited its turn
                    if self._destroyed or self._produce_end:
                        return
                    if (self._seq - self._want) >= self._ahead:
                        continue
                try:
                    item = next(self._source)
                except StopIteration:
                    with self._lock:
                        self._produce_end = True
                        self._lock.notify_all()
                    return
                except BaseException as exc:  # noqa: BLE001 - rethrown on consumer
                    self.last_producer_error = f"{type(exc).__name__}: {exc}"
                    try:
                        restarted = self._try_source_restart(exc)
                    except BaseException as exc2:  # noqa: BLE001 - the replay died
                        restarted, exc = False, exc2
                        self.last_producer_error = f"{type(exc2).__name__}: {exc2}"
                    if restarted:
                        continue  # releases the pull lock, waits again
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
        if self._scope is None:
            self._scope = _telemetry.current_scope()
        t0 = get_time()
        timeout = _stall_timeout()
        with self._lock:
            ready = lambda: (self._want in self._results  # noqa: E731
                             or (self._produce_end and self._want >= self._seq))
            if timeout > 0:
                if not self._lock.wait_for(ready, timeout=timeout):
                    alive = sum(t.is_alive() for t in self._threads)
                    _publish_stall_diagnostic({
                        "component": "OrderedWorkerPool", "label": self.counter_label,
                        "timeout_seconds": timeout, "workers_alive": alive,
                        "workers": self.num_workers, "waiting_for": self._want,
                        "pulled": self._seq, "last_producer_error": self.last_producer_error,
                        "restart_budget": _restart_budget_dict(self._restart_policy,
                                                               self.restarts)})
                    raise DMLCError(
                        f"pipeline stalled: no item produced in {timeout:.0f}s "
                        f"({alive}/{len(self._threads)} workers alive, "
                        f"waiting for #{self._want} of {self._seq} pulled; "
                        f"last producer error: {self.last_producer_error or 'none'}; "
                        f"{self._budget_state()}). A hung device transfer or remote "
                        f"read is the usual cause; unset DMLC_PIPELINE_STALL_TIMEOUT "
                        f"to wait forever")
            else:
                self._lock.wait_for(ready)
            self.stall_seconds += get_time() - t0
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

    def resize(self, num_workers: int) -> int:
        """Change the width live (module docstring); returns the new
        target width."""
        n = max(1, int(num_workers))
        spawn = []
        with self._lock:
            if self._destroyed:
                return self.num_workers
            self._threads = [t for t in self._threads if t.is_alive()]
            delta = n - self.num_workers
            self.num_workers = n
            if delta > 0:
                # cancel pending exits first, then start threads
                cancel = min(self._shrink, delta)
                self._shrink -= cancel
                for _ in range(delta - cancel):
                    t = threading.Thread(target=self._worker_loop, daemon=True)
                    self._threads.append(t)
                    spawn.append(t)
            elif delta < 0:
                self._shrink -= delta
            self._lock.notify_all()
        for t in spawn:
            t.start()
        return n

    def set_max_ahead(self, max_ahead: int) -> None:
        """Change the window live: a larger one opens at once, a smaller one
        only gates new pulls (the items in flight still deliver)."""
        with self._lock:
            self._ahead = max(1, int(max_ahead))
            self._lock.notify_all()

    def adopt_scope(self, label: Optional[str]) -> None:
        """Take ``label`` as the scope if there is none yet."""
        if self._scope is None and label is not None:
            self._scope = label

    def destroy(self) -> None:
        """Stop and join the workers (a worker inside ``work_fn`` finishes
        its item first)."""
        if self._destroyed:
            return
        with self._lock:
            self._destroyed = True
            self._lock.notify_all()
            threads = list(self._threads)
        for t in threads:
            t.join()
