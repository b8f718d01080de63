"""Named, managed threads — analog of include/dmlc/thread_group.h.

Own copy of the JAX package's ``utils/thread_group.py``: a
:class:`ThreadGroup` owns named threads (create and launch,
thread_group.h:488-493) and asks one or all of them to stop
(request_shutdown_all, thread_group.h:443-451); two managed worker shapes
come with it, :func:`blocking_queue_thread` draining a
:class:`~dmlc_tpu_torch.utils.concurrency.ConcurrentBlockingQueue`
(BlockingQueueThread, thread_group.h:530) and :func:`timer_thread` calling
back on a fixed period (TimerThread, thread_group.h:645).

The threads stop cooperatively: the run callable receives a
:class:`ShutdownToken` and polls ``token.stopped`` (or sleeps with
``token.wait(dt)``); nothing kills a thread from outside. A thread
inherits its creator's telemetry pipeline scope.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional

from dmlc_tpu_torch.utils import telemetry as _telemetry
from dmlc_tpu_torch.utils.check import DMLCError
from dmlc_tpu_torch.utils.concurrency import ConcurrentBlockingQueue


class ShutdownToken:
    """The cooperative stop flag handed to every managed thread."""

    def __init__(self) -> None:
        self._event = threading.Event()
        self._hooks: list = []

    @property
    def stopped(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Sleep until shutdown is requested; True if it was."""
        return self._event.wait(timeout)

    def on_request(self, hook: Callable[[], None]) -> None:
        """Run ``hook`` when shutdown is requested (at once if it already
        was): the way to reach a thread parked in a blocking call that
        does not poll the flag."""
        self._hooks.append(hook)
        if self.stopped:
            hook()

    def request(self) -> None:
        self._event.set()
        for hook in self._hooks:
            hook()


class ManagedThread:
    """A named thread owned by a :class:`ThreadGroup` (ThreadGroup::Thread)."""

    def __init__(self, name: str, target: Callable[[ShutdownToken], Any], daemon: bool = True):
        self.name = name
        self.token = ShutdownToken()
        self._exc: Optional[BaseException] = None

        def _run() -> None:
            try:
                target(self.token)
            except BaseException as exc:  # surfaced by join()
                self._exc = exc

        self._thread = threading.Thread(target=_telemetry.scoped_target(_run), name=name,
                                        daemon=daemon)

    def start(self) -> None:
        self._thread.start()

    def request_shutdown(self) -> None:
        self.token.request()

    @property
    def joinable(self) -> bool:
        return self._thread.is_alive()

    def join(self, timeout: Optional[float] = None) -> None:
        """Join; re-raise what the thread's body raised."""
        self._thread.join(timeout)
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc


class ThreadGroup:
    """Named managed threads (thread_group.h:95-300).

    ``create`` starts a thread under a name no live thread holds (a
    finished thread's name can be taken again); ``request_shutdown_all``
    asks every thread to stop, and ``join_all`` joins them and re-raises
    the first thread exception.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._threads: Dict[str, ManagedThread] = {}

    def create(self, name: str, target: Callable[[ShutdownToken], Any],
               daemon: bool = True) -> ManagedThread:
        with self._lock:
            old = self._threads.get(name)
            if old is not None and old.joinable:
                raise DMLCError(f"thread {name!r} is already running")
            t = self._threads[name] = ManagedThread(name, target, daemon=daemon)
        t.start()
        return t

    def get(self, name: str) -> Optional[ManagedThread]:
        with self._lock:
            return self._threads.get(name)

    def request_shutdown_all(self) -> None:
        with self._lock:
            threads = list(self._threads.values())
        for t in threads:
            t.request_shutdown()

    def join_all(self, timeout: Optional[float] = None) -> None:
        with self._lock:
            threads = list(self._threads.values())
        first_exc: Optional[BaseException] = None
        for t in threads:
            try:
                t.join(timeout)
            except BaseException as exc:
                if first_exc is None:
                    first_exc = exc
        if first_exc is not None:
            raise first_exc

    def __enter__(self) -> "ThreadGroup":
        return self

    def __exit__(self, *exc_info: Any) -> None:
        self.request_shutdown_all()
        self.join_all()


def blocking_queue_thread(group: ThreadGroup, name: str, queue: ConcurrentBlockingQueue,
                          on_item: Callable[[Any], None]) -> ManagedThread:
    """Start a managed worker that drains ``queue`` into ``on_item``
    (BlockingQueueThread, thread_group.h:530). A shutdown request kills the
    queue, so that a worker parked in ``pop`` wakes and exits."""

    def _run(token: ShutdownToken) -> None:
        token.on_request(queue.signal_for_kill)
        while not token.stopped:
            item = queue.pop()
            if item is None:
                return
            on_item(item)

    return group.create(name, _run)


def timer_thread(group: ThreadGroup, name: str, period_seconds: float,
                 callback: Callable[[], None],
                 run_first_immediately: bool = False) -> ManagedThread:
    """Start a managed thread calling ``callback`` every ``period_seconds``
    (TimerThread, thread_group.h:645): the period runs from one call's start
    to the next, and a shutdown request cuts the sleep short."""
    if period_seconds <= 0:
        raise DMLCError("timer period must be positive")

    def _run(token: ShutdownToken) -> None:
        if run_first_immediately and not token.stopped:
            callback()
        while not token.wait(period_seconds):
            callback()

    return group.create(name, _run)
