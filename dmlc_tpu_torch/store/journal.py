"""Append-only JSONL journal: the crash-safe state substrate of the
tiered artifact store's manifest (:mod:`dmlc_tpu_torch.store.manager`).

Own copy of the JAX package's ``store/journal.py``; the lines it writes
are that module's, byte for byte, so a manifest written by either package
replays in the other. The mechanics:

- **flock'd appends** — one JSON object per line, written as a single
  ``write`` under an exclusive ``flock`` on a sidecar lock file, so
  concurrent processes never interleave bytes mid-line. On platforms
  without ``fcntl`` the journal degrades to in-process locking only.
- **torn-tail skip** — a crash mid-append can leave at most one
  undecodable final line (appends are single writes under the lock);
  :meth:`read_events` skips undecodable lines, so replay after a
  ``kill -9`` reconstructs exactly the state every *completed* append
  recorded.
- **fsync on demand** — events that must survive a crash pass
  ``sync=True``; bookkeeping-only events (whose loss costs nothing but
  an ephemeral refcount) skip the fsync.
- **atomic compaction** — :meth:`rewrite` stages the compacted live
  state to a process-unique sibling file, fsyncs, and renames it into
  place with ``os.replace``. The rename lives here, inside
  ``dmlc_tpu_torch/store/``: ``tests/test_torch_store_lint.py`` fails a
  hand-rolled ``.tmp`` + ``os.replace`` publish anywhere else in the port.

Locking is reentrant per thread: :meth:`locked` tracks its own depth, so
a public method that holds the lock can call helpers that take it again
without the second ``flock`` on a fresh fd deadlocking the process.
"""

from __future__ import annotations

import json
import os
import threading
from contextlib import contextmanager
from typing import Dict, Iterable, List, Optional

try:  # POSIX cross-process lock; degrades to in-process locking without
    import fcntl as _fcntl
except ImportError:  # pragma: no cover - non-POSIX
    _fcntl = None


def encode_event(event: dict) -> str:
    """One journal line (sorted compact JSON, newline-terminated)."""
    return json.dumps(event, sort_keys=True, separators=(",", ":")) + "\n"


def decode_events(lines: List[str]) -> List[Dict]:
    """Decode journal lines, skipping undecodable ones (the torn tail
    of a crashed append) — shared by :meth:`AppendJournal.read_events`
    and replayers that already hold the lines."""
    events: List[Dict] = []
    for raw in lines:
        try:
            ev = json.loads(raw)
        except ValueError:
            continue
        if isinstance(ev, dict):
            events.append(ev)
    return events


class AppendJournal:
    """One append-only JSONL journal file + its cross-process lock."""

    def __init__(self, path: str, lock_path: Optional[str] = None):
        self.path = os.path.abspath(path)
        self.lock_path = lock_path or self.path + ".lock"
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._mu = threading.RLock()
        self._depth = 0

    # ---------------- locking ----------------

    @contextmanager
    def locked(self):
        """In-process mutex + cross-process ``flock``, reentrant per
        thread (a second :meth:`locked` from the holder is depth-counted
        instead of re-``flock``\\ ing a fresh fd, which would deadlock)."""
        with self._mu:
            if self._depth:
                self._depth += 1
                try:
                    yield
                finally:
                    self._depth -= 1
                return
            f = open(self.lock_path, "a+")
            try:
                if _fcntl is not None:
                    _fcntl.flock(f.fileno(), _fcntl.LOCK_EX)
                self._depth = 1
                try:
                    yield
                finally:
                    self._depth = 0
            finally:
                try:
                    if _fcntl is not None:
                        _fcntl.flock(f.fileno(), _fcntl.LOCK_UN)
                finally:
                    f.close()

    # ---------------- write side ----------------

    def append(self, event: dict, sync: bool = False) -> None:
        """Append one event under the lock. ``sync=True`` fsyncs — for
        records that must survive a crash; a lost unsynced line may only
        cost state the replay reconstructs anyway."""
        line = encode_event(event)
        with self.locked():
            with open(self.path, "a") as f:
                f.write(line)
                if sync:
                    f.flush()
                    os.fsync(f.fileno())

    def rewrite(self, events: Iterable[dict]) -> None:
        """Atomically replace the journal with ``events`` (compaction):
        stage to a process-unique sibling, fsync, ``os.replace``."""
        tmp = f"{self.path}.{os.getpid()}.compact"
        with self.locked():
            with open(tmp, "w") as f:
                for event in events:
                    f.write(encode_event(event))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)

    # ---------------- read side ----------------

    def read_lines(self) -> List[str]:
        """Raw journal lines (missing file reads as empty)."""
        with self.locked():
            try:
                with open(self.path, "r") as f:
                    return f.read().splitlines()
            except OSError:
                return []

    def read_events(self) -> List[Dict]:
        """Decoded events in append order; undecodable lines (the torn
        tail of a crashed append) are skipped."""
        return decode_events(self.read_lines())
