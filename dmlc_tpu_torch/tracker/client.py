"""Worker-side client for the rabit tracker protocol.

The port's copy of the JAX package's ``tracker/client.py``. The reference
ships no Python client (workers are C++ rabit binaries); this client
speaks the same wire protocol (tracker.py:58-136) so that

- the tracker gets real in-process integration tests,
- ``tpu-pod`` workers can fetch a stable rank assignment from the tracker
  before joining the job's ``torch.distributed`` process group
  (:func:`dmlc_tpu_torch.parallel.init_from_env`).
"""

from __future__ import annotations

import json
import socket
import threading
from typing import Dict, List, NamedTuple, Optional, Tuple

from dmlc_tpu_torch.io.resilience import RetryPolicy
from dmlc_tpu_torch.tracker.tracker import MAGIC, Conn
from dmlc_tpu_torch.utils import telemetry as _telemetry


class Assignment(NamedTuple):
    rank: int
    parent: int
    world_size: int
    tree_neighbors: List[int]
    ring_prev: int
    ring_next: int
    connected_peers: List[Tuple[str, int, int]]  # (host, port, rank) we dialed
    num_incoming: int                            # peers that will dial us


class WorkerClient:
    """One worker's view of the tracker."""

    def __init__(self, tracker_uri: str, tracker_port: int, jobid: str = "NULL"):
        self.tracker_uri = tracker_uri
        self.tracker_port = tracker_port
        self.jobid = jobid
        self.rank = -1
        self._listen_sock: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._peer_socks: List[socket.socket] = []
        self._hb_group = None  # ThreadGroup, created on first start_heartbeat
        self._hb_thread = None
        self._hb_seq = 0

    # ---------------- protocol ----------------

    def _hello(self, cmd: str, rank: int, world_size: int) -> Conn:
        sock = socket.create_connection(
            (self.tracker_uri, self.tracker_port), timeout=30)
        conn = Conn(sock)
        conn.send_int(MAGIC)
        magic = conn.recv_int()
        if magic != MAGIC:
            raise ConnectionError(f"tracker: bad magic {magic:#x}")
        conn.send_int(rank)
        conn.send_int(world_size)
        conn.send_str(self.jobid)
        conn.send_str(cmd)
        return conn

    def _listen(self) -> int:
        self._listen_sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listen_sock.bind(("", 0))
        self._listen_sock.listen(16)
        return self._listen_sock.getsockname()[1]

    def _accept_incoming(self, count: int) -> None:
        for _ in range(count):
            try:
                peer, _ = self._listen_sock.accept()
                self._peer_socks.append(peer)
            except OSError:
                return

    def start(self, world_size: int = -1, rank: int = -1,
              cmd: str = "start") -> Assignment:
        """Join the job; blocks until the tracker assigns a rank and all
        outgoing peer links are dialed (tracker.py:81-136 client side)."""
        port = self._listen() if self._listen_sock is None else \
            self._listen_sock.getsockname()[1]
        conn = self._hello(cmd, rank, world_size)
        self.rank = conn.recv_int()
        parent = conn.recv_int()
        world = conn.recv_int()
        num_nn = conn.recv_int()
        neighbors = [conn.recv_int() for _ in range(num_nn)]
        rprev = conn.recv_int()
        rnext = conn.recv_int()
        # brokering loop: report linked ranks, dial what the tracker hands
        # out, and report dial FAILURES via the protocol's nerr field (the
        # tracker then re-brokers) instead of dying on the first refused
        # connection — recovery can be handed a peer that died in the same
        # window (tracker.py assign_rank known_addr). Bounded: persistent
        # failures raise, and the DMLC_NUM_ATTEMPT relaunch re-enters
        # recover with a fresh, liveness-filtered peer map.
        good: List[int] = []
        peers: List[Tuple[str, int, int]] = []
        nwait = 0
        # backoff between brokering rounds delegates to the shared policy
        broker = RetryPolicy(max_attempts=3, base_delay=0.2, max_delay=0.8)
        for attempt in range(3):
            conn.send_int(len(good))
            for r in good:
                conn.send_int(r)
            nconn = conn.recv_int()
            nwait = conn.recv_int()
            todo = []
            for _ in range(nconn):
                host = conn.recv_str()
                pport = conn.recv_int()
                prank = conn.recv_int()
                todo.append((host, pport, prank))
            nerr = 0
            for host, pport, prank in todo:
                try:
                    sock_ = socket.create_connection((host, pport), timeout=30)
                except OSError:
                    nerr += 1
                    continue
                self._peer_socks.append(sock_)
                good.append(prank)
                peers.append((host, pport, prank))
            conn.send_int(nerr)
            if nerr == 0:
                break
            if attempt == 2:
                conn.close()
                raise ConnectionError(
                    f"rank {self.rank}: could not link {nerr} peer(s) "
                    f"after {attempt + 1} brokering rounds")
            broker.sleep(broker.backoff(attempt, floor=0.1))
        conn.send_int(port)
        conn.close()
        if nwait > 0:
            self._accept_thread = threading.Thread(
                target=self._accept_incoming, args=(nwait,), daemon=True)
            self._accept_thread.start()
        return Assignment(self.rank, parent, world, neighbors, rprev, rnext,
                          peers, nwait)

    def recover(self, rank: int) -> Assignment:
        """Rejoin after failure keeping the prior rank (tracker.py:288-301)."""
        return self.start(world_size=-1, rank=rank, cmd="recover")

    def heartbeat(self) -> None:
        """One liveness ping (the tracker's failure detection); requires
        an assigned rank."""
        conn = self._hello("heartbeat", self.rank, -1)
        conn.close()

    def report_metrics(self, snapshot: Optional[dict] = None) -> None:
        """Ship one telemetry snapshot to the tracker (pod-scale
        aggregation): the ``metrics`` command
        carries ``telemetry.pod_snapshot()`` — per-stage seconds,
        resilience totals, span counts — as one JSON string, and doubles
        as a liveness ping. Requires an assigned rank."""
        snap = snapshot if snapshot is not None else _telemetry.pod_snapshot()
        conn = self._hello("metrics", self.rank, -1)
        conn.send_str(json.dumps(snap))
        conn.close()

    def start_heartbeat(self, interval: float = 5.0, metrics: bool = False):
        """Ping the tracker every `interval` seconds from a managed thread
        until :meth:`stop_heartbeat` (or close). With ``metrics=True``
        every ping also carries this process's telemetry snapshot
        (:meth:`report_metrics`) — the periodic feed behind the tracker's
        merged per-rank stage table. Idempotent: a running heartbeat
        thread is stopped (and, if stuck in a socket op, simply
        superseded — names are unique). Returns the thread."""
        from dmlc_tpu_torch.utils.thread_group import ThreadGroup, timer_thread

        self.stop_heartbeat()
        if self._hb_group is None:
            self._hb_group = ThreadGroup()
        self._hb_seq += 1
        fn = self._safe_report_metrics if metrics else self._safe_heartbeat
        self._hb_thread = timer_thread(
            self._hb_group, f"heartbeat-{self._hb_seq}", interval,
            fn, run_first_immediately=True)
        return self._hb_thread

    def _safe_heartbeat(self) -> None:
        try:
            self.heartbeat()
        except OSError:
            pass  # tracker gone; shutdown paths report the real error

    def _safe_report_metrics(self) -> None:
        try:
            self.report_metrics()
        except OSError:
            pass  # tracker gone; shutdown paths report the real error

    def stop_heartbeat(self) -> None:
        if self._hb_thread is not None:
            self._hb_thread.request_shutdown()
            self._hb_thread.join(2)
            self._hb_thread = None

    def print_to_tracker(self, message: str) -> None:
        conn = self._hello("print", -1, -1)
        conn.send_str(message)
        conn.close()

    def shutdown(self) -> None:
        assert self.rank >= 0, "shutdown before rank assignment"
        conn = self._hello("shutdown", self.rank, -1)
        conn.close()
        self.close()

    def close(self) -> None:
        self.stop_heartbeat()
        for s in self._peer_socks:
            try:
                s.close()
            except OSError:
                pass
        self._peer_socks = []
        if self._listen_sock is not None:
            try:
                self._listen_sock.close()
            except OSError:
                pass
            self._listen_sock = None
