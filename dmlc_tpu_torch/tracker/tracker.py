"""Rabit-compatible rank-coordination tracker.

Wire-compatible with the reference tracker protocol
(tracker/dmlc_tracker/tracker.py) so existing rabit/ps-lite clients can
rendezvous against it:

- framing: native-endian int32 + length-prefixed strings (tracker.py:24-47),
- handshake: magic ``0xff99`` both ways (tracker.py:50, 64-66),
- worker hello: ``rank, world_size, jobid, cmd`` with
  cmd in {start, print, shutdown, recover} (tracker.py:67-70, 278-301),
- rank assignment: rank, parent, world, tree neighbors, ring prev/next,
  then the connect-brokering loop (goodset -> conset host/port/rank,
  wait_accept bookkeeping) (tracker.py:81-136),
- topology: binary-heap tree + node-sharing ring + link map
  (tracker.py:166-261),
- lazy world size from the first worker, batch rank assignment once all
  pending workers arrived (tracker.py:290-326), rank-stable ``recover``
  (tracker.py:288-301).

The port's copy of the JAX package's ``tracker/tracker.py``: the same
wire protocol, env contract and CLI, so a client of either package
rendezvouses with a tracker of either. The job's data plane is
``torch.distributed`` collectives, so these topologies exist for
rabit-client compatibility; the ``tpu-pod`` backend maps the same env
contract onto a process group
(:func:`dmlc_tpu_torch.parallel.init_from_env`, rendezvous at the
tracker's port + 1).
"""

from __future__ import annotations

import json
import logging
import os
import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

from dmlc_tpu_torch.utils import telemetry as _telemetry

MAGIC = 0xFF99

logger = logging.getLogger("dmlc_tpu_torch.tracker")


class Conn:
    """Framed socket: native int32 + length-prefixed utf-8 strings."""

    def __init__(self, sock: socket.socket):
        self.sock = sock

    def recvall(self, nbytes: int) -> bytes:
        chunks = []
        nread = 0
        while nread < nbytes:
            chunk = self.sock.recv(min(nbytes - nread, 4096))
            if not chunk:
                raise ConnectionError("tracker: peer closed mid-message")
            nread += len(chunk)
            chunks.append(chunk)
        return b"".join(chunks)

    def recv_int(self) -> int:
        return struct.unpack("@i", self.recvall(4))[0]

    def send_int(self, value: int) -> None:
        self.sock.sendall(struct.pack("@i", value))

    def send_str(self, value: str) -> None:
        data = value.encode()
        self.send_int(len(data))
        self.sock.sendall(data)

    def recv_str(self) -> str:
        return self.recvall(self.recv_int()).decode()

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


# ---------------- topology (tracker.py:166-261) ----------------

def tree_neighbors(rank: int, n: int) -> List[int]:
    """Binary-heap neighbors of ``rank`` in an n-node tree."""
    r = rank + 1
    out = []
    if r > 1:
        out.append(r // 2 - 1)
    if r * 2 - 1 < n:
        out.append(r * 2 - 1)
    if r * 2 < n:
        out.append(r * 2)
    return out


def get_tree(n: int) -> Tuple[Dict[int, List[int]], Dict[int, int]]:
    tree_map = {r: tree_neighbors(r, n) for r in range(n)}
    parent_map = {r: (r + 1) // 2 - 1 for r in range(n)}
    return tree_map, parent_map


def get_star(n: int) -> Tuple[Dict[int, List[int]], Dict[int, int]]:
    tree_map = {r: ([0] if r != 0 else list(range(1, n))) for r in range(n)}
    parent_map = {r: (0 if r != 0 else -1) for r in range(n)}
    return tree_map, parent_map


def find_share_ring(tree_map, parent_map, root: int) -> List[int]:
    """DFS order that shares links with the tree (tracker.py:202-219)."""
    children = set(tree_map[root]) - {parent_map[root]}
    if not children:
        return [root]
    out = [root]
    for i, child in enumerate(children):
        sub = find_share_ring(tree_map, parent_map, child)
        if i == len(children) - 1:
            sub.reverse()
        out += sub
    return out


def get_ring(tree_map, parent_map) -> Dict[int, Tuple[int, int]]:
    order = find_share_ring(tree_map, parent_map, 0)
    n = len(tree_map)
    assert len(order) == n
    ring = {}
    for i in range(n):
        ring[order[i]] = (order[(i - 1) % n], order[(i + 1) % n])
    return ring


def get_link_map(n: int):
    """Tree + parent + ring maps with ranks renumbered along the ring
    (tracker.py:236-261)."""
    tree_map, parent_map = get_tree(n)
    ring_map = get_ring(tree_map, parent_map)
    rmap = {0: 0}
    k = 0
    for i in range(n - 1):
        k = ring_map[k][1]
        rmap[k] = i + 1
    ring2 = {rmap[k]: (rmap[a], rmap[b]) for k, (a, b) in ring_map.items()}
    tree2 = {rmap[k]: [rmap[x] for x in v] for k, v in tree_map.items()}
    parent2 = {rmap[k]: (rmap[v] if k != 0 else -1) for k, v in parent_map.items()}
    return tree2, parent2, ring2


# ---------------- worker bookkeeping ----------------

class WorkerEntry:
    """One accepted connection — analog of SlaveEntry (tracker.py:58-136)."""

    def __init__(self, sock: socket.socket, addr):
        self.conn = Conn(sock)
        self.host = socket.getaddrinfo(addr[0], None)[0][4][0]
        magic = self.conn.recv_int()
        if magic != MAGIC:
            raise ConnectionError(f"invalid magic {magic:#x} from {self.host}")
        self.conn.send_int(MAGIC)
        self.rank = self.conn.recv_int()
        self.world_size = self.conn.recv_int()
        self.jobid = self.conn.recv_str()
        self.cmd = self.conn.recv_str()
        self.wait_accept = 0
        self.port: Optional[int] = None
        # (rank, entry) pairs settled during the CURRENT assign_rank call,
        # so a worker dying mid-brokering can have its settles rolled back
        # — without this its relaunch re-links the same peers and settles
        # them AGAIN, driving wait_accept negative and popping peers from
        # wait_conn early
        self.settled_in_call: list = []

    def decide_rank(self, job_map: Dict[str, int]) -> int:
        if self.rank >= 0:
            return self.rank
        if self.jobid != "NULL" and self.jobid in job_map:
            return job_map[self.jobid]
        return -1

    def assign_rank(self, rank, wait_conn, tree_map, parent_map, ring_map,
                    known_addr=None):
        """Send topology + broker peer connections (tracker.py:81-136).

        ``known_addr`` (rank -> (host, port) of every previously assigned
        worker) is passed on RECOVERY: the recovered worker then dials ALL
        its live peers itself instead of waiting for them to redial. Real
        rabit peers redial when their socket to the dead worker breaks
        (their next allreduce fails); here the data path is
        ``torch.distributed`` collectives and peer sockets are topology
        bookkeeping only, so no redial ever comes — without this, a
        recovered rank would sit in ``wait_conn`` forever and its eventual
        shutdown would kill the accept loop.
        """
        self.rank = rank
        conn = self.conn
        nnset = set(tree_map[rank])
        rprev, rnext = ring_map[rank]
        conn.send_int(rank)
        conn.send_int(parent_map[rank])
        conn.send_int(len(tree_map))
        conn.send_int(len(nnset))
        for r in nnset:
            conn.send_int(r)
        if rprev not in (-1, rank):
            nnset.add(rprev)
            conn.send_int(rprev)
        else:
            conn.send_int(-1)
        if rnext not in (-1, rank):
            nnset.add(rnext)
            conn.send_int(rnext)
        else:
            conn.send_int(-1)
        all_done = []
        pending_conset: list = []
        self.settled_in_call = []

        def settle(rank_):
            # exactly-once wait_accept accounting for a linked peer — used
            # by both the pending-round and final-round paths below
            entry = wait_conn[rank_]
            entry.wait_accept -= 1
            self.settled_in_call.append((rank_, entry))
            if entry.wait_accept == 0:
                all_done.append(rank_)
                wait_conn.pop(rank_, None)

        while True:
            ngood = conn.recv_int()
            goodset = {conn.recv_int() for _ in range(ngood)}
            assert goodset.issubset(nnset), (goodset, nnset)
            # settle peers handed out in the PREVIOUS round that the client
            # did link (their rank is now in goodset). The original
            # final-round-only accounting was correct when clients always
            # finished in one round; the client's nerr-retry loop means a
            # peer can be linked in a non-final round and must be settled
            # here, not skipped.
            for r in pending_conset:
                if r in goodset and r in wait_conn:
                    settle(r)
            badset = nnset - goodset
            conset = [r for r in badset if r in wait_conn]
            extra = ([r for r in badset
                      if r not in wait_conn and r in known_addr]
                     if known_addr else [])
            conn.send_int(len(conset) + len(extra))
            conn.send_int(len(badset) - len(conset) - len(extra))
            for r in conset:
                conn.send_str(wait_conn[r].host)
                conn.send_int(wait_conn[r].port)
                conn.send_int(r)
            for r in extra:
                host, port = known_addr[r]
                conn.send_str(host)
                conn.send_int(port)
                conn.send_int(r)
            nerr = conn.recv_int()
            if nerr != 0:
                pending_conset = conset
                continue
            self.port = conn.recv_int()
            for r in conset:
                settle(r)
            self.wait_accept = len(badset) - len(conset) - len(extra)
            return all_done


def _rollback_settles(worker: "WorkerEntry", wait_conn: dict) -> None:
    """Undo the wait_accept settles a failed assign_rank call applied.

    Each settled peer gets its credit back and is re-inserted into
    ``wait_conn`` (settle pops peers whose count hits 0), so the dead
    worker's relaunch re-brokers against exact accounting.
    """
    for r, entry in reversed(worker.settled_in_call):
        entry.wait_accept += 1
        wait_conn[r] = entry
    worker.settled_in_call = []


class RabitTracker:
    """The rendezvous server (tracker.py:138-349)."""

    def __init__(self, host_ip: str, num_workers: int,
                 port: int = 9091, port_end: int = 9999,
                 liveness_timeout: Optional[float] = None,
                 on_worker_lost=None):
        family = socket.getaddrinfo(host_ip, None)[0][0]
        sock = socket.socket(family, socket.SOCK_STREAM)
        if port_end <= port:
            port_end = port + 908  # keep the reference's default span width
        bound = False
        for p in range(port, port_end):
            try:
                sock.bind((host_ip, p))
                self.port = p
                bound = True
                break
            except OSError as exc:
                if exc.errno in (98, 48):  # EADDRINUSE linux/mac
                    continue
                raise
        if not bound:
            raise OSError(f"tracker: no free port in [{port}, {port_end})")
        sock.listen(256)
        self.sock = sock
        self.host_ip = host_ip
        self.num_workers = num_workers
        self.thread: Optional[threading.Thread] = None
        self.start_time: Optional[float] = None
        self.end_time: Optional[float] = None
        # liveness (the reference tracker blocks on accept
        # with no failure detection): workers running our WorkerClient send
        # periodic `heartbeat` commands — a new cmd legacy rabit clients
        # simply never send, so the wire protocol stays compatible.
        # Detection is opt-in per worker: only ranks that have heartbeat at
        # least once are tracked, so a legacy client in the same job is
        # never flagged. Tracked ranks silent for `liveness_timeout`
        # seconds are reported via on_worker_lost.
        self.liveness_timeout = liveness_timeout
        self.on_worker_lost = on_worker_lost
        self.last_seen: Dict[int, float] = {}
        self.lost_workers: set = set()
        # pod-scale telemetry aggregation: workers
        # running our WorkerClient ship periodic registry snapshots over a
        # `metrics` command — a cmd legacy rabit clients never send, so the
        # wire protocol stays compatible. Latest snapshot per rank; the
        # merged per-rank × per-stage table is logged as they arrive.
        self.metrics_by_rank: Dict[int, dict] = {}
        self._metrics_lock = threading.Lock()
        self._metrics_logged = 0.0  # last table log (rate-limited)
        self._shutdown_ranks: set = set()
        self._liveness_lock = threading.Lock()
        self._processing_since: Optional[float] = None
        self._monitor = None
        if liveness_timeout is not None:
            from dmlc_tpu_torch.utils.thread_group import ThreadGroup, timer_thread

            self._monitor_group = ThreadGroup()
            self._monitor = timer_thread(
                self._monitor_group, "liveness",
                max(liveness_timeout / 3.0, 0.05), self._check_liveness)
        logger.info("tracker listening on %s:%d", host_ip, self.port)

    def _mark_alive(self, rank: int) -> None:
        if rank < 0:
            return
        with self._liveness_lock:
            self.last_seen[rank] = time.time()
            self.lost_workers.discard(rank)

    def _check_liveness(self) -> None:
        if self.liveness_timeout is None:
            return
        now = time.time()
        # suspend judgment while the single-threaded accept loop is busy
        # (e.g. blocked brokering a recovery): heartbeats queue unprocessed
        # in the TCP backlog and every healthy rank would look stale
        busy_since = self._processing_since
        if busy_since is not None and now - busy_since > 0.2:
            return
        newly_lost = []
        with self._liveness_lock:
            for rank, seen in self.last_seen.items():
                if (rank in self._shutdown_ranks or rank in self.lost_workers):
                    continue
                if now - seen > self.liveness_timeout:
                    self.lost_workers.add(rank)
                    newly_lost.append(rank)
        for rank in newly_lost:
            logger.warning("tracker: worker rank %d missed heartbeats "
                           "(last seen %.1fs ago)", rank,
                           now - self.last_seen[rank])
            if self.on_worker_lost is not None:
                self.on_worker_lost(rank)

    def worker_envs(self) -> Dict[str, str]:
        """Env contract for workers (slave_envs, tracker.py:178-184)."""
        return {
            "DMLC_TRACKER_URI": self.host_ip,
            "DMLC_TRACKER_PORT": str(self.port),
        }

    # -------- pod-scale telemetry aggregation --------

    def _ingest_metrics(self, rank: int, payload: str) -> None:
        if rank < 0:
            return
        try:
            snap = json.loads(payload)
        except ValueError as exc:
            logger.warning("tracker: unparseable metrics from rank %d: %s",
                           rank, exc)
            return
        if not isinstance(snap, dict):
            return
        with self._metrics_lock:
            self.metrics_by_rank[rank] = snap
            now = time.time()
            do_log = now - self._metrics_logged >= self._metrics_log_every()
            if do_log:
                self._metrics_logged = now
        if do_log:
            logger.info("@tracker pod telemetry (%d rank(s)):\n%s",
                        len(self.metrics_by_rank), self.format_pod_table())

    @staticmethod
    def _metrics_log_every() -> float:
        """Seconds between merged-table log lines (DMLC_METRICS_LOG_EVERY;
        0 logs on every snapshot — handy in tests)."""
        try:
            return float(os.environ.get("DMLC_METRICS_LOG_EVERY", "30") or 30)
        except ValueError:
            return 30.0

    def pod_metrics(self) -> Dict[int, dict]:
        """Latest telemetry snapshot per rank (copy)."""
        with self._metrics_lock:
            return {r: dict(s) for r, s in self.metrics_by_rank.items()}

    def pod_job_metrics(self) -> Dict[str, dict]:
        """Fleet-wide per-job service breakdown, summed across ranks:
        ``{job: {"input_wait_seconds", "parts"}}`` from the snapshots'
        ``jobs`` sections (the per-job pod-table rows). This is the
        aggregate input-starvation signal a fleet autoscaler reads."""
        out: Dict[str, dict] = {}
        for snap in self.pod_metrics().values():
            for job, rec in (snap.get("jobs") or {}).items():
                tot = out.setdefault(str(job), {"input_wait_seconds": 0.0,
                                                "parts": 0})
                tot["input_wait_seconds"] += float(
                    (rec or {}).get("input_wait_seconds", 0.0))
                tot["parts"] += int((rec or {}).get("parts", 0))
        return out

    def pod_decisions(self) -> Dict[str, int]:
        """Fleet-wide control-decision counts summed across ranks:
        ``{"component.action": count}`` from the snapshots' ``decisions``
        sections (the decision ledger) — one line of
        who-did-what for the whole pod without pulling every ledger."""
        out: Dict[str, int] = {}
        for snap in self.pod_metrics().values():
            for key, n in (snap.get("decisions") or {}).items():
                out[str(key)] = out.get(str(key), 0) + int(n)
        return out

    def format_pod_table(self) -> str:
        """The merged per-rank × per-stage seconds table
        (telemetry.format_pod_table over the latest snapshots)."""
        return _telemetry.format_pod_table(self.pod_metrics())

    def _accept_loop(self, num_workers: int, master_ip: Optional[str] = None):
        shutdown: Dict[int, WorkerEntry] = {}
        wait_conn: Dict[int, WorkerEntry] = {}
        job_map: Dict[str, int] = {}
        pending: List[WorkerEntry] = []
        tree_map = None
        parent_map = ring_map = None
        todo_nodes: List[int] = []
        # ranks whose start brokering failed (worker died mid-call) and
        # whose relaunch has not completed yet — the all-started log and
        # start_time stamp wait for this to drain
        failed_start_ranks: set = set()
        # latest (host, listen-port) per assigned rank — the recovery
        # brokering source (see WorkerEntry.assign_rank known_addr)
        rank_addr: Dict[int, tuple] = {}

        while len(shutdown) != num_workers:
            self._processing_since = None
            fd, addr = self.sock.accept()
            self._processing_since = time.time()
            try:
                worker = WorkerEntry(fd, addr)
            except (ConnectionError, AssertionError) as exc:
                logger.warning("tracker: rejected connection: %s", exc)
                fd.close()
                continue
            if worker.cmd == "print":
                logger.info("%s", worker.conn.recv_str().strip())
                continue
            if worker.cmd == "heartbeat":
                self._mark_alive(worker.rank)
                worker.conn.close()
                continue
            if worker.cmd == "metrics":
                # heartbeat + telemetry snapshot in one round trip: the
                # payload is one JSON string (telemetry.pod_snapshot())
                try:
                    payload = worker.conn.recv_str()
                except (ConnectionError, OSError) as exc:
                    logger.warning("tracker: metrics recv from rank %d "
                                   "failed: %s", worker.rank, exc)
                    worker.conn.close()
                    continue
                self._mark_alive(worker.rank)
                worker.conn.close()
                self._ingest_metrics(worker.rank, payload)
                continue
            if worker.cmd == "shutdown":
                assert worker.rank >= 0 and worker.rank not in shutdown
                assert worker.rank not in wait_conn
                shutdown[worker.rank] = worker
                with self._liveness_lock:
                    self._shutdown_ranks.add(worker.rank)
                logger.debug("shutdown from rank %d", worker.rank)
                continue
            assert worker.cmd in ("start", "recover"), worker.cmd
            if tree_map is None:
                assert worker.cmd == "start"
                if worker.world_size > 0:
                    # lazy world size from the first worker (tracker.py:290-293)
                    num_workers = worker.world_size
                    self.num_workers = num_workers
                tree_map, parent_map, ring_map = get_link_map(num_workers)
                todo_nodes = list(range(num_workers))
            else:
                assert worker.world_size in (-1, num_workers)
            if worker.cmd == "recover":
                assert worker.rank >= 0
            rank = worker.decide_rank(job_map)
            if rank == -1:
                assert todo_nodes
                pending.append(worker)
                if len(pending) == len(todo_nodes):
                    # batch assignment; optionally pin rank 0 to the master
                    if master_ip:
                        for i, w in enumerate(pending):
                            if w.host == master_ip:
                                pending.insert(0, pending.pop(i))
                                break
                    for w in pending:
                        r = todo_nodes.pop(0)
                        if w.jobid != "NULL":
                            job_map[w.jobid] = r
                        try:
                            w.assign_rank(r, wait_conn, tree_map,
                                          parent_map, ring_map)
                        except (ConnectionError, OSError, EOFError) as exc:
                            # a worker dying mid-start-brokering (e.g. its
                            # peer-dial retries ran dry and it hung up) must
                            # fail ALONE, not take the rendezvous down with
                            # an unhandled EOF. Undo its
                            # settles so peer accounting is exact again;
                            # with a jobid its relaunch re-claims rank r via
                            # job_map and re-brokers. Without one no relaunch
                            # can ever reclaim the rank — fail loudly.
                            _rollback_settles(w, wait_conn)
                            w.conn.close()
                            if w.jobid == "NULL":
                                raise ConnectionError(
                                    f"worker {w.host} (rank {r}) died during "
                                    f"start brokering and carries no jobid; "
                                    f"rendezvous cannot complete") from exc
                            logger.warning(
                                "tracker: start brokering for rank %d "
                                "failed (%s); awaiting relaunch of jobid "
                                "%s", r, exc, w.jobid)
                            failed_start_ranks.add(r)
                            continue
                        if w.wait_accept > 0:
                            wait_conn[r] = w
                        rank_addr[r] = (w.host, w.port)
                        logger.debug("%s from %s -> rank %d", w.cmd, w.host, w.rank)
                    pending = []
                if not todo_nodes and not failed_start_ranks:
                    # only when every rank ACTUALLY completed brokering — a
                    # worker that died mid-start is assigned but not
                    # started, and logging success there would hand an
                    # operator a healthy-looking log for a stalled world
                    logger.info("@tracker all %d nodes started", num_workers)
                    self.start_time = time.time()
            else:
                known_addr = None
                if worker.cmd == "recover":
                    # never hand out a dead peer's listener: a rank flagged
                    # lost by the liveness monitor may be dead or
                    # relaunching, and a rank that already sent shutdown has
                    # exited (listener closed) — either address would fail
                    # the recovered worker's dial. A lost rank re-links when
                    # it recovers; a shut-down one never needs to.
                    with self._liveness_lock:
                        dead = set(self.lost_workers) | self._shutdown_ranks
                    known_addr = {r: a for r, a in rank_addr.items()
                                  if r not in dead}
                try:
                    worker.assign_rank(rank, wait_conn, tree_map, parent_map,
                                       ring_map, known_addr=known_addr)
                except (ConnectionError, OSError, EOFError) as exc:
                    # a worker dying mid-brokering must not kill the accept
                    # loop: it relaunches under DMLC_NUM_ATTEMPT and
                    # re-enters (recover keeps its rank; a jobid start
                    # re-claims it via job_map). Roll back this call's
                    # settles first — leaving them applied would let the
                    # relaunch settle the same peers twice, driving
                    # wait_accept negative.
                    _rollback_settles(worker, wait_conn)
                    logger.warning(
                        "tracker: %s brokering for rank %d failed (%s); "
                        "awaiting its relaunch", worker.cmd, rank, exc)
                    if worker.cmd == "start":
                        failed_start_ranks.add(rank)
                    worker.conn.close()
                    continue
                if worker.wait_accept > 0:
                    wait_conn[rank] = worker
                rank_addr[rank] = (worker.host, worker.port)
                logger.debug("%s from rank %d", worker.cmd, worker.rank)
                if worker.cmd == "start" and rank in failed_start_ranks:
                    failed_start_ranks.discard(rank)
                    if (not todo_nodes and not failed_start_ranks
                            and self.start_time is None):
                        logger.info("@tracker all %d nodes started",
                                    num_workers)
                        self.start_time = time.time()
        self.end_time = time.time()
        if self.start_time is not None:
            logger.info("@tracker %.3f secs between node start and job finish",
                        self.end_time - self.start_time)

    def start(self, num_workers: Optional[int] = None,
              master_ip: Optional[str] = None) -> None:
        n = num_workers if num_workers is not None else self.num_workers
        self.thread = threading.Thread(
            target=self._accept_loop, args=(n, master_ip), daemon=True
        )
        self.thread.start()

    def join(self, timeout: Optional[float] = None) -> None:
        deadline = None if timeout is None else time.time() + timeout
        while self.thread is not None and self.thread.is_alive():
            self.thread.join(0.1)
            if deadline is not None and time.time() > deadline:
                raise TimeoutError("tracker: join timed out")

    def alive(self) -> bool:
        return self.thread is not None and self.thread.is_alive()

    def close(self) -> None:
        if self._monitor is not None:
            self._monitor.request_shutdown()
            self._monitor = None
        try:
            self.sock.close()
        except OSError:
            pass


class PSTracker:
    """Parameter-server bootstrap: export scheduler env + run the scheduler
    locally (tracker.py:351-401). Rank brokering is done by ps-lite itself."""

    def __init__(self, host_ip: str, cmd: Optional[str] = None,
                 port: int = 9091, port_end: int = 9999,
                 envs: Optional[Dict[str, str]] = None):
        self.host_ip = host_ip
        self.cmd = cmd
        self.envs = dict(envs or {})
        if cmd:
            # probe a free port the same way the reference does
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            for p in range(port, port_end):
                try:
                    sock.bind(("", p))
                    self.port = p
                    break
                except OSError:
                    continue
            sock.close()
            self.thread = threading.Thread(target=self._run_scheduler, daemon=True)
            self.thread.start()
        else:
            self.thread = None

    def _run_scheduler(self) -> None:
        import os
        import subprocess

        env = os.environ.copy()
        env.update(self.envs)
        env["DMLC_ROLE"] = "scheduler"
        env.update(self.worker_envs())
        subprocess.check_call(self.cmd, shell=True, env=env)

    def worker_envs(self) -> Dict[str, str]:
        if self.cmd:
            return {
                "DMLC_PS_ROOT_URI": self.host_ip,
                "DMLC_PS_ROOT_PORT": str(self.port),
            }
        return {}

    def join(self) -> None:
        if self.thread is not None:
            self.thread.join()

    def alive(self) -> bool:
        return self.thread is not None and self.thread.is_alive()


def get_host_ip(host_ip: Optional[str] = None) -> str:
    """Best-effort local IP discovery (tracker.py submit's hostIP handling)."""
    if host_ip is None or host_ip == "auto":
        host_ip = "ip"
    if host_ip == "dns":
        return socket.getfqdn()
    if host_ip == "ip":
        try:
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.connect(("10.255.255.255", 1))
            ip = s.getsockname()[0]
            s.close()
            return ip
        except OSError:
            return "127.0.0.1"
    return host_ip


def start_rabit_tracker(args) -> None:
    """Standalone rabit tracker (reference tracker.py:450-470): start the
    rendezvous server, print the worker env contract between the
    ``DMLC_TRACKER_ENV_START`` / ``DMLC_TRACKER_ENV_END`` sentinels on
    stdout — the machine-readable block external launchers scrape for
    rank/coordinator env — then block until every worker has sent
    ``shutdown``."""
    import sys

    envs = {"DMLC_NUM_WORKER": args.num_workers,
            "DMLC_NUM_SERVER": args.num_servers}
    lt = float(os.environ.get("DMLC_LIVENESS_TIMEOUT") or 0)
    rabit = RabitTracker(get_host_ip(args.host_ip), args.num_workers,
                         liveness_timeout=lt if lt > 0 else None)
    envs.update(rabit.worker_envs())
    rabit.start(args.num_workers)
    sys.stdout.write("DMLC_TRACKER_ENV_START\n")
    # simply write configuration to stdout (the reference's exact shape:
    # one KEY=value line per env, values str()'d)
    for k, v in envs.items():
        sys.stdout.write(f"{k}={v}\n")
    sys.stdout.write("DMLC_TRACKER_ENV_END\n")
    sys.stdout.flush()
    rabit.join()
    rabit.close()


def main() -> None:
    """``python -m dmlc_tpu_torch.tracker.tracker --num-workers N ...`` — the
    standalone tracker CLI (reference tracker.py:473-502): external
    launchers start it, parse the env block off stdout, export those
    variables to their workers, and wait for the process to exit when
    the job's ranks all shut down."""
    import argparse

    parser = argparse.ArgumentParser(
        description="Start a standalone rabit tracker and print the "
                    "DMLC_TRACKER_ENV_START/END worker env block.")
    parser.add_argument("--num-workers", required=True, type=int,
                        help="number of worker ranks to rendezvous")
    parser.add_argument("--num-servers", default=0, type=int,
                        help="number of parameter servers (only 0 is "
                             "supported standalone, as in the reference)")
    parser.add_argument("--host-ip", default=None, type=str,
                        help="tracker bind/advertise IP (default: "
                             "auto-discover; 'dns' uses the FQDN)")
    parser.add_argument("--log-level", default="INFO", type=str,
                        choices=["INFO", "DEBUG"],
                        help="logging level")
    args = parser.parse_args()
    fmt = "%(asctime)s-%(levelname)s:%(name)s:%(message)s"
    level = logging.DEBUG if args.log_level == "DEBUG" else logging.INFO
    logging.basicConfig(format=fmt, level=level)
    if args.num_servers == 0:
        start_rabit_tracker(args)
    else:
        raise RuntimeError(
            "do not yet support start ps tracker in standalone mode.")


def submit(num_workers: int, num_servers: int, fun_submit,
           host_ip: Optional[str] = None, pscmd: Optional[str] = None):
    """Start the right tracker, call the backend launcher, wait
    (tracker.py:425-448)."""
    ip = get_host_ip(host_ip)
    envs = {"DMLC_NUM_WORKER": str(num_workers),
            "DMLC_NUM_SERVER": str(num_servers)}
    rabit: Optional[RabitTracker] = None
    pserver: Optional[PSTracker] = None
    if num_servers == 0:
        # DMLC_LIVENESS_TIMEOUT (seconds) arms heartbeat-based failure
        # detection for workers using our WorkerClient; unset = off (legacy
        # rabit clients send no heartbeats and must not be flagged)
        lt = float(os.environ.get("DMLC_LIVENESS_TIMEOUT") or 0)
        rabit = RabitTracker(ip, num_workers,
                             liveness_timeout=lt if lt > 0 else None)
        envs.update(rabit.worker_envs())
        rabit.start(num_workers)
    else:
        pserver = PSTracker(ip, pscmd, envs=envs)
        envs.update(pserver.worker_envs())
    try:
        fun_submit(num_workers, num_servers, envs)
    except BaseException:
        if rabit is not None:
            rabit.close()
        raise
    if num_servers == 0:
        # all worker processes have exited; if the tracker is still waiting
        # for shutdown commands the job died mid-flight — fail fast instead
        # of blocking on accept forever (the reference hangs here: it has
        # no heartbeat or timeout detection)
        try:
            rabit.join(timeout=10.0)
        except TimeoutError:
            rabit.close()
            raise RuntimeError(
                "tracker: worker processes exited but not all ranks sent "
                "shutdown — distributed job failed") from None
        rabit.close()
    else:
        pserver.join()


if __name__ == "__main__":
    main()
