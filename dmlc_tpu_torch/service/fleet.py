"""Localhost fleet bootstrap: one dispatcher + N parse workers.

The port's copy of the JAX package's ``service/fleet.py``, with its wire,
JSON, journal records, counters and messages.

The in-process form of the service deployment (tests, ``bench.py
--service``, the docs example): multi-host launches reuse the tracker
backends instead — export ``DMLC_SERVICE_DISPATCHER`` through the
launcher env contract and run one :class:`~dmlc_tpu_torch.service.worker.
ParseWorker` per host (docs/service.md "Deploying").
"""

from __future__ import annotations

import threading
from typing import List, Optional

from dmlc_tpu_torch.service.dispatcher import Dispatcher
from dmlc_tpu_torch.service.worker import ParseWorker
from dmlc_tpu_torch.utils.check import check


class LocalFleet:
    """1 dispatcher + ``num_workers`` workers over localhost TCP.

    ``parser`` is the dispatcher-shipped parse config (see
    :class:`~dmlc_tpu_torch.service.dispatcher.Dispatcher`). With
    ``tracker=True`` a rabit-protocol tracker is started too and every
    worker fetches its rank from it and feeds the pod-telemetry table
    over the ``metrics`` heartbeat (workers then bootstrap in parallel —
    rank assignment is a barrier across the fleet).

    ``journal_path`` arms dispatcher crash recovery and the chaos API:
    :meth:`kill_dispatcher` crash-simulates the control plane,
    :meth:`restart_dispatcher` recovers it from the journal **on the
    same address**, so the live workers and clients ride through
    (docs/service.md control-plane recovery).
    """

    def __init__(self, uri: str, num_parts: int, num_workers: int = 2,
                 parser: Optional[dict] = None, tracker: bool = False,
                 liveness_timeout: float = 10.0,
                 poll_interval: float = 0.05,
                 heartbeat_interval: float = 1.0,
                 plan: Optional[dict] = None,
                 snapshot: Optional[dict] = None,
                 autotune: Optional[bool] = None,
                 journal_path: Optional[str] = None,
                 share_dir: Optional[str] = None):
        self._dispatcher_args = dict(
            uri=uri, num_parts=num_parts, parser=parser,
            liveness_timeout=liveness_timeout, plan=plan,
            snapshot=snapshot, journal_path=journal_path,
            share_dir=share_dir)
        self._worker_args = dict(poll_interval=poll_interval,
                                 heartbeat_interval=heartbeat_interval,
                                 autotune=autotune)
        self.dispatcher = Dispatcher(**self._dispatcher_args)
        self.tracker = None
        tracker_addr = None
        if tracker:
            from dmlc_tpu_torch.tracker.tracker import RabitTracker

            self.tracker = RabitTracker("127.0.0.1", num_workers)
            self.tracker.start(num_workers)
            tracker_addr = ("127.0.0.1", self.tracker.port)
        self.workers: List[ParseWorker] = [None] * num_workers  # type: ignore[list-item]
        errors: List[BaseException] = []

        def boot(slot: int) -> None:
            try:
                self.workers[slot] = ParseWorker(
                    self.dispatcher.address, tracker=tracker_addr,
                    tracker_world=num_workers, poll_interval=poll_interval,
                    heartbeat_interval=heartbeat_interval,
                    autotune=autotune)
            except BaseException as exc:  # noqa: BLE001 - re-raised below
                errors.append(exc)

        stuck = False
        if tracker:
            # rank assignment blocks until every worker joins: boot the
            # fleet concurrently or the first constructor deadlocks
            threads = [threading.Thread(target=boot, args=(i,),
                                        daemon=True)
                       for i in range(num_workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60.0)
            if errors and any(t.is_alive() for t in threads):
                # a failed sibling leaves the others blocked inside the
                # rank-assignment barrier forever: break the barrier by
                # closing the tracker, then reap the boot threads
                self.tracker.close()
                for t in threads:
                    t.join(timeout=10.0)
            stuck = any(t.is_alive() for t in threads)
        else:
            for i in range(num_workers):
                boot(i)
        if errors or stuck or any(w is None for w in self.workers):
            # a half-booted fleet must not leak listeners/threads into the
            # caller's process, and the real boot failure rides the raise
            self.close()
            raise RuntimeError("service fleet bootstrap failed") from (
                errors[0] if errors else None)

    @property
    def address(self) -> str:
        """The dispatcher address clients connect to."""
        return self.dispatcher.address

    def register_job(self, job: str, uri: str, num_parts: int,
                     parser: Optional[dict] = None,
                     plan: Optional[dict] = None,
                     snapshot: Optional[dict] = None,
                     priority: Optional[int] = None,
                     weight: Optional[int] = None,
                     slo_wait_frac: Optional[float] = None,
                     max_inflight: Optional[int] = None) -> dict:
        """Register one more job at the running dispatcher
        (docs/service.md multi-tenant service): the live workers pick it
        up at their next grant — no fleet restart, no new fleet. With
        ``share_dir`` set on the fleet, a job over an already-registered
        corpus + config shares its published block caches by signature
        (the corpus parses once fleet-wide). ``priority`` / ``weight`` /
        ``slo_wait_frac`` / ``max_inflight`` declare the job's QoS class
        (docs/service.md Production QoS)."""
        return self.dispatcher.register_job(
            job, uri, num_parts, parser=parser, plan=plan,
            snapshot=snapshot, priority=priority, weight=weight,
            slo_wait_frac=slo_wait_frac, max_inflight=max_inflight)

    def job_qos(self):
        """The registered jobs' QoS classes ({job: {priority, weight,
        ...}}) — the FleetAutoscaler's default SLO/priority source."""
        return self.dispatcher.job_qos()

    def live_workers(self) -> List[ParseWorker]:
        """Workers that are live CAPACITY: not killed/closed/drained,
        and not mid-drain either — a draining worker serves out its
        completed parts but takes no new grants, so counting it would
        let the autoscaler drain a second worker below ``fleet_min``
        (or phantom-re-drain the same one) while the first is still
        exiting."""
        return [w for w in self.workers
                if w is not None and w.alive and not w.draining]

    def autoscale(self, **kwargs) -> "FleetAutoscaler":
        """Attach an input-wait-driven :class:`~dmlc_tpu_torch.service.
        autoscale.FleetAutoscaler` to this fleet (docs/service.md fleet
        autoscaling). ``kwargs`` pass through (``source=``, bounds,
        thresholds, ``start=True`` for the background tick thread)."""
        from dmlc_tpu_torch.service.autoscale import FleetAutoscaler

        return FleetAutoscaler(self, **kwargs)

    def _pull_trace_snapshots(self) -> List[dict]:
        """One ``trace_dump`` round trip per live component — dispatcher
        over the control plane, each worker over its data listener —
        each snapshot tagged with a clock offset estimated from the RPC
        request/reply midpoint (docs/observability.md Distributed
        tracing). A peer that cannot answer is skipped, never fatal."""
        import json
        import socket as _socket

        from dmlc_tpu_torch.service import dispatcher as _dispatch
        from dmlc_tpu_torch.utils.timer import get_time

        peers: List[dict] = []

        def note(snap, t0: float, t1: float) -> None:
            if not isinstance(snap, dict):
                return
            now = snap.get("now")
            offset = ((t0 + t1) / 2.0 - float(now)
                      if isinstance(now, (int, float)) else 0.0)
            peers.append(dict(snap, clock_offset_s=round(offset, 6)))

        try:
            t0 = get_time()
            resp = _dispatch.request(self.address, {"cmd": "trace_dump"})
            note(resp.get("snapshot"), t0, get_time())
        except Exception:  # noqa: BLE001 - a dead dispatcher still dumps
            pass           # the workers' half of the timeline
        for w in self.workers:
            if w is None or not w.alive:
                continue
            try:
                t0 = get_time()
                with _socket.create_connection((w.host, w.port),
                                               timeout=10.0) as s:
                    s.settimeout(10.0)
                    with s.makefile("rwb") as f:
                        f.write(json.dumps(
                            {"cmd": "trace_dump"}).encode() + b"\n")
                        f.flush()
                        line = f.readline()
                note(json.loads(line).get("snapshot") if line else None,
                     t0, get_time())
            except (OSError, ValueError):
                continue
        return peers

    def dump_trace(self, path: str) -> int:
        """Pull every component's span rings + decision ledgers over the
        ``trace_dump`` RPC and export ONE merged Chrome/Perfetto JSON at
        ``path`` (open in ui.perfetto.dev; docs/observability.md). Each
        genuinely remote peer gets its own timeline row with its clock
        offset applied; co-located peers (a LocalFleet is one process,
        so dispatcher and workers share one span-ring set) collapse to a
        single row instead of duplicating every span N times. Returns
        the number of span events written."""
        from dmlc_tpu_torch.utils import telemetry as _telemetry

        unique: List[dict] = []
        by_pid: dict = {}
        for peer in self._pull_trace_snapshots():
            pid = peer.get("pid")
            prior = by_pid.get(pid)
            if pid is not None and prior is not None:
                prior["peer"] = f"{prior['peer']}+{peer.get('peer')}"
                continue
            if pid is not None:
                by_pid[pid] = peer
            unique.append(peer)
        return _telemetry.export_pod_trace(path, unique)

    def kill_worker(self, index: int) -> ParseWorker:
        """Crash-simulate one worker (see :meth:`ParseWorker.kill`)."""
        w = self.workers[index]
        w.kill()
        return w

    def add_worker(self, **kwargs) -> ParseWorker:
        """LIVE JOIN (docs/service.md elastic membership): boot one more
        worker against the running dispatcher mid-epoch — it enters the
        grant rotation and the re-issue serving set immediately
        (journaled ``join`` event, ``worker_joins`` counter). Joined
        workers skip the tracker (rank worlds are fixed at rendezvous;
        elastic capacity is dispatcher-side membership). ``kwargs``
        override the fleet's worker knobs (``straggle_seconds``, ...)."""
        kw = dict(poll_interval=self._worker_args["poll_interval"],
                  heartbeat_interval=self._worker_args[
                      "heartbeat_interval"],
                  autotune=self._worker_args["autotune"])
        kw.update(kwargs)
        w = ParseWorker(self.dispatcher.address, **kw)
        self.workers.append(w)
        return w

    def drain_worker(self, index: int,
                     deadline: Optional[float] = None) -> ParseWorker:
        """Gracefully drain one worker (preemption-notice path, see
        :meth:`ParseWorker.drain`): it stops taking grants, its
        unstarted parts re-issue at the front, and it serves out its
        frame-store-complete parts until clients confirm handoff or the
        deadline (``DMLC_TPU_DRAIN_DEADLINE``) expires — then exits. The
        worker stays in :attr:`workers` (close() is idempotent)."""
        w = self.workers[index]
        w.drain(reason="fleet drain_worker", deadline=deadline)
        return w

    def kill_dispatcher(self) -> Dispatcher:
        """Crash-simulate the dispatcher (``kill -9``): its listener
        drops with no goodbye and the in-memory assignment state is
        abandoned; workers poll a dead socket (classified retryable) and
        clients' locate loops consume stream-failure budget until
        :meth:`restart_dispatcher` recovers the control plane."""
        self.dispatcher.kill()
        return self.dispatcher

    def restart_dispatcher(self) -> Dispatcher:
        """Restart the dispatcher from its journal on the SAME address:
        replay restores the exact assignment state (completed parts stay
        done, in-flight parts re-queue at the front) and the generation
        bump drives the fleet's re-register + reclaim handshake. The old
        dispatcher is killed first if still alive. Requires
        ``journal_path`` — without it the replacement would re-issue
        every part for a fleet-wide re-parse."""
        check(self._dispatcher_args.get("journal_path"),
              "LocalFleet.restart_dispatcher needs journal_path= — "
              "an unjournaled dispatcher cannot recover its assignment "
              "state (docs/service.md control-plane recovery)")
        old = self.dispatcher
        if not old._closed:
            old.kill()
        self.dispatcher = Dispatcher(host=old.host, port=old.port,
                                     **self._dispatcher_args)
        return self.dispatcher

    def close(self) -> None:
        for w in self.workers:
            if w is not None:
                w.close()
        self.dispatcher.close()
        if self.tracker is not None:
            self.tracker.close()
