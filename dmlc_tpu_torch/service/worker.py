"""Data-service parse worker: claim splits across jobs, parse, stream.

The port's copy of the JAX package's ``service/worker.py``, with its wire,
JSON, journal records, counters and messages; the JAX package's fault-plan
call here is left out (the port has no fault seam).

One worker of the disaggregated ingest fleet (arXiv:2210.14826 §3.2):
it polls the :class:`~dmlc_tpu_torch.service.dispatcher.Dispatcher` for
partitions — **multiplexing every registered job from the one grant
rotation**: each ``next_split`` grant names ``(job, part)``, the job's
dataset spec is fetched lazily at first grant and cached, and the frame
store is keyed per job, so one worker process serves N trainers' corpora
side by side (docs/service.md multi-tenant service). Each granted part
runs the **existing** parser stack
(:func:`dmlc_tpu_torch.data.parsers.create_parser` with the job's
dispatcher-shipped config, optionally fronted by the parse-once
:class:`~dmlc_tpu_torch.data.parsers.BlockCacheIter` when the config carries
``block_cache`` — a relaunched worker then re-serves its parts from the
warm cache instead of re-parsing text, and a part of a job whose
share-by-signature cache was ALREADY published by a sibling job serves
warm without parsing at all: that fleet-wide parse-once is the
cross-job sharing claim, counted as ``service_parts_shared`` vs
``service_parts_parsed`` for actual parses), encodes every RowBlock
into a wire frame at parse time
(:func:`~dmlc_tpu_torch.service.frame.encode_block_frame`, ``service_encode``
spans), and serves job-qualified ``stream``/``find``/``count`` requests
from trainer clients over its own TCP listener (``service_send``
spans). Completed parts tick the job-labeled
``service_job_parts`` registry counter, so the tracker pod table shows
per-job parts served next to per-rank stages (docs/observability.md).

Fleet bootstrap reuses the tracker layer: pass ``tracker=(uri, port)``
and the worker fetches a stable rank from the rabit-protocol tracker
(:class:`~dmlc_tpu_torch.tracker.client.WorkerClient`) — its worker id becomes
``rank<N>`` — and ships its telemetry registry to the tracker over the
PR-6 ``metrics`` command (``start_heartbeat(metrics=True)``), so
per-worker parse/encode/send seconds and ``service_*`` span counts land
in the tracker's merged pod table next to every other rank.

Failure model: :meth:`kill` simulates a crash — listener and client
connections drop mid-frame, the dispatcher is NOT told (clients
``report_lost`` it / heartbeats go stale), and the in-memory frame store
is gone, exactly like a dead process. The dispatcher re-issues the dead
worker's parts and a live worker re-parses them; parsing is
deterministic, so the re-served frames are byte-identical.

Graceful exit model (docs/service.md elastic membership): preemptible
capacity comes with a NOTICE, and wasting it means re-parsing everything
the worker held. :meth:`drain` begins a graceful departure — triggered
by the operator (``LocalFleet.drain_worker``), by SIGTERM
(``handle_sigterm=True``, main-thread processes), or by the
``DMLC_TPU_PREEMPTION_NOTICE`` file/env signal, checked every heartbeat
and counted as ``preemption_notices``. The worker tells the dispatcher
to drain it (no new grants; unstarted parts proactively re-issue), marks
any in-progress parse as a *draining* ERROR so clients relocate
immediately instead of waiting for a dead socket, and keeps SERVING its
frame-store-complete parts (ENDs carry a ``draining`` flag so clients
confirm handoffs) until the dispatcher reports the drain complete or the
drain deadline (``DMLC_TPU_DRAIN_DEADLINE``) expires — then exits
cleanly.

Chaos knobs: :meth:`kill` (crash), :meth:`drain` (preemption), and
``straggle_seconds`` — an artificial per-block stall that turns this
worker into a deterministic straggler so the dispatcher's speculative
hedging path is testable without racy scheduling tricks.

Control-plane failure model (docs/service.md control-plane recovery): a
dispatcher-unreachable round trip is a classified retryable fault —
every control RPC runs under the shared
:class:`~dmlc_tpu_torch.io.resilience.RetryPolicy` (backoff + jitter,
``control_plane_retries`` counted per re-attempt). Every dispatcher
response carries a monotonic generation token; a bump means the
dispatcher restarted, so the worker re-attaches
(``worker_reregistrations``): it re-registers and **reclaims** — sends
the new ``reclaim`` command re-announcing the fully-parsed parts still
in its frame store, which the recovered dispatcher adopts
(``parts_reclaimed``) instead of re-issuing them for a fleet-wide
re-parse. Completed parts also ``part_done`` to the dispatcher as they
finish, journaling the completion so a later restart keeps them done.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import threading
from typing import Dict, List, Optional, Tuple

from dmlc_tpu_torch.io import resilience as _resilience
from dmlc_tpu_torch.service import dispatcher as _dispatch
from dmlc_tpu_torch.service.dispatcher import DEFAULT_JOB
from dmlc_tpu_torch.service.frame import (
    WIRE_CODECS,
    annot_key,
    decode_frame,
    encode_block_frame,
    encode_block_frame_v2,
    encode_end_frame,
    encode_error_frame,
    encode_hello_frame,
    negotiate_codec,
    reframe_v2,
    send_frame,
    send_frame_vectored,
)
from dmlc_tpu_torch.store.manager import publish_owner
from dmlc_tpu_torch.utils import knobs as _knobs
from dmlc_tpu_torch.utils import telemetry as _telemetry
from dmlc_tpu_torch.utils.check import DMLCError
from dmlc_tpu_torch.utils.timer import get_time

logger = logging.getLogger("dmlc_tpu_torch.service")


# the shared packed-snapshot container (docs/service.md snapshot
# sharing): the DMLCSN01 store tier's on-disk home for a part's packed
# snapshot frames — magic, frame count, then length-prefixed wire
# frames. Deliberately trivial: the frames ARE the wire encoding
# (dmlc_tpu_torch.service.frame), so a load is a read + split, no re-pack.
_SNAP_SHARE_MAGIC = b"DMLCSN01"


def _encode_snap_container(frames: List[bytes]) -> bytes:
    import struct

    out = [_SNAP_SHARE_MAGIC, struct.pack("<I", len(frames))]
    for fr in frames:
        out.append(struct.pack("<Q", len(fr)))
        out.append(fr)
    return b"".join(out)


def _decode_snap_container(data: bytes) -> Optional[List[bytes]]:
    """The container's frames, or None on any shape violation — a
    corrupt/foreign file must fall back to a local pack, never crash
    the serve."""
    import struct

    if len(data) < 12 or data[:8] != _SNAP_SHARE_MAGIC:
        return None
    (count,) = struct.unpack_from("<I", data, 8)
    off = 12
    frames: List[bytes] = []
    for _ in range(count):
        if off + 8 > len(data):
            return None
        (ln,) = struct.unpack_from("<Q", data, off)
        off += 8
        if off + ln > len(data):
            return None
        frames.append(data[off:off + ln])
        off += ln
    return frames if off == len(data) else None


class _PartStore:
    """Frames of one claimed part, appended as the parse progresses so a
    client can stream a part that is still being parsed. Held in RAM for
    the worker's life (warm epoch re-serves + O(1) failover resume) —
    the fleet must be sized so each worker's share of the encoded corpus
    fits its host (docs/service.md "Memory model"). ``snap_frames`` is
    the part re-encoded as device-layout snapshot frames (packed on
    first snapshot stream request, once the part is complete — the
    dispatcher's ``snapshot`` geometry decides shape and dtype)."""

    __slots__ = ("frames", "keys", "complete", "error", "snap_frames",
                 "snap_packing", "cache_path", "wire_cache")

    def __init__(self):
        self.frames: List[bytes] = []
        self.keys: List[Optional[str]] = []  # annot_key per block (or None)
        self.complete = False
        self.error: Optional[str] = None
        self.snap_frames: Optional[List[bytes]] = None
        self.snap_packing = False  # one serve thread holds the pack claim
        # the part's published block-cache path (set at parse end when it
        # exists): the v2 HELLO offers it to co-located clients as the
        # mmap fast path (docs/service.md Wire v2)
        self.cache_path: Optional[str] = None
        # lazily compressed v2 frames per negotiated codec: codec ->
        # {block: frame-or-None} (None = measured incompressible, ship
        # identity) — compressed once, re-served to every v2 client
        self.wire_cache: Dict[str, Dict[int, Optional[bytes]]] = {}


class ParseWorker:
    """One tracker-launchable parse worker process/object."""

    def __init__(self, dispatcher: str, worker_id: Optional[str] = None,
                 host: str = "127.0.0.1",
                 tracker: Optional[Tuple[str, int]] = None,
                 tracker_world: int = -1,
                 poll_interval: float = 0.2,
                 heartbeat_interval: float = 2.0,
                 autotune: Optional[bool] = None,
                 drain_deadline: Optional[float] = None,
                 handle_sigterm: bool = False,
                 straggle_seconds: float = 0.0):
        self.dispatcher = dispatcher
        self.poll_interval = float(poll_interval)
        self.heartbeat_interval = float(heartbeat_interval)
        # graceful-drain state (docs/service.md elastic membership):
        # `_draining` flips once and never back; the local deadline is a
        # backstop in case the dispatcher never confirms completion
        self._draining = threading.Event()
        self._drain_deadline = drain_deadline
        self._drain_deadline_at: Optional[float] = None
        self._sigterm_seen = False
        self.drained = False
        # chaos harness: a deterministic straggler — sleep this long
        # before publishing each parsed block, so hedging tests need no
        # scheduler tricks (docs/service.md elastic membership)
        self.straggle_seconds = float(straggle_seconds)
        # control RPCs heal through the shared policy (backoff + jitter,
        # control_plane_retries per re-attempt) — a dispatcher between
        # kill and restart is retryable, not fatal (docs/service.md)
        self._policy = _resilience.default_policy()
        self._gen: Optional[int] = None
        cfg = self._request({"cmd": "config"}, reattach=False)
        # the default job's spec, kept as attributes for the historical
        # one-dataset view (None/0/{} on a dispatcher born empty); jobs
        # beyond the default are fetched lazily at first grant and
        # cached in _job_cfgs (docs/service.md multi-tenant service)
        self.uri = cfg.get("uri")
        self.num_parts = int(cfg.get("num_parts") or 0)
        self._parser_cfg = dict(cfg.get("parser") or {})
        self._job_cfgs: Dict[str, dict] = {}
        if self.uri is not None:
            self._job_cfgs[DEFAULT_JOB] = {
                "uri": self.uri, "num_parts": self.num_parts,
                "parser": self._parser_cfg,
                "plan": dict(cfg.get("plan") or {}),
                "snapshot": dict(cfg.get("snapshot") or {})}
        # per-host parse-tier self-tuning (docs/data.md autotune; the
        # tf.data-service motivation — a heterogeneous fleet cannot share
        # one static parse_workers): each completed part is a clean
        # measurement window, and the measured parallelism efficiency
        # decides the NEXT part's fan-out width within the knob-table
        # caps. Armed by autotune=True or DMLC_TPU_AUTOTUNE=1; block
        # content is engine-width-invariant (the A/B parity suites), so
        # re-served frames stay byte-identical across tier changes.
        self.tier_tuner = None
        from dmlc_tpu_torch.utils import knobs as _knobs

        if _knobs.autotune_enabled(autotune):
            from dmlc_tpu_torch.data.autotune import ParseTierTuner

            self.tier_tuner = ParseTierTuner(
                start=self._parser_cfg.get("parse_workers"))
        # dispatcher-shipped epoch-plan identity, surfaced for clients /
        # operators. Deliberately NOT folded into the worker's own parser
        # builds: frames must stay parse-order — a relaunched worker
        # re-serving a part from an already-published warm cache with a
        # plan armed would serve PLAN order, and the client's
        # failover-resume-at-block-index contract (byte-identity) would
        # break. The seed is the fleet's shared metadata, not a worker
        # serving mode (docs/service.md plan distribution).
        self.plan = dict(cfg.get("plan") or {})
        # dispatcher-shipped snapshot geometry: when set, parts ALSO
        # serve as device-layout snapshot frames — fixed [B, num_col + 2]
        # packed batches in the geometry's x_dtype (bf16 halves the
        # wire), packed lazily per part on first snapshot stream request
        # (docs/service.md snapshot frames)
        self.snapshot = dict(cfg.get("snapshot") or {})
        # data listener first: the tracker/dispatcher registrations carry
        # its port
        self._listen = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listen.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listen.bind((host, 0))
        self._listen.listen(64)
        self.host, self.port = self._listen.getsockname()[:2]
        # optional rank bootstrap + pod-telemetry feed via the tracker
        self.rank = -1
        self._tracker_client = None
        try:
            if tracker is not None:
                from dmlc_tpu_torch.tracker.client import WorkerClient

                self._tracker_client = WorkerClient(tracker[0], tracker[1])
                self.rank = self._tracker_client.start(
                    world_size=tracker_world).rank
                self._tracker_client.start_heartbeat(
                    interval=self.heartbeat_interval, metrics=True)
            self.worker_id = worker_id or (
                f"rank{self.rank}" if self.rank >= 0
                else f"{self.host}:{self.port}")
            self._cond = threading.Condition()
            # frame stores are PER JOB: (job, part) -> _PartStore, so N
            # multiplexed jobs' parts never collide (docs/service.md)
            self._store: Dict[Tuple[str, int], _PartStore] = {}
            # every part this worker ever processed, in order — the
            # no-re-parse evidence chaos tests assert on (a reclaimed
            # part must appear exactly once across the fleet); the
            # job-qualified twin rides parts_by_job
            self.parts_parsed: List[int] = []
            self.parts_by_job: Dict[str, List[int]] = {}
            # the cross-job sharing evidence: parts whose supply ran an
            # actual text parse (cold) vs parts that resolved to an
            # already-published share-by-signature block cache (warm —
            # the parse was avoided fleet-wide; docs/store.md)
            self.parts_cold: List[Tuple[str, int]] = []
            self.parts_warm: List[Tuple[str, int]] = []
            # artifact-store pins held for parts this worker serves: a
            # block cache published while parsing a part stays pinned for
            # the worker's life, so a fleet-wide byte-budget squeeze can
            # never evict the tier a relaunched/failed-over worker would
            # re-serve the part from (docs/store.md pin semantics)
            self._artifact_pins: List[str] = []
            self._stop = threading.Event()
            self._dead = False
            self._conns: set = set()
            self._conns_lock = threading.Lock()
            self._register()
            # announce the (empty) frame store: a same-id restart (e.g.
            # rank0 relaunched by the tracker) re-queues any stale parts
            # the dispatcher still maps to this id, immediately instead
            # of waiting for clients to trip over them
            self._reclaim()
        except BaseException:
            # a failed bootstrap must not leak the bound listener or a
            # live heartbeat thread for a worker that never existed
            try:
                self._listen.close()
            except OSError:
                pass
            if self._tracker_client is not None:
                self._tracker_client.close()
                self._tracker_client = None
            raise
        self._threads = [
            threading.Thread(target=self._serve_loop, daemon=True,
                             name=f"service-worker-{self.worker_id}-serve"),
            threading.Thread(target=self._split_loop, daemon=True,
                             name=f"service-worker-{self.worker_id}-parse"),
            threading.Thread(target=self._hb_loop, daemon=True,
                             name=f"service-worker-{self.worker_id}-hb"),
        ]
        for t in self._threads:
            t.start()
        if handle_sigterm:
            self.install_signal_handlers()
        logger.info("parse worker %s serving on %s:%d", self.worker_id,
                    self.host, self.port)

    # ---------------- control plane ----------------

    def _request(self, req: dict, reattach: bool = True) -> dict:
        """One policy-guarded dispatcher round trip: transient faults
        (connection refused while the dispatcher restarts, torn replies)
        back off with jitter and retry under the shared policy, counting
        ``control_plane_retries``. A generation bump in the response
        triggers the re-attach handshake (register + reclaim) unless
        ``reattach=False`` (bootstrap, and the handshake's own RPCs)."""
        resp = self._policy.call(
            lambda: _dispatch.request(self.dispatcher, req),
            op="control_plane", what=self.dispatcher,
            on_retry=lambda: _resilience.record_event(
                "control_plane_retries"))
        if self._note_generation(resp) and reattach:
            self._reattach()
        return resp

    def _note_generation(self, resp: dict) -> bool:
        """Track the dispatcher's generation token; True when it
        advanced past the last one seen (= the dispatcher restarted)."""
        gen = resp.get("gen")
        if gen is None:
            return False
        gen = int(gen)
        changed = self._gen is not None and gen > self._gen
        if self._gen is None or gen > self._gen:
            self._gen = gen
        return changed

    def _register(self) -> None:
        self._request({"cmd": "register", "worker": self.worker_id,
                       "host": self.host, "port": self.port},
                      reattach=False)

    def _reclaim(self) -> None:
        """Re-announce the fully-parsed parts still in the frame store —
        per job — so a restarted dispatcher adopts them instead of
        re-issuing them for a fleet-wide re-parse (counted as
        ``parts_reclaimed``). An empty announce is still useful: it
        re-queues any stale parts the dispatcher maps to this id whose
        frames this incarnation does not hold."""
        held: Dict[str, List[int]] = {}
        with self._cond:
            for (job, part), s in self._store.items():
                if s.complete and s.error is None:
                    held.setdefault(job, []).append(part)
        for parts in held.values():
            parts.sort()
        resp = self._request({"cmd": "reclaim", "worker": self.worker_id,
                              "parts": held}, reattach=False)
        adopted = resp.get("adopted") or {}
        count = (sum(len(ps) for ps in adopted.values())
                 if isinstance(adopted, dict) else len(adopted))
        if count:
            _resilience.record_event("parts_reclaimed", count)
            logger.info("worker %s: dispatcher adopted reclaimed parts %s",
                        self.worker_id, adopted)

    def _reattach(self) -> None:
        """The dispatcher restarted (generation bump) or declared this
        worker dead: re-register and reclaim the frame store
        (docs/service.md control-plane recovery). A DRAINING worker is
        leaving, not rejoining — it re-sends the drain instead, so the
        recovered dispatcher keeps it out of the grant rotation; but if
        the dispatcher no longer knows it at all (declared dead before
        the drain landed), the drain RPC is refused ``unknown`` — then
        it must register + reclaim FIRST, putting its frame-store-
        complete parts back into the serving set, and re-announce the
        drain in the same breath, so it re-enters the fleet as DRAINING,
        never as a grant-eligible ACTIVE."""
        if self._draining.is_set():
            resp = self._announce_drain()
            if resp is not None and resp.get("unknown"):
                try:
                    self._register()
                    self._reclaim()
                except (OSError, DMLCError, ValueError):
                    return  # the next poll retries
                self._announce_drain()
            return
        _resilience.record_event("worker_reregistrations")
        logger.info("worker %s: re-attaching to dispatcher %s (gen %s)",
                    self.worker_id, self.dispatcher, self._gen)
        try:
            self._register()
            self._reclaim()
        except (OSError, DMLCError, ValueError):
            pass  # the next poll retries; dispatcher liveness covers us

    # ---------------- graceful drain ----------------

    def _drain_seconds(self) -> float:
        if self._drain_deadline is not None:
            return float(self._drain_deadline)
        from dmlc_tpu_torch.utils import knobs as _knobs

        return float(_knobs.resolve("drain_deadline"))

    def drain(self, reason: str = "operator",
              deadline: Optional[float] = None) -> None:
        """Begin a graceful departure (docs/service.md elastic
        membership): tell the dispatcher to stop granting and re-issue
        this worker's unstarted parts, abandon any in-progress parse
        (clients get a *draining* ERROR and relocate immediately), and
        keep serving frame-store-complete parts until the dispatcher
        confirms the drain or the deadline expires. Idempotent."""
        if self._stop.is_set():
            return
        if self._draining.is_set():
            # already draining: an explicit deadline may TIGHTEN the
            # window (eviction imminent — drain(deadline=0) means leave
            # now), never loosen it
            if deadline is not None:
                new_at = get_time() + float(deadline)
                if (self._drain_deadline_at is None
                        or new_at < self._drain_deadline_at):
                    self._drain_deadline_at = new_at
                    logger.warning(
                        "worker %s: drain deadline tightened to %.1fs "
                        "(%s)", self.worker_id, float(deadline), reason)
                    self._announce_drain()
            return
        if deadline is not None:
            self._drain_deadline = float(deadline)
        ddl = self._drain_seconds()
        self._draining.set()
        self._drain_deadline_at = get_time() + ddl
        logger.warning("worker %s: draining (%s; deadline %.1fs)",
                       self.worker_id, reason, ddl)
        with self._cond:
            self._cond.notify_all()  # wake streams of the aborted parse
        self._announce_drain()

    def _announce_drain(self) -> Optional[dict]:
        """Send (or RE-send) the idempotent ``drain`` RPC; returns the
        reply, or None when the RPC failed outright. A single
        announcement is not reliable: the RPC can fail, or land while
        the dispatcher transiently considers this worker dead
        (``unknown``) — and a later re-register would heal it back to
        ACTIVE, silently desyncing membership. The split loop therefore
        re-announces (via :meth:`_reattach`) whenever a poll reply shows
        the dispatcher does not have us DRAINING; the local deadline
        backstop bounds it all."""
        remaining = max(0.0, (self._drain_deadline_at or get_time())
                        - get_time())
        try:
            resp = self._request({"cmd": "drain", "worker": self.worker_id,
                                  "deadline": remaining}, reattach=False)
        except (OSError, DMLCError, ValueError) as exc:
            logger.warning("worker %s: drain RPC failed (%s); will "
                           "re-announce from the split loop",
                           self.worker_id, exc)
            return None
        if not resp.get("ok"):
            logger.warning("worker %s: dispatcher refused drain: %s",
                           self.worker_id, resp)
        return resp

    def _check_preemption(self) -> None:
        """The preemption notice, checked every heartbeat: the
        ``DMLC_TPU_PREEMPTION_NOTICE`` env names a notice file (value
        ``1`` means 'notice already served'). A notice counts
        ``preemption_notices`` and begins the drain. (The JAX package's
        ``preempt`` fault-plan op has no counterpart: the port has no
        fault seam, and tests serve the notice through the file.)"""
        if self._draining.is_set() or self._stop.is_set():
            return
        notice = os.environ.get("DMLC_TPU_PREEMPTION_NOTICE", "").strip()
        noticed = bool(notice) and (notice == "1" or os.path.exists(notice))
        why = f"preemption notice {notice!r}"
        if noticed:
            _resilience.record_event("preemption_notices")
            self.drain(reason=why)

    def install_signal_handlers(self) -> bool:
        """Route SIGTERM to :meth:`drain` (the k8s/preemptible-VM exit
        contract). Only the main thread may install handlers; returns
        False (and stays signal-free) anywhere else."""
        import signal

        def _on_term(signum, frame):  # noqa: ARG001 - signal contract
            # the handler runs on the user's MAIN thread mid-eviction:
            # it must not block on drain()'s policy-retried dispatcher
            # RPC (an unreachable dispatcher would freeze the training
            # loop for most of the grace window), so the drain protocol
            # runs on a background thread. Orchestrators re-send SIGTERM
            # through the grace period: only the first notice counts
            # (handlers never run concurrently with themselves, so the
            # seen-flag needs no lock; drain() is idempotent besides).
            if (self._sigterm_seen or self._draining.is_set()
                    or self._stop.is_set()):
                return
            self._sigterm_seen = True
            _resilience.record_event("preemption_notices")
            threading.Thread(
                target=self.drain, kwargs={"reason": "SIGTERM"},
                daemon=True,
                name=f"service-worker-{self.worker_id}-drain").start()

        try:
            signal.signal(signal.SIGTERM, _on_term)
            return True
        except ValueError:  # not the main thread
            logger.warning("worker %s: SIGTERM handler needs the main "
                           "thread; rely on DMLC_TPU_PREEMPTION_NOTICE "
                           "or drain() instead", self.worker_id)
            return False

    def _finish_drain(self) -> None:
        """Drain complete (dispatcher confirmed, or the local deadline
        backstop fired): serve out any stream still in flight, then
        leave the fleet cleanly. The dispatcher's completion is keyed on
        handoff confirmations, but handoffs are per PART and clients are
        anonymous — ANOTHER client may still be mid-stream on a part a
        first client already confirmed, and killing its socket here
        would force exactly the ungraceful timeout failover (plus a
        re-parse) the drain protocol exists to prevent. Bounded by what
        remains of the notice window."""
        if self.drained:
            return
        self.drained = True
        deadline = self._drain_deadline_at
        while deadline is not None and get_time() < deadline:
            with self._conns_lock:
                busy = bool(self._conns)
            if not busy:
                break
            self._stop.wait(0.05)
        logger.info("worker %s: drain complete; exiting", self.worker_id)
        self.close()

    # ---------------- parse side ----------------

    def _job_cfg(self, job: str) -> dict:
        """The dataset spec of ``job`` — the cached default/previously
        granted specs, or one lazy ``config`` RPC for a job registered
        after this worker booted (the multiplexing seam)."""
        cfg = self._job_cfgs.get(job)
        if cfg is None:
            cfg = self._request({"cmd": "config", "job": job})
            self._job_cfgs[job] = cfg = {
                "uri": cfg.get("uri"),
                "num_parts": int(cfg.get("num_parts") or 0),
                "parser": dict(cfg.get("parser") or {}),
                "plan": dict(cfg.get("plan") or {}),
                "snapshot": dict(cfg.get("snapshot") or {})}
        return cfg

    def _build_parser(self, job: str, part: int):
        from dmlc_tpu_torch.data.parsers import create_parser

        cfg = self._job_cfg(job)
        kwargs = dict(cfg["parser"])
        type_ = kwargs.pop("format", kwargs.pop("type_", "auto"))
        # plan knobs never reach the worker's parser (see __init__): the
        # frame store must be parse-order for exact-block failover resume
        kwargs.pop("shuffle_seed", None)
        kwargs.pop("shuffle_window", None)
        kwargs.pop("pod_sharding", None)
        if self.tier_tuner is not None:
            # the self-tuned tier overrides the shipped static width
            kwargs["parse_workers"] = self.tier_tuner.workers
        return create_parser(cfg["uri"], part, cfg["num_parts"], type_,
                             **kwargs)

    def _retune_parse_tier(self, parser) -> None:
        """Feed the completed part's measured parallelism efficiency back
        into the tier tuner (grow saturated lanes, shed idle ones) so the
        next part parses at the adjusted width."""
        if self.tier_tuner is None or parser is None:
            return
        stats = None
        fn = getattr(parser, "parallel_stats", None)
        if callable(fn):
            try:
                stats = fn()
            except Exception:  # noqa: BLE001 - a sensor must never kill parse
                stats = None
        self.tier_tuner.decide(
            (stats or {}).get("parse_parallelism_efficiency"),
            workers=(stats or {}).get("parse_workers"))

    def autotune_state(self) -> Optional[dict]:
        """The tier tuner's decision record (None when self-tuning is
        off) — the worker-side analog of stats()['autotune']."""
        return (self.tier_tuner.snapshot()
                if self.tier_tuner is not None else None)

    def _split_loop(self) -> None:
        while not self._stop.is_set():
            if (self._draining.is_set()
                    and self._drain_deadline_at is not None
                    and get_time() >= self._drain_deadline_at):
                # local backstop: the dispatcher never confirmed (or is
                # gone) — the notice window is up, exit anyway
                self._finish_drain()
                return
            gen_before = self._gen
            try:
                resp = self._request(
                    {"cmd": "next_split", "worker": self.worker_id})
            except (OSError, DMLCError, ValueError):
                # the policy's budget is spent and the dispatcher is
                # still unreachable: poll-wait and try a fresh budget
                self._stop.wait(self.poll_interval)
                continue
            if resp.get("drained"):
                # the dispatcher completed our drain (handoffs confirmed
                # or deadline expired): exit cleanly
                self._finish_drain()
                return
            if resp.get("draining"):
                if not self._draining.is_set():
                    # the drain was initiated AT the dispatcher (operator
                    # RPC): adopt it locally so the whole protocol runs —
                    # abandon the in-progress parse with a draining
                    # ERROR, flag ENDs for handoff confirmation, arm the
                    # local deadline backstop. drain() re-sends the RPC,
                    # which is idempotent dispatcher-side.
                    self.drain(reason="dispatcher-initiated drain")
                self._stop.wait(self.poll_interval)
                continue
            if self._draining.is_set():
                # reaching here means the reply carried neither
                # `draining` nor `drained`: the dispatcher does NOT have
                # us DRAINING (it missed the drain RPC, declared us dead,
                # or a restart healed us back to ACTIVE). _reattach
                # re-announces — registering + reclaiming first when
                # we're unknown — and the drain's proactive re-issue
                # re-queues any part this very reply may have granted,
                # which we must not parse.
                self._reattach()
                self._stop.wait(self.poll_interval)
                continue
            if resp.get("register") and self._gen == gen_before:
                # declared dead (zombie) with no restart involved —
                # rejoin AND reclaim, so the frames this incarnation
                # still serves are adopted back instead of re-parsing
                # fleet-wide (a generation bump in the same reply was
                # already handled inside _request)
                self._reattach()
                self._stop.wait(self.poll_interval)
                continue
            part = resp.get("part")
            if part is None:
                self._stop.wait(self.poll_interval)
                continue
            self._parse_part(str(resp.get("job") or DEFAULT_JOB),
                             int(part),
                             _telemetry.trace_context_from_wire(
                                 resp.get("trace")))

    def _parse_part(self, job: str, part: int,
                    ctx: Optional[Tuple[str, str]] = None) -> None:
        # the whole parse — however deep the block-cache/chunk-cache
        # machinery publishes — runs in the job's publish-owner scope,
        # so every artifact lands in the manifest with its owning-job
        # ledger entry (docs/store.md per-job budgets). The grant's
        # trace context (optional `trace` key on the next_split reply)
        # scopes the parse: every service_encode span recorded inside
        # inherits the grant's trace id, parented under the grant span —
        # one (job, part) is one trace (docs/observability.md).
        with publish_owner(job), _telemetry.trace(
                ctx[0] if ctx else None, ctx[1] if ctx else ""):
            t0 = get_time()
            try:
                self._parse_part_owned(job, part)
            finally:
                _telemetry.record_span("service_parse", t0,
                                       get_time() - t0, job=job,
                                       part=part)

    def _parse_part_owned(self, job: str, part: int) -> None:
        store = _PartStore()
        # cache the job's spec BEFORE the store entry becomes visible: a
        # client's snapshot-stream request can arrive the instant the
        # dispatcher's locate names this worker, and the serve path
        # reads the job's geometry from the cfg cache with no RPC — so
        # the cache must be populated first. A failed fetch still
        # publishes the store (with the error), so waiting clients
        # relocate instead of timing out on a missing entry.
        cfg_exc: Optional[BaseException] = None
        try:
            self._job_cfg(job)
        except (OSError, DMLCError, ValueError) as exc:
            cfg_exc = exc
        with self._cond:
            self._store[(job, part)] = store
            self.parts_parsed.append(part)
            self.parts_by_job.setdefault(job, []).append(part)
            self._cond.notify_all()
        parser = None
        warm = False
        release_claim = None
        try:
            if cfg_exc is not None:
                raise cfg_exc
            parser = self._build_parser(job, part)
            # a part whose share-by-signature block cache was already
            # published (by a sibling job over the same corpus, or by
            # this worker's previous incarnation) serves WARM: the parse
            # is avoided fleet-wide (docs/store.md share-by-signature)
            warm = getattr(parser, "cache_state", "cold") == "warm"
            if not warm:
                # single-claim the cold build fleet-wide: a sibling
                # worker mid-cold-pass over the same store signature
                # (a job registered DURING the pass) must not trigger a
                # duplicate parse — wait for its publish instead
                parser, warm, release_claim = self._claim_cold_build(
                    job, part, parser)
            while True:
                if self._stop.is_set():
                    return  # killed mid-parse: the part stays incomplete
                if self._draining.is_set():
                    # the dispatcher already re-issued this part; end the
                    # streams gracefully so clients relocate NOW instead
                    # of waiting out a dead socket (the drain ERROR is
                    # not blamed and costs clients no retry budget)
                    store.error = (f"worker {self.worker_id} draining; "
                                   f"part {part} re-issued")
                    logger.info("worker %s: abandoning part %d mid-parse "
                                "(draining)", self.worker_id, part)
                    return
                block = parser.next_block()
                if block is None:
                    break
                if self.straggle_seconds > 0:
                    # chaos harness: deterministic straggler (docstring)
                    self._stop.wait(self.straggle_seconds)
                annot = getattr(block, "resume_state", None)
                frame = encode_block_frame(block, annot)
                with self._cond:
                    store.frames.append(frame)
                    store.keys.append(
                        annot_key(annot) if annot is not None else None)
                    self._cond.notify_all()
        except Exception as exc:  # noqa: BLE001 - served to clients as ERROR
            store.error = f"{type(exc).__name__}: {exc}"
            logger.warning("worker %s: parse of job %s part %d failed: %s",
                           self.worker_id, job, part, store.error)
        finally:
            if store.error is None:
                # only CLEAN parts are measurement windows: a failed part
                # measures the failure (workers idle behind a dying
                # stream), not the tier — tuning on it would shrink the
                # width the next healthy part needs
                self._retune_parse_tier(parser)
            if store.error is None:
                self._pin_part_artifact(parser)
            cache_path = getattr(parser, "cache_file", None)
            if parser is not None:
                parser.close()
            if release_claim is not None:
                # belt and braces: a clean cold pass already dissolved
                # the claim via its publish; an errored one must not
                # strand it (the waiting sibling would burn its bound)
                release_claim()
            with self._cond:
                if (store.error is None and cache_path
                        and os.path.exists(cache_path)):
                    # the published artifact this part serves from — the
                    # v2 HELLO's co-located mmap fast-path offer
                    store.cache_path = cache_path
                store.complete = True
                self._cond.notify_all()
            if store.error is None:
                # the sharing ledger: an actual parse vs a part resolved
                # from an already-published shared artifact (the bench
                # two-job leg's shared_parse_ratio reads these)
                if warm:
                    self.parts_warm.append((job, part))
                    _resilience.record_event("service_parts_shared")
                else:
                    self.parts_cold.append((job, part))
                    _resilience.record_event("service_parts_parsed")
                # job-labeled parts-served tick for the tracker pod
                # table (docs/observability.md per-job rows)
                _telemetry.REGISTRY.counter(
                    _telemetry.SERVICE_JOB_PARTS_METRIC, job=job).inc()
            if store.error is None and not self._stop.is_set():
                # journal the completion at the dispatcher: a restarted
                # control plane then keeps the part DONE instead of
                # re-queuing it as in-flight. Best-effort — a miss is
                # healed by the reclaim handshake (the response's
                # generation stamp triggers re-attach right here when
                # the dispatcher restarted mid-parse)
                try:
                    self._request({"cmd": "part_done", "part": part,
                                   "worker": self.worker_id, "job": job})
                except (OSError, DMLCError, ValueError):
                    pass
        logger.info("worker %s: job %s part %d %s (%d blocks)",
                    self.worker_id, job, part,
                    "served warm" if warm else "parsed",
                    len(store.frames))

    def _claim_cold_build(self, job: str, part: int, parser):
        """Fleet-wide single-claim of a cold cache build (docs/store.md
        single-claim builds): claim the part's final cache path through
        the store manifest before parsing. When a DIFFERENT live owner
        already holds the claim, bounded-wait for its publish (the claim
        dissolves with it), rebuild the parser, and serve warm — the
        duplicate cold pass never runs. On timeout / builder death the
        cold pass proceeds anyway (stage_path + atomic rename converge
        on one artifact). Returns ``(parser, warm, release_fn)``."""
        path = getattr(parser, "cache_file", None)
        if not path:
            return parser, False, None
        owner = f"{os.getpid()}:{self.worker_id}"
        try:
            from dmlc_tpu_torch.store import store_for

            store = store_for(path)
        except Exception:  # noqa: BLE001 - claiming must never fail parse
            return parser, False, None

        def release():
            try:
                store.release(path, owner)
            except Exception:  # noqa: BLE001 - teardown is best-effort
                pass

        try:
            if store.claim(path, owner):
                return parser, False, release
        except Exception:  # noqa: BLE001
            return parser, False, None
        _resilience.record_event("service_parse_claim_waits")
        logger.info("worker %s: job %s part %d cold build claimed by %s; "
                    "waiting for its publish", self.worker_id, job, part,
                    store.claimant(path))
        deadline = get_time() + float(_knobs.resolve("claim_wait_deadline"))
        while (get_time() < deadline and not self._stop.is_set()
               and not self._draining.is_set()):
            try:
                if store.claimant(path) is None:
                    break  # published (or the builder died)
            except Exception:  # noqa: BLE001
                break
            self._stop.wait(0.05)
        parser.close()
        parser = self._build_parser(job, part)
        if getattr(parser, "cache_state", "cold") == "warm":
            return parser, True, None
        # builder died or timed out without publishing: take the claim
        # and run the cold pass ourselves
        try:
            if store.claim(path, owner):
                return parser, False, release
        except Exception:  # noqa: BLE001
            pass
        return parser, False, None

    def _pin_part_artifact(self, parser) -> None:
        """Hold the eviction pin on a part's published block cache for
        the worker's life (pins are dropped at close/kill; a REAL crash
        needs no drop — pins of dead pids are ignored at manifest
        replay). ``parser.close()`` releases the reader's own pin, so
        this one is what keeps the artifact resident between serves."""
        path = getattr(parser, "cache_file", None)
        if not path or not os.path.exists(path):
            return
        try:
            from dmlc_tpu_torch.store import store_for

            store_for(path).pin(path)
            self._artifact_pins.append(path)
        except Exception as exc:  # noqa: BLE001 - a pin failure must
            # never fail the part: the artifact just stays evictable
            logger.warning("worker %s: artifact pin of %s failed: %s",
                           self.worker_id, path, exc)

    def _drop_artifact_pins(self) -> None:
        pins, self._artifact_pins = self._artifact_pins, []
        for path in pins:
            try:
                from dmlc_tpu_torch.store import store_for

                store_for(path).drop(path)
            except Exception:  # noqa: BLE001 - teardown is best-effort
                pass

    def _hb_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_interval):
            # preemption notices beat liveness: an eviction window is
            # short, so the drain must start on THIS beat
            self._check_preemption()
            try:
                _dispatch.request(self.dispatcher, {
                    "cmd": "heartbeat", "worker": self.worker_id})
            except (OSError, DMLCError, ValueError):
                pass  # dispatcher gone; the split loop surfaces that

    # ---------------- serve side ----------------

    def _serve_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listen.accept()
            except OSError:
                return  # listener closed (kill/close)
            with self._conns_lock:
                self._conns.add(conn)
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def _wait_store(self, job: str, part: int, timeout: float = 5.0):
        """The store of a (job, part) whose grant may still be in flight
        (the dispatcher answered ``locate`` the instant it assigned the
        part); None when this worker does not serve it. Out-of-range
        parts of a job whose spec is already cached reject instantly —
        a burst of stale locates must not hold handler threads for the
        full wait."""
        if part < 0:
            return None
        cfg = self._job_cfgs.get(job)
        if cfg is not None and part >= int(cfg.get("num_parts") or 0):
            return None
        key = (job, part)
        with self._cond:
            ok = self._cond.wait_for(
                lambda: key in self._store or self._dead, timeout=timeout)
            return self._store.get(key) if ok else None

    def _handle(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(60.0)
            # the request file stays open for the connection's life: a
            # wire-v2 stream keeps reading pipelined fetch lines off it
            # (v1 requests still carry exactly one line)
            with conn.makefile("rb") as f:
                line = f.readline()
                req = json.loads(line) if line else {}
                cmd = req.get("cmd")
                job = str(req.get("job") or DEFAULT_JOB)
                try:
                    part = int(req.get("part", -1))
                except (TypeError, ValueError):
                    part = -1  # "part": null etc — handlers answer ERROR
                try:
                    wire = int(req.get("wire") or 1)
                except (TypeError, ValueError):
                    wire = 1
                # adopt the requester's trace context (optional `trace`
                # key — the part's grant trace, handed to the client by
                # `locate`): every service_send span this stream records
                # joins the same causal chain as the grant and parse
                ctx = _telemetry.trace_context_from_wire(req.get("trace"))
                t0 = get_time()
                with _telemetry.trace(ctx[0] if ctx else None,
                                      ctx[1] if ctx else ""):
                    if cmd == "stream":
                        if req.get("snapshot"):
                            self._serve_stream_snapshot(
                                conn, job, part, int(req.get("start", 0)))
                        elif wire >= 2:
                            self._serve_stream_v2(
                                conn, f, job, part, req.get("accept"),
                                str(req.get("host") or ""))
                        else:
                            self._serve_stream(conn, job, part,
                                               int(req.get("start", 0)))
                    elif cmd == "find":
                        self._serve_find(conn, job, part,
                                         str(req.get("key", "")))
                    elif cmd == "count":
                        self._serve_count(conn, job, part)
                    elif cmd == "trace_dump":
                        # the worker half of the merged pod timeline
                        # (docs/observability.md): span rings +
                        # decisions + a clock stamp, one JSON line
                        conn.sendall(json.dumps(
                            {"snapshot": _telemetry.component_snapshot(
                                self.worker_id)}).encode() + b"\n")
                    elif cmd == "metrics_text":
                        conn.sendall(json.dumps(
                            {"text": _telemetry.render_prometheus(),
                             "content_type": "text/plain; version=0.0.4;"
                                             " charset=utf-8"}
                        ).encode() + b"\n")
                    elif cmd == "decisions":
                        conn.sendall(json.dumps(
                            {"decisions": _telemetry.decisions_snapshot(),
                             "total": _telemetry.decisions_total()}
                        ).encode() + b"\n")
                    else:
                        send_frame(conn, encode_error_frame(
                            f"unknown request {cmd!r}"))
                    _telemetry.record_span(
                        "service_rpc", t0, get_time() - t0,
                        cmd=str(cmd or ""))
        except (OSError, ValueError):
            pass  # client went away / garbage request: nothing to serve
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _serve_stream(self, conn, job: str, part: int, start: int) -> None:
        store = self._wait_store(job, part)
        if store is None:
            send_frame(conn, encode_error_frame(
                f"worker {self.worker_id} does not serve job {job} "
                f"part {part}"))
            return
        i = max(0, int(start))
        while True:
            with self._cond:
                self._cond.wait_for(
                    lambda: i < len(store.frames) or store.complete
                    or self._dead)
                if self._dead:
                    return  # crash simulation: drop mid-stream, no goodbye
                if i < len(store.frames):
                    frame = store.frames[i]
                elif store.error is not None:
                    # mid-drain this is a GRACEFUL notice (the part was
                    # re-issued): the client relocates without blaming
                    frame = encode_error_frame(
                        store.error, draining=self._draining.is_set())
                    send_frame(conn, frame)
                    return
                else:
                    # a draining END asks the client to confirm the
                    # handoff with the dispatcher (docs/service.md)
                    send_frame(conn, encode_end_frame(
                        part, len(store.frames),
                        draining=self._draining.is_set()))
                    return
            send_frame(conn, frame)  # the sendall runs outside the lock
            i += 1

    # ---------------- wire v2 serve side ----------------

    def _negotiate_codec(self, accept) -> Optional[str]:
        """The worker's half of stream-open codec negotiation: the
        operator's mode gates what this end will do, the client's
        ``accept`` list gates what the peer can undo. None = identity."""
        from dmlc_tpu_torch.utils import knobs as _knobs

        mode = _knobs.wire_compression()
        if mode == "off":
            return None
        offered = {str(a) for a in (accept or ())}
        if mode == "auto":
            return negotiate_codec(offered)
        return mode if (mode in WIRE_CODECS and mode in offered) else None

    def _send_block_v2(self, conn, store: _PartStore, i: int,
                       frame: bytes, codec: Optional[str]) -> int:
        """Ship stored v1 frame ``i`` as a v2 frame; returns on-wire
        bytes. With a codec, the compressed form is built once per
        (codec, block) and cached on the store (None = measured
        incompressible — ship identity). The identity path rewrites only
        the header's version byte and hands the stored body to a
        vectored send untouched (:func:`reframe_v2`)."""
        if codec is not None:
            cache = store.wire_cache.setdefault(codec, {})
            v2 = cache.get(i, False)
            if v2 is False:
                _, meta, payload = decode_frame(frame)
                v2 = encode_block_frame_v2(meta, payload, codec)
                cache[i] = v2
            if v2 is not None:
                send_frame(conn, v2)
                return len(v2)
        header, body = reframe_v2(frame)
        return send_frame_vectored(conn, (header, body))

    def _serve_stream_v2(self, conn, rfile, job: str, part: int,
                         accept, client_host: str) -> None:
        """The v2 data plane: reply HELLO (negotiated codec, block count,
        co-located fast-path offer), then serve newline-JSON ``fetch``
        requests FIFO off the same socket — the client keeps
        ``service_pipeline_depth`` fetches in flight so RTT hides behind
        the outstanding window. A fetch past the end of a complete part
        answers END (every in-flight fetch gets one, so the client can
        drain its window); a fetch naming the next part on the same
        connection re-targets the stream (connection reuse when the
        located owner is unchanged). Every served data byte ticks the
        compression ledger (``service_wire_bytes_raw/sent``)."""
        store = self._wait_store(job, part)
        if store is None:
            send_frame(conn, encode_error_frame(
                f"worker {self.worker_id} does not serve job {job} "
                f"part {part}"))
            return
        codec = self._negotiate_codec(accept)
        hello: dict = {"wire": 2, "codec": codec}
        with self._cond:
            complete = store.complete and store.error is None
            blocks = len(store.frames) if complete else None
            cache_path = store.cache_path
        if blocks is not None:
            hello["blocks"] = blocks
        if (client_host and client_host == socket.gethostname()
                and complete and cache_path
                and os.path.exists(cache_path)):
            # co-located peer + published store-pinned cache: offer the
            # mmap fast path — the client maps the artifact directly and
            # skips TCP for the part (pin/byte-identity semantics ride
            # the BlockCacheReader it opens; docs/service.md Wire v2)
            hello["fastpath"] = {"path": cache_path, "blocks": blocks}
        send_frame(conn, encode_hello_frame(hello))
        raw_ctr = _telemetry.REGISTRY.counter(
            _telemetry.SERVICE_WIRE_RAW_METRIC, job=job)
        sent_ctr = _telemetry.REGISTRY.counter(
            _telemetry.SERVICE_WIRE_SENT_METRIC, job=job)
        while True:
            line = rfile.readline()
            if not line:
                return  # client closed (done, or the fast path took over)
            freq = json.loads(line)
            try:
                i = int(freq.get("block", -1))
                p = int(freq.get("part", part))
            except (TypeError, ValueError):
                send_frame(conn, encode_error_frame(
                    f"bad fetch request {line!r}"))
                return
            j = str(freq.get("job") or job)
            if (j, p) != (job, part):
                # connection reuse: the stream re-targets the next part
                # this worker serves without a reconnect
                job, part = j, p
                store = self._wait_store(job, part)
                if store is None:
                    send_frame(conn, encode_error_frame(
                        f"worker {self.worker_id} does not serve job "
                        f"{job} part {part}"))
                    return
                raw_ctr = _telemetry.REGISTRY.counter(
                    _telemetry.SERVICE_WIRE_RAW_METRIC, job=job)
                sent_ctr = _telemetry.REGISTRY.counter(
                    _telemetry.SERVICE_WIRE_SENT_METRIC, job=job)
            with self._cond:
                self._cond.wait_for(
                    lambda: i < len(store.frames) or store.complete
                    or self._dead)
                if self._dead:
                    return  # crash simulation: drop mid-stream
                if i < len(store.frames):
                    frame = store.frames[i]
                elif store.error is not None:
                    send_frame(conn, encode_error_frame(
                        store.error, draining=self._draining.is_set()))
                    return
                else:
                    # fetch past the end: END — and keep reading, the
                    # client's remaining in-flight fetches need theirs
                    send_frame(conn, encode_end_frame(
                        part, len(store.frames),
                        draining=self._draining.is_set()))
                    continue
            sent = self._send_block_v2(conn, store, i, frame, codec)
            raw_ctr.inc(len(frame))
            sent_ctr.inc(sent)

    def _pack_snapshot_frames(self, store: _PartStore,
                              geometry: dict) -> List[bytes]:
        """The part re-encoded as device-layout snapshot frames: decode
        the stored CSR block frames, pack to the job's fixed batch
        geometry, encode once, cache on the store (warm re-serves pay
        nothing). Runs under no lock — only the cached-list publish
        does.

        Contract: a snapshot frame's payload IS the device-decodable
        span — the same ``write_segments`` bytes as an on-disk snapshot
        batch, with meta array offsets payload-relative (base 0) — so a
        ``device_decode=True`` client ships the payload verbatim to the device
        and decodes it there (``ops/device_decode``). Any change to the
        frame encoding must preserve that byte-level identity."""
        from dmlc_tpu_torch.data.device import pack_dense_batches
        from dmlc_tpu_torch.service.frame import (
            block_from_frame, decode_frame, encode_snapshot_frame,
        )

        B = int(geometry["batch_size"])
        nc = int(geometry["num_col"])
        # a bfloat16 slab is a torch.bfloat16 tensor, stored under the
        # dtype string "bfloat16" (no ml_dtypes)
        dt = "bfloat16" if geometry.get("x_dtype") == "bfloat16" else None
        blocks = []
        for raw in store.frames:
            _, meta, payload = decode_frame(raw)
            blocks.append(block_from_frame(meta, payload))
        frames = []
        for packed, resume in pack_dense_batches(blocks, B, nc, dtype=dt):
            frames.append(encode_snapshot_frame(
                "dense_packed", (packed,), rows=B, resume=resume))
        return frames

    def _serve_stream_snapshot(self, conn, job: str, part: int,
                               start: int) -> None:
        """Stream a part as snapshot frames (the geometry is the JOB's —
        a bf16-wire trainer and a CSR trainer can share one fleet).
        Packing needs the whole part (fixed batches span block
        boundaries), so this waits for parse completion — the CSR stream
        stays the low-latency path; snapshot frames trade first-byte
        latency for half the wire. Each frame's payload doubles as the
        client's device-decodable span (see
        :meth:`_pack_snapshot_frames`)."""
        store = self._wait_store(job, part)
        # a (job, part) in the store implies the job's cfg was fetched
        # at grant time — the serve path never needs its own RPC
        geometry = (self._job_cfgs.get(job) or {}).get("snapshot") or {}
        if store is None or not geometry:
            send_frame(conn, encode_error_frame(
                f"worker {self.worker_id} does not serve job {job} "
                f"part {part} as snapshot frames"))
            return
        with self._cond:
            self._cond.wait_for(lambda: store.complete or self._dead)
            if self._dead:
                return
            if store.error is not None:
                # mid-drain this is a GRACEFUL notice (the part was
                # re-issued): the client relocates without blaming
                send_frame(conn, encode_error_frame(
                    store.error, draining=self._draining.is_set()))
                return
            # single-packer claim: concurrent first requests must not
            # each decode + repack the whole part — one thread packs,
            # the rest wait on the publish
            self._cond.wait_for(
                lambda: store.snap_frames is not None
                or not store.snap_packing or self._dead)
            if self._dead:
                return
            frames = store.snap_frames
            if frames is None:
                store.snap_packing = True
        if frames is None:
            # cross-job snapshot sharing (docs/service.md snapshot
            # sharing): a sibling job with the SAME geometry over the
            # same corpus signature — or a previous incarnation — may
            # already have published this pack to the DMLCSN01 store
            # tier; load + pin it instead of re-packing
            packed = self._load_shared_snapshot(store, geometry)
            if packed is not None:
                _resilience.record_event("service_parts_shared")
                logger.info("worker %s: job %s part %d snapshot served "
                            "from shared artifact", self.worker_id, job,
                            part)
            else:
                try:
                    packed = self._pack_snapshot_frames(store, geometry)
                except Exception as exc:  # noqa: BLE001 - served as ERROR
                    with self._cond:
                        store.snap_packing = False
                        self._cond.notify_all()
                    send_frame(conn, encode_error_frame(
                        f"snapshot packing failed: {exc}"))
                    return
                self._publish_shared_snapshot(store, geometry, packed,
                                              job)
            with self._cond:
                store.snap_frames = packed
                store.snap_packing = False
                self._cond.notify_all()
                frames = store.snap_frames
        for i in range(max(0, int(start)), len(frames)):
            if self._dead:
                return  # crash simulation: drop mid-stream, no goodbye
            send_frame(conn, frames[i])
        # a draining END asks the client to confirm the handoff with
        # the dispatcher, same as the CSR path (docs/service.md)
        send_frame(conn, encode_end_frame(part, len(frames),
                                          draining=self._draining.is_set()))

    def _snap_share_path(self, store: _PartStore,
                         geometry: dict) -> Optional[str]:
        """The shared on-disk home of this part's packed snapshot
        frames: the part's published (share-by-signature) block-cache
        path + a geometry digest. Sibling jobs over the same corpus
        signature with the same geometry resolve the SAME path, so the
        pack happens once fleet-wide; a job with a private cache still
        shares with its own later incarnations. None when the part has
        no published cache (nothing durable to key on)."""
        cache_path = store.cache_path
        if not cache_path or not geometry:
            return None
        from dmlc_tpu_torch.store import signature_hash

        return f"{cache_path}.g{signature_hash(geometry)}.snap"

    def _load_shared_snapshot(self, store: _PartStore,
                              geometry: dict) -> Optional[List[bytes]]:
        """A previously-published shared snapshot pack for this part +
        geometry, pinned against either tenant's eviction pressure; None
        on miss/corruption (the caller packs locally)."""
        path = self._snap_share_path(store, geometry)
        if not path or not os.path.exists(path):
            return None
        try:
            with open(path, "rb") as f:
                frames = _decode_snap_container(f.read())
        except OSError:
            return None
        if frames is None:
            return None
        try:
            from dmlc_tpu_torch.store import store_for

            store_for(path).pin(path)
            self._artifact_pins.append(path)
        except Exception:  # noqa: BLE001 - a pin failure must never
            pass           # fail the serve; the artifact stays evictable
        return frames

    def _publish_shared_snapshot(self, store: _PartStore, geometry: dict,
                                 frames: List[bytes], job: str) -> None:
        """Publish this part's packed snapshot frames to the DMLCSN01
        store tier (atomic stage + rename — concurrent packers converge
        on one artifact) and pin it for this worker's life. Best-effort:
        a store failure costs only the sharing, never the stream."""
        path = self._snap_share_path(store, geometry)
        if not path:
            return
        try:
            from dmlc_tpu_torch.store import store_for

            st = store_for(path)
            tmp = st.stage_path(path)
            with open(tmp, "wb") as f:
                f.write(_encode_snap_container(frames))
            st.publish_file(
                tmp, path, "snapshot",
                signature={"cache": os.path.basename(store.cache_path),
                           "geometry": geometry},
                job=job)
            st.pin(path)
            self._artifact_pins.append(path)
        except Exception as exc:  # noqa: BLE001 - sharing is an
            # optimization; the local pack already serves this client
            logger.warning("worker %s: shared snapshot publish of %s "
                           "failed: %s", self.worker_id, path, exc)

    def _serve_find(self, conn, job: str, part: int, key: str) -> None:
        """Block index whose resume annotation matches ``key`` — the
        remote half of restoring a parser-chain checkpoint into a fresh
        service client. Scans incrementally so a match early in a part
        still being parsed answers without waiting for completion."""
        store = self._wait_store(job, part)
        found = -1
        interrupted = error = None
        if store is not None:
            i = 0
            with self._cond:
                while True:
                    while i < len(store.keys):
                        if store.keys[i] == key:
                            found = i
                            break
                        i += 1
                    if found >= 0 or store.complete or self._dead:
                        interrupted = self._dead and not store.complete
                        error = store.error
                        break
                    self._cond.wait()
        if found < 0 and (error or interrupted or store is None):
            # a partial scan must not read as an authoritative miss
            resp = {"block": -1,
                    "error": error or f"part {part} not fully served"}
        else:
            resp = {"block": found}
        conn.sendall(json.dumps(resp).encode() + b"\n")

    def _serve_count(self, conn, job: str, part: int) -> None:
        store = self._wait_store(job, part)
        if store is None:
            conn.sendall(json.dumps(
                {"error": f"part {part} not served"}).encode() + b"\n")
            return
        with self._cond:
            self._cond.wait_for(lambda: store.complete or self._dead)
            n = len(store.frames)
            partial = store.error or not store.complete
            error = store.error
        if partial:
            # a truncated count is worse than no count: the client maps
            # delivered-block offsets onto part boundaries with it
            resp = {"error": error or f"part {part} count interrupted"}
        else:
            resp = {"blocks": n}
        conn.sendall(json.dumps(resp).encode() + b"\n")

    # ---------------- lifecycle ----------------

    @property
    def alive(self) -> bool:
        """True while this worker serves: neither killed/closed nor
        drained out."""
        return not self._stop.is_set() and not self.drained

    @property
    def draining(self) -> bool:
        """True once a graceful drain has begun: still serving its
        frame-store-complete parts, but no longer grant-eligible — so
        NOT live capacity (the autoscaler must not count or re-drain
        it)."""
        return self._draining.is_set()

    def _teardown(self) -> None:
        self._stop.set()
        # release artifact pins: close() is a graceful exit, and kill()
        # emulates a dead pid (whose journaled pins replay as ignored) —
        # in-process the explicit drop is the faithful equivalent
        self._drop_artifact_pins()
        with self._cond:
            self._cond.notify_all()
        try:
            self._listen.close()
        except OSError:
            pass
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass

    def kill(self) -> None:
        """Simulate a crash: every socket drops mid-whatever, the frame
        store is abandoned, and NOBODY is notified — the dispatcher
        learns from client ``report_lost`` / stale heartbeats."""
        self._dead = True
        self._teardown()
        if self._tracker_client is not None:
            # a dead process sends no shutdown; just stop local threads
            self._tracker_client.stop_heartbeat()
            self._tracker_client.close()
            self._tracker_client = None

    def close(self) -> None:
        """Graceful shutdown (end of job)."""
        self._dead = True
        self._teardown()
        if self._tracker_client is not None:
            try:
                if self.rank >= 0:
                    self._tracker_client.shutdown()
                else:
                    self._tracker_client.close()
            except (OSError, AssertionError):
                self._tracker_client.close()
            self._tracker_client = None
