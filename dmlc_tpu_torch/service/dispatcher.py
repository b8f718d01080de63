"""Data-service dispatcher: multi-job split assignment + worker registry.

The port's copy of the JAX package's ``service/dispatcher.py``, with its wire,
JSON, journal records, counters, messages and its fault-plan seam (the
``dispatch_rpc`` op in :func:`request`).

The control plane of the disaggregated RowBlock service (tf.data
service's dispatcher role, arXiv:2210.14826 §3): it owns a registry of
**jobs** — each a dataset URI, its partition count, and the parser
config every worker must use for it — and hands each job's ``num_parts``
:class:`~dmlc_tpu_torch.io.input_split.InputSplit` partitions to parse workers
**exactly once per epoch**, rotating grants round-robin across jobs with
pending work so one greedy job can never starve another (per-job
fairness; docs/service.md multi-tenant service). A split is re-issued
only when its owner is declared dead (a client reported a broken stream,
or heartbeats went stale), and re-issued splits jump their job's queue so
a mid-stream failover heals before new work starts.

One dispatcher, MANY trainers: the constructor's ``uri``/``num_parts``
register the backward-compatible ``default`` job, and ``register_job``
(RPC or :meth:`Dispatcher.register_job`) adds more at any point — each
with its own parser config, epoch-plan identity, and snapshot geometry.
With ``share_dir=`` set, jobs that do not pin their own ``block_cache``
are assigned one keyed by the job's **store signature** (a digest of
``uri + num_parts + parser config``): two jobs over the same corpus with
the same config resolve to the SAME published ``DMLCBC01`` artifacts
through the store manifest, so the fleet parses that corpus
exactly once — the second job's parts serve warm (docs/store.md
share-by-signature).

Protocol: one JSON object per connection (newline-terminated request,
newline-terminated response — the same short-lived-connection shape the
rabit tracker uses for ``heartbeat``/``metrics``). Commands (``job``
defaults to ``"default"`` wherever it appears, so the one-dataset
protocol is a strict subset):

``config [job]``                -> the job's dataset spec
``register_job job uri num_parts [parser plan snapshot]``
                                -> add a job to the registry (idempotent
                                   for an identical spec; a conflicting
                                   spec for an existing job is refused —
                                   job identity is immutable)
``register worker host port``   -> join the fleet (re-registration of a
                                   worker already seen alive THIS
                                   generation is treated as a crash-
                                   restart: its parts re-queue at the
                                   front until a ``reclaim`` adopts them
                                   back). A brand-new worker id arriving
                                   after work has started is a **live
                                   join** (journaled ``join`` event,
                                   ``worker_joins`` counter): it enters
                                   the grant rotation immediately
``drain worker [deadline]``     -> begin a graceful drain: no new grants,
                                   unstarted parts re-issue at the front
                                   immediately, frame-store-complete
                                   parts keep serving until clients
                                   confirm ``handoff`` or the drain
                                   deadline expires (docs/service.md
                                   elastic membership)
``handoff worker part [job]``   -> a client confirms it finished
                                   streaming ``part`` from the draining
                                   ``worker``; when every served part is
                                   confirmed the drain completes early
``next_split worker``           -> ``{"part": k, "job": j}`` |
                                   ``{"part": null}`` (nothing to do) —
                                   doubles as liveness
``heartbeat worker``            -> liveness only
``locate part [job]``           -> ``{"worker", "host", "port"}`` of the
                                   live owner, or ``{"wait": true}`` while
                                   the part awaits (re)assignment
``report_lost worker``          -> a client observed the worker dead: all
                                   its parts (every job) re-queue at the
                                   FRONT
``part_done part worker [job]`` -> the owner finished parsing the part
                                   (journaled: a restarted dispatcher
                                   keeps it done instead of re-issuing)
``reclaim worker parts``        -> the worker re-announces the fully-
                                   parsed parts its frame store still
                                   holds (a flat list for the default
                                   job, or ``{job: [parts]}``): a
                                   restarted dispatcher ADOPTS them (no
                                   fleet-wide re-parse), and journal-
                                   complete parts the worker no longer
                                   holds re-queue
``status``                      -> registry snapshot (tests, operators);
                                   legacy top-level assignment fields
                                   mirror the default job, ``jobs``
                                   carries every job's state

Every response is stamped with the dispatcher's monotonic ``gen``
generation token, so workers and clients detect a restart at their next
control exchange (docs/service.md control-plane recovery).

**Crash recovery**: with ``journal_path=`` set, every state transition —
job registration, worker register/death, part grant / complete /
re-issue / reclaim — is appended to a flock'd JSONL journal (the shared
:class:`~dmlc_tpu_torch.store.journal.AppendJournal` substrate: torn-tail skip
at replay, atomic compaction). Events are job-scoped (``job`` rides
every assignment event of a non-default job; default-job events keep
the exact one-dataset shapes, so older journals replay unchanged). A
restarted ``Dispatcher(journal_path=...)`` replays into the exact
per-job assignment state: **completed parts stay done** (their owners
get a liveness grace window to re-attach), **in-flight parts re-queue
at the front**, registered jobs come back with their full spec, and the
generation token bumps so the fleet re-registers and reclaims. A journal
that records a DIFFERENT dataset than the constructor supplies is a
**fatal, non-retryable configuration error**
(:class:`ServiceConfigError`): recovery must never silently serve the
wrong corpus, and retrying cannot fix a disagreement between the journal
on disk and the code constructing the dispatcher. The journal records no
epoch state by design: epochs live with clients and worker frame stores
(``before_first`` re-serves without dispatcher involvement), so the
assignment journal is epoch-invariant.

**Worker lifecycle** (docs/service.md elastic membership): every worker
walks JOINING -> ACTIVE -> DRAINING -> DEAD. ``JOINING`` is a
journal-restored worker awaiting its re-attach handshake (it keeps
serving completed parts but gets no grants); ``register`` makes it
``ACTIVE`` (grant rotation); a ``drain`` request makes it ``DRAINING``
(no new grants, unstarted parts proactively re-issued, completed parts
keep serving until ``handoff``-confirmed or the drain deadline — clients
learn re-assignments from ``moved``/``draining`` hints on ``locate``, so
failover happens before the socket dies); ``DEAD`` is terminal (stale
heartbeats, ``report_lost``, or a completed drain). Transitions journal,
so membership state survives dispatcher restarts.

**Straggler hedging**: the dispatcher tracks per-job, per-part
grant->complete latency; once at least :data:`HEDGE_MIN_SAMPLES` parts
of a job have completed, an in-flight part stuck past
``DMLC_TPU_HEDGE_FACTOR`` times that job's median (and past
:data:`HEDGE_MIN_AGE_S`) is **speculatively re-issued** to a second
active worker (journaled ``spec_grant``, ``speculative_reissues``).
First ``part_done`` wins — a win by the speculative worker counts
``speculative_wins`` and flips ``locate`` to the winner; the loser's
completion is deduped (exactly-once preserved: parsing is
deterministic, so either stream is byte-identical). Medians are per job
so a slow-corpus job can never poison a fast job's hedge threshold.

A background **reaper tick thread** (interval derived from
``liveness_timeout``) drives liveness, drain deadlines, and the hedging
check on wall-clock time, so a quiet fleet — no poll or heartbeat
traffic at all — still reaps dead workers, expires drains, and hedges
stragglers.

The dispatcher is deliberately dataset-state-free about *blocks*: block
ordering, resume, and exactly-once delivery live with the client (global
order is part-major per job), so the dispatcher never becomes a
data-plane bottleneck — it serves O(jobs × (workers + failovers)) tiny
requests per epoch. Concurrent connection handlers are capped
(``DMLC_TPU_DISPATCH_WORKERS`` via the knob table); excess connections
shed with a retryable ``busy`` reply, so a reconnect storm from a
recovering fleet cannot exhaust threads exactly when the dispatcher must
stay responsive.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import statistics
import threading
from collections import deque
from typing import Deque, Dict, List, Optional, Set, Tuple, Union

from dmlc_tpu_torch.io import faults as _faults
from dmlc_tpu_torch.io import resilience as _resilience
from dmlc_tpu_torch.store import journal as _journal_mod
from dmlc_tpu_torch.store.journal import AppendJournal
from dmlc_tpu_torch.store.manager import signature_hash
from dmlc_tpu_torch.utils import knobs as _knobs
from dmlc_tpu_torch.utils import telemetry as _telemetry
from dmlc_tpu_torch.utils.check import DMLCError, check
from dmlc_tpu_torch.utils.timer import get_time

logger = logging.getLogger("dmlc_tpu_torch.service")

# per-address clock-offset estimates (peer monotonic clock minus ours),
# fed by every `request()` round trip whose reply carries a `now` stamp:
# offset = peer_now - (t_send + t_recv) / 2, EWMA-smoothed so one
# GC-paused round trip cannot skew a whole timeline. Consumed by
# LocalFleet.dump_trace to place every peer's spans on ONE clock
# (docs/observability.md Distributed tracing).
_CLOCK_OFFSETS: Dict[str, float] = {}
_CLOCK_OFFSETS_LOCK = threading.Lock()
_CLOCK_OFFSET_ALPHA = 0.3


def _note_clock_offset(address: str, offset: float) -> None:
    with _CLOCK_OFFSETS_LOCK:
        prev = _CLOCK_OFFSETS.get(address)
        _CLOCK_OFFSETS[address] = (
            offset if prev is None
            else prev + _CLOCK_OFFSET_ALPHA * (offset - prev))


def peer_clock_offset(address: str) -> Optional[float]:
    """Latest clock-offset estimate (seconds to ADD to ``address``'s
    monotonic timestamps to land on this process's clock), or None when
    no stamped reply from that address has been seen yet."""
    with _CLOCK_OFFSETS_LOCK:
        return _CLOCK_OFFSETS.get(address)

# the job the one-dataset constructor/protocol maps onto:
# requests without a `job` field, journal events without one, and the
# legacy reply shapes all refer to this job
DEFAULT_JOB = "default"

# journal compaction threshold: past this many lines at replay the
# journal is rewritten as the live state (jobs + start + registers +
# grant/complete pairs). Assignment journals are naturally small —
# O(jobs × parts + workers + failovers), epochs append nothing — so this
# only triggers after many restart cycles.
JOURNAL_COMPACT_LINES = 4096

# worker lifecycle states (docs/service.md elastic membership)
JOINING = "joining"      # journal-restored, awaiting register+reclaim
ACTIVE = "active"        # in the grant rotation
DRAINING = "draining"    # no new grants; serving until handoff/deadline
DEAD = "dead"            # terminal

# straggler hedging guards: never hedge before this many completion
# latency samples exist for the part's JOB (a 2-part dataset can never
# produce a meaningful median), and never hedge a part younger than this
# wall-clock floor — hedging targets seconds-scale stalls, and the floor
# must sit well above any plausible healthy-part latency (a loaded CI
# host pausing a smoke-scale part for a second must not fire a
# speculative parse, or the bench-smoke zero gate on
# `speculative_reissues` turns flaky)
HEDGE_MIN_SAMPLES = 3
HEDGE_MIN_AGE_S = 5.0
# completion-latency window each job's hedging median is computed over
HEDGE_LATENCY_WINDOW = 64


class ServiceConfigError(DMLCError):
    """Fatal service-configuration disagreement: the assignment journal
    (or the live job registry) records a dataset identity that
    contradicts what the caller supplies. Deliberately NOT retryable —
    :func:`dmlc_tpu_torch.io.resilience.classify` reads it as ``fatal``
    (no transient cause is chained on), because re-attempting cannot
    reconcile a journal on disk with conflicting constructor arguments;
    the operator must either point the dispatcher at the dataset the
    journal records or at a fresh ``journal_path``."""


class _WorkerInfo:
    __slots__ = ("worker", "host", "port", "last_seen", "state",
                 "registered_gen", "drain_deadline", "handed_off",
                 "drained")

    def __init__(self, worker: str, host: str, port: int, now: float,
                 registered_gen: Optional[int] = None,
                 state: Optional[str] = None):
        self.worker = worker
        self.host = host
        self.port = port
        self.last_seen = now
        # the generation this worker last sent `register` in; None for a
        # worker restored from the journal that has not re-attached yet
        # (its frame-store contents are unknown until it reclaims)
        self.registered_gen = registered_gen
        # lifecycle: a journal-restored worker is JOINING until its
        # re-attach handshake lands; a registered one is ACTIVE
        self.state = state or (ACTIVE if registered_gen is not None
                               else JOINING)
        self.drain_deadline: Optional[float] = None
        # (job, part) pairs clients confirmed streaming from a drainer
        self.handed_off: Set[Tuple[str, int]] = set()
        # True only for a worker whose DRAIN completed (handoffs
        # confirmed or deadline expired): its next poll reads `drained`
        # and exits instead of re-attaching as a zombie
        self.drained = False

    @property
    def alive(self) -> bool:
        return self.state != DEAD


class _JobState:
    """One registered job: its immutable dataset spec plus the mutable
    assignment state (FCFS queue, grants, completions, hedging books)
    the dispatcher serves it from."""

    __slots__ = ("job", "uri", "num_parts", "parser", "plan", "snapshot",
                 "share_sig", "todo", "assigned", "completed",
                 "clients_active", "grant_times", "latencies", "spec",
                 "spec_times", "hedge_todo", "priority", "weight",
                 "slo_wait_frac", "max_inflight", "deficit", "traces")

    def __init__(self, job: str, uri: str, num_parts: int,
                 parser: Optional[dict] = None,
                 plan: Optional[dict] = None,
                 snapshot: Optional[dict] = None,
                 share_sig: Optional[str] = None,
                 priority: int = 0, weight: int = 1,
                 slo_wait_frac: Optional[float] = None,
                 max_inflight: Optional[int] = None):
        self.job = str(job)
        self.uri = uri
        self.num_parts = int(num_parts)
        self.parser = dict(parser or {})
        # the epoch-plan identity of the job (shuffle_seed /
        # shuffle_window, dmlc_tpu_torch/data/epoch.py): shipped in `config` so
        # every worker arms its block cache with the SAME plan and every
        # client learns the seed its epochs are a function of — the one
        # place each job's shuffle is decided (docs/service.md)
        self.plan = dict(plan or {})
        # snapshot-frame geometry ({batch_size, num_col, x_dtype}): when
        # set, workers ALSO pack this job's parts into fixed-geometry
        # device-layout batches (dmlc_tpu_torch/io/snapshot.py encoding) and
        # clients stream those instead of CSR blocks — per job, so a
        # bf16-wire trainer and a CSR trainer can share one fleet
        self.snapshot = dict(snapshot or {})
        # the job's store signature when share-by-signature resolved its
        # block cache (None for jobs that pinned their own or share_dir
        # is off) — surfaced in status for operators/tests
        self.share_sig = share_sig
        # FCFS visitation queue: parts not yet assigned this epoch.
        # Re-issued parts (dead owner) go to the FRONT so failover work
        # heals before fresh parts are handed out.
        self.todo: Deque[int] = deque(range(self.num_parts))
        self.assigned: Dict[int, str] = {}   # part -> worker id
        self.completed: Set[int] = set()     # parts whose parse finished
        # True once a client has located a part of this job: a brand-new
        # worker id registering after any job saw a client is a
        # mid-epoch LIVE JOIN (worker_joins)
        self.clients_active = False
        # per-part grant timestamps (in-flight ages) and this job's
        # recent grant->complete latencies (the hedging median)
        self.grant_times: Dict[int, float] = {}
        self.latencies: Deque[float] = deque(maxlen=HEDGE_LATENCY_WINDOW)
        # part -> second (speculative) owner; the primary stays in
        # `assigned` until one of them completes (first part_done wins)
        self.spec: Dict[int, str] = {}
        self.spec_times: Dict[int, float] = {}
        # parts flagged for speculative re-issue, awaiting a poll from a
        # worker that is not the stuck primary
        self.hedge_todo: Deque[int] = deque()
        # --- QoS class (docs/service.md Production QoS) ---
        # priority band: higher bands fully preempt lower ones in the
        # grant rotation; weight shapes the deficit-round-robin share
        # WITHIN a band; slo_wait_frac is the job's input-wait SLO target
        # the autoscaler steers toward; max_inflight bounds this job's
        # granted-not-completed parts (admission control). All four are
        # part of the immutable job identity and journal with the spec.
        self.priority = int(priority)
        self.weight = int(weight)
        self.slo_wait_frac = (None if slo_wait_frac is None
                              else float(slo_wait_frac))
        self.max_inflight = (None if max_inflight is None
                             else int(max_inflight))
        # DRR running credit: replenished by `weight` when the band's
        # eligible set runs dry, spent 1.0 per grant. Scheduler state,
        # not identity — rebuilt implicitly across restarts (grants
        # already journal; credit restarts at 0 for everyone, which
        # preserves relative shares).
        self.deficit = 0.0
        # part -> (trace_id, root span_id): the trace each in-flight
        # part's grant opened. Grant replies and locate replies hand the
        # SAME context to the worker and the client, so one (job, part)
        # is one trace from next_split to device_put. Observability
        # state, not identity — never journaled, dies with a restart.
        self.traces: Dict[int, Tuple[str, str]] = {}

    def qos_dict(self) -> dict:
        """The job's QoS class as a wire/journal sub-dict (only the
        non-default knobs — the default job's flat one-dataset shape stays
        byte-compatible when nothing was asked for)."""
        qos: dict = {"priority": self.priority, "weight": self.weight}
        if self.slo_wait_frac is not None:
            qos["slo_wait_frac"] = self.slo_wait_frac
        if self.max_inflight is not None:
            qos["max_inflight"] = self.max_inflight
        return qos

    def inflight(self) -> int:
        """Granted-not-completed parts charged to this job's admission
        budget (primary grants only — a hedge duplicates work already
        admitted, it is not a new admission)."""
        return len(self.grant_times)

    def default_qos(self) -> bool:
        """True when no QoS knob was asked for — such jobs keep the
        pre-QoS wire/journal shape byte-compatible."""
        return (self.priority == 0 and self.weight == 1
                and self.slo_wait_frac is None
                and self.max_inflight is None)

    def spec_dict(self) -> dict:
        """The wire-shape dataset spec (`config` reply sans job key).
        ``wire`` advertises the fleet's newest data-plane protocol
        (docs/service.md Wire v2) — informational: the binding
        negotiation happens per stream at open, so mixed fleets and old
        peers interoperate regardless of what this says."""
        spec = {"uri": self.uri, "num_parts": self.num_parts,
                "parser": self.parser, "plan": self.plan,
                "snapshot": self.snapshot, "wire": 2}
        if not self.default_qos():
            spec["qos"] = self.qos_dict()
        return spec


class Dispatcher:
    """Split-assignment server for N registered jobs.

    The constructor's ``uri``/``num_parts``/``parser``/``plan``/
    ``snapshot`` register the ``default`` job (the one-dataset
    protocol is a strict subset of the multi-tenant one); more jobs
    arrive via :meth:`register_job` / the ``register_job`` RPC. ``uri``
    may be None for a dispatcher born empty (jobs registered later).

    ``parser`` is the config dict every worker builds its parser from
    (``format``/``type_``, ``chunk_bytes``, ``threaded``, ... — the
    kwargs of :func:`dmlc_tpu_torch.data.parsers.create_parser`); shipping it
    from one place is what makes N workers' output byte-identical to a
    local parse with the same config. ``liveness_timeout`` (seconds)
    declares a worker dead when its polls/heartbeats go stale; client
    ``report_lost`` reports short-circuit that wait.

    ``share_dir`` arms cross-job artifact sharing: a registering job
    whose parser config carries no ``block_cache`` is assigned one at
    ``share_dir/svc-<signature>.bc`` where the signature digests the
    job's dataset identity (uri + num_parts + parser config), so jobs
    over the same corpus with the same config converge on the same
    published ``DMLCBC01`` artifacts and the fleet parses that corpus
    exactly once (docs/store.md share-by-signature).

    ``journal_path`` arms crash recovery: state transitions journal to
    an append-only JSONL file and a restart on the same address replays
    them (see the module docstring). Without it the dispatcher is the
    historical in-memory-only control plane (generation fixed at 1).
    """

    def __init__(self, uri: Optional[str] = None, num_parts: int = 0,
                 parser: Optional[dict] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 liveness_timeout: float = 10.0,
                 plan: Optional[dict] = None,
                 snapshot: Optional[dict] = None,
                 journal_path: Optional[str] = None,
                 journal_compact_lines: int = JOURNAL_COMPACT_LINES,
                 share_dir: Optional[str] = None):
        self.liveness_timeout = float(liveness_timeout)
        self.share_dir = share_dir
        if share_dir:
            os.makedirs(share_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._workers: Dict[str, _WorkerInfo] = {}
        # the job registry, insertion-ordered (the grant rotation walks
        # it round-robin); the constructor's dataset is the default job
        self._jobs: Dict[str, _JobState] = {}
        self._rr = 0  # grant-rotation cursor over the job order
        if uri is not None:
            check(int(num_parts) >= 1,
                  f"Dispatcher: num_parts {num_parts} must be >= 1 for "
                  f"dataset {uri!r}")
            self._jobs[DEFAULT_JOB] = self._make_job(
                DEFAULT_JOB, uri, int(num_parts), parser, plan, snapshot)
        self._hedge_factor = _knobs.resolve("hedge_factor")
        self._drain_deadline_s = float(_knobs.resolve("drain_deadline"))
        self.generation = 1
        self._journal: Optional[AppendJournal] = None
        if journal_path:
            self._journal = AppendJournal(journal_path)
            self._recover(int(journal_compact_lines))
        # connection-handler cap (knob table; docs/service.md): excess
        # connections shed with a retryable `busy` reply instead of
        # spawning an unbounded thread per connection — a reconnect storm
        # from a recovering fleet must not exhaust threads exactly when
        # the control plane needs to stay responsive
        self._handler_slots = threading.Semaphore(
            _knobs.resolve("dispatch_workers"))
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(128)
        self.host, self.port = self._sock.getsockname()[:2]
        # in-flight handler connections, force-closed at close()/kill():
        # a dead process's sockets drop with it, and a restart must be
        # able to rebind the SAME port immediately (lingering accepted
        # sockets without SO_REUSEADDR would hold it)
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self._closed = False
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="service-dispatcher")
        self._thread.start()
        # background reaper tick: liveness used to be checked only inside
        # RPC handling, so a QUIET fleet (no poll/heartbeat traffic at
        # all) never reaped a dead worker. The tick makes liveness, drain
        # deadlines, and the straggler-hedging check wall-clock-driven;
        # interval derives from liveness_timeout (several checks per
        # window) with a floor so drain/hedge stay responsive even when
        # liveness detection is disabled (liveness_timeout <= 0).
        if self.liveness_timeout > 0:
            tick = min(max(self.liveness_timeout / 4.0, 0.05), 2.0)
        else:
            tick = 0.25
        self._tick_interval = tick
        self._tick_stop = threading.Event()
        self._tick_thread = threading.Thread(
            target=self._tick_loop, daemon=True,
            name="service-dispatcher-tick")
        self._tick_thread.start()
        logger.info("dispatcher (%d job(s): %s) on %s:%d gen %d",
                    len(self._jobs),
                    ", ".join(f"{j.job}={j.uri}({j.num_parts})"
                              for j in self._jobs.values()) or "none",
                    self.host, self.port, self.generation)

    # ---------------- default-job compatibility views ----------------

    def _default(self) -> Optional[_JobState]:
        return self._jobs.get(DEFAULT_JOB)

    @property
    def uri(self) -> Optional[str]:
        job = self._default()
        return job.uri if job is not None else None

    @property
    def num_parts(self) -> int:
        job = self._default()
        return job.num_parts if job is not None else 0

    @property
    def parser(self) -> dict:
        job = self._default()
        return job.parser if job is not None else {}

    @property
    def plan(self) -> dict:
        job = self._default()
        return job.plan if job is not None else {}

    @property
    def snapshot(self) -> dict:
        job = self._default()
        return job.snapshot if job is not None else {}

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    @property
    def jobs(self) -> List[str]:
        """Registered job names, grant-rotation order."""
        with self._lock:
            return list(self._jobs)

    def job_qos(self) -> Dict[str, dict]:
        """Every registered job's QoS class ({job: {priority, weight
        [, slo_wait_frac][, max_inflight]}}) — the FleetAutoscaler's
        SLO/priority input (docs/service.md Production QoS)."""
        with self._lock:
            return {name: j.qos_dict() for name, j in self._jobs.items()}

    # ---------------- job registry ----------------

    def _make_job(self, job: str, uri: str, num_parts: int,
                  parser: Optional[dict], plan: Optional[dict],
                  snapshot: Optional[dict],
                  share_sig: Optional[str] = None,
                  qos: Optional[dict] = None) -> _JobState:
        """Build a _JobState, resolving the share-by-signature block
        cache when armed: a job without its own ``block_cache`` gets one
        keyed by its dataset identity, so identical jobs converge on the
        same published artifacts (store manifest sharing)."""
        cfg = dict(parser or {})
        if self.share_dir and not cfg.get("block_cache"):
            share_sig = signature_hash(
                {"uri": uri, "num_parts": int(num_parts), "parser": cfg})
            cfg["block_cache"] = os.path.join(self.share_dir,
                                              f"svc-{share_sig}.bc")
        qos = dict(qos or {})
        return _JobState(job, uri, num_parts, cfg, plan, snapshot,
                         share_sig=share_sig,
                         priority=qos.get("priority", 0),
                         weight=qos.get("weight", 1),
                         slo_wait_frac=qos.get("slo_wait_frac"),
                         max_inflight=qos.get("max_inflight"))

    @staticmethod
    def _validate_qos(job: str, req: dict) -> Union[dict, str]:
        """Normalize the QoS knobs of a registration request into a qos
        sub-dict, or return an error string. Loud validation: a typo'd
        class must fail the registration, not silently round-robin."""
        qos = dict(req.get("qos") or {})
        for key in ("priority", "weight", "slo_wait_frac", "max_inflight"):
            if req.get(key) is not None:
                qos[key] = req[key]
        try:
            priority = int(qos.get("priority", 0))
        except (TypeError, ValueError):
            return (f"register_job {job!r}: priority "
                    f"{qos.get('priority')!r} is not an integer")
        if priority < 0:
            return (f"register_job {job!r}: priority {priority} must be "
                    f">= 0 (higher bands preempt lower)")
        try:
            weight = int(qos.get("weight", 1))
        except (TypeError, ValueError):
            return (f"register_job {job!r}: weight "
                    f"{qos.get('weight')!r} is not an integer")
        if weight < 1:
            return (f"register_job {job!r}: weight {weight} must be >= 1 "
                    f"(the DRR share within the priority band)")
        out = {"priority": priority, "weight": weight}
        if qos.get("slo_wait_frac") is not None:
            try:
                slo = float(qos["slo_wait_frac"])
            except (TypeError, ValueError):
                return (f"register_job {job!r}: slo_wait_frac "
                        f"{qos.get('slo_wait_frac')!r} is not a number")
            if not (0.0 < slo <= 1.0):
                return (f"register_job {job!r}: slo_wait_frac {slo} must "
                        f"be in (0, 1] — the input-wait fraction the "
                        f"autoscaler keeps the job under")
            out["slo_wait_frac"] = slo
        if qos.get("max_inflight") is not None:
            try:
                max_inflight = int(qos["max_inflight"])
            except (TypeError, ValueError):
                return (f"register_job {job!r}: max_inflight "
                        f"{qos.get('max_inflight')!r} is not an integer")
            if max_inflight < 1:
                return (f"register_job {job!r}: max_inflight "
                        f"{max_inflight} must be >= 1 (admission budget "
                        f"of granted-not-completed parts)")
            out["max_inflight"] = max_inflight
        return out

    def register_job(self, job: str, uri: str, num_parts: int,
                     parser: Optional[dict] = None,
                     plan: Optional[dict] = None,
                     snapshot: Optional[dict] = None,
                     priority: Optional[int] = None,
                     weight: Optional[int] = None,
                     slo_wait_frac: Optional[float] = None,
                     max_inflight: Optional[int] = None) -> dict:
        """In-process job registration (the RPC's twin — LocalFleet and
        tests use it directly). Returns the registered spec reply;
        raises :class:`ServiceConfigError` when ``job`` exists with a
        conflicting spec (job identity is immutable). ``priority`` /
        ``weight`` / ``slo_wait_frac`` / ``max_inflight`` are the job's
        QoS class (docs/service.md Production QoS) — part of the
        immutable identity."""
        with self._lock:
            resp = self._register_job_locked({
                "job": job, "uri": uri, "num_parts": num_parts,
                "parser": parser, "plan": plan, "snapshot": snapshot,
                "priority": priority, "weight": weight,
                "slo_wait_frac": slo_wait_frac,
                "max_inflight": max_inflight})
        if "error" in resp:
            raise ServiceConfigError(resp["error"])
        return resp

    def _register_job_locked(self, req: dict) -> dict:
        job = str(req.get("job") or "")
        uri = req.get("uri")
        if not job:
            return {"error": "register_job: empty job name"}
        if not uri:
            return {"error": f"register_job {job!r}: a dataset uri is "
                             f"required"}
        try:
            num_parts = int(req.get("num_parts", 0))
        except (TypeError, ValueError):
            return {"error": f"register_job {job!r}: num_parts "
                             f"{req.get('num_parts')!r} is not an integer"}
        if num_parts < 1:
            return {"error": f"register_job {job!r}: num_parts "
                             f"{num_parts} must be >= 1"}
        qos = self._validate_qos(job, req)
        if isinstance(qos, str):
            return {"error": qos}
        state = self._make_job(job, str(uri), num_parts,
                               dict(req.get("parser") or {}),
                               dict(req.get("plan") or {}),
                               dict(req.get("snapshot") or {}),
                               qos=qos)
        prev = self._jobs.get(job)
        if prev is not None:
            if (prev.uri == state.uri
                    and prev.num_parts == state.num_parts
                    and prev.parser == state.parser
                    and prev.plan == state.plan
                    and prev.snapshot == state.snapshot
                    and prev.qos_dict() == state.qos_dict()):
                # idempotent re-registration (a trainer restarting its
                # client re-binds to the live job state)
                return dict(prev.spec_dict(), job=job, ok=True,
                            existing=True, share_sig=prev.share_sig)
            return {"error":
                    f"register_job {job!r}: job already registered with "
                    f"a different spec (have uri={prev.uri!r} "
                    f"num_parts={prev.num_parts} parser={prev.parser} "
                    f"qos={prev.qos_dict()}; "
                    f"got uri={state.uri!r} num_parts={state.num_parts} "
                    f"parser={state.parser} qos={state.qos_dict()}) — "
                    f"job identity is "
                    f"immutable; register the new dataset under a new "
                    f"job name"}
        self._jobs[job] = state
        self._journal_append(self._job_event(state), sync=True)
        logger.info("dispatcher: registered job %s -> %s (%d parts%s)",
                    job, state.uri, state.num_parts,
                    f", shared sig {state.share_sig}"
                    if state.share_sig else "")
        return dict(state.spec_dict(), job=job, ok=True, existing=False,
                    share_sig=state.share_sig)

    @staticmethod
    def _job_event(state: _JobState) -> dict:
        """The journal record of one job registration. The default job
        keeps the exact one-dataset `dataset` shape (uri + num_parts only —
        its full spec re-arrives with the constructor at restart);
        non-default jobs journal the whole spec, because nothing else
        re-supplies it across a restart."""
        if state.job == DEFAULT_JOB:
            return {"op": "dataset", "uri": state.uri,
                    "num_parts": state.num_parts}
        return {"op": "dataset", "job": state.job, "uri": state.uri,
                "num_parts": state.num_parts, "parser": state.parser,
                "plan": state.plan, "snapshot": state.snapshot,
                "share_sig": state.share_sig, "qos": state.qos_dict()}

    # ---------------- journal + replay ----------------

    def _journal_append(self, event: dict, sync: bool = True) -> None:
        """Journal one state transition (no-op without a journal). All
        assignment events fsync: the journal IS the recovery contract,
        and its volume is O(jobs × parts + workers + failovers) per
        run."""
        if self._journal is not None:
            self._journal.append(event, sync=sync)

    def _job_tag(self, job: _JobState) -> dict:
        """The job qualifier assignment events carry: empty for the
        default job (byte-compatible with one-dataset journals), ``{"job": j}``
        otherwise."""
        return {} if job.job == DEFAULT_JOB else {"job": job.job}

    def _replay_dataset_locked(self, ev: dict) -> None:
        """Replay one job-registration event. A default-job record that
        disagrees with the constructor — or a per-job record that
        disagrees with an already-restored spec — is a fatal
        configuration error, never an assertion and never retryable:
        recovery must not silently serve the wrong corpus."""
        name = str(ev.get("job") or DEFAULT_JOB)
        if name == DEFAULT_JOB:
            current = self._jobs.get(DEFAULT_JOB)
            if current is None:
                raise ServiceConfigError(
                    f"dispatcher journal {self._journal.path} records "
                    f"dataset {ev.get('uri')!r} ({ev.get('num_parts')} "
                    f"parts) but this dispatcher was constructed with no "
                    f"default dataset — recover with "
                    f"Dispatcher(uri={ev.get('uri')!r}, "
                    f"num_parts={ev.get('num_parts')}, ...) or point "
                    f"journal_path at a fresh journal")
            want_parts = int(ev.get("num_parts", current.num_parts))
            want_uri = ev.get("uri", current.uri)
            if want_parts != current.num_parts or want_uri != current.uri:
                raise ServiceConfigError(
                    f"dispatcher journal {self._journal.path}: journaled "
                    f"dataset is {want_uri!r} with {want_parts} parts, "
                    f"constructor says {current.uri!r} with "
                    f"{current.num_parts} — a restart must recover the "
                    f"SAME dataset. Restart the dispatcher with the "
                    f"journaled dataset, or point journal_path at a "
                    f"fresh journal to start over")
            return
        prev = self._jobs.get(name)
        qos = dict(ev.get("qos") or {})
        restored = _JobState(
            name, ev.get("uri"), int(ev.get("num_parts", 0) or 0),
            dict(ev.get("parser") or {}), dict(ev.get("plan") or {}),
            dict(ev.get("snapshot") or {}),
            share_sig=ev.get("share_sig"),
            priority=qos.get("priority", 0), weight=qos.get("weight", 1),
            slo_wait_frac=qos.get("slo_wait_frac"),
            max_inflight=qos.get("max_inflight"))
        if prev is None:
            self._jobs[name] = restored
            return
        if (prev.uri != restored.uri
                or prev.num_parts != restored.num_parts
                or prev.parser != restored.parser):
            raise ServiceConfigError(
                f"dispatcher journal {self._journal.path}: job {name!r} "
                f"recorded twice with conflicting specs "
                f"({prev.uri!r}/{prev.num_parts} vs "
                f"{restored.uri!r}/{restored.num_parts}) — the journal "
                f"is corrupt or two dispatchers shared one journal_path; "
                f"point this dispatcher at a fresh journal")

    def _recover(self, compact_lines: int) -> None:
        """Replay the journal into the exact per-job assignment state:
        completed parts stay done with their owner, in-flight parts
        re-queue at the FRONT (lowest first — clients consume
        part-major), replayed workers get a fresh liveness window to
        re-attach, registered jobs are restored with their full spec,
        and the generation token bumps past every `start` ever
        journaled."""
        with self._journal.locked():
            lines = self._journal.read_lines()
            events = _journal_mod.decode_events(lines)
            last_gen = 0
            journaled_jobs: Set[str] = set()
            in_todo: Dict[str, Set[int]] = {}
            workers: Dict[str, tuple] = {}
            draining: Set[str] = set()

            def books(name: str) -> Optional[Tuple[_JobState, Set[int]]]:
                state = self._jobs.get(name)
                if state is None:
                    return None  # event for a job the journal lost
                if name not in in_todo:
                    in_todo[name] = set(state.todo)
                return state, in_todo[name]

            for ev in events:
                op = ev.get("op")
                name = str(ev.get("job") or DEFAULT_JOB)
                if op == "dataset":
                    self._replay_dataset_locked(ev)
                    journaled_jobs.add(name)
                    continue
                if op == "start":
                    last_gen = max(last_gen, int(ev.get("gen", 0) or 0))
                elif op == "register":
                    workers[str(ev.get("worker"))] = (
                        str(ev.get("host", "")), int(ev.get("port", 0)))
                    draining.discard(str(ev.get("worker")))
                elif op == "dead":
                    workers.pop(str(ev.get("worker")), None)
                    draining.discard(str(ev.get("worker")))
                elif op == "drain":
                    # a drain in flight at the crash: the worker stays out
                    # of the grant rotation after replay (its completed
                    # parts keep serving; the drain deadline re-arms)
                    if str(ev.get("worker")) in workers:
                        draining.add(str(ev.get("worker")))
                elif op == "join":
                    pass  # membership rides `register`; join is the record
                elif op == "grant":
                    got = books(name)
                    if got is None:
                        continue
                    state, todo_set = got
                    part = int(ev.get("part", -1))
                    if part in todo_set:
                        todo_set.discard(part)
                        state.todo.remove(part)
                    state.assigned[part] = str(ev.get("worker"))
                elif op == "spec_grant":
                    # the speculative twin of a grant: the part is already
                    # out of todo; whoever journals `complete` first owns
                    # it (the dedupe below), so replay needs no side state
                    pass
                elif op == "complete":
                    got = books(name)
                    if got is None:
                        continue
                    state, todo_set = got
                    part = int(ev.get("part", -1))
                    if 0 <= part < state.num_parts:
                        if part in todo_set:
                            todo_set.discard(part)
                            state.todo.remove(part)
                        # the completing worker wins the part — for a
                        # hedged part this is the first-complete owner,
                        # which may be the speculative worker
                        state.assigned[part] = str(ev.get("worker"))
                        state.completed.add(part)
                elif op == "reissue":
                    got = books(name)
                    if got is None:
                        continue
                    state, todo_set = got
                    part = int(ev.get("part", -1))
                    state.assigned.pop(part, None)
                    state.completed.discard(part)
                    if 0 <= part < state.num_parts \
                            and part not in todo_set:
                        todo_set.add(part)
                        state.todo.appendleft(part)
                elif op == "reclaim":
                    got = books(name)
                    if got is None:
                        continue
                    state, todo_set = got
                    part = int(ev.get("part", -1))
                    if part in todo_set:
                        todo_set.discard(part)
                        state.todo.remove(part)
                    state.assigned[part] = str(ev.get("worker"))
                    state.completed.add(part)
            requeued = 0
            for name, state in self._jobs.items():
                todo_set = in_todo.setdefault(name, set(state.todo))
                # in-flight at the crash (granted, never completed): the
                # owner's frames may be partial — re-queue at the front,
                # lowest part first; reclaim re-adopts what survived
                inflight = sorted(p for p in state.assigned
                                  if p not in state.completed)
                for part in inflight:
                    state.assigned.pop(part)
                # parts completed by a worker the journal no longer knows
                # (dead without a reissue line — a torn tail can lose
                # one): nothing serves them, so they re-queue behind the
                # in-flight
                orphaned = sorted(p for p, w in state.assigned.items()
                                  if w not in workers)
                for part in orphaned:
                    state.assigned.pop(part)
                    state.completed.discard(part)
                for part in reversed(inflight + orphaned):
                    if part not in todo_set:
                        todo_set.add(part)
                        state.todo.appendleft(part)
                requeued += len(inflight) + len(orphaned)
            now = get_time()
            # replayed workers start a fresh liveness window in the
            # JOINING state: a worker that survived the dispatcher
            # re-attaches within it (its next poll sees the generation
            # bump), one that died with the dispatcher goes stale and
            # its parts re-issue normally. A worker that was DRAINING at
            # the crash replays as draining — still out of the grant
            # rotation, still serving, deadline re-armed fresh.
            self._workers = {}
            for w, (h, p) in workers.items():
                info = _WorkerInfo(w, h, p, now)
                if w in draining:
                    info.state = DRAINING
                    info.drain_deadline = now + self._drain_deadline_s
                self._workers[w] = info
            self.generation = last_gen + 1
            if len(lines) > compact_lines:
                self._journal.rewrite(self._live_events())
            else:
                for name, state in self._jobs.items():
                    if name not in journaled_jobs:
                        self._journal.append(self._job_event(state),
                                             sync=True)
            self._journal.append(
                {"op": "start", "gen": self.generation}, sync=True)
            if events:
                logger.info(
                    "dispatcher: recovered from %s — gen %d, %d job(s), "
                    "%d parts done, %d re-queued, %d workers awaiting "
                    "re-attach", self._journal.path, self.generation,
                    len(self._jobs),
                    sum(len(j.completed) for j in self._jobs.values()),
                    requeued, len(self._workers))

    def _live_events(self) -> List[dict]:
        """The current state as a canonical journal (compaction): the
        jobs, the last start, live workers, and grant+complete pairs
        for done parts. Unassigned parts are implicit (replay seeds each
        queue from ``range(num_parts)``); the queues' front-ordering
        normalizes to ascending across a compaction."""
        events: List[dict] = [self._job_event(state)
                              for state in self._jobs.values()]
        events.append({"op": "start", "gen": self.generation - 1})
        for info in self._workers.values():
            if info.alive:
                events.append({"op": "register", "worker": info.worker,
                               "host": info.host, "port": info.port})
        for info in self._workers.values():
            # a drain in progress must survive compaction, or a restart
            # would put the draining worker back in the grant rotation
            if info.state == DRAINING:
                events.append({"op": "drain", "worker": info.worker})
        for state in self._jobs.values():
            tag = self._job_tag(state)
            for part in sorted(state.completed):
                worker = state.assigned.get(part)
                if worker is None:
                    continue
                events.append(dict({"op": "grant", "part": part,
                                    "worker": worker}, **tag))
                events.append(dict({"op": "complete", "part": part,
                                    "worker": worker}, **tag))
        return events

    # ---------------- assignment core (lock held) ----------------

    def _requeue_locked(self, job: _JobState, parts, worker: str,
                        why: str) -> None:
        """Re-issue ``parts`` of ``job`` at the FRONT, lowest part first
        (clients consume part-major, so the earliest lost part is the
        one blocking them), journaling each re-queue."""
        parts = sorted(parts)
        tag = self._job_tag(job)
        for part in parts:
            job.assigned.pop(part, None)
            job.completed.discard(part)
            self._drop_spec_locked(job, part)
            job.grant_times.pop(part, None)
            try:
                job.hedge_todo.remove(part)
            except ValueError:
                pass
        for part in reversed(parts):
            job.todo.appendleft(part)
            self._journal_append(dict({"op": "reissue", "part": part,
                                       "worker": worker}, **tag))
        if parts:
            logger.warning("dispatcher: worker %s %s; re-issuing "
                           "job %s parts %s", worker, why, job.job, parts)

    def _drop_spec_locked(self, job: _JobState,
                          part: int) -> Optional[str]:
        """Forget a part's speculative grant (and its grant stamp);
        returns the speculative worker, if any."""
        job.spec_times.pop(part, None)
        return job.spec.pop(part, None)

    def _drop_worker_specs_locked(self, worker: str) -> None:
        """Forget every speculative grant ``worker`` holds, every job —
        its speculative parses die with it (death, drain, departure)."""
        for job in self._jobs.values():
            for part in [p for p, w in job.spec.items() if w == worker]:
                self._drop_spec_locked(job, part)

    def _inherit_or_requeue_locked(self, job: _JobState, worker: str,
                                   parts, why: str) -> List[int]:
        """``worker`` is giving up ``parts`` of ``job``: promote each
        hedged part's speculative twin to primary (the hedge already has
        a live parse going — re-queuing would waste it) and re-queue the
        rest at the front. Returns the re-queued parts."""
        requeue = []
        tag = self._job_tag(job)
        for part in parts:
            spec_stamp = job.spec_times.get(part)
            spec = self._drop_spec_locked(job, part)
            if spec is not None and part not in job.completed:
                # the hedge worker inherits the part outright; its clock
                # restarts at ITS spec grant — keeping the stuck
                # primary's stamp would re-flag the part for hedging at
                # the very next tick and poison the latency median
                job.assigned[part] = spec
                job.grant_times[part] = (spec_stamp if spec_stamp
                                         is not None else get_time())
                self._journal_append(dict({"op": "grant", "part": part,
                                           "worker": spec}, **tag))
                logger.info("dispatcher: job %s part %d inherited by "
                            "hedge worker %s (%s %s)", job.job, part,
                            spec, worker, why)
            else:
                requeue.append(part)
        self._requeue_locked(job, requeue, worker, why)
        return requeue

    def _release_worker_parts_locked(self, worker: str, why: str) -> None:
        """A worker left (death or completed drain): drop speculative
        grants it held itself, then inherit-or-requeue everything it
        owned across every job (completed parts re-queue too — its frame
        store is gone)."""
        self._drop_worker_specs_locked(worker)
        for job in self._jobs.values():
            parts = sorted(p for p, o in job.assigned.items()
                           if o == worker)
            self._inherit_or_requeue_locked(job, worker, parts, why)

    def _mark_dead_locked(self, worker: str) -> None:
        info = self._workers.get(worker)
        if info is None or not info.alive:
            return
        info.state = DEAD
        self._journal_append({"op": "dead", "worker": worker})
        self._decision_locked(
            "mark_dead",
            {"last_seen_s": round(get_time() - info.last_seen, 3)},
            "worker declared dead; its parts re-issue", worker=worker)
        self._release_worker_parts_locked(worker, "lost")

    def _reap_stale_locked(self, now: float) -> None:
        if self.liveness_timeout <= 0:
            return
        for info in list(self._workers.values()):
            if info.alive and now - info.last_seen > self.liveness_timeout:
                logger.warning("dispatcher: worker %s missed heartbeats "
                               "(last seen %.1fs ago)", info.worker,
                               now - info.last_seen)
                self._mark_dead_locked(info.worker)

    def _clients_active_locked(self) -> bool:
        return any(j.clients_active for j in self._jobs.values())

    # ---------------- drain + hedging (lock held) ----------------

    def _finish_drain_locked(self, info: _WorkerInfo, why: str) -> None:
        """Complete a drain: the worker leaves the fleet for good — its
        next poll reads ``drained`` and exits instead of re-attaching.
        Handoff-confirmed completed parts stay ASSIGNED to the departed
        worker and re-queue lazily at the next ``locate``: every client
        that confirmed already streamed them, so an eager re-issue here
        would make the always-polling fleet re-parse frames nobody asked
        for. Everything else (unconfirmed completed parts included —
        their frames die with the worker) releases through the normal
        death path (re-queue / hedge inheritance) right now."""
        if info.state != DRAINING:
            return
        info.drained = True
        logger.info("dispatcher: drain of worker %s complete (%s)",
                    info.worker, why)
        info.state = DEAD
        self._journal_append({"op": "dead", "worker": info.worker})
        self._decision_locked(
            "drain_complete",
            {"handed_off": len(info.handed_off)}, why,
            worker=info.worker)
        self._drop_worker_specs_locked(info.worker)
        for job in self._jobs.values():
            keep = {p for (j, p) in info.handed_off
                    if j == job.job
                    and job.assigned.get(p) == info.worker
                    and p in job.completed}
            self._inherit_or_requeue_locked(
                job, info.worker,
                sorted(p for p, o in job.assigned.items()
                       if o == info.worker and p not in keep),
                why)

    def _serving_locked(self, worker: str) -> Set[Tuple[str, int]]:
        """The frame-store-complete (job, part) pairs ``worker`` still
        owns — what a drain must hand off before completing early."""
        return {(job.job, p) for job in self._jobs.values()
                for p, w in job.assigned.items()
                if w == worker and p in job.completed}

    def _maybe_finish_drain_locked(self, info: _WorkerInfo) -> None:
        """Complete the drain as soon as every still-assigned
        frame-store-complete part is handoff-confirmed — vacuously so
        for a worker with nothing to serve out (preempted before any
        part completed), which must exit within its notice window, not
        idle out the full deadline."""
        if info.state != DRAINING:
            return
        serving = self._serving_locked(info.worker)
        if serving <= info.handed_off:
            self._finish_drain_locked(
                info, "all served parts handed off"
                if serving else "nothing left to serve")

    def _expire_drains_locked(self, now: float) -> None:
        for info in list(self._workers.values()):
            if info.state != DRAINING:
                continue
            # the serving set can shrink without a handoff RPC (e.g. a
            # report_lost re-queued a part): re-check completion on the
            # wall-clock tick too, then the deadline backstop
            self._maybe_finish_drain_locked(info)
            if (info.state == DRAINING and info.drain_deadline is not None
                    and now >= info.drain_deadline):
                self._finish_drain_locked(info, "drain deadline expired")

    def _hedge_check_locked(self, now: float) -> None:
        """Flag in-flight parts stuck past ``hedge_factor`` times their
        JOB's median grant->complete latency for speculative re-issue.
        Guarded by a minimum per-job sample count and an absolute age
        floor so ordinary jitter on fast parts can never trigger a
        duplicate parse; the flagged part is granted to the next polling
        worker that is not the stuck primary."""
        for job in self._jobs.values():
            if len(job.latencies) < HEDGE_MIN_SAMPLES:
                continue
            threshold = max(self._hedge_factor
                            * statistics.median(job.latencies),
                            HEDGE_MIN_AGE_S)
            for part, granted_at in list(job.grant_times.items()):
                if (part in job.completed or part in job.spec
                        or part in job.hedge_todo):
                    continue
                owner = job.assigned.get(part)
                info = (self._workers.get(owner)
                        if owner is not None else None)
                if info is None or info.state != ACTIVE:
                    continue  # death/drain paths own those parts
                age = now - granted_at
                if age <= threshold:
                    continue
                if not any(w.state == ACTIVE and w.worker != owner
                           and w.registered_gen == self.generation
                           for w in self._workers.values()):
                    continue  # nobody to hedge onto
                job.hedge_todo.append(part)
                self._decision_locked(
                    "hedge",
                    {"part": part, "age_s": round(age, 3),
                     "threshold_s": round(threshold, 3),
                     "median_s": round(
                         statistics.median(job.latencies), 3)},
                    f"part {part} on {owner} flagged for "
                    f"speculative re-issue", job=job.job)
                logger.warning(
                    "dispatcher: job %s part %d on worker %s stuck "
                    "%.2fs (> %.2fs = %dx job median); flagging for "
                    "speculative re-issue", job.job, part, owner, age,
                    threshold, self._hedge_factor)

    def _tick_loop(self) -> None:
        """The wall-clock driver behind liveness, drain deadlines, and
        hedging — RPC traffic is no longer required for any of them."""
        while not self._tick_stop.wait(self._tick_interval):
            now = get_time()
            with self._lock:
                self._reap_stale_locked(now)
                self._expire_drains_locked(now)
                self._hedge_check_locked(now)

    # ---------------- request handlers ----------------

    def _handle(self, req: dict) -> dict:
        t0 = get_time()
        # adopt the caller's trace context (optional `trace` wire key,
        # docs/service.md) for the duration of this command, so the
        # service_rpc span — and anything the handler records — links
        # into the caller's trace
        ctx = _telemetry.trace_context_from_wire(req.get("trace"))
        with _telemetry.trace(ctx[0] if ctx else None,
                              ctx[1] if ctx else ""):
            resp = self._dispatch_cmd(req)
            _telemetry.record_span("service_rpc", t0, get_time() - t0,
                                   cmd=str(req.get("cmd") or ""))
        # the monotonic generation token: peers detect a restart at
        # their next control exchange and re-register/revalidate
        resp["gen"] = self.generation
        # monotonic clock stamp: `request()` pairs it with its own
        # send/receive midpoint to estimate this process's clock offset
        # (merged pod timelines, docs/observability.md)
        resp["now"] = round(get_time(), 6)
        return resp

    def _job_for(self, req: dict) -> Optional[_JobState]:
        """The job a request addresses (absent field = default job)."""
        return self._jobs.get(str(req.get("job") or DEFAULT_JOB))

    def _bands_locked(self) -> List[List[_JobState]]:
        """Jobs grouped into priority bands, highest band first, each
        band rotated from the round-robin cursor (docs/service.md
        Production QoS): a higher band fully preempts lower ones in the
        grant order; rotation within a band is what DRR credits shape."""
        bands: Dict[int, List[_JobState]] = {}
        for j in self._jobs.values():
            bands.setdefault(j.priority, []).append(j)
        out = []
        for prio in sorted(bands, reverse=True):
            band = bands[prio]
            k = self._rr % len(band)
            out.append(band[k:] + band[:k])
        return out

    def _grant_rotation_locked(self) -> List[_JobState]:
        """The flat job visitation order (priority bands descending,
        round-robin within each band) — the hedge scan and fairness
        probes walk this, so a latency-critical job's straggler re-issues
        ahead of a batch job's fresh work."""
        return [j for band in self._bands_locked() for j in band]

    def _fleet_inflight_locked(self) -> int:
        """Granted-not-completed parts across every job — what the
        fleet-wide admission ceiling bounds."""
        return sum(j.inflight() for j in self._jobs.values())

    def _admission_locked(self, job: _JobState) -> bool:
        """True when `job` may be granted one more part: under its own
        max_inflight budget AND the fleet under the
        DMLC_TPU_QOS_MAX_INFLIGHT ceiling. Hedge re-issues bypass this —
        they duplicate work already admitted."""
        if (job.max_inflight is not None
                and job.inflight() >= job.max_inflight):
            return False
        ceiling = _knobs.qos_max_inflight()
        if ceiling is not None and self._fleet_inflight_locked() >= ceiling:
            return False
        return True

    def _dispatch_cmd(self, req: dict) -> dict:
        cmd = req.get("cmd")
        now = get_time()
        with self._lock:
            if cmd == "config":
                job = self._job_for(req)
                if job is None:
                    if "job" in req:
                        return {"error": f"unknown job {req.get('job')!r}"
                                         f" (register_job first; "
                                         f"registered: "
                                         f"{sorted(self._jobs)})"}
                    # a dispatcher born empty: workers boot against this
                    # and fetch real job specs lazily per grant
                    return {"uri": None, "num_parts": 0, "parser": {},
                            "plan": {}, "snapshot": {}}
                resp = job.spec_dict()
                if "job" in req:
                    resp["job"] = job.job
                return resp
            if cmd == "register_job":
                return self._register_job_locked(req)
            if cmd == "register":
                worker = str(req["worker"])
                prev = self._workers.get(worker)
                if (prev is not None and prev.alive
                        and prev.registered_gen == self.generation):
                    # a worker id already seen alive THIS generation is
                    # re-registering: the process crash-restarted fast
                    # (before the liveness reaper fired) and its frame
                    # store is presumed gone — re-queue everything it
                    # owned; the reclaim that follows adopts back what
                    # actually survived (docs/service.md)
                    self._release_worker_parts_locked(
                        worker, "re-registered (crash-restart)")
                self._workers[worker] = _WorkerInfo(
                    worker, str(req["host"]), int(req["port"]), now,
                    registered_gen=self.generation)
                self._journal_append({"op": "register", "worker": worker,
                                      "host": str(req["host"]),
                                      "port": int(req["port"])})
                if prev is None and self._clients_active_locked():
                    # a brand-new worker id arriving while clients are
                    # consuming: a mid-epoch LIVE JOIN — it is in the
                    # grant rotation and the re-issue serving set from
                    # this very reply
                    self._journal_append({"op": "join", "worker": worker})
                    _resilience.record_event("worker_joins")
                    self._decision_locked(
                        "live_join", None,
                        f"worker {worker} joined mid-epoch",
                        worker=worker)
                    logger.info("dispatcher: worker %s joined the live "
                                "fleet", worker)
                return {"ok": True}
            if cmd == "heartbeat":
                info = self._workers.get(str(req.get("worker")))
                if info is not None and info.alive:
                    info.last_seen = now
                return {"ok": True}
            if cmd == "next_split":
                return self._next_split_locked(req, now)
            if cmd == "part_done":
                return self._part_done_locked(req, now)
            if cmd == "drain":
                return self._drain_locked(req, now)
            if cmd == "handoff":
                worker = str(req["worker"])
                part = int(req["part"])
                jname = str(req.get("job") or DEFAULT_JOB)
                info = self._workers.get(worker)
                if info is not None and info.state == DRAINING:
                    info.handed_off.add((jname, part))
                    self._maybe_finish_drain_locked(info)
                return {"ok": True}
            if cmd == "reclaim":
                return self._reclaim_locked(req)
            if cmd == "locate":
                return self._locate_locked(req, now)
            if cmd == "report_lost":
                self._mark_dead_locked(str(req["worker"]))
                return {"ok": True}
            if cmd == "trace_dump":
                # this process's span rings + decisions, with a clock
                # stamp — LocalFleet.dump_trace merges these into ONE
                # pod timeline (docs/observability.md)
                return {"snapshot":
                        _telemetry.component_snapshot("dispatcher")}
            if cmd == "metrics_text":
                return {"text": _telemetry.render_prometheus(),
                        "content_type":
                            "text/plain; version=0.0.4; charset=utf-8"}
            if cmd == "decisions":
                comp = req.get("component")
                return {"decisions": _telemetry.decisions_snapshot(
                            str(comp) if comp else None),
                        "total": _telemetry.decisions_total()}
            if cmd == "status":
                default = self._default()
                jobs = {
                    name: {
                        "uri": j.uri,
                        "num_parts": j.num_parts,
                        "share_sig": j.share_sig,
                        "assigned": {str(p): w
                                     for p, w in j.assigned.items()},
                        "todo": list(j.todo),
                        "completed": sorted(j.completed),
                        "hedged": {str(p): w for p, w in j.spec.items()},
                        "qos": j.qos_dict(),
                        "inflight": j.inflight(),
                    } for name, j in self._jobs.items()}
                return {
                    "workers": {w: {"host": i.host, "port": i.port,
                                    "alive": i.alive, "state": i.state}
                                for w, i in self._workers.items()},
                    # legacy one-dataset view: the default job's books
                    "assigned": ({str(p): w for p, w
                                  in default.assigned.items()}
                                 if default else {}),
                    "todo": list(default.todo) if default else [],
                    "completed": (sorted(default.completed)
                                  if default else []),
                    "hedged": ({str(p): w for p, w in default.spec.items()}
                               if default else {}),
                    "jobs": jobs,
                    "generation": self.generation,
                }
        return {"error": f"unknown command {cmd!r}"}

    def _decision_locked(self, action: str, trigger: Optional[dict],
                         outcome: Optional[str], **extra) -> None:
        """Record one dispatcher control decision: audit-ledger event
        (+ ``decision_events`` counter) and a ``decision`` journal line
        so post-mortems survive the process. Replay skips unknown ops,
        so old dispatchers reading a new journal are unaffected; journal
        compaction drops decision lines (they are observability, not
        assignment state). Never fsync'd — a lost tail decision must not
        cost the control plane a disk flush."""
        event = _telemetry.record_decision("dispatcher", action,
                                           trigger=trigger,
                                           outcome=outcome, **extra)
        self._journal_append(dict({"op": "decision"}, **event),
                             sync=False)

    def _grant_trace_locked(self, job: _JobState, part: int,
                            worker: str, now: float,
                            name: str) -> Optional[dict]:
        """Open (or re-join) the part's trace at grant time and return
        its wire context for the reply. The grant is the trace ROOT: one
        (job, part) = one trace id, and the root span id is what worker
        and client spans parent under. A hedge re-grant re-joins the
        primary grant's trace so both attempts render as one causal
        timeline."""
        if not _telemetry.trace_propagation_enabled():
            return None
        ctx = job.traces.get(part)
        if ctx is None:
            ctx = (_telemetry.new_trace_id(), _telemetry.new_span_id())
            job.traces[part] = ctx
        tid, sid = ctx
        _telemetry.record_span(name, now, get_time() - now,
                               trace_id=tid, span_id=sid,
                               job=job.job, part=part, worker=worker)
        return {"tid": tid, "sid": sid}

    def _next_split_locked(self, req: dict, now: float) -> dict:
        worker = str(req["worker"])
        info = self._workers.get(worker)
        if info is None or not info.alive:
            if info is not None and info.drained:
                # drain complete: tell the worker to exit instead of
                # re-attaching as a zombie
                return {"part": None, "drained": True}
            # unregistered/declared-dead workers get no splits — a
            # zombie must re-register before it can own parts
            return {"part": None, "register": True}
        if info.state == DRAINING:
            # draining workers get NO new work; the poll doubles as
            # liveness while they serve out their parts
            info.last_seen = now
            return {"part": None, "draining": True}
        if info.registered_gen != self.generation:
            # journal-restored worker that has not re-attached this
            # generation: its frame-store contents are unknown until the
            # register+reclaim handshake, and a grant riding the SAME
            # reply as the generation bump would race the reclaim into a
            # duplicate parse
            info.last_seen = now
            return {"part": None, "register": True}
        info.last_seen = now
        self._reap_stale_locked(now)
        rotation = self._grant_rotation_locked()
        # speculative re-issues first, any job: a flagged straggler part
        # goes to the first polling worker that is NOT the stuck primary
        # (journaled spec_grant; first part_done wins)
        for job in rotation:
            for _ in range(len(job.hedge_todo)):
                part = job.hedge_todo.popleft()
                if (part in job.completed or part in job.spec
                        or part not in job.assigned):
                    continue  # stale flag
                if job.assigned.get(part) == worker:
                    job.hedge_todo.append(part)
                    continue
                job.spec[part] = worker
                job.spec_times[part] = now
                self._journal_append(dict(
                    {"op": "spec_grant", "part": part, "worker": worker},
                    **self._job_tag(job)))
                _resilience.record_event("speculative_reissues")
                age = now - job.grant_times.get(part, now)
                self._decision_locked(
                    "spec_grant",
                    {"part": part, "age_s": round(age, 3),
                     "samples": len(job.latencies)},
                    f"re-issued to {worker} (primary "
                    f"{job.assigned.get(part)})", job=job.job)
                logger.warning(
                    "dispatcher: job %s part %d speculatively re-issued "
                    "to worker %s (primary %s)", job.job, part, worker,
                    job.assigned.get(part))
                resp = {"part": part, "job": job.job}
                wire = self._grant_trace_locked(job, part, worker, now,
                                                "service_spec_grant")
                if wire is not None:
                    resp["trace"] = wire
                return resp
        # fresh grants: deficit round-robin within the highest priority
        # band that has admissible work (docs/service.md Production QoS).
        # Higher bands fully preempt lower ones; within a band each job
        # spends one credit per grant and the band replenishes by weight
        # when every eligible credit runs dry — so weight 2 jobs draw
        # twice the grants of weight 1 siblings, and equal-weight jobs
        # keep the historical strict alternation. Over-budget jobs
        # (admission control) are simply not eligible this poll.
        for band in self._bands_locked():
            eligible = [j for j in band
                        if j.todo and self._admission_locked(j)]
            if not eligible:
                continue
            if all(j.deficit < 1.0 for j in eligible):
                for j in eligible:
                    j.deficit = min(j.deficit + j.weight, float(j.weight))
            for i, job in enumerate(eligible):
                if job.deficit < 1.0:
                    continue
                job.deficit -= 1.0
                part = job.todo.popleft()
                job.assigned[part] = worker
                job.grant_times[part] = now
                self._journal_append(dict({"op": "grant", "part": part,
                                           "worker": worker},
                                          **self._job_tag(job)))
                # advance the cursor PAST the granted job: the next
                # grant's band rotation starts at the following job
                self._rr = (self._rr + band.index(job) + 1) % (1 << 30)
                logger.info("dispatcher: job %s part %d -> worker %s",
                            job.job, part, worker)
                resp = {"part": part, "job": job.job}
                wire = self._grant_trace_locked(job, part, worker, now,
                                                "service_grant")
                if wire is not None:
                    resp["trace"] = wire
                return resp
        return {"part": None}

    def _part_done_locked(self, req: dict, now: float) -> dict:
        worker = str(req["worker"])
        part = int(req["part"])
        job = self._job_for(req)
        if job is None:
            return {"ok": True}  # completion for a job nobody knows
        tag = self._job_tag(job)
        primary = job.assigned.get(part)
        spec = job.spec.get(part)
        if part not in job.completed and worker in (primary, spec):
            # journaled completion: a restarted dispatcher keeps the
            # part done instead of re-queuing it as in-flight. For a
            # hedged part the FIRST completion wins; the loser's later
            # part_done is deduped right here.
            job.completed.add(part)
            # the latency sample measures the WINNER's own
            # grant->complete time (the spec grant stamp for a
            # speculative win) — never the stuck primary's age, which
            # exceeds the hedge threshold by construction and would
            # desensitize the median
            granted_at = job.grant_times.pop(part, None)
            if spec is not None and worker == spec:
                job.assigned[part] = worker
                granted_at = job.spec_times.get(part, granted_at)
                _resilience.record_event("speculative_wins")
                self._decision_locked(
                    "spec_win", {"part": part},
                    f"speculative worker {worker} won over {primary}",
                    job=job.job)
                logger.info("dispatcher: speculative worker %s won "
                            "job %s part %d over %s", worker, job.job,
                            part, primary)
            self._drop_spec_locked(job, part)
            self._journal_append(dict({"op": "complete", "part": part,
                                       "worker": worker}, **tag))
            if granted_at is not None:
                job.latencies.append(max(0.0, now - granted_at))
        elif part not in job.completed:
            # a completion for a part we had RE-QUEUED (its grant didn't
            # survive a dispatcher restart, or a report_lost blamed a
            # still-live worker): the frames exist, so adopt it exactly
            # as `reclaim` would instead of letting the queue force a
            # duplicate parse (no latency sample — the grant stamp died
            # with the re-queue)
            info = self._workers.get(worker)
            if (info is not None and info.alive
                    and part in job.todo):
                job.todo.remove(part)
                job.assigned[part] = worker
                job.completed.add(part)
                self._journal_append(dict(
                    {"op": "complete", "part": part, "worker": worker},
                    **tag))
                logger.info("dispatcher: adopted completion of "
                            "re-queued job %s part %d from worker %s",
                            job.job, part, worker)
        return {"ok": True}

    def _locate_locked(self, req: dict, now: float) -> dict:
        job = self._job_for(req)
        if job is None:
            return {"error": f"unknown job {req.get('job')!r} "
                             f"(register_job first)"}
        part = int(req["part"])
        if not 0 <= part < job.num_parts:
            return {"error": f"job {job.job}: part {part} out of range"}
        job.clients_active = True  # a consumer is attached
        self._reap_stale_locked(now)
        owner = job.assigned.get(part)
        info = self._workers.get(owner) if owner is not None else None
        if info is None or not info.alive:
            if owner is not None:
                # the part stayed assigned to a departed drained worker
                # (handoff-confirmed — see _finish_drain_locked) for
                # exactly this moment: a client still wants it, so NOW
                # it re-queues
                self._requeue_locked(
                    job, [part], owner, "located after its drained "
                    "owner left")
            if not self._admission_locked(job):
                # the part is ungranted BECAUSE admission control is
                # shedding this job's grants (its own budget or the
                # fleet ceiling): tell the client to back off with a
                # retryable throttle instead of a hot wait-poll —
                # overload degrades to bounded queueing, never a
                # give-up (docs/service.md Production QoS)
                _resilience.record_event("service_throttles")
                self._decision_locked(
                    "throttle",
                    {"part": part, "inflight": job.inflight(),
                     "fleet_inflight": self._fleet_inflight_locked(),
                     "max_inflight": job.max_inflight},
                    "client told to back off", job=job.job)
                return {"throttled": True}
            return {"wait": True}
        resp = {"worker": info.worker, "host": info.host,
                "port": info.port}
        ctx = job.traces.get(part)
        wire = (_telemetry.trace_context_wire(ctx)
                if ctx is not None else None)
        if wire is not None:
            # the part's grant trace: the client's recv/decode/dispatch
            # spans join the same causal chain the grant opened
            resp["trace"] = wire
        if info.state == DRAINING:
            # the owner is leaving: clients should finish this stream
            # promptly and confirm with `handoff`
            resp["draining"] = True
        have = req.get("have")
        if have is not None and str(have) != info.worker:
            # the part moved off the worker the client last used: the
            # client takes this hint as confirmation that a drain
            # re-issue landed (drain_handoffs) — no dead-socket timeout
            # involved (docs/service.md)
            resp["moved"] = True
        return resp

    def _drain_locked(self, req: dict, now: float) -> dict:
        """Begin (or report) a graceful drain: the worker leaves the
        grant rotation immediately, its unstarted/in-flight parts (every
        job) proactively re-issue at the front (hedged parts are
        inherited by their speculative worker), and its frame-store-
        complete parts keep serving until every one is ``handoff``-
        confirmed or the drain deadline expires. Idempotent — repeats
        report state."""
        worker = str(req["worker"])
        info = self._workers.get(worker)
        if info is None or not info.alive:
            return {"ok": False, "unknown": True}
        # an EXPLICIT deadline of 0 means "leave now" — only an absent
        # field falls back to the knob default (0 is falsy, so `or`
        # would silently re-arm the 30s window the caller opted out of)
        raw_deadline = req.get("deadline")
        deadline_s = (float(raw_deadline) if raw_deadline is not None
                      else self._drain_deadline_s)
        if info.state == DRAINING:
            # a repeat drain may TIGHTEN the window (eviction imminent:
            # drain(deadline=0) means leave now), never loosen it
            if raw_deadline is not None:
                new_at = now + deadline_s
                if (info.drain_deadline is None
                        or new_at < info.drain_deadline):
                    info.drain_deadline = new_at
        else:
            info.state = DRAINING
            info.drain_deadline = now + deadline_s
            info.handed_off = set()
            self._journal_append({"op": "drain", "worker": worker})
            _resilience.record_event("worker_drains")
            self._decision_locked(
                "drain", {"deadline_s": round(deadline_s, 3)},
                f"worker {worker} leaving the grant rotation",
                worker=worker)
            # speculative grants the drainer held die with the drain
            self._drop_worker_specs_locked(worker)
            # proactive re-issue of everything NOT frame-store-complete
            # (those keep serving out): failover starts now, not when
            # the worker's sockets die. A hedged part is inherited by
            # its speculative worker instead of re-queued.
            pending = 0
            for job in self._jobs.values():
                pending += len(self._inherit_or_requeue_locked(
                    job, worker,
                    sorted(p for p, w in job.assigned.items()
                           if w == worker and p not in job.completed),
                    "draining"))
            logger.warning(
                "dispatcher: draining worker %s (deadline %.1fs, "
                "%d unstarted parts re-issued, %d complete parts "
                "serving out)", worker, deadline_s, pending,
                len(self._serving_locked(worker)))
            # nothing to serve out (preempted before any part
            # completed)? the drain is already done — exit within the
            # notice window instead of idling out the deadline
            self._maybe_finish_drain_locked(info)
        serving_jobs: Dict[str, List[int]] = {}
        for jname, part in sorted(self._serving_locked(worker)):
            serving_jobs.setdefault(jname, []).append(part)
        return {"ok": True,
                # legacy shape: the default job's serving parts
                "serving": serving_jobs.get(DEFAULT_JOB, []),
                "serving_jobs": serving_jobs,
                "deadline_s": round(
                    max(0.0, (info.drain_deadline or now) - now), 3)}

    def _reclaim_locked(self, req: dict) -> dict:
        """Adopt the fully-parsed parts a (re-)registered worker's frame
        store still holds — instead of forcing a fleet-wide re-parse —
        and re-queue the journal-complete parts it no longer announces
        (its store lost them, e.g. dispatcher AND worker both died).
        ``parts`` is a flat list (default job, the one-dataset wire shape) or
        ``{job: [parts]}``; the reply's ``adopted`` mirrors the request
        shape. Parts owned by ANOTHER live worker are never stolen;
        parts granted this generation and still mid-parse are left alone
        (the announce lists complete parts only)."""
        worker = str(req["worker"])
        info = self._workers.get(worker)
        if info is None or not info.alive:
            return {"error": f"reclaim from unregistered worker "
                             f"{worker!r} (register first)"}
        raw = req.get("parts")
        flat = not isinstance(raw, dict)
        by_job: Dict[str, Set[int]] = (
            {DEFAULT_JOB: {int(p) for p in (raw or [])}} if flat
            else {str(j): {int(p) for p in (ps or [])}
                  for j, ps in raw.items()})
        adopted: Dict[str, List[int]] = {}
        for jname, held in by_job.items():
            job = self._jobs.get(jname)
            if job is None:
                continue
            tag = self._job_tag(job)
            held = {p for p in held if 0 <= p < job.num_parts}
            got: List[int] = []
            for part in sorted(held):
                owner = job.assigned.get(part)
                if owner == worker:
                    if part not in job.completed:
                        job.completed.add(part)
                        self._journal_append(dict(
                            {"op": "complete", "part": part,
                             "worker": worker}, **tag))
                    got.append(part)
                elif owner is None and part in job.todo:
                    job.todo.remove(part)
                    job.assigned[part] = worker
                    job.completed.add(part)
                    self._journal_append(dict(
                        {"op": "reclaim", "part": part,
                         "worker": worker}, **tag))
                    got.append(part)
                # else: owned by another live worker — exactly-once wins
            if got:
                adopted[jname] = got
        # journal-complete parts this incarnation no longer announces —
        # ACROSS every job, so a worker that came back holding only job
        # A's frames re-queues its stale job-B claims too
        for job in self._jobs.values():
            held = by_job.get(job.job, set())
            stale = [p for p, w in job.assigned.items()
                     if w == worker and p in job.completed
                     and p not in held]
            self._requeue_locked(job, stale, worker, "reclaimed without")
        if adopted:
            logger.info("dispatcher: worker %s reclaimed parts %s",
                        worker, adopted)
        if flat:
            return {"ok": True, "adopted": adopted.get(DEFAULT_JOB, [])}
        return {"ok": True, "adopted": {j: ps
                                        for j, ps in adopted.items()}}

    # ---------------- server loop ----------------

    def _serve(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # closed
            try:
                # accepted sockets do NOT inherit the listener's
                # SO_REUSEADDR: without it, one lingering half-closed
                # handler conn blocks a same-address restart's bind
                conn.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            except OSError:
                pass
            # one thread per connection — requests are tiny, but a
            # half-open client blocking the ONLY serve thread for its
            # read timeout would queue every worker heartbeat behind it —
            # capped by the handler semaphore: excess connections shed
            # with a retryable busy reply instead of a new thread
            if not self._handler_slots.acquire(blocking=False):
                self._shed(conn)
                continue
            with self._conns_lock:
                self._conns.add(conn)
            threading.Thread(target=self._serve_one, args=(conn,),
                             daemon=True).start()

    def _shed(self, conn) -> None:
        """Refuse one connection with a retryable busy reply (callers
        heal through the shared RetryPolicy — see :func:`request`)."""
        try:
            conn.settimeout(1.0)
            conn.sendall(b'{"busy": true}\n')
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _serve_one(self, conn) -> None:
        try:
            conn.settimeout(10.0)
            with conn.makefile("rwb") as f:
                line = f.readline()
                if not line:
                    return
                try:
                    req = json.loads(line)
                    resp = self._handle(req)
                except (ValueError, KeyError, TypeError) as exc:
                    resp = {"error": f"bad request: {exc}",
                            "gen": self.generation}
                f.write(json.dumps(resp).encode() + b"\n")
                f.flush()
        except OSError as exc:
            logger.debug("dispatcher: connection error: %s", exc)
        finally:
            self._handler_slots.release()
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def kill(self) -> None:
        """Crash-simulate the dispatcher (``kill -9``): the listener
        drops with no goodbye and the in-memory assignment state is
        abandoned — the fsync'd journal is all a restart recovers from.
        Mechanically identical to :meth:`close` (the journal is
        append-only, so there is nothing graceful to skip); kept
        separate so chaos tests state their intent."""
        self.close()

    def close(self) -> None:
        self._closed = True
        # stop the background reaper tick first (clean shutdown: the
        # tick must never fire against a half-closed dispatcher)
        self._tick_stop.set()
        if threading.current_thread() is not self._tick_thread:
            self._tick_thread.join(timeout=5.0)
        # shutdown BEFORE close: a thread blocked in accept() holds a
        # kernel reference to the fd, so close() alone leaves the old
        # LISTEN socket alive until the syscall returns — and a restart
        # on the same address then cannot bind. shutdown wakes accept
        # immediately; the join guarantees the reference is dropped.
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        if threading.current_thread() is not self._thread:
            self._thread.join(timeout=5.0)
        # force-drop in-flight handler connections, exactly like the
        # kernel does for a dead process — otherwise a lingering
        # half-open peer keeps the port and a same-address restart
        # cannot bind
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass


def request(address: str, req: dict, timeout: float = 10.0) -> dict:
    """One dispatcher round trip (shared by workers and clients).
    ``address`` is ``host:port``. Transport failures surface as their
    natural ConnectionError/OSError classes; a torn or empty reply (the
    dispatcher died mid-response) and a shed ``busy`` reply are wrapped
    in retryable ``ConnectionError`` HERE, so every caller — workers,
    clients, fleet bootstrap — heals through the shared
    :class:`~dmlc_tpu_torch.io.resilience.RetryPolicy` instead of re-deriving
    the classification at call sites. The ``dispatch_rpc`` fault-plan op
    fires on every round trip."""
    _faults.maybe_fail("dispatch_rpc", f"{address} {req.get('cmd', '')}")
    if "trace" not in req:
        # propagate the caller's trace context (optional key — old
        # dispatchers ignore it); copy-on-write so retries and callers
        # that reuse request dicts are unaffected
        wire = _telemetry.trace_context_wire()
        if wire is not None:
            req = dict(req, trace=wire)
    host, _, port = address.rpartition(":")
    t0 = get_time()
    with socket.create_connection((host, int(port)), timeout=timeout) as s:
        s.settimeout(timeout)
        with s.makefile("rwb") as f:
            f.write(json.dumps(req).encode() + b"\n")
            f.flush()
            line = f.readline()
    t1 = get_time()
    if not line:
        raise ConnectionError(f"dispatcher {address}: empty reply "
                              f"(died mid-response)")
    try:
        resp = json.loads(line)
    except ValueError as exc:
        # a torn reply mid-crash is JSON garbage — the same transient
        # fault as the connection dropping, classified ONCE here
        raise ConnectionError(
            f"dispatcher {address}: torn reply "
            f"{line[:64]!r}") from exc
    if resp.get("busy"):
        raise ConnectionError(
            f"dispatcher {address}: busy (handler slots exhausted; "
            f"retry after backoff)")
    now = resp.get("now")
    if isinstance(now, (int, float)):
        # clock-offset estimate from the round-trip midpoint: the peer
        # stamped `now` roughly halfway between our send and receive,
        # so ADDING (t0+t1)/2 − now to a peer timestamp lands it on
        # this process's clock (docs/observability.md)
        _note_clock_offset(address, (t0 + t1) / 2.0 - float(now))
    if "error" in resp:
        raise DMLCError(f"dispatcher {address}: {resp['error']}")
    return resp


def register_job(address: str, job: str, uri: str, num_parts: int,
                 parser: Optional[dict] = None,
                 plan: Optional[dict] = None,
                 snapshot: Optional[dict] = None,
                 priority: Optional[int] = None,
                 weight: Optional[int] = None,
                 slo_wait_frac: Optional[float] = None,
                 max_inflight: Optional[int] = None,
                 timeout: float = 10.0) -> dict:
    """Register ``job`` at a running dispatcher over the wire (the
    trainer-side entry point of the multi-tenant service; docs/service.md
    job registry). Idempotent for an identical spec; a conflicting spec
    raises (job identity is immutable). Returns the registered spec —
    including the resolved ``parser`` config, whose ``block_cache`` may
    have been assigned by share-by-signature. ``priority`` / ``weight`` /
    ``slo_wait_frac`` / ``max_inflight`` declare the job's QoS class
    (docs/service.md Production QoS); the keys ride the wire only when
    set, so old dispatchers keep accepting default-class registrations."""
    req = {"cmd": "register_job", "job": str(job), "uri": uri,
           "num_parts": int(num_parts), "parser": dict(parser or {}),
           "plan": dict(plan or {}), "snapshot": dict(snapshot or {})}
    for key, value in (("priority", priority), ("weight", weight),
                       ("slo_wait_frac", slo_wait_frac),
                       ("max_inflight", max_inflight)):
        if value is not None:
            req[key] = value
    return request(address, req, timeout=timeout)
