"""Data-service client: a drop-in RowBlock parser over the wire.

The port's copy of the JAX package's ``service/client.py``, with its wire,
JSON, journal records, counters and messages; the JAX package's fault-plan
call here is left out (the port has no fault seam).

:class:`ServiceParser` implements the :class:`~dmlc_tpu_torch.data.parsers.Parser`
contract against a dispatcher address, so it feeds ``DeviceIter`` (and
``BasicRowIter``) unchanged — selected via
``create_parser(service=...)`` / ``create_row_block_iter(service=...)``
or a ``#service=<host:port>`` URI suffix.

**Job identity** (docs/service.md multi-tenant service): the client
binds to ONE registered job (``job=``, default ``"default"`` — the
dispatcher-constructor dataset), carries it on every control RPC and
stream request, stamps it into checkpoints (a state restored into a
client bound to a different job fails loudly — positions are only
meaningful within one job's part-major order), and labels its
consumer-side input wait with it on the telemetry registry
(``service_job_input_wait_seconds``), which is the per-job signal the
fleet autoscaler aggregates from the tracker pod table
(docs/observability.md). Streams are byte-identical PER JOB: a job's
delivered blocks match its single-job run exactly, whatever other jobs
share the fleet or the underlying cached artifacts.

Delivery order is **part-major**: part 0's blocks, then part 1's, ...
— exactly the stream a single host produces looping
``create_parser(uri, p, num_parts)`` for ``p`` in order with the same
config, so the delivered blocks (arrays AND resume annotations) are
byte-identical to local parsing regardless of which workers parsed what.

Fault tolerance composes the shared :mod:`dmlc_tpu_torch.io.resilience`
machinery: a broken stream (connection loss, torn frame, worker ERROR)
is a classified retryable fault — the client reports the worker lost,
waits for the dispatcher to re-issue the part, reconnects to the new
owner, and resumes **at the exact block index** (``start=`` in the
stream request), counting ``service_retries`` per interruption and
``service_failovers`` when the resume landed on a different worker;
exhausted budgets count ``service_giveups`` and surface as ``DMLCError``.

The control plane is covered too (docs/service.md control-plane
recovery): every dispatcher round trip runs under the shared
``RetryPolicy`` (``control_plane_retries`` per transient re-attempt —
connection refused between a dispatcher kill and its restart, torn
replies), and every dispatcher response carries a monotonic generation
token. A bump means the dispatcher restarted: the client counts a
``dispatcher_restarts`` and simply continues — its ``(part, block)``
cursor is client-owned state, revalidated against the recovered
dispatcher by the very next ``locate``, so the epoch resumes
byte-identically whether the part was reclaimed from a surviving
worker's frame store or re-parsed.

Elastic membership (docs/service.md): a *draining* worker (preemption
notice, SIGTERM, operator drain) hands off gracefully instead of timing
out. The client learns re-assignments from ``moved`` / ``draining``
hints on ``locate`` (it sends the owner it last used as ``have``), a
drain-flagged ERROR frame relocates WITHOUT blaming the worker or
spending retry budget (the part was proactively re-issued), and a
drain-flagged END confirms the handoff back to the dispatcher
(``handoff`` RPC) so the drain can complete before its deadline. Each
graceful move or confirmed handoff counts ``drain_handoffs``.

Checkpoints: ``state_dict()`` is ``(part, block)`` — O(1) to restore
into a **fresh** client/connection. ``load_state`` additionally accepts
the parser chain's annotation states (the ``kind='split'``/``'chunks'``
states a ``DeviceIter`` checkpoint embeds) by asking the serving workers
to ``find`` the annotation in their frame stores — the service analog of
``BlockCacheIter``'s stored-annotation match.
"""

from __future__ import annotations

import os
import socket
import json
import threading
from typing import Dict, Optional

from dmlc_tpu_torch.data.parsers import Parser
from dmlc_tpu_torch.data.row_block import DenseBlock, RowBlock
from dmlc_tpu_torch.io import resilience as _resilience
from dmlc_tpu_torch.service import dispatcher as _dispatch
from dmlc_tpu_torch.service.dispatcher import DEFAULT_JOB
from dmlc_tpu_torch.utils import knobs as _knobs
from dmlc_tpu_torch.utils import telemetry as _telemetry
from dmlc_tpu_torch.service.frame import (
    KIND_BLOCK,
    KIND_END,
    KIND_ERROR,
    KIND_HELLO,
    KIND_SNAPSHOT,
    WIRE_CODECS,
    ServiceFrameError,
    annot_key,
    attach_trace,
    block_from_frame,
    recv_frame,
    snapshot_from_frame,
)
from dmlc_tpu_torch.utils.check import DMLCError
from dmlc_tpu_torch.utils.timer import get_time

_LOCATE_POLL_S = 0.05


def connect_worker(host: str, port: int, timeout: float) -> socket.socket:
    """Open a data-plane connection to a parse worker. The one place the
    client connects to a worker, so a test can break it where the JAX
    package's ``worker_rpc`` fault-plan op fires (the port has no fault
    seam)."""
    return socket.create_connection((host, port), timeout=timeout)


class ServiceUnavailableError(DMLCError):
    """No live worker owns the requested part (yet). Retryable — it
    consumes the client's stream-failure budget like any broken stream,
    so a fleet that never recovers surfaces as a ``service_giveups``."""

    def __init__(self, msg: str):
        super().__init__(msg)
        self.__cause__ = ConnectionError(msg)


class ServiceParser(Parser):
    """RowBlock stream served by a parse-worker fleet (one epoch pass =
    one part-major visitation; ``before_first`` rewinds to part 0 —
    workers re-serve from their frame stores, nothing re-parses)."""

    def __init__(self, service: str, job: str = DEFAULT_JOB,
                 retry_policy: Optional["_resilience.RetryPolicy"] = None,
                 connect_timeout: float = 10.0,
                 stream_timeout: float = 300.0):
        self.service = service
        self.job = str(job)
        self._policy = retry_policy or _resilience.default_policy()
        # consumer-side input wait, labeled by job: every second this
        # client waits on the service's wire is the job's starvation
        # signal — summed fleet-wide by the autoscaler via the tracker
        # pod table (docs/service.md fleet autoscaling)
        self._wait_metric = _telemetry.REGISTRY.counter(
            _telemetry.SERVICE_JOB_WAIT_METRIC, job=self.job)
        self._connect_timeout = float(connect_timeout)
        # idle timeout on an ESTABLISHED stream, deliberately much larger
        # than the policy's attempt timeout: a worker mid-parse (slow
        # remote reads, its own retry backoffs) is slow, not dead —
        # misclassifying it as lost would re-queue all its parts
        self._stream_timeout = float(stream_timeout)
        self._closed = threading.Event()
        # the dispatcher's monotonic generation token: an advance means
        # the control plane restarted (docs/service.md) — counted as
        # dispatcher_restarts, after which the (part, block) cursor is
        # revalidated by the next locate and the epoch rides through
        self._gen: Optional[int] = None
        cfg = self._control({"cmd": "config", "job": self.job})
        self.uri = cfg["uri"]
        self.num_parts = int(cfg["num_parts"])
        self.parser_config = dict(cfg.get("parser") or {})
        # the dispatcher-shipped epoch-plan identity (shuffle_seed /
        # shuffle_window) — the seed the fleet's warm-cache serving is
        # keyed by, surfaced so trainer-side planners agree with the
        # workers on one global shuffle (docs/service.md)
        self.plan = dict(cfg.get("plan") or {})
        self.shuffle_seed = self.plan.get("shuffle_seed")
        # dispatcher-decided snapshot mode: with a geometry shipped, the
        # fleet streams device-layout PACKED batches instead of CSR
        # blocks (bf16 halves the wire bytes) and delivered blocks are
        # exact-batch-size packed DenseBlocks — DeviceIter's zero-work
        # dense_ready fast path (docs/service.md snapshot frames).
        # Checkpoints stay (part, batch) 'service' states: the packed
        # batches carry no parser-chain annotations to match against.
        self.snapshot = dict(cfg.get("snapshot") or {})
        # the dispatcher-declared QoS class (docs/service.md Production
        # QoS): priority/weight shape this job's grant share, an SLO
        # target is republished as a job-labeled gauge so the pod table
        # shows the job's wait beside the contract the autoscaler holds
        self.qos = dict(cfg.get("qos") or {})
        if self.qos.get("slo_wait_frac"):
            _telemetry.REGISTRY.gauge(
                _telemetry.SERVICE_JOB_SLO_METRIC,
                job=self.job).set(float(self.qos["slo_wait_frac"]))
        self._part = 0
        self._pos = 0          # next block index within the current part
        self._delivered = 0    # blocks delivered this epoch (all parts)
        self._sock: Optional[socket.socket] = None
        self._owner: Optional[str] = None
        # the owner the dispatcher last pointed us at, kept across the
        # connect itself: a located worker that refuses the connection is
        # just as dead as one that drops mid-frame and must be reported,
        # or the dispatcher keeps handing it out for the liveness window
        self._pending_owner: Optional[str] = None
        self._failover_from: Optional[str] = None
        # owner already granted one same-owner retry for a torn frame
        # (ServiceFrameError): the first CRC blip re-requests the exact
        # block from the SAME worker; only a repeat escalates to
        # report_lost (which re-queues the worker's whole share)
        self._soft_retry_owner: Optional[str] = None
        # elastic-membership state (docs/service.md): the owner we last
        # located the CURRENT part at (sent as `have` so the dispatcher
        # can hint `moved` when the part was re-assigned), the owner a
        # graceful drain notice moved us off (pending handoff), and a
        # bound on consecutive drain moves (a drain gone wrong must fall
        # back to the normal fault budget, never spin)
        self._last_located: Optional[str] = None
        self._drain_move_from: Optional[str] = None
        self._drain_moves = 0
        # the CURRENT part's trace context — the grant trace the
        # dispatcher hands back on `locate`, re-offered to the worker on
        # the stream request and scoped around this client's recv/decode
        # so one (job, part) renders as one causal trace across all
        # three processes (docs/observability.md Distributed tracing)
        self._trace_ctx: Optional[tuple] = None
        self._stream_failures = 0
        self._bytes = 0
        self._recv_seconds = 0.0
        self._decode_seconds = 0.0
        self._last_annot: Optional[dict] = None
        # ---- wire v2 session state (docs/service.md Wire v2) ----
        # negotiated PER STREAM at open: the client always offers v2 and
        # peeks the first frame — a HELLO means a v2 worker (pipelined
        # newline-JSON fetches, negotiated codec, fast-path offer); any
        # other frame means a v1 worker already pushing, and the peeked
        # frame is stashed so nothing on the wire is lost
        self._pipeline_depth = _knobs.resolve("service_pipeline_depth")
        # what this client OFFERS at stream open (the negotiated result
        # lands in _wire per stream): 2 everywhere, pinned to 1 only as
        # an operational escape hatch / for the compat test matrix
        self._offer_wire = 2
        self._wire = 1
        self._codec: Optional[str] = None
        self._pending: Optional[tuple] = None
        self._inflight = 0          # v2 fetches issued, reply not read
        self._next_fetch = 0        # v2: next block index to fetch
        self._blocks_total: Optional[int] = None  # from HELLO, if complete
        self._fp_reader = None      # co-located mmap fast-path reader
        self._fp_skip = False       # fast path failed: TCP for this part
        self._fastpath_blocks = 0   # blocks served off the mmap, no TCP
        # a finished part's drained, healthy v2 socket parked for reuse:
        # (socket, owner) — adopted by _ensure_stream when the next part
        # locates at the same worker, closed otherwise
        self._held: Optional[tuple] = None

    # ---------------- control plane ----------------

    def _control(self, req: dict) -> dict:
        """One policy-guarded dispatcher round trip: transient
        control-plane faults (connection refused while the dispatcher
        restarts, torn replies — ``dispatcher.request`` classifies them)
        back off and retry under the shared policy, counting
        ``control_plane_retries``; an exhausted budget surfaces as the
        retryable :class:`ServiceUnavailableError` so the stream-fault
        layer above keeps healing. The response's generation stamp is
        inspected, so a dispatcher restart is detected at the next
        control exchange."""
        try:
            resp = self._policy.call(
                lambda: _dispatch.request(self.service, req),
                op="control_plane", what=self.service,
                on_retry=lambda: _resilience.record_event(
                    "control_plane_retries"))
        except DMLCError as exc:
            if _resilience.classify(exc) != _resilience.RETRYABLE:
                raise
            raise ServiceUnavailableError(
                f"service {self.service}: control plane unreachable "
                f"({req.get('cmd')}): {exc}") from exc
        self._note_generation(resp)
        return resp

    def _note_generation(self, resp: dict) -> None:
        gen = resp.get("gen")
        if gen is None:
            return
        gen = int(gen)
        if self._gen is not None and gen > self._gen:
            # the control plane restarted and recovered mid-run: count
            # it; the (part, block) cursor is client-owned, so the next
            # locate against the recovered dispatcher revalidates it and
            # the epoch continues byte-identically
            _resilience.record_event("dispatcher_restarts")
        if self._gen is None or gen > self._gen:
            self._gen = gen

    # ---------------- connection plumbing ----------------

    def _drop_stream(self) -> None:
        sock, self._sock = self._sock, None
        self._owner = None
        # a pending owner is only blameable while ITS connect/stream is in
        # flight: once the stream is dropped (END, epoch reset) a later
        # fault must not report this — by then healthy — worker lost
        self._pending_owner = None
        # v2 session state is per-stream: a reconnect re-negotiates and
        # re-issues the in-flight window from the exact (part, block)
        # cursor — nothing outstanding survives the old socket
        self._wire = 1
        self._codec = None
        self._pending = None
        self._inflight = 0
        self._next_fetch = 0
        self._blocks_total = None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def _close_fastpath(self) -> None:
        reader, self._fp_reader = self._fp_reader, None
        if reader is not None:
            try:
                reader.close()
            except OSError:
                pass

    def _drop_held(self) -> None:
        held, self._held = self._held, None
        if held is not None:
            try:
                held[0].close()
            except OSError:
                pass

    def _locate_owner(self) -> dict:
        """Poll the dispatcher until the current part has a live owner.
        Bounded by the policy's attempt timeout — a fleet with no live
        worker must surface, not spin forever. A ``throttled`` reply
        (admission control shedding this job's grants — docs/service.md
        Production QoS) is NOT a dead fleet: back off on the shared
        RetryPolicy's schedule and extend the deadline, so a
        deliberately-queued batch tenant never burns toward a give-up
        while the fleet is healthy."""
        deadline = get_time() + self._policy.attempt_timeout
        throttles = 0
        while not self._closed.is_set():
            req = {"cmd": "locate", "part": self._part, "job": self.job}
            if self._last_located is not None:
                # tell the dispatcher which owner we were on: a draining
                # re-assignment comes back as a `moved` hint, so the
                # failover happens here — not on a dead socket's timeout
                req["have"] = self._last_located
            resp = self._control(req)
            if resp.get("throttled"):
                _resilience.record_event("service_admission_waits")
                pause = self._policy.backoff(throttles)
                throttles += 1
                deadline = get_time() + self._policy.attempt_timeout
                self._closed.wait(pause)
                continue
            if not resp.get("wait"):
                return resp
            if get_time() >= deadline:
                break
            self._closed.wait(_LOCATE_POLL_S)
        raise ServiceUnavailableError(
            f"service {self.service}: no live worker took part "
            f"{self._part} within {self._policy.attempt_timeout:.0f}s")

    def _ensure_stream(self) -> socket.socket:
        if self._sock is not None:
            return self._sock
        owner = self._locate_owner()
        if self._drain_move_from is not None and owner.get("moved"):
            # the dispatcher's `moved` hint: the drain re-issue landed
            # and this part left the owner we were on — the handoff
            # completed before any socket died (docs/service.md)
            _resilience.record_event("drain_handoffs")
            self._drain_move_from = None
        self._last_located = str(owner["worker"])
        self._pending_owner = str(owner["worker"])
        self._trace_ctx = _telemetry.trace_context_from_wire(
            owner.get("trace"))
        held, self._held = self._held, None
        if held is not None:
            if held[1] == str(owner["worker"]):
                # connection reuse (docs/service.md Wire v2): the next
                # part located at the worker whose drained v2 stream we
                # parked — adopt it; the first fetch line names the new
                # (job, part) and re-targets the stream server-side.
                # No HELLO on a re-target: ENDs close the part, and the
                # fast path waits for the next fresh handshake.
                self._sock, self._owner = held
                self._wire = 2
                self._blocks_total = None
                self._next_fetch = self._pos
                self._inflight = 0
                self._pending = None
                self._failover_from = None
                return self._sock
            try:
                held[0].close()
            except OSError:
                pass
        sock = connect_worker(owner["host"], int(owner["port"]),
                              self._connect_timeout)
        try:
            sock.settimeout(self._stream_timeout)
            req = {"cmd": "stream", "part": self._part, "start": self._pos,
                   "job": self.job}
            # re-offer the part's grant trace to the worker (optional
            # key — old workers ignore it): its service_send spans then
            # join the same trace this client's recv/decode record under
            attach_trace(req, self._trace_ctx)
            offer_v2 = not self.snapshot and self._offer_wire >= 2
            if self.snapshot:
                # snapshot streams stay on the v1 push plane: packed
                # batches are already the minimal wire form
                req["snapshot"] = True
            elif offer_v2:
                # offer wire v2 (docs/service.md Wire v2): a v1 worker
                # ignores the unknown keys and pushes v1 frames — the
                # handshake peek below detects which peer answered
                req["wire"] = 2
                req["accept"] = sorted(WIRE_CODECS)
                req["host"] = socket.gethostname()
            sock.sendall(json.dumps(req).encode() + b"\n")
            if offer_v2:
                self._handshake(sock)
        except BaseException:
            try:
                sock.close()
            except OSError:
                pass
            raise
        self._sock = sock
        self._owner = str(owner["worker"])
        if self._failover_from is not None:
            if self._owner != self._failover_from:
                # resumed mid-part on a DIFFERENT worker: the failover
                # the dispatcher's re-issue path exists for
                _resilience.record_event("service_failovers")
            self._failover_from = None
        return sock

    def _handshake(self, sock: socket.socket) -> None:
        """Peek the first frame of a fresh stream. KIND_HELLO: a v2
        worker — record the negotiated codec / shipped block count, arm
        the pipelined fetch cursor at the exact resume position, and take
        a co-located fast-path offer when one rides the HELLO. Anything
        else: a v1 worker already pushing from ``start`` — stash the
        peeked frame so the delivery loop consumes it first."""
        kind, meta, payload = recv_frame(sock)
        if kind != KIND_HELLO:
            self._wire = 1
            self._pending = (kind, meta, payload)
            return
        self._wire = 2
        self._codec = meta.get("codec")
        total = meta.get("blocks")
        self._blocks_total = None if total is None else int(total)
        self._next_fetch = self._pos
        self._inflight = 0
        if not self._fp_skip:
            self._open_fastpath(meta.get("fastpath"))

    def _open_fastpath(self, offer) -> None:
        """Map a co-located worker's published block-cache artifact and
        serve the part off the mmap, skipping TCP entirely. The reader
        pins the artifact against byte-budget eviction for as long as it
        is open (docs/store.md), and the blocks it yields are the same
        cache spans the worker would have framed — byte-identical arrays
        AND resume annotations. Any mismatch falls back to TCP."""
        if not isinstance(offer, dict):
            return
        path = str(offer.get("path") or "")
        if not path or not os.path.exists(path):
            return
        from dmlc_tpu_torch.io.block_cache import BlockCacheReader

        try:
            reader = BlockCacheReader(path)
        except (DMLCError, OSError, ValueError):
            return  # unreadable / torn artifact: TCP serves the part
        blocks = offer.get("blocks")
        if (blocks is not None and int(blocks) != reader.num_blocks) or (
                self._blocks_total is not None
                and self._blocks_total != reader.num_blocks):
            # the artifact on disk disagrees with what the worker serves:
            # trust the wire, not the map
            try:
                reader.close()
            except OSError:
                pass
            return
        self._close_fastpath()
        self._fp_reader = reader

    def _on_stream_fault(self, exc: BaseException) -> None:
        """One broken stream: count it, tell the dispatcher, back off.
        Budget: the shared policy's max_attempts of consecutive faults
        with no delivered block in between."""
        _resilience.record_event("service_retries")
        lost = self._owner or self._pending_owner
        self._pending_owner = None
        self._drop_stream()
        soft = (isinstance(exc, ServiceFrameError) and lost is not None
                and lost != self._soft_retry_owner)
        if soft:
            # a torn frame from a live, talking worker (wire blip): the
            # resume protocol re-requests the exact block — try the same
            # owner once before report_lost re-queues its whole share
            self._soft_retry_owner = lost
            self._failover_from = lost
        elif lost is not None:
            self._failover_from = lost
            try:
                self._control({"cmd": "report_lost", "worker": lost})
            except (OSError, DMLCError, ValueError):
                pass  # dispatcher unreachable too: the locate poll decides
        used = self._stream_failures
        self._stream_failures += 1
        if self._stream_failures >= self._policy.max_attempts:
            _resilience.record_event("service_giveups")
            raise DMLCError(
                f"service {self.service}: part {self._part} stream failed "
                f"{self._stream_failures} times (budget "
                f"{self._policy.max_attempts}): {exc}") from exc
        self._policy.sleep(self._policy.backoff(used))

    def _trace_scope(self):
        """The current part's trace context as a span scope: recv/decode
        spans recorded inside inherit the grant's trace id (or none when
        propagation is off / the dispatcher predates tracing)."""
        ctx = self._trace_ctx
        return _telemetry.trace(ctx[0] if ctx else None,
                                ctx[1] if ctx else "")

    # ---------------- wire v2 engine ----------------

    def _recv_stream(self, sock: socket.socket) -> tuple:
        """One frame off the stream. v1: the worker pushes — just read
        (the handshake's peeked frame first). v2: top the pipelined fetch
        window up to ``service_pipeline_depth`` outstanding requests,
        then read — the worker answers FIFO, so RTT and per-block turn
        around hide behind the in-flight window."""
        if self._pending is not None:
            frame, self._pending = self._pending, None
            return frame
        if self._wire >= 2:
            self._fill_window(sock)
            frame = recv_frame(sock)
            self._inflight -= 1
            return frame
        return recv_frame(sock)

    def _fill_window(self, sock: socket.socket) -> None:
        """Issue fetch lines until ``service_pipeline_depth`` are in
        flight. With the part's block count known (HELLO on a complete
        part) the window stops one PAST the last block, so the final
        fetch elicits the END that closes the part; with the count
        unknown (mid-parse part, re-targeted stream) the window runs
        optimistically and every past-end fetch is answered by an END."""
        depth = max(1, int(self._pipeline_depth))
        lim = None if self._blocks_total is None else self._blocks_total + 1
        while self._inflight < depth:
            if lim is not None and self._next_fetch >= lim:
                break
            sock.sendall(json.dumps(
                {"block": self._next_fetch, "part": self._part,
                 "job": self.job}).encode() + b"\n")
            self._next_fetch += 1
            self._inflight += 1

    def _hold_stream(self) -> None:
        """Close out a finished part's v2 stream for reuse: drain the
        window's trailing ENDs (FIFO — every in-flight fetch past the
        end got one) and park the healthy socket; ``_ensure_stream``
        adopts it when the next part locates at the same worker. Any
        surprise on the drain just drops the socket — reuse is an
        optimization, never a correctness hinge."""
        sock, owner = self._sock, self._owner
        clean = self._wire >= 2 and sock is not None and owner is not None
        while clean and self._inflight > 0:
            try:
                kind, _meta, _payload = recv_frame(sock)
            except (ConnectionError, OSError, ServiceFrameError):
                clean = False
                break
            self._inflight -= 1
            if kind != KIND_END:
                clean = False
        if clean:
            self._sock = None  # detach so _drop_stream cannot close it
            self._drop_stream()
            self._drop_held()
            self._held = (sock, owner)
        else:
            self._drop_stream()

    def _fastpath_next(self, t0: float) -> Optional[RowBlock]:
        """One block off the co-located mmap (docs/service.md Wire v2
        fast path): the same cache span / resume annotation the worker
        would have framed, with zero wire bytes. Returns None when the
        part is finished (cursor advanced, reader closed — its eviction
        pin drops with it) or when the map failed mid-part (falls back
        to TCP at the exact block cursor)."""
        reader = self._fp_reader
        if self._pos >= reader.num_blocks:
            self._close_fastpath()
            self._part += 1
            self._pos = 0
            self._last_located = None
            self._drain_move_from = None
            self._fp_skip = False
            return None
        i = self._pos
        t1 = get_time()
        try:
            segments = reader.load_segments(i)
            block = RowBlock.from_segments(segments, hold=reader.hold)
            block.encoded = reader.block_encoded(i)
            annot = reader.resume(i)
            nbytes = reader.block_nbytes(i)
        except (DMLCError, OSError, ValueError):
            # torn/evicted/corrupt map mid-part: the wire is the source
            # of truth — resume over TCP at this exact block
            self._close_fastpath()
            self._fp_skip = True
            return None
        if annot is not None:
            block.resume_state = annot
        if self._trace_ctx is not None:
            block.trace_ctx = self._trace_ctx
        dt = get_time() - t0
        self._recv_seconds += dt
        self._wait_metric.inc(dt)
        self._decode_seconds += get_time() - t1
        self._bytes += nbytes
        self._pos += 1
        self._delivered += 1
        self._fastpath_blocks += 1
        self._stream_failures = 0
        self._soft_retry_owner = None
        self._drain_moves = 0
        self._last_annot = annot
        return block

    def resize_pipeline_depth(self, depth: int) -> bool:
        """Autotuner seam (docs/data.md feedback controller): the read
        stage climbs ``service_pipeline_depth`` through this, the same
        duck-typed contract as ``resize_prefetch``. Takes effect at the
        next window fill — an oversized in-flight window simply drains
        down. Returns False when nothing changed."""
        depth = int(depth)
        if depth < 1 or depth == self._pipeline_depth:
            return False
        self._pipeline_depth = depth
        return True

    @property
    def pipeline_depth(self) -> int:
        return self._pipeline_depth

    @property
    def fastpath_blocks(self) -> int:
        """Blocks served off the co-located mmap fast path (the bench's
        ``service_wire_fastpath``) — only the client can count these:
        the worker just sees its stream close."""
        return self._fastpath_blocks

    # ---------------- Parser contract ----------------

    def next_block(self) -> Optional[RowBlock]:
        while self._part < self.num_parts:
            t0 = get_time()
            try:
                if self._fp_reader is None:
                    self._ensure_stream()
                if self._fp_reader is not None:
                    # co-located fast path: the part serves off the mmap;
                    # the handshake socket is released (the worker's
                    # fetch-read returns EOF and the handler exits)
                    self._drop_stream()
                    block = self._fastpath_next(t0)
                    if block is None:
                        continue  # part done / fell back: loop re-aims
                    return block
                sock = self._sock
                with self._trace_scope():
                    kind, meta, payload = self._recv_stream(sock)
            except (ConnectionError, OSError,
                    ServiceFrameError, ServiceUnavailableError) as exc:
                # torn dispatcher replies arrive as ConnectionError —
                # dispatcher.request classifies them centrally, so no
                # call-site ValueError special case survives here
                dt = get_time() - t0
                self._recv_seconds += dt
                self._wait_metric.inc(dt)
                self._on_stream_fault(exc)
                continue
            dt = get_time() - t0
            self._recv_seconds += dt
            self._wait_metric.inc(dt)
            if kind == KIND_BLOCK:
                t1 = get_time()
                with self._trace_scope():
                    block = block_from_frame(meta, payload)
                self._decode_seconds += get_time() - t1
                self._bytes += len(payload)
                self._pos += 1
                self._delivered += 1
                self._stream_failures = 0  # progress resets the budget
                self._soft_retry_owner = None
                self._drain_moves = 0
                self._last_annot = meta.get("resume")
                if self._trace_ctx is not None:
                    # ride the trace to the device dispatch: DeviceIter's
                    # dispatch span picks this up whatever thread it runs
                    # on (docs/observability.md)
                    block.trace_ctx = self._trace_ctx
                return block
            if kind == KIND_SNAPSHOT:
                # device-layout packed batch: decode to a packed
                # DenseBlock (zero-copy views over the payload) —
                # DeviceIter serves it through the dense_ready fast path
                t1 = get_time()
                with self._trace_scope():
                    bkind, *arrays = snapshot_from_frame(meta, payload)
                if bkind != "dense_packed":
                    self._on_stream_fault(DMLCError(
                        f"unsupported snapshot frame kind {bkind!r}"))
                    continue
                xp = arrays[0]
                nc = int(self.snapshot["num_col"])
                block = DenseBlock(xp, xp[:, nc], xp[:, nc + 1],
                                   hold=payload, packed=True)
                # the frame payload IS the device-decodable span (same
                # write_segments bytes as an on-disk snapshot batch, meta
                # offsets payload-relative): keep it + its layout beside
                # the host views so a device_decode=True DeviceIter can
                # ship the raw bytes and decode on the device (ops/device_decode)
                import numpy as _np

                from dmlc_tpu_torch.io.block_cache import span_layout
                block.device_span = (
                    _np.frombuffer(payload, dtype=_np.uint8),
                    span_layout(meta["arrays"], meta.get("shapes"),
                                base=0),
                    bkind)
                resume = meta.get("resume")
                if resume is not None:
                    block.resume_state = resume
                self._decode_seconds += get_time() - t1
                self._bytes += len(payload)
                self._pos += 1
                self._delivered += 1
                self._stream_failures = 0
                self._soft_retry_owner = None
                self._drain_moves = 0
                self._last_annot = resume
                if self._trace_ctx is not None:
                    block.trace_ctx = self._trace_ctx
                return block
            if kind == KIND_END:
                total = meta.get("blocks")
                if total is not None and int(total) != self._pos:
                    # the shipped count is the delivery cross-check: a
                    # worker ending a part early (truncated parse marked
                    # complete) must read as a fault to fail over, never
                    # as a silently short epoch
                    self._on_stream_fault(DMLCError(
                        f"part {self._part} truncated: END after block "
                        f"{self._pos} of {total}"))
                    continue
                if meta.get("draining"):
                    # the part was served out by a DRAINING worker:
                    # confirm the handoff so the drain can complete
                    # before its deadline instead of waiting it out —
                    # and never park its socket (the worker is leaving)
                    self._confirm_handoff(self._part, self._owner)
                    self._drop_stream()
                else:
                    self._hold_stream()
                self._part += 1
                self._pos = 0
                self._last_located = None
                self._drain_move_from = None
                self._fp_skip = False
                continue
            if kind == KIND_ERROR and meta.get("draining"):
                # GRACEFUL drain notice: the worker is leaving and the
                # dispatcher already re-issued this part. Relocate right
                # away — no report_lost (the worker still serves its
                # complete parts), no retry budget, no backoff. Bounded:
                # repeated drain notices with no progress fall through
                # to the normal fault path so a drain gone wrong still
                # consumes budget instead of spinning.
                self._drain_moves += 1
                if self._drain_moves <= 3:
                    mover = self._owner or self._pending_owner
                    self._drop_stream()
                    self._drain_move_from = mover
                    # keep `have` pointing at the drained-off owner so
                    # the relocate's `moved` hint is meaningful
                    self._last_located = mover
                    continue
            # KIND_ERROR (worker reassigned / parse failure): retryable —
            # the dispatcher may have moved the part; ERROR text rides the
            # chained cause for the give-up message
            self._on_stream_fault(DMLCError(
                f"worker error frame: {meta.get('error')}"
                if kind == KIND_ERROR else f"unknown frame kind {kind}"))
        return None

    def _confirm_handoff(self, part: int, worker: Optional[str]) -> None:
        """Best-effort drain-handoff confirmation (``drain_handoffs``):
        tells the dispatcher this client is done streaming ``part`` from
        the draining ``worker``. A miss only delays the drain until its
        deadline — never a correctness problem."""
        if worker is None:
            return
        _resilience.record_event("drain_handoffs")
        try:
            self._control({"cmd": "handoff", "part": int(part),
                           "worker": worker, "job": self.job})
        except (OSError, DMLCError, ValueError):
            pass  # deadline backstop covers it

    def before_first(self) -> None:
        self._drop_stream()
        self._close_fastpath()
        self._drop_held()
        self._fp_skip = False
        self._part = 0
        self._pos = 0
        self._delivered = 0
        self._stream_failures = 0
        self._failover_from = None
        self._soft_retry_owner = None
        self._last_annot = None
        self._last_located = None
        self._drain_move_from = None
        self._drain_moves = 0
        self._trace_ctx = None

    # ---------------- checkpoint / resume ----------------

    def state_dict(self) -> dict:
        """O(1) resume point: the next (part, block) to deliver —
        restorable into a fresh client against the same service AND the
        same job (positions are only meaningful within one job's
        part-major order, so the job rides the state)."""
        return {"kind": "service", "job": self.job, "part": self._part,
                "block": self._pos, "blocks": self._delivered}

    def _part_query(self, part: int, req: dict) -> dict:
        """One JSON request to the worker serving ``part`` (find/count),
        under the shared retry policy with dispatcher-driven relocation.
        The reply socket gets the stream (not attempt) timeout — the
        worker legitimately blocks until the part is fully parsed, and
        slow-mid-parse is not dead."""
        def attempt():
            owner = self._locate_with_part(part)
            sock = socket.create_connection(
                (owner["host"], int(owner["port"])),
                timeout=self._connect_timeout)
            try:
                sock.settimeout(self._stream_timeout)
                sock.sendall(json.dumps(
                    dict(req, part=part, job=self.job)).encode() + b"\n")
                with sock.makefile("rb") as f:
                    line = f.readline()
            finally:
                sock.close()
            if not line:
                raise ConnectionError(f"part {part}: empty reply")
            try:
                resp = json.loads(line)
            except ValueError as exc:
                # a torn worker reply (died mid-response) is the same
                # transient fault as the connection dropping
                raise ConnectionError(
                    f"part {part}: torn reply {line[:64]!r}") from exc
            if "error" in resp:
                # the located worker cannot answer authoritatively (stale
                # assignment, interrupted parse): heal exactly like the
                # stream path — report it, let the dispatcher re-issue,
                # and retry against the new owner. A wrong count/find
                # would silently restore the wrong position.
                try:
                    self._control({"cmd": "report_lost",
                                   "worker": str(owner["worker"])})
                except (OSError, DMLCError, ValueError):
                    pass
                raise ServiceUnavailableError(
                    f"part {part}: {resp['error']}")
            return resp

        return self._policy.call(attempt, op="worker_rpc",
                                 what=f"part {part}")

    def _locate_with_part(self, part: int) -> dict:
        prev, prev_located = self._part, self._last_located
        self._part, self._last_located = part, None
        try:
            return self._locate_owner()
        finally:
            self._part, self._last_located = prev, prev_located

    def _part_counts_until(self, stop_part: int) -> int:
        """Total blocks in parts [0, stop_part) — the global-delivery
        offset a (part, block) position corresponds to."""
        return sum(int(self._part_query(p, {"cmd": "count"})["blocks"])
                   for p in range(stop_part))

    def load_state(self, state: dict) -> None:
        self._drop_stream()
        self._close_fastpath()
        self._drop_held()
        self._fp_skip = False
        self._stream_failures = 0
        self._failover_from = None
        self._soft_retry_owner = None
        self._last_annot = None
        self._last_located = None
        self._drain_move_from = None
        self._drain_moves = 0
        kind = state.get("kind")
        if self.snapshot and kind != "service":
            # per-part batch counts differ from block counts and packed
            # batches carry no parser-chain annotations — a foreign state
            # must fail loudly, not restore a wrong position
            raise DMLCError(
                "snapshot-mode service clients restore (part, batch) "
                f"'service' states only, got kind {kind!r} "
                "(docs/service.md snapshot frames)")
        if kind == "service":
            # legacy job-less states were written against the default
            # job — defaulting to self.job would let them restore into
            # ANY job-bound client and silently serve the wrong data
            state_job = str(state.get("job", DEFAULT_JOB))
            if state_job != self.job:
                # a (part, block) cursor is a position in ONE job's
                # part-major order — restoring it into another job would
                # silently serve the wrong data
                raise DMLCError(
                    f"service checkpoint belongs to job {state_job!r}, "
                    f"this client is bound to job {self.job!r} "
                    f"(docs/service.md multi-tenant service)")
            self._part = int(state["part"])
            self._pos = int(state["block"])
            self._delivered = int(state.get(
                "blocks", state.get("block", 0)))
            return
        if kind == "blocks" or kind == "block_cache":
            # a delivered-block count maps onto the part-major order via
            # the workers' per-part block counts
            n = int(state.get("blocks", state.get("block", 0)))
            part = 0
            while part < self.num_parts:
                c = int(self._part_query(part, {"cmd": "count"})["blocks"])
                if n < c:
                    break
                n -= c
                part += 1
            self._part, self._pos = part, n
            self._delivered = int(state.get("blocks",
                                            state.get("block", 0)))
            return
        if kind in ("split", "chunks"):
            if not state.get("chunks") and not state.get("blocks"):
                self.before_first()  # epoch-start state
                return
            key = annot_key(state)
            for part in range(self.num_parts):
                idx = int(self._part_query(
                    part, {"cmd": "find", "key": key})["block"])
                if idx >= 0:
                    # annotations mark the position AFTER their block
                    self._part = part
                    self._pos = idx + 1
                    self._delivered = (self._part_counts_until(part)
                                       + idx + 1)
                    return
            raise DMLCError(
                f"service {self.service}: no serving worker holds a block "
                f"matching the checkpoint annotation (stale state?)")
        raise DMLCError(f"ServiceParser: unknown state kind {kind!r}")

    # ---------------- metrics ----------------

    def stage_seconds(self) -> Dict[str, float]:
        """Frame recv waits report as the pipeline's ``read`` stage,
        decode as ``parse`` — so ``DeviceIter.stats()`` attributes a
        service-fed pipeline with the same keys as a local one (the
        service-specific twins are the ``service_recv``/``service_decode``
        spans)."""
        return {"read": self._recv_seconds, "parse": self._decode_seconds}

    @property
    def bytes_read(self) -> int:
        return self._bytes

    def close(self) -> None:
        self._closed.set()
        self._drop_stream()
        self._close_fastpath()
        self._drop_held()
