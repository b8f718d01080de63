"""Input-wait-driven fleet autoscaler: capacity follows starvation.

The port's copy of the JAX package's ``service/autoscale.py``, with its wire,
JSON, journal records, counters and messages.

The fleet-granularity reuse of the pipeline autotuner's feedback-controller pattern
(AUTOTUNE, arXiv:2101.12127 — measure a starvation signal, move ONE knob
one step, hold through hysteresis): where ``DeviceIter``'s controller
moves pipeline knobs toward ``gap_stage == transfer``, this one moves
the **parse-fleet worker count** toward "no trainer waits on input",
which is the tf.data-service scaling thesis (arXiv:2210.14826 §3.3 —
the input tier scales independently of the trainers).

**Signal.** Each :class:`~dmlc_tpu_torch.service.client.ServiceParser` labels
its consumer-side wire wait with its job on the telemetry registry
(``service_job_input_wait_seconds``); worker/trainer ranks ship that to
the tracker over the ``metrics`` heartbeat, and
``RabitTracker.pod_job_metrics()`` sums it fleet-wide per job. The
autoscaler's ``source`` callable returns that aggregate —
``{job: cumulative input_wait_seconds}`` — each control tick; the
per-tick delta divided by the tick interval is the job's **wait
fraction** (~1.0 = the job's trainers are fully input-bound, ~0 = the
fleet keeps up).

**Control law** (one decision per tick, docs/service.md fleet
autoscaling):

- *per-job SLO fairness*: each job's wait fraction is measured against
  its OWN target — ``register_job(slo_wait_frac=)`` when declared,
  ``grow_frac`` otherwise — never a mean, so a starved job cannot be
  drowned by a greedy (or idle) sibling averaging it away. Among jobs
  over target, the **highest-priority** one drives the decision
  (docs/service.md Production QoS); because the dispatcher's grant
  scheduling serves higher bands first, capacity added for that job
  actually reaches it.
- *grow*: some job over its target for ``up_ticks`` CONSECUTIVE
  ticks and the live fleet is under ``DMLC_TPU_FLEET_MAX`` -> one
  worker live-joins (``LocalFleet.add_worker()``, the live-join path),
  counted as ``fleet_scale_ups``.
- *shrink*: EVERY job's wait fraction < ``shrink_frac`` for
  ``down_ticks`` consecutive ticks and the live fleet is over
  ``DMLC_TPU_FLEET_MIN`` -> the most recently added worker drains
  gracefully (notice -> no new grants -> serve out -> exit; departure
  is safe by construction), counted as ``fleet_scale_downs``.
- *hysteresis*: the consecutive-tick requirements plus a
  ``cooldown_ticks`` freeze after every scale event — capacity changes
  take a while to show in the wait signal, and reacting to a stale
  window is exactly the flapping the bench gate forbids
  (``fleet_scale_events`` must be 0 on a clean run).

Knobs ride the validated knob table (``DMLC_TPU_FLEET_MIN`` /
``DMLC_TPU_FLEET_MAX`` / ``DMLC_TPU_FLEET_SCALE_INTERVAL``,
:mod:`dmlc_tpu_torch.utils.knobs`). The controller itself is deliberately
transport-agnostic and test-drivable: construct with ``start=False``
and call :meth:`step` directly, or ``start=True`` for the background
tick thread a deployment runs.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, List, Optional

from dmlc_tpu_torch.io import resilience as _resilience
from dmlc_tpu_torch.utils import knobs as _knobs
from dmlc_tpu_torch.utils import telemetry as _telemetry
from dmlc_tpu_torch.utils.check import check
from dmlc_tpu_torch.utils.timer import get_time

logger = logging.getLogger("dmlc_tpu_torch.service")

# decision verdicts (the history records one per tick)
GROW = "grow"
SHRINK = "shrink"
HOLD = "hold"

HISTORY_LIMIT = 128


class FleetAutoscaler:
    """Grow/drain a :class:`~dmlc_tpu_torch.service.fleet.LocalFleet` from the
    aggregated per-job input-wait signal.

    ``source`` returns ``{job: cumulative input_wait_seconds}`` (the
    shape of ``RabitTracker.pod_job_metrics()`` flattened to the wait
    values — a tracker is adapted automatically when passed as
    ``tracker=``). ``min_workers`` / ``max_workers`` / ``interval``
    default to the ``fleet_min`` / ``fleet_max`` /
    ``fleet_scale_interval`` knob rows; explicit arguments win (tests
    drive sub-second intervals).
    """

    def __init__(self, fleet,
                 source: Optional[Callable[[], Dict[str, float]]] = None,
                 tracker=None,
                 qos_source: Optional[Callable[[], Dict[str, dict]]] = None,
                 min_workers: Optional[int] = None,
                 max_workers: Optional[int] = None,
                 interval: Optional[float] = None,
                 grow_frac: float = 0.5,
                 shrink_frac: float = 0.1,
                 up_ticks: int = 2,
                 down_ticks: int = 4,
                 cooldown_ticks: int = 2,
                 start: bool = False):
        check(source is not None or tracker is not None
              or getattr(fleet, "tracker", None) is not None,
              "FleetAutoscaler needs an input-wait source: pass "
              "source= (a {job: wait_seconds} callable) or tracker=, "
              "or build the fleet with tracker=True "
              "(docs/service.md fleet autoscaling)")
        self.fleet = fleet
        if source is None:
            trk = tracker if tracker is not None else fleet.tracker

            def source():
                return {job: rec.get("input_wait_seconds", 0.0)
                        for job, rec in trk.pod_job_metrics().items()}
        self._source = source
        # the jobs' QoS classes ({job: {priority, slo_wait_frac, ...}},
        # docs/service.md Production QoS): defaults to the fleet's
        # dispatcher view so registered SLOs steer the controller with
        # zero wiring; a fleet/stub without one degrades to the
        # pre-QoS max-over-jobs law
        if qos_source is None:
            qos_source = getattr(fleet, "job_qos", None)
        self._qos_source = qos_source
        self.min_workers = _knobs.resolve("fleet_min", min_workers)
        self.max_workers = _knobs.resolve("fleet_max", max_workers)
        check(self.min_workers <= self.max_workers,
              f"fleet autoscaler bounds inverted: min {self.min_workers}"
              f" > max {self.max_workers} (check the DMLC_TPU_FLEET_MIN/"
              f"MAX pair)")
        self.interval = (float(interval) if interval is not None
                         else float(_knobs.resolve("fleet_scale_interval")))
        check(self.interval > 0,
              f"fleet autoscaler interval {self.interval} must be > 0")
        self.grow_frac = float(grow_frac)
        self.shrink_frac = float(shrink_frac)
        self.up_ticks = int(up_ticks)
        self.down_ticks = int(down_ticks)
        self.cooldown_ticks = int(cooldown_ticks)
        self._last: Optional[Dict[str, float]] = None
        self._last_t: Optional[float] = None
        self._starved_streak = 0
        self._idle_streak = 0
        self._cooldown = 0
        self.ticks = 0
        self.scale_ups = 0
        self.scale_downs = 0
        # workers this controller added, newest last — shrink drains
        # these first (LIFO), so operator-provisioned baseline capacity
        # outlives elastic capacity
        self._added: List[object] = []
        self.history: List[dict] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if start:
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="fleet-autoscaler")
            self._thread.start()

    # ---------------- control loop ----------------

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.step()
            except Exception as exc:  # noqa: BLE001 - the controller
                # must never take the fleet down with it: a failed tick
                # (tracker hiccup, fleet mid-close) logs and the next
                # tick retries
                logger.warning("fleet autoscaler: tick failed: %s", exc)

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    # ---------------- one decision ----------------

    def _live_count(self) -> int:
        return len(self.fleet.live_workers())

    def step(self, now: Optional[float] = None) -> dict:
        """One control tick: read the signal, compute per-job wait
        fractions for the window since the last tick, and make at most
        one scale decision. Returns the decision record (also appended
        to :attr:`history`)."""
        now = get_time() if now is None else float(now)
        waits = {str(j): float(v)
                 for j, v in (self._source() or {}).items()}
        if self._last is None or self._last_t is None:
            # first tick primes the window — no decision can be made
            # from a cumulative counter without a delta
            self._last, self._last_t = waits, now
            return self._record(HOLD, {}, "priming window")
        window = max(now - self._last_t, 1e-9)
        fracs = {}
        for job, total in waits.items():
            delta = max(0.0, total - self._last.get(job, 0.0))
            fracs[job] = min(1.0, delta / window)
        self._last, self._last_t = waits, now
        self.ticks += 1
        # one time-series sample per control tick: the bounded
        # metrics-history ring is what answers "what did input_wait
        # look like when the autoscaler grew" after the fact
        # (docs/observability.md Prometheus exposition)
        _telemetry.sample_metrics_history()
        # SLO-aware per-job fairness (docs/service.md Production QoS):
        # each job is measured against its OWN input-wait target
        # (register_job(slo_wait_frac=), default grow_frac), and among
        # the over-target jobs the HIGHEST-PRIORITY one drives the
        # decision (ties broken by relative overage) — capacity grows
        # for the latency-critical tenant breaching its SLO, never for
        # whichever batch job happens to wait hardest. Without QoS
        # specs every target is grow_frac and this degenerates to the
        # historical max-over-jobs law.
        qos = self._job_qos()

        def target(job: str) -> float:
            slo = (qos.get(job) or {}).get("slo_wait_frac")
            return float(slo) if slo else self.grow_frac

        over = [j for j, f in fracs.items() if f > target(j)]
        if over:
            starved_job = max(
                over,
                key=lambda j: (int((qos.get(j) or {}).get("priority", 0)),
                               fracs[j] / target(j)))
        else:
            starved_job = max(fracs, key=fracs.get) if fracs else None
        starved_frac = fracs.get(starved_job, 0.0) if starved_job \
            else 0.0
        if self._cooldown > 0:
            self._cooldown -= 1
            self._starved_streak = 0
            self._idle_streak = 0
            return self._record(HOLD, fracs,
                                f"cooldown ({self._cooldown} left)")
        if over:
            self._starved_streak += 1
            self._idle_streak = 0
        elif fracs and max(fracs.values()) < self.shrink_frac:
            self._idle_streak += 1
            self._starved_streak = 0
        else:
            self._starved_streak = 0
            self._idle_streak = 0
        live = self._live_count()
        if self._starved_streak >= self.up_ticks:
            if live >= self.max_workers:
                return self._record(
                    HOLD, fracs, f"starved (job {starved_job} at "
                    f"{starved_frac:.2f}) but at fleet_max "
                    f"{self.max_workers}")
            return self._grow(fracs, starved_job, starved_frac,
                              target(starved_job) if starved_job
                              else self.grow_frac, live)
        if self._idle_streak >= self.down_ticks:
            if live <= self.min_workers:
                return self._record(
                    HOLD, fracs, f"idle but at fleet_min "
                    f"{self.min_workers}")
            return self._shrink(fracs, live)
        return self._record(HOLD, fracs, "within hysteresis band")

    def _job_qos(self) -> Dict[str, dict]:
        """The jobs' QoS classes from the configured source; a source
        hiccup (dispatcher mid-restart) degrades to no-QoS for the tick
        — the controller never dies on its input."""
        if self._qos_source is None:
            return {}
        try:
            return {str(j): dict(q or {})
                    for j, q in (self._qos_source() or {}).items()}
        except Exception as exc:  # noqa: BLE001
            logger.warning("fleet autoscaler: qos source failed: %s", exc)
            return {}

    def _grow(self, fracs: dict, job: Optional[str], frac: float,
              tgt: float, live: int) -> dict:
        worker = self.fleet.add_worker()
        self._added.append(worker)
        self.scale_ups += 1
        self._starved_streak = 0
        self._cooldown = self.cooldown_ticks
        _resilience.record_event("fleet_scale_ups")
        logger.warning(
            "fleet autoscaler: job %s input-wait frac %.2f > target "
            "%.2f — grew fleet %d -> %d (worker %s live-joined)", job,
            frac, tgt, live, live + 1, worker.worker_id)
        return self._record(GROW, fracs,
                            f"job {job} wait frac {frac:.2f}",
                            worker=worker.worker_id)

    def _shrink(self, fracs: dict, live: int) -> dict:
        # drain elastic capacity LIFO; fall back to the fleet's newest
        # live worker when the controller added none (operator scaled
        # by hand, controller drains back)
        victim = None
        while self._added and victim is None:
            cand = self._added.pop()
            if cand in self.fleet.live_workers():
                victim = cand
        if victim is None:
            victim = self.fleet.live_workers()[-1]
        victim.drain(reason="fleet autoscaler shrink")
        self.scale_downs += 1
        self._idle_streak = 0
        self._cooldown = self.cooldown_ticks
        _resilience.record_event("fleet_scale_downs")
        logger.warning(
            "fleet autoscaler: all jobs idle — draining worker %s "
            "(%d -> %d)", victim.worker_id, live, live - 1)
        return self._record(SHRINK, fracs, "all jobs under "
                            f"{self.shrink_frac:.2f}",
                            worker=victim.worker_id)

    def _record(self, action: str, fracs: dict, why: str,
                worker: Optional[str] = None) -> dict:
        rec = {"action": action,
               "wait_fracs": {j: round(f, 4) for j, f in fracs.items()},
               "fleet_size": self._live_count(),
               "why": why}
        if worker is not None:
            rec["worker"] = worker
        if action != HOLD:
            # scale events land on the audit ledger (HOLD ticks stay in
            # the local history only — one decision event per actual
            # control action, docs/observability.md Decision ledger)
            _telemetry.record_decision(
                "autoscaler", action,
                trigger={"wait_fracs": rec["wait_fracs"],
                         "fleet_size": rec["fleet_size"]},
                outcome=why, worker=worker)
        self.history.append(rec)
        if len(self.history) > HISTORY_LIMIT:
            del self.history[:len(self.history) - HISTORY_LIMIT]
        return rec

    def snapshot(self, history: int = 16) -> dict:
        """The controller's decision record (operators/bench): bounds,
        tick/scale tallies, and the recent decision history."""
        return {
            "min_workers": self.min_workers,
            "max_workers": self.max_workers,
            "interval": self.interval,
            "ticks": self.ticks,
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "fleet_size": self._live_count(),
            "history": list(self.history[-history:]),
        }
