"""Elastic membership of the port's fleet against the JAX package's, and
fleets mixing the packages: a dispatcher of one with parse workers of the
other, since the control plane is JSON lines on TCP.

- drain and replace mid-epoch (``drain_worker`` + ``add_worker``): the
  stream equal to local parsing, ``worker_drains`` 1, ``worker_joins`` 1,
  at least one ``drain_handoffs``, no retry or give-up, every part parsed
  once fleet-wide, for every fleet x client pair;
- a drain landing mid-parse: the part re-issued to a fresh worker, the
  client relocated without a fault, the dispatcher and the workers of
  either package;
- the preemption notice file (``DMLC_TPU_PREEMPTION_NOTICE``) drains a
  worker of either package with ``preemption_notices`` 1 and
  ``worker_drains`` 1 (the JAX package's ``preempt`` fault-plan op has no
  port counterpart: the notice file is the port's way in);
- a straggler (``straggle_seconds``) hedged: a speculative re-issue wins,
  the stream exact, on mixed fleets;
- the reaper thread stopping on ``close``; ``worker_joins`` counted only
  once a client is attached;
- ``LocalFleet(tracker=True)``: the workers' ranks from the port's
  tracker, their ids ``rank<n>``.
"""

from __future__ import annotations

import contextlib
import time

import pytest

from test_torch_service_frame import (  # noqa: F401
    PARSER_CFG, PKGS, block_key, corpus, drain_keys, local_keys, write_corpus)

PAIRS = pytest.mark.parametrize("fleet_pkg,client_pkg",
                                [(f, c) for f in PKGS for c in PKGS])
MIXED = pytest.mark.parametrize("disp_pkg,worker_pkg",
                                [(d, w) for d in PKGS for w in PKGS])


def _wait_for(predicate, timeout=8.0, what="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _status(pkg, address):
    return PKGS[pkg].dispatcher.request(address, {"cmd": "status"})


@PAIRS
def test_drain_and_replace_mid_epoch(corpus, fleet_pkg, client_pkg):
    P, C = PKGS[fleet_pkg], PKGS[client_pkg]
    want = local_keys(corpus, 6)
    base = {p: PKGS[p].resilience.counters_snapshot() for p in PKGS}
    fleet = P.LocalFleet(corpus, 6, num_workers=3, parser=PARSER_CFG, poll_interval=0.02,
                         heartbeat_interval=0.1, liveness_timeout=5.0)
    try:
        sp = C.ServiceParser(fleet.address)
        got = [block_key(sp.next_block()) for _ in range(2)]
        _wait_for(lambda: len(_status(fleet_pkg, fleet.address)["completed"]) == 6,
                  what="6 parts done")
        status = _status(fleet_pkg, fleet.address)
        victim_id = status["assigned"]["5"]
        victim = next(i for i, w in enumerate(fleet.workers) if w.worker_id == victim_id)
        victim_parts = sorted(p for p, w in status["assigned"].items() if w == victim_id)
        fleet.drain_worker(victim, deadline=30)
        fleet.add_worker()
        got += drain_keys(sp)
        assert got == want
        fd = P.resilience.counters_delta(base[fleet_pkg])
        cd = C.resilience.counters_delta(base[client_pkg])
        assert fd["worker_drains"] == 1 and fd["worker_joins"] == 1
        assert cd["drain_handoffs"] >= 1
        assert cd["service_giveups"] == 0 and cd["service_retries"] == 0
        assert sorted(p for w in fleet.workers for p in w.parts_parsed) == list(range(6))
        assert sorted(str(p) for p in fleet.workers[victim].parts_parsed) == victim_parts
    finally:
        fleet.close()


@MIXED
def test_drain_mid_parse_reissues(corpus, disp_pkg, worker_pkg):
    D, W = PKGS[disp_pkg], PKGS[worker_pkg]
    want = local_keys(corpus, 2)
    base = D.resilience.counters_snapshot()
    disp = D.dispatcher.Dispatcher(corpus, 2, parser=PARSER_CFG, liveness_timeout=5.0)
    slow = W.worker.ParseWorker(disp.address, poll_interval=0.02, heartbeat_interval=0.1,
                                straggle_seconds=0.5)
    fast = sp = None
    try:
        _wait_for(lambda: _status(disp_pkg, disp.address)["assigned"],
                  what="the slow worker claims a part")
        sp = W.ServiceParser(disp.address)
        slow.drain(deadline=30)
        fast = W.worker.ParseWorker(disp.address, poll_interval=0.02, heartbeat_interval=0.1)
        assert drain_keys(sp, close=False) == want
        d = D.resilience.counters_delta(base)
        # at least one: a drain that completes (no complete part to hand
        # off) while the worker re-announces it is counted again, in both
        # packages alike (the worker re-registers, then drains anew)
        assert d["worker_drains"] >= 1
        assert W.resilience.counters_snapshot()["service_giveups"] == 0
        assert sorted(fast.parts_parsed) == [0, 1]
    finally:
        if sp is not None:
            sp.close()
        slow.close()
        if fast is not None:
            fast.close()
        disp.close()


@pytest.mark.parametrize("pkg", list(PKGS))
def test_preemption_notice_file_drains(corpus, tmp_path, monkeypatch, pkg):
    P = PKGS[pkg]
    notice = tmp_path / "preempt.notice"
    monkeypatch.setenv("DMLC_TPU_PREEMPTION_NOTICE", str(notice))
    base = P.resilience.counters_snapshot()
    fleet = P.LocalFleet(corpus, 3, num_workers=1, parser=PARSER_CFG, poll_interval=0.02,
                         heartbeat_interval=0.05, liveness_timeout=5.0)
    try:
        assert drain_keys(P.ServiceParser(fleet.address)) == local_keys(corpus)
        assert not fleet.workers[0].draining
        notice.write_text("")
        _wait_for(lambda: P.resilience.counters_delta(base).get("worker_drains", 0) == 1,
                  timeout=5.0, what="notice-file drain")
        d = P.resilience.counters_delta(base)
        assert fleet.workers[0].draining
        assert (d["preemption_notices"], d["worker_drains"]) == (1, 1)
    finally:
        fleet.close()


def test_preemption_notice_counters_match_reference(corpus, tmp_path, monkeypatch):
    """One worker of two noticing preemption: the port's notice file read
    by worker 0's check against JAX's ``preempt@1`` fault plan (consumed
    by one heartbeat): the same counters, and the other worker serves
    the whole epoch."""
    from dmlc_tpu.io import faults as jax_faults

    keys = ("preemption_notices", "worker_drains", "service_giveups")
    out = {}
    for pkg in PKGS:
        P = PKGS[pkg]
        base = P.resilience.counters_snapshot()
        with (jax_faults.inject("preempt@1") if pkg == "jax" else contextlib.nullcontext()):
            # the port's heartbeats are slow, so only the explicit check reads
            # the notice; JAX's are fast, so its plan fires on one of them
            fleet = P.LocalFleet(corpus, 3, num_workers=2, parser=PARSER_CFG,
                                 poll_interval=0.02,
                                 heartbeat_interval=60.0 if pkg == "port" else 0.05,
                                 liveness_timeout=120.0)
            try:
                if pkg == "port":
                    notice = tmp_path / "preempt.notice"
                    notice.write_text("")
                    monkeypatch.setenv("DMLC_TPU_PREEMPTION_NOTICE", str(notice))
                    fleet.workers[0]._check_preemption()
                    monkeypatch.delenv("DMLC_TPU_PREEMPTION_NOTICE")
                _wait_for(lambda: P.resilience.counters_delta(base)["worker_drains"] >= 1,
                          timeout=5.0, what="a preemption drain")
                assert drain_keys(P.ServiceParser(fleet.address)) == local_keys(corpus)
                d = P.resilience.counters_delta(base)
                out[pkg] = {k: d.get(k, 0) for k in keys}
            finally:
                fleet.close()
    assert out["port"] == out["jax"] == {"preemption_notices": 1, "worker_drains": 1,
                                         "service_giveups": 0}


@MIXED
def test_straggler_hedged(tmp_path, monkeypatch, disp_pkg, worker_pkg):
    D, W = PKGS[disp_pkg], PKGS[worker_pkg]
    monkeypatch.setenv("DMLC_TPU_HEDGE_FACTOR", "2")
    monkeypatch.setattr(D.dispatcher, "HEDGE_MIN_AGE_S", 0.3)
    path = write_corpus(tmp_path / "s.libsvm", rows=1200)
    want = local_keys(path, 4)
    base = D.resilience.counters_snapshot()
    disp = D.dispatcher.Dispatcher(path, 4, parser=PARSER_CFG, liveness_timeout=2.0)
    slow = W.worker.ParseWorker(disp.address, poll_interval=0.02, heartbeat_interval=0.1,
                                straggle_seconds=1.5)
    fast = W.worker.ParseWorker(disp.address, poll_interval=0.02, heartbeat_interval=0.1)
    sp = None
    try:
        sp = W.ServiceParser(disp.address)
        assert drain_keys(sp, close=False) == want
        d = D.resilience.counters_delta(base)
        assert d["speculative_reissues"] >= 1 and d["speculative_wins"] >= 1
    finally:
        if sp is not None:
            sp.close()
        slow.close()
        fast.close()
        disp.close()


@pytest.mark.parametrize("pkg", list(PKGS))
def test_reaper_and_joins(pkg):
    P = PKGS[pkg]
    disp = P.dispatcher.Dispatcher("d", 1, liveness_timeout=0.2)
    tick = disp._tick_thread
    assert tick.is_alive()
    disp.close()
    tick.join(timeout=5.0)
    assert not tick.is_alive()
    disp = P.dispatcher.Dispatcher("d", 4, liveness_timeout=0)
    try:
        base = P.resilience.counters_snapshot()
        req = P.dispatcher.request
        req(disp.address, {"cmd": "register", "worker": "a", "host": "h", "port": 1})
        req(disp.address, {"cmd": "next_split", "worker": "a"})
        req(disp.address, {"cmd": "register", "worker": "b", "host": "h", "port": 2})
        joins = [P.resilience.counters_delta(base)["worker_joins"]]
        req(disp.address, {"cmd": "locate", "part": 0})
        req(disp.address, {"cmd": "register", "worker": "c", "host": "h", "port": 3})
        joins.append(P.resilience.counters_delta(base)["worker_joins"])
        req(disp.address, {"cmd": "register", "worker": "c", "host": "h", "port": 3})
        joins.append(P.resilience.counters_delta(base)["worker_joins"])
        assert joins == [0, 1, 1]
    finally:
        disp.close()


def test_tracker_bootstrap_ranks(corpus):
    """``LocalFleet(tracker=True)``: each worker takes its rank from the
    port's tracker and heartbeats metrics to it; the stream is local
    parsing's."""
    P = PKGS["port"]
    fleet = P.LocalFleet(corpus, 3, num_workers=2, parser=PARSER_CFG, tracker=True)
    try:
        assert sorted(w.worker_id for w in fleet.workers) == ["rank0", "rank1"]
        assert sorted(w.rank for w in fleet.workers) == [0, 1]
        assert type(fleet.tracker).__module__ == "dmlc_tpu_torch.tracker.tracker"
        assert drain_keys(P.ServiceParser(fleet.address)) == local_keys(corpus)
    finally:
        fleet.close()
