"""Recovery of the port's service against the JAX package's: the same
chaos through both packages, the streams equal to local parsing and the
resilience counters equal to the JAX run's.

- a worker killed mid-epoch (the owner of the last part): one
  ``service_retries``, one ``service_failovers``, no give-up, and a
  checkpoint taken before the kill restored into a fresh client, for every
  fleet x client pair; all workers dead gives up once;
- a torn frame retried once on the same owner before ``report_lost``;
- the JAX package's fault plans on the control and data planes, through
  both packages' seams: ``dispatch_rpc~locate@1..2=conn`` heals through
  the shared policy (``control_plane_retries`` 2, ``service_retries`` 0,
  no dispatcher restart) and ``worker_rpc~stream@1=torn`` fails over
  (``service_retries`` 1), the streams and ``fired()`` equal, the
  ``conn`` and ``torn`` classes retryable in both; the same faults raised
  from the test side too, by breaking the port's
  ``service.dispatcher.request`` and ``service.client.connect_worker``.
  The client's counters are its telemetry scope's (where the failover
  lands is a race in both);
- the dispatcher killed mid-epoch and restarted from its journal on the
  same address: the generation, ``dispatcher_restarts`` 1, the workers'
  re-registration and reclaim, no part parsed twice; a client riding
  through the downtime; the dispatcher and a worker dying together;
- ``restart_dispatcher`` without a journal refused with JAX's message.
"""

from __future__ import annotations

import threading
import time

import pytest

from dmlc_tpu.io import faults as jax_faults
from dmlc_tpu.utils import telemetry as jax_telemetry
from dmlc_tpu_torch.io import faults as port_faults
from dmlc_tpu_torch.service import client as port_client_mod
from dmlc_tpu_torch.service import dispatcher as port_dispatcher_mod
from dmlc_tpu_torch.utils import telemetry as port_telemetry
from test_torch_service_frame import (  # noqa: F401
    PARSER_CFG, PKGS, block_key, corpus, drain_keys, local_keys)

PAIRS = pytest.mark.parametrize("fleet_pkg,client_pkg",
                                [(f, c) for f in PKGS for c in PKGS])
FLEET_KW = dict(num_workers=2, parser=PARSER_CFG, poll_interval=0.02,
                heartbeat_interval=0.1, liveness_timeout=5.0)
KEYS = ("service_retries", "service_failovers", "service_giveups", "control_plane_retries",
        "dispatcher_restarts")
TELEMETRY = {"port": port_telemetry, "jax": jax_telemetry}
# the client's own events: its drain runs in this scope, the fleet's
# threads in none (other tests' lingering threads count elsewhere too)
CLIENT_SCOPE = "service-client"
# what a fault from the test side is held to: where a failover lands
# after report_lost is a race in both packages
FAULT_KEYS = ("service_retries", "service_giveups", "control_plane_retries",
              "dispatcher_restarts")


def _status(pkg, address):
    return PKGS[pkg].dispatcher.request(address, {"cmd": "status"})


def _wait_for(predicate, timeout=8.0, what="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _delta(pkg, base, scope=None):
    d = PKGS[pkg].resilience.counters_delta(base, scope)
    return {k: d.get(k, 0) for k in KEYS}


@PAIRS
def test_worker_killed_mid_epoch(corpus, fleet_pkg, client_pkg):
    want = local_keys(corpus, 4)
    fleet = PKGS[fleet_pkg].LocalFleet(corpus, 4, num_workers=2, parser=PARSER_CFG)
    C = PKGS[client_pkg]
    try:
        base = C.resilience.counters_snapshot(CLIENT_SCOPE)
        with TELEMETRY[client_pkg].scope(CLIENT_SCOPE):
            sp = C.ServiceParser(fleet.address)
            got = [block_key(sp.next_block()) for _ in range(7)]
            state = sp.state_dict()
            # the owner of the last part: its frames cannot already sit in
            # the client's socket buffer, so exactly one fault is seen
            _wait_for(lambda: "3" in _status(fleet_pkg, fleet.address)["assigned"],
                      what="part 3 assigned")
            owner = _status(fleet_pkg, fleet.address)["assigned"]["3"]
            fleet.kill_worker(next(i for i, w in enumerate(fleet.workers)
                                   if w.worker_id == owner))
            got += drain_keys(sp)
        assert got == want
        assert _delta(client_pkg, base, CLIENT_SCOPE) == {
            "service_retries": 1, "service_failovers": 1, "service_giveups": 0,
            "control_plane_retries": 0, "dispatcher_restarts": 0}
        other = "jax" if client_pkg == "port" else "port"
        sp2 = PKGS[other].ServiceParser(fleet.address)
        sp2.load_state(state)
        assert drain_keys(sp2) == want[7:]
    finally:
        fleet.close()


@PAIRS
def test_all_workers_dead_gives_up(corpus, fleet_pkg, client_pkg):
    fleet = PKGS[fleet_pkg].LocalFleet(corpus, 2, num_workers=1, parser=PARSER_CFG)
    C = PKGS[client_pkg]
    try:
        sp = C.ServiceParser(fleet.address, retry_policy=C.resilience.RetryPolicy(
            max_attempts=2, base_delay=0.01, max_delay=0.02, attempt_timeout=0.5))
        base = C.resilience.counters_snapshot()
        assert sp.next_block() is not None
        fleet.kill_worker(0)
        with pytest.raises(C.DMLCError, match="stream failed 2 times|no live worker"):
            drain_keys(sp, close=False)
        d = C.resilience.counters_delta(base)
        assert d["service_giveups"] == 1 and d["service_retries"] >= 1
        sp.close()
    finally:
        fleet.close()


@pytest.mark.parametrize("pkg", list(PKGS))
def test_torn_frame_soft_retry_before_report_lost(corpus, monkeypatch, pkg):
    P = PKGS[pkg]
    reported = []
    orig = P.dispatcher.request

    def recording(address, req, **kw):
        if req.get("cmd") == "report_lost":
            reported.append(req["worker"])
        return orig(address, req, **kw)

    monkeypatch.setattr(P.dispatcher, "request", recording)
    fleet = P.LocalFleet(corpus, 3, num_workers=2, parser=PARSER_CFG)
    try:
        sp = P.ServiceParser(fleet.address)
        assert sp.next_block() is not None
        pos = sp._pos
        sp._on_stream_fault(P.frame.ServiceFrameError("crc mismatch"))
        assert reported == []
        assert sp.next_block() is not None and sp._pos == pos + 1
        owner = sp._owner
        sp._soft_retry_owner = owner
        sp._on_stream_fault(P.frame.ServiceFrameError("crc mismatch again"))
        assert reported == [owner]
        sp.close()
    finally:
        fleet.close()


# ---------------- the fault plans through both seams ----------------

FAULTS = {"jax": jax_faults, "port": port_faults}


def test_fault_plan_conn_and_torn_error_classes():
    described = {}
    for pkg, faults in FAULTS.items():
        res = PKGS[pkg].resilience
        plan = faults.FaultPlan("dispatch_rpc@1=conn;worker_rpc@1=torn")
        conn = plan.check("dispatch_rpc", "127.0.0.1:1 locate")
        assert isinstance(conn, ConnectionRefusedError)
        assert res.classify(conn) == res.RETRYABLE
        torn = plan.check("worker_rpc", "rank0 stream part 2")
        assert isinstance(torn, ConnectionError)
        assert res.classify(torn) == res.RETRYABLE
        assert plan.fired() == 2
        described[pkg] = (type(conn).__name__, conn.errno, str(conn),
                          type(torn).__name__, str(torn))
    assert described["port"] == described["jax"]


def _plan_run(pkg, corpus, plan: str) -> tuple:
    fleet = PKGS[pkg].LocalFleet(corpus, 3, **FLEET_KW)
    try:
        with FAULTS[pkg].inject(plan) as p:
            keys, counts = _client_drain(pkg, fleet.address)
        return keys, p.fired(), counts
    finally:
        fleet.close()


def test_fault_plan_dispatch_rpc_heals_through_policy(corpus):
    """An injected dispatcher-unreachable burst on the client's locate
    path (``~locate`` keeps the workers' ``next_split`` polls out of it)
    heals through the shared policy with exact counters and the stream
    of local parsing, in both packages."""
    local = local_keys(corpus)
    out = {}
    for pkg in PKGS:
        keys, fired, d = _plan_run(pkg, corpus, "dispatch_rpc~locate@1..2=conn")
        assert keys == local
        assert fired == 2
        assert d["control_plane_retries"] == 2
        assert d["dispatcher_restarts"] == 0
        assert d["service_retries"] == 0  # absorbed below the stream
        out[pkg] = (fired, d)
    assert out["port"] == out["jax"]


def test_fault_plan_worker_rpc_torn_storm(corpus):
    """``worker_rpc=torn`` breaks the client's first part-stream connect;
    the stream layer fails over and the epoch equals local parsing, one
    ``service_retries``, in both packages."""
    local = local_keys(corpus)
    out = {}
    for pkg in PKGS:
        keys, fired, d = _plan_run(pkg, corpus, "worker_rpc~stream@1=torn")
        assert keys == local
        assert fired == 1
        assert d["service_retries"] == 1
        out[pkg] = (fired, d)
    assert out["port"] == out["jax"]


# ---------------- the same faults, from the test side ----------------

def _client_drain(pkg, address) -> tuple:
    """The stream and the client's own counters (its scope's)."""
    res = PKGS[pkg].resilience
    base = res.counters_snapshot(CLIENT_SCOPE)
    with TELEMETRY[pkg].scope(CLIENT_SCOPE):
        keys = drain_keys(PKGS[pkg].ServiceParser(address))
    d = res.counters_delta(base, CLIENT_SCOPE)
    return keys, {k: d.get(k, 0) for k in FAULT_KEYS}


def _jax_plan_run(corpus, plan: str) -> dict:
    fleet = PKGS["jax"].LocalFleet(corpus, 3, **FLEET_KW)
    try:
        with jax_faults.inject(plan) as p:
            keys, counts = _client_drain("jax", fleet.address)
        assert p.fired() >= 1
        return {"keys": keys, "counters": counts}
    finally:
        fleet.close()


def test_locate_refused_twice_heals_as_reference(corpus, monkeypatch):
    want = _jax_plan_run(corpus, "dispatch_rpc~locate@1..2=conn")
    fired = []
    orig = port_dispatcher_mod.request

    def refusing(address, req, **kw):
        if req.get("cmd") == "locate" and len(fired) < 2:
            fired.append(req)
            raise ConnectionRefusedError(111, f"refused: {address} locate")
        return orig(address, req, **kw)

    fleet = PKGS["port"].LocalFleet(corpus, 3, **FLEET_KW)
    try:
        monkeypatch.setattr(port_dispatcher_mod, "request", refusing)
        keys, got = _client_drain("port", fleet.address)
        monkeypatch.setattr(port_dispatcher_mod, "request", orig)
    finally:
        fleet.close()
    assert len(fired) == 2
    assert keys == want["keys"] == local_keys(corpus)
    assert got == want["counters"]
    assert got["control_plane_retries"] == 2 and got["service_retries"] == 0


def test_worker_connect_torn_heals_as_reference(corpus, monkeypatch):
    want = _jax_plan_run(corpus, "worker_rpc~stream@1=torn")
    fired = []
    orig = port_client_mod.connect_worker

    def torn(host, port, timeout):
        if not fired:
            fired.append((host, port))
            raise ConnectionError(f"torn reply from {host}:{port}")
        return orig(host, port, timeout)

    monkeypatch.setattr(port_client_mod, "connect_worker", torn)
    fleet = PKGS["port"].LocalFleet(corpus, 3, **FLEET_KW)
    try:
        keys, got = _client_drain("port", fleet.address)
    finally:
        fleet.close()
    assert len(fired) == 1
    assert keys == want["keys"] == local_keys(corpus)
    assert got == want["counters"]
    assert got["service_retries"] == 1


# ---------------- the control plane killed ----------------

@pytest.mark.parametrize("pkg", list(PKGS))
def test_dispatcher_killed_mid_epoch(corpus, tmp_path, pkg):
    """Both packages alike: the stream equal to local parsing, one restart,
    both workers re-attached, a part reclaimed, none parsed twice."""
    P = PKGS[pkg]
    want = local_keys(corpus, 4)
    fleet = P.LocalFleet(corpus, 4, journal_path=str(tmp_path / "j.jsonl"), **FLEET_KW)
    try:
        sp = P.ServiceParser(fleet.address)
        base = P.resilience.counters_snapshot()
        got = [block_key(sp.next_block()) for _ in range(5)]
        _wait_for(lambda: len(_status(pkg, fleet.address)["completed"]) == 4,
                  what="4 parts done")
        fleet.kill_dispatcher()
        fleet.restart_dispatcher()
        assert fleet.dispatcher.generation == 2
        got += drain_keys(sp)
        assert got == want
        _wait_for(lambda: P.resilience.counters_delta(base)["worker_reregistrations"] >= 2,
                  what="both workers re-attached")
        _wait_for(lambda: P.resilience.counters_delta(base)["parts_reclaimed"] >= 1,
                  what="parts reclaimed")
        d = P.resilience.counters_delta(base)
        assert d["dispatcher_restarts"] == 1 and d["service_giveups"] == 0
        assert sorted(p for w in fleet.workers for p in w.parts_parsed) == [0, 1, 2, 3]
        assert _status(pkg, fleet.address)["completed"] == [0, 1, 2, 3]
    finally:
        fleet.close()


@PAIRS
def test_client_rides_through_dispatcher_downtime(corpus, tmp_path, fleet_pkg, client_pkg):
    C = PKGS[client_pkg]
    fleet = PKGS[fleet_pkg].LocalFleet(corpus, 3, journal_path=str(tmp_path / "j.jsonl"),
                                       **FLEET_KW)
    try:
        sp = C.ServiceParser(fleet.address, retry_policy=C.resilience.RetryPolicy(
            max_attempts=8, base_delay=0.02, max_delay=0.1, attempt_timeout=5.0))
        base = C.resilience.counters_snapshot()
        got = [block_key(sp.next_block()) for _ in range(2)]
        _wait_for(lambda: len(_status(fleet_pkg, fleet.address)["completed"]) == 3,
                  what="3 parts done")
        fleet.kill_dispatcher()
        sp._drop_stream()  # the next pull must locate against the dead dispatcher
        restarter = threading.Timer(0.4, fleet.restart_dispatcher)
        restarter.start()
        try:
            got += drain_keys(sp)
        finally:
            restarter.join()
        assert got == local_keys(corpus)
        d = _delta(client_pkg, base)
        assert d["dispatcher_restarts"] == 1 and d["control_plane_retries"] >= 1
        assert d["service_giveups"] == 0
    finally:
        fleet.close()


@pytest.mark.parametrize("pkg", list(PKGS))
def test_dispatcher_and_worker_die_together(corpus, tmp_path, pkg):
    P = PKGS[pkg]
    fleet = P.LocalFleet(corpus, 4, num_workers=2, parser=PARSER_CFG, poll_interval=0.02,
                         heartbeat_interval=0.1, liveness_timeout=0.6,
                         journal_path=str(tmp_path / "j.jsonl"))
    try:
        sp = P.ServiceParser(fleet.address)
        base = P.resilience.counters_snapshot()
        got = [block_key(sp.next_block()) for _ in range(3)]
        _wait_for(lambda: len(_status(pkg, fleet.address)["completed"]) == 4,
                  what="4 parts done")
        owner = _status(pkg, fleet.address)["assigned"]["3"]
        victim = next(i for i, w in enumerate(fleet.workers) if w.worker_id == owner)
        fleet.kill_dispatcher()
        fleet.kill_worker(victim)
        fleet.restart_dispatcher()
        got += drain_keys(sp)
        assert got == local_keys(corpus, 4)
        d = P.resilience.counters_delta(base)
        assert d["dispatcher_restarts"] == 1 and d["service_giveups"] == 0
        assert 3 in fleet.workers[1 - victim].parts_parsed
    finally:
        fleet.close()


def test_restart_dispatcher_requires_journal(corpus):
    msgs = []
    for pkg in PKGS:
        fleet = PKGS[pkg].LocalFleet(corpus, 3, **FLEET_KW)
        try:
            with pytest.raises(PKGS[pkg].DMLCError) as e:
                fleet.restart_dispatcher()
            msgs.append(str(e.value))
        finally:
            fleet.close()
    assert msgs[0] == msgs[1]
