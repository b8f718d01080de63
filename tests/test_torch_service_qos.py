"""QoS admission and the fleet autoscaler of the port against the JAX
package's.

- the per-job in-flight budget and the fleet ceiling
  (``DMLC_TPU_QOS_MAX_INFLIGHT``): ``throttled`` locates, heals, and
  ``service_throttles`` as JAX's; a throttled tenant beside a priority
  tenant backing off without a give-up, both streams local parsing's,
  for every fleet x client pair;
- the knob reads the service takes (``claim_wait_deadline``,
  ``qos_max_inflight``, ``store_job_budget_bytes``,
  ``wire_compression``, ``service_pipeline_depth``) with JAX's errors;
- ``FleetAutoscaler`` on a ``LocalFleet`` of each package fed the same
  synthetic input waits: grow on starvation, hold at the ceiling, drain
  back to the floor, the per-job maximum (a starved job is not averaged
  away), a job's SLO target and priority deciding; decision records
  (``action``, ``why``, ``wait_fracs``), ``snapshot()`` and the counters
  equal to JAX's; bound and knob validation with JAX's messages;
- the autoscaler fed by the port tracker's ``pod_job_metrics`` (its
  default source), aggregated across ranks as JAX's;
- snapshot packs shared across jobs (the ``DMLCSN01`` store tier): one
  pack a part published and pinned, the second job served shared.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import pytest

from dmlc_tpu.utils import knobs as jax_knobs
from dmlc_tpu_torch.utils import knobs as port_knobs
from test_torch_service_frame import (  # noqa: F401
    NUM_PARTS, PARSER_CFG, PKGS, corpus, drain_keys, local_keys, write_corpus)

PAIRS = pytest.mark.parametrize("fleet_pkg,client_pkg",
                                [(f, c) for f in PKGS for c in PKGS])
KNOBS = {"port": port_knobs, "jax": jax_knobs}


def _req(pkg, disp, cmd, **kw):
    return PKGS[pkg].dispatcher.request(disp.address, dict({"cmd": cmd}, **kw))


def _other(tmp_path):
    return write_corpus(tmp_path / "other.libsvm", rows=900, cols=4, seed=3)


def _wait_for(predicate, timeout=8.0, what="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


# ---------------- admission ----------------

def test_inflight_budget_and_fleet_ceiling_match_reference(corpus, tmp_path, monkeypatch):
    other = _other(tmp_path)
    out = {}
    for pkg in PKGS:
        P = PKGS[pkg]
        base = P.resilience.counters_snapshot()
        trace = []
        disp = P.dispatcher.Dispatcher(liveness_timeout=0)
        try:
            disp.register_job("j", corpus, 2, parser=PARSER_CFG, max_inflight=1)
            _req(pkg, disp, "register", worker="a", host="h", port=1)
            trace.append(_req(pkg, disp, "next_split", worker="a")["part"])
            trace.append(_req(pkg, disp, "next_split", worker="a")["part"])
            shed = _req(pkg, disp, "locate", part=1, job="j")
            trace.append(sorted(k for k in shed if k not in ("now",)))
            trace.append(_req(pkg, disp, "locate", part=0, job="j")["worker"])
            _req(pkg, disp, "part_done", worker="a", part=0, job="j")
            trace.append(_req(pkg, disp, "next_split", worker="a")["part"])
        finally:
            disp.close()
        monkeypatch.setenv("DMLC_TPU_QOS_MAX_INFLIGHT", "1")
        disp = P.dispatcher.Dispatcher(liveness_timeout=0)
        try:
            disp.register_job("a", corpus, 1, parser=PARSER_CFG)
            disp.register_job("b", other, 1, parser=PARSER_CFG)
            _req(pkg, disp, "register", worker="w", host="h", port=1)
            trace.append(_req(pkg, disp, "next_split", worker="w")["job"])
            trace.append(_req(pkg, disp, "next_split", worker="w")["part"])
            trace.append(_req(pkg, disp, "locate", part=0, job="b").get("throttled"))
            _req(pkg, disp, "part_done", worker="w", part=0, job="a")
            trace.append(_req(pkg, disp, "next_split", worker="w")["job"])
        finally:
            disp.close()
            monkeypatch.delenv("DMLC_TPU_QOS_MAX_INFLIGHT")
        trace.append(P.resilience.counters_delta(base)["service_throttles"])
        out[pkg] = trace
    assert out["port"] == out["jax"]
    assert out["port"][-1] == 2


@PAIRS
def test_throttled_tenant_backs_off_and_heals(corpus, tmp_path, monkeypatch,
                                               fleet_pkg, client_pkg):
    monkeypatch.setenv("DMLC_TPU_QOS_MAX_INFLIGHT", "1")
    other = _other(tmp_path)
    P, C = PKGS[fleet_pkg], PKGS[client_pkg]
    base = C.resilience.counters_snapshot()
    disp = P.dispatcher.Dispatcher(liveness_timeout=10.0)
    workers = [P.worker.ParseWorker(disp.address, poll_interval=0.02, heartbeat_interval=0.1,
                                    straggle_seconds=0.05) for _ in range(2)]
    try:
        P.dispatcher.register_job(disp.address, "crit", corpus, NUM_PARTS, parser=PARSER_CFG,
                                  priority=1, weight=2)
        P.dispatcher.register_job(disp.address, "batch", other, 2, parser=PARSER_CFG,
                                  max_inflight=1)
        sp0 = C.ServiceParser(disp.address, job="batch")
        state = sp0.state_dict()
        sp0.close()
        out = {}

        def drain_batch():
            sp = C.ServiceParser(disp.address, job="batch")
            sp.load_state(state)
            out["batch"] = drain_keys(sp)

        t = threading.Thread(target=drain_batch, daemon=True)
        t.start()
        out["crit"] = drain_keys(C.ServiceParser(disp.address, job="crit"))
        t.join(120)
        assert not t.is_alive()
        assert out["crit"] == local_keys(corpus) and out["batch"] == local_keys(other, 2)
        d = C.resilience.counters_delta(base)
        assert d["service_admission_waits"] >= 1 and d["service_giveups"] == 0
    finally:
        for w in workers:
            w.close()
        disp.close()


@pytest.mark.parametrize("case", [
    ("claim_wait_deadline", "DMLC_TPU_CLAIM_WAIT_DEADLINE", ["5", "0", "-1", "soon"]),
    ("service_pipeline_depth", "DMLC_TPU_SERVICE_PIPELINE_DEPTH", ["16", "0", "x"]),
    ("drain_deadline", "DMLC_TPU_DRAIN_DEADLINE", ["2.5", "-1", "x"]),
    ("dispatch_workers", "DMLC_TPU_DISPATCH_WORKERS", ["3", "0", "x"]),
])
def test_service_knob_rows_match_reference(monkeypatch, case):
    name, env, values = case
    for raw in [None] + values:
        if raw is None:
            monkeypatch.delenv(env, raising=False)
        else:
            monkeypatch.setenv(env, raw)
        res = {}
        for pkg, K in KNOBS.items():
            try:
                res[pkg] = K.resolve(name)
            except Exception as exc:  # noqa: BLE001 - compared across packages
                res[pkg] = ("error", str(exc))
        assert res["port"] == res["jax"], (name, raw)


@pytest.mark.parametrize("raw", [None, "3", "0", "lots"])
def test_qos_store_and_wire_readers_match_reference(monkeypatch, raw):
    for env, fn in (("DMLC_TPU_QOS_MAX_INFLIGHT", "qos_max_inflight"),
                    ("DMLC_TPU_STORE_JOB_BUDGET_BYTES", "store_job_budget_bytes"),
                    ("DMLC_TPU_WIRE_COMPRESSION", "wire_compression")):
        if raw is None:
            monkeypatch.delenv(env, raising=False)
        else:
            monkeypatch.setenv(env, raw)
        res = {}
        for pkg, K in KNOBS.items():
            try:
                res[pkg] = getattr(K, fn)()
            except Exception as exc:  # noqa: BLE001 - compared across packages
                res[pkg] = ("error", str(exc))
        assert res["port"] == res["jax"], (fn, raw)
        monkeypatch.delenv(env, raising=False)


# ---------------- the autoscaler ----------------

def _scale_script(pkg, corpus, script, jobs=(), **kw):
    """Drive an autoscaler of ``pkg`` over ``script`` (a list of per-tick
    wait increments), returning each decision's comparable fields, the
    live worker counts, its snapshot and the counters."""
    P = PKGS[pkg]
    base = P.resilience.counters_snapshot()
    fleet = P.LocalFleet(corpus, NUM_PARTS, num_workers=1, parser=PARSER_CFG)
    waits = {}
    try:
        for job, jkw in jobs:
            fleet.register_job(job, corpus, NUM_PARTS, parser=PARSER_CFG, **jkw)
        scaler = fleet.autoscale(source=lambda: dict(waits), start=False, **kw)
        recs, t = [], 0.0
        for inc in script:
            for job, v in inc.items():
                waits[job] = waits.get(job, 0.0) + v
            rec = scaler.step(now=t)
            recs.append({k: rec.get(k) for k in ("action", "why", "wait_fracs", "target")})
            if rec["action"] == "shrink":
                _wait_for(lambda: len(fleet.live_workers()) == rec.get("target", 1),
                          what="the drain to complete")
            recs[-1]["live"] = len(fleet.live_workers())
            t += 1.0
        snap = scaler.snapshot()
        keys = drain_keys(P.ServiceParser(fleet.address))
        d = P.resilience.counters_delta(base)
    finally:
        fleet.close()
    return {"recs": recs, "snapshot": {k: snap.get(k) for k in ("scale_ups", "scale_downs")},
            "keys_ok": keys == local_keys(corpus),
            "counters": {k: d.get(k, 0) for k in ("fleet_scale_ups", "fleet_scale_downs",
                                                  "service_giveups")}}


def test_autoscaler_grows_then_drains_back_as_reference(corpus):
    script = [{}] + [{"default": 1.0}] * 5 + [{}] * 5
    kw = dict(min_workers=1, max_workers=2, interval=1.0, up_ticks=2, down_ticks=2,
              cooldown_ticks=0)
    got = _scale_script("port", corpus, script, **kw)
    want = _scale_script("jax", corpus, script, **kw)
    assert got == want
    assert [r["action"] for r in got["recs"]] == (
        ["hold", "hold", "grow", "hold", "hold", "hold", "hold", "shrink", "hold", "hold",
         "hold"])
    assert got["snapshot"] == {"scale_ups": 1, "scale_downs": 1} and got["keys_ok"]


def test_autoscaler_per_job_maximum_and_slo_as_reference(corpus):
    fair = [{}, {"a": 1.0, "b": 0.0, "c": 0.0}]
    kw = dict(min_workers=1, max_workers=3, interval=1.0, grow_frac=0.5, up_ticks=1,
              cooldown_ticks=0)
    got, want = _scale_script("port", corpus, fair, **kw), _scale_script("jax", corpus, fair,
                                                                         **kw)
    assert got == want and got["recs"][1]["action"] == "grow"
    slo = [{}, {"crit": 0.4, "batch": 0.45}, {"crit": 0.4, "batch": 0.9}]
    jobs = [("crit", dict(priority=2, slo_wait_frac=0.3)), ("batch", {})]
    kw = dict(min_workers=1, max_workers=4, interval=1.0, grow_frac=0.5, up_ticks=1,
              cooldown_ticks=0)
    got = _scale_script("port", corpus, slo, jobs=jobs, **kw)
    want = _scale_script("jax", corpus, slo, jobs=jobs, **kw)
    assert got == want
    assert [r["action"] for r in got["recs"][1:]] == ["grow", "grow"]
    assert all("crit" in r["why"] for r in got["recs"][1:])


def test_autoscaler_validation_matches_reference(corpus, monkeypatch):
    out = {}
    for pkg in PKGS:
        P = PKGS[pkg]
        fleet = P.LocalFleet(corpus, NUM_PARTS, num_workers=1, parser=PARSER_CFG)
        msgs = []
        try:
            for env, kw in ((None, dict(min_workers=5, max_workers=2)),
                            (("DMLC_TPU_FLEET_MIN", "0"), {}),
                            (("DMLC_TPU_FLEET_SCALE_INTERVAL", "soon"), {})):
                if env:
                    monkeypatch.setenv(*env)
                with pytest.raises(P.DMLCError) as e:
                    fleet.autoscale(source=dict, **kw)
                msgs.append(str(e.value))
                if env:
                    monkeypatch.delenv(env[0])
        finally:
            fleet.close()
        out[pkg] = msgs
    assert out["port"] == out["jax"]


def test_autoscaler_reads_the_port_tracker(corpus):
    """The default source is the tracker's ``pod_job_metrics``: per-job
    input wait summed over ranks, as JAX's tracker sums it."""
    from dmlc_tpu.tracker.tracker import RabitTracker as JaxTracker
    from dmlc_tpu_torch.tracker.tracker import RabitTracker

    metrics = {0: {"jobs": {"a": {"input_wait_seconds": 1.5, "parts": 2}}},
               1: {"jobs": {"a": {"input_wait_seconds": 0.5, "parts": 1},
                            "b": {"input_wait_seconds": 2.0, "parts": 4}}}}
    aggs = []
    for T in (RabitTracker, JaxTracker):
        trk = T.__new__(T)
        trk._metrics_lock = threading.Lock()
        trk.metrics_by_rank = metrics
        aggs.append(trk.pod_job_metrics())
    assert aggs[0] == aggs[1] == {"a": {"input_wait_seconds": 2.0, "parts": 3},
                                  "b": {"input_wait_seconds": 2.0, "parts": 4}}
    P = PKGS["port"]
    fleet = P.LocalFleet(corpus, NUM_PARTS, num_workers=1, parser=PARSER_CFG, tracker=True)
    try:
        scaler = fleet.autoscale(min_workers=1, max_workers=2, interval=1.0, up_ticks=1,
                                 cooldown_ticks=0, start=False)
        assert scaler.step(now=0.0)["action"] == "hold"
    finally:
        fleet.close()


# ---------------- snapshot packs shared across jobs ----------------

@pytest.mark.parametrize("pkg", list(PKGS))
def test_snapshot_pack_shared_across_jobs(corpus, tmp_path, pkg):
    P = PKGS[pkg]
    share = str(tmp_path / "share")
    geom = {"batch_size": 32, "num_col": 6, "x_dtype": "float32"}
    base = P.resilience.counters_snapshot()
    fleet = P.LocalFleet(None, 0, num_workers=1, parser=PARSER_CFG, share_dir=share)
    try:
        fleet.register_job("a", corpus, NUM_PARTS, parser=PARSER_CFG, snapshot=geom)
        got_a = []
        sp = P.ServiceParser(fleet.address, job="a")
        while (b := sp.next_block()) is not None:
            got_a.append(np.asarray(b.x).tobytes())
        sp.close()
        snaps = sorted(n for n in os.listdir(share) if n.endswith(".snap"))
        assert len(snaps) == NUM_PARTS
        for name in snaps:
            path = os.path.join(share, name)
            entry = next(e for e in P.mgr.store_for(path).entries() if e["path"] == name)
            assert entry["tier"] == "snapshot" and entry["pinned"]
        fleet.register_job("b", corpus, NUM_PARTS, parser=PARSER_CFG, snapshot=geom)
        got_b = []
        sp = P.ServiceParser(fleet.address, job="b")
        while (b := sp.next_block()) is not None:
            got_b.append(np.asarray(b.x).tobytes())
        sp.close()
        assert got_a == got_b and len(got_a) == NUM_PARTS * 63
        d = P.resilience.counters_delta(base)
        assert (d["service_parts_parsed"], d["service_parts_shared"],
                d["service_giveups"]) == (NUM_PARTS, 2 * NUM_PARTS, 0)
    finally:
        fleet.close()
