"""The port's dispatcher (``dmlc_tpu_torch/service/dispatcher.py``) against
the JAX package's: the same RPC scripts through both, replies equal as
JSON (the clock stamp ``now`` and the listen address aside, deadlines to
the second), and each package's journal replayed by the other.

- the job registry: ``config``, ``register_job`` (RPC and method, the
  share-by-signature cache path under ``share_dir``), its validation and
  immutability errors with JAX's messages, ``status``;
- grants: first come first served, exactly once, re-issue at the front on
  ``report_lost``, the dead worker's re-register; round robin across jobs;
- liveness: a stale owner reaped at ``locate``, the background reaper;
- drain: grants stop, unstarted parts re-issued, ``moved`` / ``draining``
  hints, ``handoff`` completing the drain early, a repeated drain
  tightening the deadline, expiry through the tick;
- hedging: a straggler's speculative re-issue, first completion wins
  (``HEDGE_MIN_AGE_S`` shrunk in both packages);
- QoS: validation and echo, weighted deficit round robin, priority bands,
  the per-job in-flight budget's ``throttled`` replies;
- journals: a script journaled by one package, then replayed by a fresh
  dispatcher of either (status equal), a torn tail skipped, compaction,
  the dataset mismatch refusal, reclaim after a restart;
- ``request()``: a torn, an empty and a ``busy`` reply classified as
  JAX's; the handler cap shedding ``busy``.
"""

from __future__ import annotations

import json
import socket
import threading
import time

import pytest

from test_torch_service_frame import BOTH, PKGS, PARSER_CFG, corpus  # noqa: F401


def _norm(obj, addr: str = ""):
    """A reply as comparable JSON: ``now`` and the timestamps (``ts``) dropped, a trace
    context as its keys, the listen address masked, times rounded to the
    second."""
    if isinstance(obj, dict):
        # a grant's trace context is random: its keys only
        return {k: (sorted(v) if k == "trace" and isinstance(v, dict) else _norm(v, addr))
                for k, v in sorted(obj.items())
                if k not in ("now", "ts", "last_seen", "age_s", "since")}
    if isinstance(obj, list):
        return [_norm(v, addr) for v in obj]
    if isinstance(obj, float):
        return round(obj)
    if isinstance(obj, str) and addr:
        return obj.replace(addr, "ADDR")
    return obj


def _run(pkg: str, steps, journal_path=None, **disp_kw):
    """Run ``steps`` (``(cmd, kwargs)`` RPCs, or callables of ``(D, disp)``
    whose result is recorded) against a fresh dispatcher of ``pkg``;
    returns the normalized replies (an error as its class and message)."""
    D = PKGS[pkg].dispatcher
    kw = dict(liveness_timeout=0)
    kw.update(disp_kw)
    disp = D.Dispatcher(journal_path=journal_path, **kw)
    out = []
    try:
        for step in steps:
            try:
                if callable(step):
                    res = step(D, disp)
                else:
                    cmd, args = step
                    res = D.request(disp.address, dict({"cmd": cmd}, **args))
            except Exception as exc:  # noqa: BLE001 - compared across packages
                res = ["error", type(exc).__name__, str(exc)]
            out.append(_norm(res, disp.address))
    finally:
        disp.close()
    return out


def _both(steps, **kw):
    got, want = _run("port", steps, **kw), _run("jax", steps, **kw)
    assert got == want
    return got


def _reg(w, port):
    return ("register", {"worker": w, "host": "127.0.0.1", "port": port})


def _split(w):
    return ("next_split", {"worker": w})


def _sleep(s):
    def step(D, disp):
        time.sleep(s)
        return None
    return step


# ---------------- registry and grants ----------------

def test_fcfs_exactly_once_and_reissue_trace():
    steps = [("config", {}), _split("ghost"), _reg("a", 1111), _reg("b", 2222),
             _split("a"), _split("b"), _split("a"), _split("b"), _split("a"),
             ("locate", {"part": 1}), ("report_lost", {"worker": "b"}),
             ("locate", {"part": 1}), _split("a"), _split("a"), _split("b"),
             ("status", {}), ("part_done", {"worker": "a", "part": 0}),
             ("part_done", {"worker": "a", "part": 1}), ("status", {})]
    got = _both(steps, uri="dummy.libsvm", num_parts=4, parser={"format": "libsvm"})
    grants = [r["part"] for r in got[4:8]]
    assert grants == [0, 1, 2, 3] and got[8]["part"] is None
    assert got[11].get("wait") and got[12]["part"] == 1 and got[13]["part"] == 3


def test_multi_job_registry_and_round_robin(corpus, tmp_path):
    other = str(tmp_path / "o.libsvm")
    with open(other, "w") as f:
        f.write("1 0:1\n0 1:2\n" * 50)
    steps = [("config", {}), ("status", {}),
             ("register_job", {"job": "a", "uri": corpus, "num_parts": 3,
                               "parser": PARSER_CFG}),
             ("register_job", {"job": "b", "uri": other, "num_parts": 2,
                               "parser": PARSER_CFG}),
             ("register_job", {"job": "a", "uri": corpus, "num_parts": 3,
                               "parser": PARSER_CFG}),
             ("register_job", {"job": "a", "uri": other, "num_parts": 3,
                               "parser": PARSER_CFG}),
             ("register_job", {"job": "c", "uri": corpus, "num_parts": 0}),
             ("register_job", {"job": "", "uri": corpus, "num_parts": 2}),
             ("config", {"job": "b"}), ("config", {"job": "zzz"}),
             _reg("w", 1)] + [_split("w")] * 6 + [
             ("locate", {"part": 1, "job": "b"}), ("locate", {"part": 9, "job": "a"}),
             ("status", {}),
             lambda D, d: d.jobs, lambda D, d: d.job_qos()]
    got = _both(steps)
    jobs = [(r["job"], r["part"]) for r in got[11:17] if r.get("part") is not None]
    assert sorted(jobs) == [("a", 0), ("a", 1), ("a", 2), ("b", 0), ("b", 1)]


def test_share_dir_assigns_one_cache_per_corpus(corpus, tmp_path):
    def steps_for(share):
        def reg(job):
            return lambda D, d: D.register_job(d.address, job, corpus, 3,
                                               parser=dict(PARSER_CFG))
        return [reg("a"), reg("b"), ("config", {"job": "b"})]
    got = {}
    for pkg in PKGS:
        share = str(tmp_path / pkg)
        got[pkg] = _run(pkg, steps_for(share), share_dir=share)
        for r in got[pkg][:2]:
            r["parser"]["block_cache"] = r["parser"]["block_cache"].replace(share, "SHARE")
        got[pkg][2]["parser"]["block_cache"] = got[pkg][2]["parser"]["block_cache"].replace(
            share, "SHARE")
    assert got["port"] == got["jax"]
    a, b = got["port"][:2]
    assert a["parser"]["block_cache"] == b["parser"]["block_cache"]
    assert a["parser"]["block_cache"].startswith("SHARE/svc-")


@BOTH
def test_register_job_method_errors_match_reference(pkg, corpus):
    """The method's refusals (``ServiceConfigError``) read as JAX's."""
    msgs = {}
    for p in PKGS:
        D = PKGS[p].dispatcher
        disp = D.Dispatcher(corpus, 3, parser=PARSER_CFG, liveness_timeout=0)
        try:
            out = []
            for kw in (dict(priority=-1), dict(weight=0), dict(slo_wait_frac=1.5),
                       dict(slo_wait_frac=0.0), dict(max_inflight=0)):
                with pytest.raises(D.ServiceConfigError) as e:
                    disp.register_job("bad", corpus, 3, parser=PARSER_CFG, **kw)
                out.append(str(e.value))
            disp.register_job("crit", corpus, 3, parser=PARSER_CFG, priority=2, weight=3,
                              slo_wait_frac=0.25, max_inflight=4)
            with pytest.raises(D.ServiceConfigError) as e:
                disp.register_job("crit", corpus, 3, parser=PARSER_CFG, priority=1)
            out.append(str(e.value))
            with pytest.raises(D.ServiceConfigError) as e:
                disp.register_job(D.DEFAULT_JOB, corpus, 4, parser=PARSER_CFG)
            out.append(str(e.value))
            out.append(disp.job_qos())
            msgs[p] = out
        finally:
            disp.close()
    assert msgs["port"] == msgs["jax"]
    assert isinstance(PKGS[pkg].dispatcher.ServiceConfigError("x"), PKGS[pkg].DMLCError)


# ---------------- liveness ----------------

def test_stale_owner_reaped_at_locate():
    steps = [_reg("a", 1), _split("a"), _sleep(0.4), ("locate", {"part": 0}),
             _split("a"), ("status", {})]
    got = _both(steps, uri="dummy", num_parts=1, liveness_timeout=0.2)
    assert got[3].get("wait")


def test_background_reaper_requeues_a_silent_worker():
    steps = [_reg("a", 1), _reg("b", 2), _split("a"), _split("b"),
             ("heartbeat", {"worker": "b"}), _sleep(0.15), ("heartbeat", {"worker": "b"}),
             _sleep(0.15), ("heartbeat", {"worker": "b"}), _sleep(0.15),
             lambda D, d: sorted(D.request(d.address, {"cmd": "status"})["todo"])]
    got = _both(steps, uri="d", num_parts=3, liveness_timeout=0.3)
    assert got[-1] == [0, 2]


# ---------------- drain and hedging ----------------

def test_drain_trace():
    steps = [_reg("a", 1), _reg("b", 2), _split("a"), _split("a"),
             ("part_done", {"worker": "a", "part": 0}),
             ("drain", {"worker": "a", "deadline": 30}), ("status", {}), _split("a"),
             _split("b"), ("locate", {"part": 0}), ("locate", {"part": 0, "have": "zzz"}),
             ("drain", {"worker": "a", "deadline": 60}),
             ("drain", {"worker": "ghost", "deadline": 1}),
             ("handoff", {"worker": "a", "part": 0}), ("status", {}), _split("a"),
             ("locate", {"part": 0}), ("status", {})]
    got = _both(steps, uri="d", num_parts=4)
    assert got[6]["todo"] == [1, 2, 3] and got[7].get("draining")
    assert got[14]["workers"]["a"]["state"] == "dead" and got[15].get("drained")


def test_drain_deadline_tightens_and_expires():
    def wait_dead(D, d):
        deadline = time.time() + 5
        while time.time() < deadline:
            st = D.request(d.address, {"cmd": "status"})
            if st["workers"]["a"]["state"] == "dead":
                return st
            time.sleep(0.02)
        return "timeout"
    steps = [_reg("a", 1), _split("a"), ("part_done", {"worker": "a", "part": 0}),
             ("drain", {"worker": "a", "deadline": 60}),
             ("drain", {"worker": "a", "deadline": 120}),
             ("drain", {"worker": "a", "deadline": 0}), wait_dead, _split("a")]
    got = _both(steps, uri="d", num_parts=2)
    assert got[6]["todo"] == [0, 1] and got[7].get("drained")


@pytest.fixture
def fast_hedge(monkeypatch):
    monkeypatch.setenv("DMLC_TPU_HEDGE_FACTOR", "2")
    for pkg in PKGS.values():
        monkeypatch.setattr(pkg.dispatcher, "HEDGE_MIN_AGE_S", 0.2)


def test_hedging_first_complete_wins(fast_hedge):
    def hedged(D, d):
        deadline = time.time() + 8
        while time.time() < deadline:
            if D.request(d.address, {"cmd": "next_split", "worker": "fast"})["part"] == 0:
                return True
            time.sleep(0.02)
        return False
    steps = [_reg("slow", 1), _reg("fast", 2), _split("slow")]
    for part in (1, 2, 3):
        steps += [_split("fast"), ("part_done", {"worker": "fast", "part": part})]
    steps += [hedged, ("status", {}), ("part_done", {"worker": "fast", "part": 0}),
              ("status", {}), ("part_done", {"worker": "slow", "part": 0}), ("status", {})]
    base = {p: PKGS[p].resilience.counters_snapshot() for p in PKGS}
    got = _both(steps, uri="d", num_parts=5)
    assert got[9] is True and got[10]["hedged"] == {"0": "fast"}
    assert got[14]["assigned"]["0"] == "fast" and got[14]["hedged"] == {}
    keys = ("speculative_reissues", "speculative_wins")
    deltas = {p: {k: PKGS[p].resilience.counters_delta(base[p]).get(k, 0) for k in keys}
              for p in PKGS}
    assert deltas["port"] == deltas["jax"] == {"speculative_reissues": 1,
                                               "speculative_wins": 1}


# ---------------- QoS ----------------

def test_qos_validation_over_the_wire(corpus):
    steps = [("register_job", dict(job="bad", uri=corpus, num_parts=3, parser=PARSER_CFG,
                                   **kw))
             for kw in ({"priority": "high"}, {"weight": -2}, {"slo_wait_frac": "x"},
                        {"max_inflight": 0}, {"priority": 1.5})]
    steps += [("register_job", dict(job="crit", uri=corpus, num_parts=3, parser=PARSER_CFG,
                                    priority=2, weight=3, slo_wait_frac=0.25,
                                    max_inflight=4)), ("config", {"job": "crit"}),
              ("config", {}), lambda D, d: d.job_qos()]
    got = _both(steps, uri=corpus, num_parts=3, parser=PARSER_CFG)
    assert [isinstance(r, list) and r[0] == "error" for r in got[:5]] == [True] * 4 + [False]


def test_weighted_drr_and_priority_bands(corpus):
    steps = [lambda D, d: d.register_job("heavy", corpus, 6, parser=PARSER_CFG, weight=2),
             lambda D, d: d.register_job("light", corpus, 3, parser=PARSER_CFG),
             _reg("a", 1)] + [_split("a")] * 5 + [
             lambda D, d: d.register_job("crit", corpus, 2, parser=PARSER_CFG, priority=1)
             ] + [_split("a")] * 7
    got = _both(steps)
    order = [(r["job"], r["part"]) for r in got[3:8] + got[9:] if r.get("part") is not None]
    assert order[:3].count(("heavy", 0)) + order[:3].count(("heavy", 1)) == 2
    assert order[5:7] == [("crit", 0), ("crit", 1)]


def test_inflight_budget_throttles_locate(corpus):
    steps = [lambda D, d: d.register_job("t", corpus, 4, parser=PARSER_CFG, max_inflight=1),
             _reg("a", 1), _reg("b", 2), _split("a"), _split("b"), _split("a"),
             ("locate", {"part": 0, "job": "t"}), ("locate", {"part": 1, "job": "t"}),
             ("part_done", {"worker": "a", "part": 0, "job": "t"}),
             ("locate", {"part": 1, "job": "t"}), ("status", {})]
    _both(steps)


# ---------------- journals across the packages ----------------

def _journal_script(corpus):
    return [_reg("a", 1), _reg("b", 2), _split("a"), _split("b"), _split("a"),
            ("part_done", {"worker": "a", "part": 0}), ("report_lost", {"worker": "b"}),
            lambda D, d: d.register_job("j2", corpus, 2, parser=PARSER_CFG, priority=1,
                                        weight=2, max_inflight=3),
            _split("a"), ("drain", {"worker": "a", "deadline": 60}), ("status", {})]


@pytest.mark.parametrize("writer,reader", [(w, r) for w in PKGS for r in PKGS])
def test_journal_replayed_by_either_package(corpus, tmp_path, writer, reader):
    jp = str(tmp_path / f"{writer}.jsonl")
    _run(writer, _journal_script(corpus), journal_path=jp, uri=corpus, num_parts=3,
         parser=PARSER_CFG)
    replay = [("status", {}), ("config", {}), ("config", {"job": "j2"}),
              lambda D, d: d.job_qos(), lambda D, d: d.generation]
    ref = str(tmp_path / "ref.jsonl")
    _run(reader, _journal_script(corpus), journal_path=ref, uri=corpus, num_parts=3,
         parser=PARSER_CFG)
    got = _run(reader, replay, journal_path=jp, uri=corpus, num_parts=3, parser=PARSER_CFG)
    want = _run(reader, replay, journal_path=ref, uri=corpus, num_parts=3, parser=PARSER_CFG)
    assert got == want
    assert got[4] == 2  # one restart


def test_journal_files_equal_across_packages(corpus, tmp_path):
    recs = {}
    for pkg in PKGS:
        jp = str(tmp_path / f"{pkg}.jsonl")
        _run(pkg, _journal_script(corpus), journal_path=jp, uri=corpus, num_parts=3,
             parser=PARSER_CFG)
        with open(jp) as f:
            recs[pkg] = [json.loads(ln) for ln in f if ln.strip()]
    assert _norm(recs["port"]) == _norm(recs["jax"])


@BOTH
def test_journal_torn_tail_and_compaction(pkg, corpus, tmp_path):
    """A torn last line is skipped, and compaction keeps the state, in
    both packages alike (each replays the other's torn file)."""
    out = {}
    for p in PKGS:
        jp = str(tmp_path / f"{p}.jsonl")
        _run(p, _journal_script(corpus), journal_path=jp, uri=corpus, num_parts=3,
             parser=PARSER_CFG)
        with open(jp, "a") as f:
            f.write('{"op": "grant", "part": 2, "wor')
        reader = pkg
        st = _run(reader, [("status", {})], journal_path=jp, uri=corpus, num_parts=3,
                  parser=PARSER_CFG, journal_compact_lines=8)
        again = _run(reader, [("status", {})], journal_path=jp, uri=corpus, num_parts=3,
                     parser=PARSER_CFG, journal_compact_lines=8)
        with open(jp) as f:
            lines = f.read().splitlines()
        out[p] = (st, again, len(lines))
    assert out["port"][0] == out["jax"][0]
    assert out["port"][1] == out["jax"][1]


@pytest.mark.parametrize("writer,reader", [(w, r) for w in PKGS for r in PKGS])
def test_journal_dataset_mismatch_refused(tmp_path, writer, reader):
    jp = str(tmp_path / "j.jsonl")
    _run(writer, [_reg("a", 1)], journal_path=jp, uri="d", num_parts=3)
    D = PKGS[reader].dispatcher
    with pytest.raises(PKGS[reader].DMLCError) as got:
        D.Dispatcher("d", 4, journal_path=jp, liveness_timeout=0)
    other = PKGS["jax" if reader == "port" else "port"].dispatcher
    with pytest.raises(PKGS["jax" if reader == "port" else "port"].DMLCError) as want:
        other.Dispatcher("d", 4, journal_path=jp, liveness_timeout=0)
    assert str(got.value) == str(want.value)


def test_reclaim_after_restart(tmp_path):
    out = {}
    for pkg in PKGS:
        jp = str(tmp_path / f"{pkg}.jsonl")
        _run(pkg, [_reg("a", 1), _reg("b", 2), _split("a"), _split("b"), _split("a"),
                   ("part_done", {"worker": "a", "part": 0}),
                   ("part_done", {"worker": "b", "part": 1})],
             journal_path=jp, uri="d", num_parts=4)
        out[pkg] = _run(pkg, [("status", {}), _split("a"), _reg("a", 1),
                              ("reclaim", {"worker": "a", "parts": {"default": [0]}}),
                              _reg("b", 2), ("reclaim", {"worker": "b", "parts": {}}),
                              ("status", {}), _split("b")],
                        journal_path=jp, uri="d", num_parts=4)
    assert out["port"] == out["jax"]


# ---------------- request() and shedding ----------------

def _one_shot_server(reply: bytes):
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)

    def serve():
        conn, _ = srv.accept()
        with conn:
            conn.recv(4096)
            if reply:
                conn.sendall(reply)
        srv.close()
    threading.Thread(target=serve, daemon=True).start()
    return f"127.0.0.1:{srv.getsockname()[1]}"


@pytest.mark.parametrize("reply", [b"", b'{"gen": 1, "pa', b'{"busy": true}\n',
                                   b'{"error": "unknown worker"}\n', b'{"ok": true}\n'])
def test_request_classifies_replies_as_reference(reply):
    out = {}
    for pkg in PKGS:
        addr = _one_shot_server(reply)
        try:
            res = PKGS[pkg].dispatcher.request(addr, {"cmd": "status"}, timeout=5)
        except Exception as exc:  # noqa: BLE001 - compared across packages
            res = [type(exc).__name__, str(exc).replace(addr, "ADDR"),
                   PKGS[pkg].resilience.classify(exc)]
        out[pkg] = res
    assert out["port"] == out["jax"]


def test_handler_cap_sheds_busy(monkeypatch):
    out = {}
    for pkg in PKGS:
        D = PKGS[pkg].dispatcher
        monkeypatch.setenv("DMLC_TPU_DISPATCH_WORKERS", "1")
        disp = D.Dispatcher("d", 1, liveness_timeout=0)
        try:
            hog = socket.create_connection((disp.host, disp.port))  # holds the one slot
            time.sleep(0.2)
            try:
                D.request(disp.address, {"cmd": "status"}, timeout=5)
                res = "served"
            except ConnectionError as exc:
                res = str(exc).replace(disp.address, "ADDR")
            hog.close()
            res2 = None
            deadline = time.time() + 5
            while res2 is None and time.time() < deadline:
                try:
                    res2 = sorted(D.request(disp.address, {"cmd": "status"}, timeout=5))
                except ConnectionError:
                    time.sleep(0.05)
        finally:
            disp.close()
        out[pkg] = (res, res2)
    assert out["port"] == out["jax"]
