"""The port's online autotuner and the live resizes it drives, against the
JAX package's (``dmlc_tpu/data/autotune.py`` and what it moves).

Checked on the CPU (``device="cpu"``), the same inputs through both
packages:

- the controller: every case of the JAX package's controller tests
  (parse-, read-, convert-, cache-, snapshot- and dispatch-bound, the
  transfer no-op, hysteresis, ``hold_steps=1``, an improvement that
  commits, cooldown, environment bounds, an unavailable knob, a refused
  revert, a tiny window) and seeded random window sequences give equal
  decision histories, ``snapshot()``s, knob values and ledger events (their
  timestamps aside); ``ParseTierTuner.decide``, ``efficiency_window`` and
  ``env_config`` are equal;
- the knob table: ``KNOB_TABLE``'s rows, ``resolve``, ``bounds``,
  ``autotune_enabled`` and ``autotune_interval`` equal under the same
  environment, with the same error texts;
- the live resizes: ``OrderedWorkerPool.resize`` (grow, shrink, shrink then
  grow), ``set_max_ahead``, ``ThreadedIter.set_capacity`` and ``recycle``
  deliver the JAX primitives' items in their order, and
  ``ParallelTextParser.resize_parse_workers`` mid-stream gives blocks
  byte-equal to JAX's;
- ``restart_policy``: one retryable error mid-stream (``ThreadedIter``,
  ``OrderedWorkerPool``, ``ParallelTextParser``) heals to the clean items,
  a spent budget gives up and a fatal error propagates, with the JAX
  package's counters; a ``DeviceIter`` whose source fails once mid-epoch
  restarts and delivers the clean batches;
- ``DeviceIter(autotune=True)`` (dense and ell, cold and warm) gives the
  JAX ``DeviceIter(autotune=True)``'s batches byte for byte, across forced
  live knob changes, and a state taken after them restores to the same
  bytes; ``stats()["autotune"]`` has the JAX snapshot's keys and types;
- the staging ring: a shrink then a grow mid-epoch, with the workers parked
  on a full ring, does not deadlock, and the grow's slots are made by the
  workers.

Every case that could hang runs its body under a join timeout.
"""

import json
import threading

import numpy as np
import pytest

from dmlc_tpu.data import autotune as jax_autotune
from dmlc_tpu.data import create_parser as jax_create_parser
from dmlc_tpu.data.device import DeviceIter as JaxDeviceIter
from dmlc_tpu.io import resilience as jax_resilience
from dmlc_tpu.io import threaded_iter as jax_threaded
from dmlc_tpu.utils import knobs as jax_knobs
from dmlc_tpu.utils import telemetry as jax_telemetry
from dmlc_tpu.utils.check import DMLCError as JaxDMLCError
from dmlc_tpu_torch.data import DeviceIter, autotune, create_parser
from dmlc_tpu_torch.data.parsers import Parser
from dmlc_tpu_torch.io import resilience, threaded_iter
from dmlc_tpu_torch.utils import knobs, telemetry
from dmlc_tpu_torch.utils.check import DMLCError

NUM_COL, BATCH, CHUNK, ROWS = 6, 64, 2048, 900
JOIN_TIMEOUT = 30.0
TUNABLE_ENVS = ("DMLC_TPU_PARSE_WORKERS", "DMLC_TPU_CONVERT_WORKERS",
                "DMLC_TPU_PLAN_READ_WORKERS", "DMLC_TPU_SNAPSHOT_READ_WORKERS",
                "DMLC_TPU_PREFETCH", "DMLC_TPU_CONVERT_AHEAD", "DMLC_TPU_AUTOTUNE",
                "DMLC_TPU_AUTOTUNE_INTERVAL", "DMLC_TPU_TRANSFER_SAMPLE", "DMLC_TPU_TRACE",
                "DMLC_RETRY_MAX_ATTEMPTS")
LAYOUTS = {"dense": {}, "ell": {"layout": "ell", "max_nnz": NUM_COL}}


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    """The JAX controller tests' environment: the knobs unset, and the
    worker caps (the CPU count by default) raised so growth is exercised."""
    import os

    for name in TUNABLE_ENVS:
        monkeypatch.delenv(name, raising=False)
    for name in list(os.environ):
        if name.startswith(("DMLC_TPU_AUTOTUNE_MIN_", "DMLC_TPU_AUTOTUNE_MAX_")):
            monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("DMLC_TPU_AUTOTUNE_MAX_PARSE_WORKERS", "6")
    monkeypatch.setenv("DMLC_TPU_AUTOTUNE_MAX_PLAN_READ_WORKERS", "4")
    monkeypatch.setenv("DMLC_TPU_AUTOTUNE_MAX_SNAPSHOT_READ_WORKERS", "4")
    monkeypatch.setenv("DMLC_TPU_NO_NATIVE_READER", "1")
    yield
    telemetry.set_scope(None)
    jax_telemetry.set_scope(None)


def _within_timeout(fn):
    """``fn()``'s result, run on a thread joined with a timeout: a hang
    fails the case instead of hanging the suite."""
    out, errors = [], []

    def run():
        try:
            out.append(fn())
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(JOIN_TIMEOUT)
    assert not t.is_alive(), f"did not return within {JOIN_TIMEOUT} s"
    if errors:
        raise errors[0]
    return out[0]


# ---------------- the controller on synthetic windows ----------------

def _win(wall=1.0, batches=100, wait_frac=0.5, transfer=0.0, events=0, **busy):
    return {"wall": wall, "batches": batches, "input_wait": wait_frac * wall, "busy": busy,
            "transfer_est": transfer, "resilience_events": events}


def _fake_knobs(mod, store, names, refuse=None):
    """Identical fake knobs over ``store``; ``refuse(name, value)`` True
    makes that apply fail."""
    built = []
    for n in names:
        def apply(v, n=n):
            if refuse is not None and refuse(n, int(v)):
                return False
            store[n] = int(v)
            return True
        built.append(mod.Knob(n, get=lambda n=n: store[n], apply=apply))
    return built


# each case: (initial knob values, tuner kwargs, windows, refusal rule)
def _refuse_all(name, value):
    return True


class _RefuseAfter:
    """Accept the first ``n`` applies, refuse the rest (a tier that stops
    being resizable between windows)."""

    def __init__(self, n):
        self.n = n

    def __call__(self, name, value):
        self.n -= 1
        return self.n < 0


CASES = {
    "parse_bound": ({"parse_workers": 2, "convert_ahead": 4}, {},
                    [_win(parse=0.8, convert=0.1)] * 3, None),
    "read_bound": ({"parse_workers": 2}, {}, [_win(read=0.9)], None),
    "convert_bound": ({"parse_workers": 2, "convert_ahead": 2}, {},
                      [_win(convert=0.9, parse=0.05)] * 3, None),
    "cache_and_snapshot_read": ({"plan_read_workers": 2, "snapshot_read_workers": 2}, {},
                                [_win(cache_read=0.9), _win(snapshot_read=0.9)], None),
    "dispatch_bound": ({"prefetch": 2}, {}, [_win(dispatch=0.9)], None),
    "device_decode_bound": ({"prefetch": 2}, {}, [_win(device_decode=0.9)], None),
    "transfer_noop": ({"parse_workers": 2}, {},
                      [_win(wait_frac=0.01, parse=0.5),
                       _win(wait_frac=0.5, parse=0.2, transfer=0.8)], None),
    "hysteresis": ({"parse_workers": 2}, {"hold_steps": 3},
                   [_win(batches=100, parse=0.8), _win(batches=80, parse=0.8)]
                   + [_win(batches=100, parse=0.8)] * 4, None),
    "hold_steps_one": ({"parse_workers": 2}, {"hold_steps": 1},
                       [_win(batches=100, parse=0.8), _win(batches=50, parse=0.8),
                        _win(batches=100, parse=0.8), _win(batches=100, parse=0.8)], None),
    "improvement_commits": ({"parse_workers": 2}, {},
                            [_win(batches=100, parse=0.8), _win(batches=130, parse=0.8)],
                            None),
    "cooldown": ({"parse_workers": 2}, {"cooldown_steps": 2},
                 [_win(parse=0.9, events=3), _win(parse=0.9), _win(parse=0.9)], None),
    "env_bounds": ({"parse_workers": 2}, {}, [_win(parse=0.9)] * 5, None),
    "unavailable_knob": ({"parse_workers": 2}, {}, [_win(parse=0.9)] * 4, _refuse_all),
    "failed_revert": ({"parse_workers": 2}, {},
                      [_win(batches=100, parse=0.9), _win(batches=50, parse=0.9)],
                      "after1"),
    "tiny_window": ({"parse_workers": 2}, {}, [_win(batches=1, parse=0.9)], None),
    "fallback_service_depth": ({"service_pipeline_depth": 4}, {}, [_win(read=0.9)] * 2, None),
}


def _run_case(mod, tel, case, monkeypatch):
    store0, kw, windows, refuse = CASES[case]
    if case == "env_bounds":
        monkeypatch.setenv("DMLC_TPU_AUTOTUNE_MAX_PARSE_WORKERS", "3")
    if refuse == "after1":
        refuse = _RefuseAfter(1)
    store = dict(store0)
    tel.reset_decisions()
    tuner = mod.AutoTuner(_fake_knobs(mod, store, list(store0), refuse),
                          scope=f"case-{case}", min_batches=4, **kw)
    decisions = [tuner.step(dict(w, busy=dict(w["busy"]))) for w in windows]
    ledger = [{k: v for k, v in e.items() if k != "ts"}
              for e in tel.decisions_snapshot("autotune")]
    return {"decisions": decisions, "history": tuner.history, "snapshot": tuner.snapshot(),
            "store": store, "converged": tuner.converged, "ledger": ledger}


@pytest.mark.parametrize("case", sorted(CASES))
def test_controller_cases_match_reference(case, monkeypatch):
    got = _run_case(autotune, telemetry, case, monkeypatch)
    want = _run_case(jax_autotune, jax_telemetry, case, monkeypatch)
    assert got == want
    assert got["history"], case


def test_controller_case_outcomes(monkeypatch):
    """The cases' outcomes, as the JAX package's controller tests state
    them (so an equal wrong answer in both would still fail)."""
    r = {c: _run_case(autotune, telemetry, c, monkeypatch) for c in CASES}
    assert r["parse_bound"]["store"]["parse_workers"] > 2
    assert r["read_bound"]["store"] == {"parse_workers": 3}
    assert r["convert_bound"]["store"] == {"parse_workers": 2, "convert_ahead": 5}
    assert r["cache_and_snapshot_read"]["store"] == {"plan_read_workers": 3,
                                                     "snapshot_read_workers": 3}
    assert r["dispatch_bound"]["store"] == r["device_decode_bound"]["store"] == {"prefetch": 3}
    assert [d["action"] for d in r["transfer_noop"]["decisions"]] == ["steady", "steady"]
    assert r["transfer_noop"]["converged"]
    assert [d["action"] for d in r["hysteresis"]["decisions"]] == [
        "grow", "revert", "bound", "bound", "bound", "grow"]
    assert [d["action"] for d in r["hold_steps_one"]["decisions"]] == [
        "grow", "revert", "bound", "grow"]
    assert r["improvement_commits"]["store"] == {"parse_workers": 4}
    assert [d["action"] for d in r["cooldown"]["decisions"]] == ["cooldown", "hold", "grow"]
    assert r["env_bounds"]["store"] == {"parse_workers": 3}
    assert "DMLC_TPU_AUTOTUNE_MAX" in r["env_bounds"]["decisions"][-1]["rationale"]
    assert [d["action"] for d in r["unavailable_knob"]["decisions"]] == ["bound"] * 4
    d = r["failed_revert"]["decisions"][-1]
    assert d["action"] == "revert_failed" and d["to"] == 3 and "REFUSED" in d["rationale"]
    assert r["tiny_window"]["decisions"][0]["action"] == "skip"
    assert r["fallback_service_depth"]["store"] == {"service_pipeline_depth": 6}
    assert {e["action"] for e in r["hysteresis"]["ledger"]} == {"grow", "revert", "bound"}


def _random_windows(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    stages = ("read", "cache_read", "snapshot_read", "parse", "convert", "dispatch",
              "device_decode")
    out = []
    for _ in range(n):
        busy = {s: float(rng.random()) for s in stages if rng.random() < 0.6}
        out.append(_win(wall=float(0.2 + rng.random()), batches=int(rng.integers(0, 200)),
                        wait_frac=float(rng.random() * 0.6),
                        transfer=float(rng.random() * 0.5 if rng.random() < 0.3 else 0.0),
                        events=int(rng.random() < 0.1), **busy))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_seeded_window_sequences_match_reference(seed):
    names = ("prefetch", "convert_ahead", "parse_workers", "plan_read_workers",
             "snapshot_read_workers")
    windows = _random_windows(seed, 60)
    out = []
    for mod, tel in ((autotune, telemetry), (jax_autotune, jax_telemetry)):
        store = {n: 2 for n in names}
        tel.reset_decisions()
        tuner = mod.AutoTuner(_fake_knobs(mod, store, names), scope=f"seq-{seed}",
                              hold_steps=2, cooldown_steps=1)
        for w in windows:
            tuner.step(dict(w, busy=dict(w["busy"])))
        out.append((tuner.history, tuner.snapshot(history=64), store,
                    [{k: v for k, v in e.items() if k != "ts"}
                     for e in tel.decisions_snapshot("autotune")]))
    assert out[0] == out[1]
    assert {h["action"] for h in out[0][0]} >= {"grow", "steady"}


def test_step_mirrors_on_the_registry():
    store = {"parse_workers": 2}
    tuner = autotune.AutoTuner(_fake_knobs(autotune, store, ["parse_workers"]),
                               scope="mirror-scope")
    tuner.step(_win(parse=0.9))
    rows = telemetry.REGISTRY.snapshot(telemetry.AUTOTUNE_KNOB_METRIC, pipeline="mirror-scope")
    assert {r["labels"]["knob"]: r["value"] for r in rows} == {"parse_workers": 3.0}
    assert telemetry.REGISTRY.sum(telemetry.AUTOTUNE_STEP_METRIC, pipeline="mirror-scope") == 1
    assert telemetry.span_counts().get("autotune_step", 0) >= 1
    with pytest.raises(DMLCError, match="duplicate knob names"):
        autotune.AutoTuner(_fake_knobs(autotune, store, ["parse_workers"]) * 2)


def test_parse_tier_tuner_matches_reference():
    effs = [0.9, 0.1, 0.5, None, 0.95, 0.95, 0.95, 0.95, 0.2, 0.71]
    out = []
    for mod in (autotune, jax_autotune):
        t = mod.ParseTierTuner(start=2)
        picks = [t.decide(e) for e in effs] + [t.decide(0.9, workers=6)]
        out.append((picks, t.history, t.snapshot()))
    assert out[0] == out[1]
    assert out[0][0][:4] == [3, 2, 2, 2] and out[0][2]["bounds"] == [1, 6]


def test_efficiency_window_and_env_config_match_reference():
    s1 = {"parse_busy_seconds": 2.0, "parse_span_seconds": 1.0, "parse_workers": 2}
    s2 = {"parse_busy_seconds": 5.0, "parse_span_seconds": 2.0, "parse_workers": 3}
    for mod in (autotune, jax_autotune):
        eff, prev = mod.efficiency_window(None, s1)
        assert eff == pytest.approx(1.0)
        eff, prev = mod.efficiency_window(prev, s2)
        assert eff == pytest.approx(1.0)
        assert mod.efficiency_window(prev, s2)[0] is None
        assert mod.efficiency_window(None, None) == (None, {"busy": 0.0, "span": 0.0})
    values = {"parse_workers": 4, "prefetch": 3, "convert_ahead": 8, "nope": 2,
              "service_pipeline_depth": 5}
    assert autotune.env_config(values) == jax_autotune.env_config(values)
    assert autotune.STAGE_KNOB == jax_autotune.STAGE_KNOB
    assert autotune.STAGE_KNOB_FALLBACK == jax_autotune.STAGE_KNOB_FALLBACK


# ---------------- the knob table ----------------

def test_knob_table_rows_match_reference():
    assert list(knobs.KNOB_TABLE) == list(jax_knobs.KNOB_TABLE)
    for name, spec in knobs.KNOB_TABLE.items():
        ref = jax_knobs.KNOB_TABLE[name]
        assert (spec.env, spec.default_value(), spec.lo, spec.hi_value()) == (
            ref.env, ref.default_value(), ref.lo, ref.hi_value())
        assert knobs.resolve(name) == jax_knobs.resolve(name)
        assert knobs.resolve(name, 0) == jax_knobs.resolve(name, 0)


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except (DMLCError, JaxDMLCError) as exc:
        return ("raise", str(exc))


@pytest.mark.parametrize("raw", ["8", "junk", "0", "-3", "2.5", ""])
@pytest.mark.parametrize("name", sorted(jax_knobs.KNOB_TABLE))
def test_resolve_and_bounds_match_reference_under_env(name, raw, monkeypatch):
    env = jax_knobs.KNOB_TABLE[name].env
    monkeypatch.setenv(env, raw)
    assert _outcome(knobs.resolve, name) == _outcome(jax_knobs.resolve, name)
    monkeypatch.setenv(f"DMLC_TPU_AUTOTUNE_MAX_{name.upper()}", raw)
    assert _outcome(knobs.bounds, name) == _outcome(jax_knobs.bounds, name)
    monkeypatch.setenv(f"DMLC_TPU_AUTOTUNE_MIN_{name.upper()}", "9")
    assert _outcome(knobs.bounds, name) == _outcome(jax_knobs.bounds, name)


def test_unknown_knob_texts_match_reference():
    for fn in ("resolve", "bounds"):
        assert _outcome(getattr(knobs, fn), "no_such_knob") == _outcome(
            getattr(jax_knobs, fn), "no_such_knob")


@pytest.mark.parametrize("raw", [None, "", "1", "0", "yes", " 1 "])
def test_autotune_enabled_matches_reference(raw, monkeypatch):
    if raw is None:
        monkeypatch.delenv("DMLC_TPU_AUTOTUNE", raising=False)
    else:
        monkeypatch.setenv("DMLC_TPU_AUTOTUNE", raw)
    for explicit in (None, True, False):
        assert knobs.autotune_enabled(explicit) is jax_knobs.autotune_enabled(explicit)


@pytest.mark.parametrize("raw", [None, "", "32", "0", "x", "-1", "2.5"])
def test_autotune_interval_matches_reference(raw, monkeypatch):
    if raw is None:
        monkeypatch.delenv("DMLC_TPU_AUTOTUNE_INTERVAL", raising=False)
    else:
        monkeypatch.setenv("DMLC_TPU_AUTOTUNE_INTERVAL", raw)
    for explicit in (None, 7, 0, -1):
        assert _outcome(knobs.autotune_interval, explicit) == _outcome(
            jax_knobs.autotune_interval, explicit)


def test_store_and_service_readers_match_reference(monkeypatch):
    for env, fn in (("DMLC_TPU_STORE_BUDGET_BYTES", "store_budget_bytes"),
                    ("DMLC_TPU_STORE_JOB_BUDGET_BYTES", "store_job_budget_bytes"),
                    ("DMLC_TPU_QOS_MAX_INFLIGHT", "qos_max_inflight"),
                    ("DMLC_TPU_STORE_GC_AGE_SECONDS", "store_gc_age_seconds")):
        for raw in ("", "1024", "0", "junk"):
            monkeypatch.setenv(env, raw)
            for explicit in (None, 5, 0):
                assert _outcome(getattr(knobs, fn), explicit) == _outcome(
                    getattr(jax_knobs, fn), explicit), (env, raw, explicit)
    for raw in ("", "zstd", "OFF", "snappy"):
        monkeypatch.setenv("DMLC_TPU_WIRE_COMPRESSION", raw)
        assert _outcome(knobs.wire_compression) == _outcome(jax_knobs.wire_compression)


# ---------------- the live resizes ----------------

def _pool_run(mod, ops):
    pool = mod.OrderedWorkerPool(lambda: iter(range(300)), lambda x: x * 2, num_workers=1,
                                 max_ahead=4)
    out = []
    try:
        for n, op in ops:
            out += [pool.next() for _ in range(n)]
            op(pool)
        while (v := pool.next()) is not None:
            out.append(v)
    finally:
        pool.destroy()
    return out, pool.num_workers


POOL_OPS = {
    "grow_then_shrink": [(100, lambda p: p.resize(4)),
                         (100, lambda p: (p.resize(1), p.set_max_ahead(2)))],
    "shrink_then_grow": [(10, lambda p: p.resize(3)), (0, lambda p: p.resize(1)),
                         (5, lambda p: p.resize(3))],
    "window_only": [(7, lambda p: p.set_max_ahead(16)), (50, lambda p: p.set_max_ahead(1))],
    "many_flips": [(i, (lambda p, i=i: (p.resize(1 + i % 4), p.set_max_ahead(1 + i % 7))))
                   for i in range(1, 20)],
}


@pytest.mark.parametrize("ops", sorted(POOL_OPS))
def test_pool_resizes_deliver_the_reference_items(ops):
    got = _within_timeout(lambda: _pool_run(threaded_iter, POOL_OPS[ops]))
    want = _within_timeout(lambda: _pool_run(jax_threaded, POOL_OPS[ops]))
    assert got == want and got[0] == [2 * i for i in range(300)]


def test_pool_shrink_takes_exit_credits_and_grow_cancels_them():
    def run():
        pool = threaded_iter.OrderedWorkerPool(lambda: iter(range(50)), lambda x: x,
                                               num_workers=3, max_ahead=4)
        try:
            pool.resize(1)
            assert pool._shrink == 2 or sum(t.is_alive() for t in pool._threads) < 3
            pool.resize(3)  # cancels the pending exits or starts threads
            items = [pool.next() for _ in range(50)]
            assert pool.next() is None
            return items, pool.num_workers
        finally:
            pool.destroy()
    assert _within_timeout(run) == (list(range(50)), 3)


def _threaded_run(mod):
    it = mod.ThreadedIter.from_factory(lambda: iter(range(100)), max_capacity=2)
    try:
        out = [it.next() for _ in range(10)]
        it.set_capacity(8)
        out += [it.next() for _ in range(40)]
        it.set_capacity(1)
        while (v := it.next()) is not None:
            out.append(v)
        return out
    finally:
        it.destroy()


def test_threaded_iter_set_capacity_matches_reference():
    assert _within_timeout(lambda: _threaded_run(threaded_iter)) == _within_timeout(
        lambda: _threaded_run(jax_threaded)) == list(range(100))


def _recycle_run(mod):
    made = []

    def produce(cell):
        if len(made) >= 30:
            return False, None
        buf = cell if cell is not None else []
        buf.clear()
        buf.append(len(made))
        made.append(cell is not None)
        return True, buf

    it = mod.ThreadedIter(produce, max_capacity=2)
    out = []
    try:
        while (item := it.next()) is not None:
            out.append(item[0])
            it.recycle(item)
        return out, any(made)
    finally:
        it.destroy()


def test_threaded_iter_recycle_matches_reference():
    got = _within_timeout(lambda: _recycle_run(threaded_iter))
    assert got == _within_timeout(lambda: _recycle_run(jax_threaded))
    assert got == (list(range(30)), True)


def _corpus(tmp_path, n=ROWS, name="tune.libsvm"):
    rng = np.random.default_rng(14)
    path = tmp_path / name
    with open(path, "w") as f:
        for i in range(n):
            cols = np.flatnonzero(rng.random(NUM_COL) < 0.7)
            f.write(f"{i % 2} " + " ".join(f"{j}:{rng.normal():.5f}" for j in cols) + "\n")
    return str(path)


def _block_bytes(block) -> bytes:
    return b"".join(np.ascontiguousarray(a).tobytes() for a in (
        block.offset, block.label, block.index, block.value))


def _drain_blocks(parser, resize_at=None, to=None):
    out, n = [], 0
    while (blk := parser.next_block()) is not None:
        out.append(_block_bytes(blk))
        n += 1
        if resize_at is not None and n == resize_at:
            assert parser.resize_parse_workers(to)
    parser.close()
    return out


@pytest.mark.parametrize("start,at,to", [(2, 3, 4), (4, 2, 1), (1, 1, 3)])
def test_parallel_parser_resize_matches_reference(tmp_path, start, at, to):
    uri = _corpus(tmp_path)

    def run():
        static = _drain_blocks(create_parser(uri, 0, 1, "libsvm", parse_workers=2,
                                             chunk_bytes=CHUNK))
        if start == 1:  # the one-lane parser has no live width
            assert create_parser(uri, parse_workers=1).resize_parse_workers is None
            return static, static, static
        port = _drain_blocks(create_parser(uri, 0, 1, "libsvm", parse_workers=start,
                                           chunk_bytes=CHUNK), at, to)
        ref = _drain_blocks(jax_create_parser(uri + "?engine=python", 0, 1, "libsvm",
                                              threaded=True, parse_workers=start,
                                              chunk_bytes=CHUNK), at, to)
        return static, port, ref
    static, port, ref = _within_timeout(run)
    assert len(static) > 4 and port == static == ref


# ---------------- restart_policy ----------------

class _Flaky:
    """A deterministic iterator factory whose first iterator raises a
    retryable (or, ``fatal``, a fatal) error at item ``at``; with ``always``
    every iterator does."""

    def __init__(self, n=40, at=13, always=False, fatal=False):
        self.n, self.at, self.always, self.fatal = n, at, always, fatal
        self.calls = 0

    def __call__(self):
        self.calls += 1
        fail = self.always or self.calls == 1

        def gen():
            for i in range(self.n):
                if fail and i == self.at:
                    raise (ValueError("bad record") if self.fatal
                           else ConnectionResetError("peer reset"))
                yield i
        return gen()


def _policy(mod, attempts=3):
    return mod.RetryPolicy(max_attempts=attempts, base_delay=0.0, max_delay=0.0, seed=0)


def _restart_run(threaded_mod, res_mod, tel, kind, flaky, attempts=3):
    label = tel.new_pipeline_label("restart-test")
    with tel.scope(label):
        if kind == "threaded":
            it = threaded_mod.ThreadedIter.from_factory(
                flaky, max_capacity=4, restart_policy=_policy(res_mod, attempts))
        else:
            it = threaded_mod.OrderedWorkerPool(flaky, lambda x: x * 3, num_workers=3,
                                                max_ahead=4,
                                                restart_policy=_policy(res_mod, attempts),
                                                counter_label="convert")
    out, error = [], None
    try:
        while (v := it.next()) is not None:
            out.append(v)
    except Exception as exc:  # noqa: BLE001 - compared below
        error = type(exc).__name__
    finally:
        it.destroy()
    counts = {k: v for k, v in res_mod.counters_snapshot(label).items() if v}
    return out, error, it.restarts, it.restart_giveups, counts


@pytest.mark.parametrize("kind", ["threaded", "pool"])
@pytest.mark.parametrize("mode", ["heal", "giveup", "fatal"])
def test_restart_policy_matches_reference(kind, mode):
    kw = {"heal": {}, "giveup": {"always": True}, "fatal": {"fatal": True}}[mode]
    got = _within_timeout(lambda: _restart_run(threaded_iter, resilience, telemetry, kind,
                                               _Flaky(**kw), attempts=2))
    want = _within_timeout(lambda: _restart_run(jax_threaded, jax_resilience, jax_telemetry,
                                                kind, _Flaky(**kw), attempts=2))
    assert got == want
    scale = 1 if kind == "threaded" else 3
    if mode == "heal":
        assert got[0] == [scale * i for i in range(40)] and got[1] is None and got[2] == 1
    elif mode == "giveup":
        assert got[1] == "ConnectionResetError" and got[2] == 1 and got[3] == 1
    else:
        assert got[1] == "ValueError" and got[2] == 0 and got[3] == 0


def test_restart_verdict_and_classify_match_reference():
    import urllib.error

    errors = [ConnectionResetError("x"), TimeoutError(), ValueError("v"),
              urllib.error.HTTPError("u", 503, "busy", {"Retry-After": "2"}, None),
              urllib.error.HTTPError("u", 404, "gone", {}, None),
              OSError("wrapped")]
    errors[-1].__cause__ = TimeoutError()
    for exc in errors:
        assert resilience.classify(exc) == jax_resilience.classify(exc)
        assert resilience.retry_after_seconds(exc) == jax_resilience.retry_after_seconds(exc)
        for used in range(4):
            for pol in (None, 1, 3):
                mine = None if pol is None else resilience.RetryPolicy(max_attempts=pol)
                ref = None if pol is None else jax_resilience.RetryPolicy(max_attempts=pol)
                assert resilience.restart_verdict(mine, used, exc) == \
                    jax_resilience.restart_verdict(ref, used, exc)
    a, b = resilience.RetryPolicy(seed=3), jax_resilience.RetryPolicy(seed=3)
    assert [a.backoff(i, floor=0.01 * i) for i in range(8)] == [
        b.backoff(i, floor=0.01 * i) for i in range(8)]


def test_retry_policy_call_matches_reference(monkeypatch):
    monkeypatch.setenv("DMLC_RETRY_MAX_ATTEMPTS", "3")
    for res in (resilience, jax_resilience):
        assert res.default_policy().max_attempts == 3
        assert res.RetryPolicy.none().max_attempts == 1
    out = []
    for res, err in ((resilience, DMLCError), (jax_resilience, JaxDMLCError)):
        res.reset_counters()
        sleeps = []
        pol = res.RetryPolicy(max_attempts=3, seed=1, sleep_fn=sleeps.append)
        calls = iter([ConnectionResetError("a"), TimeoutError("b"), "done"])

        def fn():
            v = next(calls)
            if isinstance(v, BaseException):
                raise v
            return v
        first = pol.call(fn, op="read", what="x", resume_offset=5)
        with pytest.raises(err) as info:
            pol.call(lambda: (_ for _ in ()).throw(ConnectionResetError("c")), what="y")
        with pytest.raises(err):
            pol.call(lambda: (_ for _ in ()).throw(ValueError("fatal")), what="z")
        counts = {k: v for k, v in res.counters_snapshot().items() if v}
        out.append((first, sleeps, str(info.value), counts))
    assert out[0] == out[1]


def _flaky_split(parser, at=3):
    """Make the split under a parse fan-out raise a retryable error once,
    at its ``at``-th chunk."""
    split = parser.base.source
    real, state = split.next_chunk, {"n": 0}

    def next_chunk():
        state["n"] += 1
        if state["n"] == at:
            raise ConnectionResetError("split read reset")
        return real()
    split.next_chunk = next_chunk


@pytest.mark.parametrize("policy", [True, False])
def test_parse_pool_restart_matches_reference(tmp_path, policy):
    uri = _corpus(tmp_path)

    def run(make, res, tel):
        label = tel.new_pipeline_label("parse-restart")
        parser = make()
        if policy:
            parser._restart_policy = _policy(res)
        _flaky_split(parser)
        with tel.scope(label):
            try:
                blocks, error = _drain_blocks(parser), None
            except Exception as exc:  # noqa: BLE001 - compared below
                blocks, error = None, type(exc).__name__
                parser.close()
        return blocks, error, {k: v for k, v in res.counters_snapshot(label).items() if v}

    clean = _within_timeout(lambda: _drain_blocks(create_parser(
        uri, 0, 1, "libsvm", parse_workers=2, chunk_bytes=CHUNK)))
    got = _within_timeout(lambda: run(lambda: create_parser(
        uri, 0, 1, "libsvm", parse_workers=2, chunk_bytes=CHUNK), resilience, telemetry))
    want = _within_timeout(lambda: run(lambda: jax_create_parser(
        uri + "?engine=python", 0, 1, "libsvm", threaded=True, parse_workers=2,
        chunk_bytes=CHUNK), jax_resilience, jax_telemetry))
    assert got == want
    if policy:
        assert got[0] == clean and got[2] == {"parse_restarts": 1}
    else:
        assert got[1] == "ConnectionResetError" and got[2] == {}


class _FailOnce(Parser):
    """A parser that raises a retryable error once, at its ``at``-th block
    (over the wrapped parser's blocks and state)."""

    def __init__(self, inner, at):
        self.inner, self.at, self.n, self.fired = inner, at, 0, False

    def before_first(self):
        self.n = 0
        self.inner.before_first()

    def next_block(self):
        self.n += 1
        if self.n == self.at and not self.fired:
            self.fired = True
            raise ConnectionResetError("source reset")
        return self.inner.next_block()

    def state_dict(self):
        return self.inner.state_dict()

    def load_state(self, state):
        self.inner.load_state(state)

    def close(self):
        self.inner.close()


def test_device_iter_restarts_a_failed_source_as_reference(tmp_path):
    uri = _corpus(tmp_path)
    clean_it = _port_iter(uri, "ell")
    clean = _drain(clean_it, "ell")
    clean_it.close()
    it = DeviceIter(_FailOnce(create_parser(uri, 0, 1, "libsvm", chunk_bytes=CHUNK,
                                            parse_workers=1), at=4),
                    num_col=NUM_COL, batch_size=BATCH, device="cpu", **LAYOUTS["ell"])
    got = _within_timeout(lambda: _drain(it, "ell"))
    stats = it.stats()
    it.close()
    assert got == clean and stats["resilience"]["pipeline_restarts"] == 1
    jax_it = JaxDeviceIter(_FailOnce(jax_create_parser(
        uri + "?engine=python", 0, 1, "libsvm", threaded=True, parse_workers=1,
        chunk_bytes=CHUNK), at=4), num_col=NUM_COL, batch_size=BATCH, **LAYOUTS["ell"])
    want = [[np.asarray(a).tobytes() for a in b] for b in jax_it]
    assert want == clean and jax_it.stats()["resilience"]["pipeline_restarts"] == 1
    jax_it.close()


# ---------------- DeviceIter(autotune=True) ----------------

def _jax_iter(uri, layout, snapshot=None, **kw):
    parser = jax_create_parser(uri + "?engine=python", 0, 1, "libsvm", threaded=True,
                               parse_workers=2, chunk_bytes=CHUNK, snapshot=snapshot)
    return JaxDeviceIter(parser, num_col=NUM_COL, batch_size=BATCH, **LAYOUTS[layout], **kw)


def _port_iter(uri, layout, snapshot=None, **kw):
    parser = create_parser(uri, 0, 1, "libsvm", chunk_bytes=CHUNK, parse_workers=2,
                           snapshot=snapshot)
    return DeviceIter(parser, num_col=NUM_COL, batch_size=BATCH, device="cpu",
                      **LAYOUTS[layout], **kw)


def _bytes(batch) -> list:
    arrays = [batch.packed] if hasattr(batch, "packed") else list(batch)
    return [np.asarray(a).tobytes() for a in arrays]


def _drain(it, layout=None, n=None, on_batch=None) -> list:
    out = []
    for batch in it:
        out.append(_bytes(batch))
        if on_batch is not None:
            on_batch(len(out))
        if n is not None and len(out) == n:
            break
    return out


def _force_knobs(it, warm: bool) -> None:
    """Move every live knob the pipeline has through the controller's apply
    paths: widen, then narrow below the start, then widen again."""
    for ahead, pre, parse, srw in ((6, 4, 4, 3), (1, 1, 1, 1), (3, 2, 3, 2)):
        assert it._apply_convert_ahead(ahead) and it._apply_prefetch(pre)
        if warm:
            assert it._apply_snapshot_read_workers(srw)
        else:
            assert it._apply_parse_workers(parse)


@pytest.mark.parametrize("layout", ["dense", "ell"])
@pytest.mark.parametrize("warm", [False, True])
def test_autotuned_batches_and_states_match_reference(tmp_path, layout, warm):
    uri = _corpus(tmp_path)
    snap = str(tmp_path / "tune.snapshot") if warm else None
    jax_snap = str(tmp_path / "jax.snapshot") if warm else None

    def epoch_pair(make, path):
        it = make(path)
        if warm:  # the cold pass writes the snapshot
            _drain(it)
            it.reset()
        return it

    def run():
        ref = epoch_pair(lambda p: _jax_iter(uri, layout, snapshot=p, autotune=True,
                                             autotune_interval=2), jax_snap)
        want = _drain(ref)
        ref_stats = ref.stats()
        ref.close()
        it = epoch_pair(lambda p: _port_iter(uri, layout, snapshot=p, autotune=True,
                                             autotune_interval=2), snap)
        state = {}

        def poke(n):
            if n == 3:
                _force_knobs(it, warm)
                state["at"] = json.loads(json.dumps(it.state_dict()))
        got = _drain(it, on_batch=poke)
        stats = it.stats()
        it.close()
        fresh = epoch_pair(lambda p: _port_iter(uri, layout, snapshot=p), snap)
        fresh.load_state(state["at"])
        tail = _drain(fresh)
        fresh.close()
        return want, got, tail, stats, ref_stats

    want, got, tail, stats, ref_stats = _within_timeout(run)
    assert len(want) == -(-ROWS // BATCH) and got == want and tail == want[3:]
    tune, ref_tune = stats["autotune"], ref_stats["autotune"]
    assert set(tune) == set(ref_tune) and tune["enabled"] is True
    assert set(tune["knobs"]) == set(ref_tune["knobs"])
    assert tune["steps"] >= len(want) // 2 - 1 and tune["knobs"]["convert_ahead"] >= 1
    assert stats["snapshot_state"] == ("warm" if warm else None)


def test_autotune_off_by_default_and_epoch_boundary_steps(tmp_path):
    uri = _corpus(tmp_path, n=300)
    it = _port_iter(uri, "dense")
    assert it.autotuner is None and it.stats()["autotune"] is None
    it.close()
    it = _port_iter(uri, "dense", autotune=True)
    for _ in range(3):
        _drain(it)
        it.reset()
    snap = it.stats()["autotune"]
    it.close()
    # the first boundary takes the mark; the next two step
    assert snap["steps"] == 2 and set(snap["knobs"]) == {"prefetch", "convert_ahead",
                                                         "parse_workers"}


def test_parse_knob_seeds_from_the_cold_cache_hint(tmp_path):
    uri = _corpus(tmp_path, n=300)
    for make, width in ((lambda: create_parser(uri, parse_workers=5, chunk_bytes=CHUNK,
                                               block_cache=str(tmp_path / "bc")), 5),
                        (lambda: create_parser(uri, parse_workers=3, chunk_bytes=CHUNK), 3)):
        it = DeviceIter(make(), num_col=NUM_COL, batch_size=BATCH, device="cpu",
                        autotune=True)
        assert it._knob_parse_workers == width
        if width == 5:
            assert it.source.parse_workers_hint == 5
            assert "plan_read_workers" in it.autotuner.knobs
        it.close()


def test_resilience_sensor_is_monotonic_across_reset(tmp_path):
    uri = _corpus(tmp_path, n=300)
    it = _port_iter(uri, "dense", autotune=True)
    _drain(it)
    it.pipeline_restarts = 2
    it._faults_lifetime += 2
    m1 = it._autotune_mark_now()
    it.reset()
    assert it.pipeline_restarts == 0 and it._autotune_mark_now()["res"] >= m1["res"]
    it.close()


# ---------------- the staging ring ----------------

@pytest.mark.parametrize("knob", ["convert_ahead", "prefetch"])
def test_ring_shrink_then_grow_with_workers_parked(tmp_path, knob):
    uri = _corpus(tmp_path)
    full_it = _port_iter(uri, "ell")
    full = _drain(full_it)
    full_it.close()
    it = _port_iter(uri, "ell", convert_workers=4, convert_ahead=4, prefetch=1)
    ring = it._ring_for(it._cold_spec(), it._convert_ahead, it.convert_workers)
    depth0 = ring.stats()["depth"]
    held = [ring.acquire() for _ in range(depth0)]
    it._host_iter()  # the pool starts: its workers park on the full ring

    def parked():
        for _ in range(2000):
            if ring.stats()["misses"] >= 4:
                return True
            threading.Event().wait(0.005)
        return False
    assert _within_timeout(parked)
    apply = it._apply_convert_ahead if knob == "convert_ahead" else it._apply_prefetch
    assert apply(1)  # a shrink stops new slots and frees none
    assert ring.stats()["depth"] == depth0
    assert apply(6)  # a grow: the parked workers make the new slots

    def grown():
        for _ in range(2000):
            if ring.stats()["depth"] > depth0:
                return True
            threading.Event().wait(0.005)
        return False
    assert _within_timeout(grown)
    for slot in held:
        ring.release(slot, None)
    got = _within_timeout(lambda: _drain(it))
    stats = it.stats()["staging_ring"]
    it.close()
    assert got == full and depth0 < stats["depth"] <= depth0 + 5


def test_ring_set_depth_wakes_a_waiter_that_makes_its_slot():
    from dmlc_tpu_torch.data.device import _Slot, _StagingRing

    import torch

    made = []

    def make():
        made.append(1)
        return _Slot([torch.empty(4)])

    ring = _StagingRing([], make=make)
    ring.grow(1)
    first = ring.acquire()
    got = []
    t = threading.Thread(target=lambda: got.append(ring.acquire()), daemon=True)
    t.start()
    for _ in range(500):
        if ring.stats()["misses"] == 1:
            break
        threading.Event().wait(0.005)
    assert ring.stats() == {"depth": 1, "hits": 1, "misses": 1}
    ring.set_depth(2)
    t.join(JOIN_TIMEOUT)
    assert not t.is_alive() and got[0] is not None and got[0] is not first
    assert len(made) == 2 and ring.stats()["depth"] == 2
    ring.set_depth(1)  # a smaller depth frees nothing
    ring.release(first, None)
    ring.release(got[0], None)
    assert ring.stats()["depth"] == 2 and ring.acquire() is not None


class _SlowBlocks(Parser):
    """Blocks of 64 rows after a 4 ms wait each: a supply-bound source."""

    def __init__(self, n=48):
        self.n, self.i = n, 0
        rng = np.random.default_rng(3)
        self.block = _block(rng)

    def before_first(self):
        self.i = 0

    def next_block(self):
        if self.i >= self.n:
            return None
        self.i += 1
        threading.Event().wait(0.004)
        return self.block

    def close(self):
        pass


def _block(rng):
    from dmlc_tpu_torch.data.row_block import RowBlock

    idx = np.tile(np.arange(NUM_COL, dtype=np.uint64), BATCH)
    return RowBlock(offset=np.arange(0, BATCH * NUM_COL + 1, NUM_COL, dtype=np.int64),
                    label=(rng.random(BATCH) < 0.5).astype(np.float32), index=idx,
                    value=rng.normal(size=BATCH * NUM_COL).astype(np.float32))


def test_refill_wait_reaches_the_tuner():
    """In a supply-bound epoch the consumer waits in the refill behind the
    batch it hands out: that wait is input wait, so the tuner sees the
    pipeline input-bound and climbs (a sensor blind to it reads steady)."""
    it = DeviceIter(_SlowBlocks(), num_col=NUM_COL, batch_size=BATCH, device="cpu",
                    autotune=True, autotune_interval=4, **LAYOUTS["ell"])
    _within_timeout(lambda: _drain(it))
    stats = it.stats()
    it.close()
    assert stats["input_wait_seconds"] >= 0.8 * stats["host_stall_seconds"] > 0.1
    actions = {h["action"] for h in stats["autotune"]["history"]}
    assert "grow" in actions and "steady" not in actions


def _stall_run(threaded_mod, tel, kind):
    """A producer that blocks until released, read under a 0.2 s stall
    timeout: the error and the published diagnostic."""
    gate = threading.Event()

    def blocked(x):
        gate.wait(JOIN_TIMEOUT)
        return x

    label = tel.new_pipeline_label("stall-test")
    with tel.scope(label):
        if kind == "pool":
            it = threaded_mod.OrderedWorkerPool(lambda: iter(range(4)), blocked, num_workers=2,
                                                max_ahead=2, counter_label="convert")
        else:
            it = threaded_mod.ThreadedIter.from_factory(lambda: map(blocked, range(4)))
        try:
            it.next()
            error = None
        except Exception as exc:  # noqa: BLE001 - compared below
            error = (type(exc).__name__, "pipeline stalled" in str(exc))
        finally:
            gate.set()
            it.destroy()
        rows = tel.REGISTRY.snapshot(tel.STALL_METRIC, pipeline=label)
    diag = rows[0]["value"] if rows else None
    return error, {k: v for k, v in (diag or {}).items()}


@pytest.mark.parametrize("kind", ["pool", "threaded"])
def test_stall_diagnostic_matches_reference(kind, monkeypatch):
    monkeypatch.setenv("DMLC_PIPELINE_STALL_TIMEOUT", "0.2")
    got = _within_timeout(lambda: _stall_run(threaded_iter, telemetry, kind))
    want = _within_timeout(lambda: _stall_run(jax_threaded, jax_telemetry, kind))
    assert got[0] == want[0] == ("DMLCError", True)
    assert set(got[1]) == set(want[1]) and got[1]["component"] == want[1]["component"]
    assert got[1]["restart_budget"] == want[1]["restart_budget"]
