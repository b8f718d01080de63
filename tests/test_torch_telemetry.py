"""The port's telemetry (``utils/telemetry.py``, ``utils/timer.py``'s
``StageMeter``, the scoped resilience counters) and ``DeviceIter``'s stage
attribution, against the JAX package's.

Checked on the CPU: the registry's metric kinds and reads give what the
JAX registry gives for the same calls; ``StageMeter`` is registry-backed;
scopes restore, pass to ``scoped_target`` threads and to the threads of
``ThreadedIter`` and ``OrderedWorkerPool`` (captured at construction,
adopted at the first scoped pull or by ``adopt_scope``), and stamp the
resilience events; span rings are bounded and keep their counts; the
Chrome export has the JAX export's structure, and a ``DeviceIter`` run
exports the same stage event names as the JAX run of the same pipeline,
with every stage ``stats()["stages"]`` reports above 0, per-stage span sums
within 10% of the busy seconds, and the stage sum at most
``wall_seconds``; ``DMLC_TPU_TRACE=1`` shows the profiler ranges; two
concurrent iterators keep disjoint counters, under a flipped byte and
under the JAX test's ``cache_read~a.blockcache@1=corrupt`` plan (as the
JAX package's do). The rest of the module
equals the JAX package's for the same inputs: the Prometheus text (and its
parse, malformed lines refused), the decision log (trace id, extras, the
bounded ring, the counts), the metrics history ring, the retirement of old
pipeline scopes under ``DMLC_TPU_METRICS_MAX_PIPELINES``, the trace
context and its wire form under each ``DMLC_TPU_TRACE_CONTEXT`` setting,
``pod_snapshot`` / ``format_pod_table`` (the ``store`` block reading 0),
``component_snapshot`` and ``export_pod_trace``.
"""

import functools
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from dmlc_tpu.data import create_parser as jax_create_parser
from dmlc_tpu.data.device import DeviceIter as JaxDeviceIter
from dmlc_tpu.io import faults as jax_faults
from dmlc_tpu.io import resilience as jax_resilience
from dmlc_tpu.store import manager as jax_store
from dmlc_tpu.utils import telemetry as jax_telemetry
from dmlc_tpu.utils.timer import StageMeter as JaxStageMeter
from dmlc_tpu_torch.data import DeviceIter, create_parser
from dmlc_tpu_torch.data.device import _adopt_pipeline_scope
from dmlc_tpu_torch.data.parsers import Parser
from dmlc_tpu_torch.data.row_block import RowBlock
from dmlc_tpu_torch.io import block_cache as bc
from dmlc_tpu_torch.io import faults as port_faults
from dmlc_tpu_torch.io import resilience
from dmlc_tpu_torch.io.threaded_iter import OrderedWorkerPool, ThreadedIter
from dmlc_tpu_torch.store import manager as port_store
from dmlc_tpu_torch.utils import telemetry
from dmlc_tpu_torch.utils.timer import StageMeter, format_stage_table

NUM_COL = 6


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    monkeypatch.setenv("DMLC_TPU_NO_NATIVE_READER", "1")
    monkeypatch.delenv("DMLC_TPU_TRACE", raising=False)
    yield
    telemetry.set_scope(None)
    jax_telemetry.set_scope(None)


def _corpus(tmp_path, name="c.libsvm", n=300, seed=0):
    rng = np.random.default_rng(seed)
    lines = [f"{i % 2} " + " ".join(f"{j}:{rng.normal():.5f}" for j in range(NUM_COL))
             for i in range(n)]
    path = tmp_path / name
    path.write_text("\n".join(lines) + "\n")
    return str(path)


# ---------------- the registry ----------------

def _exercise(mod):
    reg = mod.MetricsRegistry()
    reg.counter("c", pipeline="a", stage="x").inc(1.5)
    reg.counter("c", pipeline="a", stage="y").inc(2.0)
    reg.counter("c", pipeline="b", stage="x").inc(4.0)
    reg.gauge("g", pipeline="a").set(7)
    h = reg.histogram("h")
    for v in (3.0, 1.0, 2.0):
        h.observe(v)
    reg.info("i", component="pool").set({"k": 1})
    out = {"rows": sorted(json.dumps(r, sort_keys=True) for r in reg.snapshot()),
           "sum": reg.sum("c"), "sum_a": reg.sum("c", pipeline="a"),
           "by": reg.sum_by("c", "pipeline"), "by_x": reg.sum_by("c", "pipeline", stage="x"),
           "same_handle": reg.counter("c", stage="x", pipeline="a") is reg.counter(
               "c", pipeline="a", stage="x")}
    reg.clear("c")
    out["after_clear"] = sorted(r["name"] for r in reg.snapshot())
    return out


def test_registry_reads_as_reference():
    assert _exercise(telemetry) == _exercise(jax_telemetry)


def test_registry_concurrent_increments_are_exact():
    c = telemetry.REGISTRY.counter("test_concurrent", pipeline=telemetry.new_pipeline_label())

    def bump():
        for _ in range(2000):
            c.inc(1.0)

    threads = [threading.Thread(target=bump) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value == 16000.0


def test_stage_meter_is_registry_backed():
    for mod, cls in ((telemetry, StageMeter), (jax_telemetry, JaxStageMeter)):
        label = mod.new_pipeline_label("meter-test")
        m = cls("read", "convert", metric=mod.STAGE_BUSY_METRIC, scope=label)
        m.add("read", 0.25)
        m.add("convert", 1.0)
        m.add("late", 0.5)  # a stage named on the fly
        assert m.seconds() == {"read": 0.25, "convert": 1.0, "late": 0.5}
        assert mod.REGISTRY.counter(mod.STAGE_BUSY_METRIC, stage="convert",
                                    pipeline=label).value == 1.0
        assert mod.REGISTRY.sum(mod.STAGE_BUSY_METRIC, pipeline=label) == 1.75
        assert m.total() == 1.75
    # meters without a scope never share a counter
    a, b = StageMeter("s"), StageMeter("s")
    a.add("s", 1.0)
    assert b.seconds() == {"s": 0.0} and a.scope != b.scope
    table = format_stage_table({"read": 1.0, "parse": 2.0}, 4.0)
    assert table.splitlines()[-2].split()[:2] == ["other", "1.000"]


# ---------------- scopes ----------------

def test_scope_context_and_scoped_target():
    assert telemetry.current_scope() is None
    with telemetry.scope("outer"):
        with telemetry.scope("inner"):
            assert telemetry.current_scope() == "inner"
        assert telemetry.current_scope() == "outer"
        seen = []
        t = threading.Thread(target=telemetry.scoped_target(
            lambda: seen.append(telemetry.current_scope())))
    t.start()
    t.join()
    assert seen == ["outer"] and telemetry.current_scope() is None


def test_record_event_is_scoped():
    label = telemetry.new_pipeline_label("events")
    base, base_all = resilience.counters_snapshot(label), resilience.counters_snapshot()
    with telemetry.scope(label):
        resilience.record_event("cache_rebuilds", 2)
    resilience.record_event("cache_rebuilds")  # outside any scope
    mine = resilience.counters_delta(base, label)
    assert mine["cache_rebuilds"] == 2 and sum(mine.values()) == 2
    assert resilience.counters_delta(base_all)["cache_rebuilds"] == 3
    assert set(mine) == set(resilience.EVENT_KEYS)


def test_thread_primitives_inherit_and_adopt_scopes():
    seen = {}

    def factory(tag):
        def gen():
            for i in range(3):
                seen.setdefault(tag, set()).add(telemetry.current_scope())
                yield i
        return gen

    with telemetry.scope("creator"):
        ti = ThreadedIter.from_factory(factory("ti"), max_capacity=1)
        pool = OrderedWorkerPool(lambda: iter(range(6)),
                                 lambda x: seen.setdefault("pool", set()).add(
                                     telemetry.current_scope()) or x, num_workers=3)
    assert [ti.next() for _ in range(4)] == [0, 1, 2, None]
    assert [pool.next() for _ in range(7)] == [0, 1, 2, 3, 4, 5, None]
    ti.destroy()
    pool.destroy()
    assert seen["ti"] == {"creator"} and seen["pool"] == {"creator"}
    # built outside any scope: the first scoped pull adopts its scope
    late = ThreadedIter.from_factory(factory("late"), max_capacity=1)
    with telemetry.scope("consumer"):
        assert late.next() == 0
    assert [late.next() for _ in range(3)] == [1, 2, None]
    late.destroy()
    assert "consumer" in seen["late"]
    # adopt_scope: None -> label only
    p = OrderedWorkerPool(lambda: iter(()), lambda x: x)
    p.adopt_scope("a")
    p.adopt_scope("b")
    assert p._scope == "a"
    p.destroy()


def test_device_iter_adopts_its_source_chain():
    class Chain:
        def __init__(self, base=None):
            self.base = base
            self.adopted = []

        def adopt_scope(self, label):
            self.adopted.append(label)

    inner = Chain()
    outer = Chain(base=Chain(base=inner))
    _adopt_pipeline_scope(outer, "p-1")
    assert outer.adopted == outer.base.adopted == inner.adopted == ["p-1"]


# ---------------- spans and the export ----------------

def test_span_ring_bounded_counts_kept(monkeypatch):
    monkeypatch.setenv("DMLC_TPU_TRACE_RING_SPANS", "64")
    # past DMLC_TPU_TRACE_MAX_RINGS rings (a process that ran many
    # pipelines first), the new thread's ring would retire a dead thread's
    # ring and add its spans to spans_dropped inside the measured window:
    # raise the cap so the window holds this ring's drops alone
    monkeypatch.setenv("DMLC_TPU_TRACE_MAX_RINGS", str(1 << 30))

    def run():
        for i in range(200):
            telemetry.record_span("ring_test", float(i), 0.001)

    t = threading.Thread(target=run)
    before, dropped0 = telemetry.span_counts().get("ring_test", 0), telemetry.spans_dropped()
    t.start()
    t.join()
    assert telemetry.span_counts()["ring_test"] - before == 200
    assert telemetry.spans_dropped() - dropped0 == 200 - 64
    mine = [s for s in telemetry.spans_snapshot() if s["name"] == "ring_test"]
    assert len(mine) == 64 and mine[-1]["start_ns"] == int(199 * 1e9)


def test_record_span_carries_scope_and_labels():
    label = telemetry.new_pipeline_label("span")
    with telemetry.scope(label):
        telemetry.record_span("labelled", time.monotonic(), 0.002, rows=5)
        with telemetry.span("timed"):
            pass
    rows = telemetry.spans_snapshot(label)
    assert [r["name"] for r in rows] == ["labelled", "timed"]
    assert rows[0]["labels"] == {"rows": 5} and rows[0]["dur_ns"] == 2_000_000
    jax_rows = []
    with jax_telemetry.scope("jax-span"):
        jax_telemetry.record_span("labelled", time.monotonic(), 0.002, rows=5)
        jax_rows = jax_telemetry.spans_snapshot("jax-span")
    assert set(rows[0]) == set(jax_rows[0])


def _structure(doc) -> dict:
    by_ph = {}
    for e in doc["traceEvents"]:
        by_ph.setdefault(e["ph"], set()).update(e)
    return {"top": sorted(doc), "other": sorted(doc["otherData"]),
            "events": {k: sorted(v) for k, v in by_ph.items()},
            "version": doc["otherData"]["telemetry_schema_version"],
            "unit": doc["displayTimeUnit"]}


def test_chrome_export_has_the_reference_structure(tmp_path):
    docs = []
    for mod in (telemetry, jax_telemetry):
        with mod.scope("export-test"):
            mod.record_span("convert", time.monotonic(), 0.001, rows=3)
        path = str(tmp_path / f"{mod.__name__}.json")
        n = mod.export_chrome_trace(path, pipeline="export-test")
        assert n >= 1 and not os.path.exists(path + ".tmp")
        with open(path) as f:
            docs.append(json.load(f))
    assert _structure(docs[0]) == _structure(docs[1])


# ---------------- DeviceIter: the trace and the attribution ----------------

def _port_cache_iter(path, cache, **kw):
    parser = create_parser(path, 0, 1, "libsvm", threaded=False, block_cache=cache,
                           chunk_bytes=8192)
    return DeviceIter(parser, num_col=NUM_COL, batch_size=256, layout="dense", device="cpu",
                      prefetch=2, convert_ahead=2, transfer_sample=1, **kw)


def _jax_cache_iter(path, cache, **kw):
    parser = jax_create_parser(path + "?engine=python", 0, 1, "libsvm", threaded=False,
                               block_cache=cache, chunk_bytes=8192)
    return JaxDeviceIter(parser, num_col=NUM_COL, batch_size=256, layout="dense",
                         prefetch=2, convert_ahead=2, transfer_sample=1, **kw)


def _close(span_sum, ref, what):
    tol = max(0.10 * max(ref, span_sum), 0.02)
    assert abs(span_sum - ref) <= tol, (what, span_sum, ref)


def _run_two_epochs(it) -> int:
    n = sum(1 for _ in it)
    it.reset()
    return n + sum(1 for _ in it)


@pytest.mark.parametrize("workers", [1, 3])
def test_chrome_trace_covers_the_stages_as_reference(tmp_path, monkeypatch, workers):
    path = _corpus(tmp_path, n=2000)
    names = {}
    for who, make in (("port", _port_cache_iter), ("jax", _jax_cache_iter)):
        trace = str(tmp_path / f"{who}.trace.json")
        monkeypatch.setenv("DMLC_TPU_TRACE", f"chrome:{trace}")
        it = make(path, str(tmp_path / f"{who}.blockcache"), convert_workers=workers)
        batches = _run_two_epochs(it)   # cold: read, parse, cache_write; warm: cache_read
        stats = it.stats()
        it.close()                      # chrome mode: exported on close
        with open(trace) as f:
            doc = json.load(f)
        mine = [e for e in doc["traceEvents"]
                if e.get("ph") == "X" and e["args"].get("pipeline") == stats["pipeline"]]
        names[who] = {e["name"] for e in mine}
        if who != "port":
            continue
        assert stats["cache_state"] == "warm"
        assert {k for k, v in stats["stages"].items() if v > 0} <= names[who]
        assert set(telemetry.STAGES) <= names[who]
        sums = {}
        for e in mine:
            sums[e["name"]] = sums.get(e["name"], 0.0) + e["dur"] / 1e6
        assert sum(1 for e in mine if e["name"] == "dispatch") == batches
        assert sum(1 for e in mine if e["name"] == "transfer") == stats["transfer_samples"]
        busy = stats["stage_busy"]
        for stage in ("read", "cache_read", "convert", "dispatch"):
            _close(sums.get(stage, 0.0), busy[stage], stage)
        _close(sums.get("transfer", 0.0), stats["stages"]["transfer"], "transfer")
        # a pull's parse busy holds the block cache's shadow write
        _close(sums.get("parse", 0.0), max(0.0, busy["parse"] - sums.get("cache_write", 0.0)),
               "parse")
        assert sum(stats["stages"].values()) <= stats["wall_seconds"] * 1.02 + 1e-6
    assert names["port"] == names["jax"]


def test_dump_trace_without_env(tmp_path):
    path = _corpus(tmp_path, n=200)
    parser = create_parser(path, 0, 1, "libsvm", threaded=False, chunk_bytes=4096)
    it = DeviceIter(parser, num_col=NUM_COL, batch_size=64, device="cpu", transfer_sample=0)
    for _ in it:
        pass
    out = str(tmp_path / "direct.json")
    n = it.dump_trace(out)
    it.close()
    assert n > 0
    with open(out) as f:
        doc = json.load(f)
    assert {"read", "parse", "convert", "dispatch"} <= {
        e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}


def test_annotate_mode_shows_profiler_ranges(tmp_path, monkeypatch):
    monkeypatch.setenv("DMLC_TPU_TRACE", "1")
    path = _corpus(tmp_path, n=200)
    cache = str(tmp_path / "a.blockcache")
    it = DeviceIter(create_parser(path, 0, 1, "libsvm", threaded=False, block_cache=cache,
                                  chunk_bytes=4096),
                    num_col=NUM_COL, batch_size=64, device="cpu", transfer_sample=1)
    for _ in it:  # the cold epoch writes the cache
        pass
    it.reset()
    # torch's profiler keeps to its own thread unless told to take all:
    # the convert and cache_read ranges open on the pipeline's threads
    cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                experimental_config=cfg) as prof:
        for _ in it:
            pass
    it.close()
    keys = {e.key for e in prof.key_averages()}
    assert {"dmlc_tpu.convert", "dmlc_tpu.dispatch", "dmlc_tpu.cache_read"} <= keys, keys


@pytest.mark.parametrize("layout,kw", [
    ("dense", {}), ("ell", {"max_nnz": NUM_COL}), ("bcoo", {}),
    ("ell", {"max_nnz": NUM_COL, "snapshot": True}),
])
def test_stage_sum_at_most_wall(tmp_path, layout, kw):
    path = _corpus(tmp_path, n=800)
    if kw.pop("snapshot", False):
        kw["snapshot"] = str(tmp_path / "s.snapshot")
    it = DeviceIter(create_parser(path, 0, 1, "libsvm", chunk_bytes=4096), num_col=NUM_COL,
                    batch_size=64, layout=layout, device="cpu", convert_workers=3,
                    transfer_sample=2, **kw)
    n = _run_two_epochs(it)
    s = it.stats()
    it.close()
    assert n == 2 * 13
    assert set(s["stages"]) == {"read", "cache_read", "snapshot_read", "parse", "convert",
                                "dispatch", "device_decode", "transfer"}
    assert all(v >= 0.0 for v in s["stages"].values())
    assert s["wall_seconds"] > 0.0
    assert sum(s["stages"].values()) <= s["wall_seconds"] * 1.02 + 1e-6
    assert s["transfer_samples"] == 2 * (13 // 2)  # counted an epoch from its start
    assert s["stage_busy"]["dispatch"] > 0.0
    assert s["stage_busy"]["snapshot_read" if "snapshot" in kw else "convert"] > 0.0
    # the busy meters are the registry's books
    for stage, v in s["stage_busy"].items():
        assert telemetry.REGISTRY.counter(telemetry.STAGE_BUSY_METRIC, stage=stage,
                                          pipeline=s["pipeline"]).value == v


class _SlowSource(Parser):
    """A few blocks with a delay before each: a supply-bound pipeline."""

    def __init__(self):
        self.i = 0

    def before_first(self):
        self.i = 0

    def next_block(self):
        if self.i >= 4:
            return None
        self.i += 1
        time.sleep(0.05)
        rng = np.random.default_rng(self.i)
        return RowBlock(offset=np.arange(0, 33, 4, dtype=np.int64),
                        label=np.zeros(8, np.float32),
                        index=np.tile(np.arange(4, dtype=np.uint64), 8),
                        value=rng.normal(size=32).astype(np.float32))


def test_attribution_names_the_supply_cost():
    it = DeviceIter(_SlowSource(), num_col=4, batch_size=8, device="cpu", convert_workers=2)
    assert sum(1 for _ in it) == 4
    s = it.stats()
    it.close()
    # about 0.2 s of supply wait: the parse stage owns most of the wall
    assert s["stages"]["parse"] >= 0.5 * s["wall_seconds"], s
    assert s["host_stall_seconds"] > 0.1 and s["input_wait_seconds"] > 0.1


# ---------------- two pipelines, disjoint books ----------------

def _flip(cache: str, block: int) -> None:
    r = bc.BlockCacheReader(cache)
    pos = int(r._blocks[block]["pos"]) + 8
    r.close()
    with open(cache, "r+b") as f:
        f.seek(pos)
        byte = f.read(1)
        f.seek(pos)
        f.write(bytes([byte[0] ^ 0x55]))


def test_two_concurrent_iterators_keep_disjoint_counters(tmp_path):
    its = {}
    for name, seed in (("a", 0), ("b", 1)):
        parser = create_parser(_corpus(tmp_path, f"{name}.libsvm", seed=seed), 0, 1, "libsvm",
                               threaded=False, block_cache=str(tmp_path / f"{name}.blockcache"),
                               chunk_bytes=4096)
        its[name] = DeviceIter(parser, num_col=NUM_COL, batch_size=128, device="cpu",
                               convert_workers=2, transfer_sample=0)
    try:
        for it in its.values():  # cold: publish both caches
            for _ in it:
                pass
            it.reset()
        _flip(str(tmp_path / "a.blockcache"), 1)
        base = resilience.counters_snapshot()
        errors = []

        def drain(it):
            try:
                for _ in it:
                    pass
            except BaseException as exc:  # noqa: BLE001 - re-raised below
                errors.append(exc)

        threads = [threading.Thread(target=drain, args=(it,)) for it in its.values()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors
        res_a, res_b = its["a"].stats()["resilience"], its["b"].stats()["resilience"]
        assert res_a["cache_corruptions"] == 1 and res_a["cache_rebuilds"] == 1
        assert all(v == 0 for v in res_b.values()), res_b
        assert resilience.counters_delta(base)["cache_corruptions"] == 1
        busy_a, busy_b = its["a"].stats()["stage_busy"], its["b"].stats()["stage_busy"]
        label_a, label_b = its["a"].pipeline_label, its["b"].pipeline_label
        assert label_a != label_b
        for label, busy in ((label_a, busy_a), (label_b, busy_b)):
            assert telemetry.REGISTRY.sum(telemetry.STAGE_BUSY_METRIC,
                                          pipeline=label) == pytest.approx(sum(busy.values()))
    finally:
        for it in its.values():
            it.close()


def test_two_concurrent_iterators_keep_disjoint_counters_under_a_fault_plan(tmp_path):
    """``tests/test_telemetry.py``'s case in both packages: warm epochs of
    two pipelines interleaved on one thread while
    ``cache_read~a.blockcache@1=corrupt`` targets pipeline A's cache
    only. A's ``stats()["resilience"]`` holds the corruption and the
    rebuild, B's holds nothing, the process-wide counters hold both
    pipelines; the two packages' books equal."""
    out = {}
    for pkg, make_parser, make_iter, faults, res in (
            ("jax", jax_create_parser, JaxDeviceIter, jax_faults, jax_resilience),
            ("port", create_parser, functools.partial(DeviceIter, device="cpu"), port_faults,
             resilience)):
        d = tmp_path / pkg
        d.mkdir()
        its = {}
        for name, seed in (("a", 0), ("b", 1)):
            parser = make_parser(_corpus(d, f"corpus_{name}.libsvm", seed=seed), 0, 1,
                                 "libsvm", threaded=False,
                                 block_cache=str(d / f"{name}.blockcache"), chunk_bytes=4096)
            its[name] = make_iter(parser, num_col=NUM_COL, batch_size=128, layout="dense",
                                  convert_workers=1, transfer_sample=0)
        try:
            for it in its.values():  # cold: publish both caches
                for _ in it:
                    pass
            for it in its.values():
                it.reset()
            base = res.counters_snapshot()
            with faults.inject("cache_read~a.blockcache@1=corrupt") as plan:
                done = {"a": False, "b": False}
                while not all(done.values()):
                    for name, it in its.items():
                        if not done[name]:
                            try:
                                next(it)
                            except StopIteration:
                                done[name] = True
            res_a, res_b = its["a"].stats()["resilience"], its["b"].stats()["resilience"]
            assert res_a["cache_corruptions"] == 1 and res_a["cache_rebuilds"] == 1
            assert res_b["cache_corruptions"] == 0 and res_b["cache_rebuilds"] == 0
            assert all(v == 0 for v in res_b.values()), res_b
            assert res.counters_delta(base)["cache_corruptions"] == 1
            out[pkg] = (plan.fired(), {k: v for k, v in res_a.items() if v},
                        {k: v for k, v in res_b.items() if v})
        finally:
            for it in its.values():
                it.close()
    assert out["port"] == out["jax"]
    assert out["port"][0] == 1


def test_stats_carries_the_pipeline_label(tmp_path):
    path = _corpus(tmp_path, n=50)
    it = DeviceIter(create_parser(path, 0, 1, "libsvm", threaded=False), num_col=NUM_COL,
                    batch_size=32, device="cpu", pipeline_label="train-input")
    other = DeviceIter(create_parser(path, 0, 1, "libsvm", threaded=False), num_col=NUM_COL,
                       batch_size=32, device="cpu")
    try:
        next(it)
        assert it.stats()["pipeline"] == "train-input"
        assert other.stats()["pipeline"].startswith("pipeline-")
    finally:
        it.close()
        other.close()


# ---------------- the rest of the module: against the reference ----------------

def _fill_registry(mod):
    """The same metrics in a fresh registry of either package."""
    reg = mod.MetricsRegistry()
    reg.counter(mod.STAGE_BUSY_METRIC, pipeline="p-1", stage="parse").inc(1.25)
    reg.counter(mod.RESILIENCE_METRIC, pipeline="p-1", event="cache_rebuilds").inc(2)
    reg.gauge(mod.AUTOTUNE_KNOB_METRIC, pipeline="p-1", knob="prefetch").set(3)
    reg.gauge("odd name-1", label='quote"back\\slash\nline').set(0.1)
    reg.counter(mod.AUTOTUNE_STEP_METRIC, pipeline="").inc(7)
    h = reg.histogram("latency", pipeline="p-2")
    for v in (0.5, 1.5, 1e30):
        h.observe(v)
    reg.histogram("empty")
    reg.info(mod.STALL_METRIC, component="pool").set({"k": 1})
    reg.gauge("inf_gauge").set(float("inf"))
    return reg


def test_prometheus_text_matches_reference_and_round_trips():
    text = telemetry.render_prometheus(_fill_registry(telemetry).snapshot())
    assert text == jax_telemetry.render_prometheus(_fill_registry(jax_telemetry).snapshot())
    samples = telemetry.parse_prometheus_text(text)
    assert samples == jax_telemetry.parse_prometheus_text(text)
    by = {(n, tuple(sorted(lb.items()))): v for n, lb, v in samples}
    assert by[("dmlc_tpu_stage_busy_seconds_total", (("pipeline", "p-1"), ("stage", "parse")))] \
        == 1.25
    assert by[("dmlc_tpu_odd_name_1", (("label", 'quote"back\\slash\nline'),))] == 0.1
    assert by[("dmlc_tpu_autotune_steps_total", ())] == 7
    assert not any(n.startswith("dmlc_tpu_pipeline_stall") for n, _, _ in samples)
    for bad in ("metric{a=1} 2", "metric 1 2 3", 'm{a="x"b="y"} 1', "m notanumber"):
        for mod in (telemetry, jax_telemetry):
            with pytest.raises(ValueError):
                mod.parse_prometheus_text(bad)
    assert telemetry.render_prometheus([]) == jax_telemetry.render_prometheus([]) == ""


def _ledger_run(mod):
    mod.reset_decisions()
    with mod.trace("trace-abc", "span-1"):
        mod.record_decision("autotune", "grow", trigger={"knob": "prefetch", "from": 2},
                            outcome="grew", pipeline="p", step=1, skipped=None)
    mod.record_decision("store", "evict")
    first = [{k: v for k, v in e.items() if k != "ts"} for e in mod.decisions_snapshot()]
    for i in range(mod.DECISION_HISTORY_LIMIT + 3):
        mod.record_decision("autotune", "revert", step=i)
    return (first, len(mod.decisions_snapshot()), mod.decisions_total(),
            mod.decision_counts(),
            [e.get("step") for e in mod.decisions_snapshot("autotune")][-3:])


def test_decision_log_matches_reference():
    got, want = _ledger_run(telemetry), _ledger_run(jax_telemetry)
    assert got == want
    assert got[0][0] == {"component": "autotune", "action": "grow",
                         "trigger": {"knob": "prefetch", "from": 2}, "outcome": "grew",
                         "trace_id": "trace-abc", "pipeline": "p", "step": 1}
    assert got[1] == telemetry.DECISION_HISTORY_LIMIT and got[2] == got[1] + 5


def _history_run(mod, monkeypatch):
    monkeypatch.setenv("DMLC_TPU_METRICS_HISTORY", "3")
    mod.reset_metrics_history()
    mod.reset_decisions()
    for name in (mod.INPUT_WAIT_METRIC, mod.SERVICE_JOB_WAIT_METRIC, mod.STORE_BYTES_METRIC,
                 mod.SERVICE_WIRE_RAW_METRIC, mod.SERVICE_WIRE_SENT_METRIC):
        mod.REGISTRY.clear(name)
    mod.REGISTRY.counter(mod.INPUT_WAIT_METRIC, pipeline="h").inc(0.25)
    mod.REGISTRY.counter(mod.SERVICE_JOB_WAIT_METRIC, job="j1").inc(1.5)
    mod.record_decision("autotune", "grow")
    out = [mod.sample_metrics_history(now=float(i)) for i in range(5)]
    return out, mod.metrics_history()


def test_metrics_history_matches_reference(monkeypatch):
    got, want = _history_run(telemetry, monkeypatch), _history_run(jax_telemetry, monkeypatch)
    assert got == want
    assert [s["ts"] for s in got[1]] == [2.0, 3.0, 4.0]
    assert got[0][0]["input_wait_seconds"] == 0.25 and got[0][0]["decisions"] == 1


def _retire_run(mod, monkeypatch):
    monkeypatch.setenv("DMLC_TPU_METRICS_MAX_PIPELINES", "8")
    reg = mod.MetricsRegistry()
    for i in range(12):
        reg.counter("c", pipeline=f"p{i}", stage="x").inc(i + 1)
        reg.gauge("g", pipeline=f"p{i}").set(i)
        reg.histogram("h", pipeline=f"p{i}").observe(float(i))
    reg.counter("c", pipeline="p5", stage="x").inc(100)  # an old handle's scope again
    return (reg.retired_pipelines(), reg.sum("c"), sorted(reg.sum_by("c", "pipeline").items()),
            sorted(json.dumps(r, sort_keys=True) for r in reg.snapshot()))


def test_pipeline_retirement_matches_reference(monkeypatch):
    got = _retire_run(telemetry, monkeypatch)
    assert got == _retire_run(jax_telemetry, monkeypatch)
    assert got[0] >= 4 and got[1] == sum(range(1, 13)) + 100
    assert ("", float(sum(range(1, got[0] + 1)))) in got[2]


@pytest.mark.parametrize("switch", [None, "0", "1"])
def test_trace_context_wire_matches_reference(monkeypatch, switch):
    if switch is None:
        monkeypatch.delenv("DMLC_TPU_TRACE_CONTEXT", raising=False)
    else:
        monkeypatch.setenv("DMLC_TPU_TRACE_CONTEXT", switch)
    out = []
    for mod in (telemetry, jax_telemetry):
        rows = [mod.trace_propagation_enabled(), mod.trace_context_wire(),
                mod.trace_context_wire(("t1", "")), mod.trace_context_wire(("", "s"))]
        with mod.trace("t2", "s2"):
            rows += [mod.current_trace(), mod.trace_context_wire()]
            with mod.trace(None):
                rows.append(mod.current_trace())
        rows.append(mod.current_trace())
        for wire in ({"tid": "a", "sid": "b"}, {"tid": "a", "sid": 3}, {"tid": ""},
                     ["tid"], None, {"sid": "x"}):
            rows.append(mod.trace_context_from_wire(wire))
        mod.set_trace_propagation(True)
        rows.append(mod.trace_context_wire(("t3", "s3")))
        mod.set_trace_propagation(False)
        rows.append(mod.trace_context_wire(("t3", "s3")))
        mod.set_trace_propagation(None)
        assert len(mod.new_trace_id()) == 16 and len(mod.new_span_id()) == 8
        out.append(rows)
    assert out[0] == out[1]


def test_spans_carry_the_trace_context():
    label = telemetry.new_pipeline_label("trace-span")
    with telemetry.scope(label), telemetry.trace("tid-9", "parent-3"):
        telemetry.record_span("convert", time.monotonic(), 0.001)
        telemetry.record_span("dispatch", time.monotonic(), 0.001, span_id="mine")
    telemetry.record_span("transfer", time.monotonic(), 0.001)
    rows = {r["name"]: r for r in telemetry.spans_snapshot(label)}
    assert rows["convert"]["trace_id"] == "tid-9" and rows["convert"]["parent_id"] == "parent-3"
    assert rows["dispatch"]["span_id"] == "mine"
    assert all("trace_id" not in r for r in telemetry.spans_snapshot(None)
               if r["name"] == "transfer" and r["pipeline"] is None)


def _pod(mod):
    reg = mod.REGISTRY
    for name in (mod.STAGE_BUSY_METRIC, mod.STAGE_WALL_METRIC, mod.RESILIENCE_METRIC,
                 mod.SERVICE_JOB_WAIT_METRIC, mod.SERVICE_JOB_PARTS_METRIC,
                 mod.SERVICE_JOB_SLO_METRIC, mod.STORE_BYTES_METRIC):
        reg.clear(name)
    mod.reset_decisions()
    reg.counter(mod.STAGE_BUSY_METRIC, pipeline="pod-a", stage="parse").inc(1.5)
    reg.counter(mod.STAGE_BUSY_METRIC, pipeline="pod-b", stage="convert").inc(0.25)
    reg.counter(mod.STAGE_WALL_METRIC, pipeline="pod-a", stage="transfer").inc(0.5)
    reg.counter(mod.RESILIENCE_METRIC, pipeline="pod-a", event="parse_restarts").inc(1)
    reg.counter(mod.SERVICE_JOB_WAIT_METRIC, job="j1").inc(0.75)
    reg.counter(mod.SERVICE_JOB_PARTS_METRIC, job="j1").inc(3)
    reg.gauge(mod.SERVICE_JOB_SLO_METRIC, job="j1").set(0.05)
    mod.record_decision("autotune", "grow")
    snap = mod.pod_snapshot()
    snap.pop("spans")
    snap.pop("spans_dropped")
    other = dict(snap, stages={"parse": 0.5, "cache_read": 2.0}, decisions={"autotune.revert": 1})
    table = mod.format_pod_table({0: snap, 1: other, 2: {"telemetry_schema_version": 1}})
    return snap, table


def test_pod_snapshot_and_table_match_reference(tmp_path):
    got, want = _pod(telemetry), _pod(jax_telemetry)
    assert got == want
    snap, table = got
    assert snap["store"] == {"store_bytes": 0, "store_evictions": 0,
                             "store_rebuilds_after_eviction": 0}
    assert snap["jobs"] == {"j1": {"input_wait_seconds": 0.75, "parts": 3, "slo_wait_frac": 0.05}}
    assert snap["stages"]["transfer"] == 0.5 and "not merged" in table
    # one published artifact in each package's store: the store block then
    # reads its live bytes, the same in both
    blocks = []
    for mod, store in ((telemetry, port_store), (jax_telemetry, jax_store)):
        d = tmp_path / mod.__name__
        d.mkdir()
        final = str(d / "a.bin")
        st = store.store_for(final)
        tmp = st.stage_path(final)
        with open(tmp, "wb") as f:
            f.write(b"DMLCBC01" + bytes(120))
        st.publish_file(tmp, final, tier="block_cache")
        blocks.append(mod.pod_snapshot()["store"])
        store.reset_stores()
    assert blocks[0] == blocks[1] == {"store_bytes": 128, "store_evictions": 0,
                                      "store_rebuilds_after_eviction": 0}


def test_component_snapshot_and_pod_trace_match_reference(tmp_path):
    docs = []
    for mod in (telemetry, jax_telemetry):
        mod.reset_decisions()
        mod.record_decision("autotune", "grow", step=1)
        comp = mod.component_snapshot("worker-0")
        assert comp["schema"] == mod.SCHEMA_VERSION and comp["peer"] == "worker-0"
        spans = [{"name": "convert", "tid": 7, "thread": "w", "start_ns": 1000,
                  "dur_ns": 500, "pipeline": "p", "labels": {"rows": 2}, "trace_id": "t"}]
        peers = [{"peer": "rank-0", "schema": mod.SCHEMA_VERSION, "clock_offset_s": 0.5,
                  "spans": spans, "decisions": [{"ts": 1.0, "component": "autotune",
                                                  "action": "grow"}]},
                 {"peer": "old", "schema": 1, "spans": spans}]
        path = str(tmp_path / f"{mod.__name__}.pod.json")
        assert mod.export_pod_trace(path, peers) == 1
        with open(path) as f:
            docs.append(json.load(f))
    assert docs[0] == docs[1]
