"""The port's ``dmlc_tpu.*`` profiler ranges and the counters beside them.

The ranges open whenever a torch profiler is recording, whatever
``DMLC_TPU_TRACE`` holds, and cost one flag read otherwise: the learner's
step (``dmlc_tpu.step`` tiled by ``.forward``, ``.backward`` and
``.optimizer``), the consumer's wait on the pipeline
(``dmlc_tpu.input_wait``) and the copies. The convert pool's thread CPU
seconds (``convert_cpu_seconds``) and the fused reader's parse busy time
(``parallel_stats()["parse_busy_seconds"]``) are checked against the
seconds they split. Everything runs on the CPU, the port alone."""

import inspect
import json
import threading

import numpy as np
import pytest
import torch

from dmlc_tpu_torch import native
from dmlc_tpu_torch.data import DeviceIter, create_parser
from dmlc_tpu_torch.data.native_parser import NativeFeedParser, NativeStreamParser
from dmlc_tpu_torch.io import filesystem as fs_mod
from dmlc_tpu_torch.io import snapshot
from dmlc_tpu_torch.models import FMLearner
from dmlc_tpu_torch.utils import telemetry
from dmlc_tpu_torch.utils.check import DMLCError

NUM_COL = 8
STEP_RANGES = ["dmlc_tpu.step", "dmlc_tpu.step.forward", "dmlc_tpu.step.backward",
               "dmlc_tpu.step.optimizer"]


def _corpus(tmp_path, n=640, name="c.libsvm"):
    rng = np.random.default_rng(3)
    lines = []
    for i in range(n):
        cols = np.sort(rng.choice(NUM_COL, size=rng.integers(2, NUM_COL), replace=False))
        lines.append(f"{i % 2} " + " ".join(f"{j}:{rng.normal():.5f}" for j in cols))
    path = tmp_path / name
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _iter(path, layout="ell", num_col=NUM_COL, **kw):
    kw = dict(dict(batch_size=32, drop_remainder=True, device="cpu"), **kw)
    if layout == "ell":
        kw["max_nnz"] = NUM_COL
    return DeviceIter(create_parser(path, 0, 1, "libsvm", chunk_bytes=4096), num_col=num_col,
                      layout=layout, **kw)


def _model(layout="ell"):
    return FMLearner(NUM_COL, num_factors=4, layout=layout, learning_rate=0.05, seed=5,
                     device="cpu")


def _profile(**kw):
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU], **kw)


def _main_thread_ranges(prof, tmp_path):
    """The ``dmlc_tpu.*`` ranges of the calling thread, ``(ts, end,
    name)`` in start order, from the profiler's Chrome export."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    tid = threading.get_native_id()
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("name", "").startswith("dmlc_tpu.")
                  and e.get("tid") == tid)


# ---------------- one gate: the profiler's own state ----------------

def test_the_jax_switches_default_to_the_profiler():
    """``enabled`` and ``annotate`` are kept for the JAX package's
    signatures; left at their defaults the ranges follow the profiler."""
    assert inspect.signature(telemetry.profiler_annotation).parameters["enabled"].default
    assert inspect.signature(snapshot.SnapshotIter).parameters["annotate"].default is True
    with _profile():
        assert isinstance(telemetry.profiler_annotation("dmlc_tpu.x"),
                          torch.profiler.record_function)
        assert telemetry.profiler_annotation("dmlc_tpu.x", False) is \
            telemetry.profiler_annotation("dmlc_tpu.y", enabled=False)


def test_no_reader_keeps_a_trace_flag(tmp_path, monkeypatch):
    monkeypatch.setenv("DMLC_TPU_TRACE", "1")
    path = _corpus(tmp_path)
    parser = create_parser(path, 0, 1, "libsvm", threaded=False,
                           block_cache=str(tmp_path / "a.blockcache"), chunk_bytes=4096)
    it = DeviceIter(parser, num_col=NUM_COL, batch_size=32, device="cpu")
    assert not hasattr(it, "_trace") and not hasattr(parser, "_annotate")
    it.close()


@pytest.mark.parametrize("all_threads", [False, True])
def test_the_range_follows_the_profiler(all_threads):
    off = telemetry.profiler_annotation("dmlc_tpu.x")
    assert off is telemetry.profiler_annotation("dmlc_tpu.y")  # one shared no-op
    kw = ({"experimental_config": torch._C._profiler._ExperimentalConfig(
        profile_all_threads=True)} if all_threads else {})
    seen = {}

    def on_a_thread():
        seen["thread"] = type(telemetry.profiler_annotation("dmlc_tpu.t"))

    with _profile(**kw):
        seen["main"] = type(telemetry.profiler_annotation("dmlc_tpu.m"))
        t = threading.Thread(target=on_a_thread)
        t.start()
        t.join()
    assert seen == {"main": torch.profiler.record_function,
                    "thread": torch.profiler.record_function}
    assert telemetry.profiler_annotation("dmlc_tpu.z") is off


def test_nothing_opens_without_a_profiler(tmp_path, monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counted(*a, **k):
        calls.append(a)
        return real(*a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    model, it = _model(), _iter(_corpus(tmp_path), convert_workers=2, transfer_sample=1)
    model.fit_epoch(it)
    it.close()
    assert calls == []
    it = _iter(_corpus(tmp_path, name="d.libsvm"))
    batch = next(it)
    it.close()
    with _profile():
        model.step(batch)
    assert [a[0] for a in calls] == STEP_RANGES


# ---------------- the step on the timeline ----------------

@pytest.mark.parametrize("layout", ["ell", "dense"])
def test_the_step_is_tiled_by_three_ranges_in_order(tmp_path, layout):
    model = _model(layout)
    it = _iter(_corpus(tmp_path), layout=layout, num_col=model.device_num_col())
    batches = [next(it) for _ in range(2)]
    it.close()
    with _profile() as prof:
        for batch in batches:
            model.step(batch)
    ranges = _main_thread_ranges(prof, tmp_path)
    assert [n for _, _, n in ranges] == STEP_RANGES * 2
    for k in (0, 4):
        (s0, s1, _), *children = ranges[k: k + 4]
        assert all(s0 <= a <= b <= s1 for a, b, _ in children)
        assert all(children[i][1] <= children[i + 1][0] for i in range(2))


@pytest.mark.parametrize("l2", [0.0, 0.01])
def test_the_ranges_change_no_bit(tmp_path, l2):
    it = _iter(_corpus(tmp_path))
    batches = [next(it) for _ in range(4)]
    it.close()
    sides = []
    for traced in (False, True):
        model = FMLearner(NUM_COL, num_factors=4, layout="ell", learning_rate=0.05, seed=5,
                          l2=l2, device="cpu")
        if traced:
            with _profile():
                losses = [model.step(b) for b in batches]
        else:
            losses = [model.step(b) for b in batches]
        sides.append((losses, [p.detach().clone() for p in model.params]))
    for a, b in zip(sides[0][0] + sides[0][1], sides[1][0] + sides[1][1]):
        assert torch.equal(a, b)


# ---------------- the input wait on the timeline ----------------

def test_the_consumer_ranges_show_without_the_env(tmp_path, monkeypatch):
    monkeypatch.delenv("DMLC_TPU_TRACE", raising=False)
    it = _iter(_corpus(tmp_path), convert_workers=2, transfer_sample=1)
    with _profile() as prof:
        n = sum(1 for _ in it)
    it.close()
    names = [name for _, _, name in _main_thread_ranges(prof, tmp_path)]
    assert names.count("dmlc_tpu.dispatch") == n
    # the refill pulls each batch, and again for the end of the epoch
    assert names.count("dmlc_tpu.input_wait") > n
    # the sampled landings wait on a copy event, which the CPU has none of
    assert set(names) == {"dmlc_tpu.dispatch", "dmlc_tpu.input_wait"}


# ---------------- the convert pool's off-CPU time ----------------

@pytest.mark.parametrize("layout,workers", [("ell", 1), ("ell", 3), ("dense", 2),
                                            ("bcoo", 2)])
def test_convert_cpu_seconds_lie_within_the_convert_seconds(tmp_path, layout, workers):
    it = _iter(_corpus(tmp_path, n=2000), layout=layout, convert_workers=workers)
    for _ in range(2):
        for _ in it:
            pass
        it.reset()
    s = it.stats()
    it.close()
    assert 0.0 < s["convert_cpu_seconds"] <= s["convert_seconds"]


def test_a_warm_epoch_adds_no_convert_cpu(tmp_path):
    it = _iter(_corpus(tmp_path), snapshot=str(tmp_path / "s.snapshot"))
    for _ in it:
        pass
    cold = it.stats()["convert_cpu_seconds"]
    it.reset()
    for _ in it:
        pass
    s = it.stats()
    it.close()
    assert s["snapshot_state"] == "warm"
    assert s["convert_cpu_seconds"] == cold > 0.0


# ---------------- the native parse's busy time ----------------

needs_native = pytest.mark.skipif(not native.available(), reason="native library not built")


@needs_native
def test_parse_busy_seconds_count_across_epochs_and_partitions(tmp_path):
    path = _corpus(tmp_path, n=4000)
    p = NativeStreamParser(path, {}, 0, 2, "libsvm", chunk_bytes=4096)
    assert p.parallel_stats()["parse_busy_seconds"] == 0.0
    seen = []
    for step in ("first", "before_first", "reset_partition"):
        if step == "before_first":
            p.before_first()
        elif step == "reset_partition":
            p.reset_partition(1, 2)
        while p.next_block() is not None:
            pass
        seen.append(p.parallel_stats())
    p.close()
    busy = [s["parse_busy_seconds"] for s in seen]
    assert 0.0 < busy[0] < busy[1] < busy[2]
    assert all(s["parse_span_seconds"] is None and s["parse_parallelism_efficiency"] is None
               for s in seen)


@needs_native
def test_the_reader_counts_its_parse_across_before_first(tmp_path):
    path = _corpus(tmp_path, n=4000)
    reader = native.Reader([path], [len(open(path, "rb").read())], 0, 1, native.FMT_LIBSVM,
                           chunk_bytes=4096)
    busy = []
    for _ in range(2):
        while reader.next() is not None:
            pass
        busy.append(reader.parse_busy_seconds)
        reader.before_first()
    reader.close()
    assert 0.0 < busy[0] < busy[1]
    assert reader.parse_busy_seconds == 0.0


@needs_native
def test_the_feeder_counts_its_parse(tmp_path):
    data = open(_corpus(tmp_path, n=2000), "rb").read()
    feeder = native.Feeder(native.FMT_LIBSVM, chunk_bytes=4096)
    feeder.push(data)
    feeder.finish()
    while feeder.next() is not None:
        pass
    busy = feeder.parse_busy_seconds
    feeder.close()
    assert busy > 0.0 and feeder.parse_busy_seconds == 0.0


@pytest.fixture
def mem_corpus(tmp_path):
    fs_mod.MemoryFileSystem.reset()
    fs_mod.MemoryFileSystem.instance().store["b/c.libsvm"] = open(
        _corpus(tmp_path, n=4000), "rb").read()
    yield "mem://b/c.libsvm"
    fs_mod.MemoryFileSystem.reset()


@needs_native
def test_a_feeder_rebuilt_after_a_fault_counts_on(mem_corpus, monkeypatch):
    """A feed that fails mid-stream makes ``before_first`` build a new
    feeder (a pipeline restart): the busy time parsed before the fault is
    kept, so the count never falls."""
    monkeypatch.setattr(NativeFeedParser, "FEED_CHUNK", 4096)
    p = create_parser(mem_corpus, 0, 1, "libsvm", chunk_bytes=4096)
    assert isinstance(p, NativeFeedParser)
    make, feeds = p._make_split, []

    def failing_first_feed():
        split = make()
        feeds.append(split)
        if len(feeds) == 1:
            read, calls = split._read, [0]

            def read_until_the_fault(size):
                calls[0] += 1
                if calls[0] > 8:
                    raise OSError("connection reset by peer")
                return read(size)

            split._read = read_until_the_fault
        return split

    p._make_split = failing_first_feed
    with pytest.raises(DMLCError, match="feed failed"):
        while p.next_block() is not None:
            pass
    before = p.parallel_stats()["parse_busy_seconds"]
    p.before_first()
    assert p.parallel_stats()["parse_busy_seconds"] >= before > 0.0
    while p.next_block() is not None:
        pass
    after = p.parallel_stats()["parse_busy_seconds"]
    p.close()
    assert len(feeds) == 2 and after > before
    assert p.parallel_stats()["parse_busy_seconds"] == after


@needs_native
def test_a_reader_rebuilt_after_close_counts_on(tmp_path):
    p = NativeStreamParser(_corpus(tmp_path, n=4000), {}, 0, 1, "libsvm", chunk_bytes=4096)
    busy = []
    for _ in range(2):
        while p.next_block() is not None:
            pass
        p.close()
        busy.append(p.parallel_stats()["parse_busy_seconds"])
    assert 0.0 < busy[0] < busy[1]


@needs_native
def test_deviceiter_reports_the_native_parse_busy_time(tmp_path):
    path = _corpus(tmp_path, n=2000)
    it = DeviceIter(create_parser(path + "?format=libsvm"), num_col=NUM_COL, batch_size=32,
                    layout="ell", max_nnz=NUM_COL, device="cpu")
    for _ in it:
        pass
    pp = it.stats()["parse_parallel"]
    it.close()
    assert pp["engine"] == "native" and pp["parse_busy_seconds"] > 0.0
