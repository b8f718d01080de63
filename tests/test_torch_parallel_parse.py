"""The port's parse fan-out (``ParallelTextParser``) over its zero-copy
``MmapLineSplit``, against its one-worker ``ThreadedParser`` and against
dmlc_tpu's ``ParallelTextParser``.

At 1, 2 and 4 workers over libsvm (plain, qid, label:weight,
``indexing_mode=-1``), libfm and csv, on both engines: the blocks and
their resume annotations equal the serial stream's and the JAX package's
(its numpy chain, ``?engine=python``). ``MmapLineSplit``'s partition
bounds equal ``LineSplitter``'s; multi-partition and multi-file chunking;
seek resume from a state of either package; the pending-chunk refusal;
``stage_seconds()`` / ``parallel_stats()`` and ``DeviceIter.stats()``'s
``parse_workers``; the knob; the token table's edges, qid validation and
the csv skeleton cache under concurrent workers. Mirrors
``tests/test_parallel_parse.py``'s ``TestParityAB``,
``TestParallelResume``, ``TestMmapLineSplit``, ``TestTokenTableEdges``,
``TestQidValidation`` and ``TestSkeletonCacheConcurrency``; its HTTP fault
plan and ``restart_policy`` cases wait for those layers.
"""

import json
import sys
import threading

import numpy as np
import pytest

from dmlc_tpu.data.parsers import ParallelTextParser as JaxParallelTextParser
from dmlc_tpu.data.parsers import create_parser as jax_create_parser
from dmlc_tpu.io.input_split import create_input_split
from dmlc_tpu.io.input_split import create_mmap_text_split as jax_mmap_split
from dmlc_tpu.utils import knobs as jax_knobs
from dmlc_tpu.utils.check import DMLCError as JaxDMLCError
from dmlc_tpu_torch.data import (DenseBlock, DeviceIter, LibSVMParser, ParallelTextParser,
                                 ThreadedParser, create_parser)
from dmlc_tpu_torch.data.parsers import (CSVParser, LibFMParser, LibSVMParserParam,
                                         _CSV_SKELETON_CACHE, _csv_skeleton)
from dmlc_tpu_torch.io import LineSplitter, MmapLineSplit, create_mmap_text_split
from dmlc_tpu_torch.utils import knobs
from dmlc_tpu_torch.utils.check import DMLCError


@pytest.fixture(autouse=True)
def _registry_stack(monkeypatch):
    """These cases hold the registry stack of ``create_parser`` (the split,
    the text parsers and their threaded wrappers) against the JAX package's
    Python chain. A plain local file now goes to the fused native reader,
    as in the JAX package, whose own tests reach the registry stack the
    same way; the reader has its own suite (test_torch_native_reader.py)."""
    monkeypatch.setenv("DMLC_TPU_NO_NATIVE_READER", "1")


@pytest.fixture(autouse=True)
def _no_worker_env(monkeypatch):
    monkeypatch.delenv("DMLC_TPU_PARSE_WORKERS", raising=False)


# ---------------- corpora ----------------

def _libsvm_text(n=300, d=6, qid=False, weight=False, seed=0):
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        label = f"{i % 2}:{rng.random():.3f}" if weight else f"{i % 2}"
        q = f" qid:{i // 10}" if qid else ""
        lines.append(f"{label}{q} " + " ".join(f"{j}:{rng.normal():.5f}" for j in range(d)))
    return ("\n".join(lines) + "\n").encode()


def _libfm_text(n=300, d=5, seed=1):
    rng = np.random.default_rng(seed)
    lines = [f"{i % 2} " + " ".join(f"{j % 3}:{j}:{rng.normal():.5f}" for j in range(d))
             for i in range(n)]
    return ("\n".join(lines) + "\n").encode()


def _csv_text(n=300, d=5, seed=2):
    rng = np.random.default_rng(seed)
    lines = [f"{i % 2}," + ",".join(f"{rng.normal():.5f}" for _ in range(d)) for i in range(n)]
    return ("\n".join(lines) + "\n").encode()


def _write(tmp_path, name, data) -> str:
    p = tmp_path / name
    p.write_bytes(data)
    return str(p)


def _js(obj) -> str:
    return json.dumps(obj, sort_keys=True, default=str)


def _stream(parser) -> list:
    """Every block with its annotation and the parser's state after it."""
    out = []
    while (b := parser.next_block()) is not None:
        arrays = {}
        for name in ("x", "offset", "label", "weight", "qid", "field", "index", "value"):
            a = getattr(b, name, None)
            if a is not None:
                a = np.asarray(a)
                arrays[name] = (a.dtype.str, a.shape, a.tobytes())
        out.append((type(b).__name__, arrays, _js(b.resume_state), _js(parser.state_dict())))
    parser.close()
    return out


CASES = [
    ("libsvm", _libsvm_text(), ""),
    ("libsvm", _libsvm_text(qid=True), ""),
    ("libsvm", _libsvm_text(weight=True), ""),
    ("libsvm", _libsvm_text(d=3, seed=7), "&indexing_mode=-1"),
    ("libfm", _libfm_text(), ""),
    ("csv", _csv_text(), "&label_column=0"),
    ("csv", _csv_text(seed=9), "&label_column=0&weight_column=1"),
]


# ---------------- A/B parity ----------------

@pytest.mark.parametrize("engine", ["auto", "python"])
@pytest.mark.parametrize("fmt,data,args", CASES,
                         ids=["libsvm", "qid", "weight", "mode-1", "libfm", "csv", "csv_w"])
def test_streams_equal_at_every_worker_count(tmp_path, fmt, data, args, engine):
    path = _write(tmp_path, f"c.{fmt}", data)
    uri = f"{path}?format={fmt}{args}"

    def port(workers):
        p = create_parser(uri, 0, 1, "auto", threaded=True, parse_workers=workers,
                          chunk_bytes=2048, engine=engine)
        assert isinstance(p, ParallelTextParser if workers > 1 else ThreadedParser)
        return _stream(p)

    # the serial stream over the same mmap split: annotations and all
    cls = {"libsvm": LibSVMParser, "libfm": LibFMParser, "csv": CSVParser}[fmt]
    args_d = dict(kv.split("=", 1) for kv in f"format={fmt}{args}".split("&"))
    mmap_serial = _stream(ThreadedParser(cls(create_mmap_text_split(path, chunk_bytes=2048),
                                             args_d, engine=engine)))
    one = port(1)
    for workers in (2, 4):
        got = port(workers)
        # blocks equal the one-worker stream's; annotations the serial
        # stream's over the same split
        assert [g[:2] for g in got] == [o[:2] for o in one]
        assert got == mmap_serial
        jp = jax_create_parser(f"{path}?format={fmt}&engine=python{args}", 0, 1, "auto",
                               threaded=True, parse_workers=workers, chunk_bytes=2048)
        assert isinstance(jp, JaxParallelTextParser)
        want = _stream(jp)
        if engine == "python":
            assert got == want
        else:  # the native scanner: the same annotations and row count
            assert [g[2:] for g in got] == [w[2:] for w in want]
    jax_one = _stream(jax_create_parser(f"{path}?format={fmt}&engine=python{args}", 0, 1,
                                        "auto", threaded=True, parse_workers=1,
                                        chunk_bytes=2048))
    assert [o[2:] for o in one] == [w[2:] for w in jax_one]


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_dense_emit_parity(tmp_path, workers):
    path = _write(tmp_path, "d.libsvm", _libsvm_text(d=4))
    p = create_parser(path, 0, 1, "libsvm", parse_workers=workers, chunk_bytes=2048)
    assert p.set_emit_dense(4)
    got = _stream(p)
    assert all(g[0] == "DenseBlock" for g in got)
    p = create_parser(path, 0, 1, "libsvm", parse_workers=1, chunk_bytes=2048)
    p.set_emit_dense(4)
    one = _stream(p)
    assert [g[:2] for g in got] == [o[:2] for o in one]


def test_unterminated_tail_chunk_grouping(tmp_path):
    """A last line without '\\n' is its own chunk on both splits, so the
    per-chunk ``indexing_mode=-1`` shift cannot differ between widths."""
    rng = np.random.default_rng(3)
    lines = [f"{i % 2} " + " ".join(f"{j}:{rng.normal():.4f}" for j in range(3))
             for i in range(300)]
    path = _write(tmp_path, "tail.libsvm", ("\n".join(lines) + "\n1 1:9.0").encode())
    uri = path + "?indexing_mode=-1"
    runs = [_stream(create_parser(uri, parse_workers=w, chunk_bytes=2048, engine="python"))
            for w in (1, 4)]
    assert [g[:2] for g in runs[0]] == [g[:2] for g in runs[1]]
    want = _stream(jax_create_parser(path + "?engine=python&indexing_mode=-1", 0, 1,
                                     "libsvm", parse_workers=4, chunk_bytes=2048))
    assert runs[1] == want


def test_multi_partition_parity(tmp_path):
    path = _write(tmp_path, "p.libsvm", _libsvm_text(n=500))
    total = 0
    for part in range(3):
        one = _stream(create_parser(path, part, 3, "libsvm", parse_workers=1,
                                    chunk_bytes=1024))
        four = _stream(create_parser(path, part, 3, "libsvm", parse_workers=4,
                                     chunk_bytes=1024))
        assert [g[:2] for g in one] == [g[:2] for g in four]
        jax4 = _stream(jax_create_parser(path + "?engine=python", part, 3, "libsvm",
                                         parse_workers=4, chunk_bytes=1024))
        assert [g[2:] for g in four] == [g[2:] for g in jax4]
        total += sum(len(np.frombuffer(g[1]["label"][2], np.float32)) for g in four)
    assert total == 500


def test_multi_file_corpus_keeps_stream_chunking(tmp_path):
    d = tmp_path / "many"
    d.mkdir()
    (d / "a.libsvm").write_bytes(_libsvm_text(n=40, d=3, seed=1))
    (d / "b.libsvm").write_bytes(_libsvm_text(n=40, d=3, seed=2)[:-1])  # no trailing \n
    p = create_parser(str(d), 0, 1, "libsvm", parse_workers=4, chunk_bytes=4096)
    assert isinstance(p, ParallelTextParser)
    assert not isinstance(p.base.source, MmapLineSplit)
    four = _stream(p)
    one = _stream(create_parser(str(d), 0, 1, "libsvm", parse_workers=1, chunk_bytes=4096))
    assert four == one
    jax4 = _stream(jax_create_parser(str(d) + "?engine=python", 0, 1, "libsvm",
                                     parse_workers=4, chunk_bytes=4096))
    assert [g[2:] for g in four] == [g[2:] for g in jax4]


# ---------------- resume ----------------

def _resume_uri(tmp_path):
    return _write(tmp_path, "s.libsvm", _libsvm_text(n=1500, d=4))


@pytest.mark.parametrize("source", ["port4", "port1", "jax4", "jax1"])
def test_byte_exact_seek_resume(tmp_path, source):
    path = _resume_uri(tmp_path)

    def port(workers):
        return create_parser(path, 0, 1, "libsvm", parse_workers=workers, chunk_bytes=1024)

    full = _stream(port(4))
    assert len(full) >= 6
    if source.startswith("port"):
        p = port(int(source[-1]))
    else:
        p = jax_create_parser(path + "?engine=python", 0, 1, "libsvm",
                              parse_workers=int(source[-1]), chunk_bytes=1024)
    for _ in range(3):
        p.next_block()
    state = json.loads(_js(p.state_dict()))
    p.close()
    assert state["kind"] == "split" and state["blocks"] == 3
    for workers in (4, 1):
        p = port(workers)
        p.load_state(state)
        rest = _stream(p)
        assert [g[:2] for g in rest] == [g[:2] for g in full[3:]]
    # and a port state restores in the JAX fan-out
    p = port(4)
    for _ in range(3):
        p.next_block()
    state = json.loads(_js(p.state_dict()))
    p.close()
    jp = jax_create_parser(path + "?engine=python", 0, 1, "libsvm", parse_workers=4,
                           chunk_bytes=1024)
    jp.load_state(state)
    assert [g[1]["label"] for g in _stream(jp)] == [g[1]["label"] for g in full[3:]]


def test_blocks_state_replays_the_count(tmp_path):
    path = _resume_uri(tmp_path)
    full = _stream(create_parser(path, parse_workers=4, chunk_bytes=1024))
    p = create_parser(path, parse_workers=4, chunk_bytes=1024)
    assert p.state_dict() == {"kind": "blocks", "blocks": 0}
    p.load_state({"kind": "blocks", "blocks": 2})
    assert [g[:2] for g in _stream(p)] == [g[:2] for g in full[2:]]


def test_epoch_reset_and_repartition(tmp_path):
    path = _resume_uri(tmp_path)
    p = create_parser(path, 0, 2, "libsvm", parse_workers=4, chunk_bytes=1024)
    first = []
    while (b := p.next_block()) is not None:
        first.append(b.label.tobytes())
    p.before_first()
    again = [b.label.tobytes() for b in iter(p.next_block, None)]
    assert first == again
    p.reset_partition(1, 2)
    other = [b.label for b in iter(p.next_block, None)]
    p.close()
    assert sum(len(np.frombuffer(x, np.float32)) for x in first) + sum(map(len, other)) == 1500


def test_stage_seconds_and_parallel_stats(tmp_path):
    path = _resume_uri(tmp_path)
    p = create_parser(path, 0, 1, "libsvm", parse_workers=4, chunk_bytes=1024)
    assert isinstance(p, ParallelTextParser) and isinstance(p.base.source, MmapLineSplit)
    assert p.base._parse_nthread == 1  # one native lane a worker
    assert p.parallel_stats()["parse_parallelism_efficiency"] is None
    assert len(list(iter(p.next_block, None))) > 4
    stages = p.stage_seconds()
    assert set(stages) == {"read", "parse"} and stages["parse"] > 0
    ps = p.parallel_stats()
    assert ps["parse_workers"] == 4
    assert ps["parse_busy_seconds"] == pytest.approx(stages["parse"])
    assert ps["parse_span_seconds"] > 0
    assert 0 < ps["parse_parallelism_efficiency"] <= 1.0
    p.before_first()  # a fresh span: the idle gap is not the workers'
    assert p.parallel_stats()["parse_parallelism_efficiency"] is None
    p.close()


def test_device_iter_stats_carry_parse_workers(tmp_path):
    path = _resume_uri(tmp_path)

    def run(workers):
        p = create_parser(path, 0, 1, "libsvm", parse_workers=workers, chunk_bytes=1024)
        it = DeviceIter(p, num_col=4, batch_size=64, layout="dense", pack_aux=False,
                        device="cpu")
        batches = [(x.numpy().tobytes(), y.numpy().tobytes()) for x, y, _ in it]
        stats = it.stats()
        it.close()
        return batches, stats

    b1, s1 = run(1)
    b4, s4 = run(4)
    assert b1 == b4
    assert s1["parse_workers"] == 1 and s1["parse_parallelism_efficiency"] is None
    assert s4["parse_workers"] == 4
    assert 0 < s4["parse_parallelism_efficiency"] <= 1.0
    assert s4["parse_parallel"]["parse_workers"] == 4


def test_parse_error_raises_in_stream_order(tmp_path):
    good = _libsvm_text(n=200, d=3)
    path = _write(tmp_path, "bad.libsvm", good + b"1 0:1 foo 2:3\n" + good)
    p = create_parser(path, 0, 1, "libsvm", parse_workers=4, chunk_bytes=512)
    delivered = 0
    with pytest.raises(DMLCError, match="malformed"):
        while p.next_block() is not None:
            delivered += 1
    p.close()
    # every block before the bad chunk was delivered first
    one = create_parser(path, 0, 1, "libsvm", parse_workers=1, chunk_bytes=512)
    before = 0
    with pytest.raises(DMLCError):
        while one.next_block() is not None:
            before += 1
    one.close()
    assert delivered == before > 0


# ---------------- the knob ----------------

def test_parse_workers_knob_matches_reference(monkeypatch):
    assert knobs.resolve("parse_workers") == jax_knobs.resolve("parse_workers")
    assert knobs.resolve("parse_workers", 64) == jax_knobs.resolve("parse_workers", 64) == 64
    assert knobs.resolve("parse_workers", 0) == jax_knobs.resolve("parse_workers", 0) == 1
    monkeypatch.setenv("DMLC_TPU_PARSE_WORKERS", "3")
    assert knobs.resolve("parse_workers") == jax_knobs.resolve("parse_workers") == 3
    for raw in ("0", "-2", "two"):
        monkeypatch.setenv("DMLC_TPU_PARSE_WORKERS", raw)
        with pytest.raises(JaxDMLCError):
            jax_knobs.resolve("parse_workers")
        with pytest.raises(DMLCError, match="DMLC_TPU_PARSE_WORKERS"):
            knobs.resolve("parse_workers")


def test_create_parser_reads_the_knob(tmp_path, monkeypatch):
    path = _write(tmp_path, "k.libsvm", _libsvm_text(n=50, d=3))
    monkeypatch.setenv("DMLC_TPU_PARSE_WORKERS", "1")
    assert isinstance(create_parser(path), ThreadedParser)
    monkeypatch.setenv("DMLC_TPU_PARSE_WORKERS", "3")
    p = create_parser(path)
    assert isinstance(p, ParallelTextParser) and p.num_workers == 3
    assert isinstance(p.base.source, MmapLineSplit)
    p.close()
    assert isinstance(create_parser(path, threaded=False), LibSVMParser)


# ---------------- the mmap chunk source ----------------

@pytest.mark.parametrize("nparts", [1, 3])
def test_mmap_bounds_and_records_equal_the_stream(tmp_path, nparts):
    path = _write(tmp_path, "m.libsvm", _libsvm_text(n=700, d=3))
    for part in range(nparts):
        a = create_mmap_text_split(path, part, nparts, chunk_bytes=4096)
        b = LineSplitter(path, part, nparts, chunk_bytes=4096)
        j = jax_mmap_split(path, part, nparts, chunk_bytes=4096)
        assert (a.offset_begin, a.offset_end) == (b.offset_begin, b.offset_end)
        assert (a.offset_begin, a.offset_end) == (j.offset_begin, j.offset_end)
        ca = [bytes(c) for c in iter(a.next_chunk, None)]
        cb = [bytes(c) for c in iter(b.next_chunk, None)]
        cj = [bytes(c) for c in iter(j.next_chunk, None)]
        assert ca == cj and ca == cb  # one file: the stream's grouping
        a.before_first()
        assert [bytes(c) for c in iter(a.next_chunk, None)] == ca
        for s in (a, b, j):
            s.close()


def test_empty_after_adjustment_partition(tmp_path):
    """A partition the record-boundary adjustment empties yields nothing,
    never a mid-record fragment."""
    path = _write(tmp_path, "one_long.libsvm", b"3 " + b"1:1 " * 9 + b"\n44 1:2\n")
    for nparts in (3, 5):
        for part in range(nparts):
            a = create_mmap_text_split(path, part, nparts)
            b = LineSplitter(path, part, nparts)
            ca = b"".join(bytes(c) for c in iter(a.next_chunk, None))
            cb = b"".join(bytes(c) for c in iter(b.next_chunk, None))
            assert ca.rstrip(b"\n") == cb.rstrip(b"\n"), (nparts, part)
            a.before_first()
            assert b"".join(bytes(c) for c in iter(a.next_chunk, None)) == ca
            a.close()
            b.close()


def test_multi_file_joins(tmp_path):
    _write(tmp_path, "a.txt", b"1 0:1\n2 0:2\n")
    _write(tmp_path, "b.txt", b"3 0:3\n4 0:4")
    a = create_mmap_text_split(str(tmp_path), 0, 1)
    j = jax_mmap_split(str(tmp_path), 0, 1)
    ca = [bytes(c) for c in iter(a.next_chunk, None)]
    assert ca == [bytes(c) for c in iter(j.next_chunk, None)]
    assert b"".join(ca).split() == b"1 0:1 2 0:2 3 0:3 4 0:4".split()
    assert ca[0] == b"1 0:1\n2 0:2\n"  # a chunk never spans a file join
    a.close()
    j.close()


def test_state_roundtrip_and_cross_split(tmp_path):
    path = _write(tmp_path, "x.libsvm", _libsvm_text(n=400, d=3))
    a = create_mmap_text_split(path, 0, 1, chunk_bytes=4096)
    a.next_chunk()
    st = a.state_dict()
    j = jax_mmap_split(path, 0, 1, chunk_bytes=4096)
    j.next_chunk()
    assert _js(st) == _js(j.state_dict())
    assert st["kind"] == "byte" and st["overflow"] == "" and st["chunk"] == ""
    rest = b"".join(bytes(c) for c in iter(a.next_chunk, None))
    a2 = create_mmap_text_split(path, 0, 1, chunk_bytes=4096)
    a2.load_state(st)
    assert b"".join(bytes(c) for c in iter(a2.next_chunk, None)) == rest
    # a stream state (with its read-ahead overflow) into the mmap split,
    # and the mmap state into the stream split
    b = LineSplitter(path, 0, 1, chunk_bytes=4096)
    b.next_chunk()
    stb = b.state_dict()
    assert stb["overflow"]
    rest_b = b"".join(bytes(c) for c in iter(b.next_chunk, None))
    a3 = create_mmap_text_split(path, 0, 1, chunk_bytes=4096)
    a3.load_state(stb)
    assert b"".join(bytes(c) for c in iter(a3.next_chunk, None)) == rest_b
    b2 = LineSplitter(path, 0, 1, chunk_bytes=4096)
    b2.load_state(st)
    assert b"".join(bytes(c) for c in iter(b2.next_chunk, None)) == rest
    for s in (a, a2, a3, b, b2, j):
        s.close()


def test_refuses_pending_chunk_state(tmp_path):
    path = _write(tmp_path, "y.libsvm", _libsvm_text(n=100, d=3))
    b = create_input_split(path, 0, 1, "text", threaded=False, chunk_bytes=512)
    b.next_record()  # mid-record iteration: a pending chunk tail
    st = b.state_dict()
    b.close()
    assert st["chunk"]
    a = create_mmap_text_split(path, 0, 1)
    with pytest.raises(DMLCError, match="pending chunk"):
        a.load_state(st)
    a.close()


def test_chunk_views_outlive_close(tmp_path):
    path = _write(tmp_path, "v.libsvm", _libsvm_text(n=50, d=3))
    a = create_mmap_text_split(path)
    chunk = a.next_chunk()
    a.close()  # a live view leaves the unmap to the garbage collector
    assert bytes(chunk[:2]) == b"0 "
    del chunk


# ---------------- fast-path edges, qid, skeleton cache ----------------

def _svm():
    p = LibSVMParser.__new__(LibSVMParser)
    p.param = LibSVMParserParam()
    return p


def test_label_weight_plus_binary_features():
    b = _svm().parse_chunk_py(b"1:2 3\n1:5 7\n")
    np.testing.assert_array_equal(b.label, [1.0, 1.0])
    np.testing.assert_array_equal(b.weight, [2.0, 5.0])
    np.testing.assert_array_equal(b.index, [3, 7])
    assert b.value is None


def test_token_table_edges():
    with pytest.raises(DMLCError, match="label:weight"):
        _svm().parse_chunk_py(b"1 2:3\n1:2 3\n")
    b = _svm().parse_chunk_py(b"1 2: 3\n")  # a missing value reads 1.0
    np.testing.assert_array_equal(b.index, [2, 3])
    np.testing.assert_array_equal(b.value, [1.0, 1.0])
    for chunk in (b"1 2 :3\n", b"1 2:3\n:::\n1 4:5\n"):
        with pytest.raises((DMLCError, ValueError)):
            _svm().parse_chunk_py(chunk)


def test_fast_path_gives_up_after_rejections():
    p = _svm()
    for _ in range(4):
        p.parse_chunk_py(b"1:2 3\n")  # label:weight: never the fast path
    assert p._fast_rejects == 4 and not p._fast_saw_hit
    p.parse_chunk_py(b"1 2:3\n")  # no longer probed
    assert p._fast_rejects == 5 and not p._fast_saw_hit
    q = _svm()
    q.parse_chunk_py(b"1 2:3\n")
    assert q._fast_saw_hit


@pytest.mark.parametrize("chunk", [b"1 0:1\n0 qid:2 0:2\n1 qid:3 0:3\n",
                                   b"1 qid:1 0:1\n0 0:2\n"])
def test_qid_on_some_rows_raises(chunk):
    with pytest.raises(DMLCError, match="qid"):
        _svm().parse_chunk_py(chunk)


def test_skeleton_cache_under_concurrent_workers():
    """64 geometries on 8 threads with the >64 eviction, a short switch
    interval: no lost insert, no dict-size race, read-only arrays."""
    _CSV_SKELETON_CACHE.clear()
    errors = []

    def run(tid):
        try:
            for rep in range(30):
                for n in range(1, 24):
                    k = (tid + rep) % 7 + 1
                    idx, off = _csv_skeleton(n, k)
                    assert len(idx) == n * k and off[-1] == n * k
                    assert idx.dtype == np.uint64 and not idx.flags.writeable
                    assert not off.flags.writeable
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(t,)) for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors


def test_csv_fan_out_shares_the_read_only_skeleton(tmp_path):
    path = _write(tmp_path, "sk.csv", _csv_text(n=600))
    p = create_parser(path + "?format=csv&label_column=0", parse_workers=4, chunk_bytes=1024,
                      engine="python")
    blocks = list(iter(p.next_block, None))
    p.close()
    assert len(blocks) > 4
    for b in blocks:
        assert not b.index.flags.writeable and not b.offset.flags.writeable
    it = DeviceIter(create_parser(path + "?format=csv&label_column=0", parse_workers=4,
                                  chunk_bytes=1024, engine="python"),
                    num_col=5, batch_size=64, layout="ell", max_nnz=5, device="cpu")
    assert sum(1 for _ in it) == -(-600 // 64)
    it.close()
    assert not isinstance(blocks[0], DenseBlock)


# ---------------- fault C7: the parse engine knob ----------------

def _jax_engine(parser) -> str:
    """The engine a JAX parser chain parses with."""
    if type(parser).__name__ == "NativeStreamParser":
        return "reader"
    while not hasattr(parser, "use_native"):
        parser = parser.base
    return "native" if parser.use_native() else "numpy"


def _port_engine(parser) -> str:
    return "reader" if type(parser).__name__ == "NativeStreamParser" else parser.engine


@pytest.mark.parametrize("source", ["keyword", "uri", "env"])
@pytest.mark.parametrize("engine", ["python", "native", "auto"])
def test_c7_engine_from_each_source_matches_reference(tmp_path, monkeypatch, source, engine):
    """The engine runs as the JAX package's under each of its three sources
    (create_parser's ``engine=``, a ``?engine=`` URI argument,
    ``DMLC_TPU_PARSE_ENGINE``): ``python`` the numpy scanner under every
    wrapper, ``native`` and ``auto`` the fused native reader."""
    monkeypatch.delenv("DMLC_TPU_NO_NATIVE_READER")
    monkeypatch.delenv("DMLC_TPU_PARSE_ENGINE", raising=False)
    path = tmp_path / "c7.libsvm"
    path.write_bytes(_libsvm_text(n=50))
    uri, kw = str(path), {}
    if source == "keyword":
        kw["engine"] = engine
    elif source == "uri":
        uri += f"?engine={engine}"
    else:
        monkeypatch.setenv("DMLC_TPU_PARSE_ENGINE", engine)
    port, jax = create_parser(uri, **kw), jax_create_parser(uri, **kw)
    assert _port_engine(port) == _jax_engine(jax) == (
        "numpy" if engine == "python" else "reader")
    assert [b.index.tobytes() for b in port] == [b.index.tobytes() for b in jax]
    port.close()
    jax.close()


def test_c7_engine_priority_and_typos_match_reference(tmp_path, monkeypatch):
    monkeypatch.delenv("DMLC_TPU_NO_NATIVE_READER")
    path = tmp_path / "c7.libsvm"
    path.write_bytes(_libsvm_text(n=20))
    monkeypatch.setenv("DMLC_TPU_PARSE_ENGINE", "python")
    # the explicit keyword beats the URI, which beats the environment
    for uri, kw, want in ((str(path), {}, "numpy"),
                          (str(path) + "?engine=native", {}, "reader"),
                          (str(path) + "?engine=native", {"engine": "python"}, "numpy"),
                          # the URI's opt-out still keeps the reader away
                          (str(path) + "?engine=python", {"engine": "auto"}, "native")):
        port, jax = create_parser(uri, **kw), jax_create_parser(uri, **kw)
        assert _port_engine(port) == _jax_engine(jax) == want, (uri, kw)
        port.close()
        jax.close()
    for raw in ("pyhton", "NATIVE-BATCH "):
        try:
            want = jax_knobs.parse_engine(raw)
        except JaxDMLCError as exc:
            with pytest.raises(DMLCError) as got:
                knobs.parse_engine(raw)
            assert str(got.value) == str(exc)
        else:
            assert knobs.parse_engine(raw) == want
    monkeypatch.setenv("DMLC_TPU_PARSE_ENGINE", "typo")
    with pytest.raises(DMLCError, match="must be one of"):
        create_parser(str(path))
    assert knobs.PARSE_ENGINES == jax_knobs.PARSE_ENGINES


def test_c7_native_batch_warns_and_takes_the_registry_stack(tmp_path, monkeypatch, caplog):
    """``native-batch`` warns as the JAX package does where its batch
    engine cannot serve a config (a csv of int32 values), and parses on
    the registry stack; a config it serves takes the batch engine, with no
    warning; ``native`` that cannot be served warns too."""
    monkeypatch.delenv("DMLC_TPU_NO_NATIVE_READER")
    path = tmp_path / "c7.libsvm"
    path.write_bytes(_libsvm_text(n=20))
    csv = tmp_path / "c7.csv"
    csv.write_text("".join(f"{i % 2},{i},{i + 1}\n" for i in range(20)))
    with caplog.at_level("WARNING", logger="dmlc_tpu_torch"):
        port = create_parser(f"{csv}?format=csv&dtype=int32", engine="native-batch")
    assert isinstance(port, ParallelTextParser) and port.engine == "numpy"
    assert ("engine=native-batch unavailable for format='csv' index_dtype=<u8 "
            "(toolchain/format/dtype); using the Python engine") in caplog.text
    assert sum(len(b) for b in port) == 20
    port.close()
    caplog.clear()
    with caplog.at_level("WARNING", logger="dmlc_tpu_torch"):
        port = create_parser(str(path), engine="native-batch")
    assert isinstance(port, ParallelTextParser) and port.engine == "native-batch"
    assert "unavailable" not in caplog.text
    port.close()
    caplog.clear()
    with caplog.at_level("WARNING", logger="dmlc_tpu_torch"):
        port = create_parser(str(path), engine="native", threaded=False)
    assert isinstance(port, LibSVMParser)
    assert "engine=native unavailable for uri=" in caplog.text
