"""The port's chunk-batch engine (``engine="native-batch"``) against the
Python engine and against the JAX package's batch engine.

The cases of ``tests/test_native_batch.py``, each run through the port
(and, where the case compares engines, through the JAX package too):

- the parity matrix (libsvm with qid, weights, binary features, indexing
  modes, CRLF without a final newline; libfm; csv with label and weight
  columns) at 1 and 4 parse workers, several parts and their union, CRLF
  partition bounds: the batch engine's arrays equal the Python engine's
  and JAX's batch engine's;
- ``block.encoded``: the span is ``write_segments``' bytes with its crc,
  ``arrays`` and ``num_col``; a cold tee through the batch engine writes the
  Python engine's cache byte for byte, and JAX's batch engine's; a batch-
  built cache serves warm, in either package; a warm block's span
  (``block_encoded``) is the cold block's and re-tees the same file (the
  JAX test's service frame, held in ``test_torch_service_frame.py``);
- ``simd_level`` and ``crc32`` (against ``zlib.crc32`` too) as JAX's,
  and ``bf16_dtype`` is ``torch.bfloat16``; cross-engine checkpoints; the fan-out and its
  stage seconds; the engine knob (env, URI argument, a typo, a config the
  engine cannot serve, the knob outside the cache signature);
- healing: a read that fails mid-stream on a filesystem whose streams
  resume (a ``ResilientStream``) and a flipped byte in the warm cache give
  the clean epoch, with the counters; the JAX test's two fault plans
  (``read@2..3=http-503`` over a local HTTP source, and
  ``DMLC_FAULT_PLAN=cache_read@1=corrupt`` on a warm batch-built cache)
  heal the same way in both packages, with equal ``fired()`` and counters.
"""

import io as _pyio
import os
import zlib

import numpy as np
import pytest
import torch

from dmlc_tpu import native as jax_native
from dmlc_tpu.data.parsers import create_parser as jax_create_parser
from dmlc_tpu.io import faults as jax_faults
from dmlc_tpu.io import filesystem as jax_fs
from dmlc_tpu.io import http_filesys as jax_http
from dmlc_tpu.io import resilience as jax_resilience
from dmlc_tpu.store import manager as jax_mgr
from dmlc_tpu_torch import native
from dmlc_tpu_torch.data.batch_parser import NativeBatchParser
from dmlc_tpu_torch.data.parsers import ParallelTextParser, create_parser
from dmlc_tpu_torch.io import faults as port_faults
from dmlc_tpu_torch.io import filesystem as fs_mod
from dmlc_tpu_torch.io import http_filesys as port_http
from dmlc_tpu_torch.io import resilience
from dmlc_tpu_torch.io.block_cache import BlockCacheReader, BlockCacheWriter, write_segments
from dmlc_tpu_torch.store import manager as port_mgr
from dmlc_tpu_torch.utils.check import DMLCError

pytestmark = pytest.mark.skipif(not native.available(), reason="native core unavailable")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    monkeypatch.setenv("DMLC_RETRY_BASE_MS", "1")
    monkeypatch.setenv("DMLC_RETRY_MAX_MS", "5")
    monkeypatch.delenv("DMLC_TPU_PARSE_WORKERS", raising=False)
    monkeypatch.delenv("DMLC_TPU_PARSE_ENGINE", raising=False)
    monkeypatch.delenv("DMLC_TPU_NO_NATIVE_READER", raising=False)
    resilience.reset_counters()
    jax_mgr.reset_stores()
    port_mgr.reset_stores()
    yield
    jax_mgr.reset_stores()
    port_mgr.reset_stores()


# ---------------- corpora (tests/test_native_batch.py's) ----------------

def _libsvm_text(n=300, d=6, qid=False, weight=False, seed=0, binary=False,
                 eol="\n", terminated=True):
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        label = f"{i % 2}:{rng.random():.3f}" if weight else f"{i % 2}"
        q = f" qid:{i // 10}" if qid else ""
        if binary:
            feats = " ".join(f"{j}" for j in range(1, d + 1))
        else:
            feats = " ".join(f"{j}:{rng.normal():.5f}" for j in range(d))
        lines.append(f"{label}{q} {feats}")
    return (eol.join(lines) + (eol if terminated else "")).encode()


def _libfm_text(n=300, d=5, seed=1):
    rng = np.random.default_rng(seed)
    return ("\n".join(f"{i % 2} " + " ".join(f"{j % 3}:{j}:{rng.normal():.5f}"
                                             for j in range(d))
                      for i in range(n)) + "\n").encode()


def _csv_text(n=300, d=5, seed=2):
    rng = np.random.default_rng(seed)
    return ("\n".join(f"{i % 2}," + ",".join(f"{rng.normal():.5f}" for _ in range(d))
                      for i in range(n)) + "\n").encode()


def _write(tmp_path, name, data):
    p = tmp_path / name
    p.write_bytes(data)
    return str(p)


def _drain_arrays(parser):
    out = {}

    def add(key, arr):
        if arr is not None:
            out.setdefault(key, []).append(np.asarray(arr))

    while (b := parser.next_block()) is not None:
        add("label", b.label)
        add("index", b.index)
        add("value", b.value)
        add("weight", b.weight)
        add("qid", b.qid)
        add("field", b.field)
        add("nnz", np.diff(np.asarray(b.offset)))
    return {k: np.concatenate(v) for k, v in out.items()}


def _assert_same(a, b):
    assert set(a) == set(b), (sorted(a), sorted(b))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a[k].dtype == b[k].dtype, k


def _run(uri, fmt, engine, workers=1, part=0, nparts=1, make=create_parser, **kw):
    p = make(uri, part, nparts, fmt, threaded=True, parse_workers=workers, engine=engine,
             chunk_bytes=2048, **kw)
    try:
        return _drain_arrays(p)
    finally:
        p.close()


PARITY_MATRIX = [
    ("libsvm", _libsvm_text(), ""),
    ("libsvm", _libsvm_text(qid=True), ""),
    ("libsvm", _libsvm_text(weight=True), ""),
    ("libsvm", _libsvm_text(binary=True), ""),
    ("libsvm", _libsvm_text(d=3, seed=7), "?indexing_mode=-1"),
    ("libsvm", _libsvm_text(d=3, seed=8), "?indexing_mode=1"),
    ("libsvm", _libsvm_text(eol="\r\n", terminated=False), ""),
    ("libfm", _libfm_text(), ""),
    ("libfm", _libfm_text(seed=5), "?indexing_mode=-1"),
    ("csv", _csv_text(), "?label_column=0"),
    ("csv", _csv_text(seed=9), "?label_column=0&weight_column=1"),
    ("csv", _csv_text(seed=11), ""),
]


# ---------------- parity ----------------

@pytest.mark.parametrize("fmt,data,uri_args", PARITY_MATRIX)
@pytest.mark.parametrize("workers", [1, 4])
def test_epoch_byte_identical(tmp_path, fmt, data, uri_args, workers):
    uri = _write(tmp_path, f"c.{fmt}", data) + uri_args
    got = _run(uri, fmt, "native-batch", workers)
    _assert_same(got, _run(uri, fmt, "python", workers))
    _assert_same(got, _run(uri, fmt, "native-batch", workers, make=jax_create_parser))


def test_multi_partition_parity_and_union(tmp_path):
    uri = _write(tmp_path, "parts.libsvm", _libsvm_text(n=900, d=4, seed=3))
    whole = _run(uri, "libsvm", "python")
    parts = []
    for part in range(3):
        a = _run(uri, "libsvm", "native-batch", part=part, nparts=3)
        _assert_same(a, _run(uri, "libsvm", "python", part=part, nparts=3))
        _assert_same(a, _run(uri, "libsvm", "native-batch", part=part, nparts=3,
                             make=jax_create_parser))
        parts.append(a)
    _assert_same({k: np.concatenate([p[k] for p in parts]) for k in whole}, whole)


def test_crlf_noterm_partition_boundaries(tmp_path):
    uri = _write(tmp_path, "crlf.libsvm", _libsvm_text(n=120, d=3, eol="\r\n",
                                                       terminated=False))
    for nparts in (2, 3, 5):
        for part in range(nparts):
            _assert_same(_run(uri, "libsvm", "native-batch", part=part, nparts=nparts),
                         _run(uri, "libsvm", "python", part=part, nparts=nparts))


# ---------------- the encoded span ----------------

def test_encoded_contract(tmp_path):
    """``block.encoded`` carries exactly write_segments' bytes and crc."""
    uri = _write(tmp_path, "e.libsvm", _libsvm_text(n=200, d=5))
    p = create_parser(uri, 0, 1, "libsvm", threaded=False, engine="native-batch",
                      chunk_bytes=4096)
    assert isinstance(p, NativeBatchParser) and p.engine == "native-batch"
    n = 0
    while (b := p.next_block()) is not None:
        enc = b.encoded
        assert enc.rows == len(b)
        assert zlib.crc32(enc.data) & 0xFFFFFFFF == enc.crc
        buf = _pyio.BytesIO()
        _, crc, arrays = write_segments(buf, b.to_segments())
        assert buf.getvalue() == bytes(memoryview(enc.data))
        assert crc == enc.crc
        assert arrays == {k: [d, o, nb] for k, (d, o, nb) in enc.arrays.items()}
        assert enc.num_col == b.num_col
        n += 1
    p.close()
    assert n >= 1


def _build_cache(make, uri, cache, engine, workers):
    p = make(uri, 0, 1, "libsvm", threaded=True, parse_workers=workers, engine=engine,
             chunk_bytes=2048, block_cache=cache)
    try:
        while p.next_block() is not None:
            pass
    finally:
        p.close()
    with open(cache, "rb") as f:
        return f.read()


@pytest.mark.parametrize("workers", [1, 4])
def test_cold_tee_cache_byte_identical(tmp_path, workers):
    """A cold epoch teed through the batch engine writes the Python
    engine's cache byte for byte, and JAX's batch engine's."""
    uri = _write(tmp_path, "tee.libsvm", _libsvm_text(n=600, d=5))
    files = {}
    for name, make, engine in (("batch", create_parser, "native-batch"),
                               ("python", create_parser, "python"),
                               ("jax_batch", jax_create_parser, "native-batch")):
        files[name] = _build_cache(make, uri, str(tmp_path / f"{name}.bc"), engine, workers)
    assert files["batch"] == files["python"] == files["jax_batch"]
    assert files["batch"][:8] == b"DMLCBC01" and files["batch"][-8:] == b"DMLCBC01"


def test_batch_built_cache_serves_warm_in_either_package(tmp_path):
    """Warm epochs over a batch-built cache deliver the cold stream, in the
    package that built it and in the other."""
    uri = _write(tmp_path, "warm.libsvm", _libsvm_text(n=400, d=4))
    for writer, server in ((create_parser, create_parser), (create_parser, jax_create_parser),
                            (jax_create_parser, create_parser)):
        cache = str(tmp_path / "warm.bc")
        p = writer(uri, 0, 1, "libsvm", threaded=True, parse_workers=1,
                    engine="native-batch", chunk_bytes=2048, block_cache=cache)
        cold = _drain_arrays(p)
        assert p.cache_state == "cold"
        p.close()
        q = server(uri, 0, 1, "libsvm", threaded=True, parse_workers=1,
                   engine="native-batch", chunk_bytes=2048, block_cache=cache)
        assert q.cache_state == "warm"
        _assert_same(cold, _drain_arrays(q))
        q.close()
        os.remove(cache)


def test_warm_spans_are_the_cold_spans_and_retee(tmp_path):
    """A warm block's ``encoded`` (the cache's mmap span) is the cold
    block's span byte for byte, and appending the warm spans to a new
    cache rewrites the file: the one materialization serves the parse,
    the cache and any consumer that appends blocks."""
    uri = _write(tmp_path, "span.libsvm", _libsvm_text(n=300, d=4))
    cache = str(tmp_path / "span.bc")
    p = create_parser(uri, 0, 1, "libsvm", threaded=False, engine="native-batch",
                      chunk_bytes=2048, block_cache=cache)
    cold = [(bytes(memoryview(b.encoded.data)), b.encoded.crc, b.resume_state)
            for b in iter(p.next_block, None)]
    p.before_first()
    assert p.cache_state == "warm"
    copy = str(tmp_path / "copy.bc")
    reader = BlockCacheReader(cache)
    w = BlockCacheWriter(copy, signature=reader.signature)
    warm = []
    for b in iter(p.next_block, None):
        warm.append((bytes(memoryview(b.encoded.data)), b.encoded.crc, b.resume_state))
        w.add_block_encoded(b.encoded, resume=b.resume_state)
    w.finish()
    reader.close()
    p.close()
    assert warm == cold and len(cold) > 3
    assert open(copy, "rb").read() == open(cache, "rb").read()


def test_simd_level_reported():
    level = native.simd_level()
    assert level == jax_native.simd_level() and level in (0, 1, 2, 3)
    out = native.parse_batch(b"1 1:2\n", "libsvm")
    want = jax_native.parse_batch(b"1 1:2\n", "libsvm")
    assert out["simd_level"] == level
    assert bytes(out["data"]) == bytes(want["data"]) and out["arrays"] == want["arrays"]
    assert (out["crc"], out["rows"], out["nnz"], out["num_col"]) == (
        want["crc"], want["rows"], want["nnz"], want["num_col"])


# ---------------- checkpoints ----------------

@pytest.mark.parametrize("engines", [("native-batch", "python"), ("python", "native-batch"),
                                     ("native-batch", "native-batch"),
                                     ("jax-native-batch", "native-batch")])
def test_cross_engine_resume_byte_identical(tmp_path, engines):
    """A mid-stream checkpoint of one engine (of either package) restores
    into the other and replays the rest byte for byte."""
    src_engine, dst_engine = engines
    uri = _write(tmp_path, "ck.libsvm", _libsvm_text(n=500, d=4))

    def parser(engine):
        make = create_parser
        if engine.startswith("jax-"):
            make, engine = jax_create_parser, engine[4:]
        return make(uri, 0, 1, "libsvm", threaded=True, parse_workers=1, engine=engine,
                    chunk_bytes=2048)

    full = parser(src_engine)
    try:
        ref = _drain_arrays(full)
    finally:
        full.close()
    src = parser(src_engine)
    try:
        head = []
        for _ in range(2):
            b = src.next_block()
            assert b is not None
            head.append(np.asarray(b.label))
        state = src.state_dict()
    finally:
        src.close()
    dst = parser(dst_engine)
    try:
        dst.load_state(state)
        tail = _drain_arrays(dst)
    finally:
        dst.close()
    np.testing.assert_array_equal(np.concatenate(head + [tail["label"]]), ref["label"])


def test_parallel_wrap_and_stage_seconds(tmp_path):
    uri = _write(tmp_path, "w.libsvm", _libsvm_text(n=300, d=4))
    p = create_parser(uri, 0, 1, "libsvm", threaded=True, parse_workers=4,
                      engine="native-batch", chunk_bytes=2048)
    try:
        assert isinstance(p, ParallelTextParser)
        assert isinstance(p.base, NativeBatchParser) and p.engine == "native-batch"
        while p.next_block() is not None:
            pass
        stages = p.stage_seconds()
        assert set(stages) >= {"read", "parse"}
        assert stages["parse"] > 0.0
        assert p.parallel_stats()["parse_workers"] == 4
    finally:
        p.close()


# ---------------- the engine knob ----------------

def test_env_routes_engine(tmp_path, monkeypatch):
    uri = _write(tmp_path, "env.libsvm", _libsvm_text(n=50, d=3))
    monkeypatch.setenv("DMLC_TPU_PARSE_ENGINE", "native-batch")
    p = create_parser(uri, 0, 1, "libsvm", threaded=False, chunk_bytes=4096)
    try:
        assert isinstance(p, NativeBatchParser)
    finally:
        p.close()


def test_uri_arg_routes_engine(tmp_path):
    uri = _write(tmp_path, "uri.libsvm", _libsvm_text(n=50, d=3))
    p = create_parser(uri + "?engine=native-batch", 0, 1, "libsvm", threaded=False,
                      chunk_bytes=4096)
    try:
        assert isinstance(p, NativeBatchParser)
    finally:
        p.close()


def test_bad_engine_rejected_loudly(tmp_path, monkeypatch):
    uri = _write(tmp_path, "bad.libsvm", _libsvm_text(n=10, d=2))
    monkeypatch.setenv("DMLC_TPU_PARSE_ENGINE", "turbo")
    with pytest.raises(DMLCError, match="parse engine"):
        create_parser(uri, 0, 1, "libsvm", threaded=False)


def test_unsupported_config_falls_back_to_python(tmp_path, caplog):
    """A config the batch kernel cannot serve (a csv of int32 values, or
    ``index_dtype=uint32``: its segments are uint64) takes the Python
    engine, loudly, as in JAX, and still serves JAX's blocks, dtypes
    included."""
    ints = "".join(f"{i % 2},{i},{3 * i}\n" for i in range(40)).encode()
    uri = _write(tmp_path, "dt.csv", ints) + "?dtype=int32"
    with caplog.at_level("WARNING", logger="dmlc_tpu_torch"):
        p = create_parser(uri, 0, 1, "csv", threaded=False, engine="native-batch",
                          chunk_bytes=4096)
    want = jax_create_parser(uri, 0, 1, "csv", threaded=False, engine="native-batch",
                             chunk_bytes=4096)
    try:
        assert not isinstance(p, NativeBatchParser)
        assert type(p).__name__ == type(want).__name__
        assert "engine=native-batch unavailable for format='csv'" in caplog.text
        _assert_same(_drain_arrays(p), _drain_arrays(want))
    finally:
        p.close()
        want.close()
    caplog.clear()
    with caplog.at_level("WARNING", logger="dmlc_tpu_torch"):
        p = create_parser(uri, 0, 1, "csv", threaded=False, index_dtype=np.uint32,
                          engine="native-batch", chunk_bytes=4096)
    want = jax_create_parser(uri, 0, 1, "csv", threaded=False, index_dtype=np.uint32,
                             engine="native-batch", chunk_bytes=4096)
    try:
        assert not isinstance(p, NativeBatchParser)
        assert type(p).__name__ == type(want).__name__
        assert "format='csv' index_dtype=<u4" in caplog.text
        got = _drain_arrays(p)
        _assert_same(got, _drain_arrays(want))
        assert got["index"][0].dtype == np.uint32
    finally:
        p.close()
        want.close()


def test_engine_outside_cache_signature(tmp_path):
    """One cache serves every engine: a cache built under engine=python
    opens warm under native-batch (the knob is out of the signature)."""
    path = _write(tmp_path, "sig.libsvm", _libsvm_text(n=120, d=3))
    cache = str(tmp_path / "sig.bc")
    p = create_parser(path + "?engine=python", 0, 1, "libsvm", threaded=False,
                      chunk_bytes=4096, block_cache=cache)
    try:
        while p.next_block() is not None:
            pass
        p.before_first()
        assert p.cache_state == "warm"
    finally:
        p.close()
    q = create_parser(path + "?engine=native-batch", 0, 1, "libsvm", threaded=False,
                      chunk_bytes=4096, block_cache=cache)
    try:
        assert q.cache_state == "warm"
    finally:
        q.close()


# ---------------- healing ----------------

class _FlakyFS(fs_mod.FileSystem):
    """A filesystem whose streams resume by themselves (a ResilientStream
    over each open, as the remote members' range reads do); the reads
    ``fail_reads`` (their ordinal numbers) raise a reset connection."""

    native_resilience = True

    def __init__(self, data: bytes, fail_reads):
        self.data = data
        self.fail_reads = set(fail_reads)
        self.reads = 0

    def get_path_info(self, path):
        return fs_mod.FileInfo(path, len(self.data), fs_mod.FILE_TYPE)

    def _raw(self):
        bio = _pyio.BytesIO(self.data)
        orig = bio.read

        def read(n=-1):
            self.reads += 1
            if self.reads in self.fail_reads:
                raise ConnectionResetError("read flake")
            return orig(n)

        bio.read = read
        return bio

    def open(self, path, mode):
        return _pyio.BufferedReader(resilience.ResilientStream(self._raw, what=path.raw),
                                    buffer_size=1024)


def test_remote_read_fault_heals_byte_identical(tmp_path):
    """A read that fails twice mid-stream, under the batch engine over a
    filesystem whose streams resume: the epoch equals a clean
    Python-engine run, and the retries are counted."""
    data = _libsvm_text(n=400, d=4)
    clean = _run(_write(tmp_path, "c.libsvm", data), "libsvm", "python")
    flaky = _FlakyFS(data, fail_reads=(7, 8))
    fs_mod.register_filesystem("flaky://", lambda uri: flaky)
    try:
        resilience.reset_counters()
        healed = _run("flaky://h/c.libsvm", "libsvm", "native-batch")
    finally:
        with fs_mod._FS_LOCK:
            fs_mod._FS_FACTORIES.pop("flaky://")
    _assert_same(healed, clean)
    snap = resilience.counters_snapshot()
    assert snap["retries"] == 2 and snap["resumes"] == 2 and snap["giveups"] == 0


def test_corrupt_warm_block_heals_byte_identical(tmp_path):
    """A flipped byte in a batch-built cache: the warm epoch heals to the
    clean stream, with one corruption and one rebuild counted."""
    uri = _write(tmp_path, "fp.libsvm", _libsvm_text(n=400, d=4))
    clean = _run(uri, "libsvm", "python")
    cache = str(tmp_path / "fp.bc")
    p = create_parser(uri, 0, 1, "libsvm", threaded=True, parse_workers=1,
                      engine="native-batch", chunk_bytes=2048, block_cache=cache)
    try:
        while p.next_block() is not None:
            pass
        p.close()
        reader = BlockCacheReader(cache)
        pos = int(reader._blocks[1]["pos"]) + 3
        reader.close()
        with open(cache, "r+b") as f:
            f.seek(pos)
            byte = f.read(1)
            f.seek(pos)
            f.write(bytes([byte[0] ^ 0xFF]))
        resilience.reset_counters()
        p = create_parser(uri, 0, 1, "libsvm", threaded=True, parse_workers=1,
                          engine="native-batch", chunk_bytes=2048, block_cache=cache)
        assert p.cache_state == "warm"
        healed = _drain_arrays(p)
    finally:
        p.close()
    _assert_same(healed, clean)
    snap = resilience.counters_snapshot()
    assert snap["cache_corruptions"] == 1 and snap["cache_rebuilds"] == 1


def test_remote_read_fault_plan_heals_byte_identical(monkeypatch):
    """The JAX test's plan, ``read@2..3=http-503``, through the batch engine
    over a local HTTP source in both packages: the epoch equals a clean
    Python-engine run, the two retries are counted, nothing gives up, and
    the port's arrays, ``fired()`` and counters equal the JAX package's."""
    import http.server
    import threading

    from test_resilience import _HttpFilesHandler

    for mod in (jax_http, port_http):
        monkeypatch.setattr(mod, "_BLOCK", 2048)
    _HttpFilesHandler.files = {"/c.libsvm": _libsvm_text(n=400, d=4)}
    _HttpFilesHandler.flaky_503 = _HttpFilesHandler.flaky_429 = 0
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _HttpFilesHandler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    out = {}
    try:
        uri = f"http://127.0.0.1:{server.server_address[1]}/c.libsvm"
        for name, make, faults, res in (
                ("jax", jax_create_parser, jax_faults, jax_resilience),
                ("port", create_parser, port_faults, resilience)):
            clean = _run(uri, "libsvm", "python", make=make)
            res.reset_counters()
            with faults.inject("read@2..3=http-503") as plan:
                healed = _run(uri, "libsvm", "native-batch", make=make)
            _assert_same(healed, clean)
            snap = res.counters_snapshot()
            assert plan.fired() == 2
            assert snap["retries"] == 2 and snap["giveups"] == 0
            out[name] = (healed, plan.fired(), snap["retries"], snap["resumes"])
    finally:
        server.shutdown()
        server.server_close()
    _assert_same(out["port"][0], out["jax"][0])
    assert out["port"][1:] == out["jax"][1:]


def test_fault_plan_heal_byte_identical(tmp_path, monkeypatch):
    """The JAX test's env plan, ``DMLC_FAULT_PLAN=cache_read@1=corrupt``, on
    a warm batch-built cache in both packages: healed to the clean stream
    with one corruption and one rebuild, equal to the JAX package's."""
    out = {}
    for name, make, faults, res in (("jax", jax_create_parser, jax_faults, jax_resilience),
                                    ("port", create_parser, port_faults, resilience)):
        d = tmp_path / name
        d.mkdir()
        uri = _write(d, "fp.libsvm", _libsvm_text(n=400, d=4))
        clean = _run(uri, "libsvm", "python", make=make)
        res.reset_counters()
        p = make(uri, 0, 1, "libsvm", threaded=True, parse_workers=1, engine="native-batch",
                 chunk_bytes=2048, block_cache=str(d / "fp.bc"))
        try:
            while p.next_block() is not None:
                pass
            p.before_first()  # warm now
            monkeypatch.setenv("DMLC_FAULT_PLAN", "cache_read@1=corrupt")
            faults.reset()
            healed = _drain_arrays(p)
            fired = faults.active_plan().fired()
        finally:
            monkeypatch.delenv("DMLC_FAULT_PLAN")
            faults.reset()
            p.close()
        _assert_same(healed, clean)
        snap = res.counters_snapshot()
        assert snap["cache_corruptions"] == 1 and snap["cache_rebuilds"] == 1
        out[name] = (healed, fired, snap["cache_corruptions"], snap["cache_rebuilds"])
    _assert_same(out["port"][0], out["jax"][0])
    assert out["port"][1:] == out["jax"][1:] == (1, 1, 1)


def test_batch_engine_over_memfs_matches_reference(tmp_path):
    """``mem://`` under the batch engine: the stream split's chunks, the
    same arrays as JAX's batch engine over its own ``mem://``."""
    data = _libsvm_text(n=500, d=4, seed=4)
    for mod in (fs_mod, jax_fs):
        mod.MemoryFileSystem.reset()
        mod.MemoryFileSystem.instance().store["b/m.libsvm"] = data
    try:
        for workers in (1, 4):
            got = _run("mem://b/m.libsvm", "libsvm", "native-batch", workers)
            _assert_same(got, _run("mem://b/m.libsvm", "libsvm", "native-batch", workers,
                                   make=jax_create_parser))
            _assert_same(got, _run(_write(tmp_path, "m.libsvm", data), "libsvm", "python"))
    finally:
        for mod in (fs_mod, jax_fs):
            mod.MemoryFileSystem.reset()


@pytest.mark.parametrize("data", [b"", b"x", b"123456789", bytes(range(256)) * 41,
                                  bytearray(b"dmlc" * 1000), memoryview(b"abc" * 77)])
def test_crc32_matches_zlib_and_reference(data):
    got = native.crc32(data)
    assert got == jax_native.crc32(data) == zlib.crc32(bytes(data)) & 0xFFFFFFFF


def test_crc32_without_the_library_and_bf16_dtype(monkeypatch):
    monkeypatch.setattr(native, "_load", lambda: None)
    assert native.crc32(b"abc") is None
    assert native.bf16_dtype() is torch.bfloat16
    assert torch.empty(0, dtype=native.bf16_dtype()).element_size() == (
        jax_native.bf16_dtype().itemsize)
