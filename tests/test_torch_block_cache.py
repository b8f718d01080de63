"""The port's parse-once block cache, against the JAX package's.

On the CPU, every port entry point with ``device="cpu"``; the JAX side
runs its Python parser chain (``create_parser(uri + "?engine=python",
threaded=True, parse_workers=1, chunk_bytes=4096, ...)``) as
``tests/test_torch_checkpoint.py`` does. Checked, bytes as bytes:

- the port's writer reproduces ``tests/data/blockcache_v1.golden`` byte
  for byte (a ``uint32`` index segment and a ``None`` resume included),
  and reads it back;
- a cache written by either package serves warm in the other with
  byte-equal blocks and resume annotations, and the two packages write
  byte-identical cache files; a changed source, chunk size or parser
  argument invalidates the cache (counted as the JAX package counts it),
  so the next epoch runs cold;
- a corrupt block heals with the JAX package's counters, in sequential
  mode (re-parse from the source) and in plan mode (a silent rebuild),
  the stream unchanged;
- ``DeviceIter(ell)`` over the planned cache: its states equal the JAX
  package's as JSON at every batch, ``stats()`` carries the plan's seed
  and epoch, and a mid-epoch state restores both ways to byte-equal
  batches;
- ``DeviceIter(snapshot_shuffle_seed=)``: each warm batch is the stored
  batch at ``block_permutation(seed, epoch, n)[pos]``, order and states
  equal the JAX package's, ``unit="batch"`` states restore both ways
  (also after the snapshot was deleted, which rebuilds it), and a
  snapshot over a seeded source raises as in JAX;
- ``create_parser``'s checks and messages equal the JAX package's, and
  the ``#blockcache=`` fragment and the ``DMLC_TPU_BLOCK_CACHE`` directory
  resolve to the JAX package's paths;
- the ``plan_read_workers`` knob and the ordered pool behind it.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from dmlc_tpu.data import create_parser as jax_create_parser
from dmlc_tpu.data import epoch as jax_epoch
from dmlc_tpu.data.device import DeviceIter as JaxDeviceIter
from dmlc_tpu.io import resilience as jax_resilience
from dmlc_tpu.io.uri import URISpec as JaxURISpec
from dmlc_tpu.utils import knobs as jax_knobs
from dmlc_tpu.utils.check import DMLCError as JaxDMLCError
from dmlc_tpu_torch.data import DeviceIter, create_parser
from dmlc_tpu_torch.data.row_block import RowBlock
from dmlc_tpu_torch.io import block_cache as bc
from dmlc_tpu_torch.io import resilience
from dmlc_tpu_torch.io.snapshot import SnapshotReader
from dmlc_tpu_torch.io.threaded_iter import OrderedWorkerPool
from dmlc_tpu_torch.io.uri import URISpec
from dmlc_tpu_torch.store import STORE_DIRNAME
from dmlc_tpu_torch.utils import knobs
from dmlc_tpu_torch.utils.check import DMLCError

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_block_cache import GOLDEN, _golden_blocks  # noqa: E402

NUM_COL, BATCH, CHUNK = 6, 64, 4096


@pytest.fixture(autouse=True)
def _registry_stack(monkeypatch):
    """These cases hold the registry stack of ``create_parser`` (the split,
    the text parsers and their threaded wrappers) against the JAX package's
    Python chain. A plain local file now goes to the fused native reader,
    as in the JAX package, whose own tests reach the registry stack the
    same way; the reader has its own suite (test_torch_native_reader.py)."""
    monkeypatch.setenv("DMLC_TPU_NO_NATIVE_READER", "1")


def _corpus(tmp_path, n=900, name="bc.libsvm"):
    rng = np.random.default_rng(12)
    path = tmp_path / name
    with open(path, "w") as f:
        for i in range(n):
            feats = " ".join(f"{j}:{rng.normal():.5f}" for j in range(NUM_COL))
            f.write(f"{i % 2} {feats}\n")
    return str(path)


def _jax(path, cache=None, **kw):
    kw.setdefault("chunk_bytes", CHUNK)
    uri = path + ("&" if "?" in path else "?") + "engine=python"
    return jax_create_parser(uri, 0, 1, "libsvm", threaded=True,
                             parse_workers=1, block_cache=cache, **kw)


def _port(path, cache=None, **kw):
    kw.setdefault("chunk_bytes", CHUNK)
    kw.setdefault("parse_workers", 1)
    return create_parser(path, 0, 1, "libsvm", block_cache=cache, **kw)


def _block_bytes(b) -> bytes:
    return b"".join(np.asarray(a).tobytes() for a in (
        b.offset, b.label, np.asarray(b.index).astype(np.uint64), b.value))


def _js(state) -> str:
    return json.dumps(state, sort_keys=True)


def _drain(parser, n=None):
    out = []
    while n is None or len(out) < n:
        b = parser.next_block()
        if b is None:
            break
        out.append((_block_bytes(b), _js(getattr(b, "resume_state", None))))
    return out


def _batch_bytes(batch) -> list:
    arrays = [batch.packed, *batch] if hasattr(batch, "packed") else list(batch)
    return [(a.contiguous().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)).tobytes()
            for a in arrays]


def _cache_events(delta) -> dict:
    return {k: v for k, v in delta.items() if k.startswith("cache_") and v}


# ---------------- the format ----------------

def test_writer_reproduces_the_golden_file(tmp_path):
    rebuilt = str(tmp_path / "rebuilt.golden")
    w = bc.BlockCacheWriter(rebuilt, signature={"pinned": "blockcache-v1-golden"})
    for segments, rows, num_col, resume in _golden_blocks():
        w.add_block(segments, rows=rows, num_col=num_col, resume=resume)
    w.finish()
    with open(GOLDEN, "rb") as f:
        want = f.read()
    with open(rebuilt, "rb") as f:
        assert f.read() == want
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    r = bc.BlockCacheReader(GOLDEN, signature={"pinned": "blockcache-v1-golden"})
    assert (r.num_blocks, r.num_col, r.rows) == (2, 10, 3)
    for i, (segments, rows, _, resume) in enumerate(_golden_blocks()):
        got = r.load_segments(i)
        assert set(got) == {k for k, v in segments.items() if v is not None}
        for name, arr in got.items():
            assert arr.dtype == segments[name].dtype and arr.tobytes() == segments[name].tobytes()
            assert not arr.flags.writeable  # zero-copy mmap views
        copied = r.load_segments(i, copy=True)
        assert all(a.flags.writeable for a in copied.values())
        assert r.block_rows(i) == rows and r.resume(i) == resume
    blk = RowBlock.from_segments(r.load_segments(1), hold=r.hold)
    assert len(blk) == 1 and blk.index.dtype == np.uint32
    # block 0 is a libfm block: its field segment rides through
    blk = RowBlock.from_segments(r.load_segments(0), hold=r.hold)
    assert blk.field.tobytes() == _golden_blocks()[0][0]["field"].tobytes()
    r.close()
    # an aborted writer leaves nothing behind but the store's sidecar
    w = bc.BlockCacheWriter(str(tmp_path / "aborted"))
    w.add_block(_golden_blocks()[1][0], rows=1)
    w.abort()
    assert sorted(os.listdir(tmp_path)) == [STORE_DIRNAME, "rebuilt.golden"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_of_either_package_serves_warm_in_the_other(tmp_path, writer):
    path = _corpus(tmp_path)
    cache = str(tmp_path / "c.bc")
    first, second = (_jax, _port) if writer == "jax" else (_port, _jax)
    cold = first(path, cache)
    want = _drain(cold)
    cold.close()
    warm = second(path, cache)
    assert warm.cache_state == "warm"
    assert _drain(warm) == want
    warm.close()
    # both packages write the same bytes for the same corpus and settings
    other = str(tmp_path / "other.bc")
    p = second(path, other)
    _drain(p)
    p.close()
    with open(cache, "rb") as f, open(other, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("change", ["source", "chunk_bytes", "args"])
def test_a_changed_source_or_config_runs_cold(tmp_path, change):
    path = _corpus(tmp_path)
    counts = []
    for make, events in ((_jax, jax_resilience), (_port, resilience)):
        cache = str(tmp_path / f"{make.__name__}.bc")
        p = make(path, cache)
        _drain(p)
        p.before_first()
        assert p.cache_state == "warm"
        p.close()
        if change == "source":
            os.utime(path, ns=(1, os.stat(path).st_mtime_ns + 1000))
        base = events.counters_snapshot()
        kw = {"chunk_bytes": 2 * CHUNK} if change == "chunk_bytes" else {}
        uri = path + "?indexing_mode=0" if change == "args" else path
        p = make(uri, cache, **kw)
        assert p.cache_state == "cold"
        assert _drain(p)
        p.before_first()
        assert p.cache_state == "warm"  # republished under the new signature
        p.close()
        counts.append(_cache_events(events.counters_delta(base)))
    assert counts[1] == counts[0] == {"cache_invalidations": 1}


def _flip(cache: str, block: int) -> None:
    """Flip one byte inside ``block``'s segments."""
    r = bc.BlockCacheReader(cache)
    pos = int(r._blocks[block]["pos"]) + 8
    r.close()
    with open(cache, "r+b") as f:
        f.seek(pos)
        byte = f.read(1)
        f.seek(pos)
        f.write(bytes([byte[0] ^ 0x55]))


@pytest.mark.parametrize("kw", [{}, dict(shuffle_seed=3, shuffle_window=16)],
                         ids=["sequential", "plan"])
def test_a_corrupt_block_heals_as_in_the_reference(tmp_path, kw):
    """A byte flipped in block 2 of a published cache: a fresh pipeline
    opens it warm (the footer is intact), meets the crc mismatch, heals
    (sequential: re-parse and rewrite; plan: one silent rebuild), and
    delivers the stream a clean cache gives, with the JAX package's
    counters; the next epoch reads the rewritten cache."""
    path = _corpus(tmp_path)
    results = []
    for make, events in ((_jax, jax_resilience), (_port, resilience)):
        cache = str(tmp_path / f"{make.__name__}.bc")
        p = make(path, cache, **kw)
        _drain(p)                  # the cold pass publishes
        p.close()
        p = make(path, cache, **kw)
        clean = _drain(p)          # a fresh pipeline's warm epoch 0
        p.close()
        _flip(cache, 2)
        base = events.counters_snapshot()
        p = make(path, cache, **kw)
        assert p.cache_state == "warm"
        healed = _drain(p)
        delta = _cache_events(events.counters_delta(base))
        p.before_first()
        assert p.cache_state == "warm"
        nxt = _drain(p)
        p.close()
        assert healed == clean
        results.append((healed, delta, nxt))
    assert results[1] == results[0]
    assert results[1][1] == {"cache_corruptions": 1, "cache_rebuilds": 1}


# ---------------- DeviceIter over the planned cache ----------------

PLAN = dict(shuffle_seed=2, shuffle_window=8)
ELL = dict(num_col=NUM_COL, batch_size=BATCH, layout="ell", max_nnz=NUM_COL)


def _jax_iter(path, cache, snapshot=None, **kw):
    src = _jax(path, cache, snapshot=snapshot, **({} if snapshot else PLAN))
    return JaxDeviceIter(src, **ELL, **kw)


def _port_iter(path, cache, snapshot=None, **kw):
    src = _port(path, cache, snapshot=snapshot, **({} if snapshot else PLAN))
    return DeviceIter(src, **ELL, device="cpu", **kw)


def _batches(it, n=None):
    out = []
    for batch in it:
        out.append(_batch_bytes(batch))
        if n is not None and len(out) == n:
            break
    return out


def test_device_iter_states_over_the_planned_cache_equal_the_reference(tmp_path):
    path = _corpus(tmp_path)
    jit, pit = _jax_iter(path, str(tmp_path / "j.bc")), _port_iter(path, str(tmp_path / "p.bc"))
    for ep in range(3):
        assert _js(pit.state_dict()) == _js(jit.state_dict())
        n = 0
        for jb, pb in zip(jit, pit):
            assert _batch_bytes(pb) == _batch_bytes(jb)
            assert _js(pit.state_dict()) == _js(jit.state_dict())
            n += 1
        stats = pit.stats()
        assert n == -(-900 // BATCH)
        assert stats["cache_state"] == ("cold" if ep == 0 else "warm")
        assert (stats["shuffle_seed"], stats["epoch"]) == (2, ep)
        assert stats["shuffle_seed"] == jit.stats()["shuffle_seed"]
        assert stats["epoch"] == jit.stats()["epoch"]
        assert stats["input_wait_seconds"] >= 0.0
        if ep:
            state = pit.state_dict()
            assert state["kind"] == "source" and state["source"]["kind"] == "epoch_plan"
        jit.reset()
        pit.reset()
    jit.close()
    pit.close()


@pytest.mark.parametrize("origin", ["jax", "port"])
@pytest.mark.parametrize("at", [1, 5])
def test_device_iter_plan_state_restores_across_packages(tmp_path, origin, at):
    """A state taken ``at`` batches into the first warm planned epoch,
    restored into a fresh pipeline of each package over its own cache: the
    remaining batches are byte-equal to the uninterrupted run's."""
    path = _corpus(tmp_path)
    src = (_jax_iter if origin == "jax" else _port_iter)(path, str(tmp_path / "src.bc"))
    _batches(src)
    src.reset()
    _batches(src, at)
    state = json.loads(_js(src.state_dict()))
    assert state["kind"] == "source" and state["source"]["epoch"] == 1
    rest = _batches(src)
    src.close()
    for make, name in ((_jax_iter, "j.bc"), (_port_iter, "p.bc")):
        build = make(path, str(tmp_path / name))
        _batches(build)            # this package's own cache
        build.close()
        dst = make(path, str(tmp_path / name))
        dst.load_state(state)
        assert _batches(dst) == rest
        dst.close()


# ---------------- shuffled snapshot epochs ----------------

@pytest.mark.parametrize("device_decode", [False, True])
def test_snapshot_shuffle_order_and_states_equal_the_reference(tmp_path, device_decode):
    path = _corpus(tmp_path)
    snap_j, snap_p = str(tmp_path / "j.snap"), str(tmp_path / "p.snap")
    jit = _jax_iter(path, None, snapshot=snap_j, snapshot_shuffle_seed=4)
    pit = _port_iter(path, None, snapshot=snap_p, snapshot_shuffle_seed=4,
                     device_decode=device_decode)
    sequential = None
    for ep in range(3):
        got = []
        for jb, pb in zip(jit, pit):
            got.append(_batch_bytes(pb))
            assert got[-1] == _batch_bytes(jb)
            assert _js(pit.state_dict()) == _js(jit.state_dict())
        st = pit.stats()
        assert (st["snapshot_seed"], st["snapshot_epoch"]) == (4, ep)
        assert st["snapshot_state"] == ("cold" if ep == 0 else "warm")
        if ep == 0:
            sequential = got     # the cold epoch is the stored order
        else:
            order = jax_epoch.block_permutation(4, ep, len(sequential))
            assert got == [sequential[i] for i in order]
            assert pit.state_dict()["source"] == {
                "kind": "epoch_plan", "seed": 4, "window": 0, "epoch": ep,
                "pos": len(got), "host_id": 0, "num_hosts": 1, "unit": "batch"}
        jit.reset()
        pit.reset()
    jit.close()
    pit.close()
    with open(snap_j, "rb") as f, open(snap_p, "rb") as g:
        assert f.read() == g.read()
    assert SnapshotReader(snap_p).num_batches == len(sequential)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("vanished", [False, True])
def test_snapshot_batch_state_restores_across_packages(tmp_path, direction, vanished):
    """A ``unit="batch"`` state taken 4 batches into a shuffled warm epoch
    restores in a fresh pipeline of the other package (seed and epoch
    adopted) to byte-equal batches; with the snapshot deleted it is
    rebuilt first."""
    path = _corpus(tmp_path)
    make_src, make_dst = ((_jax_iter, _port_iter) if direction == "jax_to_port"
                          else (_port_iter, _jax_iter))
    src = make_src(path, None, snapshot=str(tmp_path / "src.snap"), snapshot_shuffle_seed=9)
    _batches(src)
    src.reset()
    _batches(src)
    src.reset()
    _batches(src, 4)
    state = json.loads(_js(src.state_dict()))
    assert state["source"]["unit"] == "batch" and state["source"]["epoch"] == 2
    rest = _batches(src)
    src.close()
    snap = str(tmp_path / "dst.snap")
    if not vanished:
        build = make_dst(path, None, snapshot=snap)
        _batches(build)
        build.close()
    dst = make_dst(path, None, snapshot=snap)   # built with no seed: the state's wins
    dst.load_state(state)
    assert os.path.exists(snap)
    assert _batches(dst) == rest
    dst.close()


def test_snapshot_over_a_seeded_source_raises_as_in_the_reference(tmp_path):
    path = _corpus(tmp_path)
    errors = []
    for make, it_cls, kw, err in (
            (_jax, JaxDeviceIter, {}, JaxDMLCError),
            (_port, DeviceIter, {"device": "cpu"}, DMLCError)):
        src = make(path, str(tmp_path / f"{make.__name__}.bc"), shuffle_seed=1)
        with pytest.raises(err) as exc:
            it_cls(src, **ELL, snapshot=str(tmp_path / "x.snap"), **kw)
        errors.append(str(exc.value))
        src.close()
    assert errors[1] == errors[0]


# ---------------- create_parser: checks, fragment, env directory ----------------

CHECKS = {
    "seed_without_cache": dict(shuffle_seed=1),
    "window_without_cache": dict(shuffle_window=4),
    "sharding_without_cache": dict(pod_sharding=(0, 2)),
    "window_without_seed": dict(block_cache="CACHE", shuffle_window=4),
    "sharding_with_num_parts": dict(block_cache="CACHE", pod_sharding=True, num_parts=2),
    "snapshot_with_seed": dict(block_cache="CACHE", snapshot="SNAP", shuffle_seed=1),
}


@pytest.mark.parametrize("case", sorted(CHECKS))
def test_create_parser_checks_and_messages(tmp_path, case):
    path = _corpus(tmp_path)
    kw = dict(CHECKS[case])
    nparts = kw.pop("num_parts", 1)
    for key, name in (("block_cache", "c.bc"), ("snapshot", "s.snap")):
        if key in kw:
            kw[key] = str(tmp_path / name)
    with pytest.raises(JaxDMLCError) as want:
        jax_create_parser(path, 0, nparts, "libsvm", **kw)
    with pytest.raises(DMLCError) as got:
        create_parser(path, 0, nparts, "libsvm", **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("nparts", [1, 2])
def test_blockcache_fragment_and_env_directory(tmp_path, monkeypatch, nparts):
    path = _corpus(tmp_path)
    frag = str(tmp_path / "frag.bc")
    pairs = [(jax_create_parser(f"{path}#blockcache={frag}", 0, nparts, "libsvm"),
              create_parser(f"{path}#blockcache={frag}", 0, nparts, "libsvm"))]
    monkeypatch.setenv("DMLC_TPU_BLOCK_CACHE", str(tmp_path / "env"))
    pairs.append((jax_create_parser(path + "?indexing_mode=0", 0, nparts, "libsvm"),
                  create_parser(path + "?indexing_mode=0", 0, nparts, "libsvm")))
    # the explicit knob wins over the fragment and the directory
    pairs.append((jax_create_parser(f"{path}#blockcache={frag}", 0, nparts, "libsvm",
                                    block_cache=str(tmp_path / "knob.bc")),
                  create_parser(f"{path}#blockcache={frag}", 0, nparts, "libsvm",
                                block_cache=str(tmp_path / "knob.bc"))))
    for jp, pp in pairs:
        assert pp.cache_file == jp.cache_file
        # blocks only: the JAX package's default (native) reader annotates none
        assert [raw for raw, _ in _drain(pp)] == [raw for raw, _ in _drain(jp)]
        jp.close()
        pp.close()
    assert pairs[1][1].cache_file.startswith(str(tmp_path / "env") + os.sep)
    assert pairs[0][1].cache_file.endswith(".split2.part0" if nparts == 2 else "frag.bc")


def test_uri_fragments():
    spec = URISpec("data.libsvm?format=libsvm#blockcache=/tmp/c.bc")
    assert (spec.uri, spec.args, spec.block_cache) == (
        "data.libsvm", {"format": "libsvm"}, "/tmp/c.bc")
    assert URISpec("data.libsvm").block_cache is None
    # the chunk cache, snapshot and service fragments are the JAX package's
    for uri in ("d#snapshot=/s", "d#cachefile", "d?format=csv#c.cache", "d#service=h:1",
                "d?job=b#service=h:1"):
        for part, nparts in ((0, 1), (1, 3)):
            got, want = URISpec(uri, part, nparts), JaxURISpec(uri, part, nparts)
            assert (got.uri, got.args, got.cache_file, got.block_cache, got.snapshot,
                    got.service) == (want.uri, want.args, want.cache_file, want.block_cache,
                                     want.snapshot, want.service)
    assert URISpec("d#cachefile", 1, 3).cache_file == "cachefile.split3.part1"
    assert URISpec("d#service=h:1").service == "h:1"
    for bad, match in (("d#service=h", "host:port"), ("d#snapshot=", "empty path"),
                       ("d#blockcache=", "empty path"), ("d#a#b", "only one")):
        with pytest.raises(DMLCError, match=match):
            URISpec(bad)


# ---------------- the plan read pool and its knob ----------------

@pytest.mark.parametrize("raw", [None, "3", "1", "0", "x"])
def test_plan_read_workers_knob_matches_the_reference(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("DMLC_TPU_PLAN_READ_WORKERS", raising=False)
    else:
        monkeypatch.setenv("DMLC_TPU_PLAN_READ_WORKERS", raw)
    try:
        want = jax_knobs.resolve("plan_read_workers")
    except JaxDMLCError:
        with pytest.raises(DMLCError):
            knobs.resolve("plan_read_workers")
        return
    assert knobs.resolve("plan_read_workers") == want
    assert knobs.resolve("plan_read_workers", 0) == jax_knobs.resolve("plan_read_workers", 0)


@pytest.mark.parametrize("workers", ["1", "4"])
def test_plan_stream_is_the_same_at_any_pool_width(tmp_path, monkeypatch, workers):
    path = _corpus(tmp_path)
    cache = str(tmp_path / "c.bc")
    ref = _jax(path, cache, **PLAN)
    _drain(ref)
    ref.before_first()
    want = _drain(ref)
    ref.close()
    monkeypatch.setenv("DMLC_TPU_PLAN_READ_WORKERS", workers)
    p = _port(path, cache, **PLAN)
    assert p.plan_read_workers == int(workers)
    p.next_block()            # epoch 0 of a fresh pipeline is warm: the plan of epoch 0
    p.before_first()
    assert _drain(p) == want
    p.close()


def test_ordered_pool_delivers_in_order_and_raises_in_place():
    """More workers than cores and a short switch interval: every item is
    delivered once, in source order, and a work error is raised at its
    item's position with nothing delivered after it."""
    import random
    import time

    def work(x):
        time.sleep(random.random() * 1e-4)
        if x == 423:
            raise ValueError("item 423")
        return x * x

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = 2 * (os.cpu_count() or 1) + 1
        pool = OrderedWorkerPool(lambda: iter(range(600)), work, num_workers=workers,
                                 max_ahead=workers)
        got = []
        with pytest.raises(ValueError, match="item 423"):
            while (v := pool.next()) is not None:
                got.append(v)
        assert got == [i * i for i in range(423)]
        assert pool.next() is None      # nothing after the failed item
        pool.destroy()
        pool = OrderedWorkerPool(lambda: iter(range(300)), lambda x: -x, num_workers=workers)
        assert list(iter(pool.next, None)) == [-i for i in range(300)]
        pool.destroy()
        assert not any(t.is_alive() for t in pool._threads)
    finally:
        sys.setswitchinterval(interval)
    with pytest.raises(DMLCError):
        pool.next()


def test_block_plan_state_goes_to_the_source_under_a_snapshot(tmp_path):
    """A sharded cache (no seed) under a snapshot: the stored batches carry
    the block cache's ``epoch_plan`` annotations. Such a state restored
    into a fresh snapshot pipeline is handed to the source, which replays
    it, and the snapshot sits out the rest of the epoch, as in the JAX
    package (it is not taken for a count of stored batches)."""
    path = _corpus(tmp_path)
    streams = []
    for make, it_cls, kw in ((_jax, JaxDeviceIter, {}), (_port, DeviceIter, {"device": "cpu"})):
        name = make.__name__

        def build():
            src = make(path, str(tmp_path / f"{name}.bc"), pod_sharding=(0, 2),
                       snapshot=str(tmp_path / f"{name}.snap"))
            return it_cls(src, **ELL, **kw)

        it = build()
        _batches(it)             # cold: the cache and the snapshot publish
        it.reset()
        _batches(it, 2)
        state = json.loads(_js(it.state_dict()))
        assert state["source"]["kind"] == "epoch_plan" and "cold" in state["source"]
        rest = _batches(it)
        it.close()
        fresh = build()
        fresh.load_state(state)
        got = _batches(fresh)
        streams.append((got, fresh.stats()["snapshot_state"], fresh.stats()["cache_state"]))
        fresh.close()
        assert got == rest
    assert streams[1] == streams[0]
    assert streams[1][1:] == ("cold", "warm")
