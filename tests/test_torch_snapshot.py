"""The port's snapshot store against dmlc_tpu.io.snapshot, byte for byte.

- The port's ``SnapshotWriter``, fed the fixture
  ``tests/data/snapshot_v1.golden`` was written from, reproduces that file
  byte for byte, and its reader decodes the file.
- A snapshot written by either package reads in the other, bfloat16
  segments included (the port resolves them without ``ml_dtypes``).
- A geometry or signature mismatch drops the file at open; a crc mismatch
  raises ``CacheCorruptionError``; an aborted writer leaves nothing.
- ``source_signature`` and ``create_parser(snapshot=)``'s stamp equal the
  JAX package's for the same corpus.
- ``verify=False`` (reader and ``open_snapshot``) and ``copy=True``
  (``load_batch``, ``batch_span``) read what the verified views read; an
  unverified reader serves a corrupt batch as it is, the bytes JAX's
  unverified reader gives, and the ``snapshot_read`` fault seam fires all
  the same. ``hold``, ``kind``, ``batch_rows``, ``SnapshotWriter.close``
  and ``io.snapshot.quantize_int8`` answer as the JAX package's.
"""

import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from dmlc_tpu.data import create_parser as jax_create_parser
from dmlc_tpu.io import block_cache as jax_bc
from dmlc_tpu.io import snapshot as jax_snapshot
from dmlc_tpu_torch.data import create_parser
from dmlc_tpu_torch.io import block_cache
from dmlc_tpu_torch.io import faults
from dmlc_tpu_torch.io import snapshot as port_snapshot
from dmlc_tpu_torch.io.snapshot import (
    SNAPSHOT_MAGIC,
    SnapshotIter,
    SnapshotReader,
    SnapshotWriter,
    open_snapshot,
)
from dmlc_tpu_torch.ops.device_decode import quantize_int8
from dmlc_tpu_torch.store import STORE_DIRNAME
from dmlc_tpu_torch.utils.check import CacheCorruptionError, DMLCError

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "snapshot_v1.golden")
GEOM = {"v": 1, "batch_size": 4, "num_col": 3, "x_dtype": "float32"}


def _golden_batches():
    """The fixture the golden file was written from (tests/test_snapshot.py),
    with the port's quantize_int8."""
    xp = np.arange(20, dtype=np.float32).reshape(4, 5)
    q, scale = quantize_int8(xp)
    ell_idx = np.array([[0, 1], [2, 3]], np.int32)
    ell_val = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    return [
        ("dense_packed", (xp,), 4,
         {"source": {"kind": "split", "chunks": 1,
                     "split": {"kind": "byte", "offset_curr": 64}},
          "skip_rows": 2}),
        ("ell", (ell_idx, ell_val, np.array([1.0, 0.0], np.float32),
                 np.array([1.0, 1.0], np.float32)), 2, None),
        ("dense_packed_q8", (q, scale), 4, None),
    ]


def _write(writer_cls, path, batches, signature, geometry=GEOM):
    w = writer_cls(path, signature=signature, geometry=geometry)
    for kind, arrays, rows, resume in batches:
        w.add_batch(kind, arrays, rows=rows, resume=resume)
    w.finish()


def test_writer_reproduces_golden_bytes(tmp_path):
    path = str(tmp_path / "rebuilt.golden")
    _write(SnapshotWriter, path, _golden_batches(), {"pinned": "snapshot-v1"})
    with open(GOLDEN, "rb") as f:
        want = f.read()
    with open(path, "rb") as f:
        got = f.read()
    assert got == want
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]


def test_reader_decodes_golden(tmp_path):
    r = SnapshotReader(GOLDEN)
    assert r.signature == {"pinned": "snapshot-v1"} and r.geometry == GEOM
    assert r.num_batches == 3 and r.rows == 10
    for i, (kind, arrays, rows, resume) in enumerate(_golden_batches()):
        got = r.load_batch(i)
        assert got[0] == kind and len(got) == 1 + len(arrays)
        for a, b in zip(got[1:], arrays):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()
            assert not a.flags.writeable  # views over the mmap
        assert r._batches[i]["rows"] == rows
        assert r.resume(i) == resume
        # the raw span holds the same segments at the layout's offsets
        k, span, layout = r.batch_span(i)
        assert k == kind and span.dtype == np.uint8
        assert span.size == r.batch_nbytes(i)
        for (name, _, off, nbytes, shape), a in zip(layout, arrays):
            assert shape == a.shape
            assert span[off: off + nbytes].tobytes() == a.tobytes()
    r.close()


def _mixed_batches():
    """Every dtype a snapshot batch carries, bfloat16 included."""
    rng = np.random.default_rng(0)
    x16 = rng.normal(size=(8, 5)).astype(np.float32).astype(ml_dtypes.bfloat16)
    return [
        ("dense_packed", (x16,), 8),
        ("ell", (rng.integers(0, 9, size=(8, 3)).astype(np.int32),
                 rng.normal(size=(8, 3)).astype(np.float32),
                 rng.normal(size=8).astype(np.float32),
                 np.ones(8, np.float32)), 8),
        ("dense_packed_q8", quantize_int8(rng.normal(size=(8, 4))), 8),
    ]


def test_port_reads_jax_written_snapshot(tmp_path):
    path = str(tmp_path / "jax.snap")
    w = jax_snapshot.SnapshotWriter(path, signature={"s": 1}, geometry=GEOM)
    for kind, arrays, rows in _mixed_batches():
        w.add_batch(kind, arrays, rows=rows)
    w.finish()
    r = open_snapshot(path, signature={"s": 1}, geometry=GEOM)
    assert r is not None
    for i, (kind, arrays, _) in enumerate(_mixed_batches()):
        got = r.load_batch(i)
        assert got[0] == kind
        for a, b in zip(got[1:], arrays):
            assert a.shape == b.shape and a.tobytes() == b.tobytes()
    # the bfloat16 segment reads as uint16 words under its stored name
    assert r.load_batch(0)[1].dtype == np.uint16
    assert r.layout(0)[0][1] == "bfloat16"
    r.close()


def test_jax_reads_port_written_snapshot(tmp_path):
    path = str(tmp_path / "port.snap")
    w = SnapshotWriter(path, signature={"s": 1}, geometry=GEOM)
    for kind, arrays, rows in _mixed_batches():
        if kind == "dense_packed":  # the port's bf16 arrays are tensors
            arrays = (torch.from_numpy(arrays[0].view(np.int16)).view(torch.bfloat16),)
        w.add_batch(kind, arrays, rows=rows)
    w.finish()
    r = jax_snapshot.open_snapshot(path, signature={"s": 1}, geometry=GEOM)
    assert r is not None
    for i, (kind, arrays, _) in enumerate(_mixed_batches()):
        got = r.load_batch(i)
        assert got[0] == kind
        for a, b in zip(got[1:], arrays):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()
    r.close()


@pytest.mark.parametrize("drift", [
    {"geometry": dict(GEOM, batch_size=8)},
    {"geometry": dict(GEOM, x_dtype="bfloat16")},
    {"geometry": dict(GEOM, num_col=4)},
    {"signature": {"pinned": "other"}},
])
def test_mismatch_self_invalidates(tmp_path, drift):
    path = str(tmp_path / "s.snap")
    _write(SnapshotWriter, path, _golden_batches(), {"pinned": "snapshot-v1"})
    kw = {"signature": {"pinned": "snapshot-v1"}, "geometry": GEOM, **drift}
    with pytest.raises(DMLCError, match="mismatch"):
        SnapshotReader(path, **kw)
    assert os.path.exists(path)
    assert open_snapshot(path, **kw) is None
    assert not os.path.exists(path)  # the stale file is dropped


def test_truncated_file_is_dropped(tmp_path):
    path = str(tmp_path / "t.snap")
    _write(SnapshotWriter, path, _golden_batches(), {})
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 3)
    assert open_snapshot(path) is None and not os.path.exists(path)
    assert open_snapshot(str(tmp_path / "missing.snap")) is None


def test_crc_mismatch_raises(tmp_path):
    path = str(tmp_path / "c.snap")
    _write(SnapshotWriter, path, _golden_batches(), {})
    r = SnapshotReader(path)
    pos = r._batches[1]["pos"] + 70  # inside batch 1's first segment
    r.close()
    with open(path, "r+b") as f:
        f.seek(pos)
        byte = f.read(1)
        f.seek(pos)
        f.write(bytes([byte[0] ^ 0xFF]))
    r = SnapshotReader(path)
    r.load_batch(0)
    with pytest.raises(CacheCorruptionError, match="crc"):
        r.load_batch(1)
    with pytest.raises(CacheCorruptionError, match="crc"):
        r.batch_span(1)
    r.close()


def test_abort_leaves_nothing(tmp_path):
    path = str(tmp_path / "a.snap")
    w = SnapshotWriter(path, geometry=GEOM)
    w.add_batch("dense_packed", (np.zeros((4, 5), np.float32),), rows=4)
    assert os.path.exists(w.tmp_path)
    w.abort()
    assert os.listdir(tmp_path) == [STORE_DIRNAME]  # the store's sidecar only
    with pytest.raises(DMLCError, match="finished/aborted"):
        w.add_batch("dense_packed", (np.zeros((4, 5), np.float32),), rows=4)


@pytest.mark.parametrize("raw", [False, True])
def test_snapshot_iter_serves_in_order(tmp_path, raw):
    path = str(tmp_path / "i.snap")
    _write(SnapshotWriter, path, _golden_batches(), {})
    r = SnapshotReader(path)
    it = SnapshotIter(r, raw=raw)
    got = []
    while True:
        item = it.next()
        if item is None:
            break
        got.append(item)
    it.destroy()
    assert len(got) == 3
    for i, ((batch, resume, nbytes), (kind, arrays, _, want_resume)) in enumerate(
            zip(got, _golden_batches())):
        assert resume == want_resume and nbytes == r.batch_nbytes(i)
        if raw:
            assert batch[0] == "device_span" and batch[3] == kind
            assert batch[1].tobytes() == r.batch_span(i)[1].tobytes()
            assert batch[2] == r.layout(i)
        else:
            assert batch[0] == kind
            assert [a.tobytes() for a in batch[1:]] == [a.tobytes() for a in arrays]
    r.close()


def test_source_signature_matches_reference(tmp_path):
    corpus = tmp_path / "c.libsvm"
    corpus.write_text("1 0:1.5 2:2\n0 1:1\n")
    folder = tmp_path / "parts"
    folder.mkdir()
    (folder / "a.libsvm").write_text("1 0:1\n")
    (folder / "b.libsvm").write_text("0 1:1\n")
    for uri in (str(corpus), f"file://{corpus}", str(folder),
                f"{corpus};{tmp_path / 'missing.libsvm'}"):
        kw = dict(format="libsvm", args={"indexing_mode": "1"}, chunk_bytes=1 << 20)
        want = jax_bc.source_signature(uri, 1, 3, **kw)
        assert block_cache.source_signature(uri, 1, 3, **kw) == want


@pytest.mark.parametrize("uri_args,parts", [("", (0, 1)), ("?indexing_mode=0", (1, 2))])
def test_create_parser_stamp_matches_reference(tmp_path, uri_args, parts):
    corpus = tmp_path / "c.libsvm"
    corpus.write_text("1 0:1.5 2:2\n0 1:1\n")
    snap = str(tmp_path / "c.snapshot")
    uri = str(corpus) + uri_args
    got = create_parser(uri, *parts, "libsvm", snapshot=snap)
    want = jax_create_parser(uri, *parts, "libsvm", snapshot=snap)
    try:
        assert got.snapshot_path == want.snapshot_path
        assert got.snapshot_signature == want.snapshot_signature
        assert json.dumps(got.snapshot_signature, sort_keys=True) == json.dumps(
            want.snapshot_signature, sort_keys=True)
    finally:
        got.close()
        want.close()


def test_magic_and_header(tmp_path):
    path = str(tmp_path / "m.snap")
    _write(SnapshotWriter, path, _golden_batches(), {})
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == SNAPSHOT_MAGIC and data[-8:] == SNAPSHOT_MAGIC
    assert block_cache.container_header(SNAPSHOT_MAGIC, 1) == data[:16]


def _flip(path: str, pos: int) -> None:
    with open(path, "r+b") as f:
        f.seek(pos)
        byte = f.read(1)
        f.seek(pos)
        f.write(bytes([byte[0] ^ 0xFF]))


@pytest.mark.parametrize("copy", [False, True])
def test_unverified_and_copied_reads_equal_verified(tmp_path, copy):
    path = str(tmp_path / "v.snap")
    _write(SnapshotWriter, path, _golden_batches(), {"pinned": "snapshot-v1"})
    ref = SnapshotReader(path)
    r = open_snapshot(path, signature={"pinned": "snapshot-v1"}, geometry=GEOM, verify=False)
    j = jax_snapshot.open_snapshot(path, verify=False)
    assert r.verify is False and ref.verify is True
    for i in range(ref.num_batches):
        want = ref.load_batch(i)
        got = r.load_batch(i, copy=copy)
        jgot = j.load_batch(i, copy=copy)
        assert got[0] == want[0] == jgot[0]
        for a, b, c in zip(got[1:], want[1:], jgot[1:]):
            assert a.tobytes() == b.tobytes() == c.tobytes() and a.shape == b.shape
            # a copy is the process's own, writable; a view stays read-only
            assert a.flags.writeable == copy == c.flags.writeable
        kind, span, layout = r.batch_span(i, copy=copy)
        jkind, jspan, _ = j.batch_span(i, copy=copy)
        assert kind == jkind and layout == ref.layout(i)
        assert span.tobytes() == jspan.tobytes() == ref.batch_span(i)[1].tobytes()
        assert span.flags.writeable == copy
    for reader in (ref, r, j):
        reader.close()


def test_unverified_reader_serves_a_corrupt_batch_as_jax_does(tmp_path):
    path = str(tmp_path / "c.snap")
    _write(SnapshotWriter, path, _golden_batches(), {})
    probe = SnapshotReader(path)
    pos = int(probe._batches[1]["arrays"]["a0"][1]) + 1  # batch 1's first segment
    probe.close()
    _flip(path, pos)
    verified, jverified = SnapshotReader(path), jax_snapshot.SnapshotReader(path)
    r = SnapshotReader(path, verify=False)
    j = jax_snapshot.SnapshotReader(path, verify=False)
    for reader, err in ((verified, CacheCorruptionError), (jverified, Exception)):
        with pytest.raises(err, match="crc"):
            reader.load_batch(1)
    got, want = r.load_batch(1), j.load_batch(1)
    assert [a.tobytes() for a in got[1:]] == [a.tobytes() for a in want[1:]]
    assert got[1].tobytes() != _golden_batches()[1][1][0].tobytes()  # no heal
    assert r.batch_span(1)[1].tobytes() == j.batch_span(1)[1].tobytes()
    # the fault seam fires on an unverified read too, as in JAX
    with faults.inject("snapshot_read@1=corrupt"):
        with pytest.raises(CacheCorruptionError):
            r.load_batch(0)
    for reader in (verified, jverified, r, j):
        reader.close()


def test_reader_accessors_and_writer_close_match_reference(tmp_path):
    r, j = SnapshotReader(GOLDEN), jax_snapshot.SnapshotReader(GOLDEN)
    assert r.hold is r._mm and j.hold is j._mm
    for i in range(r.num_batches):
        assert r.kind(i) == j.kind(i) == _golden_batches()[i][0]
        assert r.batch_rows(i) == j.batch_rows(i) == _golden_batches()[i][2]
    r.close()
    j.close()
    # close() aborts an unfinished writer and leaves a finished one published
    for writer_cls in (SnapshotWriter, jax_snapshot.SnapshotWriter):
        open_w = writer_cls(str(tmp_path / f"{writer_cls.__module__}.open"), geometry=GEOM)
        open_w.add_batch("dense_packed", (np.zeros((4, 5), np.float32),), rows=4)
        open_w.close()
        assert not os.path.exists(open_w.tmp_path) and not os.path.exists(open_w.path)
        done = writer_cls(str(tmp_path / f"{writer_cls.__module__}.done"), geometry=GEOM)
        done.add_batch("dense_packed", (np.zeros((4, 5), np.float32),), rows=4)
        done.finish()
        done.close()
        assert os.path.exists(done.path)
    q, scale = port_snapshot.quantize_int8(np.arange(12, dtype=np.float32).reshape(3, 4) - 5)
    jq, jscale = jax_snapshot.quantize_int8(np.arange(12, dtype=np.float32).reshape(3, 4) - 5)
    assert q.tobytes() == np.asarray(jq).tobytes() and scale.tobytes() == np.asarray(jscale).tobytes()
