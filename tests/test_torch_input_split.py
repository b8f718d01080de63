"""The port's split layer (``dmlc_tpu_torch.io.input_split``,
``dmlc_tpu_torch.io.recordio``) against the JAX package's.

- ``create_input_split`` for every type (``text``, ``recordio``,
  ``indexed_recordio`` with and without shuffle, ``stdin``) at 1, 2 and 3
  parts and two chunk sizes, threaded and not: the chunks, the records and
  the states after each chunk equal the JAX package's (the JAX side with
  ``?engine=python``, as its own tests reach its Python splitters; its
  native engines give the same records);
- ``ThreadedInputSplit``'s ``chunk_resume_state`` and
  ``ShuffledInputSplit``'s chunk order over two epochs equal the JAX
  decorators'; states restore across the packages both ways;
- ``create_parser(**split_kw)`` blocks equal the JAX package's (the
  shuffle decorator, ``recurse_directories``, a ``#cachefile``), and with
  a block cache the legacy ``shuffle`` / ``num_shuffle_parts`` / ``seed``
  mapping warns as the JAX package does and sets the same plan and
  signature;
- RecordIO: the writer's bytes, the index files, the readers, the head
  scan and the chunk reader equal the JAX module's;
- the constructors take the JAX package's positions (``fs`` first, no
  partition until ``reset_partition``), driven by the JAX tests' own
  calls, and ``records_in_chunk`` splits a chunk into the JAX package's
  records on the three splitter kinds.

Everything runs on the CPU at a small size.
"""

import io
import json
import sys
import warnings

import numpy as np
import pytest

from dmlc_tpu.data import create_parser as jax_create_parser
from dmlc_tpu.io import create_input_split as jax_create_input_split
from dmlc_tpu.io import get_filesystem as jax_get_filesystem
from dmlc_tpu.io import input_split as jax_split
from dmlc_tpu.io import recordio as jax_rio
from dmlc_tpu.io.input_split import ShuffledInputSplit as JaxShuffledInputSplit
from dmlc_tpu.io.input_split import ThreadedInputSplit as JaxThreadedInputSplit
from dmlc_tpu.store import manager as jax_mgr
from dmlc_tpu_torch.data import create_parser
from dmlc_tpu_torch.io import (IndexedRecordIOSplitter, LineSplitter, MmapLineSplit,
                               RecordIOSplitter, ShuffledInputSplit, SingleFileSplit,
                               ThreadedInputSplit, create_input_split)
from dmlc_tpu_torch.io.filesystem import get_filesystem
from dmlc_tpu_torch.io.input_split import create_mmap_text_split
from dmlc_tpu_torch.io import recordio as rio
from dmlc_tpu_torch.store import manager as port_mgr
from dmlc_tpu_torch.utils.check import DMLCError

PY = "?engine=python"


@pytest.fixture(autouse=True)
def _registry_stack(monkeypatch):
    """Both packages' Python chains (the JAX package's native engines give
    the same records, not always the same chunk grouping)."""
    monkeypatch.setenv("DMLC_TPU_NO_NATIVE_READER", "1")
    jax_mgr.reset_stores()
    port_mgr.reset_stores()
    yield
    jax_mgr.reset_stores()
    port_mgr.reset_stores()


def _text(tmp_path, n=700, name="c.libsvm"):
    rng = np.random.default_rng(11)
    with open(tmp_path / name, "w") as f:
        for i in range(n):
            k = int(rng.integers(1, 7))
            feats = " ".join(f"{j}:{rng.random():.3f}" for j in sorted(
                rng.choice(25, size=k, replace=False)))
            f.write(f"{i % 2} {feats}\n" if i % 50 else f"{i % 2} {feats}\r\n\n")
    return str(tmp_path / name)


def _records(n=260, seed=12):
    rng = np.random.default_rng(seed)
    magic = rio.RECORDIO_MAGIC.to_bytes(4, "little")
    out = []
    for i in range(n):
        rec = rng.bytes(int(rng.integers(0, 120)))
        if i % 13 == 0:
            rec = rec[:8] + magic + rec[8:] + magic  # escaped multi-part records
        out.append(rec)
    return out


def _recordio(tmp_path, name="c.rec", index=False):
    recs = _records()
    data, idx = io.BytesIO(), io.StringIO()
    if index:
        rio.write_indexed_recordio(data, idx, recs)
        with open(tmp_path / (name + ".idx"), "w") as f:
            f.write(idx.getvalue())
    else:
        w = rio.RecordIOWriter(data)
        for r in recs:
            w.write_record(r)
    with open(tmp_path / name, "wb") as f:
        f.write(data.getvalue())
    return str(tmp_path / name), recs


def _source(tmp_path, kind):
    """``(uri, type_, kw)`` of a corpus of ``kind``."""
    if kind == "text":
        return _text(tmp_path), "text", {}
    if kind == "recordio":
        return _recordio(tmp_path)[0], "recordio", {}
    path, _ = _recordio(tmp_path, index=True)
    kw = {"index_uri": path + ".idx", "batch_size": 7}
    if kind == "indexed_shuffle":
        kw.update(shuffle=True, seed=5)
    return path, "indexed_recordio", kw


def _walk(split):
    """Chunks with the split's position after each, then the records of a
    rewound pass."""
    chunks = []
    while (c := split.next_chunk()) is not None:
        st = getattr(split, "chunk_resume_state", None)
        chunks.append((bytes(c), json.dumps(st, sort_keys=True)))
    split.before_first()
    recs = [bytes(r) for r in split.iter_records()]
    split.close()
    return chunks, recs


KINDS = ["text", "recordio", "indexed", "indexed_shuffle"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("nparts", [1, 2, 3])
@pytest.mark.parametrize("chunk", [4096, 1 << 16])
@pytest.mark.parametrize("threaded", [False, True])
def test_create_input_split_matches_reference(tmp_path, kind, nparts, chunk, threaded):
    uri, type_, kw = _source(tmp_path, kind)
    all_recs = []
    for part in range(nparts):
        got = _walk(create_input_split(uri + PY, part, nparts, type_, threaded=threaded,
                                       chunk_bytes=chunk, **kw))
        want = _walk(jax_create_input_split(uri + PY, part, nparts, type_,
                                            threaded=threaded, chunk_bytes=chunk, **kw))
        assert got == want
        all_recs += got[1]
    if kind != "text":
        recs = _records()
        assert sorted(all_recs) == sorted(recs)  # each record in exactly one part
        if kind in ("recordio", "indexed"):
            assert all_recs == recs


@pytest.mark.parametrize("kind", ["text", "recordio"])
def test_threaded_split_states_restore_across_packages(tmp_path, kind):
    """A ThreadedInputSplit's state after chunk k, restored into a fresh
    split of the other package, gives the same remaining chunks."""
    uri, type_, kw = _source(tmp_path, kind)
    make = {"port": lambda: create_input_split(uri, 0, 1, type_, chunk_bytes=4096),
            "jax": lambda: jax_create_input_split(uri + PY, 0, 1, type_, chunk_bytes=4096)}
    ref = make["jax"]()
    assert isinstance(ref, JaxThreadedInputSplit)
    chunks, states = [], []
    while (c := ref.next_chunk()) is not None:
        chunks.append(bytes(c))
        states.append(ref.chunk_resume_state)
    ref.close()
    assert len(chunks) > 4
    for k in (0, 2, len(chunks) - 1):
        for pkg in ("port", "jax"):
            split = make[pkg]()
            split.load_state(json.loads(json.dumps(states[k])))
            rest = [bytes(c) for c in split.iter_chunks()]
            split.close()
            assert rest == chunks[k + 1:], (pkg, k)
    port = make["port"]()
    assert isinstance(port, ThreadedInputSplit) and port.chunk_resume_state is None
    got = [(bytes(c), port.chunk_resume_state) for c in port.iter_chunks()]
    port.close()
    assert got == list(zip(chunks, states))


def test_indexed_states_restore_across_packages(tmp_path):
    uri, type_, kw = _source(tmp_path, "indexed_shuffle")
    splits = {
        "port": lambda: create_input_split(uri, 1, 2, type_, threaded=False, **kw),
        "jax": lambda: jax_create_input_split(uri + PY, 1, 2, type_, threaded=False, **kw)}
    ref = splits["jax"]()
    for _ in range(3):
        ref.next_chunk()
    state = json.loads(json.dumps(ref.state_dict()))
    rest = [bytes(c) for c in ref.iter_chunks()]
    ref.close()
    port = splits["port"]()
    assert isinstance(port, IndexedRecordIOSplitter) and port.cheap_chunk_state is False
    port.load_state(state)
    assert [bytes(c) for c in port.iter_chunks()] == rest
    port.close()
    # a threaded indexed split hands out no per-chunk state (count resume)
    threaded = create_input_split(uri, 0, 1, type_, **kw)
    threaded.next_chunk()
    assert threaded.chunk_resume_state is None
    threaded.close()


@pytest.mark.parametrize("kind", ["text", "recordio", "indexed"])
@pytest.mark.parametrize("num_shuffle_parts,seed", [(2, 0), (4, 3), (5, 11)])
@pytest.mark.parametrize("nparts", [1, 2])
def test_shuffled_split_order_matches_reference(tmp_path, kind, num_shuffle_parts, seed,
                                                nparts):
    uri, type_, kw = _source(tmp_path, kind)
    kw = {k: v for k, v in kw.items() if k not in ("shuffle", "seed")}
    for part in range(nparts):
        out = {}
        for pkg, factory in (("port", create_input_split), ("jax", jax_create_input_split)):
            split = factory(uri + PY, part, nparts, type_, num_shuffle_parts=num_shuffle_parts,
                            seed=seed, chunk_bytes=4096, **kw)
            epochs = []
            for _ in range(2):
                epochs.append([bytes(c) for c in split.iter_chunks()])
                split.before_first()
            epochs.append([bytes(r) for r in split.iter_records()])
            split.close()
            out[pkg] = (epochs, getattr(split, "_order", None))
        assert isinstance(split, JaxShuffledInputSplit)
        assert out["port"] == out["jax"]
        assert out["port"][0][0] != out["port"][0][1] or num_shuffle_parts == 2


def test_single_file_and_stdin_splits_match_reference(tmp_path, monkeypatch):
    path = _text(tmp_path)
    got = [bytes(r) for r in create_input_split(path, 0, 1, "stdin").iter_records()]
    want = [bytes(r) for r in jax_create_input_split(path, 0, 1, "stdin").iter_records()]
    assert got == want and len(got) == 700
    split = SingleFileSplit(path, chunk_bytes=4096)
    chunks = [bytes(c) for c in split.iter_chunks()]
    assert b"".join(chunks) == open(path, "rb").read() and len(chunks) > 3
    with pytest.raises(DMLCError, match="partitioning"):
        split.reset_partition(1, 2)

    class _Stdin:
        def __init__(self, data):
            self.buffer = io.BytesIO(data)

    data = open(path, "rb").read()
    for factory in (create_input_split, jax_create_input_split):
        monkeypatch.setattr(sys, "stdin", _Stdin(data))
        split = factory("stdin", 0, 1)
        assert [bytes(r) for r in split.iter_records()] == got
        with pytest.raises(Exception, match="single-pass"):
            split.before_first()


def test_file_matching_matches_reference(tmp_path):
    """';' lists, directories (recursive or not), regex basenames and
    empty files match the JAX splitter's file lists."""
    d = tmp_path / "d"
    (d / "sub").mkdir(parents=True)
    for name, n in (("a.txt", 30), ("b.txt", 20), ("sub/c.txt", 10)):
        with open(d / name, "w") as f:
            f.writelines(f"{name} {i}\n" for i in range(n))
    (d / "empty.txt").write_text("")
    for uri, recurse in ((str(d), False), (str(d), True), (f"{d}/a.txt;{d}/sub/c.txt", False),
                         (f"{d}/[ab]\\.txt", False)):
        got = create_input_split(uri, 0, 1, "text", threaded=False, recurse_directories=recurse)
        want = jax_create_input_split(uri, 0, 1, "text", threaded=False,
                                      recurse_directories=recurse)
        assert [f.path.name for f in got.files] == [f.path.name for f in want.files]
        assert [bytes(r) for r in got.iter_records()] == [bytes(r) for r in want.iter_records()]
    with pytest.raises(DMLCError, match="Cannot find any files"):
        create_input_split(str(d / "nothing.txt"), 0, 1, "text")
    with pytest.raises(DMLCError, match="unknown input split type"):
        create_input_split(str(d), 0, 1, "parquet")
    with pytest.raises(DMLCError, match="requires index_uri"):
        create_input_split(str(d), 0, 1, "indexed_recordio")
    with pytest.raises(DMLCError, match="cannot be combined"):
        create_input_split(f"{d}#c.cache", 0, 1, "text", num_shuffle_parts=2)


def test_splitters_stay_the_line_split_it_was(tmp_path):
    """LineSplitter takes the JAX package's ``(fs, uri)`` constructor and
    keeps its kind="byte" chunks and states; the recordio splitter refuses
    unaligned files."""
    path = _text(tmp_path)
    a = LineSplitter(get_filesystem(path), path, part_index=1, num_parts=3, chunk_bytes=4096)
    b = jax_create_input_split(path, 1, 3, "text", threaded=False, chunk_bytes=4096)
    assert [(bytes(c), a.state_dict()) for c in a.iter_chunks()] == [
        (bytes(c), b.state_dict()) for c in b.iter_chunks()]
    assert a.bytes_read == b.bytes_read
    odd = tmp_path / "odd.rec"
    odd.write_bytes(b"123")
    with pytest.raises(DMLCError, match="align"):
        RecordIOSplitter(get_filesystem(str(odd)), str(odd))


# ---------------- create_parser(**split_kw) ----------------

def _blocks(parser):
    out = []
    while (b := parser.next_block()) is not None:
        out.append((np.asarray(b.offset).tobytes(), np.asarray(b.label).tobytes(),
                    np.asarray(b.index).astype(np.uint64).tobytes(),
                    np.asarray(b.value).tobytes()))
    parser.close()
    return out


@pytest.mark.parametrize("kw", [
    {"shuffle": True, "num_shuffle_parts": 4, "seed": 3},
    {"num_shuffle_parts": 3, "seed": 1},
    {"recurse_directories": True},
    {"chunk_bytes": 8192},
])
@pytest.mark.parametrize("parse_workers", [1, 3])
def test_create_parser_split_keywords_match_reference(tmp_path, kw, parse_workers):
    d = tmp_path / "data"
    (d / "more").mkdir(parents=True)
    _text(d, n=500, name="a.libsvm")
    _text(d / "more", n=300, name="b.libsvm")
    uri = str(d) if kw.get("recurse_directories") else str(d / "a.libsvm")
    kw = dict({"chunk_bytes": 4096}, **kw)
    got = _blocks(create_parser(uri, 0, 1, "libsvm", parse_workers=parse_workers, **kw))
    want = _blocks(jax_create_parser(uri + PY, 0, 1, "libsvm", parse_workers=parse_workers,
                                     **kw))
    assert got == want and len(got) >= 2
    with pytest.raises(TypeError, match="unexpected keyword"):
        create_parser(uri, 0, 1, "libsvm", shufle=True)


def test_create_parser_cachefile_matches_reference(tmp_path):
    path = _text(tmp_path)
    got = _blocks(create_parser(f"{path}#{tmp_path / 'p.cache'}", 1, 2, "libsvm",
                                chunk_bytes=4096, parse_workers=1))
    want = _blocks(jax_create_parser(f"{path}?engine=python#{tmp_path / 'j.cache'}", 1, 2,
                                     "libsvm", chunk_bytes=4096, parse_workers=1))
    assert got == want
    with open(tmp_path / "p.cache.split2.part1", "rb") as f1, \
            open(tmp_path / "j.cache.split2.part1", "rb") as f2:
        assert f1.read() == f2.read()


@pytest.mark.parametrize("kw", [
    {"shuffle": True, "num_shuffle_parts": 4, "seed": 3},
    {"num_shuffle_parts": 2, "seed": 9},
    {"shuffle": True},
    {"shuffle": True, "seed": 2, "shuffle_seed": 7, "shuffle_window": 64},
])
def test_legacy_shuffle_mapping_with_block_cache_matches_reference(tmp_path, kw):
    path = _text(tmp_path)
    out = {}
    for pkg, factory, uri in (("port", create_parser, path),
                              ("jax", jax_create_parser, path + PY)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            p = factory(uri, 0, 1, "libsvm", chunk_bytes=4096, parse_workers=1,
                        block_cache=str(tmp_path / f"{pkg}.bc"), **kw)
        dep = [w for w in caught if issubclass(w.category, DeprecationWarning)]
        assert len(dep) == 1 and "epoch plan" in str(dep[0].message)
        plan = dict(p.plan_state)
        sig = p._signature
        epochs = [_rows_of(p), _rows_of(p)]
        p.close()
        out[pkg] = (plan, sig, epochs)
    assert out["port"][0] == out["jax"][0]
    want_seed = kw.get("shuffle_seed", kw.get("seed", 0))
    assert out["port"][0]["shuffle_seed"] == want_seed
    assert out["port"][1]["config"] == out["jax"][1]["config"]
    assert out["port"][1]["config"]["split"] == {}
    assert out["port"][2] == out["jax"][2]
    # the legacy arguments leave the signature: one cache serves every seed
    assert sorted(out["port"][2][0]) == sorted(out["port"][2][1])


def _rows_of(parser):
    rows = []
    while (b := parser.next_block()) is not None:
        for i in range(len(b)):
            s, e = int(b.offset[i]), int(b.offset[i + 1])
            rows.append((float(b.label[i]), tuple(b.index[s:e].tolist()),
                         tuple(np.asarray(b.value[s:e]).tolist())))
    parser.before_first()
    return rows


def test_shuffle_without_cache_feeds_the_same_rows(tmp_path):
    path = _text(tmp_path)
    plain = sorted(_rows_of(create_parser(path, 0, 1, "libsvm", chunk_bytes=4096)))
    p = create_parser(path, 0, 1, "libsvm", chunk_bytes=4096, shuffle=True,
                      num_shuffle_parts=4, seed=3)
    assert isinstance(p.base.source, ShuffledInputSplit)
    assert p.state_dict() == {"kind": "blocks", "blocks": 0}
    first, second = _rows_of(p), _rows_of(p)
    p.close()
    assert sorted(first) == sorted(second) == plain and first != second


# ---------------- RecordIO ----------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_recordio_writer_and_index_match_reference(tmp_path, seed):
    recs = _records(120, seed=seed) + [b"", rio.RECORDIO_MAGIC.to_bytes(4, "little") * 3]
    bufs = {}
    for name, mod in (("port", rio), ("jax", jax_rio)):
        data, idx = io.BytesIO(), io.BytesIO()
        n = mod.write_indexed_recordio(data, idx, recs)
        plain = io.BytesIO()
        w = mod.RecordIOWriter(plain)
        for r in recs:
            w.write_record(r)
        bufs[name] = (n, data.getvalue(), idx.getvalue(), plain.getvalue(), w.except_counter)
    assert bufs["port"] == bufs["jax"]
    data = bufs["port"][1]
    assert list(rio.RecordIOReader(io.BytesIO(data))) == recs
    assert list(jax_rio.RecordIOReader(io.BytesIO(data))) == recs
    assert np.array_equal(rio.find_record_heads(data), jax_rio.find_record_heads(data))
    total = len(data)
    assert rio.read_index_file(io.BytesIO(bufs["port"][2]), total) == \
        jax_rio.read_index_file(io.BytesIO(bufs["port"][2]), total)
    for nparts in (1, 3):
        for part in range(nparts):
            got = [bytes(r) for r in rio.RecordIOChunkReader(data, part, nparts)]
            want = [bytes(r) for r in jax_rio.RecordIOChunkReader(data, part, nparts)]
            assert got == want
    with pytest.raises(DMLCError, match="Invalid RecordIO"):
        rio.RecordIOReader(io.BytesIO(bytes(8) + data)).next_record()
    with pytest.raises(DMLCError, match="Invalid RecordIO"):
        list(rio.RecordIOReader(io.BytesIO(data[:-4])))
    with pytest.raises(DMLCError):
        rio.read_index_file(io.BytesIO(b"0"), 10)


# ---------------- the JAX package's constructor positions ----------------

def test_mmap_resume_sweep_with_the_reference_calls(tmp_path):
    """``tests/test_io.py``'s sweep, call for call: ``MmapLineSplit(fs,
    path)`` and ``LineSplitter(fs, path)`` hold no partition until
    ``reset_partition``; a state taken after k chunks of either restores
    into a fresh ``MmapLineSplit`` to the rest of the stream, in both
    packages alike."""
    p = tmp_path / "resume.txt"
    p.write_bytes(b"a 1\nbb 22\nccc 333\ndddd 4444\ntail-without-newline")
    tails = {}
    for pkg, fs_of, mmap_cls, line_cls in (
            ("port", get_filesystem, MmapLineSplit, LineSplitter),
            ("jax", jax_get_filesystem, jax_split.MmapLineSplit, jax_split.LineSplitter)):
        fs = fs_of(str(p))
        empty = mmap_cls(fs, str(p))
        assert empty.next_chunk() is None  # no partition yet
        empty.close()

        def chunks_from(split):
            out = []
            while (c := split.next_chunk()) is not None:
                out.append(bytes(c))
            return out

        base = mmap_cls(fs, str(p))
        base._chunk_bytes = 8
        base.reset_partition(0, 1)
        full = chunks_from(base)
        base.close()
        got = []
        for k in range(len(full) + 1):
            for src_cls in (mmap_cls, line_cls):
                src = src_cls(fs, str(p))
                src._chunk_bytes = 8
                src.reset_partition(0, 1)
                for _ in range(k):
                    src.next_chunk()
                state = src.state_dict()
                src.close()
                r = mmap_cls(fs, str(p))
                r._chunk_bytes = 8
                r.reset_partition(0, 1)
                r.load_state(state)
                got.append(b"".join(chunks_from(r)))
                r.close()
        tails[pkg] = (full, got)
    assert tails["port"] == tails["jax"]
    with pytest.raises(DMLCError, match="local files"):
        MmapLineSplit(get_filesystem("mem://b/x"), "mem://b/x")


def test_indexed_splitter_with_the_reference_call(tmp_path):
    """``tests/test_concurrency.py``'s call: ``IndexedRecordIOSplitter(fs,
    uri, index_uri, batch_size=, shuffle=, seed=)`` then
    ``reset_partition``; a state restores into a splitter of another seed."""
    path, _ = _recordio(tmp_path, index=True)
    out = {}
    for pkg, fs_of, cls in (("port", get_filesystem, IndexedRecordIOSplitter),
                            ("jax", jax_get_filesystem, jax_split.IndexedRecordIOSplitter)):
        s = cls(fs_of(path), path, path + ".idx", batch_size=4, shuffle=True, seed=7)
        s.reset_partition(0, 1)
        first = [bytes(s.next_record()) for _ in range(9)]
        state = s.state_dict()
        rest = [bytes(r) for r in s.iter_records()]
        s.close()
        s2 = cls(fs_of(path), path, path + ".idx", 4, True, 999)  # positional, as JAX's
        s2.reset_partition(0, 1)
        s2.load_state(state)
        assert [bytes(r) for r in s2.iter_records()] == rest
        s2.close()
        out[pkg] = (first, rest)
    assert out["port"] == out["jax"]


def test_create_mmap_text_split_positions(tmp_path):
    """``create_mmap_text_split(uri, part_index, num_parts, chunk_bytes=)``
    as ``tests/test_parallel_parse.py`` calls it; the positions are
    required, as in JAX."""
    path = _text(tmp_path)
    for part, nparts in ((0, 1), (1, 3)):
        a = create_mmap_text_split(path, part, nparts, chunk_bytes=4096)
        b = jax_split.create_mmap_text_split(path, part, nparts, chunk_bytes=4096)
        assert [bytes(c) for c in a.iter_chunks()] == [bytes(c) for c in b.iter_chunks()]
        a.close()
        b.close()
    for make in (create_mmap_text_split, jax_split.create_mmap_text_split):
        with pytest.raises(TypeError):
            make(path)


@pytest.mark.parametrize("kind", ["text", "recordio", "indexed"])
def test_records_in_chunk_matches_reference(tmp_path, kind):
    uri, _, kw = _source(tmp_path, kind)
    got, want = [], []
    for fs_of, mod, out in ((get_filesystem, None, got), (jax_get_filesystem, jax_split, want)):
        if kind == "text":
            cls = LineSplitter if mod is None else mod.LineSplitter
            split = cls(fs_of(uri), uri)
        elif kind == "recordio":
            cls = RecordIOSplitter if mod is None else mod.RecordIOSplitter
            split = cls(fs_of(uri), uri)
        else:
            cls = IndexedRecordIOSplitter if mod is None else mod.IndexedRecordIOSplitter
            split = cls(fs_of(uri), uri, kw["index_uri"], batch_size=kw["batch_size"])
        split.hint_chunk_size(4096)
        split.reset_partition(0, 1)
        while (c := split.next_chunk()) is not None:
            chunk = bytes(c)
            out.append([bytes(r) for r in split.records_in_chunk(chunk)])
            # a memoryview chunk gives the same records
            assert [bytes(r) for r in split.records_in_chunk(memoryview(chunk))] == out[-1]
        split.close()
    assert got == want and sum(len(c) for c in got) > 0
