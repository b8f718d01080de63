"""The port's native RecordIO engines against the JAX package's.

The same seeded RecordIO corpus (records of varied lengths, some holding
the magic word, so the writer splits them into multi-part records) and
its index, local and under ``mem://``, through both packages:

- ``NativeRecordIOSplit`` (records and raw chunks), the shuffled and
  sequential ``NativeIndexedRecordIOSplit`` over two epochs, and
  ``NativeFeedRecordIOSplit`` over ``mem://``, at 1-3 parts: the records
  and the ``state_dict``s after each record, as JSON, equal JAX's;
- a state taken in either package restores in the other (the indexed
  split's ``skip`` into a later shuffled epoch included) to the same
  remaining records;
- the routes: for a matrix of URIs (local and ``mem://``; threaded or
  not; with and without an index, shuffle, ``#cachefile``,
  ``?engine=python`` and ``DMLC_TPU_NO_NATIVE_READER``),
  ``create_input_split`` builds the class the JAX factory builds.
"""

import io
import json

import numpy as np
import pytest

from dmlc_tpu.io import filesystem as jax_fs
from dmlc_tpu.io import native_recordio as jax_nr
from dmlc_tpu.io.input_split import create_input_split as jax_create_input_split
from dmlc_tpu.store import manager as jax_mgr
from dmlc_tpu_torch import native
from dmlc_tpu_torch.io import filesystem as fs_mod
from dmlc_tpu_torch.io import native_recordio as nr
from dmlc_tpu_torch.io import recordio as rio
from dmlc_tpu_torch.io.input_split import create_input_split
from dmlc_tpu_torch.store import manager as port_mgr
from dmlc_tpu_torch.utils.check import DMLCError

pytestmark = pytest.mark.skipif(not native.available(), reason="native core unavailable")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("DMLC_TPU_NO_NATIVE_READER", raising=False)
    fs_mod.MemoryFileSystem.reset()
    jax_fs.MemoryFileSystem.reset()
    jax_mgr.reset_stores()
    port_mgr.reset_stores()
    yield
    fs_mod.MemoryFileSystem.reset()
    jax_fs.MemoryFileSystem.reset()
    jax_mgr.reset_stores()
    port_mgr.reset_stores()


def _records(n=400, seed=21):
    rng = np.random.default_rng(seed)
    magic = rio.RECORDIO_MAGIC.to_bytes(4, "little")
    out = []
    for i in range(n):
        rec = rng.bytes(int(rng.integers(0, 3000)))
        if i % 11 == 0:  # the writer splits these into multi-part records
            rec = rec[:16] + magic + rec[16:] + magic
        out.append(rec)
    return out


@pytest.fixture
def corpus(tmp_path):
    recs = _records()
    data, idx = io.BytesIO(), io.BytesIO()
    rio.write_indexed_recordio(data, idx, recs)
    path = tmp_path / "c.rec"
    path.write_bytes(data.getvalue())
    (tmp_path / "c.rec.idx").write_bytes(idx.getvalue())
    for mod in (fs_mod, jax_fs):
        store = mod.MemoryFileSystem.instance().store
        store["b/c.rec"] = data.getvalue()
        store["b/c.rec.idx"] = idx.getvalue()
    return {"path": str(path), "index": str(path) + ".idx", "mem": "mem://b/c.rec",
            "records": recs}


def _walk(split, chunks=False, n=None):
    """Records (or chunks) with the state after each; ``n`` stops early."""
    out = []
    while n is None or len(out) < n:
        item = split.next_chunk() if chunks else split.next_record()
        if item is None:
            break
        out.append((bytes(item), json.dumps(split.state_dict(), sort_keys=True)))
    return out


def _make(kind, pkg, corpus, part=0, nparts=1, **kw):
    mod = nr if pkg == "port" else jax_nr
    if kind == "plain":
        return mod.NativeRecordIOSplit(corpus["path"], part, nparts, chunk_bytes=16384, **kw)
    if kind == "feed":
        return mod.NativeFeedRecordIOSplit(corpus["mem"], part, nparts, chunk_bytes=16384,
                                           **kw)
    return mod.NativeIndexedRecordIOSplit(corpus["path"], corpus["index"], part, nparts,
                                          batch_size=13, seed=4, **kw)


@pytest.mark.parametrize("kind,kw", [("plain", {}), ("feed", {}), ("indexed", {}),
                                     ("indexed", {"shuffle": True})])
@pytest.mark.parametrize("nparts", [1, 2, 3])
def test_records_and_states_match_reference(corpus, kind, kw, nparts):
    union = []
    for part in range(nparts):
        got, want = [], []
        for pkg, out in (("port", got), ("jax", want)):
            split = _make(kind, pkg, corpus, part, nparts, **kw)
            for _ in range(2):  # two epochs (the indexed split reshuffles)
                out.append(_walk(split))
                split.before_first()
            split.close()
        assert got == want, (kind, part)
        union += [r for r, _ in got[0]]
    if kw.get("shuffle"):
        assert sorted(union) == sorted(corpus["records"])
        assert [r for r, _ in got[0]] != [r for r, _ in got[1]] or nparts == 3
    else:
        assert union == corpus["records"]


@pytest.mark.parametrize("kind", ["plain", "feed"])
def test_chunks_and_their_states_match_reference(corpus, kind):
    out = {}
    for pkg in ("port", "jax"):
        split = _make(kind, pkg, corpus)
        out[pkg] = _walk(split, chunks=True)
        with pytest.raises(Exception, match="cannot be mixed"):
            split.next_record()
        split.close()
    assert out["port"] == out["jax"] and len(out["port"]) > 3
    recs = native.recordio_extract(b"".join(c for c, _ in out["port"]))
    payload, offsets = recs
    got = [bytes(payload[offsets[i]:offsets[i + 1]]) for i in range(len(offsets) - 1)]
    assert got == corpus["records"]


@pytest.mark.parametrize("kind,kw,at", [("plain", {}, 57), ("feed", {}, 120),
                                        ("indexed", {}, 33),
                                        ("indexed", {"shuffle": True}, 200)])
def test_states_restore_across_packages(corpus, kind, kw, at):
    ref = _make(kind, "jax", corpus, 1, 2, **kw)
    if kind == "indexed":
        ref.next_record()   # the reader starts; the reset draws epoch 1
        ref.before_first()
    head = _walk(ref, n=at)
    state = json.loads(head[-1][1])
    rest = [r for r, _ in _walk(ref)]
    ref.close()
    for src, dst in (("jax", "port"), ("port", "jax"), ("port", "port")):
        if src == "port":
            split = _make(kind, "port", corpus, 1, 2, **kw)
            if kind == "indexed":
                split.next_record()
                split.before_first()
            got_head = _walk(split, n=at)
            state = json.loads(got_head[-1][1])
            split.close()
            assert got_head == head
        split = _make(kind, dst, corpus, 1, 2, **kw)
        split.load_state(state)
        assert [r for r, _ in _walk(split)] == rest, (src, dst)
        split.close()
    if kind == "indexed":
        assert state["epochs"] == 1 and state["kind"] == "indexed_native"


def test_errors_match_reference(corpus, tmp_path):
    odd = tmp_path / "odd.rec"
    odd.write_bytes(b"\x00" * 6)
    for mod, cls in ((nr, DMLCError), (jax_nr, Exception)):
        with pytest.raises(cls, match="does not align by 4 bytes"):
            mod.NativeRecordIOSplit(str(odd), 0, 1)
        with pytest.raises(cls, match="out of range"):
            mod.NativeRecordIOSplit(corpus["path"], 2, 2)
        with pytest.raises(cls, match="serves records, not raw chunks"):
            mod.NativeIndexedRecordIOSplit(corpus["path"], corpus["index"], 0, 1).next_chunk()
        with pytest.raises(cls, match="requires local files"):
            mod.NativeRecordIOSplit(corpus["mem"], 0, 1)
        with pytest.raises(cls, match="incompatible"):
            mod.NativeRecordIOSplit(corpus["path"], 0, 1).load_state({"kind": "byte"})


def _route(factory, uri, type_, kw):
    split = factory(uri, 0, 2, type_, **kw)
    name = type(split).__name__
    inner = getattr(split, "base", None)
    split.close()
    return name, (type(inner).__name__ if inner is not None else None)


ROUTES = [  # (uri key, type, suffix, keywords)
    ("path", "recordio", "", {}),
    ("path", "recordio", "", {"threaded": False}),
    ("path", "recordio", "?engine=python", {}),
    ("path", "recordio", "#CACHE", {}),
    ("path", "recordio", "", {"num_shuffle_parts": 2}),
    ("path", "recordio", "", {"recurse_directories": True}),
    ("path", "indexed_recordio", "", {"index_uri": "INDEX"}),
    ("path", "indexed_recordio", "", {"index_uri": "INDEX", "shuffle": True, "seed": 3}),
    ("path", "indexed_recordio", "", {"index_uri": "INDEX", "threaded": False}),
    ("path", "indexed_recordio", "?engine=python", {"index_uri": "INDEX"}),
    ("path", "indexed_recordio", "", {"index_uri": "MEMINDEX"}),
    ("path", "text", "", {}),
    ("mem", "recordio", "", {}),
    ("mem", "recordio", "", {"threaded": False}),
    ("mem", "recordio", "?engine=python", {}),
    ("mem", "recordio", "#CACHE", {}),
    ("mem", "recordio", "", {"shuffle": True}),
    ("mem", "indexed_recordio", "", {"index_uri": "MEMINDEX"}),
    ("mem", "text", "", {}),
]


@pytest.mark.parametrize("no_native", [False, True])
@pytest.mark.parametrize("route", ROUTES, ids=[str(i) for i in range(len(ROUTES))])
def test_routes_match_reference(corpus, tmp_path, monkeypatch, route, no_native):
    key, type_, suffix, kw = route
    if no_native:
        monkeypatch.setenv("DMLC_TPU_NO_NATIVE_READER", "1")
    kw = dict(kw)
    if kw.get("index_uri") == "INDEX":
        kw["index_uri"] = corpus["index"]
    elif kw.get("index_uri") == "MEMINDEX":
        kw["index_uri"] = corpus["mem"] + ".idx"
    names = []
    for pkg, factory in (("port", create_input_split), ("jax", jax_create_input_split)):
        uri = corpus[key] + suffix.replace("CACHE", str(tmp_path / f"{pkg}.cache"))
        names.append(_route(factory, uri, type_, kw))
    assert names[0] == names[1]
    if key == "path" and type_ == "recordio" and not (suffix or kw or no_native):
        assert names[0][0] == "NativeRecordIOSplit"
    if key == "mem" and type_ == "recordio" and not (suffix or kw or no_native):
        assert names[0][0] == "NativeFeedRecordIOSplit"


def test_native_engine_enabled_matches_reference(monkeypatch):
    for env in (None, "", "0", "1", "yes"):
        if env is None:
            monkeypatch.delenv("DMLC_TPU_NO_NATIVE_READER", raising=False)
        else:
            monkeypatch.setenv("DMLC_TPU_NO_NATIVE_READER", env)
        for args in (None, {}, {"engine": "python"}, {"engine": "native"}):
            assert nr.native_engine_enabled(args) == jax_nr.native_engine_enabled(args)


def _failing_feed(mod, corpus):
    """The feed split of ``mod`` whose fifth 4 KiB read fails; returns the
    records it gave and the error that ended them."""
    split = mod.NativeFeedRecordIOSplit(corpus["mem"], 0, 1, chunk_bytes=16384)
    split.FEED_CHUNK = 4096
    real = split._make_split

    def broken():
        s = real()
        calls = {"n": 0}
        orig = s._read

        def _read(n):
            calls["n"] += 1
            if calls["n"] == 5:
                raise ConnectionResetError("feed flake")
            return orig(n)

        s._read = _read
        return s

    split._make_split = broken
    got = []
    try:
        while (rec := split.next_record()) is not None:
            got.append(bytes(rec))
        err = None
    except Exception as exc:  # noqa: BLE001 - compared below
        err = (type(exc).__name__, str(exc))
    split.close()
    return got, err


def test_feed_split_surfaces_a_failed_read(corpus):
    """A read error in the feed thread ends the stream as an error, not
    as an early end: the records before it and the error as JAX's."""
    got, want = _failing_feed(nr, corpus), _failing_feed(jax_nr, corpus)
    assert got == want
    assert got[1] is not None and got[1][0] == "DMLCError"
    assert got[0] == corpus["records"][:len(got[0])]
