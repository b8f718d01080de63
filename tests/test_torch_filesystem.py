"""The port's filesystem registry and streams against the JAX package's.

- ``mem://``: the cases of ``tests/test_io.py`` (the in-memory
  filesystem's info, listings and streams; the line split over two
  ``mem://`` files at several part counts; a double close), each run
  through both packages on the same bytes;
- the registry: an unknown protocol raises as JAX's does, a factory the
  test registers serves ``create_input_split`` and ``open_stream``;
- ``open_stream``: ``allow_null``, the bad mode, ``resilient`` (wrapped
  for ``file://`` and ``mem://``, not for a filesystem that resumes by
  itself), ``read_all`` / ``write_all``;
- ``ResilientStream`` over a flaky source (``tests/test_resilience.py``'s
  cases): the same bytes, reopens and retry counters as JAX's;
- ``source_signature`` over ``mem://`` files and directories equals JAX's,
  and a block cache over a ``mem://`` corpus carries it in both packages.
"""

import io as _pyio
import json

import numpy as np
import pytest

from dmlc_tpu.io import block_cache as jax_bc
from dmlc_tpu.io import filesystem as jax_fs
from dmlc_tpu.io import resilience as jax_res
from dmlc_tpu.io import stream as jax_stream
from dmlc_tpu.io.input_split import create_input_split as jax_create_input_split
from dmlc_tpu.io.uri import URI as JaxURI
from dmlc_tpu.utils.check import DMLCError as JaxDMLCError
from dmlc_tpu_torch.io import block_cache as bc
from dmlc_tpu_torch.io import filesystem as fs_mod
from dmlc_tpu_torch.io import resilience as res
from dmlc_tpu_torch.io import stream
from dmlc_tpu_torch.io.input_split import LineSplitter, create_input_split
from dmlc_tpu_torch.io.uri import URI
from dmlc_tpu_torch.utils.check import DMLCError

LINES = [f"line-{i:04d} value:{i * 3}".encode() for i in range(500)]
# the JAX package's cloud members (queue A): known there, not here yet
CLOUD = {"azure://", "gs://", "hdfs://", "http://", "https://", "s3://", "viewfs://"}

PACKAGES = {"port": (fs_mod, stream, create_input_split, URI),
            "jax": (jax_fs, jax_stream, jax_create_input_split, JaxURI)}


@pytest.fixture(autouse=True)
def _fresh_mem():
    fs_mod.MemoryFileSystem.reset()
    jax_fs.MemoryFileSystem.reset()
    yield
    fs_mod.MemoryFileSystem.reset()
    jax_fs.MemoryFileSystem.reset()


def _mem_fs_case(pkg):
    fs, st, _, uri_cls = PACKAGES[pkg]
    with st.open_stream("mem://bucket/a.txt", "w") as f:
        f.write(b"abc")
    with st.open_stream("mem://bucket/sub/b.txt", "w") as f:
        f.write(b"defg")
    mem = fs.get_filesystem("mem://bucket/a.txt")
    info = mem.get_path_info(uri_cls("mem://bucket/a.txt"))
    names = sorted(i.path.raw for i in mem.list_directory(uri_cls("mem://bucket")))
    rec = mem.list_directory_recursive(uri_cls("mem://bucket"))
    with st.open_stream("mem://bucket/a.txt") as f:
        back = f.read()
    return {"size": info.size, "type": info.type, "names": names,
            "rec": sorted((str(i.path), i.size, i.type) for i in rec), "back": back,
            "dir": mem.get_path_info(uri_cls("mem://bucket/sub")).type,
            "exists": [mem.exists(uri_cls(u)) for u in ("mem://bucket/a.txt",
                                                        "mem://bucket/nope")]}


def test_mem_fs_matches_reference():
    got, want = _mem_fs_case("port"), _mem_fs_case("jax")
    assert got == want
    assert got["size"] == 3 and "mem://bucket/a.txt" in got["names"]
    assert sum(r[1] for r in got["rec"]) == 7 and got["back"] == b"abc"
    assert isinstance(fs_mod.get_filesystem("mem://x/y"), fs_mod.MemoryFileSystem)
    with pytest.raises(DMLCError, match="no such directory"):
        fs_mod.get_filesystem("mem://x").list_directory(URI("mem://nothing"))
    with pytest.raises(DMLCError, match="no such path"):
        fs_mod.get_filesystem("mem://x").get_path_info(URI("mem://nothing/a"))


def _parts(pkg, uri, num_parts, **kw):
    factory = PACKAGES[pkg][2]
    out = []
    for part in range(num_parts):
        split = factory(uri, part, num_parts, "text", threaded=False, **kw)
        out.append([bytes(r) for r in split.iter_records()])
        split.close()
    return out


@pytest.mark.parametrize("num_parts", [1, 3, 5])
def test_line_split_on_memfs_matches_reference(num_parts):
    for pkg in PACKAGES:
        st = PACKAGES[pkg][1]
        with st.open_stream("mem://c/d/a.txt", "w") as f:
            f.write(b"\n".join(LINES[:100]))
        with st.open_stream("mem://c/d/b.txt", "w") as f:
            f.write(b"\n".join(LINES[100:200]))
    for uri in ("mem://c/d/a.txt;mem://c/d/b.txt", "mem://c/d", "mem://c/d/[ab]\\.txt"):
        got = _parts("port", uri, num_parts, chunk_bytes=4096)
        assert got == _parts("jax", uri, num_parts, chunk_bytes=4096)
        assert [r for p in got for r in p] == LINES[:200]
    split = create_input_split("mem://c/d/a.txt", 0, 1, "text", threaded=False)
    assert isinstance(split, LineSplitter)
    assert isinstance(split.fs, fs_mod.MemoryFileSystem)
    split.close()


def test_memfile_double_close_and_append():
    for pkg in PACKAGES:
        st = PACKAGES[pkg][1]
        f = st.open_stream("mem://b/x.txt", "w")
        f.write(b"hi")
        f.close()
        f.close()  # idempotent
        with st.open_stream("mem://b/x.txt", "a") as g:
            g.write(b" there")
        assert st.read_all("mem://b/x.txt") == b"hi there"
    with pytest.raises(DMLCError, match="bad mode"):
        fs_mod.get_filesystem("mem://b").open(URI("mem://b/x.txt"), "x")


def test_unknown_protocol_raises_as_reference():
    with pytest.raises(JaxDMLCError) as want:
        jax_fs.get_filesystem("nofs://bucket/a")
    with pytest.raises(DMLCError) as got:
        fs_mod.get_filesystem("nofs://bucket/a")
    prefix = "unknown filesystem protocol 'nofs://'; known: "
    assert str(got.value) == prefix + "['file://', 'mem://']"
    assert str(want.value).startswith(prefix)
    jax_known = set(json.loads(str(want.value)[len(prefix):].replace("'", '"')))
    assert jax_known - {"file://", "mem://"} == CLOUD
    with pytest.raises(DMLCError, match="unknown filesystem protocol"):
        stream.open_stream("nofs://bucket/a")
    assert stream.open_stream("nofs://bucket/a", allow_null=True) is None
    with pytest.raises(DMLCError, match="unknown filesystem protocol"):
        create_input_split("nofs://bucket/a", 0, 1, "text")


class _DictFS(fs_mod.FileSystem):
    """A filesystem the test registers: files in a dict, opened counted."""

    def __init__(self, files):
        self.files = files
        self.opens = 0

    def get_path_info(self, path):
        key = path.name
        if key not in self.files:
            raise DMLCError(f"no {key}")
        return fs_mod.FileInfo(URI("tst://" + path.host + key), len(self.files[key]),
                               fs_mod.FILE_TYPE)

    def open(self, path, mode):
        if mode != "r":
            raise DMLCError(f"read-only: {mode!r}")
        self.opens += 1
        return _pyio.BytesIO(self.files[path.name])


def test_a_registered_factory_serves():
    data = b"\n".join(LINES) + b"\n"
    mine = _DictFS({"/corpus.txt": data})
    calls = []
    fs_mod.register_filesystem("tst://", lambda uri: calls.append(uri.raw) or mine)
    try:
        assert fs_mod.get_filesystem("tst://h/corpus.txt") is mine
        got = [r for p in _parts("port", "tst://h/corpus.txt", 3) for r in p]
        assert got == LINES and mine.opens > 0
        assert stream.read_all("tst://h/corpus.txt") == data
        assert "tst://h/corpus.txt" in calls
        with pytest.raises(DMLCError, match="read-only"):
            stream.open_stream("tst://h/corpus.txt", "w")
    finally:
        with fs_mod._FS_LOCK:
            fs_mod._FS_FACTORIES.pop("tst://")
    with pytest.raises(DMLCError, match="unknown filesystem protocol 'tst://'"):
        fs_mod.get_filesystem("tst://h/corpus.txt")


def test_open_stream_allow_null_resilient_and_helpers(tmp_path):
    payload = b"resilient local bytes" * 100
    path = tmp_path / "f.bin"
    path.write_bytes(payload)
    for pkg in PACKAGES:
        st = PACKAGES[pkg][1]
        st.write_all("mem://r/f.bin", payload)
        for uri in (str(path), "mem://r/f.bin"):
            with st.open_stream(uri, "r", resilient=True) as f:
                assert type(f.raw).__name__ == "ResilientStream"
                assert f.read() == payload
            assert st.read_all(uri) == payload
        assert st.open_stream(str(tmp_path / "missing"), "r", allow_null=True) is None
        assert st.open_stream("mem://r/missing", "r", allow_null=True) is None
    with pytest.raises(DMLCError, match="bad mode"):
        stream.open_stream(str(path), "rw")
    with pytest.raises(DMLCError, match="no such file"):
        stream.open_stream("mem://r/missing")

    class _Native(_DictFS):
        native_resilience = True

    fs_mod.register_filesystem("tst://", lambda uri: _Native({"/n.bin": b"native resume"}))
    try:
        with stream.open_stream("tst://h/n.bin", "r", resilient=True) as f:
            assert not isinstance(getattr(f, "raw", f), res.ResilientStream)
            assert f.read() == b"native resume"
    finally:
        with fs_mod._FS_LOCK:
            fs_mod._FS_FACTORIES.pop("tst://")


def _flaky_open(data, state):
    opens = []

    def open_fn():
        bio = _pyio.BytesIO(data)
        opens.append(bio)
        orig = bio.read

        def read(n=-1):
            if state.get("fails", 0) > 0 and bio.tell() >= state["at"]:
                state["fails"] -= 1
                raise ConnectionResetError("mid-read flake")
            return orig(n)

        bio.read = read
        return bio

    return open_fn, opens


def _resilient_case(mod, case):
    """One of ``tests/test_resilience.py``'s ResilientStream cases through
    ``mod`` (a package's resilience module): what it read, its reopens and
    the counters it moved."""
    mod.reset_counters()
    data = bytes(range(256)) * 64
    out = {}
    if case == "mid_read":
        open_fn, opens = _flaky_open(data, {"fails": 1, "at": 6000})
        rs = mod.ResilientStream(open_fn, policy=mod.RetryPolicy(max_attempts=3,
                                                                 base_delay=0.001),
                                 what="mem://flaky")
        buf = bytearray()
        while chunk := rs.read(4096):
            buf += chunk
        out.update(data=bytes(buf) == data, reopens=rs.reopens, opens=len(opens))
    elif case == "seek":
        open_fn, opens = _flaky_open(data, {"fails": 1, "at": 0})
        rs = mod.ResilientStream(open_fn, policy=mod.RetryPolicy(max_attempts=3,
                                                                 base_delay=0.001))
        rs.seek(12345)
        out.update(read=rs.read(10) == data[12345:12355], tell=rs.tell(), opens=len(opens))
    elif case in ("fatal", "budget"):
        calls = {"n": 0}

        def open_fn():
            calls["n"] += 1
            if case == "fatal":
                raise ValueError("malformed")
            raise ConnectionResetError("always down")

        rs = mod.ResilientStream(open_fn, policy=mod.RetryPolicy(max_attempts=3,
                                                                 base_delay=0.001))
        try:
            rs.read(10)
        except Exception as exc:  # noqa: BLE001 - the class is compared below
            out.update(error=type(exc).__name__, text=str(exc).split(":")[0],
                       calls=calls["n"])
    snap = mod.counters_snapshot()
    out["counters"] = {k: snap[k] for k in ("attempts", "retries", "resumes", "giveups",
                                            "fatal")}
    rs.close()
    return out


@pytest.mark.parametrize("case", ["mid_read", "seek", "fatal", "budget"])
def test_resilient_stream_matches_reference(case):
    got, want = _resilient_case(res, case), _resilient_case(jax_res, case)
    assert got == want
    if case == "mid_read":
        assert got["data"] and got["reopens"] == 1 and got["opens"] == 2
        assert got["counters"]["resumes"] == 1 and got["counters"]["retries"] == 1
    if case == "fatal":
        assert got["calls"] == 1 and got["error"] == "DMLCError"
    if case == "budget":
        assert got["calls"] == 3 and got["counters"]["giveups"] == 1


def _sig_files(mod_bc, uri):
    return mod_bc.source_signature(uri, 1, 3, format="libsvm", chunk_bytes=4096)


def test_source_signature_over_memfs_matches_reference():
    for pkg in PACKAGES:
        st = PACKAGES[pkg][1]
        st.write_all("mem://sig/a.libsvm", b"1 1:2\n0 3:4\n")
        st.write_all("mem://sig/d/b.libsvm", b"1 2:2\n")
        st.write_all("mem://sig/d/c.libsvm", b"0 2:1\n1 5:1\n")
    for uri in ("mem://sig/a.libsvm", "mem://sig/d", "mem://sig/a.libsvm;mem://sig/d/c.libsvm",
                "mem://sig/missing", "nofs://x/y", "mem://sig/a.libsvm?format=libsvm#cache"):
        got, want = _sig_files(bc, uri), _sig_files(jax_bc, uri)
        assert got == want, uri
    assert _sig_files(bc, "mem://sig/a.libsvm")["files"] == [["mem://sig/a.libsvm", 12, None]]
    assert _sig_files(bc, "mem://sig/missing")["files"] == [["mem://sig/missing", None, None]]


def test_block_cache_over_memfs_carries_the_reference_signature(tmp_path):
    """A block cache over a ``mem://`` corpus: the same file from either
    package (the signature included), served warm by the other."""
    from dmlc_tpu.data.parsers import create_parser as jax_create_parser
    from dmlc_tpu_torch.data.parsers import create_parser

    rng = np.random.default_rng(3)
    data = "".join(f"{i % 2} " + " ".join(f"{j}:{rng.random():.3f}" for j in range(1, 5))
                   + "\n" for i in range(400)).encode()
    files = {}
    for pkg, make in (("port", create_parser), ("jax", jax_create_parser)):
        PACKAGES[pkg][1].write_all("mem://bc/c.libsvm", data)
        cache = str(tmp_path / f"{pkg}.bc")
        p = make("mem://bc/c.libsvm?engine=python", 0, 1, "libsvm", threaded=False,
                 chunk_bytes=4096, block_cache=cache)
        while p.next_block() is not None:
            pass
        p.close()
        files[pkg] = open(cache, "rb").read()
    assert files["port"] == files["jax"]
    reader = bc.BlockCacheReader(str(tmp_path / "jax.bc"))
    assert reader.signature["files"] == [["mem://bc/c.libsvm", len(data), None]]
    reader.close()
    warm = create_parser("mem://bc/c.libsvm?engine=python", 0, 1, "libsvm", threaded=False,
                         chunk_bytes=4096, block_cache=str(tmp_path / "jax.bc"))
    assert warm.cache_state == "warm"
    assert sum(len(b) for b in warm) == 400
    warm.close()
