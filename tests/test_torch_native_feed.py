"""The port's chunk feeder (``NativeFeedParser``) against the JAX package's.

Seeded libsvm, csv and libfm corpora written to ``mem://`` in both
packages:

- the blocks of ``NativeFeedParser`` (CSR, the dense emit with and without
  the batch repack, the COO emit) at 1-3 parts equal JAX's array for array,
  over two epochs, and equal the local pull reader's on the same bytes;
- ``kind="blocks"`` states equal JAX's and restore across the packages;
- ``create_parser``'s route over a matrix of URIs (local and ``mem://``;
  threaded or not; ``?engine=python``, a ``#cachefile``, a csv the native
  scanner cannot serve, ``engine=`` ``native`` / ``native-batch`` /
  ``python``, ``DMLC_TPU_NO_NATIVE_READER``) builds the class JAX's builds;
- an error raised in the feed thread reaches ``next_block`` as a
  ``DMLCError`` whose ``__cause__`` is the original exception (and so is
  classified retryable), as in JAX; ``before_first`` while the feed
  thread is still pushing restarts cleanly, and a feeder that failed is
  rebuilt.
"""

import json

import numpy as np
import pytest

from dmlc_tpu.data import native_parser as jax_np
from dmlc_tpu.data.parsers import create_parser as jax_create_parser
from dmlc_tpu.io import filesystem as jax_fs
from dmlc_tpu.store import manager as jax_mgr
from dmlc_tpu_torch import native
from dmlc_tpu_torch.data import native_parser as port_np
from dmlc_tpu_torch.data.parsers import create_parser
from dmlc_tpu_torch.io import filesystem as fs_mod
from dmlc_tpu_torch.io import resilience
from dmlc_tpu_torch.store import manager as port_mgr
from dmlc_tpu_torch.utils.check import DMLCError

pytestmark = pytest.mark.skipif(not native.available(), reason="native core unavailable")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("DMLC_TPU_NO_NATIVE_READER", raising=False)
    monkeypatch.delenv("DMLC_TPU_PARSE_ENGINE", raising=False)
    for mod in (fs_mod, jax_fs):
        mod.MemoryFileSystem.reset()
    jax_mgr.reset_stores()
    port_mgr.reset_stores()
    yield
    for mod in (fs_mod, jax_fs):
        mod.MemoryFileSystem.reset()
    jax_mgr.reset_stores()
    port_mgr.reset_stores()


def _libsvm(n=1500, seed=0):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        feats = " ".join(f"{j}:{rng.random():.4f}" for j in sorted(
            rng.choice(20, size=int(rng.integers(1, 8)), replace=False)))
        rows.append(f"{i % 2}:{rng.random():.2f} {feats}")
    return ("\n".join(rows) + "\n").encode()


def _csv(n=1500, seed=1):
    rng = np.random.default_rng(seed)
    return "".join(f"{i % 2}," + ",".join(f"{v:.4f}" for v in rng.random(6)) + "\n"
                   for i in range(n)).encode()


def _libfm(n=1500, seed=2):
    rng = np.random.default_rng(seed)
    return "".join(f"{i % 2} " + " ".join(f"{j % 3}:{j}:{rng.random():.3f}" for j in
                                           sorted(rng.choice(30, 4, replace=False))) + "\n"
                   for i in range(n)).encode()


CORPORA = {"libsvm": (_libsvm, {}), "csv": (_csv, {"label_column": "0"}),
           "libfm": (_libfm, {})}


@pytest.fixture
def corpora(tmp_path):
    out = {}
    for fmt, (gen, args) in CORPORA.items():
        data = gen()
        for mod in (fs_mod, jax_fs):
            mod.MemoryFileSystem.instance().store[f"b/c.{fmt}"] = data
        (tmp_path / f"c.{fmt}").write_bytes(data)
        out[fmt] = {"mem": f"mem://b/c.{fmt}", "path": str(tmp_path / f"c.{fmt}"),
                    "args": args, "data": data}
    return out


def _arrays(block):
    """Every array of a block, by name, as bytes with its dtype."""
    names = {"RowBlock": ("offset", "label", "index", "value", "weight", "qid", "field"),
             "DenseBlock": ("x", "label", "weight"),
             "CooBlock": ("coords", "values", "label", "weight", "row_ptr")}[
        type(block).__name__]
    out = {"kind": type(block).__name__, "rows": len(block)}
    for n in names:
        a = getattr(block, n)
        out[n] = None if a is None else (str(np.asarray(a).dtype), np.asarray(a).tobytes())
    return out


def _drain(parser, epochs=2):
    out = []
    for _ in range(epochs):
        out.append([_arrays(b) for b in iter(parser.next_block, None)])
        parser.before_first()
    return out


EMITS = [("csr", {}), ("dense", {"batch_rows": 0}), ("dense_repack", {"batch_rows": 256}),
         ("coo", {})]


def _configure(parser, fmt, emit, kw):
    if emit.startswith("dense"):
        return parser.set_emit_dense(21 if fmt == "libsvm" else 7, **kw)
    if emit == "coo":
        return parser.set_emit_coo(31, row_bucket=64, nnz_bucket=256)
    return True


@pytest.mark.parametrize("fmt", list(CORPORA))
@pytest.mark.parametrize("emit,kw", EMITS, ids=[e for e, _ in EMITS])
@pytest.mark.parametrize("nparts", [1, 2, 3])
def test_feed_blocks_match_reference(corpora, fmt, emit, kw, nparts):
    c = corpora[fmt]
    for part in range(nparts):
        out = {}
        for pkg, mod in (("port", port_np), ("jax", jax_np)):
            p = mod.NativeFeedParser(c["mem"], c["args"], part, nparts, fmt, chunk_bytes=8192)
            ok = _configure(p, fmt, emit, kw)
            out[pkg] = (ok, _drain(p))
            p.close()
        assert out["port"] == out["jax"], (fmt, emit, part)
        ok, epochs = out["port"]
        assert epochs[0] == epochs[1] and len(epochs[0]) > 0
        # the local pull reader gives the same blocks on the same bytes
        local = port_np.NativeStreamParser(c["path"], c["args"], part, nparts, fmt,
                                           chunk_bytes=8192)
        assert _configure(local, fmt, emit, kw) == ok
        assert _drain(local, 1)[0] == epochs[0]
        local.close()


@pytest.mark.parametrize("fmt", list(CORPORA))
def test_feed_states_restore_across_packages(corpora, fmt):
    c = corpora[fmt]
    make = {"port": lambda: port_np.NativeFeedParser(c["mem"], c["args"], 1, 2, fmt,
                                                     chunk_bytes=8192),
            "jax": lambda: jax_np.NativeFeedParser(c["mem"], c["args"], 1, 2, fmt,
                                                   chunk_bytes=8192)}
    states = {}
    for pkg in make:
        p = make[pkg]()
        for _ in range(3):
            p.next_block()
        states[pkg] = json.loads(json.dumps(p.state_dict()))
        rest = [_arrays(b) for b in iter(p.next_block, None)]
        p.close()
        states[pkg + "_rest"] = rest
    assert states["port"] == states["jax"] == {"kind": "blocks", "blocks": 3,
                                                 "part_index": 1, "num_parts": 2}
    assert states["port_rest"] == states["jax_rest"]
    for src in ("port", "jax"):
        for dst in ("port", "jax"):
            p = make[dst]()
            p.load_state(states[src])
            assert [_arrays(b) for b in iter(p.next_block, None)] == states["port_rest"]
            p.close()


ROUTES = [  # (uri key, format, suffix, create_parser keywords)
    ("mem", "libsvm", "", {}),
    ("mem", "libsvm", "", {"threaded": False}),
    ("mem", "libsvm", "?engine=python", {}),
    ("mem", "libsvm", "#CACHE", {}),
    ("mem", "libsvm", "", {"engine": "native"}),
    ("mem", "libsvm", "", {"engine": "python"}),
    ("mem", "libsvm", "", {"engine": "native-batch"}),
    ("mem", "libsvm", "", {"parse_workers": 1}),
    ("mem", "libsvm", "", {"shuffle": True}),
    ("mem", "csv", "?format=csv&label_column=0", {}),
    ("mem", "csv", "?format=csv&dtype=int32", {}),
    ("mem", "libfm", "?format=libfm", {}),
    ("path", "libsvm", "", {}),
    ("path", "libsvm", "", {"threaded": False}),
    ("path", "libsvm", "#CACHE", {}),
    ("path", "csv", "?format=csv&dtype=int64", {}),
]


def _route(make, uri, fmt, kw):
    p = make(uri, 0, 1, fmt, **kw)
    names = [type(p).__name__]
    base = getattr(p, "base", None)
    if base is not None:
        names.append(type(base).__name__)
    p.close()
    return names


@pytest.mark.parametrize("no_native", [False, True])
@pytest.mark.parametrize("route", ROUTES, ids=[str(i) for i in range(len(ROUTES))])
def test_create_parser_routes_match_reference(corpora, tmp_path, monkeypatch, route,
                                              no_native):
    key, fmt, suffix, kw = route
    if no_native:
        monkeypatch.setenv("DMLC_TPU_NO_NATIVE_READER", "1")
    kw = dict(kw, chunk_bytes=8192)
    names = {}
    for pkg, make in (("port", create_parser), ("jax", jax_create_parser)):
        uri = corpora[fmt][key] + suffix.replace("CACHE", str(tmp_path / f"{pkg}.cache"))
        names[pkg] = _route(make, uri, fmt, kw)
    assert names["port"] == names["jax"]
    if key == "mem" and not (suffix or no_native) and kw == {"chunk_bytes": 8192}:
        assert names["port"] == ["NativeFeedParser"]


def test_a_feed_thread_error_surfaces_with_its_cause(corpora):
    """The split under the feed thread fails once mid-stream: the consumer
    gets the blocks before it, then a DMLCError chained to the original
    exception (classified retryable, as in JAX); before_first rebuilds the
    failed feeder and the next epoch is whole."""
    c = corpora["libsvm"]
    out = {}
    for pkg, mod, res in (("port", port_np, resilience), ("jax", jax_np, None)):
        p = mod.NativeFeedParser(c["mem"], {}, 0, 1, "libsvm", chunk_bytes=8192)
        p.FEED_CHUNK = 4096
        real = p._make_split
        state = {"armed": True}

        def broken(real=real, state=state):
            s = real()
            orig, calls = s._read, {"n": 0}

            def _read(n):
                calls["n"] += 1
                if state["armed"] and calls["n"] == 6:
                    state["armed"] = False
                    raise ConnectionResetError("feed flake")
                return orig(n)

            s._read = _read
            return s

        p._make_split = broken
        got = []
        with pytest.raises(Exception) as err:
            while (b := p.next_block()) is not None:
                got.append(_arrays(b))
        assert type(err.value).__name__ == "DMLCError"
        assert isinstance(err.value.__cause__, ConnectionResetError)
        if res is not None:
            assert res.classify(err.value) == res.RETRYABLE
        p.before_first()
        whole = [_arrays(b) for b in iter(p.next_block, None)]
        p.close()
        out[pkg] = (got, str(err.value), whole)
    assert out["port"] == out["jax"]
    local = port_np.NativeStreamParser(c["path"], {}, 0, 1, "libsvm", chunk_bytes=8192)
    assert out["port"][2] == [_arrays(b) for b in iter(local.next_block, None)]
    local.close()


def test_before_first_while_the_feed_is_pushing(corpora):
    """An epoch reset after one block, while the feed thread still pushes
    (the byte queue full), restarts the stream from the partition's start;
    close joins the feed thread."""
    c = corpora["libsvm"]
    p = port_np.NativeFeedParser(c["mem"], {}, 0, 1, "libsvm", chunk_bytes=4096)
    p.FEED_CHUNK = 1024
    full = [_arrays(b) for b in iter(p.next_block, None)]
    for _ in range(3):
        p.before_first()
        first = _arrays(p.next_block())
        assert p._feed_thread is not None and first == full[0]
    p.before_first()
    assert [_arrays(b) for b in iter(p.next_block, None)] == full
    thread = p._feed_thread
    p.close()
    assert not thread.is_alive() and p._feed_thread is None
    with pytest.raises(DMLCError, match="requires local files"):
        port_np.NativeStreamParser(c["mem"], {}, 0, 1, "libsvm")
