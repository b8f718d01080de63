"""The port's chunk cache (``#cachefile``, ``dmlc_tpu_torch.io.cached_split``)
against the JAX package's.

- the ``DMLCCHK1`` file the port writes is byte-identical to the JAX
  package's for the same corpus, partition and chunk size (text and
  RecordIO), and so are the chunks and records a first pass serves;
- a cache written by either package is served by the other with the
  source file renamed away (a cache-only pass never opens the source);
- a flipped frame byte heals (``cache_corruptions`` + ``cache_rebuilds``,
  the stream unbroken, the cache rewritten to the same bytes), a torn
  tail heals the same way, and a headerless or foreign-headed file is
  invalidated at open (``cache_invalidations``), with the JAX package's
  counts;
- the cache is pinned in its store while a split serves it, and the
  ``create_parser(path#cache)`` chain gives the plain chain's blocks over
  two epochs, the second with the source gone.

Everything runs on the CPU at a small size.
"""

import io
import os

import numpy as np
import pytest

from dmlc_tpu.io import create_input_split as jax_create_input_split
from dmlc_tpu.io import resilience as jax_resilience
from dmlc_tpu.store import manager as jax_mgr
from dmlc_tpu_torch.data import create_parser
from dmlc_tpu_torch.io import create_input_split
from dmlc_tpu_torch.io import resilience
from dmlc_tpu_torch.io.cached_split import CHUNK_CACHE_MAGIC, CachedInputSplit
from dmlc_tpu_torch.io.recordio import RecordIOWriter
from dmlc_tpu_torch.store import manager as port_mgr
from dmlc_tpu_torch.utils.check import DMLCError

FACTORY = {"jax": jax_create_input_split, "port": create_input_split}
RES = {"jax": jax_resilience, "port": resilience}
OTHER = {"jax": "port", "port": "jax"}


@pytest.fixture(autouse=True)
def _fresh_stores(monkeypatch):
    monkeypatch.delenv("DMLC_TPU_STORE_BUDGET_BYTES", raising=False)
    jax_mgr.reset_stores()
    port_mgr.reset_stores()
    yield
    jax_mgr.reset_stores()
    port_mgr.reset_stores()


def _text_corpus(path, n=900):
    rng = np.random.default_rng(5)
    with open(path, "w") as f:
        for i in range(n):
            feats = " ".join(f"{j}:{rng.random():.4f}" for j in sorted(
                rng.choice(30, size=int(rng.integers(1, 9)), replace=False)))
            f.write(f"{i % 2} {feats}\n")
    return str(path)


def _recordio_corpus(path, n=300):
    rng = np.random.default_rng(6)
    buf = io.BytesIO()
    w = RecordIOWriter(buf)
    magic = (0xCED7230A).to_bytes(4, "little")
    for i in range(n):
        rec = rng.bytes(int(rng.integers(1, 90)))
        if i % 17 == 0:
            rec = rec[:4] + magic + rec[4:]  # escaped multi-part records too
        w.write_record(rec)
    with open(path, "wb") as f:
        f.write(buf.getvalue())
    return str(path)


def _corpus(tmp_path, type_):
    if type_ == "text":
        return _text_corpus(tmp_path / "c.libsvm")
    return _recordio_corpus(tmp_path / "c.rec")


def _drain(split, chunks=False):
    out = [bytes(x) for x in (split.iter_chunks() if chunks else split.iter_records())]
    split.close()
    return out


def _cache_path(d, part, nparts):
    name = "c.cache" if nparts == 1 else f"c.cache.split{nparts}.part{part}"
    return os.path.join(str(d), name)


@pytest.mark.parametrize("type_", ["text", "recordio"])
@pytest.mark.parametrize("chunk", [4096, 1 << 20])
@pytest.mark.parametrize("part,nparts", [(0, 1), (0, 3), (2, 3)])
def test_cache_file_byte_identical_to_reference(tmp_path, type_, chunk, part, nparts):
    src = _corpus(tmp_path, type_)
    out = {}
    for pkg, factory in FACTORY.items():
        d = tmp_path / pkg
        d.mkdir()
        split = factory(f"{src}#{d / 'c.cache'}", part, nparts, type_, chunk_bytes=chunk)
        chunks = _drain(split, chunks=True)
        with open(_cache_path(d, part, nparts), "rb") as f:
            out[pkg] = (chunks, f.read())
    assert out["port"] == out["jax"]
    assert out["port"][1][:8] == CHUNK_CACHE_MAGIC
    plain = _drain(create_input_split(src, part, nparts, type_, threaded=False,
                                      chunk_bytes=chunk), chunks=True)
    assert out["port"][0] == plain


@pytest.mark.parametrize("type_", ["text", "recordio"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_of_either_package_serves_in_the_other_without_source(tmp_path, writer, type_):
    src = _corpus(tmp_path, type_)
    want = _drain(create_input_split(src, 0, 1, type_, threaded=False, chunk_bytes=4096))
    uri = f"{src}#{tmp_path / 'c.cache'}"
    assert _drain(FACTORY[writer](uri, 0, 1, type_, chunk_bytes=4096)) == want
    os.rename(src, src + ".away")  # a cache-only pass never opens the source
    reader = OTHER[writer]
    split = FACTORY[reader](uri, 0, 1, type_, chunk_bytes=4096)
    assert _drain(split) == want
    split = FACTORY[reader](uri, 0, 1, type_, chunk_bytes=4096)
    first = [bytes(split.next_record()) for _ in range(5)]
    split.before_first()  # a rewind of a warm pass reads the cache again
    assert first + [bytes(r) for r in split.iter_records()][5:] == want
    split.close()


def _flip(path, offset):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0x5A]))


@pytest.mark.parametrize("damage", ["first_frame", "middle_frame", "last_byte", "torn_tail"])
def test_damaged_cache_heals_with_reference_counters(tmp_path, damage):
    src = _text_corpus(tmp_path / "c.libsvm")
    want = _drain(create_input_split(src, 0, 1, "text", threaded=False, chunk_bytes=4096))
    out = {}
    for pkg, factory in FACTORY.items():
        d = tmp_path / pkg
        d.mkdir()
        uri = f"{src}#{d / 'c.cache'}"
        cache = str(d / "c.cache")
        assert _drain(factory(uri, 0, 1, "text", chunk_bytes=4096)) == want
        with open(cache, "rb") as f:
            clean = f.read()
        if damage == "torn_tail":
            with open(cache, "r+b") as f:
                f.truncate(len(clean) - 7)
        else:
            _flip(cache, {"first_frame": 8 + 12 + 3, "middle_frame": len(clean) // 2,
                          "last_byte": len(clean) - 1}[damage])
        base = RES[pkg].counters_snapshot()
        got = _drain(factory(uri, 0, 1, "text", chunk_bytes=4096))
        d_ = RES[pkg].counters_delta(base)
        with open(cache, "rb") as f:
            rewritten = f.read()
        out[pkg] = (got, rewritten, {k: d_.get(k, 0) for k in (
            "cache_corruptions", "cache_rebuilds", "cache_invalidations")})
    assert out["port"] == out["jax"]
    got, rewritten, counts = out["port"]
    assert got == want and rewritten == clean
    assert counts == {"cache_corruptions": 1, "cache_rebuilds": 1, "cache_invalidations": 0}


@pytest.mark.parametrize("head", [b"", b"0123456789abcdef", b"DMLCCHK0" + bytes(20)])
def test_stale_header_invalidates_with_reference_counters(tmp_path, head):
    src = _text_corpus(tmp_path / "c.libsvm")
    want = _drain(create_input_split(src, 0, 1, "text", threaded=False, chunk_bytes=4096))
    out = {}
    for pkg, factory in FACTORY.items():
        d = tmp_path / pkg
        d.mkdir()
        cache = d / "c.cache"
        cache.write_bytes(head + b"1 0:1\n")  # an older build's headerless cache
        base = RES[pkg].counters_snapshot()
        got = _drain(factory(f"{src}#{cache}", 0, 1, "text", chunk_bytes=4096))
        d_ = RES[pkg].counters_delta(base)
        out[pkg] = (got, cache.read_bytes(), d_.get("cache_invalidations", 0),
                    d_.get("cache_corruptions", 0))
    assert out["port"] == out["jax"]
    assert out["port"][0] == want and out["port"][2] == 1 and out["port"][3] == 0


def test_cache_pinned_while_served(tmp_path):
    src = _text_corpus(tmp_path / "c.libsvm")
    uri = f"{src}#{tmp_path / 'c.cache'}"
    _drain(create_input_split(uri, 0, 1, "text"))
    split = create_input_split(uri, 0, 1, "text")
    assert isinstance(split, CachedInputSplit) and split._mode == "cached"
    st = port_mgr.store_for(str(tmp_path / "c.cache"))
    assert [e["pinned"] for e in st.entries()] == [True]
    split.next_record()
    split.close()
    assert [(e["pinned"], e["tier"]) for e in st.entries()] == [(False, "chunk_cache")]
    with pytest.raises(DMLCError, match="reset_partition"):
        create_input_split(uri, 0, 1, "text").reset_partition(0, 2)


def test_interrupted_first_pass_publishes_nothing(tmp_path):
    # far more 4 KiB chunks than the producer's 16-chunk queue: the first
    # pass cannot finish (and publish) before the rewind
    src = _text_corpus(tmp_path / "c.libsvm", n=20000)
    cache = tmp_path / "c.cache"
    want = _drain(create_input_split(src, 0, 1, "text", threaded=False, chunk_bytes=4096))
    split = create_input_split(f"{src}#{cache}", 0, 1, "text", chunk_bytes=4096)
    for _ in range(10):
        split.next_record()
    split.before_first()  # the partial staging file goes; the pass restarts
    assert not cache.exists()
    assert [bytes(r) for r in split.iter_records()] == want
    split.close()
    assert cache.exists()
    assert [n for n in os.listdir(tmp_path) if n.endswith(".tmp")] == []


@pytest.mark.parametrize("nparts", [1, 2])
def test_create_parser_cachefile_epochs_equal_plain(tmp_path, monkeypatch, nparts):
    """``create_parser(path#cache)`` serves the plain chain's blocks, cold
    and then warm with the source renamed away, on every part."""
    src = _text_corpus(tmp_path / "c.libsvm")

    def rows(p):
        out = []
        for b in p:
            for i in range(len(b)):
                s, e = int(b.offset[i]), int(b.offset[i + 1])
                out.append((float(b.label[i]), b.index[s:e].tolist(),
                            np.asarray(b.value[s:e]).tolist()))
        return out

    for part in range(nparts):
        plain = create_parser(src, part, nparts, "libsvm", chunk_bytes=4096, parse_workers=1)
        want = rows(plain)
        plain.close()
        p = create_parser(f"{src}#{tmp_path / 'h.cache'}", part, nparts, "libsvm",
                          chunk_bytes=4096, parse_workers=1)
        assert type(p).__name__ == "ThreadedParser"  # never the fused reader
        assert rows(p) == want
        os.rename(src, src + ".away")
        p.before_first()
        assert rows(p) == want
        p.close()
        os.rename(src + ".away", src)
    names = sorted(n for n in os.listdir(tmp_path) if n.startswith("h.cache"))
    assert names == (["h.cache"] if nparts == 1
                     else ["h.cache.split2.part0", "h.cache.split2.part1"])


# ---------------- fault C11: DeviceIter over a warm chain ----------------

def _ell_batches(it) -> list:
    """The epoch's ELL batches as bytes (indices, values, label, weight)."""
    out = [tuple(t.numpy().tobytes() for t in (b.indices, b.values, b.label, b.weight))
           for b in it]
    it.close()
    return out


def _device_iter(parser):
    from dmlc_tpu_torch.data import DeviceIter

    return DeviceIter(parser, num_col=31, batch_size=64, layout="ell", max_nnz=8,
                      device="cpu")


@pytest.mark.parametrize("workers", [1, 3])
def test_c11_device_iter_over_a_warm_cachefile_chain(tmp_path, workers):
    """After the first pass wrote the chunk cache, a ``DeviceIter`` built
    over a fresh ``path#cache`` chain, the source renamed away, constructs
    (its scope walk does not build the source split behind the cache) and
    yields the plain run's batches."""
    src = _text_corpus(tmp_path / "c.libsvm")
    cache = tmp_path / "c.cache"
    plain = _ell_batches(_device_iter(create_parser(src, chunk_bytes=4096,
                                                    parse_workers=workers)))
    first = _ell_batches(_device_iter(create_parser(f"{src}#{cache}", chunk_bytes=4096,
                                                    parse_workers=workers)))
    assert first == plain and cache.exists() and len(plain) == 900 // 64 + 1
    os.rename(src, src + ".away")
    it = _device_iter(create_parser(f"{src}#{cache}", chunk_bytes=4096,
                                    parse_workers=workers))
    assert _ell_batches(it) == plain


def test_c11_warm_block_cache_under_device_iter_builds_no_cold_chain(tmp_path):
    """A warm ``BlockCacheIter`` under ``DeviceIter``: construction and a
    whole epoch never build its cold chain (its factory raises if called,
    and ``_base`` stays None), and the batches are the cold pass's."""
    src = _text_corpus(tmp_path / "c.libsvm")
    bc = str(tmp_path / "c.bc")
    plain = _ell_batches(_device_iter(create_parser(src, chunk_bytes=4096, block_cache=bc)))
    warm = create_parser(src, chunk_bytes=4096, block_cache=bc)
    assert warm.cache_state == "warm" and warm._base is None

    def build():
        raise AssertionError("the warm pass built the cold chain")

    warm._base_factory = build
    it = _device_iter(warm)
    assert warm._base is None
    got = [tuple(t.numpy().tobytes() for t in (b.indices, b.values, b.label, b.weight))
           for b in it]
    assert warm._base is None
    it.close()
    assert got == plain
