"""The port's row iterators, serializer and ``Row`` against the JAX
package's, and the slice as a whole on the learner.

- ``utils/serializer``: scalars, strings, bytes, nested lists and dicts,
  numpy arrays of every wire dtype; the streams are byte-equal, each
  reads the other's, and a truncated stream raises ``DMLCError``;
- ``Row`` and the ``RowBlock`` row views (``get_value``, ``sdot``,
  slices), ``save`` / ``load`` bytes, ``RowBlockContainer.push_row``;
- ``BasicRowIter`` and ``DiskRowIter`` blocks equal JAX's (one and
  several pages); a page cache is byte-identical across the packages and
  served by the other, with the source renamed away; a truncated page
  cache raises ``DMLCError``; ``create_row_block_iter``'s argument
  checks raise as JAX's, and the data service raises in the port;
- the slice as a whole: a ``mem://`` corpus through ``create_parser``
  (the chunk feeder) into ``DeviceIter(device="cpu", layout="ell")`` and
  ``LinearLearner``, 20 steps within 1e-5 of the JAX learner on its own
  ``mem://`` corpus; the same with a ``DiskRowIter`` as the source.
"""

import io
import os

import numpy as np
import pytest
import torch

from dmlc_tpu.data import iterators as jax_iters
from dmlc_tpu.data import row_block as jax_rb
from dmlc_tpu.data.device import DeviceIter as JaxDeviceIter
from dmlc_tpu.data.parsers import create_parser as jax_create_parser
from dmlc_tpu.io import filesystem as jax_fs
from dmlc_tpu.models.linear import LinearLearner as JaxLinearLearner
from dmlc_tpu.store import manager as jax_mgr
from dmlc_tpu.utils import serializer as jax_ser
from dmlc_tpu.utils.check import DMLCError as JaxDMLCError
from dmlc_tpu_torch import convert
from dmlc_tpu_torch.data import DeviceIter, iterators
from dmlc_tpu_torch.data import row_block as rb
from dmlc_tpu_torch.data.native_parser import NativeFeedParser
from dmlc_tpu_torch.data.parsers import create_parser
from dmlc_tpu_torch.io import filesystem as fs_mod
from dmlc_tpu_torch.models import LinearLearner
from dmlc_tpu_torch.store import manager as port_mgr
from dmlc_tpu_torch.utils import serializer as ser
from dmlc_tpu_torch.utils.check import DMLCError

TOL = 1e-5
NUM_COL = 24
ROWS = 1344  # 21 batches of 64: the 20 compared steps see each row once


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


@pytest.fixture
def deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def _corpus_bytes(n=ROWS, seed=5, qid=False):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        ids = np.sort(rng.choice(NUM_COL, size=int(rng.integers(1, 9)), replace=False))
        feats = " ".join(f"{j}:{rng.normal():.4f}" for j in ids)
        q = f" qid:{i // 7}" if qid else ""
        rows.append(f"{int(rng.random() < 0.5)}:{0.5 + rng.random():.3f}{q} {feats}")
    return ("\n".join(rows) + "\n").encode()


# ---------------- the serializer ----------------

OBJECTS = [
    None, True, False, 0, -(1 << 63), (1 << 63) - 1, 3.25, float("inf"), "", "héllo",
    b"\x00\xff", bytearray(b"ab"), [1, "a", None, [2.5, {"k": b"v"}]],
    {"a": 1, "b": [True, {"c": "d"}], "e": {}},
    np.arange(12, dtype=np.int64).reshape(3, 4),
    np.linspace(0, 1, 7, dtype=np.float32), np.array([], dtype=np.uint64),
    np.array([[1, 2], [3, 4]], dtype=np.uint8), np.float32(2.5), np.int16(-3),
    {"arr": np.array([1.5, -2.0]), "nested": [np.zeros((2, 0), np.int32)]},
]


def _dump(mod, obj) -> bytes:
    buf = io.BytesIO()
    mod.write_obj(buf, obj)
    return buf.getvalue()


def _same_obj(a, b):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same_obj(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_obj(x, y)
    else:
        assert a == b and type(a) is type(b)


@pytest.mark.parametrize("obj", OBJECTS, ids=[str(i) for i in range(len(OBJECTS))])
def test_serializer_streams_byte_equal_both_ways(obj):
    mine, theirs = _dump(ser, obj), _dump(jax_ser, obj)
    assert mine == theirs
    _same_obj(ser.read_obj(io.BytesIO(theirs)), jax_ser.read_obj(io.BytesIO(theirs)))
    _same_obj(jax_ser.read_obj(io.BytesIO(mine)), ser.read_obj(io.BytesIO(mine)))


def test_serializer_scalars_strings_and_errors():
    for kind in ser._FMT:
        value = 1 if kind != "bool" else True
        a, b = io.BytesIO(), io.BytesIO()
        ser.write_scalar(a, value, kind)
        jax_ser.write_scalar(b, value, kind)
        assert a.getvalue() == b.getvalue()
        assert ser.read_scalar(io.BytesIO(a.getvalue()), kind) == value
    a, b = io.BytesIO(), io.BytesIO()
    ser.write_str(a, "dmlc")
    jax_ser.write_str(b, "dmlc")
    assert a.getvalue() == b.getvalue() and ser.read_str(io.BytesIO(b.getvalue())) == "dmlc"
    full = _dump(ser, {"a": np.arange(10)})
    for cut in (0, 1, 9, len(full) - 1):
        with pytest.raises(DMLCError) as got:
            ser.read_obj(io.BytesIO(full[:cut]))
        with pytest.raises(JaxDMLCError) as want:
            jax_ser.read_obj(io.BytesIO(full[:cut]))
        assert str(got.value) == str(want.value)
    for bad in (object(), {1: 2}, 1 << 64):
        with pytest.raises(DMLCError) as got:
            _dump(ser, bad)
        with pytest.raises(JaxDMLCError) as want:
            _dump(jax_ser, bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(DMLCError, match="bad tag 42"):
        ser.read_obj(io.BytesIO(b"\x2a"))


# ---------------- Row and RowBlock ----------------

def _block_pair(tmp_path, qid=False):
    path = tmp_path / "rows.libsvm"
    path.write_bytes(_corpus_bytes(n=200, qid=qid))
    port = create_parser(str(path), threaded=False, chunk_bytes=4096)
    jax = jax_create_parser(str(path) + "?engine=python", threaded=False, chunk_bytes=4096)
    pb, jb = port.next_block(), jax.next_block()
    port.close()
    jax.close()
    return pb, jb


def _row_fields(row, w):
    return (row.label, row.weight, row.qid, None if row.field is None else row.field.tolist(),
            row.index.tolist(), None if row.value is None else row.value.tolist(), len(row),
            [row.get_value(i) for i in range(len(row))], row.sdot(w))


@pytest.mark.parametrize("qid", [False, True])
def test_rows_and_block_views_match_reference(tmp_path, qid):
    pb, jb = _block_pair(tmp_path, qid)
    w = np.random.default_rng(0).normal(size=NUM_COL).astype(np.float32)
    assert len(pb) == len(jb) and pb.num_nonzero == jb.num_nonzero
    assert [_row_fields(r, w) for r in pb] == [_row_fields(r, w) for r in jb]
    assert _row_fields(pb[-1], w) == _row_fields(jb[-1], w)
    assert pb.mem_cost_bytes() == jb.mem_cost_bytes()
    sp, sj = pb[3:9], jb[3:9]
    assert [_row_fields(r, w) for r in sp] == [_row_fields(r, w) for r in sj]
    for bad in (len(pb), -len(pb) - 1):
        with pytest.raises(DMLCError, match="out of range"):
            pb[bad]
    with pytest.raises(DMLCError, match="stepped"):
        pb[::2]
    a, b = io.BytesIO(), io.BytesIO()
    pb.save(a)
    jb.save(b)
    assert a.getvalue() == b.getvalue()
    back = rb.RowBlock.load(io.BytesIO(b.getvalue()))
    assert [_row_fields(r, w) for r in back] == [_row_fields(r, w) for r in jb]
    binary = rb.Row(1.0, 1.0, None, None, np.array([0, 2]), None)
    jbinary = jax_rb.Row(1.0, 1.0, None, None, np.array([0, 2]), None)
    assert (binary.get_value(1), binary.sdot(w)) == (jbinary.get_value(1), jbinary.sdot(w))


def test_container_push_row_matches_reference():
    out = []
    for mod in (rb, jax_rb):
        c = mod.RowBlockContainer()
        c.push_row(1.0, [3, 5], value=[0.5, 1.5], weight=2.0, qid=7)
        c.push_row(0.0, [1], value=[4.0], weight=1.0, qid=8)
        assert len(c) == 2
        buf = io.BytesIO()
        c.to_block().save(buf)
        c.clear()
        assert len(c) == 0
        out.append(buf.getvalue())
    assert out[0] == out[1]


# ---------------- the row iterators ----------------

def _iter_blocks(it, epochs=2):
    out = []
    for _ in range(epochs):
        out.append([_save(b) for b in it])
        it.before_first()
    return out


def _save(block) -> bytes:
    buf = io.BytesIO()
    block.save(buf)
    return buf.getvalue()


def _write(tmp_path, name, data):
    path = tmp_path / name
    path.write_bytes(data)
    return str(path)


@pytest.mark.parametrize("qid", [False, True])
def test_basic_row_iter_matches_reference(tmp_path, qid):
    path = _write(tmp_path, "b.libsvm", _corpus_bytes(qid=qid))
    port = iterators.create_row_block_iter(path, silent=True, chunk_bytes=4096)
    jax = jax_iters.create_row_block_iter(path, silent=True, chunk_bytes=4096)
    assert isinstance(port, iterators.BasicRowIter)
    assert _iter_blocks(port) == _iter_blocks(jax)
    assert port.num_col == jax.num_col and port.autotune is None
    assert len(port.block) == ROWS


@pytest.mark.parametrize("page_bytes", [iterators.CACHE_PAGE_BYTES, 4096])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_disk_row_iter_pages_cross_packages(tmp_path, page_bytes, writer):
    path = _write(tmp_path, "d.libsvm", _corpus_bytes())
    caches = {pkg: str(tmp_path / f"{pkg}.pages") for pkg in ("port", "jax")}
    made = {}
    for pkg, mod, make in (("port", iterators, create_parser),
                           ("jax", jax_iters, jax_create_parser)):
        parser = make(path + ("?engine=python" if pkg == "jax" else ""), threaded=False,
                      chunk_bytes=4096)
        made[pkg] = mod.DiskRowIter(parser, caches[pkg], page_bytes=page_bytes, silent=True)
    assert open(caches["port"], "rb").read() == open(caches["jax"], "rb").read()
    want = _iter_blocks(made["jax"])
    assert _iter_blocks(made["port"]) == want
    assert made["port"].num_col == made["jax"].num_col == NUM_COL
    if page_bytes == 4096:
        assert len(want[0]) > 3  # several pages
    for it in made.values():
        it.close()
    os.rename(path, path + ".away")  # the pages alone serve now
    other = caches[writer]
    for mod in (iterators, jax_iters):
        it = mod.DiskRowIter(None, other, silent=True)
        assert _iter_blocks(it) == want
        it.close()
    it = iterators.create_row_block_iter(path + "#" + other, silent=True)
    assert isinstance(it, iterators.DiskRowIter) and _iter_blocks(it) == want
    it.close()


def test_truncated_page_cache_raises(tmp_path):
    path = _write(tmp_path, "t.libsvm", _corpus_bytes())
    cache = str(tmp_path / "t.pages")
    iterators.DiskRowIter(create_parser(path, threaded=False), cache, silent=True).close()
    data = open(cache, "rb").read()
    for cut in (20, 40, len(data) // 2, len(data) - 4):
        with open(cache, "wb") as f:
            f.write(data[:cut])
        with pytest.raises(DMLCError):
            iterators.DiskRowIter(None, cache, silent=True)
        with pytest.raises(JaxDMLCError):
            jax_iters.DiskRowIter(None, cache, silent=True)
    with open(cache, "wb") as f:
        f.write(b"not a cache at all")
    with pytest.raises(DMLCError, match="no parser given"):
        iterators.DiskRowIter(None, cache, silent=True)


def test_create_row_block_iter_checks_match_reference(tmp_path):
    path = _write(tmp_path, "c.libsvm", _corpus_bytes(n=100))
    cache = str(tmp_path / "c.pages")
    for kw in ({"shuffle_seed": 3}, {"shuffle_window": 16}, {"pod_sharding": (0, 2)}):
        with pytest.raises(JaxDMLCError) as want:
            jax_iters.create_row_block_iter(path + "#" + cache, silent=True, **kw)
        with pytest.raises(DMLCError) as got:
            iterators.create_row_block_iter(path + "#" + cache, silent=True, **kw)
        assert str(got.value) == str(want.value)
    for kw in ({"shuffle_seed": 3}, {"pod_sharding": True}):
        with pytest.raises(JaxDMLCError) as want:
            jax_iters.create_row_block_iter(path, silent=True, **kw)
        with pytest.raises(DMLCError) as got:
            iterators.create_row_block_iter(path, silent=True, **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(DMLCError, match="data service"):
        iterators.create_row_block_iter(path, service="127.0.0.1:1", silent=True)
    with pytest.raises(DMLCError, match="service="):
        iterators.create_row_block_iter(path + "#service=127.0.0.1:1", silent=True)
    with pytest.raises(DMLCError, match="Cannot find any files"):
        iterators.create_row_block_iter(str(tmp_path / "none.libsvm"), silent=True)
    assert not os.path.exists(cache)
    part = iterators.create_row_block_iter(path + "#" + cache, 1, 2, silent=True)
    assert part.cache_file == cache + ".split2.part1" and os.path.exists(part.cache_file)
    part.close()
    bc = iterators.create_row_block_iter(path, silent=True, block_cache=str(tmp_path / "c.bc"))
    assert os.path.exists(str(tmp_path / "c.bc")) and len(bc.block) == 100


# ---------------- the slice as a whole ----------------

def _twenty_steps(port, jax, port_it, jax_it):
    got, want = [], []
    while len(got) < 20:
        for pb, jb in zip(port_it, jax_it):
            want.append(float(jax.step(jb)))
            got.append(float(port.step(pb)))
            if len(got) == 20:
                break
        port_it.reset()
        jax_it.reset()
    port_it.close()
    jax_it.close()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    for p, j in zip(convert.linear_params_to_jax(port.params), jax.params):
        np.testing.assert_allclose(p, np.asarray(j), rtol=TOL, atol=TOL)
    return got


def _learners():
    jax = JaxLinearLearner(NUM_COL, layout="ell", learning_rate=0.3)
    port = LinearLearner(NUM_COL, layout="ell", learning_rate=0.3, device="cpu")
    port.set_params(convert.linear_params_from_jax(*(np.asarray(p) for p in jax.params),
                                                   device="cpu"))
    return port, jax


def test_memfs_corpus_trains_as_reference(deterministic):
    data = _corpus_bytes()
    for mod in (fs_mod, jax_fs):
        mod.MemoryFileSystem.instance().store["train/c.libsvm"] = data
    port, jax = _learners()
    parser = create_parser("mem://train/c.libsvm", chunk_bytes=4096)
    assert isinstance(parser, NativeFeedParser)
    port_it = DeviceIter(parser, num_col=port.device_num_col(), batch_size=64, layout="ell",
                         max_nnz=8, device="cpu")
    jax_it = JaxDeviceIter(jax_create_parser("mem://train/c.libsvm", chunk_bytes=4096),
                           num_col=port.device_num_col(), batch_size=64, layout="ell",
                           max_nnz=8)
    assert type(jax_it.source).__name__ == "NativeFeedParser"
    losses = _twenty_steps(port, jax, port_it, jax_it)
    assert losses[-1] < losses[0]


def test_disk_row_iter_source_trains_as_reference(tmp_path, deterministic):
    path = _write(tmp_path, "s.libsvm", _corpus_bytes(seed=6))
    port, jax = _learners()
    cache = str(tmp_path / "s.pages")
    src = iterators.create_row_block_iter(path + "#" + cache, silent=True, chunk_bytes=4096)
    assert isinstance(src, iterators.DiskRowIter)
    port_it = DeviceIter(src, num_col=port.device_num_col(), batch_size=64, layout="ell",
                         max_nnz=8, device="cpu")
    jax_src = jax_iters.create_row_block_iter(path + "#" + str(tmp_path / "j.pages"),
                                              silent=True, chunk_bytes=4096)
    jax_it = JaxDeviceIter(jax_src, num_col=port.device_num_col(), batch_size=64,
                           layout="ell", max_nnz=8)
    _twenty_steps(port, jax, port_it, jax_it)
    # a second pipeline over the built pages, the source renamed away
    os.rename(path, path + ".away")
    again = iterators.create_row_block_iter(path + "#" + cache, silent=True)
    it = DeviceIter(again, num_col=port.device_num_col(), batch_size=64, layout="ell",
                    max_nnz=8, device="cpu")
    assert sum(1 for _ in it) == ROWS // 64
    it.close()
