"""Parity of the port's csv and libfm parsers and its dense emit with
dmlc_tpu's, on both engines.

The JAX side runs as its own tests run it: the numpy scanner through
``create_parser(uri + "?engine=python", ...)``, the native per-chunk
scanner through its parser classes over an unthreaded split (their
``parse_chunk_native``), never its fused reader. The port runs
``create_parser(uri, ..., engine="auto" | "python")``. Blocks are held
field by field and dtype by dtype (``offset``, ``label``, ``weight``,
``qid``, ``index``, ``value``, ``field``; ``x`` for a dense block); the
engines against each other within the JAX tests' tolerance. Mirrors
``tests/test_data.py`` (csv, libfm, native parity, tab delimiter and bad
cells, dense against CSR, the dense weights and out-of-range columns, the
emit into ``DeviceIter``, the qid fallback, the csv emit) and the random
corpora of ``tests/test_properties.py`` under hypothesis; then states
equal as JSON and restored across the packages both ways.
"""

import json

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from dmlc_tpu import native as jax_native
from dmlc_tpu.data import create_parser as jax_create_parser
from dmlc_tpu.data.device import DeviceIter as JaxDeviceIter
from dmlc_tpu.data.parsers import CSVParser as JaxCSVParser
from dmlc_tpu.data.parsers import LibFMParser as JaxLibFMParser
from dmlc_tpu.data.parsers import LibSVMParser as JaxLibSVMParser
from dmlc_tpu.io.input_split import create_input_split
from dmlc_tpu.utils.check import DMLCError as JaxDMLCError
from dmlc_tpu_torch import native
from dmlc_tpu_torch.data import (CSVParser, DenseBlock, DeviceIter, LibFMParser, RowBlock,
                                 create_parser)
from dmlc_tpu_torch.data.parsers import CSVParserParam, LibFMParserParam, LibSVMParserParam
from dmlc_tpu_torch.ops.sparse import block_to_dense
from dmlc_tpu_torch.utils.check import DMLCError

ROW_FIELDS = ("offset", "label", "weight", "qid", "field", "index", "value")
JAX_CLASSES = {"libsvm": JaxLibSVMParser, "csv": JaxCSVParser, "libfm": JaxLibFMParser}
SETTLE = settings(max_examples=25, deadline=None,
                  suppress_health_check=[HealthCheck.function_scoped_fixture])


@pytest.fixture(autouse=True)
def _registry_stack(monkeypatch):
    """These cases hold the registry stack of ``create_parser`` (the split,
    the text parsers and their threaded wrappers) against the JAX package's
    Python chain. A plain local file now goes to the fused native reader,
    as in the JAX package, whose own tests reach the registry stack the
    same way; the reader has its own suite (test_torch_native_reader.py)."""
    monkeypatch.setenv("DMLC_TPU_NO_NATIVE_READER", "1")


@pytest.fixture(autouse=True)
def _native_built():
    assert native.available(), "the port's native parser failed to build"
    assert jax_native.available(), "the JAX package's native parser failed to build"


def _write(tmp_path, name, data) -> str:
    p = tmp_path / name
    p.write_bytes(data if isinstance(data, bytes) else data.encode())
    return str(p)


def _args(query: str) -> dict:
    return dict(kv.split("=", 1) for kv in query.split("&") if kv)


def _jax_blocks(path, fmt, query, engine, chunk_bytes=1 << 20):
    """The JAX package's blocks: its numpy chain, or its native per-chunk
    scanner through the parser class over an unthreaded split."""
    if engine == "python":
        p = jax_create_parser(f"{path}?format={fmt}&engine=python{query}", 0, 1, "auto",
                              threaded=False, chunk_bytes=chunk_bytes)
    else:
        split = create_input_split(path, 0, 1, "text", threaded=False, chunk_bytes=chunk_bytes)
        p = JAX_CLASSES[fmt](split, dict(_args(query), format=fmt))
        assert p.use_native()
    blocks = list(p)
    p.close()
    return blocks


def _port_blocks(path, fmt, query, engine, chunk_bytes=1 << 20, **kw):
    p = create_parser(f"{path}?format={fmt}{query}", 0, 1, "auto", threaded=False,
                      engine=engine, chunk_bytes=chunk_bytes, **kw)
    assert p.engine == ("numpy" if engine == "python" else "native")
    blocks = list(p)
    p.close()
    return blocks


def _fields(block) -> tuple:
    return ("x", "label", "weight") if isinstance(block, DenseBlock) else ROW_FIELDS


def _assert_same(port_block, jax_block):
    """Field by field, dtype by dtype, byte for byte."""
    assert type(port_block).__name__ == type(jax_block).__name__
    for name in _fields(port_block):
        a, b = getattr(port_block, name), getattr(jax_block, name)
        assert (a is None) == (b is None), name
        if a is not None:
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert a.tobytes() == b.tobytes(), name


def _assert_streams(port_blocks, jax_blocks):
    assert len(port_blocks) == len(jax_blocks) > 0
    for a, b in zip(port_blocks, jax_blocks):
        _assert_same(a, b)


def _merged(blocks) -> dict:
    """The rows of a block stream, concatenated (value and weight 1 where
    absent), for comparing the two engines."""
    out = {k: [] for k in ("nnz", "label", "weight", "index", "value", "field")}
    for b in blocks:
        out["nnz"].append(np.diff(b.offset))
        out["label"].append(b.label)
        out["weight"].append(b.weight if b.weight is not None else np.ones(len(b), np.float32))
        out["index"].append(b.index)
        out["value"].append(b.value if b.value is not None
                            else np.ones(len(b.index), np.float32))
        if b.field is not None:
            out["field"].append(b.field)
    return {k: np.concatenate(v) for k, v in out.items() if v}


def _assert_engines_agree(native_blocks, numpy_blocks):
    a, b = _merged(native_blocks), _merged(numpy_blocks)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(a[k].astype(np.float64), b[k].astype(np.float64),
                                   rtol=1e-5, err_msg=k)


def _both(path, fmt, query="", **kw):
    """Each engine's port blocks, held against the JAX package's on the same
    engine; returns the native and numpy streams."""
    out = []
    for engine in ("auto", "python"):
        got = _port_blocks(path, fmt, query, engine, **kw)
        _assert_streams(got, _jax_blocks(path, fmt, query, engine, **kw))
        out.append(got)
    _assert_engines_agree(*out)
    return out


# ---------------- csv ----------------

def test_csv_basic(tmp_path):
    path = _write(tmp_path, "a.csv", b"1.0,2.0,3.0\n4.0,5.0,6.0\n")
    for blocks in _both(path, "csv"):
        (blk,) = blocks
        np.testing.assert_array_equal(blk.label, [0, 0])  # no label column -> 0
        np.testing.assert_array_equal(blk.index, [0, 1, 2, 0, 1, 2])
        np.testing.assert_allclose(blk.value, [1, 2, 3, 4, 5, 6])
        assert not blk.index.flags.writeable and not blk.offset.flags.writeable


def test_csv_label_weight_columns(tmp_path):
    path = _write(tmp_path, "c.csv", b"7;1.5;2.5;0.9\n3;4.5;5.5;0.1\n-1;0;2e2;1\n")
    for blocks in _both(path, "csv", "&label_column=0&weight_column=3&delimiter=;"):
        (blk,) = blocks
        np.testing.assert_allclose(blk.label, [7, 3, -1])
        np.testing.assert_allclose(blk.weight, [0.9, 0.1, 1])
        np.testing.assert_allclose(blk.value, [1.5, 2.5, 4.5, 5.5, 0, 200])
        np.testing.assert_array_equal(blk.index, [0, 1] * 3)


@pytest.mark.parametrize("engine", ["auto", "python"])
def test_csv_ragged_raises(tmp_path, engine):
    path = _write(tmp_path, "d.csv", b"1,2,3\n4,5\n")
    with pytest.raises(JaxDMLCError) as want:
        _jax_blocks(path, "csv", "", engine)
    with pytest.raises(DMLCError) as got:
        _port_blocks(path, "csv", "", engine)
    assert str(got.value) == str(want.value)
    if engine == "python":
        assert "ragged" in str(got.value)


def test_csv_int_dtype_takes_the_numpy_engine(tmp_path):
    path = _write(tmp_path, "e.csv", b"1,2\n3,4\n")
    p = create_parser(path + "?format=csv&dtype=int64", threaded=False)
    assert isinstance(p, CSVParser) and p.engine == "numpy"
    (blk,) = list(p)
    want = _jax_blocks(path, "csv", "&dtype=int64", "python")
    _assert_streams([blk], want)
    np.testing.assert_allclose(blk.value, [1, 2, 3, 4])
    assert p.set_emit_dense(2) is False  # no dense scanner for int cells


def test_csv_bom_and_carriage_returns(tmp_path):
    path = _write(tmp_path, "bom.csv", b"\xef\xbb\xbf1,2,3\r\n4,5,6\r\n\r\n7,8,9\n")
    for blocks in _both(path, "csv", "&label_column=2"):
        np.testing.assert_allclose(blocks[0].label, [3, 6, 9])
        np.testing.assert_allclose(blocks[0].value, [1, 2, 4, 5, 7, 8])


def test_csv_parameter_checks_match_reference(tmp_path):
    path = _write(tmp_path, "f.csv", b"1,2\n")
    for query in ("&delimiter=ab", "&label_column=1&weight_column=1", "&dtype=float16",
                  "&label_column=x"):
        with pytest.raises(JaxDMLCError) as want:
            jax_create_parser(f"{path}?format=csv&engine=python{query}", threaded=False)
        with pytest.raises(DMLCError) as got:
            create_parser(f"{path}?format=csv{query}", threaded=False)
        assert str(got.value) == str(want.value)


# ---------------- libfm ----------------

def test_libfm_basic(tmp_path):
    path = _write(tmp_path, "a.libfm", b"1 0:3:1.5 2:7:2.5\n0 1:2:0.5\n")
    for blocks in _both(path, "libfm"):
        (blk,) = blocks
        np.testing.assert_array_equal(blk.field, [0, 2, 1])
        np.testing.assert_array_equal(blk.index, [3, 7, 2])
        np.testing.assert_allclose(blk.value, [1.5, 2.5, 0.5])
        assert blk.field.dtype == np.uint64


def test_libfm_indexing_heuristic(tmp_path):
    path = _write(tmp_path, "b.libfm", b"1 1:1:0.5 2:4:1.5\n0 1:3:1.5 2:7:2.5\n")
    for blocks in _both(path, "libfm", "&indexing_mode=-1"):
        np.testing.assert_array_equal(blocks[0].field, [0, 1, 0, 1])
        np.testing.assert_array_equal(blocks[0].index, [0, 3, 2, 6])
    # a zero field keeps both as they are, the heuristic shifting them together
    path = _write(tmp_path, "z.libfm", b"1 0:1:0.5 2:4:1.5\n")
    for blocks in _both(path, "libfm", "&indexing_mode=-1"):
        np.testing.assert_array_equal(blocks[0].field, [0, 2])
        np.testing.assert_array_equal(blocks[0].index, [1, 4])


@pytest.mark.parametrize("engine", ["auto", "python"])
def test_libfm_malformed_raises(tmp_path, engine):
    path = _write(tmp_path, "c.libfm", b"1 3:1.5\n")
    with pytest.raises(JaxDMLCError):
        _jax_blocks(path, "libfm", "", engine)
    with pytest.raises(DMLCError):
        _port_blocks(path, "libfm", "", engine)


def test_libfm_fast_and_general_paths(tmp_path):
    """Comments and a blank line send the numpy engine down its general
    path; the plain chunk takes the token table."""
    text = b"1 0:3:1.5 2:7:2.5  # note\n\n0 1:2:0.5\n"
    path = _write(tmp_path, "g.libfm", text)
    _both(path, "libfm")
    p = LibFMParser.__new__(LibFMParser)
    p.param = LibFMParserParam()
    p.index_dtype = np.uint64
    with pytest.raises((DMLCError, ValueError)):
        p.parse_chunk_py(b"1:2:3 4\n")  # a label colon: malformed


# ---------------- the native scanners ----------------

def test_native_csv_tab_delimiter_and_bad_cells():
    cells, _owner = native.parse_csv(b"1\t2.5\t3\n4\t5\t6\n", delimiter="\t")
    want, _jowner = jax_native.parse_csv(b"1\t2.5\t3\n4\t5\t6\n", delimiter="\t")
    assert cells.dtype == want.dtype and cells.tobytes() == want.tobytes()
    np.testing.assert_allclose(cells, [[1, 2.5, 3], [4, 5, 6]])
    for chunk, pattern in ((b"1,,2\n", "empty cell"), (b"1,abc,2\n", "unparseable|unexpected")):
        with pytest.raises(JaxDMLCError) as jerr:
            jax_native.parse_csv(chunk, delimiter=",")
        with pytest.raises(DMLCError, match=pattern) as err:
            native.parse_csv(chunk, delimiter=",")
        assert str(err.value) == str(jerr.value)


def test_native_chunk_from_a_memoryview():
    """A memoryview chunk (an mmap slice) parses in place, as bytes do."""
    raw = b"junk1 0:1 3:2\n0 2:5\n"
    got = native.parse_libsvm(memoryview(raw)[4:])
    want = native.parse_libsvm(raw[4:])
    for k in ("offset", "label", "index", "value"):
        assert got[k].tobytes() == want[k].tobytes()
    cells, _ = native.parse_csv(memoryview(b"xx1,2\n3,4\n")[2:])
    np.testing.assert_array_equal(cells, [[1, 2], [3, 4]])


@pytest.mark.parametrize("mode", [-1, 0, 1])
def test_native_dense_matches_csr_path(mode):
    """parse_libsvm_dense equals the CSR parse + block_to_dense, and the
    JAX package's dense scanner, byte for byte."""
    rng = np.random.default_rng(11)
    lines = []
    lo = 1 if mode != 0 else 0
    for _ in range(300):
        nnz = int(rng.integers(0, 12))
        idx = np.sort(rng.choice(np.arange(lo, 40 + lo), size=nnz, replace=False))
        lines.append(f"{int(rng.integers(0, 2))} " + " ".join(f"{j}:{rng.normal():.5g}"
                                                               for j in idx))
    text = ("\n".join(lines) + "\n").encode()
    x, y, w, _owner = native.parse_libsvm_dense(text, 40, indexing_mode=mode)
    jx, jy, jw, _jowner, _packed = jax_native.parse_libsvm_dense(text, 40, indexing_mode=mode)
    assert x.tobytes() == np.asarray(jx).tobytes() and y.tobytes() == jy.tobytes()
    assert w is None and jw is None  # no weights in the corpus
    d = native.parse_libsvm(text, indexing_mode=mode)
    block = RowBlock(offset=d["offset"], label=d["label"], index=d["index"],
                     value=d["value"], hold=d["_owner"])
    xr, yr, _wr = block_to_dense(block, 40)
    assert x.tobytes() == xr.tobytes() and y.tobytes() == yr.tobytes()


def test_native_dense_weight_and_out_of_range():
    x, y, w, _o = native.parse_libsvm_dense(b"1:0.5 0:2 9:7\n0:2.0 1:4\n", 3, indexing_mode=0)
    np.testing.assert_allclose(x, [[2, 0, 0], [0, 4, 0]])  # index 9 dropped
    np.testing.assert_allclose(w, [0.5, 2.0])
    with pytest.raises(native.NeedsCsrError):
        native.parse_libsvm_dense(b"1 qid:3 0:1\n", 3)
    with pytest.raises(DMLCError):
        native.parse_libsvm_dense(b"1 0:1 foo 2:3\n", 3)


# ---------------- the dense emit ----------------

def _libsvm_corpus(tmp_path, n=100, d=6, seed=5, name="d.libsvm", weight=False):
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        label = f"{i % 2}:{1 + i % 3}" if weight else f"{int(rng.integers(0, 2))}"
        lines.append(label + " " + " ".join(f"{j}:{rng.normal():.4f}" for j in range(d)))
    return _write(tmp_path, name, "\n".join(lines) + "\n")


def _csv_corpus(tmp_path, n=300, d=5, seed=2, name="c.csv"):
    rng = np.random.default_rng(seed)
    lines = [f"{i % 2}," + ",".join(f"{rng.normal():.5f}" for _ in range(d)) for i in range(n)]
    return _write(tmp_path, name, "\n".join(lines) + "\n")


def _batch_arrays(batch) -> list:
    arrays = [batch.packed, *batch] if hasattr(batch, "packed") else list(batch)
    return [np.asarray(a.contiguous().numpy() if isinstance(a, torch.Tensor) else a)
            for a in arrays]


def test_parser_emit_dense_flows_to_device_iter(tmp_path):
    path = _libsvm_corpus(tmp_path)
    p = create_parser(path, 0, 1, "libsvm", threaded=True)
    assert p.set_emit_dense(6)
    blocks = list(iter(p.next_block, None))
    p.close()
    assert all(isinstance(b, DenseBlock) for b in blocks)
    assert sum(len(b) for b in blocks) == 100
    # the emit into DeviceIter, packed and not: the JAX package's CSR route
    # (its numpy chain) gives the same batches, pad rows included
    for pack_aux in (True, False):
        p = create_parser(path, 0, 1, "libsvm", threaded=True)
        it = DeviceIter(p, num_col=6, batch_size=32, layout="dense", pack_aux=pack_aux,
                        device="cpu")
        assert isinstance(p.next_block(), DenseBlock)  # the iterator asked for them
        p.before_first()
        jit = JaxDeviceIter(jax_create_parser(path + "?engine=python", 0, 1, "libsvm",
                                              threaded=True, parse_workers=1),
                            num_col=6, batch_size=32, layout="dense", pack_aux=pack_aux)
        got, want = [_batch_arrays(b) for b in it], [_batch_arrays(b) for b in jit]
        it.close()
        jit.close()
        assert len(got) == len(want) == 4  # 100 rows -> 3 full + 1 padded batch
        for g, w in zip(got, want):
            assert [a.tobytes() for a in g] == [a.tobytes() for a in w]


def test_dense_emit_qid_falls_back_to_csr(tmp_path):
    lines = [f"1 qid:{i} 0:1 1:2" for i in range(10)]
    path = _write(tmp_path, "q.libsvm", "\n".join(lines) + "\n")
    p = create_parser(path, 0, 1, "libsvm", threaded=False)
    assert p.set_emit_dense(2)
    blocks = list(iter(p.next_block, None))
    p.close()
    assert all(isinstance(b, RowBlock) and b.qid is not None for b in blocks)
    assert p._emit_dense is None  # CSR for good
    want = _jax_blocks(path, "libsvm", "", "python")
    _assert_streams(blocks, want)


def test_csv_emit_dense(tmp_path):
    rng = np.random.default_rng(7)
    ref = rng.normal(size=(50, 5)).astype(np.float32)
    path = _write(tmp_path, "d.csv", "".join(",".join(f"{v:.6f}" for v in row) + "\n"
                                             for row in ref))
    p = create_parser(path + "?format=csv&label_column=0", 0, 1, "auto", threaded=False)
    assert p.set_emit_dense(4)
    blocks = list(iter(p.next_block, None))
    p.close()
    assert all(isinstance(b, DenseBlock) for b in blocks)
    np.testing.assert_allclose(np.concatenate([b.x for b in blocks]), ref[:, 1:],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.concatenate([b.label for b in blocks]), ref[:, 0],
                               rtol=1e-4, atol=1e-6)
    # the JAX package's native csv scanner in dense mode, block for block
    split = create_input_split(path, 0, 1, "text", threaded=False)
    jp = JaxCSVParser(split, {"format": "csv", "label_column": "0"})
    assert jp.set_emit_dense(4)
    _assert_streams(blocks, list(jp))
    # a narrower or wider width than the features keeps the first columns
    # and zero-fills the rest; no label column and the full width is zero-copy
    for width in (2, 7):
        p = create_parser(path + "?format=csv&label_column=0", threaded=False)
        p.set_emit_dense(width)
        (b,) = list(p)
        jp = JaxCSVParser(create_input_split(path, 0, 1, "text", threaded=False),
                          {"format": "csv", "label_column": "0"})
        jp.set_emit_dense(width)
        _assert_streams([b], list(jp))


@pytest.mark.parametrize("fmt", ["libsvm", "csv"])
@pytest.mark.parametrize("pack_aux", [True, False])
def test_dense_emit_batches_equal_the_csr_route(tmp_path, fmt, pack_aux):
    """Batches from the dense emit (the native engine) and from the CSR route
    (the numpy engine, densified on the producer) are the same bytes, with
    weights, a ragged tail and chunk-sized blocks split across batches."""
    if fmt == "libsvm":
        path, query = _libsvm_corpus(tmp_path, n=777, weight=True), ""
    else:
        path, query = _csv_corpus(tmp_path, n=777), "?format=csv&label_column=0&weight_column=2"

    def run(engine):
        p = create_parser(path + query, chunk_bytes=4096, engine=engine, parse_workers=2)
        it = DeviceIter(p, num_col=6, batch_size=100, layout="dense", pack_aux=pack_aux,
                        device="cpu")
        out = [_batch_arrays(b) for b in it]
        it.close()
        return out

    dense, csr = run("auto"), run("python")
    assert len(dense) == len(csr) == 8
    for a, b in zip(dense, csr):
        assert [x.tobytes() for x in a] == [x.tobytes() for x in b]


def test_dense_emit_is_declined_once_production_runs(tmp_path):
    path = _libsvm_corpus(tmp_path)
    p = create_parser(path, 0, 1, "libsvm", parse_workers=1)
    assert isinstance(p.next_block(), RowBlock)
    assert p.set_emit_dense(6) is False  # blocks of both kinds would mix
    p.close()
    p = create_parser(path, 0, 1, "libsvm", engine="python")
    assert p.set_emit_dense(6) is False  # no dense scanner in numpy
    assert isinstance(p.next_block(), RowBlock)
    p.close()


# ---------------- random corpora ----------------

@SETTLE
@given(cells=st.lists(st.lists(st.floats(-1e4, 1e4, width=32), min_size=3, max_size=3),
                      min_size=1, max_size=40),
       label_col=st.sampled_from([-1, 0, 1, 2]))
def test_csv_random_corpora(tmp_path_factory, cells, label_col):
    d = tmp_path_factory.mktemp("csvparity")
    path = _write(d, "c.csv", "\n".join(",".join(f"{v:.6g}" for v in row)
                                         for row in cells) + "\n")
    query = f"&label_column={label_col}" if label_col >= 0 else ""
    native_blocks, _ = _both(path, "csv", query)
    assert sum(len(b) for b in native_blocks) == len(cells)


@SETTLE
@given(rows=st.lists(st.lists(st.tuples(st.integers(0, 9), st.integers(0, 500),
                                        st.floats(-100, 100, width=32)),
                              min_size=1, max_size=5),
                     min_size=1, max_size=40),
       mode=st.sampled_from([-1, 0, 1]))
def test_libfm_random_corpora(tmp_path_factory, rows, mode):
    d = tmp_path_factory.mktemp("fmparity")
    lines = []
    for i, triples in enumerate(rows):
        triples = sorted({idx: (f, v) for f, idx, v in triples}.items())
        lines.append(f"{i % 2} " + " ".join(f"{f + (mode > 0)}:{idx + (mode > 0)}:{v:.5g}"
                                            for idx, (f, v) in triples))
    path = _write(d, "c.libfm", "\n".join(lines) + "\n")
    native_blocks, _ = _both(path, "libfm", f"&indexing_mode={mode}")
    assert sum(len(b) for b in native_blocks) == len(rows)


# ---------------- parameters and checkpoints ----------------

def test_parameter_structs_match_reference():
    from dmlc_tpu.data import parsers as jp

    for port_cls, jax_cls in ((LibSVMParserParam, jp.LibSVMParserParam),
                              (CSVParserParam, jp.CSVParserParam),
                              (LibFMParserParam, jp.LibFMParserParam)):
        assert port_cls().to_dict() == jax_cls().to_dict()
        args = {"indexing_mode": "-1", "label_column": "2", "delimiter": "\t",
                "weight_column": "1", "dtype": "int32", "extra": "x"}
        args = {k: v for k, v in args.items() if k in jax_cls.__fields__ or k == "extra"}
        p, j = port_cls(), jax_cls()
        assert p.init(dict(args), allow_unknown=True) == j.init(dict(args), allow_unknown=True)
        assert p.to_dict() == j.to_dict()
        with pytest.raises(JaxDMLCError) as want:
            jax_cls().init({"extra": "x"})
        with pytest.raises(DMLCError) as got:
            port_cls().init({"extra": "x"})
        assert str(got.value) == str(want.value)


def _js(obj) -> str:
    return json.dumps(obj, sort_keys=True, default=str)


@pytest.mark.parametrize("fmt", ["csv", "libfm"])
def test_states_equal_and_restore_across_packages(tmp_path, fmt):
    if fmt == "csv":
        path, query = _csv_corpus(tmp_path, n=600), "&label_column=0"
    else:
        rng = np.random.default_rng(1)
        lines = [f"{i % 2} " + " ".join(f"{j % 3}:{j}:{rng.normal():.5f}" for j in range(5))
                 for i in range(600)]
        path, query = _write(tmp_path, "s.libfm", "\n".join(lines) + "\n"), ""

    def jax_parser():
        return jax_create_parser(f"{path}?format={fmt}&engine=python{query}", 0, 1, "auto",
                                 threaded=True, parse_workers=1, chunk_bytes=4096)

    def port_parser(**kw):
        return create_parser(f"{path}?format={fmt}{query}", 0, 1, "auto", threaded=True,
                             chunk_bytes=4096, **kw)

    jp, pp = jax_parser(), port_parser(parse_workers=1)
    assert _js(jp.state_dict()) == _js(pp.state_dict())
    blocks, states = [], []
    while (a := jp.next_block()) is not None:
        b = pp.next_block()
        _assert_same(b, a)
        assert _js(a.resume_state) == _js(b.resume_state)
        assert _js(jp.state_dict()) == _js(pp.state_dict())
        blocks.append(b)
        states.append(json.loads(_js(pp.state_dict())))
    assert pp.next_block() is None and len(blocks) >= 5
    jp.close()
    pp.close()
    # a mid-stream state of either package restores in the other, and in
    # the port's fan-out over its mmap split
    k = 3
    for make in (jax_parser, lambda: port_parser(parse_workers=1),
                 lambda: port_parser(parse_workers=4)):
        p = make()
        p.load_state(states[k - 1])
        rest = list(iter(p.next_block, None))
        p.close()
        assert len(rest) == len(blocks) - k
        for got, want in zip(rest, blocks[k:]):
            for name in ROW_FIELDS:
                a, b = getattr(got, name), getattr(want, name)
                assert (a is None) == (b is None)
                assert a is None or np.asarray(a).tobytes() == b.tobytes(), name
