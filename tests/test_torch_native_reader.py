"""The port's fused native reader (``data/native_parser.py`` over
``native.Reader``), against the JAX package's.

On the CPU, the same seeded files through the JAX package's
``NativeStreamParser`` and the port's (both over ``native/src/reader.cc``,
each package's own build), compared byte for byte:

- the blocks of every partition at 1, 2, 3, 4 and 7 parts, equal to the
  port's registry stack's rows, and again after ``before_first``;
- the dense emit, the qid downgrade to CSR (``needs_csr``), csv (the
  ``FMT_CSV_SPLIT`` route included) and libfm with its fields, the rows a
  batch repack delivers before a parse error;
- the packed dense repack in float32 and bfloat16 (as ``uint16`` bits);
- the COO emit on the pair and CSR wires, with and without unit-value
  elision, bucketed;
- ``state_dict`` equal as JSON, ``load_state`` across the packages both
  ways;
- ``csr_coords`` against ``_csr_coords_impl`` and the native COO emit
  mapped to the port's pad scheme (``native_coo_to_port``);
- ``DeviceIter`` over the reader: packed dense batches equal to the JAX
  package's; ``bcoo`` natural blocks (pair and CSR wire, elision on and
  off) giving the JAX ``LinearLearner`` and ``FMLearner`` trajectories
  within 1e-5; routing of ``create_parser`` to the reader exactly where
  the JAX package routes.
"""

import json
import os

import numpy as np
import pytest
import torch

from dmlc_tpu import native as jax_native
from dmlc_tpu.data import create_parser as jax_create_parser
from dmlc_tpu.data.device import DeviceIter as JaxDeviceIter
from dmlc_tpu.data.device import _csr_coords_impl
from dmlc_tpu.data.native_parser import NativeStreamParser as JaxNativeStreamParser
from dmlc_tpu.models.fm import FMLearner as JaxFMLearner
from dmlc_tpu.models.linear import LinearLearner as JaxLinearLearner
from dmlc_tpu_torch import convert, native
from dmlc_tpu_torch.data import DeviceIter, create_parser
from dmlc_tpu_torch.data.native_parser import (NativeStreamParser, list_partition_files,
                                               native_reader_eligible)
from dmlc_tpu_torch.data.row_block import CooBlock, DenseBlock, RowBlock
from dmlc_tpu_torch.models import FMLearner, LinearLearner
from dmlc_tpu_torch.ops.sparse import csr_coords, native_coo_to_port
from dmlc_tpu_torch.utils.check import DMLCError

TOL = 1e-5
CSR_KEYS = ("offset", "label", "weight", "qid", "field", "index", "value")


@pytest.fixture(autouse=True)
def _native_built(monkeypatch):
    assert native.available(), "the port's native parser failed to build"
    assert jax_native.available(), "the JAX package's native parser failed to build"
    for var in ("DMLC_TPU_NO_NATIVE_READER", "DMLC_TPU_PARSE_ENGINE",
                "DMLC_TPU_PARSE_THREADS"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture
def deterministic():
    """Float trajectories are compared with torch's deterministic kernels
    (its CPU backward of a gather otherwise adds with parallel atomics)."""
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


@pytest.fixture
def corpus(tmp_path):
    """Three files with the boundary traps: a join without a newline, blank
    lines, a comment, CRLF."""
    a = tmp_path / "a.txt"
    a.write_bytes(b"1 0:1.5 2:2.5\n0 1:3.0\n\n1 4:0.25\n")
    b = tmp_path / "b.txt"
    b.write_bytes(b"1 0:7.0")
    c = tmp_path / "c.txt"
    c.write_bytes(b"# comment only\r\n0 2:9.0\r\n1 0:1 1:2\n0 3:4\n")
    return ";".join(str(p) for p in (a, b, c))


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def _bits(arr):
    return None if arr is None else (np.asarray(arr).dtype.str, np.asarray(arr).tobytes())


def _block_bits(block):
    """A block's arrays as (dtype, bytes) pairs: bfloat16 (JAX) and the
    port's uint16 view compare by their bits."""
    if isinstance(block, RowBlock) or type(block).__name__ == "RowBlock":
        return ("csr",) + tuple(_bits(getattr(block, k)) for k in CSR_KEYS)
    if type(block).__name__ == "DenseBlock":
        return ("dense", block.packed,
                *(None if a is None else np.asarray(a).view(
                    np.uint16 if np.asarray(a).dtype.itemsize == 2 else np.uint32).tobytes()
                  for a in (block.x, block.label, block.weight)))
    return ("coo", block.n_rows, block.nnz, block.num_col,
            *(_bits(a) for a in (block.coords, block.values, block.label, block.weight,
                                 block.row_ptr)))


def _drain(parser, close=True):
    out = []
    while True:
        b = parser.next_block()
        if b is None:
            break
        out.append(_block_bits(b))
    if close:
        parser.close()
    return out


def _csr_rows(blocks):
    """Concatenated CSR arrays of a RowBlock stream (offsets re-based)."""
    parts = {k: [] for k in CSR_KEYS}
    base = 0
    for b in blocks:
        parts["offset"].append(b.offset[1:] + base if parts["offset"] else b.offset + base)
        base += int(b.offset[-1])
        for k in CSR_KEYS[1:]:
            v = getattr(b, k)
            if v is not None:
                parts[k].append(np.asarray(v))
    return {k: (np.concatenate(v).tobytes() if v else None) for k, v in parts.items()}


def _registry(uri, part, nparts, fmt, monkeypatch):
    monkeypatch.setenv("DMLC_TPU_NO_NATIVE_READER", "1")
    try:
        p = create_parser(uri, part, nparts, fmt, threaded=False)
    finally:
        monkeypatch.delenv("DMLC_TPU_NO_NATIVE_READER")
    return p


# ---------------- partitions and epochs ----------------

@pytest.mark.parametrize("nparts", [1, 2, 3, 4, 7])
def test_partitions_match_jax_and_the_registry_stack(corpus, nparts, monkeypatch):
    port_all, reg_all = [], []
    for part in range(nparts):
        port = NativeStreamParser(corpus, {}, part, nparts, "libsvm")
        jax = JaxNativeStreamParser(corpus, {}, part, nparts, "libsvm")
        got, want = _drain(port, close=False), _drain(jax)
        assert got == want
        port.before_first()
        port_all += list(iter(port.next_block, None))
        port.close()
        reg_all += list(_registry(corpus, part, nparts, "libsvm", monkeypatch))
    assert _csr_rows(port_all) == _csr_rows(reg_all)
    assert sum(len(b) for b in port_all) == 7


def test_same_blocks_after_before_first(corpus):
    port = NativeStreamParser(corpus, {}, 0, 2, "libsvm")
    first = _drain(port, close=False)
    port.before_first()
    second = _drain(port, close=False)
    assert port.bytes_read > 0
    port.close()
    assert first == second and first


def test_list_partition_files_and_checks(corpus):
    paths, sizes = list_partition_files(corpus)
    assert paths == corpus.split(";") and sizes == [os.path.getsize(p) for p in paths]
    for part, nparts in ((0, 0), (3, 2), (-1, 2)):
        with pytest.raises(DMLCError):
            NativeStreamParser(corpus, {}, part, nparts, "libsvm")
    with pytest.raises(DMLCError, match="does not support"):
        NativeStreamParser(corpus, {}, 0, 1, "recordio")


# ---------------- the dense emit, csv, libfm ----------------

def test_dense_emit_and_qid_downgrade(tmp_path):
    f = _write(tmp_path, "d.libsvm", "1 0:1.0 2:3.0\n0 1:2.0\n")
    blocks = []
    for cls in (NativeStreamParser, JaxNativeStreamParser):
        p = cls(f, {}, 0, 1, "libsvm")
        assert p.set_emit_dense(4)
        blocks.append(_drain(p))
    assert blocks[0] == blocks[1] and blocks[0][0][0] == "dense"
    p = NativeStreamParser(f, {}, 0, 1, "libsvm")
    p.set_emit_dense(4)
    b = p.next_block()
    p.close()
    assert isinstance(b, DenseBlock) and not b.packed
    np.testing.assert_array_equal(b.x, [[1, 0, 3, 0], [0, 2, 0, 0]])
    # the dense scanner cannot express qid rows: the reader turns to CSR
    q = _write(tmp_path, "q.libsvm", "1 qid:7 0:1.0\n0 qid:8 1:2.0\n" * 50)
    with pytest.raises(native.NeedsCsrError):
        native.parse_libsvm_dense(b"1 qid:3 0:1.0\n", 4)
    got = []
    for cls in (NativeStreamParser, JaxNativeStreamParser):
        p = cls(q, {}, 0, 1, "libsvm")
        p.set_emit_dense(4, batch_rows=16)
        got.append(_drain(p))
    assert got[0] == got[1] and got[0][0][0] == "csr"


@pytest.mark.parametrize("args", [{}, {"label_column": "0"},
                                  {"label_column": "2", "weight_column": "5"},
                                  {"label_column": "5", "delimiter": ";"}])
def test_csv_blocks_match_jax(tmp_path, args, monkeypatch):
    rng = np.random.default_rng(7)
    delim = args.get("delimiter", ",")
    text = "".join(delim.join(f"{v:.5f}" for v in rng.normal(size=6)) + "\n"
                   for _ in range(400))
    f = _write(tmp_path, "s.csv", text)
    port = NativeStreamParser(f, dict(args), 0, 1, "csv", chunk_bytes=4096)
    jax = JaxNativeStreamParser(f, dict(args), 0, 1, "csv", chunk_bytes=4096)
    split = args.get("label_column") is not None
    assert port._stream_config()[0] == (native.FMT_CSV_SPLIT if split else native.FMT_CSV)
    got, want = _drain(port), _drain(jax)
    assert got == want and len(got) > 1
    # the rows equal the registry stack's (synthetic indices 0..k)
    query = "?format=csv" + "".join(f"&{k}={v}" for k, v in args.items())
    port = NativeStreamParser(f, dict(args), 0, 1, "csv", chunk_bytes=4096)
    blocks = list(iter(port.next_block, None))
    port.close()
    reg = list(_registry(f + query, 0, 1, "csv", monkeypatch))
    assert _csr_rows(blocks) == _csr_rows(reg)


def test_csv_checks(tmp_path):
    f = _write(tmp_path, "c.csv", "1,2,3\n4,5,6\n")
    with pytest.raises(DMLCError, match="float32"):
        NativeStreamParser(f, {"dtype": "int32"}, 0, 1, "csv")
    with pytest.raises(DMLCError, match="one char"):
        NativeStreamParser(f, {"delimiter": ";;"}, 0, 1, "csv")
    with pytest.raises(DMLCError, match="differ"):
        NativeStreamParser(f, {"label_column": "1", "weight_column": "1"}, 0, 1, "csv")
    bad = NativeStreamParser(f, {"label_column": "9"}, 0, 1, "csv")
    with pytest.raises(DMLCError):
        list(iter(bad.next_block, None))
    bad.close()


def test_libfm_blocks_with_fields(tmp_path, monkeypatch):
    rng = np.random.default_rng(3)
    lines = [f"{i % 2} " + " ".join(f"{f}:{rng.integers(0, 500)}:{rng.random():.3f}"
                                    for f in range(4)) for i in range(300)]
    f = _write(tmp_path, "t.libfm", "\n".join(lines) + "\n")
    port = NativeStreamParser(f, {"indexing_mode": "-1"}, 0, 1, "libfm", chunk_bytes=4096)
    jax = JaxNativeStreamParser(f, {"indexing_mode": "-1"}, 0, 1, "libfm", chunk_bytes=4096)
    assert _drain(port) == _drain(jax)
    port = NativeStreamParser(f, {}, 0, 1, "libfm")
    blocks = list(iter(port.next_block, None))
    port.close()
    assert all(b.field is not None for b in blocks)
    assert int(blocks[0].field[0]) == 0 and int(blocks[0].field[3]) == 3
    assert _csr_rows(blocks) == _csr_rows(_registry(f + "?format=libfm", 0, 1, "libfm",
                                                    monkeypatch))
    assert not NativeStreamParser(f, {}, 0, 1, "libfm").set_emit_dense(4)


def test_batch_repack_delivers_clean_rows_before_the_error(tmp_path):
    good = "".join(f"1 0:{i}.5\n" for i in range(2000))
    f = _write(tmp_path, "err.libsvm", good + "0 bad$token\n")

    def rows_before_error(cls, batch_rows):
        p = cls(f, {}, 0, 1, "libsvm", chunk_bytes=4096)
        p.set_emit_dense(4, batch_rows=batch_rows)
        rows = 0
        with pytest.raises(Exception, match="bad|parse|malformed|invalid"):
            while (blk := p.next_block()) is not None:
                rows += len(blk)
        p.close()
        return rows

    plain = rows_before_error(NativeStreamParser, 0)
    assert plain > 0
    assert rows_before_error(NativeStreamParser, 64) == plain
    assert rows_before_error(JaxNativeStreamParser, 64) == plain


# ---------------- the packed dense repack ----------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", ["libsvm", "csv"])
@pytest.mark.parametrize("pack", [True, False])
def test_packed_repack_bits_match_jax(tmp_path, dtype, fmt, pack):
    if fmt == "libsvm":
        f = _write(tmp_path, "p.libsvm", "".join(
            f"{i % 2}:{0.5 + (i % 3)} 0:{i}.5 2:{(i * 7) % 50}\n" for i in range(500)))
        args = {}
    else:
        f = _write(tmp_path, "p.csv", "".join(
            f"{i % 2},{i * 0.5},{-i}.25,{(i % 5) + 0.5}\n" for i in range(300)))
        args = {"label_column": "0", "weight_column": "3"}
    num_col = 4 if fmt == "libsvm" else 2
    got = []
    for cls in (NativeStreamParser, JaxNativeStreamParser):
        p = cls(f, dict(args), 0, 1, fmt, chunk_bytes=2048)
        assert p.set_emit_dense(num_col, batch_rows=64, dtype=dtype, pack_aux=pack)
        got.append(_drain(p))
    assert got[0] == got[1] and len(got[0]) > 1
    p = NativeStreamParser(f, dict(args), 0, 1, fmt, chunk_bytes=2048)
    p.set_emit_dense(num_col, batch_rows=64, dtype=dtype, pack_aux=pack)
    blocks = list(iter(p.next_block, None))
    p.close()
    want_dt = np.uint16 if dtype == "bfloat16" else np.float32
    for b in blocks:
        assert b.packed == pack and b.x.dtype == want_dt
        assert b.x.shape[1] == num_col + (2 if pack else 0)
        if pack:  # label and weight are views of the trailing columns
            assert np.shares_memory(b.label, b.x) and np.shares_memory(b.weight, b.x)
    assert {len(b) for b in blocks[:-1]} == {64}


# ---------------- the COO emit ----------------

COO_NUM_COL = 1_000


def _libfm_corpus(tmp_path, n=400, unit=True, oob=False):
    lines = []
    for i in range(n):
        val = "1" if unit else f"{(i % 7) + 0.5:.1f}"
        feats = [f"{j}:{(i * 2654435761 + j * 40503) % COO_NUM_COL}:{val}" for j in range(6)]
        if oob and i % 5 == 0:
            feats.insert(2, f"6:{COO_NUM_COL + 3 + i}:{val}")  # past the width
            feats.insert(1, f"7:{COO_NUM_COL}:{val}")
        lines.append(f"{i % 2} " + " ".join(feats))
    return _write(tmp_path, "c.libfm", "\n".join(lines) + "\n")


COO_KW = [dict(), dict(row_bucket=128, nnz_bucket=512),
          dict(row_bucket=128, nnz_bucket=512, elide_unit=True),
          dict(row_bucket=128, nnz_bucket=512, csr_wire=True),
          dict(row_bucket=128, nnz_bucket=512, elide_unit=True, csr_wire=True)]


@pytest.mark.parametrize("kw", COO_KW, ids=lambda kw: "-".join(sorted(kw)) or "exact")
@pytest.mark.parametrize("unit", [True, False])
def test_coo_emit_matches_jax(tmp_path, kw, unit):
    f = _libfm_corpus(tmp_path, unit=unit, oob=True)
    got = []
    for cls in (NativeStreamParser, JaxNativeStreamParser):
        p = cls(f, {}, 0, 1, "libfm", chunk_bytes=4096)
        assert p.set_emit_coo(COO_NUM_COL, **kw)
        got.append(_drain(p))
    assert got[0] == got[1] and len(got[0]) > 1
    p = NativeStreamParser(f, {}, 0, 1, "libfm", chunk_bytes=4096)
    p.set_emit_coo(COO_NUM_COL, **kw)
    blocks = list(iter(p.next_block, None))
    p.close()
    for b in blocks:
        assert isinstance(b, CooBlock) and b.shape == (len(b.label), COO_NUM_COL)
        assert (b.values is None) == (unit and kw.get("elide_unit", False))
        assert (b.row_ptr is not None) == kw.get("csr_wire", False)
        if kw.get("nnz_bucket"):
            assert len(b.coords) % 512 == 0 and len(b.label) % 128 == 0
    assert sum(b.n_rows for b in blocks) == 400
    assert not NativeStreamParser(f, {}, 0, 1, "libfm").set_emit_coo((1 << 31) - 1)
    csv = _write(tmp_path, "x.csv", "1,2\n")
    assert not NativeStreamParser(csv, {}, 0, 1, "csv").set_emit_coo(4)


def test_csr_coords_and_the_port_pad_scheme(tmp_path):
    """``csr_coords`` gives JAX's rows on every entry (real and pad);
    ``native_coo_to_port`` keeps the real entries' coordinates and values
    and gives every slot JAX masks (the tail pads and the ids clamped to
    ``num_col`` inside the real entries) value 0 at an in-bounds
    coordinate, elided or not."""
    f = _libfm_corpus(tmp_path, unit=False, oob=True)
    pair, csr = [], []
    for wire, out in ((False, pair), (True, csr)):
        for elide in (False, True):
            p = NativeStreamParser(f, {}, 0, 1, "libfm", chunk_bytes=4096)
            p.set_emit_coo(COO_NUM_COL, row_bucket=128, nnz_bucket=512,
                           elide_unit=elide, csr_wire=wire)
            out.append(list(iter(p.next_block, None)))
            p.close()
    masked_inside = 0
    for bp, bc in zip(pair[0], csr[0]):
        rows_padded = len(bp.label)
        want = np.asarray(_csr_coords_impl(np.asarray(bc.coords), np.asarray(bc.row_ptr)))
        got = csr_coords(torch.from_numpy(np.array(bc.coords)),
                         torch.from_numpy(np.array(bc.row_ptr))).numpy()
        assert got.dtype == np.int32 and got.tobytes() == want.tobytes()
        assert got.tobytes() == bp.coords.tobytes()
        coords, vals = native_coo_to_port(torch.from_numpy(np.array(bp.coords)),
                                          torch.from_numpy(np.array(bp.values)),
                                          COO_NUM_COL, rows_padded)
        coords, vals = coords.numpy(), vals.numpy()
        raw = np.asarray(bp.coords)
        live = (raw[:, 0] < rows_padded) & (raw[:, 1] < COO_NUM_COL)
        masked_inside += int((~live[:bp.nnz]).sum())
        assert (coords[:, 0] < rows_padded).all() and (coords[:, 1] < COO_NUM_COL).all()
        np.testing.assert_array_equal(coords[live], raw[live])
        np.testing.assert_array_equal(vals[live], np.asarray(bp.values)[live])
        assert (vals[~live] == 0).all()
        # the JAX product over BCOO equals the port's over the mapped slots
        dense = np.zeros((rows_padded, COO_NUM_COL), np.float32)
        np.add.at(dense, (coords[:, 0], coords[:, 1]), vals)
        jdense = np.zeros((rows_padded + 1, COO_NUM_COL + 1), np.float32)
        np.add.at(jdense, (raw[:, 0], raw[:, 1]), np.asarray(bp.values))
        np.testing.assert_array_equal(dense, jdense[:rows_padded, :COO_NUM_COL])
        # elided values are the mask itself, never plain ones
        _, ones = native_coo_to_port(torch.from_numpy(np.array(bp.coords)), None,
                                     COO_NUM_COL, rows_padded)
        np.testing.assert_array_equal(ones.numpy(), live.astype(np.float32))
    assert masked_inside > 0


# ---------------- states ----------------

@pytest.mark.parametrize("fmt", ["libsvm", "libfm"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_states_equal_and_restore_across_packages(tmp_path, fmt, writer):
    rng = np.random.default_rng(11)
    sep = ":" if fmt == "libfm" else ""
    lines = [f"{i % 2} " + " ".join(
        (f"{j}{sep}" if fmt == "libfm" else "") + f"{rng.integers(0, 300)}:{rng.random():.3f}"
        for j in range(5)) for i in range(900)]
    f = _write(tmp_path, f"s.{fmt}", "\n".join(lines) + "\n")
    make = {"port": NativeStreamParser, "jax": JaxNativeStreamParser}
    reader = {"port": "jax", "jax": "port"}[writer]
    full = _drain(make[reader](f, {}, 1, 2, fmt, chunk_bytes=4096))
    assert len(full) > 3
    for cut in (0, 2, len(full)):
        src = make[writer](f, {}, 1, 2, fmt, chunk_bytes=4096)
        mirror = make[reader](f, {}, 1, 2, fmt, chunk_bytes=4096)
        for _ in range(cut):
            src.next_block()
            mirror.next_block()
        state = json.loads(json.dumps(src.state_dict()))
        assert state == mirror.state_dict()
        assert state == {"kind": "blocks", "blocks": cut, "part_index": 1, "num_parts": 2}
        src.close()
        mirror.close()
        # into a parser pointed at another partition: the state's shard first
        dst = make[reader](f, {}, 0, 3, fmt, chunk_bytes=4096)
        dst.load_state(state)
        assert (dst.part_index, dst.num_parts) == (1, 2)
        assert _drain(dst) == full[cut:]
    p = NativeStreamParser(f, {}, 0, 1, fmt)
    with pytest.raises(DMLCError, match="incompatible resume state"):
        p.load_state({"kind": "split", "split": {}, "chunks": 1})


def test_reset_partition_keeps_bytes_read(corpus):
    p = NativeStreamParser(corpus, {}, 0, 2, "libsvm")
    _drain(p, close=False)
    first = p.bytes_read
    p.reset_partition(1, 2)
    _drain(p, close=False)
    assert p.bytes_read > first > 0
    stats = p.parallel_stats()
    assert stats["engine"] == "native" and stats["parse_parallelism_efficiency"] is None
    assert stats["parse_workers"] == native.default_nthread() == jax_native.default_nthread()
    assert p.stall_seconds >= 0.0 and p.engine == "native"
    p.close()


def test_parse_threads_knob_matches_jax(monkeypatch):
    for raw in ("3", "1"):
        monkeypatch.setenv("DMLC_TPU_PARSE_THREADS", raw)
        assert native.default_nthread() == jax_native.default_nthread() == int(raw)
    monkeypatch.delenv("DMLC_TPU_PARSE_THREADS")
    assert native.default_nthread() == jax_native.default_nthread()


# ---------------- routing ----------------

@pytest.mark.parametrize("case", [
    ("libsvm", "", {}), ("csv", "?format=csv&label_column=0", {}),
    ("libfm", "?format=libfm", {}), ("libsvm", "", {"threaded": False}),
    ("libsvm", "?engine=python", {}), ("csv", "?format=csv&dtype=int32", {}),
    ("libsvm", "", {"engine": "python"}), ("libsvm", "", {"engine": "native"}),
    ("libsvm", "", {"env": "DMLC_TPU_NO_NATIVE_READER"}),
    ("libsvm", "", {"env": "DMLC_TPU_PARSE_ENGINE"}),
], ids=lambda c: f"{c[0]}{c[1]}-{'-'.join(f'{k}={v}' for k, v in c[2].items())}")
def test_create_parser_routes_where_jax_does(tmp_path, case, monkeypatch):
    fmt, query, opts = case
    text = "1,2,3\n0,4,5\n" if fmt == "csv" else (
        "1 0:1:1 1:2:1\n" if fmt == "libfm" else "1 0:1 2:2\n0 1:1\n")
    f = _write(tmp_path, f"r.{fmt}", text)
    opts = dict(opts)
    env = opts.pop("env", None)
    if env == "DMLC_TPU_NO_NATIVE_READER":
        monkeypatch.setenv(env, "1")
    elif env:
        monkeypatch.setenv(env, "python")
    port = create_parser(f + query, 0, 1, "auto", **opts)
    jax = jax_create_parser(f + query, 0, 1, "auto", **opts)
    native_route = type(jax).__name__ == "NativeStreamParser"
    assert isinstance(port, NativeStreamParser) == native_route
    assert native_route == (opts.get("engine", "native") == "native" and not env
                            and opts.get("threaded", True) and "engine" not in query
                            and "dtype" not in query)
    assert (_csr_rows(list(iter(port.next_block, None)))
            == _csr_rows(list(iter(jax.next_block, None))))
    port.close()
    jax.close()
    assert native_reader_eligible(f, fmt, True) == (fmt in ("libsvm", "csv", "libfm"))
    assert not native_reader_eligible(f + "#blockcache=" + str(tmp_path / "bc"), fmt, True)


# ---------------- DeviceIter over the reader ----------------

def _dense_corpus(tmp_path, n=700, d=6):
    rng = np.random.default_rng(2)
    w = rng.normal(size=d)
    lines = []
    for _ in range(n):
        x = rng.normal(size=d)
        lines.append(f"{int(x @ w > 0)} " + " ".join(f"{j}:{x[j]:.4f}" for j in range(d)))
    return _write(tmp_path, "dense.libsvm", "\n".join(lines) + "\n")


def _packed_bits(t):
    t = torch.as_tensor(np.asarray(t)) if not isinstance(t, torch.Tensor) else t
    return t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32).numpy()


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("drop_remainder", [False, True])
def test_deviceiter_packed_dense_matches_jax(tmp_path, x_dtype, drop_remainder):
    f = _dense_corpus(tmp_path)
    kw = dict(num_col=7, batch_size=64, layout="dense", x_dtype=x_dtype, pack_aux=True,
              drop_remainder=drop_remainder)
    port_parser = create_parser(f, chunk_bytes=4096)
    assert isinstance(port_parser, NativeStreamParser)
    port = DeviceIter(port_parser, device="cpu", **kw)
    jax = JaxDeviceIter(jax_create_parser(f, chunk_bytes=4096), **kw)
    got = [_packed_bits(b.packed) for b in port]
    import jax.numpy as jnp
    want = [_packed_bits(np.asarray(b.packed.astype(jnp.float32)).astype(np.float32))
            if x_dtype == "float32" else np.asarray(b.packed).view(np.int16) for b in jax]
    port.close()
    jax.close()
    assert len(got) == len(want) == (700 // 64 if drop_remainder else -(-700 // 64))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert port.stats()["parse_parallel"]["engine"] == "native"


def test_deviceiter_bf16_pack_checks_the_labels(tmp_path):
    f = _write(tmp_path, "w.libsvm", "".join(f"{i % 2}:{1 + i / 1000} 0:{i}\n"
                                             for i in range(300)))
    it = DeviceIter(create_parser(f), num_col=2, batch_size=64, layout="dense",
                    x_dtype="bfloat16", pack_aux=True, device="cpu")
    with pytest.raises(DMLCError, match="not bf16-exact"):
        next(it)
    it.close()


def _bcoo_pair(path, num_col, csr_wire, elide, query="?format=libfm"):
    kw = dict(num_col=num_col, batch_size=None, layout="bcoo", nnz_bucket=512,
              row_bucket=128, csr_wire=csr_wire, elide_unit_values=elide)
    port = DeviceIter(create_parser(path + query, chunk_bytes=4096), device="cpu", **kw)
    jax = JaxDeviceIter(jax_create_parser(path + query, chunk_bytes=4096), **kw)
    return port, jax


@pytest.mark.parametrize("csr_wire", [False, True])
@pytest.mark.parametrize("elide", [False, True])
@pytest.mark.parametrize("unit", [True, False])
def test_bcoo_natural_blocks_match_jax(tmp_path, csr_wire, elide, unit):
    f = _libfm_corpus(tmp_path, n=900, unit=unit, oob=True)
    port, jax = _bcoo_pair(f, COO_NUM_COL, csr_wire, elide)
    got = [(x.to_dense().numpy(), y.numpy(), w.numpy()) for x, y, w in port]
    want = [(np.asarray(m.todense()), np.asarray(y), np.asarray(w)) for m, y, w in jax]
    port.close()
    jax.close()
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def _trajectory(port_model, jax_model, port_it, jax_it, steps=20):
    got, want = [], []
    while len(got) < steps:
        for pb, jb in zip(port_it, jax_it):
            want.append(float(jax_model.step(jb)))
            got.append(float(port_model.step(pb)))
            if len(got) == steps:
                break
        port_it.reset()
        jax_it.reset()
    port_it.close()
    jax_it.close()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    return got


@pytest.mark.parametrize("csr_wire", [False, True])
@pytest.mark.parametrize("elide", [False, True])
def test_bcoo_linear_trajectory_over_the_reader(tmp_path, csr_wire, elide, deterministic):
    f = _libfm_corpus(tmp_path, n=900, oob=True)
    jax = JaxLinearLearner(COO_NUM_COL, layout="bcoo", learning_rate=0.5)
    port = LinearLearner(COO_NUM_COL, layout="bcoo", learning_rate=0.5, device="cpu")
    port.set_params(convert.linear_params_from_jax(*(np.asarray(p) for p in jax.params),
                                                   device="cpu"))
    port_it, jax_it = _bcoo_pair(f, COO_NUM_COL, csr_wire, elide)
    _trajectory(port, jax, port_it, jax_it)
    for p, j in zip(convert.linear_params_to_jax(port.params), jax.params):
        np.testing.assert_allclose(p, np.asarray(j), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("csr_wire", [False, True])
def test_bcoo_fm_trajectory_over_the_reader(tmp_path, csr_wire, deterministic):
    import optax

    f = _libfm_corpus(tmp_path, n=900, unit=False, oob=True)
    kw = dict(num_factors=4, layout="bcoo", learning_rate=0.05, init_scale=0.1)
    jax = JaxFMLearner(COO_NUM_COL, seed=3, optimizer=optax.sgd(0.2), **kw)
    port = FMLearner(COO_NUM_COL, device="cpu",
                     optimizer=lambda params: torch.optim.SGD(params, lr=0.2), **kw)
    port.set_params(convert.fm_params_from_jax(*(np.asarray(p) for p in jax.params), "cpu"))
    port_it, jax_it = _bcoo_pair(f, COO_NUM_COL, csr_wire, False)
    _trajectory(port, jax, port_it, jax_it)
    for p, j in zip(convert.fm_params_to_jax(port.params), jax.params):
        np.testing.assert_allclose(p, np.asarray(j), rtol=TOL, atol=TOL)


def test_bcoo_natural_restore_by_block_count(tmp_path):
    f = _libfm_corpus(tmp_path, n=900)
    port, jax = _bcoo_pair(f, COO_NUM_COL, True, True)
    full = [x.to_dense().numpy() for x, _, _ in port]
    port.reset()
    for _ in range(2):
        next(port)
        next(jax)
    state = json.loads(json.dumps(port.state_dict()))
    assert state == jax.state_dict() == {"kind": "batches", "batches": 2}
    port.close()
    jax.close()
    fresh, _ = _bcoo_pair(f, COO_NUM_COL, True, True)
    fresh.load_state(state)
    rest = [x.to_dense().numpy() for x, _, _ in fresh]
    fresh.close()
    assert len(rest) == len(full) - 2
    for a, b in zip(rest, full[2:]):
        np.testing.assert_array_equal(a, b)


# ---------------- one set_emit_dense interface ----------------

@pytest.mark.parametrize("threaded", [False, True])
def test_registry_stack_takes_the_reader_emit_keywords(tmp_path, threaded, monkeypatch):
    """The registry stack's ``set_emit_dense`` takes the reader's repack
    keywords and ignores them: chunk-sized, unpacked float32 blocks, the
    same rows as a call with ``num_col`` alone."""
    text = "".join(f"{i % 2} 0:{i}.5 3:{i}.25\n" for i in range(40))
    f = _write(tmp_path, "d.libsvm", text)
    got = []
    for kw in ({}, {"batch_rows": 16, "dtype": "bfloat16", "pack_aux": True}):
        monkeypatch.setenv("DMLC_TPU_NO_NATIVE_READER", "1")
        p = create_parser(f, 0, 1, "libsvm", threaded=threaded, parse_workers=2)
        monkeypatch.delenv("DMLC_TPU_NO_NATIVE_READER")
        assert not isinstance(p, NativeStreamParser)
        assert p.set_emit_dense(4, **kw)
        blocks = []
        while (b := p.next_block()) is not None:
            blocks.append(b)
        p.close()
        assert all(isinstance(b, DenseBlock) and not b.packed and b.x.dtype == np.float32
                   for b in blocks)
        got.append([_block_bits(b) for b in blocks])
    assert got[0] == got[1]


def test_deviceiter_does_not_swallow_an_emit_error():
    """``DeviceIter`` makes one ``set_emit_dense`` call: a ``TypeError``
    raised inside it reaches the caller, with no retry on ``num_col``
    alone that would quietly drop the repack."""

    class Source:
        def set_emit_dense(self, num_col, batch_rows=0, dtype="float32", pack_aux=False):
            if batch_rows:
                raise TypeError("raised inside set_emit_dense")
            return True

        def next_block(self):
            return None

    with pytest.raises(TypeError, match="raised inside"):
        DeviceIter(Source(), num_col=4, batch_size=2, layout="dense", device="cpu")


def test_parser_base_refuses_an_unknown_engine(tmp_path):
    """Engine resolution lives in ``create_parser``; the parser base takes
    ``auto`` or ``python`` only and refuses anything else with DMLCError."""
    from dmlc_tpu_torch.data.parsers import LibSVMParser
    from dmlc_tpu_torch.io.input_split import LineSplitter

    f = _write(tmp_path, "e.libsvm", "1 0:1\n")
    for engine in (None, "native", "native-batch", "numpy"):
        with pytest.raises(DMLCError, match="unknown parse engine"):
            LibSVMParser(LineSplitter(f, 0, 1), engine=engine)
