"""Parity of the port's libsvm parse path with dmlc_tpu.data.create_parser.

For each corpus — plain, NOEOL, CRLF, blank lines and comments, weighted
labels with binary features, 1-based indices through ``?indexing_mode=1``
— and each engine (native C++ scanner, numpy), every partition of
``num_parts`` in {1, 3} parses to the same rows in both packages, byte for
byte, and the partitions together hold every row of the file exactly once.
"""

import numpy as np
import pytest

from dmlc_tpu.data import create_parser as jax_create_parser
from dmlc_tpu_torch import native
from dmlc_tpu_torch.data import LibSVMParser, create_parser
from dmlc_tpu_torch.io import LineSplitter


def _lines(rng, n, one_based=False):
    out = []
    for i in range(n):
        k = int(rng.integers(1, 6))
        idx = np.sort(rng.choice(20, size=k, replace=False)) + (1 if one_based else 0)
        feats = " ".join(f"{j}:{rng.normal():.4f}" for j in idx)
        out.append(f"{i % 2} {feats}")
    return out


def _corpus(kind, rng):
    if kind == "plain":
        return "\n".join(_lines(rng, 120)) + "\n", ""
    if kind == "noeol":
        return "\n".join(_lines(rng, 120)), ""
    if kind == "crlf":
        return "\r\n".join(_lines(rng, 120)) + "\r\n", ""
    if kind == "blank_comments":
        lines = _lines(rng, 120)
        lines[3] += "  # trailing comment"
        return "\n\n".join(lines[:60]) + "\n\n\n" + "\n".join(lines[60:]) + "\n", ""
    if kind == "weighted_binary":
        lines = [f"{i % 2}:{1 + i % 3} " + " ".join(
            str(j) for j in sorted(rng.choice(30, size=3, replace=False)))
            for i in range(120)]
        return "\n".join(lines) + "\n", ""
    if kind == "one_based":
        return "\n".join(_lines(rng, 120, one_based=True)) + "\n", "?indexing_mode=1"
    raise ValueError(kind)


def _rows(parser):
    """The rows a parser emits, concatenated: lengths, label, index, value
    (ones for binary), weight (ones when unweighted) — block boundaries
    may differ between engines, rows may not."""
    lens, label, index, value, weight = [], [], [], [], []
    for b in parser:
        lens.append(np.diff(b.offset))
        label.append(b.label)
        index.append(b.index)
        value.append(b.value if b.value is not None
                     else np.ones(len(b.index), np.float32))
        weight.append(b.weight if b.weight is not None
                      else np.ones(len(b.label), np.float32))
    parser.close()
    cat = [np.concatenate(x) if x else np.empty(0) for x in
           (lens, label, index, value, weight)]
    return cat


def _assert_rows_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


@pytest.mark.parametrize("engine", ["native", "numpy"])
@pytest.mark.parametrize("kind", ["plain", "noeol", "crlf", "blank_comments",
                                  "weighted_binary", "one_based"])
def test_create_parser_rows_match_reference(tmp_path, kind, engine):
    if engine == "native":
        assert native.available(), "the native parser failed to build"
    rng = np.random.default_rng(len(kind))
    text, args = _corpus(kind, rng)
    path = tmp_path / f"{kind}.libsvm"
    path.write_bytes(text.encode())
    uri = str(path) + args
    whole = None
    for num_parts in (1, 3):
        parts = []
        for part in range(num_parts):
            got = _rows(create_parser(uri, part, num_parts, "libsvm",
                                      engine="auto" if engine == "native" else "python"))
            want = _rows(jax_create_parser(uri, part, num_parts, "libsvm",
                                           engine="native" if engine == "native" else "python"))
            _assert_rows_equal(got, want)
            parts.append(got)
        joined = [np.concatenate([p[i] for p in parts]) for i in range(5)]
        if whole is None:
            whole = joined
            assert len(whole[0]) == 120
        else:
            # no row dropped or duplicated across partitions
            _assert_rows_equal(joined, whole)


def test_engine_selection(tmp_path):
    path = tmp_path / "e.libsvm"
    path.write_text("1 0:1.5 3:2\n0 1:0.5\n")
    assert native.available() and native.build_seconds is not None
    auto = create_parser(str(path), 0, 1, "libsvm")
    python = create_parser(str(path), 0, 1, "libsvm", engine="python")
    assert (auto.engine, python.engine) == ("native", "numpy")
    _assert_rows_equal(_rows(auto), _rows(python))


@pytest.mark.parametrize("engine", ["auto", "python"])
def test_lines_longer_than_the_chunk(tmp_path, engine):
    """A line longer than the read chunk grows the chunk (Chunk::Load)
    instead of splitting the record."""
    rng = np.random.default_rng(9)
    lines = []
    for i in range(30):
        k = 2000 if i % 7 == 3 else 4   # ~26 KB lines among short ones
        idx = np.sort(rng.choice(5000, size=k, replace=False))
        lines.append(f"{i % 2} " + " ".join(f"{j}:{rng.normal():.4f}" for j in idx))
    path = tmp_path / "long.libsvm"
    path.write_text("\n".join(lines) + "\n")
    for num_parts in (1, 3):
        for part in range(num_parts):
            split = LineSplitter(str(path), part, num_parts, chunk_bytes=4096)
            got = _rows(LibSVMParser(split, engine=engine))
            want = _rows(jax_create_parser(str(path), part, num_parts, "libsvm",
                                           engine="native" if engine == "auto" else "python",
                                           chunk_bytes=4096))
            _assert_rows_equal(got, want)
