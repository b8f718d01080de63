"""The corpus writers: one seed, one corpus; and the reference's parse
reads back what the writer meant."""

import hashlib

import numpy as np
import pytest

from portbench import registry
from portbench.corpora import fixed_width as fw
from portbench.reference import parse

import tiny

CONFIGS = ["kdd12_fm", "criteo1tb_fm"]


def _write(tmp_path, cfg, seed, tag):
    path = tmp_path / f"{cfg['name']}.{tag}.txt"
    registry.corpus_writer(cfg["format"]).write(str(path), cfg, seed)
    return path


@pytest.mark.parametrize("name", CONFIGS)
def test_writer_is_deterministic_by_seed(tmp_path, name):
    cfg = tiny.config(name, rows=(1 << 16) + 300)  # crosses a writer block
    seed = 2 ** 31 + 5
    digest = [hashlib.sha256(_write(tmp_path, cfg, s, i).read_bytes()).hexdigest()
              for i, s in enumerate((seed, seed, seed + 1))]
    assert digest[0] == digest[1] != digest[2]


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_parse_reads_the_rows_the_writer_meant(tmp_path, name):
    cfg = tiny.config(name, rows=300)
    seed = 77
    path = _write(tmp_path, cfg, seed, "p")
    rng = np.random.default_rng(seed)
    ids = fw.draw_ids(rng, 300, cfg["fields"])
    micro = fw.draw_dense(rng, 300, cfg["dense"])
    k = cfg["max_nnz"]
    got_ids, got_vals, got_label, got_weight = parse.rows(str(path), cfg["format"], 0, 300,
                                                         cfg["num_col"], k)
    dense_ids = np.array([d["id"] for d in cfg["dense"]], dtype=np.int64)
    want_ids = np.concatenate([np.broadcast_to(dense_ids, (300, len(dense_ids))), ids], 1)
    want_vals = np.concatenate([(micro / 1e6).astype(np.float32),
                                np.ones(ids.shape, np.float32)], 1)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_array_equal(got_vals, want_vals)
    np.testing.assert_array_equal(got_label, fw.labels(ids, cfg["label"]).astype(np.float32))
    np.testing.assert_array_equal(got_weight, np.ones(300, np.float32))
    # a window in the middle, and rows past the end come back as padding
    mid = parse.rows(str(path), cfg["format"], 290, 310, cfg["num_col"], k)
    np.testing.assert_array_equal(mid[0][:10], want_ids[290:])
    assert (mid[0][10:] == cfg["num_col"]).all() and (mid[3][10:] == 0).all()


@pytest.mark.parametrize("name", CONFIGS)
def test_fields_tile_the_table_and_ids_stay_inside_them(name):
    cfg = registry.config(name)
    fields = cfg["fields"]
    lo = np.array([f["offset"] for f in fields])
    hi = lo + np.array([f["cardinality"] for f in fields])
    # each field its own range, one after another up to the table's width
    assert lo[0] == len(cfg["dense"]) and (lo[1:] == hi[:-1]).all() and hi[-1] == cfg["num_col"]
    ids = fw.draw_ids(np.random.default_rng(3), 4096, fields)
    assert ((ids >= lo) & (ids < hi)).all()
    # a field of a few values repeats its ids in every batch
    small = [j for j, f in enumerate(fields) if f["cardinality"] <= 3]
    for j in small:
        assert len(np.unique(ids[:, j])) == fields[j]["cardinality"]


def test_digits_are_zero_padded():
    buf = np.zeros((2, 12), np.uint8)
    fw.put_digits(buf, 1, 5, np.array([[7, 1234], [0, 99]]), 4)
    assert bytes(buf[0, 1:5]) == b"0007" and bytes(buf[0, 6:10]) == b"1234"
    assert bytes(buf[1, 1:5]) == b"0000" and bytes(buf[1, 6:10]) == b"0099"
