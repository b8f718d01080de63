"""The reference FM and Adam against ``FMLearner`` on the CPU at a tiny
size (this file imports both; the reference module imports nothing of the
program), the frozen byte counts against hand-worked values, the rows a
batch hits as counted from the reference's parse, and the row scatter's
roofline read from them."""

import numpy as np
import pytest
import torch

from dmlc_tpu_torch import FMLearner
from dmlc_tpu_torch.models.fm import FMParams
from dmlc_tpu_torch.ops.sparse import EllBatch
from portbench import harness, registry, yardstick
from portbench.reference import check, fm as ref_fm, params as ref_params, parse

import tiny


def _batches(cfg, n, seed):
    rng = np.random.default_rng(seed)
    b, k = cfg["batch_size"], cfg["max_nnz"]
    out = []
    for _ in range(n):
        ids = rng.integers(0, cfg["num_col"], size=(b, k))
        ids[0, -2:] = cfg["num_col"]  # a padded row end
        vals = rng.random((b, k)).astype(np.float32)
        vals[0, -2:] = 0.0
        label = (rng.random(b) < 0.3).astype(np.float32)
        weight = np.ones(b, np.float32)
        weight[-3:] = 0.0  # the zero-weight rows of a padded last batch
        out.append((ids, vals, label, weight))
    return out


@pytest.mark.parametrize("name", ["kdd12_fm", "criteo1tb_fm"])
def test_reference_follows_the_learner(name):
    cfg = tiny.config(name)
    seed, steps = 5, 3
    batches = _batches(cfg, steps, seed)
    model = FMLearner(cfg["num_col"], num_factors=cfg["num_factors"], layout="ell",
                      learning_rate=cfg["learning_rate"], device="cpu")
    start = ref_params.full(cfg, seed, "cpu")
    model.set_params(FMParams(*start))
    losses, g1 = [], None
    for i, (ids, vals, label, weight) in enumerate(batches):
        batch = EllBatch(torch.from_numpy(ids).int(), torch.from_numpy(vals),
                         torch.from_numpy(label), torch.from_numpy(weight))
        losses.append(float(model.step(batch)))
        if i == 0:
            g1 = [float(model.opt.state[p]["exp_avg"].norm()) / 0.1 for p in model.params]
    change = [float((p.detach() - s).norm()) for p, s in zip(model.params, start)]
    ref = ref_fm.follow(cfg, seed, batches, "cpu")
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-6)
    np.testing.assert_allclose(g1, ref["grad_norms"], rtol=1e-5)
    np.testing.assert_allclose(change, ref["change_norms"], rtol=1e-5)
    gaps = check.step_gaps({"losses": losses, "grad_norms": g1, "change_norms": change}, ref)
    assert max(gaps.values()) < 1e-4


def test_rows_of_draws_the_same_rows_as_the_whole_table():
    cfg = dict(tiny.config("kdd12_fm"))
    w0, w, v = ref_params.full(cfg, 9, "cpu")
    ids = torch.tensor([0, 3, 17, cfg["num_col"] - 1, cfg["num_col"]])
    r0, rw, rv = ref_params.rows_of(cfg, 9, ids)
    assert torch.equal(rv, v[ids]) and torch.equal(rw, w[ids]) and float(r0) == float(w0)
    assert torch.equal(v[-1], torch.zeros_like(v[-1]))  # the padding sink


def test_rows_of_crosses_chunks(monkeypatch):
    monkeypatch.setattr(ref_params, "CHUNK_ROWS", 100)
    cfg = tiny.config("kdd12_fm")
    _, _, v = ref_params.full(cfg, 4, "cpu")
    ids = torch.arange(0, cfg["num_col"] + 1, 37)
    assert torch.equal(ref_params.rows_of(cfg, 4, ids)[2], v[ids])


def test_the_byte_counts():
    # P = (num_col + 1) * (1 + F) + 1
    assert yardstick.param_count(9, 2) == 31
    # a batch: B*K ids and values, B labels and weights, 4 B each
    assert yardstick.batch_bytes(4, 3) == 4 * 3 * 8 + 4 * 8
    # 6 x 4 B x P plus the batch
    assert yardstick.step_bytes(9, 2, 4, 3) == 6 * 4 * 31 + 128
    # one scatter: b*k entries of an id and n_row words read, 5 hit rows
    # of n_row words written: b*k*(4 + 4*n_row) + hit_rows*n_row*4
    assert yardstick.row_scatter_bytes(4, 3, 5, 2) == 12 * 12 + 5 * 2 * 4
    # an FM step's two over the same ids and hit rows: n_row 1 and n_row F
    assert yardstick.step_row_scatter_bytes(2, 4, 3, 5) == (12 * 8 + 5 * 4) + (12 * 12 + 5 * 2 * 4)
    # a fractional mean of hit rows counts as it is
    assert yardstick.row_scatter_bytes(4, 3, 2.5, 1) == 12 * 8 + 10.0
    assert yardstick.least_seconds(3.35e12, 1) == 1.0
    assert yardstick.least_seconds(1, 67e12) == 1.0


@pytest.mark.parametrize("name,gb,ms", [("kdd12_fm", 11.81, 3.53), ("criteo1tb_fm", 40.56, 12.11)])
def test_step_bytes_at_full_size(name, gb, ms):
    from portbench import registry

    c = registry.config(name)
    args = (c["num_col"], c["num_factors"], c["batch_size"], c["max_nnz"])
    nbytes = yardstick.step_bytes(*args)
    assert round(nbytes / 1e9, 2) == gb
    # the bytes set the least time, not the operations
    assert yardstick.step_ops(*args) / yardstick.FP32_FLOPS_PER_S < nbytes / yardstick.HBM_BYTES_PER_S
    assert round(yardstick.least_seconds(nbytes, yardstick.step_ops(*args)) * 1e3, 2) == ms
    # every flat index into the table fits a signed 32-bit int
    assert (c["num_col"] + 1) * c["num_factors"] < 2 ** 31


def test_leaf_gap_is_taken_against_the_larger_norm():
    ref = {"losses": [1.0], "grad_norms": [1e-9, 2.0, 4.0], "change_norms": [1.0, 1.0, 1.0]}
    prog = {"losses": [1.0], "grad_norms": [2e-9, 2.0, 4.0], "change_norms": [0.5, 0.0, 1.0]}
    gaps = check.step_gaps(prog, ref)
    # the tiny leaf's doubled norm is measured against the median leaf's
    assert gaps["grad_norm_gap"] == pytest.approx(1e-9 / 2.0)
    # a leaf left unmoved reads 1; the leaf whose gradient is nought to
    # rounding (under a thousandth of the median's) is left out
    assert gaps["change_norm_gap"] == 1.0
    prog["change_norms"][1] = 1.0
    assert check.step_gaps(prog, ref)["change_norm_gap"] == 0.0


# rows 0-2 of a libsvm corpus over num_col 10, K 3: ids repeated within a
# row and across rows, short rows padded to the sink 10, an id 11 past the
# table; a batch of rows [0, 4) or [2, 4) also holds a row past the end
HIT_CORPUS = "1 3:1 5:1 3:1\n0 5:1 9:1\n1 0:1 11:1\n"


@pytest.mark.parametrize("form,want", [
    # padded: {0, 3, 5, 9, 10} over [0, 4) (the row past the end all sink),
    # {0, 10} over [2, 4)
    ("ell", (5 + 2) / 2),
    # CSR: no padding, so no sink: {0, 3, 5, 9} and {0}
    ("csr", (4 + 1) / 2),
])
def test_hit_rows_are_the_distinct_ids_in_the_table(tmp_path, form, want):
    path = tmp_path / "hits.libsvm"
    path.write_text(HIT_CORPUS)
    num_col = 10
    spans = [(0, 4), (2, 4)]
    if form == "ell":
        batches = [parse.rows(str(path), "libsvm", r0, r1, num_col, 3) for r0, r1 in spans]
        assert batches[0][0][3].tolist() == [num_col] * 3  # the row past the end
    else:
        batches = [parse.csr_rows(str(path), "libsvm", r0, r1) for r0, r1 in spans]
    assert harness.hit_rows(batches, num_col) == want
    # one batch alone, and ids below 0 count for nothing
    assert harness.hit_rows(batches[1:], num_col) == (2 if form == "ell" else 1)
    ids = np.array([[-1, 4, 4], [10, 11, 4]])
    assert harness.hit_rows([(ids, ids * 0.5, np.ones(2), np.ones(2))], num_col) == 2


def test_the_row_scatter_roofline_reads_the_hit_rows_over_the_scatter_time():
    reader = registry.metric_reader("row_scatter_roofline")
    cfg = {"num_col": 10 ** 6, "num_factors": 8, "batch_size": 4, "max_nnz": 3}
    run = harness.Run(config=cfg, cell={}, steps=10, hit_rows=5.0)
    assert reader.read(run) is None  # no trace
    spent = 2e-3
    run.trace = {"by_ranges": {("portbench.step", "_GatherRowsBackward"): spent / 2,
                               ("portbench.step", "_GatherRowsBackward", "aten::sort"): spent / 2,
                               ("portbench.step", "Optimizer.step#FusedAdam.step"): 1.0}}
    # (12 ids and words read + 5 rows written) for w and V: 708 bytes a step,
    # whatever the table's 10**6 rows
    need = (12 * (4 + 4) + 5 * 4) + (12 * (4 + 4 * 8) + 5 * 8 * 4)
    assert need == 708 == yardstick.step_row_scatter_bytes(8, 4, 3, 5.0)
    assert reader.read(run) == pytest.approx(100.0 * 10 * need / yardstick.HBM_BYTES_PER_S / spent)
    assert registry.metric_reader("row_scatter_roofline.host_paced") is reader
    run.hit_rows = None  # a run the harness did not count
    assert reader.read(run) is None
    run.hit_rows, run.trace = 5.0, {"by_ranges": {("Optimizer.step#FusedAdam.step",): 1.0}}
    assert reader.read(run) is None  # no time under the gather's backward
