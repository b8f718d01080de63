"""The reference FM and Adam against ``FMLearner`` on the CPU at a tiny
size (this file imports both; the reference module imports nothing of the
program), and the frozen byte counts against hand-worked values."""

import numpy as np
import pytest
import torch

from dmlc_tpu_torch import FMLearner
from dmlc_tpu_torch.models.fm import FMParams
from dmlc_tpu_torch.ops.sparse import EllBatch
from portbench import yardstick
from portbench.reference import check, fm as ref_fm, params as ref_params

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
    # one scatter: b*k*(8 + 4*n_row) + rows*n_row*4
    assert yardstick.row_scatter_bytes(4, 3, 10, 2) == 12 * 16 + 80
    # an FM step's two: n_row 1 and n_row F into num_col + 1 rows
    assert yardstick.step_row_scatter_bytes(9, 2, 4, 3) == (12 * 12 + 40) + (12 * 16 + 80)
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
