"""Ragged (``bcoo``) batches through the harness: the reference's CSR
parse, the ragged feed comparison, and a tiny ragged FM configuration
(``ragged_fm.json``, not a cell of the benchmark) run end to end on the
CPU, its faults and its control not correct. And the FM cells' padded
path read to the digit as before ragged batches came."""

import hashlib
import json
import os
import time

import numpy as np
import pytest
import torch

from portbench import calibrate, harness, registry
from portbench.reference import check, parse

import tiny

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 2 ** 31 + 29


def _load(name):
    with open(os.path.join(HERE, name)) as f:
        return json.load(f)


CONFIG = _load("ragged_fm.json")
CELL = _load("ragged_fm.cold.json")
LEARNER = registry.learner(CONFIG["model"])


def _corpus(tmp_path, config=CONFIG, seed=SEED):
    path = str(tmp_path / "ragged.libsvm")
    registry.corpus_writer(harness.corpus_name(config)).write(path, config, seed)
    return path


def test_every_batch_holds_a_row_of_one_and_a_row_a_hundred_times_the_median(tmp_path):
    path = _corpus(tmp_path)
    b, n = CONFIG["batch_size"], CONFIG["corpus_rows"]
    offsets = parse.csr_rows(path, "libsvm", 0, n)[0]
    lengths = np.diff(offsets)
    median = np.median(lengths)
    for start in range(0, n, b):
        batch = lengths[start:start + b]
        assert batch.min() == 1 and batch.max() >= 100 * median, (start, batch.max(), median)


def test_the_csr_parse_reads_a_row_longer_than_any_padded_width(tmp_path):
    widest = max(registry.config(c["name"]).get("max_nnz", 0)
                 for c in registry.benchmark(os.path.dirname(os.path.dirname(HERE)))["configs"])
    count = 25 * widest
    path = tmp_path / "long.libsvm"
    ids = np.arange(count) * 3 + 1
    path.write_text("1 3:0.5\n0 " + " ".join(f"{i}:{i / 8}" for i in ids) + "\n")
    offsets, got_ids, vals, label, weight = parse.csr_rows(str(path), "libsvm", 0, 3)
    np.testing.assert_array_equal(offsets, [0, 1, 1 + count, 1 + count])
    np.testing.assert_array_equal(got_ids, np.concatenate([[3], ids]))
    np.testing.assert_array_equal(vals, np.concatenate([[0.5], ids / 8]).astype(np.float32))
    np.testing.assert_array_equal(label, [1, 0, 0])
    np.testing.assert_array_equal(weight, [1, 1, 0])  # past the end: no entries, weight 0
    with pytest.raises(ValueError, match="more than"):
        parse.rows(str(path), "libsvm", 0, 2, 10 ** 6, widest)


def _moved_entry(batch):
    """The last entry of row 0 moved to the front of row 1."""
    offsets = batch[0].copy()
    offsets[1] -= 1
    return (offsets,) + batch[1:]


def _dropped_longest(batch):
    offsets, ids, vals, label, weight = batch
    r = int(np.argmax(np.diff(offsets)))
    last = offsets[r + 1] - 1
    offsets = offsets.copy()
    offsets[r + 1:] -= 1
    return offsets, np.delete(ids, last), np.delete(vals, last), label, weight


def _altered_id(batch):
    ids = batch[1].copy()
    ids[len(ids) // 2] += 1
    return batch[:1] + (ids,) + batch[2:]


def _changed_label(batch):
    label = batch[3].copy()
    label[5] = 1 - label[5]
    return batch[:3] + (label,) + batch[4:]


def _value_off(batch):
    vals = batch[2].copy()
    vals[7] += np.float32(1e-3)
    return batch[:2] + (vals,) + batch[3:]


BREAKS = {"altered_id": _altered_id, "dropped_longest_entry": _dropped_longest,
          "moved_entry": _moved_entry, "changed_label": _changed_label,
          "value_off": _value_off}


@pytest.mark.parametrize("how", sorted(BREAKS))
def test_the_ragged_feed_comparison(tmp_path, how):
    ref = harness.reference_batches(CONFIG, _corpus(tmp_path), [0, 1])
    # a sound feed reads 0, its rows' entries in any order within each row
    shuffled = []
    for offsets, ids, vals, label, weight in ref:
        order = np.concatenate([np.arange(a, b)[::-1] for a, b in zip(offsets, offsets[1:])])
        shuffled.append((offsets, ids[order], vals[order], label, weight))
    assert check.feed_gaps_csr(shuffled, ref) == {"feed_mismatch": 0, "feed_value_gap": 0.0}
    broken = [BREAKS[how](ref[0])] + ref[1:]
    assert not check.verdict(check.feed_gaps_csr(broken, ref), CELL["limits"])


def _recording(seen):
    """A fault that breaks nothing: it keeps every fed batch in its host form."""
    host = harness.LAYOUTS["bcoo"].host

    class Recorder:
        def __init__(self, it):
            self.it = it

        def __next__(self):
            batch = next(self.it)
            seen.append(host(batch))
            return batch

        def __getattr__(self, name):
            return getattr(self.it, name)

    return lambda model, it: (model, Recorder(it))


def _run(tmp_path, fault=None, seconds=0.5):
    return harness.run(CONFIG, CELL, SEED, seconds, False, "cpu", str(tmp_path),
                       time.perf_counter(), fault=fault)


def test_a_sound_ragged_run_is_correct_and_feeds_the_reference_parse(tmp_path):
    seen = []
    rec, readings, limits = _run(tmp_path, _recording(seen), seconds=1.0)
    assert rec.steps > 0 and rec.epochs >= 1
    assert check.verdict(readings, limits), readings
    assert readings["feed_mismatch"] == 0 and readings["feed_value_gap"] == 0.0
    # the fed CSR arrays are the reference's parse, entry for entry: rebuild
    # the corpus (the run removed it) and read each fed batch's rows
    path = _corpus(tmp_path)
    per_epoch = -(-CONFIG["corpus_rows"] // CONFIG["batch_size"])
    b = CONFIG["batch_size"]
    for i, fed in enumerate(seen[:2 * per_epoch]):
        p = i % per_epoch
        want = parse.csr_rows(path, CONFIG["format"], p * b, (p + 1) * b)
        for got, ref in zip(fed, want):
            np.testing.assert_array_equal(got, ref)
    assert len(seen) > per_epoch  # the comparison crossed a restart


@pytest.mark.parametrize("fault", sorted(LEARNER.faults()))
def test_a_broken_ragged_run_is_not_correct(tmp_path, fault):
    _, readings, limits = _run(tmp_path, LEARNER.faults()[fault])
    assert not check.verdict(readings, limits), readings


def test_the_ragged_control_and_faults_in_the_reference_are_not_correct(tmp_path):
    sides = calibrate.control_readings(CONFIG, 3, "cpu", str(tmp_path))
    assert set(sides) == {"control_bf16", "fault_half_batch", "fault_altered_id"}
    for side, readings in sides.items():
        assert not check.verdict(readings, CELL["limits"]), (side, readings)


# what the padded path read at the parent of the ragged seam, for one seed:
# the reference's parse of four batches (a digest) and the feed comparison
# of bfloat16-rounded values and of altered ids and labels
GOLDEN = {
    "kdd12_fm": ("9cd992751083a3722e1e85df85aaa084a3896cdb55e548b2bb48b83c2c587a0c",
                 {"feed_mismatch": 0, "feed_value_gap": 0.0},
                 {"feed_mismatch": 8, "feed_value_gap": 0.0}),
    "criteo1tb_fm": ("841701ae703d8c1ed3da13273436f7d689262ecc82569433c26017c7f5db545a",
                     {"feed_mismatch": 0, "feed_value_gap": 0.003833595864475511},
                     {"feed_mismatch": 8, "feed_value_gap": 2.172502011711181}),
}


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_the_padded_path_reads_as_it_did(tmp_path, name):
    cfg = tiny.config(name)
    ref = harness.reference_batches(cfg, _corpus(tmp_path, cfg, 2 ** 31 + 17), [0, 1, 2, 7])
    digest = hashlib.sha256()
    for batch in ref:
        for a in batch:
            digest.update(a.tobytes())
            digest.update(str(a.dtype).encode())
            digest.update(str(a.shape).encode())
    rounded = [(i, torch.from_numpy(v).to(torch.bfloat16).float().numpy(), lab, w)
               for i, v, lab, w in ref]
    altered = []
    for j, (ids, vals, label, weight) in enumerate(ref):
        ids, label = ids.copy(), label.copy()
        ids[j, 1] += 1
        label[2 * j] = 1 - label[2 * j]
        altered.append((ids, vals, label, weight))
    sha, want_rounded, want_altered = GOLDEN[name]
    assert digest.hexdigest() == sha
    assert check.feed_gaps(rounded, ref) == want_rounded
    assert check.feed_gaps(altered, ref) == want_altered
    assert harness.LAYOUTS["ell"].feed_gaps is check.feed_gaps


def test_the_warm_decode_bytes_and_roofline():
    from portbench import yardstick

    # the values slab of one [B, K] float32 ELL batch, read and written
    assert yardstick.widen_span_bytes(4, 3) == 2 * 4 * 3 * 4
    assert yardstick.widen_span_bytes(8192, 10) == 655360
    reader = registry.metric_reader("widen_span_roofline")
    run = harness.Run(config={"batch_size": 8192, "max_nnz": 10}, cell={})
    assert reader.read(run) is None  # no trace
    run.trace = {"by_name": {"gemm": [1.0, 10]}}
    assert reader.read(run) is None  # the window launched no K2
    # 100 launches at twice their least time read 50%
    least = 655360 / yardstick.HBM_BYTES_PER_S
    run.trace = {"by_name": {"(anonymous namespace)::decode_span_kernel(...)": [200 * least, 100],
                             "gemm": [1.0, 10]}}
    assert reader.read(run) == pytest.approx(50.0)
