"""A whole run on the CPU at a tiny size, its result line, and the faults
that must turn ``correct`` false, each cell's learner's own (``faults()``
in ``learners/<model>.py``; FM's: a step that leaves the state unchanged,
half of each batch left out, an id altered where the feed makes it); and
the control (the reference in bfloat16); and the rows a batch hits,
counted from the reference's parse of the checked batches whatever the
program feeds. Each cell is cut to CPU size by its corpus writer's
``tiny``."""

import json
import sys
import time
import types

import numpy as np
import pytest
import torch

from portbench import calibrate, harness, registry
from portbench import run as run_mod
from portbench.reference import check

import tiny

from conftest import ROOT

BENCH = registry.benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]


def _learner(name):
    return registry.learner(registry.config(registry.workload(name)["config"])["model"])


FAULT_CASES = [(name, fault) for name in CELLS for fault in sorted(_learner(name).faults())]


def _run(tmp_path, name, fault=None, traced=False, seconds=0.5, rows=640):
    cell = tiny.cell(name)
    cfg = tiny.config(cell["config"], rows=rows)
    rec, readings, limits = harness.run(cfg, cell, 2 ** 31 + 11, seconds, traced, "cpu",
                                        str(tmp_path), time.perf_counter(), fault=fault)
    return rec, readings, limits


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(tmp_path, name):
    rec, readings, limits = _run(tmp_path, name, traced=True, seconds=1.0)
    assert rec.steps > 0 and rec.failed == 0
    out = run_mod.result_line(BENCH, name, rec, readings, limits, True, {"platform": "cpu"})
    assert out["correct"] is True, out["checks"]
    assert list(out)[-1] == "checks"
    # the cell's own names, a split <metric>.<kind> where it reports other end-to-end metrics
    bases = {m.split(".", 1)[0] for m in out["metrics"]}
    assert set(_learner(name).cpu_metrics) <= bases
    # the CPU trace holds no device operation: no device metric is invented
    assert "step_device_ms" not in bases and "device_idle_share" not in bases
    untraced = run_mod.result_line(BENCH, name, rec, readings, limits, False, {})
    e2e = {m["name"] for m in registry.metrics_for(BENCH, name, "end_to_end")}
    # a CPU run has no device memory peak to read
    assert set(untraced["metrics"]) == e2e - {"peak_device_gib"}
    assert not list((tmp_path / ".portbench_cache" / "corpus").iterdir())
    # nor does a route leave a snapshot behind
    snapshots = tmp_path / ".portbench_cache" / "snapshot"
    assert not snapshots.exists() or not list(snapshots.iterdir())


@pytest.mark.parametrize("name,fault", FAULT_CASES, ids=[f"{n}-{f}" for n, f in FAULT_CASES])
def test_a_broken_timed_path_is_not_correct(tmp_path, name, fault):
    _, readings, limits = _run(tmp_path, name, fault=_learner(name).faults()[fault])
    assert not check.verdict(readings, limits), readings


# the cells whose learner can alter an id where its feed makes it (FM's)
ALTERED_ID = [name for name in CELLS if "altered_id" in _learner(name).faults()]


class _OneIdFeed:
    """Every id of each padded batch made 0 where the feed makes it."""

    def __init__(self, it):
        self.it = it

    def __next__(self):
        batch = next(self.it)
        return batch._replace(indices=torch.zeros_like(batch.indices))

    def __getattr__(self, name):
        return getattr(self.it, name)


@pytest.mark.parametrize("name", ALTERED_ID)
def test_hit_rows_come_from_the_reference_parse_of_the_checked_batches(tmp_path, monkeypatch,
                                                                       name):
    parses = []
    real = harness.reference_batches

    def spy(config, corpus, positions):
        batches = real(config, corpus, positions)
        parses.append((list(positions), batches, config["num_col"]))
        return batches

    monkeypatch.setattr(harness, "reference_batches", spy)
    faults = {"altered_id": _learner(name).faults()["altered_id"],
              "one_id": lambda model, it: (model, _OneIdFeed(it))}
    sound, _, _ = _run(tmp_path / "sound", name, seconds=1.0)
    runs = [sound]
    for fault, plant in faults.items():
        rec, readings, limits = _run(tmp_path / fault, name, seconds=1.0, fault=plant)
        assert not check.verdict(readings, limits), (fault, readings)
        runs.append(rec)
    # one parse a run, shared by the check and the count: the followed
    # batches, then the window's sampled one and its first after a restart
    assert len(parses) == len(runs)
    for rec, (positions, batches, num_col) in zip(runs, parses):
        assert positions[:harness.FOLLOWED] == list(range(harness.FOLLOWED))
        assert len(positions) > harness.FOLLOWED and len(batches) == len(positions)
        distinct = [len({int(i) for i in b[-4].ravel() if 0 <= i <= num_col}) for b in batches]
        assert rec.hit_rows == np.mean(distinct) > 1
    # ids altered in the program's feed leave the traffic's count as it was
    assert all(positions == parses[0][0] for positions, _, _ in parses)
    assert all(rec.hit_rows == sound.hit_rows for rec in runs)


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(tmp_path, name):
    cell = tiny.cell(name)
    cfg = tiny.config(cell["config"], batch=512, rows=2048)
    sides = calibrate.control_readings(cfg, 3, "cpu", str(tmp_path))
    for side, readings in sides.items():
        assert not check.verdict(readings, cell["limits"]), (side, readings)


def test_a_module_loaded_after_the_window_withholds_the_result(monkeypatch, capsys):
    out = {"correct": True, "checks": {"loss_gap": {"value": 0.0, "limit": 1e-5}}}
    assert run_mod.emit(out) == 0
    assert capsys.readouterr().out.strip() == json.dumps(out)
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert run_mod.emit(out) != 0
    seen = capsys.readouterr()
    assert seen.out == "" and "jax" in seen.err


def test_forbidden_modules_are_named():
    assert "jax" not in harness.forbidden_modules()
    assert {"jax", "dmlc_tpu"} == set(harness.FORBIDDEN) - {"jaxlib", "flax"}


WARM = [n for n in CELLS if registry.workload(n).get("route") == "warm"]


@pytest.mark.parametrize("name", WARM)
def test_the_warm_route_serves_the_window_from_its_snapshot(tmp_path, name):
    rec, readings, limits = _run(tmp_path, name, seconds=1.0, rows=192)  # 3 batches an epoch
    assert check.verdict(readings, limits), readings
    # set-up parsed the one cold epoch; the window parsed nothing and
    # decoded every batch from the snapshot's raw spans
    assert rec.stats1["convert_seconds"] == rec.stats0["convert_seconds"]
    assert rec.stats1["device_decode_bytes"] > rec.stats0["device_decode_bytes"]
    assert rec.epochs >= 1
    assert not list((tmp_path / ".portbench_cache" / "snapshot").iterdir())

    def planted(model, it):
        raise RuntimeError("planted")

    failing = tmp_path / "failing"
    with pytest.raises(RuntimeError, match="planted"):
        _run(failing, name, fault=planted)
    # the snapshot goes with a run that fails, too
    assert not list((failing / ".portbench_cache" / "snapshot").iterdir())
