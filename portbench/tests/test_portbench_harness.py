"""A whole run on the CPU at a tiny size, its result line, and the faults
that must turn ``correct`` false: a step that leaves the state unchanged,
half of each batch left out, an id altered where the feed makes it; and
the control (the reference in bfloat16)."""

import json
import sys
import time
import types

import pytest

from portbench import calibrate, harness, registry
from portbench import run as run_mod
from portbench.reference import check

import tiny

from conftest import ROOT

BENCH = registry.benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]


def _run(tmp_path, name, fault=None, traced=False, seconds=0.5):
    cell = tiny.cell(name)
    cfg = tiny.config(cell["config"])
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
    assert {"stall_share", "step_mfu"} <= bases
    # the CPU trace holds no device operation: no device metric is invented
    assert "step_device_ms" not in bases and "device_idle_share" not in bases
    untraced = run_mod.result_line(BENCH, name, rec, readings, limits, False, {})
    e2e = {m["name"] for m in registry.metrics_for(BENCH, name, "end_to_end")}
    # a CPU run has no device memory peak to read
    assert set(untraced["metrics"]) == e2e - {"peak_device_gib"}
    assert not list((tmp_path / ".portbench_cache" / "corpus").iterdir())


def _unchanged(model, it):
    model.opt.step = lambda *a, **k: None
    return model, it


def _half_batch(model, it):
    step = model.step

    def half(batch):
        weight = batch.weight.clone()
        weight[len(weight) // 2:] = 0.0
        return step(batch._replace(weight=weight))
    model.step = half
    return model, it


class _AlteredFeed:
    def __init__(self, it):
        self.it = it

    def __next__(self):
        batch = next(self.it)
        idx = batch.indices.clone()
        idx[0, 0] = (idx[0, 0] + 1) % idx.max()
        return batch._replace(indices=idx)

    def __getattr__(self, name):
        return getattr(self.it, name)


FAULTS = {"unchanged_state": _unchanged, "half_batch": _half_batch,
          "altered_id": lambda m, it: (m, _AlteredFeed(it))}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(tmp_path, name, fault):
    _, readings, limits = _run(tmp_path, name, fault=FAULTS[fault])
    assert not check.verdict(readings, limits), readings


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
