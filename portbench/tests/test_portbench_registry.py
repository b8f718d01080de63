"""Every piece is found by its name, and a new cell or metric is a new
file and a BENCHMARK.json entry, nothing more."""

import json
import os
import shutil
import subprocess
import sys
import textwrap
import time

import pytest

from portbench import harness, registry

from conftest import ROOT

BENCH = registry.benchmark(ROOT)


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_found_by_name(entry):
    cfg = registry.config(entry["name"])
    assert cfg["name"] == entry["name"]
    assert os.path.samefile(os.path.join(ROOT, entry["file"]),
                            os.path.join(registry.HERE, "configs", entry["name"] + ".json"))
    assert set(entry["reduced"]) == set(cfg["reduced"])
    assert registry.corpus_writer(cfg["format"]).write


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_cell_found_by_name(entry):
    cell = registry.workload(entry["name"])
    assert cell["config"] == entry["config"]
    assert set(cell["limits"]) >= {"feed_mismatch", "loss_gap"}


@pytest.mark.parametrize("entry", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda e: e["name"])
def test_metric_found_by_name(entry):
    assert callable(registry.metric_reader(entry["name"]).read)


def test_every_cell_reports_setup_and_a_per_layer_metric():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in registry.metrics_for(BENCH, w["name"], "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert registry.metrics_for(BENCH, w["name"], "per_layer")


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= set(cells), m["name"]
    for m in BENCH["per_layer"]:
        for cell in m.get("workloads", cells):
            e2e = [e["name"] for e in registry.metrics_for(BENCH, cell, "end_to_end")]
            assert m["moves"] in e2e, (m["name"], cell)


def test_a_split_metric_is_read_by_its_base_reader():
    assert registry.metric_reader("stall_share.host_paced") is registry.metric_reader("stall_share")
    assert registry.metric_reader("rows_per_s.host_paced").read(
        harness.Run(config={}, cell={}, rows=300, window_s=2.0)) == 150.0
    with pytest.raises(LookupError, match="no_such_metric.host_paced"):
        registry.metric_reader("no_such_metric.host_paced")
    with pytest.raises(LookupError, match="no_such_metric"):
        registry.metric_reader("no_such_metric")


def test_names_are_refused_outside_the_alphabet():
    with pytest.raises(ValueError):
        registry.config("../etc")


STUB_CORPUS = """
import os

import numpy as np


def write(path, config, seed):
    rng = np.random.default_rng(seed)
    n, k = config["corpus_rows"], config["max_nnz"]
    ids = rng.integers(0, config["num_col"], size=(n, k))
    label = rng.integers(0, 2, size=n)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for y, row in zip(label, ids):
            f.write(f"{y} " + " ".join(f"{i}:0.5" for i in row) + "\\n")
    return {"rows": n}


def tiny(config, rows, batch):
    return dict(config, corpus_rows=rows, batch_size=batch)
"""

# a route that does work in set-up (the corpus turned into an .npz) and
# removes it in its cleanup; it logs its calls into the model's events
STUB_ROUTE = """
import os

import numpy as np
import torch

from portbench.reference import parse


class Feed:
    def __init__(self, path, batch, events):
        self.arrays = [np.load(path)[k] for k in ("ids", "vals", "label", "weight")]
        self.batch, self.events, self.pos = batch, events, 0

    def __next__(self):
        if self.pos >= len(self.arrays[0]):
            raise StopIteration
        out = tuple(torch.from_numpy(a[self.pos:self.pos + self.batch]) for a in self.arrays)
        self.pos += self.batch
        return out

    def reset(self):
        self.events.append("reset")
        self.pos = 0

    def stats(self):
        return {}

    def close(self):
        self.events.append("close")


def open_pipeline(config, corpus, learner, model, device):
    rows = parse.rows(corpus, config["format"], 0, config["corpus_rows"], config["num_col"],
                      config["max_nnz"])
    path = corpus + ".npz"
    np.savez(path, **dict(zip(("ids", "vals", "label", "weight"), rows)))
    model.events.append("open")

    def cleanup():
        os.remove(path)
        model.events.append("cleanup")
    return Feed(path, config["batch_size"], model.events), cleanup
"""

# logistic regression by plain SGD; the reference steps it again in numpy
STUB_LEARNER = """
import numpy as np
import torch

EVENTS = []


class Model:
    def __init__(self, num_col, lr):
        self.w, self.lr, self.events = torch.zeros(num_col, dtype=torch.float64), lr, EVENTS

    def step(self, batch):
        ids, vals, label, weight = batch
        margin = (self.w[ids] * vals).sum(1)
        p = torch.sigmoid(margin)
        loss = -(weight * (label * torch.log(p) + (1 - label) * torch.log(1 - p))).sum()
        loss = loss / weight.sum()
        dm = (p - label) * weight / weight.sum()
        self.w.index_add_(0, ids.reshape(-1), -self.lr * (dm[:, None] * vals).reshape(-1))
        return loss


def build(config, seed, device, log=lambda what: None):
    return Model(config["num_col"], config["learning_rate"])


def pipeline_kwargs(model, config):
    return {}


def after_step(model, step, program):
    program.setdefault("steps_after", []).append(step)


def after_followed(model, config, seed, device, program):
    program["followed"] = True


def epoch_end(model):
    model.events.append("epoch_end")


def _losses(config, ref_batches, dtype):
    w, out = np.zeros(config["num_col"], dtype), []
    for ids, vals, label, weight in ref_batches:
        vals, label, weight = (a.astype(dtype) for a in (vals, label, weight))
        p = 1 / (1 + np.exp(-(w[ids] * vals).sum(1)))
        loss = -(weight * (label * np.log(p) + (1 - label) * np.log(1 - p))).sum()
        loss /= weight.sum()
        np.add.at(w, ids.reshape(-1),
                  -config["learning_rate"] * (((p - label) * weight / weight.sum())[:, None]
                                              * vals).reshape(-1))
        out.append(float(loss))
    return out


def _gap(got, ref):
    return max(abs(g - r) / abs(r) for g, r in zip(got, ref))


def reference_readings(config, seed, ref_batches, program, device):
    assert program["steps_after"] == [0, 1, 2] and program["followed"]
    return {"loss_gap": _gap(program["losses"], _losses(config, ref_batches, np.float64))}


def control_readings(config, seed, ref_batches, device):
    ref = _losses(config, ref_batches, np.float64)
    return {"control_float32": {"feed_mismatch": 0, "feed_value_gap": 0.0,
                                "loss_gap": _gap(_losses(config, ref_batches, np.float32), ref)}}


cpu_metrics = ()


def _unchanged(model, it):
    model.lr = 0.0
    return model, it


def faults():
    return {"unchanged_state": _unchanged}
"""

STUB_PROBE = """
import json, time
from portbench import harness, registry, run
from portbench.learners import stub_lr
b = registry.benchmark(".")
cell = registry.workload("stub_lr.npz")
rec, readings, limits = harness.run(registry.config(cell["config"]), cell, 2 ** 31 + 7, 0.3,
                                    False, "cpu", ".", time.perf_counter())
out = run.result_line(b, "stub_lr.npz", rec, readings, limits, False, {"platform": "cpu"})
events = list(stub_lr.EVENTS)
stub_lr.EVENTS.clear()


def planted(model, it):
    raise RuntimeError("planted")


try:
    harness.run(registry.config(cell["config"]), cell, 5, 0.3, False, "cpu", ".",
                time.perf_counter(), fault=planted)
except RuntimeError:
    pass
print(json.dumps({"out": out, "epochs": rec.epochs, "events": events,
                  "failed_run_events": stub_lr.EVENTS}))
"""


def _add_stub_cell(tmp_path, bench):
    """A learner, a route and a corpus writer of their own, as new files,
    and a configuration and a cell that name them."""
    pb = tmp_path / "portbench"
    (pb / "learners" / "stub_lr.py").write_text(textwrap.dedent(STUB_LEARNER))
    (pb / "routes" / "stub_npz.py").write_text(textwrap.dedent(STUB_ROUTE))
    (pb / "corpora" / "stub_rows.py").write_text(textwrap.dedent(STUB_CORPUS))
    config = {"name": "stub_lr", "model": "stub_lr", "corpus": "stub_rows", "format": "libsvm",
              "num_col": 50, "max_nnz": 3, "batch_size": 16, "corpus_rows": 64,
              "learning_rate": 0.5, "reduced": []}
    (pb / "configs" / "stub_lr.json").write_text(json.dumps(config))
    cell = {"name": "stub_lr.npz", "config": "stub_lr", "route": "stub_npz",
            "limits": {"feed_mismatch": 0, "feed_value_gap": 1e-6, "loss_gap": 1e-9}}
    (pb / "workloads" / "stub_lr.npz.json").write_text(json.dumps(cell))
    bench["configs"].append({"name": "stub_lr", "source": "https://example.org/stub",
                             "file": "portbench/configs/stub_lr.json", "reduced": [],
                             "why": "a stub"})
    bench["workloads"].append({"name": "stub_lr.npz", "config": "stub_lr", "traffic": "npz",
                               "chips": 1, "why": "a stub learner, route and corpus"})
    next(m for m in bench["end_to_end"] if m["name"] == "rows_per_s")["workloads"].append(
        "stub_lr.npz")


def test_added_files_are_picked_up_without_edits(tmp_path):
    """A copy of the benchmark gains a cell and a metric by files and
    BENCHMARK.json entries alone; and a learner, an input route and a
    corpus writer, whose tiny cell runs end to end on the CPU."""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    new_cell = dict(registry.workload("kdd12_fm.cold"), name="kdd12_fm.small",
                    config="kdd12_fm_small")
    (tmp_path / "portbench" / "workloads" / "kdd12_fm.small.json").write_text(json.dumps(new_cell))
    new_config = dict(registry.config("kdd12_fm"), name="kdd12_fm_small", corpus_rows=4096)
    (tmp_path / "portbench" / "configs" / "kdd12_fm_small.json").write_text(
        json.dumps(new_config))
    (tmp_path / "portbench" / "metrics" / "epochs_seen.py").write_text(
        "def read(run):\n    return float(run.epochs)\n")
    bench["configs"].append(dict(bench["configs"][0], name="kdd12_fm_small",
                                 file="portbench/configs/kdd12_fm_small.json"))
    bench["workloads"].append({"name": "kdd12_fm.small", "config": "kdd12_fm_small",
                               "traffic": "small", "chips": 1, "why": "a shorter corpus"})
    bench["per_layer"].append({"name": "epochs_seen", "unit": "epochs", "better": "higher",
                               "source": "host_clock", "layer": "DeviceIter",
                               "moves": "peak_device_gib", "workloads": ["kdd12_fm.small"]})
    _add_stub_cell(tmp_path, bench)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    probe = (
        "from portbench import registry, harness\n"
        "b = registry.benchmark('.')\n"
        "c = registry.workload('kdd12_fm.small')\n"
        "names = [m['name'] for m in registry.metrics_for(b, 'kdd12_fm.small', 'per_layer')]\n"
        "run = harness.Run(config=registry.config(c['config']), cell=c, epochs=3)\n"
        "print(run.config['corpus_rows'], names[-1], registry.metric_reader(names[-1]).read(run))\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["4096", "epochs_seen", "3.0"]

    out = subprocess.run([sys.executable, "-c", STUB_PROBE], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    seen = json.loads(out.stdout.splitlines()[-1])
    line = seen["out"]
    assert line["correct"] is True, line["checks"]
    assert list(line["checks"]) == ["feed_mismatch", "feed_value_gap", "loss_gap"]
    assert list(line)[-1] == "checks" and line["attempted"] > 0
    assert set(line["metrics"]) == {"rows_per_s", "setup_s"}
    # the learner's epoch_end before every restart, the route's cleanup at exit
    epochs = seen["epochs"]
    assert epochs >= 2
    assert seen["events"] == ["open"] + ["epoch_end", "reset"] * epochs + ["close", "cleanup"]
    # a run that fails after set-up still cleans up after its route and its corpus
    assert seen["failed_run_events"] == ["open", "cleanup"]
    assert not list((tmp_path / ".portbench_cache" / "corpus").iterdir())

    # the harness's tests take the new cell as it is: its sound run, the
    # learner's one fault and its control
    out = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                          "portbench/tests/test_portbench_harness.py", "-k", "stub_lr"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:]
    assert "3 passed" in out.stdout, out.stdout[-3000:]


@pytest.mark.parametrize("key", ["model", "route", "corpus"])
def test_an_unknown_piece_fails_by_its_name(tmp_path, key):
    cell, cfg = dict(registry.workload("kdd12_fm.cold")), dict(registry.config("kdd12_fm"))
    name = f"no_such_{key}"
    (cell if key == "route" else cfg)[key] = name
    with pytest.raises(LookupError, match=name):
        harness.run(cfg, cell, 1, 0.1, False, "cpu", str(tmp_path), time.perf_counter())
    # it fails before set-up writes anything
    assert not (tmp_path / ".portbench_cache").exists()
    lookup = {"model": registry.learner, "route": registry.route, "corpus": registry.corpus_writer}
    with pytest.raises(LookupError, match=name):
        lookup[key](name)


@pytest.mark.parametrize("module", ["harness.py", "run.py", "calibrate.py"])
def test_the_generic_files_name_no_learner(module):
    with open(os.path.join(registry.HERE, module)) as f:
        text = f.read()
    for word in ("FMLearner", "FMParams", "reference.fm", "ref_fm", "model.opt", "w0, w, v"):
        assert word not in text, word
