"""Every piece is found by its name, and a new cell or metric is a new
file and a BENCHMARK.json entry, nothing more."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import registry

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


def test_names_are_refused_outside_the_alphabet():
    with pytest.raises(ValueError):
        registry.config("../etc")


def test_added_files_are_picked_up_without_edits(tmp_path):
    """A copy of the benchmark gains a cell and a metric by files and
    BENCHMARK.json entries alone."""
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
                               "moves": "rows_per_s", "workloads": ["kdd12_fm.small"]})
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
