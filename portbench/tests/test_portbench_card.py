"""On the card: one short run of each cell through the command in
BENCHMARK.json, its result line read as the contract asks."""

import json
import subprocess

import pytest

from portbench import registry

from conftest import ROOT

BENCH = registry.benchmark(ROOT)


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_a_short_run_on_the_card(cuda_device, name, trace):
    out = subprocess.run(BENCH["command"] + ["--workload", name, "--seed", str(2 ** 31 + 21),
                                             "--seconds", "3", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in registry.metrics_for(BENCH, name, kind)}
    assert set(line["metrics"]) == want
