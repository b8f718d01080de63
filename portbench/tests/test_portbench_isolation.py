"""What a run may load, and where it refuses to run: checked in processes
of their own."""

import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT

LOADED = ("import sys, json\n{imports}\n"
          "print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))\n")


def _top_level_modules(imports: str) -> set:
    out = subprocess.run([sys.executable, "-c", LOADED.format(imports=imports)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_the_harness_loads_no_jax():
    mods = _top_level_modules(
        "import portbench.run, portbench.harness, portbench.calibrate\n"
        "import dmlc_tpu_torch, dmlc_tpu_torch.data.device, dmlc_tpu_torch.models.fm\n"
        "from portbench import registry\n"
        "b = registry.benchmark('.')\n"
        "[registry.metric_reader(m['name']) for m in b['end_to_end'] + b['per_layer']]\n"
        "cfgs = [registry.config(c['name']) for c in b['configs']]\n"
        "[registry.corpus_writer(c.get('corpus', c['format'])) for c in cfgs]\n"
        "[registry.learner(c['model']) for c in cfgs]\n"
        "[registry.route(registry.workload(w['name']).get('route', 'cold')) "
        "for w in b['workloads']]")
    assert not mods & {"jax", "jaxlib", "flax", "dmlc_tpu"}
    assert "dmlc_tpu_torch" in mods


def _every(package: str) -> str:
    """An import line for every module of ``portbench/<package>/``."""
    names = sorted(f[:-3] for f in os.listdir(os.path.join(ROOT, "portbench", package))
                   if f.endswith(".py") and f != "__init__.py")
    assert names
    return "import " + ", ".join(f"portbench.{package}.{n}" for n in names)


def test_the_pieces_import_the_program_only_when_they_build():
    mods = _top_level_modules(
        "import portbench.run, portbench.harness, portbench.calibrate\n"
        + _every("learners") + "\n" + _every("routes") + "\n" + _every("corpora"))
    assert not mods & {"jax", "jaxlib", "flax", "dmlc_tpu", "dmlc_tpu_torch"}


def test_the_reference_loads_nothing_of_the_program():
    mods = _top_level_modules(_every("reference"))
    assert not mods & {"jax", "jaxlib", "flax", "dmlc_tpu", "dmlc_tpu_torch"}


def _cli(cwd, *extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "kdd12_fm.cold",
                           "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0", *extra],
                          cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_no_card_no_result():
    out = _cli(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
