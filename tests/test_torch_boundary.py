"""The port's import boundary and its device rule.

- ``dmlc_tpu_torch`` and every submodule import with ``jax``, ``optax``,
  ``dmlc_tpu`` and ``ml_dtypes`` blocked (a subprocess: this test process
  already imported jax through conftest.py). ``ml_dtypes`` comes with JAX
  here, but the card's machine lacks it: the port reads bfloat16
  segments without it.
- No module of the port, and not ``chip_smoke.py``, imports any of them
  (an AST scan).
- Entry points run on the card unless the caller asks for the CPU: without
  ``device=`` they raise on a host without CUDA.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

import dmlc_tpu_torch
from dmlc_tpu_torch import DMLCError, DeviceIter, LinearLearner
from dmlc_tpu_torch.ops.ell_matvec import ell_matvec_auto
from dmlc_tpu_torch.ops.sparse import EllBatch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(dmlc_tpu_torch.__file__)
FORBIDDEN = ("jax", "jaxlib", "optax", "dmlc_tpu", "ml_dtypes")
# modules the port added by hand-picked slices, which the subprocess must
# import too (the block cache, the snapshot store, the epoch planner, the ALS
# example, the tiered artifact store, the chunk cache, RecordIO, the
# filesystem registry and its streams, the native RecordIO engines, the
# chunk-batch engine, the row iterators, the serializer, the rest of utils,
# the cloud filesystems, their fake, the host examples, the tracker and its
# backends, the pod example, the data service, and the fault-injection seam)
SNAPSHOT_MODULES = ("dmlc_tpu_torch.io.block_cache", "dmlc_tpu_torch.io.snapshot",
                    "dmlc_tpu_torch.ops.device_decode", "dmlc_tpu_torch.data.epoch",
                    "dmlc_tpu_torch.examples.train_als", "dmlc_tpu_torch.store.journal",
                    "dmlc_tpu_torch.store.manager", "dmlc_tpu_torch.io.cached_split",
                    "dmlc_tpu_torch.io.recordio", "dmlc_tpu_torch.io.filesystem",
                    "dmlc_tpu_torch.io.stream", "dmlc_tpu_torch.io.native_recordio",
                    "dmlc_tpu_torch.data.batch_parser", "dmlc_tpu_torch.data.iterators",
                    "dmlc_tpu_torch.utils.serializer", "dmlc_tpu_torch.utils.registry",
                    "dmlc_tpu_torch.utils.config", "dmlc_tpu_torch.utils.concurrency",
                    "dmlc_tpu_torch.utils.thread_group", "dmlc_tpu_torch.io.http_filesys",
                    "dmlc_tpu_torch.io.s3_filesys", "dmlc_tpu_torch.io.gcs_filesys",
                    "dmlc_tpu_torch.io.hdfs_filesys", "dmlc_tpu_torch.io.azure_filesys",
                    "dmlc_tpu_torch.testing.fake_cloud",
                    "dmlc_tpu_torch.examples.parameter_demo",
                    "dmlc_tpu_torch.examples.checkpoint_resume",
                    "dmlc_tpu_torch.tracker", "dmlc_tpu_torch.tracker.tracker",
                    "dmlc_tpu_torch.tracker.client", "dmlc_tpu_torch.tracker.opts",
                    "dmlc_tpu_torch.tracker.local", "dmlc_tpu_torch.tracker.submit",
                    "dmlc_tpu_torch.tracker.tpu_pod", "dmlc_tpu_torch.tracker.ssh",
                    "dmlc_tpu_torch.tracker.launcher", "dmlc_tpu_torch.tracker.mpi",
                    "dmlc_tpu_torch.tracker.sge", "dmlc_tpu_torch.tracker.slurm",
                    "dmlc_tpu_torch.tracker.kubernetes",
                    "dmlc_tpu_torch.examples.distributed_pod",
                    "dmlc_tpu_torch.service", "dmlc_tpu_torch.service.frame",
                    "dmlc_tpu_torch.service.dispatcher", "dmlc_tpu_torch.service.worker",
                    "dmlc_tpu_torch.service.client", "dmlc_tpu_torch.service.fleet",
                    "dmlc_tpu_torch.service.autoscale", "dmlc_tpu_torch.io.faults")


def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return paths


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_no_forbidden_imports_in_sources():
    offenders = []
    sources = _port_sources()
    for mod in SNAPSHOT_MODULES:  # the scan reaches the hand-picked modules (or packages)
        path = os.path.join(REPO, *mod.split("."))
        assert path + ".py" in sources or os.path.join(path, "__init__.py") in sources, mod
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [(path, n) for n in names if _forbidden(n)]
    assert not offenders


def test_every_submodule_imports_without_jax():
    script = (
        "import sys, pkgutil, importlib\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"
        "import dmlc_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(dmlc_tpu_torch.__path__, 'dmlc_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        f"assert set({SNAPSHOT_MODULES!r}) <= set(mods)\n"
        f"assert not any(k.split('.')[0] in {FORBIDDEN!r}\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 18


def test_default_device_is_the_card(tmp_path):
    path = tmp_path / "d.libsvm"
    path.write_text("1 0:1\n")
    if torch.cuda.is_available():
        assert LinearLearner(num_col=3).params.weight.is_cuda
        return
    with pytest.raises(DMLCError, match="device='cpu'"):
        LinearLearner(num_col=3)
    with pytest.raises(DMLCError, match="device='cpu'"):
        DeviceIter(dmlc_tpu_torch.create_parser(str(path)), num_col=3, batch_size=4)
    # the CPU runs when asked for
    assert LinearLearner(num_col=3, device="cpu").params.weight.device.type == "cpu"


def test_kernel_route_refuses_cpu_tensors():
    w = torch.zeros(4)
    batch = EllBatch(torch.zeros((2, 3), dtype=torch.int32), torch.zeros((2, 3)), None, None)
    with pytest.raises(DMLCError, match="CUDA"):
        ell_matvec_auto(w, batch, use_kernel=True)
