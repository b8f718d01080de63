"""The port of ``examples/train_als.py``'s local leg, against the reference.

At the example's dryrun size (128 users, 24 items, 2 factors, 8 ratings a
row, batch 16, reg 0.05, 1 KiB chunks), on the CPU:

- ``AlsLearner`` trained through the port's pod-sharded, shuffled block
  cache (the example's ``_build``: ``shuffle_seed=0``,
  ``pod_sharding=True``, a one-rank mesh) from the JAX learner's initial
  state stays within rtol 1e-4 / atol 1e-5 of the JAX learner fed by the
  JAX package's planned cache over 3 epochs (per-step losses and
  factors), and both see the same batches in the same order;
- ``python -m dmlc_tpu_torch.examples.train_als --dryrun --device cpu``
  exits 0 in a subprocess that cannot import ``jax``, prints the epoch,
  eval and restore lines (the restore replayed byte for byte over the 5
  steps after batch 3), the service line (the ALS job and a second tenant
  on one ``LocalFleet``: 2 tenant blocks, each part parsed once and served
  shared to the tenant, no give-up, the service-fed restore replayed bit
  for bit) with the JAX example's fields, and ``OK``;
- without ``--device`` the example runs on the card, and raises
  ``DMLCError`` on a host without one.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dmlc_tpu.data import create_parser as jax_create_parser
from dmlc_tpu.data.device import DeviceIter as JaxDeviceIter
from dmlc_tpu.models import AlsLearner as JaxAlsLearner
from dmlc_tpu_torch import convert
from dmlc_tpu_torch.examples import train_als
from dmlc_tpu_torch.parallel import make_mesh
from dmlc_tpu_torch.utils.check import DMLCError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5
CFG = train_als.config(dryrun=True, world=1)


def test_dryrun_config_is_the_reference_one():
    assert CFG == {"users": 128, "items": 24, "factors": 2, "per_row": 8, "batch": 16,
                   "reg": 0.05, "epochs": 3, "restore_at": 3, "chunk_bytes": 1 << 10}
    full = train_als.config(dryrun=False, world=1)
    assert (full["users"], full["items"], full["factors"], full["per_row"], full["batch"],
            full["epochs"], full["restore_at"], full["chunk_bytes"]) == (
        4096, 512, 16, 32, 512, 4, 2, 64 << 10)


def _jax_pipeline(path, cache):
    model = JaxAlsLearner(CFG["users"], CFG["items"], num_factors=CFG["factors"],
                          reg=CFG["reg"], seed=0)
    parser = jax_create_parser(path + "?engine=python", 0, 1, "libsvm", threaded=True,
                               parse_workers=1, block_cache=cache, shuffle_seed=0,
                               pod_sharding=True, chunk_bytes=CFG["chunk_bytes"])
    it = JaxDeviceIter(parser, num_col=model.device_num_col(), batch_size=CFG["batch"],
                       layout="ell", max_nnz=CFG["per_row"], drop_remainder=True)
    return model, it


def test_planned_cache_trajectory_matches_reference(tmp_path):
    path = str(tmp_path / "ratings.libsvm")
    train_als.synthesize(path, CFG["users"], CFG["items"], CFG["per_row"])
    jax_model, jit = _jax_pipeline(path, str(tmp_path / "jax.bc"))
    model, it = train_als._build(path, str(tmp_path / "port.bc"), CFG,
                                 make_mesh(devices="cpu"), "cpu")
    model.load_state_dict(convert.als_state_from_jax(jax_model.state_dict()))
    firsts = []
    for ep in range(3):
        got, want = [], []
        for jb, pb in zip(jit, it):
            np.testing.assert_array_equal(pb.label.numpy(), np.asarray(jb.label))
            want.append(float(jax_model.step(jb)))
            got.append(float(model.step(pb)))
        assert it.stats()["cache_state"] == ("cold" if ep == 0 else "warm")
        assert it.stats()["epoch"] == jit.stats()["epoch"] == ep
        jit.reset()
        it.reset()
        jax_model.finalize_items()
        model.finalize_items()
        assert len(got) == CFG["users"] // CFG["batch"]
        firsts.append(got[0])
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        for key, ref in jax_model.state_dict().items():
            np.testing.assert_allclose(model.state_dict()[key], ref, rtol=RTOL, atol=ATOL,
                                       err_msg=key)
    assert firsts[-1] < firsts[0]
    jit.close()
    it.close()


def test_example_dryrun_runs_without_jax():
    block = "import sys\nfor m in ('jax', 'jaxlib', 'dmlc_tpu'):\n    sys.modules[m] = None\n"
    script = (block + "import runpy\nsys.argv = ['train_als', '--dryrun', '--device', 'cpu']\n"
              "runpy.run_module('dmlc_tpu_torch.examples.train_als', run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert [ln.split(":")[0] for ln in lines[:3]] == ["epoch 0", "epoch 1", "epoch 2"]
    assert "cache=cold" in lines[0] and "cache=warm" in lines[1] and "cache=warm" in lines[2]
    assert lines[3].startswith("eval mse (local path): ")
    assert lines[4] == "checkpoint/restore byte-identical over 5 steps"
    assert lines[5].startswith("service-fed: loss=")
    assert lines[5].split(" ", 2)[2] == "tenant_blocks=2 parts parsed=2 shared=2 giveups=0"
    assert lines[6:] == ["OK"]


def test_example_defaults_to_the_card():
    if torch.cuda.is_available():
        assert make_mesh().device.type == "cuda"  # where main() builds everything
        return
    with pytest.raises(DMLCError, match="device='cpu'"):
        train_als.main(["--dryrun"])
