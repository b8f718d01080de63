"""The port's entry points (``entry``, the dry run) and its ``train_linear`` example.

- ``dmlc_tpu_torch.entry.entry(device="cpu")``: the flagship model's
  forward loss on the JAX entry's inputs equals ``__graft_entry__.entry()``'s
  within 1e-6;
- ``dryrun_multichip(2, device="cpu")``: two spawned gloo ranks run the
  dense, ell and FM one-step legs and a 20-step trajectory over the
  ranks' shards that matches the single-process port run on the same
  global batches within 1e-4 and descends (it raises otherwise); without
  ``device`` it runs on the card, and raises on a host without one;
- ``python -m dmlc_tpu_torch.examples.train_linear --device cpu`` under
  two ranks (the DMLC_* contract per rank) trains to accuracy above 0.9,
  every rank stepping the same count an epoch.
"""

import re
import sys

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from dmlc_tpu_torch.entry import dryrun_multichip, entry
from dmlc_tpu_torch.parallel.launch import run_local
from dmlc_tpu_torch.utils.check import DMLCError


def test_entry_forward_matches_reference():
    fn, args = entry(device="cpu")
    jfn, jargs = graft.entry()
    np.testing.assert_array_equal(args[1].numpy(), np.asarray(jargs[1]))
    np.testing.assert_allclose(float(fn(*args).detach()), float(jax.jit(jfn)(*jargs)), rtol=1e-6)


def test_dryrun_multichip_two_ranks():
    out = dryrun_multichip(2, timeout=180, device="cpu")
    assert out["backend"] == "gloo"
    assert set(out["legs"]) == {"loss", "ell_loss", "fm_loss"}
    assert all(np.isfinite(v) for v in out["legs"].values())
    assert len(out["trajectory"]) == 20
    assert out["trajectory"][-1] < out["trajectory"][0]


def test_dryrun_multichip_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DMLCError, match="CUDA is not available"):
        dryrun_multichip(2)


def test_train_linear_example_two_ranks():
    results = run_local([sys.executable, "-m", "dmlc_tpu_torch.examples.train_linear",
                         "--device", "cpu"], 2, timeout=180)
    counts, accs = [], []
    for r in results:
        counts.append(re.findall(r"batches=(\d+)", r.stdout))
        accs += [float(a) for a in re.findall(r"train accuracy: ([0-9.]+)", r.stdout)]
    assert len(counts[0]) == 5 and counts[0] == counts[1], counts
    assert len(accs) == 2 and accs[0] == accs[1] and accs[0] > 0.9, accs
