"""Entry points of the port: a single-device forward loss and a
multi-rank dry run, the counterparts of the repository's
``__graft_entry__.py``.

``entry(device=None)`` returns the forward loss of the flagship model
(logistic regression over the dense layout) and example arguments.

``dryrun_multichip(n, device=None)`` spawns ``n`` ranks, each a fresh
interpreter under the DMLC_* contract, on the card (``device=None``; it
raises without one) or on the CPU (``device="cpu"``), and runs through the
normal entry points (``init_from_env`` -> ``make_mesh`` -> per-rank
``create_parser`` -> ``DeviceIter(mesh=, shardings=)``) on the JAX dry
run's mesh (``__graft_entry__.py``): ``{"data": n // 2, "model": 2}`` when
``n`` is even, else ``{"data": n}``. Each rank reads part
``coords["data"]`` of ``shape["data"]``, so the ranks of one model group
see the same rows:

- one step each of the dense ``LinearLearner`` with ``model_axis="model"``
  (feature-sharded: its table and ``x``'s columns split over the model
  axis), and the ell ``LinearLearner`` and the dense ``FMLearner`` on the
  same mesh without it (replicated over the model axis);
- a 20-step feature-sharded dense trajectory over the data ranks' shards
  of one corpus, which must match the port's single-process learner on
  the same global batches (the data ranks' batches concatenated in data
  order) within 1e-4, agree on every rank, and descend.

The ranks' backend is gloo on the CPU; on the card it is NCCL where
there is a card for every rank, and gloo over CUDA tensors where the ranks
share fewer cards (NCCL takes one card a rank).

    python -m dmlc_tpu_torch.entry [n] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from datetime import timedelta

import numpy as np
import torch

NUM_COL, ROWS, PER_RANK_BATCH, STEPS = 16, 640, 8, 20


def entry(device=None):
    """``(fn, example_args)``: the forward loss of the flagship model."""
    from dmlc_tpu_torch.models.linear import LinearLearner, _loss_from_margin

    model = LinearLearner(num_col=32, objective="logistic", layout="dense", device=device)
    rng = np.random.default_rng(0)
    dev = model.device
    x = torch.tensor(rng.normal(size=(64, model.device_num_col())).astype(np.float32), device=dev)
    y = torch.tensor((rng.normal(size=64) > 0).astype(np.float32), device=dev)
    w = torch.ones(64, device=dev)

    def forward(params, x, y, w):
        return _loss_from_margin(x @ params.weight + params.bias, y, w, "logistic")

    return forward, (model.params, x, y, w)


def _write_corpora(out: str) -> dict:
    """A normal-valued corpus for the one-step legs and a separable one
    for the trajectory, as the JAX dry run writes them."""
    rng = np.random.default_rng(0)
    paths = {"legs": os.path.join(out, "legs.libsvm"), "traj": os.path.join(out, "traj.libsvm")}
    with open(paths["legs"], "w") as f:
        for i in range(ROWS):
            f.write(f"{i % 2} " + " ".join(f"{j}:{rng.normal():.4f}" for j in range(NUM_COL))
                    + "\n")
    rng = np.random.default_rng(1)
    with open(paths["traj"], "w") as f:
        for _ in range(ROWS):
            vals = rng.normal(size=NUM_COL)
            f.write(f"{int(vals.sum() > 0)} "
                    + " ".join(f"{j}:{vals[j]:.4f}" for j in range(NUM_COL)) + "\n")
    return paths


def _trajectory(model, it, per_epoch: int, steps: int = STEPS) -> list:
    """``steps`` step losses, ``per_epoch`` batches an epoch."""
    out = []
    while len(out) < steps:
        for _, batch in zip(range(min(per_epoch, steps - len(out))), it):
            out.append(float(model.step(batch)))
        it.reset()
    return out


def dryrun_axes(n: int) -> dict:
    """The JAX dry run's mesh over ``n`` ranks: a model axis of 2 when
    ``n`` is even."""
    return {"data": n // 2, "model": 2} if n % 2 == 0 else {"data": n}


def _dryrun_child(out: str) -> None:
    """One rank of the dry run; writes ``rank<r>.json`` into ``out``."""
    from dmlc_tpu_torch import DeviceIter, FMLearner, LinearLearner, create_parser
    from dmlc_tpu_torch.parallel import host_shard_info, init_from_env, make_mesh, sync_min
    from dmlc_tpu_torch.parallel.distributed import exit_rank

    cfg = json.load(open(os.path.join(out, "config.json")))
    init_from_env(device=cfg["device"], backend=cfg["backend"], timeout=timedelta(seconds=60))
    rank, world = host_shard_info()
    mesh = make_mesh(dryrun_axes(world), devices=cfg["device"])
    part, parts = mesh.coords["data"], mesh.shape["data"]
    model_axis = "model" if "model" in mesh.shape else None
    paths = cfg["paths"]

    def feed(model, path, **kw):
        return DeviceIter(create_parser(path, part, parts, "libsvm", threaded=False),
                          num_col=model.device_num_col(), batch_size=PER_RANK_BATCH,
                          mesh=mesh, shardings=model.batch_shardings(), drop_remainder=True,
                          **kw)

    legs = {}
    for name, model, kw in (
            ("loss", LinearLearner(NUM_COL, layout="dense", learning_rate=0.1, mesh=mesh,
                                   model_axis=model_axis),
             {"layout": "dense"}),
            ("ell_loss", LinearLearner(NUM_COL, layout="ell", learning_rate=0.1, mesh=mesh),
             {"layout": "ell", "max_nnz": NUM_COL}),
            ("fm_loss", FMLearner(NUM_COL, num_factors=4, layout="dense", mesh=mesh),
             {"layout": "dense"})):
        it = feed(model, paths["legs"], **kw)
        legs[name] = float(model.step(next(iter(it))))
        it.close()
    parser = create_parser(paths["traj"], part, parts, "libsvm", threaded=False)
    per_epoch = sync_min(sum(len(b) for b in parser) // PER_RANK_BATCH)
    parser.close()
    model = LinearLearner(NUM_COL, layout="dense", learning_rate=0.5, mesh=mesh,
                          model_axis=model_axis)
    it = feed(model, paths["traj"], layout="dense")
    traj = _trajectory(model, it, per_epoch)
    it.close()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump({"legs": legs, "traj": traj, "per_epoch": per_epoch}, f)
    exit_rank()  # destroys the group and skips torch's teardown at exit


def _single_process_trajectory(path: str, world: int, device) -> list:
    """The same 20 steps on one process: each step's global batch is the
    ``world`` data ranks' batches concatenated in data order."""
    from dmlc_tpu_torch import DeviceIter, LinearLearner, create_parser

    model = LinearLearner(NUM_COL, layout="dense", learning_rate=0.5, device=device)
    parts = []
    for part in range(world):
        it = DeviceIter(create_parser(path, part, world, "libsvm", threaded=False),
                        num_col=model.device_num_col(), batch_size=PER_RANK_BATCH,
                        layout="dense", drop_remainder=True, pack_aux=False, device=device)
        parts.append(list(it))
        it.close()
    per_epoch = min(len(p) for p in parts)
    epoch = [tuple(torch.cat([p[k][i] for p in parts]) for i in range(3))
             for k in range(per_epoch)]
    out = []
    while len(out) < STEPS:
        out += [float(model.step(b)) for b in epoch[:STEPS - len(out)]]
    return out


def dryrun_multichip(n_devices: int, timeout: float = 300.0, device=None) -> dict:
    """The multi-rank dry run over ``n_devices`` ranks on ``device`` (None:
    the card, and it raises without one; ``"cpu"``: gloo on the CPU), as
    the module docstring says. Raises when a rank fails, the trajectories
    disagree or the loss does not fall; returns the legs' losses, the two
    trajectories and the backend."""
    from dmlc_tpu_torch._device import resolve_device
    from dmlc_tpu_torch.parallel.launch import run_local

    dev = resolve_device(device)
    if dev.type == "cpu":
        backend = "gloo"
    else:
        # NCCL takes one card a rank; ranks that share a card name gloo
        backend = "nccl" if torch.cuda.device_count() >= n_devices else "gloo"
    with tempfile.TemporaryDirectory(prefix="dmlc_dryrun_") as out:
        paths = _write_corpora(out)
        with open(os.path.join(out, "config.json"), "w") as f:
            json.dump({"paths": paths, "device": dev.type, "backend": backend}, f)
        run_local([sys.executable, "-m", "dmlc_tpu_torch.entry", "--dryrun-child", out],
                  n_devices, timeout=timeout)
        ranks = [json.load(open(os.path.join(out, f"rank{r}.json")))
                 for r in range(n_devices)]
        axes = dryrun_axes(n_devices)
        single = _single_process_trajectory(paths["traj"], axes["data"], dev)
    traj = ranks[0]["traj"]
    if any(r["traj"] != traj or r["legs"] != ranks[0]["legs"] for r in ranks):
        raise RuntimeError("dryrun_multichip: the ranks disagree on the global losses")
    np.testing.assert_allclose(traj, single, atol=1e-4)
    if not traj[-1] < traj[0]:
        raise RuntimeError(f"dryrun_multichip: the loss did not decrease: {traj}")
    legs = ranks[0]["legs"]
    print(f"dryrun_multichip({n_devices}): mesh={axes} on {dev.type} "
          f"({backend}) " + " ".join(f"{k}={v:.4f}" for k, v in legs.items())
          + f" | 20-step sharded-split trajectory {traj[0]:.4f}->{traj[-1]:.4f} "
          "matches single-process to 1e-4 OK", flush=True)
    return {"legs": legs, "trajectory": traj, "single_process": single, "backend": backend,
            "mesh": axes}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=8, help="ranks of the dry run")
    ap.add_argument("--device", default=None, help="cpu, or the card (the default)")
    ap.add_argument("--dryrun-child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.dryrun_child:
        _dryrun_child(args.dryrun_child)
        return
    fn, fn_args = entry(device=args.device)
    print("entry loss:", float(fn(*fn_args)))
    dryrun_multichip(args.n, device=args.device)


if __name__ == "__main__":
    main()
