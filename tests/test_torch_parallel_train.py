"""Data-parallel training in the port against the JAX package's global batch.

Each multi-rank case spawns 2 and 4 gloo ranks on the CPU in fresh
interpreters (``dmlc_tpu_torch.parallel.launch.run_local``, the DMLC_*
contract set per rank as the ``tpu-pod`` launcher sets it). One spawned
group a world size runs every leg through the normal entry points:
``init_from_env`` -> ``make_mesh`` / ``host_shard_info`` -> per-rank
``create_parser(path, rank, world)`` -> ``DeviceIter(mesh=, shardings=)`` ->
the learner's step with its collectives. The JAX reference is the one the
JAX package's own multi-process test uses (``tests/test_distributed.py``
``_single_process_reference``, since this jaxlib runs no multi-process
collectives): one JAX learner stepping on the global batches, each the
ranks' batches concatenated in rank order, from the same initial state
(``dmlc_tpu_torch.convert``).

- ``LinearLearner`` dense (logistic with l2) and ell (logistic, softmax)
  and ``FMLearner`` dense and ell: 20 steps, losses and final parameters
  within rtol 1e-5 / atol 1e-6 (FM, under Adam: 1e-5 / 1e-5, the
  tolerance of its single-process parity test, ``FM_TOL``);
- ``AlsLearner``: 2 epochs with the item solve, losses and tables within
  rtol 1e-4 / atol 1e-5, and ``eval_loss``;
- the parameters bit-identical across the ranks;
- weighted rows whose per-rank weight sums differ: the global weighted
  mean (a mean of the ranks' means, as ``DistributedDataParallel`` takes,
  misses it by more than 1e-3 here);
- ``fit`` capped by ``sync_min`` over shards of unequal batch counts ends
  with the same step count on every rank;
- ``accuracy`` equal to JAX's global pass;
- the first mesh step against the JAX learner on the in-process virtual
  mesh of the same size, within 1e-5;
- a two-axis mesh (``{"data": world / 2, "model": 2}``): a learner without
  a model axis trains on it, replicated over the model axis, its first
  step within 1e-5 of the JAX learner's on the virtual mesh of that shape,
  and a model axis the mesh lacks raises (feature sharding itself:
  ``tests/test_torch_feature_shard.py``);
- in process: a group of one gives the non-mesh step's bits, and bcoo,
  snapshots and a model axis the mesh lacks raise under a mesh, as in JAX.
"""

import json
import sys
import textwrap
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from dmlc_tpu.data import create_parser as jax_create_parser
from dmlc_tpu.data.device import DeviceIter as JaxDeviceIter
from dmlc_tpu.models import AlsLearner as JaxAlsLearner
from dmlc_tpu.models import LinearLearner as JaxLinearLearner
from dmlc_tpu.models.fm import FMLearner as JaxFMLearner
from dmlc_tpu.models.linear import LinearParams as JaxLinearParams
from dmlc_tpu.ops.sparse import EllBatch as JaxEllBatch
from dmlc_tpu.parallel import make_mesh as jax_make_mesh
from dmlc_tpu_torch import DeviceIter, FMLearner, LinearLearner, create_parser
from dmlc_tpu_torch.ops.sparse import EllBatch
from dmlc_tpu_torch.parallel import make_mesh, pod_identity, sync_min
from dmlc_tpu_torch.parallel.launch import free_port, run_local
from dmlc_tpu_torch.utils.check import DMLCError

NUM_COL, B, STEPS = 12, 16, 20
RTOL, ATOL = 1e-5, 1e-6
# FM under Adam: the update divides by sqrt(v), so a gradient summed in
# another order moves a small factor by a larger share; the port's
# single-process FM is 6e-6 off JAX's after 20 steps on these batches
# (v up to 3e-4 relative), so FM keeps tests/test_torch_fm.py's tolerance
FM_TOL = 1e-5
ALS_CFG = {"users": 256, "items": 24, "factors": 2, "per_row": 8, "reg": 0.05, "epochs": 2}
ALS_RTOL, ALS_ATOL = 1e-4, 1e-5

# ---------------- corpora (numpy, from seeds) ----------------


def _write(path, lines):
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _binary_corpus(path, n, seed, weighted=False):
    """Sparse rows (|x| > 0.3 kept) with a noisy linear label; with
    ``weighted``, ``label:weight`` rows whose first third weighs about 12x
    the rest, so byte-range shards hold unequal weight sums."""
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=NUM_COL)
    lines = []
    for i in range(n):
        x = rng.normal(size=NUM_COL)
        y = int(x @ w_true + 0.3 * rng.normal() > 0)
        label = f"{y}"
        if weighted:
            label += f":{(3.0 if i < n // 3 else 0.25) * rng.uniform(0.5, 1.5):.4f}"
        lines.append(label + " " + " ".join(f"{j}:{x[j]:.5f}" for j in range(NUM_COL)
                                            if abs(x[j]) > 0.3))
    return _write(path, lines)


def _softmax_corpus(path, n=1400, seed=21):
    rng = np.random.default_rng(seed)
    w3 = rng.normal(size=(NUM_COL, 3))
    lines = []
    for _ in range(n):
        x = rng.normal(size=NUM_COL)
        lines.append(f"{int(np.argmax(x @ w3))} "
                     + " ".join(f"{j}:{x[j]:.5f}" for j in range(NUM_COL) if abs(x[j]) > 0.3))
    return _write(path, lines)


def _uneven_corpus(path, n=640, seed=31):
    """Long rows first, short rows after: byte-range shards then hold
    unequal row (and batch) counts."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        cols = range(NUM_COL) if i < n // 2 else (0, 1)
        x = rng.normal(size=NUM_COL)
        lines.append(f"{int(x[0] + x[1] > 0)} "
                     + " ".join(f"{j}:{x[j]:.8f}" for j in cols))
    return _write(path, lines)


def _ratings_corpus(path, seed=0, rank=4):
    """``examples/train_als.py``'s ``synthesize``: one row per user."""
    rng = np.random.default_rng(seed)
    users, items, per_row = ALS_CFG["users"], ALS_CFG["items"], ALS_CFG["per_row"]
    gt_u = rng.normal(size=(users, rank)).astype(np.float32)
    gt_v = rng.normal(size=(items, rank)).astype(np.float32)
    lines = []
    for uid in range(users):
        cols = rng.choice(items, size=per_row, replace=False)
        ratings = gt_u[uid] @ gt_v[cols].T
        lines.append(f"{uid} " + " ".join(f"{j}:{r:.6f}" for j, r in zip(cols, ratings)))
    return _write(path, lines)


# ---------------- the legs: what each rank runs ----------------

LEGS = {  # name: (learner, corpus, layout, learner kwargs)
    "linear_dense": ("linear", "binary", "dense",
                     dict(objective="logistic", learning_rate=0.3, l2=0.01)),
    "linear_ell": ("linear", "binary", "ell", dict(objective="logistic", learning_rate=0.3)),
    "linear_softmax": ("linear", "softmax", "ell",
                       dict(objective="softmax", num_class=3, learning_rate=0.3)),
    "linear_weighted": ("linear", "weighted", "ell",
                        dict(objective="logistic", learning_rate=0.3)),
    "fm_dense": ("fm", "binary", "dense",
                 dict(num_factors=4, learning_rate=0.05, init_scale=0.1)),
    "fm_ell": ("fm", "binary", "ell",
               dict(num_factors=4, learning_rate=0.05, init_scale=0.1, l2=0.01)),
}

WORKER = textwrap.dedent(r'''
    import hashlib, json, os, sys
    from datetime import timedelta

    import numpy as np
    import torch

    from dmlc_tpu_torch import (AlsLearner, DMLCError, DeviceIter, FMLearner,
                                LinearLearner, convert, create_parser)
    from dmlc_tpu_torch.parallel import (host_shard_info, init_from_env, make_mesh,
                                         pod_identity, sync_min)
    from dmlc_tpu_torch.parallel.distributed import exit_rank

    cfg = json.load(open(sys.argv[1]))
    contract = init_from_env(device="cpu", timeout=timedelta(seconds=60))
    mesh = make_mesh(devices="cpu")
    rank, world = host_shard_info()
    assert (rank, world) == (contract.task_id, contract.num_worker) == pod_identity()
    assert mesh.shape == {"data": world} and mesh.coords == {"data": rank}
    B, out = cfg["batch"], {"rank": rank, "legs": {}}

    def bits(params):
        return hashlib.sha256(b"".join(t.detach().numpy().tobytes()
                                       for t in params)).hexdigest()

    def local_batches(path):
        parser = create_parser(path, rank, world, "libsvm", threaded=False)
        rows = sum(len(b) for b in parser)
        parser.close()
        return rows // B

    def feed(model, path, layout, max_nnz):
        return DeviceIter(create_parser(path, rank, world, "libsvm", threaded=False),
                          num_col=model.device_num_col(), batch_size=B, layout=layout,
                          max_nnz=max_nnz, mesh=mesh, shardings=model.batch_shardings(),
                          drop_remainder=True)

    def run(model, it, per_epoch, total, on_step=None, epoch_end=None):
        losses = []
        while len(losses) < total:
            for _, b in zip(range(min(per_epoch, total - len(losses))), it):
                losses.append(float(model.step(b)))
                if on_step:
                    on_step(len(losses))
            it.reset()
            if epoch_end:
                epoch_end()
        return losses

    init = np.load(cfg["init"])
    for name, (kind, corpus, layout, kw) in cfg["legs"].items():
        path, nc = cfg["corpora"][corpus], cfg["num_col"]
        if kind == "linear":
            model = LinearLearner(nc, layout=layout, mesh=mesh, **kw)
            model.set_params(convert.linear_params_from_jax(
                init[f"{corpus}_w{kw.get('num_class', 1)}"], init[f"{corpus}_b{kw.get('num_class', 1)}"],
                "cpu"))
        else:
            model = FMLearner(nc, layout=layout, mesh=mesh, **kw)
            model.set_params(convert.fm_params_from_jax(
                *(init[f"{name}_{k}"] for k in ("w0", "w", "v")), "cpu"))
        it = feed(model, path, layout, nc)
        per_epoch = sync_min(local_batches(path))
        leg = {"per_epoch": per_epoch}

        def first_step(n):
            if n == 1:
                leg["step1"] = [t.detach().numpy().ravel().tolist() for t in model.params]

        leg["losses"] = run(model, it, per_epoch, cfg["steps"], on_step=first_step)
        leg["accuracy"] = model.accuracy(it, max_steps=per_epoch)
        leg["bits"] = bits(model.params)
        leg["params"] = [t.detach().numpy().ravel().tolist() for t in model.params]
        it.close()
        out["legs"][name] = leg

    # ALS: two alternations, then eval_loss
    als = cfg["als"]
    model = AlsLearner(als["users"], als["items"], num_factors=als["factors"], reg=als["reg"],
                       mesh=mesh, device="cpu")
    model.load_state_dict({k: init[f"als_{k}"] for k in ("users", "items", "gram", "rhs")})
    path = cfg["corpora"]["ratings"]
    it = DeviceIter(create_parser(path, rank, world, "libsvm", threaded=False),
                    num_col=model.device_num_col(), batch_size=B, layout="ell",
                    max_nnz=als["per_row"], mesh=mesh, shardings=model.batch_shardings(),
                    drop_remainder=True)
    per_epoch = sync_min(local_batches(path))
    losses = run(model, it, per_epoch, per_epoch * als["epochs"], epoch_end=model.finalize_items)
    state = model.state_dict()
    out["als"] = {"per_epoch": per_epoch, "losses": losses,
                  "eval": model.eval_loss(it, max_steps=per_epoch),
                  "bits": hashlib.sha256(b"".join(state[k].tobytes() for k in sorted(state))).hexdigest()}
    if rank == 0:
        np.savez(os.path.join(cfg["out"], "als_state.npz"), **state)
    it.close()

    # fit capped by sync_min over shards of unequal batch counts
    path = cfg["corpora"]["uneven"]
    model = LinearLearner(cfg["num_col"], layout="dense", learning_rate=0.3, mesh=mesh)
    it = feed(model, path, "dense", None)
    local = local_batches(path)
    cap = sync_min(local)
    epochs = []
    model.fit(it, epochs=2, steps_per_epoch=cap,
              log_fn=lambda e, loss, nb, secs: epochs.append([loss, nb]))
    out["uneven"] = {"local": local, "cap": cap, "epochs": epochs,
                     "bits": bits(model.params)}
    it.close()

    # a two-axis mesh: a learner without a model axis is replicated over it
    # (the JAX dry run trains so); a model axis the mesh lacks raises
    wide = make_mesh({"data": -1, "model": 2}, devices="cpu") if world % 2 == 0 else None
    if wide is not None:
        out["wide_shape"] = wide.shape
        try:
            LinearLearner(cfg["num_col"], mesh=wide, model_axis="tensor")
            out["wide_raised"] = False
        except DMLCError as exc:
            out["wide_raised"] = "not an axis" in str(exc)
        model = LinearLearner(cfg["num_col"], layout="ell", learning_rate=0.3, mesh=wide)
        model.set_params(convert.linear_params_from_jax(init["binary_w1"], init["binary_b1"],
                                                        "cpu"))
        it = DeviceIter(create_parser(cfg["corpora"]["binary"], wide.coords["data"],
                                      wide.shape["data"], "libsvm", threaded=False),
                        num_col=model.device_num_col(), batch_size=B, layout="ell",
                        max_nnz=cfg["num_col"], mesh=wide, shardings=model.batch_shardings(),
                        drop_remainder=True)
        loss = float(model.step(next(iter(it))))
        out["wide_step"] = {"loss": loss, "bits": bits(model.params),
                            "params": [t.detach().numpy().ravel().tolist()
                                       for t in model.params]}
        it.close()
    with open(os.path.join(cfg["out"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    exit_rank()  # destroys the group and skips torch's teardown at exit
''')


# ---------------- the JAX reference ----------------


class _Batches:
    """A list of global batches as the JAX loop iterates a DeviceIter."""

    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)

    def reset(self):
        pass


def _global_epoch(path, world, layout, max_nnz, num_col):
    """One epoch of global batches: each part's JAX DeviceIter batches, cut
    to the smallest part's count (the ranks' ``sync_min``), concatenated in
    rank order. Returns the batches (numpy) and each part's count."""
    parts = []
    for r in range(world):
        it = JaxDeviceIter(jax_create_parser(path + "?engine=python", r, world, "libsvm",
                                             threaded=False),
                           num_col=num_col, batch_size=B, layout=layout, max_nnz=max_nnz,
                           drop_remainder=True, pack_aux=False)
        parts.append([tuple(np.asarray(a) for a in b) for b in it])
        it.close()
    steps = min(len(p) for p in parts)
    batches = [tuple(np.concatenate([p[k][i] for p in parts]) for i in range(len(parts[0][0])))
               for k in range(steps)]
    return batches, [len(p) for p in parts]


def _jax_batch(arrays, layout):
    if layout == "ell":
        return JaxEllBatch(*(jnp.asarray(a) for a in arrays))
    return tuple(jnp.asarray(a) for a in arrays)


def _jax_learner(name, init):
    kind, corpus, layout, kw = LEGS[name]
    if kind == "linear":
        model = JaxLinearLearner(NUM_COL, layout=layout, **kw)
        c = kw.get("num_class", 1)
        model.params = JaxLinearParams(jnp.asarray(init[f"{corpus}_w{c}"]),
                                       jnp.asarray(init[f"{corpus}_b{c}"]))
        model.opt_state = model.opt.init(model.params)
    else:
        model = JaxFMLearner(NUM_COL, layout=layout, seed=3, **kw)
    return model


def _reference(name, corpora, world, init):
    """The JAX learner on the global batches: step losses (cycling the
    epoch as the ranks do), params after step 1 and at the end, and the
    accuracy pass over one epoch."""
    kind, corpus, layout, _ = LEGS[name]
    batches, _ = _global_epoch(corpora[corpus], world, layout, NUM_COL, NUM_COL + 1
                               if layout == "dense" else NUM_COL)
    model = _jax_learner(name, init)
    losses, step1 = [], None
    while len(losses) < STEPS:
        for arrays in batches[:STEPS - len(losses)]:
            losses.append(float(model.step(_jax_batch(arrays, layout))))
            if step1 is None:
                step1 = [np.asarray(p).ravel() for p in model.params]
    acc = model.accuracy(_Batches([_jax_batch(a, layout) for a in batches]))
    return {"losses": losses, "step1": step1, "accuracy": acc, "batches": batches,
            "params": [np.asarray(p).ravel() for p in model.params]}


# ---------------- the spawned groups ----------------


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpora")
    return {"binary": _binary_corpus(d / "binary.libsvm", 1400, 5),
            "weighted": _binary_corpus(d / "weighted.libsvm", 1400, 6, weighted=True),
            "softmax": _softmax_corpus(d / "softmax.libsvm"),
            "uneven": _uneven_corpus(d / "uneven.libsvm"),
            "ratings": _ratings_corpus(d / "ratings.libsvm")}


@pytest.fixture(scope="module")
def init(tmp_path_factory):
    """The initial states, from numpy seeds and the JAX learners' own init."""
    rng = np.random.default_rng(13)
    arrays = {}
    for corpus in ("binary", "weighted", "softmax", "uneven"):
        for c in (1, 3):
            shape = (NUM_COL + 1, c) if c > 1 else (NUM_COL + 1,)
            w = (0.1 * rng.normal(size=shape)).astype(np.float32)
            w[-1] = 0.0
            arrays[f"{corpus}_w{c}"] = w
            arrays[f"{corpus}_b{c}"] = np.full(shape[1:], 0.05, np.float32)
    for name, (kind, _, _, _) in LEGS.items():
        if kind == "fm":
            for k, p in zip(("w0", "w", "v"), _jax_learner(name, arrays).params):
                arrays[f"{name}_{k}"] = np.asarray(p)
    als = JaxAlsLearner(ALS_CFG["users"], ALS_CFG["items"], num_factors=ALS_CFG["factors"],
                        reg=ALS_CFG["reg"], seed=0)
    for k, v in als.state_dict().items():
        arrays[f"als_{k}"] = v
    path = tmp_path_factory.mktemp("init") / "init.npz"
    np.savez(path, **arrays)
    return {"path": str(path), **arrays}


@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: f"world{w}")
def group(request, corpora, init, tmp_path_factory):
    """One spawned gloo group a world size runs every leg; its ranks' JSON."""
    world = request.param
    out = tmp_path_factory.mktemp(f"world{world}")
    script = out / "worker.py"
    script.write_text(WORKER)
    cfg = {"batch": B, "steps": STEPS, "num_col": NUM_COL, "init": init["path"],
           "corpora": corpora, "out": str(out), "legs": LEGS, "als": ALS_CFG}
    (out / "cfg.json").write_text(json.dumps(cfg))
    run_local([sys.executable, str(script), str(out / "cfg.json")], world, timeout=240)
    ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(world)]
    return {"world": world, "ranks": ranks, "out": out}


@pytest.mark.parametrize("name", list(LEGS))
def test_twenty_mesh_steps_match_global_batch_reference(group, corpora, init, name):
    world, ranks = group["world"], group["ranks"]
    ref = _reference(name, corpora, world, init)
    legs = [r["legs"][name] for r in ranks]
    rtol, atol = (FM_TOL, FM_TOL) if LEGS[name][0] == "fm" else (RTOL, ATOL)
    assert all(leg["per_epoch"] == len(ref["batches"]) for leg in legs)
    # the loss is global: every rank reports the same one
    assert all(leg["losses"] == legs[0]["losses"] for leg in legs)
    np.testing.assert_allclose(legs[0]["losses"], ref["losses"], rtol=rtol, atol=atol)
    for got, want in zip(legs[0]["params"], ref["params"]):
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    # replicated parameters: the same bits on every rank
    assert len({leg["bits"] for leg in legs}) == 1
    assert all(leg["accuracy"] == legs[0]["accuracy"] for leg in legs)
    np.testing.assert_allclose(legs[0]["accuracy"], ref["accuracy"], rtol=RTOL)
    assert legs[0]["losses"][-1] < legs[0]["losses"][0]


def test_unequal_rank_weights_take_the_global_weighted_mean(group, corpora, init):
    """The weighted corpus's ranks hold unequal weight sums: the ranks'
    mean of means (DDP's) misses the global weighted mean that both
    packages' steps take (the leg above holds the 20 steps to it)."""
    world = group["world"]
    batches, _ = _global_epoch(corpora["weighted"], world, "ell", NUM_COL, NUM_COL)
    model = _jax_learner("linear_weighted", init)
    first = batches[0]
    sums = [float(first[3][r * B:(r + 1) * B].sum()) for r in range(world)]
    assert max(sums) > 2 * min(sums), sums
    rank_means = [float(model.loss_fn(model.params, _jax_batch(
        tuple(a[r * B:(r + 1) * B] for a in first), "ell"))) for r in range(world)]
    global_mean = float(model.loss_fn(model.params, _jax_batch(first, "ell")))
    assert abs(np.mean(rank_means) - global_mean) > 1e-3
    np.testing.assert_allclose(group["ranks"][0]["legs"]["linear_weighted"]["losses"][0],
                               global_mean, rtol=RTOL, atol=ATOL)


def test_als_two_epochs_match_global_batch_reference(group, corpora, init):
    world, ranks = group["world"], group["ranks"]
    batches, _ = _global_epoch(corpora["ratings"], world, "ell", ALS_CFG["per_row"],
                               ALS_CFG["items"])
    ref = JaxAlsLearner(ALS_CFG["users"], ALS_CFG["items"], num_factors=ALS_CFG["factors"],
                        reg=ALS_CFG["reg"], seed=0)
    ref.load_state_dict({k: init[f"als_{k}"] for k in ("users", "items", "gram", "rhs")})
    losses = []
    for _ in range(ALS_CFG["epochs"]):
        losses += [float(ref.step(_jax_batch(a, "ell"))) for a in batches]
        ref.finalize_items()
    got = ranks[0]["als"]
    assert got["per_epoch"] == len(batches) and len({r["als"]["bits"] for r in ranks}) == 1
    np.testing.assert_allclose(got["losses"], losses, rtol=ALS_RTOL, atol=ALS_ATOL)
    state = np.load(group["out"] / "als_state.npz")
    for key, want in ref.state_dict().items():
        np.testing.assert_allclose(state[key], want, rtol=ALS_RTOL, atol=ALS_ATOL, err_msg=key)
    want_eval = ref.eval_loss(_Batches([_jax_batch(a, "ell") for a in batches]))
    assert all(r["als"]["eval"] == got["eval"] for r in ranks)
    np.testing.assert_allclose(got["eval"], want_eval, rtol=ALS_RTOL, atol=ALS_ATOL)
    half = len(losses) // 2
    assert np.mean(losses[half:]) < np.mean(losses[:half])  # the alternation descends


def test_sync_min_caps_fit_over_uneven_shards(group, corpora, init):
    world, ranks = group["world"], group["ranks"]
    locals_ = [r["uneven"]["local"] for r in ranks]
    assert len(set(locals_)) > 1, locals_  # the shards really are uneven
    for r in ranks:
        assert r["uneven"]["cap"] == min(locals_)
        assert [nb for _, nb in r["uneven"]["epochs"]] == [min(locals_)] * 2
    assert len({r["uneven"]["bits"] for r in ranks}) == 1
    # the capped epochs' mean losses are JAX's fit_epoch over the global batches
    batches, counts = _global_epoch(corpora["uneven"], world, "dense", None, NUM_COL + 1)
    assert counts == locals_
    ref = JaxLinearLearner(NUM_COL, layout="dense", learning_rate=0.3)
    want = [ref.fit_epoch(_Batches([_jax_batch(a, "dense") for a in batches]))[0]
            for _ in range(2)]
    np.testing.assert_allclose([loss for loss, _ in ranks[0]["uneven"]["epochs"]], want,
                               rtol=RTOL, atol=ATOL)


def test_first_mesh_step_matches_jax_virtual_mesh(group, corpora, init):
    """JAX's own mesh path (XLA's collectives over ``world`` virtual CPU
    devices) on the same global batch: the port's first mesh step."""
    world = group["world"]
    for name in ("linear_ell", "linear_dense"):
        _, corpus, layout, kw = LEGS[name]
        batches, _ = _global_epoch(corpora[corpus], world, layout, NUM_COL,
                                   NUM_COL + 1 if layout == "dense" else NUM_COL)
        mesh = jax_make_mesh({"data": world}, devices=jax.devices()[:world])
        model = JaxLinearLearner(NUM_COL, layout=layout, mesh=mesh, **kw)
        model.params = JaxLinearParams(jnp.asarray(init[f"{corpus}_w1"]),
                                       jnp.asarray(init[f"{corpus}_b1"]))
        model.opt_state = model.opt.init(model.params)
        placed = [jax.device_put(a, sh) for a, sh in zip(batches[0], model.batch_shardings())]
        batch = JaxEllBatch(*placed) if layout == "ell" else tuple(placed)
        loss = float(model.step(batch))
        leg = group["ranks"][0]["legs"][name]
        np.testing.assert_allclose(leg["losses"][0], loss, rtol=1e-5, atol=1e-5)
        for got, want in zip(leg["step1"], model.params):
            np.testing.assert_allclose(got, np.asarray(want).ravel(), rtol=1e-5, atol=1e-5)


def test_feature_sharding_raises_on_a_model_axis(group, corpora, init):
    """On ``{"data": world / 2, "model": 2}`` a learner without a model
    axis trains, replicated over the model axis (every rank the same bits),
    and its first step is the JAX learner's on the virtual mesh of that
    shape; a ``model_axis`` that is not a mesh axis raises. (This test
    asserted the refusal of any second mesh axis until feature sharding
    was ported; ``tests/test_torch_feature_shard.py`` trains it.)"""
    world, data = group["world"], group["world"] // 2
    for r in group["ranks"]:
        assert r["wide_shape"] == {"data": data, "model": 2}
        assert r["wide_raised"] is True
    assert len({r["wide_step"]["bits"] for r in group["ranks"]}) == 1
    batches, _ = _global_epoch(corpora["binary"], data, "ell", NUM_COL, NUM_COL)
    mesh = jax_make_mesh({"data": data, "model": 2}, devices=jax.devices()[:world])
    model = JaxLinearLearner(NUM_COL, layout="ell", learning_rate=0.3, mesh=mesh)
    model.params = JaxLinearParams(jnp.asarray(init["binary_w1"]),
                                   jnp.asarray(init["binary_b1"]))
    model.opt_state = model.opt.init(model.params)
    placed = [jax.device_put(a, sh) for a, sh in zip(batches[0], model.batch_shardings())]
    loss = float(model.step(JaxEllBatch(*placed)))
    got = group["ranks"][0]["wide_step"]
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-5, atol=1e-5)
    for g, w in zip(got["params"], model.params):
        np.testing.assert_allclose(g, np.asarray(w).ravel(), rtol=1e-5, atol=1e-5)


# ---------------- in process ----------------


def _ell_batches(seed, steps=5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        idx = rng.integers(0, NUM_COL, size=(B, 6)).astype(np.int32)
        val = rng.normal(size=(B, 6)).astype(np.float32)
        pad = rng.random(size=(B, 6)) < 0.3
        idx[pad], val[pad] = NUM_COL, 0.0
        out.append(EllBatch(torch.from_numpy(idx), torch.from_numpy(val),
                            torch.from_numpy(rng.integers(0, 2, B).astype(np.float32)),
                            torch.from_numpy(rng.uniform(0.5, 1.5, B).astype(np.float32))))
    return out


def test_group_of_one_gives_the_single_device_bits():
    """A world-size-1 gloo group: the mesh's data axis holds one rank,
    so the mesh step issues no collective over it, and gives the non-mesh
    step's bits."""
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0, timeout=timedelta(seconds=60))
    try:
        mesh = make_mesh(devices="cpu")
        assert mesh.distributed and mesh.shape == {"data": 1}
        assert sync_min(7) == 7 and pod_identity(env={}) == (0, 1)
        plain = LinearLearner(NUM_COL, layout="ell", learning_rate=0.3, device="cpu")
        meshed = LinearLearner(NUM_COL, layout="ell", learning_rate=0.3, mesh=mesh)
        fm_plain = FMLearner(NUM_COL, layout="ell", seed=2, device="cpu")
        fm_mesh = FMLearner(NUM_COL, layout="ell", seed=2, mesh=mesh)
        for b in _ell_batches(3):
            assert torch.equal(plain.step(b), meshed.step(b))
            assert torch.equal(fm_plain.step(b), fm_mesh.step(b))
        for a, m in ((plain, meshed), (fm_plain, fm_mesh)):
            assert all(torch.equal(p, q) for p, q in zip(a.params, m.params))
    finally:
        dist.destroy_process_group()


def test_mesh_raises_where_the_reference_raises(tmp_path):
    path = _binary_corpus(tmp_path / "c.libsvm", 64, 1)
    mesh = make_mesh(devices="cpu")
    jmesh = jax_make_mesh({"data": 1}, devices=jax.devices()[:1])
    from dmlc_tpu.utils.check import DMLCError as JaxDMLCError

    for layout in ("bcoo",):
        with pytest.raises(DMLCError, match="single-device"):
            LinearLearner(NUM_COL, layout=layout, mesh=mesh)
        with pytest.raises(JaxDMLCError, match="single-device"):
            JaxLinearLearner(NUM_COL, layout=layout, mesh=jmesh)
        with pytest.raises(DMLCError, match="single-device"):
            FMLearner(NUM_COL, layout=layout, mesh=mesh)
        with pytest.raises(JaxDMLCError, match="single-device"):
            JaxFMLearner(NUM_COL, layout=layout, mesh=jmesh)
        with pytest.raises(DMLCError, match="bcoo"):
            DeviceIter(create_parser(path, 0, 1, "libsvm", threaded=False), NUM_COL, B,
                       "bcoo", mesh=mesh)
    with pytest.raises(DMLCError, match="snapshot"):
        DeviceIter(create_parser(path, 0, 1, "libsvm", threaded=False), NUM_COL + 1, B,
                   mesh=mesh, snapshot=str(tmp_path / "s.snapshot"))
    with pytest.raises(DMLCError, match="snapshot"):  # the parser's stamp counts too
        DeviceIter(create_parser(path, 0, 1, "libsvm", snapshot=str(tmp_path / "t.snapshot")),
                   NUM_COL + 1, B, mesh=mesh)
    with pytest.raises(DMLCError, match="not an axis"):
        LinearLearner(NUM_COL, mesh=mesh, model_axis="model")
    with pytest.raises(DMLCError, match="shardings"):
        DeviceIter(create_parser(path, 0, 1, "libsvm", threaded=False), NUM_COL + 1, B,
                   mesh=mesh, shardings=LinearLearner(NUM_COL, layout="ell",
                                                      mesh=mesh).batch_shardings())
    # dense batches ship unpacked under a mesh, on the mesh's device
    model = LinearLearner(NUM_COL, mesh=mesh)
    it = DeviceIter(create_parser(path, 0, 1, "libsvm", threaded=False),
                    model.device_num_col(), B, mesh=mesh, shardings=model.batch_shardings())
    assert not it.pack_aux
    x, y, w = next(iter(it))
    assert x.shape == (B, NUM_COL + 1) and x.device == mesh.device
    it.close()
    with pytest.raises(DMLCError, match="mesh's"):
        LinearLearner(NUM_COL, mesh=mesh, device="meta")
