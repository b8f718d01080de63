"""Feature sharding in the port (``LinearLearner(model_axis=)``) and every
learner on a two-axis mesh, against the JAX package.

Two spawned gloo groups on the CPU (``dmlc_tpu_torch.parallel.launch.
run_local``), one on ``{"data": 1, "model": 2}`` and one on ``{"data": 2,
"model": 2}``, each running every leg through the normal entry points:
``init_from_env`` -> ``make_mesh`` -> ``create_parser(path, coords["data"],
shape["data"])`` -> ``DeviceIter(mesh=, shardings=)`` -> the learner. The
JAX reference is ``LinearLearner(mesh=make_mesh({... "model": 2}),
model_axis="model")`` on the in-process virtual CPU devices, stepping on
the global batches (the data ranks' batches concatenated in data order)
from the same initial table (``dmlc_tpu_torch.convert``, the rank's shard
in, the all-gathered table out).

- ``dense`` logistic with ``l2``, ``dense`` softmax, ``ell`` logistic and
  ``ell`` softmax: 20 steps, the losses and the gathered table within
  rtol 1e-5 / atol 1e-6 (float32 sums taken in another order), the table
  bit-equal across the ranks, ``accuracy`` equal to JAX's within 1e-5;
- ``weight_dim`` and ``device_num_col()`` equal to JAX's (10 and 10 / 9
  for ``num_col = 8`` at model 2, as ``tests/test_device.py`` pins), each
  rank holding 5 words and shipping 5 columns of a dense batch, and the
  sink at 0, pinned by the last model rank alone;
- ``FMLearner`` and ``AlsLearner`` on the two-axis mesh without a model
  axis, replicated over it, against the JAX one-process learner on the
  global batches (FM within 1e-5 under Adam, as its data-axis test; ALS
  within rtol 1e-4 / atol 1e-5, its ``eval_loss`` too);
- the mesh's per-axis collectives: sums over one axis and over every rank,
  and the all-gather in coordinate order;
- in process: the windowed plain ``ell_matvec`` and ``ell_matvec_grads``
  (the CPU route, and the reference of the windowed kernels on the card)
  against JAX's ``ell_matvec`` and its ``jax.grad`` on the table with the
  words outside the window zeroed, within 1e-5; and ``bcoo`` with a mesh
  and a ``model_axis`` that is not a mesh axis still raise, as in JAX.
"""

import json
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlc_tpu.data import create_parser as jax_create_parser
from dmlc_tpu.data.device import DeviceIter as JaxDeviceIter
from dmlc_tpu.models import AlsLearner as JaxAlsLearner
from dmlc_tpu.models import LinearLearner as JaxLinearLearner
from dmlc_tpu.models.fm import FMLearner as JaxFMLearner
from dmlc_tpu.models.linear import LinearParams as JaxLinearParams
from dmlc_tpu.ops import sparse as jsparse
from dmlc_tpu.ops.sparse import EllBatch as JaxEllBatch
from dmlc_tpu.parallel import make_mesh as jax_make_mesh
from dmlc_tpu_torch import FMLearner, LinearLearner
from dmlc_tpu_torch.ops import sparse
from dmlc_tpu_torch.ops.ell_matvec import ell_matvec_auto, ell_matvec_grads
from dmlc_tpu_torch.parallel import make_mesh
from dmlc_tpu_torch.parallel.launch import run_local
from dmlc_tpu_torch.utils.check import DMLCError

NUM_COL, B, STEPS, MODEL = 8, 16, 20, 2
WEIGHT_DIM = 10  # 8 + 1 rounded up to the model axis, as in JAX
RTOL, ATOL = 1e-5, 1e-6
FM_TOL = 1e-5  # FM under Adam: tests/test_torch_parallel_train.py's FM tolerance
ALS_CFG = {"users": 256, "items": 24, "factors": 2, "per_row": 8, "reg": 0.05, "epochs": 2}
ALS_RTOL, ALS_ATOL = 1e-4, 1e-5

LEGS = {  # name: (corpus, layout, learner kwargs); every leg takes model_axis="model"
    "dense_logistic": ("binary", "dense", dict(objective="logistic", learning_rate=0.3,
                                               l2=0.01)),
    "dense_softmax": ("softmax", "dense", dict(objective="softmax", num_class=3,
                                               learning_rate=0.3)),
    "ell_logistic": ("binary", "ell", dict(objective="logistic", learning_rate=0.3)),
    "ell_softmax": ("softmax", "ell", dict(objective="softmax", num_class=3,
                                           learning_rate=0.3)),
}
FM_KW = dict(num_factors=4, learning_rate=0.05, init_scale=0.1, l2=0.01)

# ---------------- corpora (numpy, from seeds) ----------------


def _write(path, lines):
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _binary_corpus(path, n=1400, seed=5):
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=NUM_COL)
    lines = []
    for _ in range(n):
        x = rng.normal(size=NUM_COL)
        y = int(x @ w_true + 0.3 * rng.normal() > 0)
        lines.append(f"{y} " + " ".join(f"{j}:{x[j]:.5f}" for j in range(NUM_COL)
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


# ---------------- what each rank runs ----------------

WORKER = textwrap.dedent(r'''
    import hashlib, json, os, sys
    from datetime import timedelta

    import numpy as np
    import torch

    from dmlc_tpu_torch import (AlsLearner, DMLCError, DeviceIter, FMLearner,
                                LinearLearner, convert, create_parser)
    from dmlc_tpu_torch.parallel import host_shard_info, init_from_env, make_mesh, sync_min
    from dmlc_tpu_torch.parallel.distributed import exit_rank

    cfg = json.load(open(sys.argv[1]))
    init_from_env(device="cpu", timeout=timedelta(seconds=60))
    rank, world = host_shard_info()
    mesh = make_mesh({"data": -1, "model": cfg["model"]}, devices="cpu")
    part, parts = mesh.coords["data"], mesh.shape["data"]
    B, out = cfg["batch"], {"rank": rank, "coords": mesh.coords, "shape": mesh.shape,
                            "legs": {}}
    init = np.load(cfg["init"])

    def digest(arrays):
        return hashlib.sha256(b"".join(np.ascontiguousarray(a).tobytes()
                                       for a in arrays)).hexdigest()

    def local_batches(path):
        parser = create_parser(path, part, parts, "libsvm", threaded=False)
        rows = sum(len(b) for b in parser)
        parser.close()
        return rows // B

    def feed(model, path, layout, max_nnz):
        return DeviceIter(create_parser(path, part, parts, "libsvm", threaded=False),
                          num_col=model.device_num_col(), batch_size=B, layout=layout,
                          max_nnz=max_nnz, mesh=mesh, shardings=model.batch_shardings(),
                          drop_remainder=True)

    def run(model, it, per_epoch, total, epoch_end=None):
        losses = []
        while len(losses) < total:
            for _, b in zip(range(min(per_epoch, total - len(losses))), it):
                losses.append(float(model.step(b)))
            it.reset()
            if epoch_end:
                epoch_end()
        return losses

    # the mesh's collectives: over one axis, over every rank, the gather
    t = torch.tensor([float(rank + 1)])
    out["sum_data"] = float(mesh.all_reduce_(t.clone(), "data")[0])
    out["sum_model"] = float(mesh.all_reduce_(t.clone(), "model")[0])
    out["sum_all"] = float(mesh.all_reduce_(t.clone())[0])
    out["gather_model"] = mesh.all_gather(t, "model").tolist()
    out["gather_data"] = mesh.all_gather(t, "data").tolist()

    for name, (corpus, layout, kw) in cfg["legs"].items():
        c = kw.get("num_class", 1)
        model = LinearLearner(cfg["num_col"], layout=layout, mesh=mesh, model_axis="model", **kw)
        model.set_params(convert.linear_params_from_jax(
            init[f"{corpus}_w{c}"], init[f"{corpus}_b{c}"], mesh=mesh, model_axis="model"))
        it = feed(model, cfg["corpora"][corpus], layout, cfg["num_col"])
        per_epoch = sync_min(local_batches(cfg["corpora"][corpus]))
        first = next(iter(it))
        bytes_first = it.bytes_to_device
        it.reset()
        leg = {"per_epoch": per_epoch, "weight_dim": model.weight_dim,
               "device_num_col": model.device_num_col(),
               "shard": [model.shard_lo, model.shard_width],
               "local_shape": list(model.params.weight.shape),
               "batch_width": list(first[0].shape) if layout == "dense" else None,
               "bytes_first_batch": bytes_first}
        leg["losses"] = run(model, it, per_epoch, cfg["steps"])
        leg["local_sink"] = float(model.params.weight[-1].abs().max())
        leg["accuracy"] = model.accuracy(it, max_steps=per_epoch)
        weight, bias = convert.linear_params_gather_to_jax(model.params, mesh, "model")
        leg["weight"], leg["bias"] = weight.tolist(), bias.tolist()
        leg["bits"] = digest([weight, bias])
        it.close()
        out["legs"][name] = leg

    # FM on the two-axis mesh without a model axis: replicated over it
    fm = FMLearner(cfg["num_col"], layout="ell", mesh=mesh, seed=3, **cfg["fm"])
    fm.set_params(convert.fm_params_from_jax(*(init[f"fm_{k}"] for k in ("w0", "w", "v")),
                                             "cpu"))
    it = feed(fm, cfg["corpora"]["binary"], "ell", cfg["num_col"])
    per_epoch = sync_min(local_batches(cfg["corpora"]["binary"]))
    losses = run(fm, it, per_epoch, cfg["steps"])
    out["fm"] = {"losses": losses, "params": [t.detach().numpy().ravel().tolist()
                                              for t in fm.params],
                 "bits": digest([t.detach().numpy() for t in fm.params])}
    it.close()

    # ALS too: two alternations, then eval_loss
    als = cfg["als"]
    model = AlsLearner(als["users"], als["items"], num_factors=als["factors"], reg=als["reg"],
                       mesh=mesh, device="cpu")
    model.load_state_dict({k: init[f"als_{k}"] for k in ("users", "items", "gram", "rhs")})
    path = cfg["corpora"]["ratings"]
    it = DeviceIter(create_parser(path, part, parts, "libsvm", threaded=False),
                    num_col=model.device_num_col(), batch_size=B, layout="ell",
                    max_nnz=als["per_row"], mesh=mesh, shardings=model.batch_shardings(),
                    drop_remainder=True)
    per_epoch = sync_min(local_batches(path))
    losses = run(model, it, per_epoch, per_epoch * als["epochs"], epoch_end=model.finalize_items)
    state = model.state_dict()
    out["als"] = {"per_epoch": per_epoch, "losses": losses,
                  "eval": model.eval_loss(it, max_steps=per_epoch),
                  "bits": digest([state[k] for k in sorted(state)])}
    if rank == 0:
        np.savez(os.path.join(cfg["out"], "als_state.npz"), **state)
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


def _global_epoch(path, parts, layout, max_nnz, num_col):
    """One epoch of global batches: each data part's JAX DeviceIter
    batches, cut to the smallest part's count, concatenated in data order."""
    per_part = []
    for p in range(parts):
        it = JaxDeviceIter(jax_create_parser(path + "?engine=python", p, parts, "libsvm",
                                             threaded=False),
                           num_col=num_col, batch_size=B, layout=layout, max_nnz=max_nnz,
                           drop_remainder=True, pack_aux=False)
        per_part.append([tuple(np.asarray(a) for a in b) for b in it])
        it.close()
    steps = min(len(p) for p in per_part)
    return [tuple(np.concatenate([p[k][i] for p in per_part])
                  for i in range(len(per_part[0][0]))) for k in range(steps)]


def _jax_batch(arrays, layout, shardings=None):
    if shardings is not None:
        arrays = [jax.device_put(a, sh) for a, sh in zip(arrays, shardings)]
    else:
        arrays = [jnp.asarray(a) for a in arrays]
    return JaxEllBatch(*arrays) if layout == "ell" else tuple(arrays)


def _jax_mesh(data):
    return jax_make_mesh({"data": data, "model": MODEL}, devices=jax.devices()[:data * MODEL])


def _reference(name, corpora, data, init):
    """The JAX learner with ``model_axis="model"`` on the virtual mesh, on
    the global batches: step losses (cycling the epoch as the ranks do),
    the final table and the accuracy pass over one epoch."""
    corpus, layout, kw = LEGS[name]
    model = JaxLinearLearner(NUM_COL, layout=layout, mesh=_jax_mesh(data), model_axis="model",
                             **kw)
    c = kw.get("num_class", 1)
    params_sh = model._shardings()[0]
    model.params = JaxLinearParams(
        jax.device_put(jnp.asarray(init[f"{corpus}_w{c}"]), params_sh.weight),
        jax.device_put(jnp.asarray(init[f"{corpus}_b{c}"]), params_sh.bias))
    model.opt_state = model.opt.init(model.params)
    batches = _global_epoch(corpora[corpus], data, layout, NUM_COL, model.device_num_col())
    placed = [_jax_batch(a, layout, model.batch_shardings()) for a in batches]
    losses = []
    while len(losses) < STEPS:
        for batch in placed[:STEPS - len(losses)]:
            losses.append(float(model.step(batch)))
    return {"losses": losses, "batches": batches, "model": model,
            "accuracy": model.accuracy(_Batches(placed)),
            "weight": np.asarray(model.params.weight), "bias": np.asarray(model.params.bias)}


# ---------------- the spawned groups ----------------


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    d = tmp_path_factory.mktemp("fs_corpora")
    return {"binary": _binary_corpus(d / "binary.libsvm"),
            "softmax": _softmax_corpus(d / "softmax.libsvm"),
            "ratings": _ratings_corpus(d / "ratings.libsvm")}


@pytest.fixture(scope="module")
def init(tmp_path_factory):
    """The initial states, from a numpy seed and the JAX learners' own
    init: the linear tables at JAX's rounded width, the sink at 0."""
    rng = np.random.default_rng(17)
    arrays = {}
    for corpus in ("binary", "softmax"):
        for c in (1, 3):
            shape = (WEIGHT_DIM, c) if c > 1 else (WEIGHT_DIM,)
            w = (0.1 * rng.normal(size=shape)).astype(np.float32)
            w[-1] = 0.0
            arrays[f"{corpus}_w{c}"] = w
            arrays[f"{corpus}_b{c}"] = np.full(shape[1:], 0.05, np.float32)
    fm = JaxFMLearner(NUM_COL, layout="ell", seed=3, **FM_KW)
    for k, p in zip(("w0", "w", "v"), fm.params):
        arrays[f"fm_{k}"] = np.asarray(p)
    als = JaxAlsLearner(ALS_CFG["users"], ALS_CFG["items"], num_factors=ALS_CFG["factors"],
                        reg=ALS_CFG["reg"], seed=0)
    for k, v in als.state_dict().items():
        arrays[f"als_{k}"] = v
    path = tmp_path_factory.mktemp("fs_init") / "init.npz"
    np.savez(path, **arrays)
    return {"path": str(path), **arrays}


@pytest.fixture(scope="module", params=[1, 2], ids=lambda d: f"data{d}_model2")
def group(request, corpora, init, tmp_path_factory):
    """One spawned gloo group a mesh, ``{"data": d, "model": 2}``, runs
    every leg; its ranks' JSON."""
    data = request.param
    world = data * MODEL
    out = tmp_path_factory.mktemp(f"fs_data{data}")
    script = out / "worker.py"
    script.write_text(WORKER)
    cfg = {"batch": B, "steps": STEPS, "num_col": NUM_COL, "model": MODEL,
           "init": init["path"], "corpora": corpora, "out": str(out), "legs": LEGS,
           "fm": FM_KW, "als": ALS_CFG}
    (out / "cfg.json").write_text(json.dumps(cfg))
    run_local([sys.executable, str(script), str(out / "cfg.json")], world, timeout=240)
    ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(world)]
    return {"data": data, "world": world, "ranks": ranks, "out": out}


@pytest.mark.parametrize("name", list(LEGS))
def test_twenty_sharded_steps_match_jax_model_mesh(group, corpora, init, name):
    ref = _reference(name, corpora, group["data"], init)
    legs = [r["legs"][name] for r in group["ranks"]]
    assert all(leg["per_epoch"] == len(ref["batches"]) for leg in legs)
    # the loss is global: every rank reports the same one
    assert all(leg["losses"] == legs[0]["losses"] for leg in legs)
    np.testing.assert_allclose(legs[0]["losses"], ref["losses"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(legs[0]["weight"], ref["weight"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(legs[0]["bias"], ref["bias"], rtol=RTOL, atol=ATOL)
    # every rank gathers the same table, bit for bit
    assert len({leg["bits"] for leg in legs}) == 1
    assert all(leg["accuracy"] == legs[0]["accuracy"] for leg in legs)
    np.testing.assert_allclose(legs[0]["accuracy"], ref["accuracy"], rtol=RTOL)
    assert legs[0]["losses"][-1] < legs[0]["losses"][0]


def test_weight_dim_and_shards_follow_jax(group):
    jmodel = JaxLinearLearner(NUM_COL, layout="dense", mesh=_jax_mesh(group["data"]),
                              model_axis="model")
    jell = JaxLinearLearner(NUM_COL, layout="ell", mesh=_jax_mesh(group["data"]),
                            model_axis="model")
    assert jmodel.weight_dim == WEIGHT_DIM
    width = WEIGHT_DIM // MODEL
    for r in group["ranks"]:
        assert r["shape"] == {"data": group["data"], "model": MODEL}
        assert r["coords"] == {"data": r["rank"] // MODEL, "model": r["rank"] % MODEL}
        for name, (_, layout, kw) in LEGS.items():
            leg = r["legs"][name]
            want_num_col = (jmodel if layout == "dense" else jell).device_num_col()
            assert (leg["weight_dim"], leg["device_num_col"]) == (WEIGHT_DIM, want_num_col)
            assert leg["shard"] == [r["coords"]["model"] * width, width]
            assert leg["local_shape"] == [width] + ([kw["num_class"]] if "num_class" in kw
                                                    else [])


def test_dense_ships_its_column_slice(group):
    """A feature-sharded dense batch is this rank's 5 of the 10 columns,
    cut on the host: every batch copied (the first and those prefetched
    behind it) is ``x``'s slice plus label and weight."""
    for r in group["ranks"]:
        for name, (_, layout, _) in LEGS.items():
            if layout == "dense":
                leg = r["legs"][name]
                assert leg["batch_width"] == [B, WEIGHT_DIM // MODEL]
                per_batch = B * (WEIGHT_DIM // MODEL) * 4 + 2 * B * 4
                assert leg["bytes_first_batch"] > 0
                assert leg["bytes_first_batch"] % per_batch == 0


def test_sink_is_pinned_by_the_last_shard(group):
    for r in group["ranks"]:
        for name in LEGS:
            leg = r["legs"][name]
            assert np.all(np.asarray(leg["weight"])[-1] == 0.0)
            if r["coords"]["model"] == MODEL - 1:
                assert leg["local_sink"] == 0.0


def test_mesh_reduces_over_one_axis(group):
    """Rank r adds r + 1: the data axis sums the ranks of its model
    coordinate, the model axis those of its data coordinate; the gathers
    come in coordinate order."""
    world = group["world"]
    for r in group["ranks"]:
        d, m = r["coords"]["data"], r["coords"]["model"]
        data_ranks = [dd * MODEL + m for dd in range(group["data"])]
        model_ranks = [d * MODEL + mm for mm in range(MODEL)]
        assert r["sum_data"] == sum(x + 1 for x in data_ranks)
        assert r["sum_model"] == sum(x + 1 for x in model_ranks)
        assert r["sum_all"] == world * (world + 1) / 2
        assert r["gather_model"] == [float(x + 1) for x in model_ranks]
        assert r["gather_data"] == [float(x + 1) for x in data_ranks]


def test_fm_replicated_over_the_model_axis(group, corpora, init):
    """FMLearner on the two-axis mesh without a model axis: the JAX
    one-process learner on the global batches."""
    batches = _global_epoch(corpora["binary"], group["data"], "ell", NUM_COL, NUM_COL)
    model = JaxFMLearner(NUM_COL, layout="ell", seed=3, **FM_KW)
    losses = []
    while len(losses) < STEPS:
        losses += [float(model.step(_jax_batch(a, "ell"))) for a in batches[:STEPS - len(losses)]]
    ranks = group["ranks"]
    assert len({r["fm"]["bits"] for r in ranks}) == 1
    np.testing.assert_allclose(ranks[0]["fm"]["losses"], losses, rtol=FM_TOL, atol=FM_TOL)
    for got, want in zip(ranks[0]["fm"]["params"], model.params):
        np.testing.assert_allclose(got, np.asarray(want).ravel(), rtol=FM_TOL, atol=FM_TOL)


def test_als_replicated_over_the_model_axis(group, corpora, init):
    batches = _global_epoch(corpora["ratings"], group["data"], "ell", ALS_CFG["per_row"],
                            ALS_CFG["items"])
    ref = JaxAlsLearner(ALS_CFG["users"], ALS_CFG["items"], num_factors=ALS_CFG["factors"],
                        reg=ALS_CFG["reg"], seed=0)
    ref.load_state_dict({k: init[f"als_{k}"] for k in ("users", "items", "gram", "rhs")})
    losses = []
    for _ in range(ALS_CFG["epochs"]):
        losses += [float(ref.step(_jax_batch(a, "ell"))) for a in batches]
        ref.finalize_items()
    ranks = group["ranks"]
    got = ranks[0]["als"]
    assert got["per_epoch"] == len(batches) and len({r["als"]["bits"] for r in ranks}) == 1
    np.testing.assert_allclose(got["losses"], losses, rtol=ALS_RTOL, atol=ALS_ATOL)
    state = np.load(group["out"] / "als_state.npz")
    for key, want in ref.state_dict().items():
        np.testing.assert_allclose(state[key], want, rtol=ALS_RTOL, atol=ALS_ATOL, err_msg=key)
    want_eval = ref.eval_loss(_Batches([_jax_batch(a, "ell") for a in batches]))
    assert all(r["als"]["eval"] == got["eval"] for r in ranks)
    np.testing.assert_allclose(got["eval"], want_eval, rtol=ALS_RTOL, atol=ALS_ATOL)


# ---------------- in process: the windowed plain versions ----------------

WINDOWS = [  # (B, K, W, lo, width, classes): a shard [lo, lo + width) of a W-word table
    (40, 6, 30, 0, 15, 1),
    (40, 6, 30, 15, 15, 1),
    (33, 7, 101, 40, 30, 1),     # a middle window: ids below and above it
    (40, 6, 30, 15, 15, 3),      # the softmax [W, C] shard: the plain masked gather
    (16, 10, 5000, 2500, 2500, 1),
]


def _window_inputs(b, k, w, classes, seed):
    rng = np.random.default_rng(seed)
    shape = (w, classes) if classes > 1 else (w,)
    table = rng.normal(size=shape).astype(np.float32)
    table[-1] = 0.0
    idx = rng.integers(0, w - 1, size=(b, k)).astype(np.int32)
    val = rng.normal(size=(b, k)).astype(np.float32)
    pad = rng.random(size=(b, k)) < 0.25
    idx[pad], val[pad] = w - 1, 0.0
    g = rng.normal(size=(b, classes) if classes > 1 else (b,)).astype(np.float32)
    return table, idx, val, g


def _masked(table, lo, width):
    out = np.zeros_like(table)
    out[lo:lo + width] = table[lo:lo + width]
    return out


@pytest.mark.parametrize("b,k,w,lo,width,classes", WINDOWS)
def test_windowed_ell_matvec_matches_jax_on_the_sliced_table(b, k, w, lo, width, classes):
    table, idx, val, _ = _window_inputs(b, k, w, classes, seed=lo + w)
    batch = sparse.EllBatch(torch.from_numpy(idx), torch.from_numpy(val), None, None)
    shard = torch.from_numpy(table[lo:lo + width].copy())
    got = ell_matvec_auto(shard, batch, lo=lo).numpy()
    want = np.asarray(jsparse.ell_matvec(jnp.asarray(_masked(table, lo, width)),
                                         JaxEllBatch(jnp.asarray(idx), jnp.asarray(val),
                                                     None, None)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the shards' partials sum to the whole table's margin
    if classes == 1 and lo == 0 and 2 * width == w:
        other = torch.from_numpy(table[width:].copy())
        whole = sparse.ell_matvec(torch.from_numpy(table), batch)
        np.testing.assert_allclose(got + sparse.ell_matvec(other, batch, lo=width).numpy(),
                                   whole.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,k,w,lo,width,classes", [c for c in WINDOWS if c[5] == 1])
def test_windowed_ell_grads_match_jax_grad(b, k, w, lo, width, classes):
    table, idx, val, g = _window_inputs(b, k, w, classes, seed=lo + w + 1)

    def f(tw, tv):
        out = jsparse.ell_matvec(tw, JaxEllBatch(jnp.asarray(idx), tv, None, None))
        return jnp.sum(out * jnp.asarray(g))

    jdw, jdval = jax.grad(f, argnums=(0, 1))(jnp.asarray(_masked(table, lo, width)),
                                             jnp.asarray(val))
    shard = torch.from_numpy(table[lo:lo + width].copy())
    dw, dval = ell_matvec_grads(shard, torch.from_numpy(idx), torch.from_numpy(val),
                                torch.from_numpy(g), lo=lo)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw)[lo:lo + width], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dval.numpy(), np.asarray(jdval), rtol=1e-5, atol=1e-5)
    # autograd through the windowed plain forward gives the same gradients
    tw = shard.clone().requires_grad_()
    tv = torch.from_numpy(val).requires_grad_()
    out = sparse.ell_matvec(tw, sparse.EllBatch(torch.from_numpy(idx), tv, None, None), lo=lo)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tw.grad.numpy(), dw.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tv.grad.numpy(), dval.numpy(), rtol=1e-5, atol=1e-5)


def test_whole_window_keeps_the_unsharded_bits():
    """``lo=0`` over the whole table is the unsharded call: the same bits
    (the kernel on the card takes lo = 0 for an unsharded table too)."""
    table, idx, val, g = _window_inputs(64, 9, 40, 1, seed=3)
    t, i, v, gg = (torch.from_numpy(a) for a in (table, idx, val, g))
    batch = sparse.EllBatch(i, v, None, None)
    assert torch.equal(sparse.ell_matvec(t, batch, lo=0), sparse.ell_matvec(t, batch))
    for a, b in zip(ell_matvec_grads(t, i, v, gg, lo=0), ell_matvec_grads(t, i, v, gg)):
        assert torch.equal(a, b)


def test_mesh_refusals_match_jax():
    mesh = make_mesh(devices="cpu")
    jmesh = jax_make_mesh({"data": 1}, devices=jax.devices()[:1])
    with pytest.raises(DMLCError, match="single-device"):
        LinearLearner(NUM_COL, layout="bcoo", mesh=mesh, model_axis="data")
    with pytest.raises(DMLCError, match="not an axis"):
        LinearLearner(NUM_COL, mesh=mesh, model_axis="model")
    with pytest.raises(KeyError):  # JAX: mesh.shape["model"]
        JaxLinearLearner(NUM_COL, mesh=jmesh, model_axis="model")
    with pytest.raises(DMLCError, match="both"):
        LinearLearner(NUM_COL, mesh=mesh, model_axis="data")
    with pytest.raises(DMLCError, match="not an axis"):
        FMLearner(NUM_COL, mesh=mesh, data_axis="rows")
    # without a mesh the model axis is ignored, as in JAX
    assert LinearLearner(NUM_COL, model_axis="model", device="cpu").weight_dim == NUM_COL + 1
    assert JaxLinearLearner(NUM_COL, model_axis="model").weight_dim == NUM_COL + 1
