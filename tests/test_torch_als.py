"""Parity of the port's AlsLearner with dmlc_tpu.models.AlsLearner.

At ``examples/train_als.py``'s dryrun size (128 users, 24 items, 2
factors, 8 ratings a row, batch 16, reg 0.05), on the CPU
(``device="cpu"``), from one ratings corpus written with
``synthesize``'s recipe from a numpy seed:

- the same corpus through both packages (``create_parser`` ->
  ``DeviceIter(ell)`` -> learner) from the JAX learner's initial state:
  per-step losses, ``users`` and ``items`` over 3 epochs within rtol 1e-4
  / atol 1e-5 (reached: about 1e-7 relative on the losses and 3e-6 on the
  factors; LAPACK's LU on both sides, sums in another order);
- a JAX ``state_dict`` taken mid-training restores into the port and
  continues on the JAX trajectory, and the other way round;
- pad slots are inert (the JAX package's ``test_als_pad_slots_inert``);
- the sink row is ``device_num_col``; ``device=None`` raises without a
  card;
- a mid-epoch checkpoint (``DeviceIter.state_dict`` by a seek of the split
  and ``AlsLearner.state_dict``) restored into fresh objects replays the
  loss tail, the item solve and the next epoch byte for byte;
- host syncs: one per ``fit_epoch``, two per ``eval_loss``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dmlc_tpu_torch.models._loop as loop_mod
from dmlc_tpu.data import create_parser as jax_create_parser
from dmlc_tpu.data.device import DeviceIter as JaxDeviceIter
from dmlc_tpu.models import AlsLearner as JaxAlsLearner
from dmlc_tpu.ops.sparse import EllBatch as JaxEllBatch
from dmlc_tpu_torch import convert
from dmlc_tpu_torch.data import DeviceIter, create_parser
from dmlc_tpu_torch.models import AlsLearner
from dmlc_tpu_torch.ops.sparse import EllBatch
from dmlc_tpu_torch.utils.check import DMLCError

CFG = {"users": 128, "items": 24, "factors": 2, "per_row": 8, "batch": 16, "reg": 0.05}
RTOL, ATOL = 1e-4, 1e-5


def _ratings_corpus(path, num_users, num_items, per_row, rank=4, seed=0):
    """``examples/train_als.py``'s ``synthesize``: low-rank ratings, one
    libsvm row per user, label = user id, features = item:rating."""
    rng = np.random.default_rng(seed)
    gt_u = rng.normal(size=(num_users, rank)).astype(np.float32)
    gt_v = rng.normal(size=(num_items, rank)).astype(np.float32)
    with open(path, "w") as f:
        for uid in range(num_users):
            items = rng.choice(num_items, size=per_row, replace=False)
            ratings = gt_u[uid] @ gt_v[items].T
            feats = " ".join(f"{j}:{r:.6f}" for j, r in zip(items, ratings))
            f.write(f"{uid} {feats}\n")


@pytest.fixture
def corpus(tmp_path):
    path = str(tmp_path / "ratings.libsvm")
    _ratings_corpus(path, CFG["users"], CFG["items"], CFG["per_row"])
    return path


def _learners():
    jax = JaxAlsLearner(CFG["users"], CFG["items"], num_factors=CFG["factors"],
                        reg=CFG["reg"], seed=0)
    port = AlsLearner(CFG["users"], CFG["items"], num_factors=CFG["factors"],
                      reg=CFG["reg"], seed=0, device="cpu")
    port.load_state_dict(convert.als_state_from_jax(jax.state_dict()))
    return jax, port


def _port_iter(path, chunk_bytes=1 << 20):
    # the reference's positional call: (uri, part, nparts, type_, threaded=False)
    parser = create_parser(path, 0, 1, "libsvm", threaded=False, chunk_bytes=chunk_bytes)
    return DeviceIter(parser, num_col=CFG["items"], batch_size=CFG["batch"], layout="ell",
                      max_nnz=CFG["per_row"], drop_remainder=True, device="cpu")


def _jax_iter(path):
    parser = jax_create_parser(path, 0, 1, "libsvm", threaded=False)
    return JaxDeviceIter(parser, num_col=CFG["items"], batch_size=CFG["batch"], layout="ell",
                         max_nnz=CFG["per_row"], drop_remainder=True)


def _assert_state_close(port, jax):
    for key, want in jax.state_dict().items():
        np.testing.assert_allclose(port.state_dict()[key], want, rtol=RTOL, atol=ATOL,
                                   err_msg=key)


def test_three_epochs_match_reference(corpus):
    jax, port = _learners()
    jit, pit = _jax_iter(corpus), _port_iter(corpus)
    first = None
    for _ in range(3):
        got, want = [], []
        for jb, pb in zip(jit, pit):
            want.append(float(jax.step(jb)))
            got.append(float(port.step(pb)))
        jit.reset()
        pit.reset()
        jax.finalize_items()
        port.finalize_items()
        assert len(got) == CFG["users"] // CFG["batch"]
        first = got[0] if first is None else first
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        _assert_state_close(port, jax)
    assert got[-1] < 0.5 * first  # the alternation converged
    assert not port.params.items[-1].any()
    np.testing.assert_allclose(port.eval_loss(pit), jax.eval_loss(jit), rtol=RTOL, atol=ATOL)
    jit.close()
    pit.close()


def _batches(path):
    it = _jax_iter(path)
    out = [tuple(np.array(a) for a in b) for b in it]
    it.close()
    return out


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_state_crosses_mid_training(corpus, direction):
    """Train one package an epoch and three steps, carry its state over,
    and continue both on the same batches: the trajectories agree."""
    batches = _batches(corpus)
    jax, port = _learners()
    src = jax if direction == "jax_to_port" else port
    for arrays in batches + batches[:3]:
        if src is jax:
            jax.step(JaxEllBatch(*(jnp.asarray(a) for a in arrays)))
        else:
            port.step(EllBatch(*(torch.from_numpy(a) for a in arrays)))
        if arrays is batches[-1]:
            src.finalize_items()
    if direction == "jax_to_port":
        port.load_state_dict(convert.als_state_from_jax(jax.state_dict()))
    else:
        jax.load_state_dict({k: jnp.asarray(v) for k, v in
                             convert.als_state_to_jax(port.state_dict()).items()})
    _assert_state_close(port, jax)
    got, want = [], []
    for arrays in batches[3:] + batches:
        want.append(float(jax.step(JaxEllBatch(*(jnp.asarray(a) for a in arrays)))))
        got.append(float(port.step(EllBatch(*(torch.from_numpy(a) for a in arrays)))))
        if arrays is batches[-1]:
            jax.finalize_items()
            port.finalize_items()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    _assert_state_close(port, jax)


def test_reference_state_dict_loads_unchanged():
    jax = JaxAlsLearner(16, 10, num_factors=3, seed=4)
    port = AlsLearner(16, 10, num_factors=3, seed=9, device="cpu")
    port.load_state_dict(jax.state_dict())
    for key, want in jax.state_dict().items():
        np.testing.assert_array_equal(port.state_dict()[key], want)
    back = convert.als_state_to_jax(port.state_dict())
    assert sorted(back) == ["gram", "items", "rhs", "users"]
    assert all(v.dtype == np.float32 for v in back.values())
    with pytest.raises(DMLCError, match="lacks"):
        convert.als_state_from_jax({"users": back["users"]})
    with pytest.raises(DMLCError, match="items"):
        AlsLearner(16, 11, num_factors=3, device="cpu").load_state_dict(back)


def _lowrank_batch(num_users=8, num_items=16, rank=3, per_row=12, seed=0):
    rng = np.random.default_rng(seed)
    gt_u = rng.normal(size=(num_users, rank)).astype(np.float32)
    gt_v = rng.normal(size=(num_items, rank)).astype(np.float32)
    idx = np.stack([rng.choice(num_items, size=per_row, replace=False)
                    for _ in range(num_users)]).astype(np.int32)
    vals = np.einsum("bf,bkf->bk", gt_u, gt_v[idx]).astype(np.float32)
    return idx, vals, np.arange(num_users, dtype=np.float32), np.ones(num_users, np.float32)


def test_pad_slots_inert():
    """Widening every row with pad slots (index = num_items, rating 0)
    leaves the model as it was (allclose: the sums run over a wider K)."""
    idx, vals, label, weight = _lowrank_batch()
    num_items = 16
    pad_idx = np.concatenate([idx, np.full((8, 4), num_items, np.int32)], axis=1)
    pad_vals = np.concatenate([vals, np.zeros((8, 4), np.float32)], axis=1)
    models = [AlsLearner(8, num_items, num_factors=3, reg=1e-3, seed=0, device="cpu")
              for _ in range(2)]
    l1 = float(models[0].step(EllBatch(*map(torch.from_numpy, (idx, vals, label, weight)))))
    l2 = float(models[1].step(EllBatch(*map(torch.from_numpy,
                                            (pad_idx, pad_vals, label, weight)))))
    np.testing.assert_allclose(l1, l2, rtol=1e-5)
    np.testing.assert_allclose(models[0].params.users.numpy(), models[1].params.users.numpy(),
                               rtol=1e-4, atol=1e-5)
    for m in models:
        m.finalize_items()
        assert not m.params.items[-1].any()
    np.testing.assert_allclose(models[0].params.items.numpy(), models[1].params.items.numpy(),
                               rtol=1e-3, atol=1e-4)


def test_sink_row_is_device_num_col():
    model = AlsLearner(16, 10, num_factors=2, device="cpu")
    assert model.device_num_col() == 10
    assert tuple(model.params.items.shape) == (11, 2)
    assert not model.params.items[-1].any() and model.params.items[:-1].abs().sum() > 0
    with pytest.raises(DMLCError):
        AlsLearner(0, 10, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(DMLCError, match="CUDA"):
            AlsLearner(16, 10)


def test_checkpoint_mid_epoch_replays_bytes(corpus):
    """Run A trains an epoch, then steps the next one and checkpoints
    after 3 batches (the split's seek state, through the learner's numpy
    state); run B restores both into fresh objects and replays the tail,
    the item solve from the restored normal equations and the epoch after
    it: the float32 loss stream and the final state match byte for byte."""
    restore_at = 3

    def build():
        model = AlsLearner(CFG["users"], CFG["items"], num_factors=CFG["factors"],
                           reg=CFG["reg"], seed=0, device="cpu")
        return model, _port_iter(corpus, chunk_bytes=1 << 10)

    def rest_and_next_epoch(model, it, losses):
        losses += [np.float32(loop_mod.host_scalar(model.step(b))) for b in it]
        model.finalize_items()
        it.reset()
        losses += [np.float32(loop_mod.host_scalar(model.step(b))) for b in it]
        it.close()
        return np.asarray(losses), model.state_dict()

    model, it = build()
    model.fit_epoch(it)
    losses_a, ckpt = [], None
    for batch in it:
        losses_a.append(np.float32(loop_mod.host_scalar(model.step(batch))))
        if len(losses_a) == restore_at:
            ckpt = (model.state_dict(), it.state_dict())
            break
    losses_a, state_a = rest_and_next_epoch(model, it, losses_a)
    assert len(losses_a) == 2 * (CFG["users"] // CFG["batch"])
    assert ckpt[1]["kind"] == "source", ckpt[1]

    model2, it2 = build()
    model2.load_state_dict(ckpt[0])
    it2.load_state(ckpt[1])
    losses_b, state_b = rest_and_next_epoch(model2, it2, [])
    tail = losses_a[restore_at:]
    assert tail.tobytes() == losses_b.tobytes(), (tail, losses_b)
    for key in state_a:
        assert state_a[key].tobytes() == state_b[key].tobytes(), key


class _SyncCounter:
    def __init__(self):
        self.calls = 0

    def __call__(self, x):
        self.calls += 1
        return float(x.item())


def test_host_syncs(corpus, monkeypatch):
    _, model = _learners()
    it = _port_iter(corpus)
    counter = _SyncCounter()
    monkeypatch.setattr(loop_mod, "host_scalar", counter)
    loss, n = model.fit_epoch(it)
    assert n == 8 and np.isfinite(loss) and counter.calls == 1
    counter.calls = 0
    model.finalize_items()
    assert counter.calls == 0
    mse = model.eval_loss(it, max_steps=3)
    assert np.isfinite(mse) and counter.calls == 2
    it.close()
