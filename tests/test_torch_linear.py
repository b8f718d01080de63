"""Parity of the port's LinearLearner with dmlc_tpu.models.LinearLearner.

- From one initial state (carried over with ``dmlc_tpu_torch.convert``) and
  on the same 20 batches, the per-step losses of logistic-ell,
  logistic-dense (with l2), squared-ell and softmax-ell agree within 1e-5,
  and so do the trained parameters; the padding sink stays exactly 0.
- The loop's host syncs: one per ``fit_epoch``, two per ``accuracy``.
- The whole slice, libsvm file -> create_parser -> DeviceIter(ell) ->
  fit(2) -> accuracy, gives the same epoch losses and accuracy within 1e-5
  in both packages.
- A bfloat16 dense batch gives the reference's losses (rtol 1e-5) over
  three steps: the margin widens ``x`` to float32 first.
- ``init_params`` gives the JAX package's zero shapes, and ``loss_fn`` at
  the initial and the trained parameters gives JAX's loss and gradient
  (``jax.grad`` of its ``loss_fn``) within 1e-5; the value a step returns
  is ``loss_fn`` at the parameters before it, bit for bit.

The port runs on ``device="cpu"`` here, where the ell margin takes the
plain gather (kernel K1 runs on the card only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dmlc_tpu_torch.models._loop as loop_mod
from dmlc_tpu.data import create_parser as jax_create_parser
from dmlc_tpu.data.device import DeviceIter as JaxDeviceIter
from dmlc_tpu.models import LinearLearner as JaxLinearLearner
from dmlc_tpu.models.linear import LinearParams as JaxLinearParams
from dmlc_tpu.models.linear import init_params as jax_init_params
from dmlc_tpu.ops.sparse import EllBatch as JaxEllBatch
from dmlc_tpu_torch import convert
from dmlc_tpu_torch.data import DeviceIter, create_parser
from dmlc_tpu_torch.models import LinearLearner
from dmlc_tpu_torch.models.linear import init_params
from dmlc_tpu_torch.ops.sparse import EllBatch

TOL = 1e-5
NUM_COL, B, K = 12, 32, 6


def _batches(rng, layout, objective, steps=20):
    """Host batches as numpy arrays; ELL pad slots carry the sink index."""
    out = []
    for _ in range(steps):
        if objective == "softmax":
            label = rng.integers(0, 3, size=B).astype(np.float32)
        elif objective == "logistic":
            label = rng.integers(0, 2, size=B).astype(np.float32)
        else:
            label = rng.normal(size=B).astype(np.float32)
        weight = rng.uniform(0.5, 1.5, size=B).astype(np.float32)
        weight[-3:] = 0.0  # zero-weight pad rows
        if layout == "ell":
            idx = rng.integers(0, NUM_COL, size=(B, K)).astype(np.int32)
            val = rng.normal(size=(B, K)).astype(np.float32)
            pad = rng.random(size=(B, K)) < 0.3
            idx[pad], val[pad] = NUM_COL, 0.0
            out.append((idx, val, label, weight))
        else:
            x = rng.normal(size=(B, NUM_COL + 1)).astype(np.float32)
            x[:, -1] = 0.0
            out.append((x, label, weight))
    return out


@pytest.mark.parametrize("layout,objective,l2,num_class", [
    ("ell", "logistic", 0.0, 1),
    ("dense", "logistic", 0.01, 1),
    ("ell", "squared", 0.0, 1),
    ("ell", "softmax", 0.0, 3),
])
def test_twenty_step_trajectory_matches_reference(layout, objective, l2, num_class):
    rng = np.random.default_rng(11)
    shape = (NUM_COL + 1, num_class) if num_class > 1 else (NUM_COL + 1,)
    w0 = (0.1 * rng.normal(size=shape)).astype(np.float32)
    w0[-1] = 0.0
    b0 = np.full(shape[1:], 0.05, np.float32)
    kw = dict(objective=objective, layout=layout, learning_rate=0.3, l2=l2,
              num_class=num_class)
    ref = JaxLinearLearner(NUM_COL, **kw)
    ref.params = JaxLinearParams(jnp.asarray(w0), jnp.asarray(b0))
    ref.opt_state = ref.opt.init(ref.params)
    port = LinearLearner(NUM_COL, device="cpu", **kw)
    port.set_params(convert.linear_params_from_jax(w0, b0, "cpu"))
    got, want = [], []
    for arrays in _batches(rng, layout, objective):
        if layout == "ell":
            jb = JaxEllBatch(*(jnp.asarray(a) for a in arrays))
            tb = EllBatch(*(torch.from_numpy(a) for a in arrays))
        else:
            jb = tuple(jnp.asarray(a) for a in arrays)
            tb = tuple(torch.from_numpy(a) for a in arrays)
        want.append(float(ref.step(jb)))
        got.append(float(port.step(tb)))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    w, b = convert.linear_params_to_jax(port.params)
    np.testing.assert_allclose(w, np.asarray(ref.params.weight), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(b, np.asarray(ref.params.bias), rtol=TOL, atol=TOL)
    # the padding sink stays exactly zero
    assert not w[-1].any()


def _corpus(tmp_path, n=640, d=NUM_COL):
    rng = np.random.default_rng(5)
    w_true = rng.normal(size=d)
    lines = []
    for _ in range(n):
        x = rng.normal(size=d)
        feats = " ".join(f"{j}:{x[j]:.5f}" for j in range(d) if abs(x[j]) > 0.3)
        lines.append(f"{int(x @ w_true > 0)} {feats}")
    path = tmp_path / "slice.libsvm"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


class _SyncCounter:
    def __init__(self):
        self.calls = 0

    def __call__(self, x):
        self.calls += 1
        return float(x.item())


def test_host_syncs_per_epoch_and_accuracy(tmp_path, monkeypatch):
    uri = _corpus(tmp_path)
    model = LinearLearner(NUM_COL, layout="ell", learning_rate=0.3, device="cpu")
    it = DeviceIter(create_parser(uri, 0, 1, "libsvm"), num_col=model.device_num_col(),
                    batch_size=64, layout="ell", max_nnz=NUM_COL, device="cpu")
    counter = _SyncCounter()
    monkeypatch.setattr(loop_mod, "host_scalar", counter)
    loss, n = model.fit_epoch(it)
    assert n == 10 and np.isfinite(loss)
    assert counter.calls == 1
    # a step returns a device tensor, never a host float
    assert isinstance(model.step(next(iter(it))), torch.Tensor)
    it.reset()
    counter.calls = 0
    acc = model.accuracy(it)
    assert 0.0 <= acc <= 1.0 and counter.calls == 2
    it.close()


def test_whole_slice_matches_reference(tmp_path):
    uri = _corpus(tmp_path)
    results = []
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            model = JaxLinearLearner(NUM_COL, layout="ell", learning_rate=0.3)
            it = JaxDeviceIter(jax_create_parser(uri, 0, 1, "libsvm"),
                               num_col=model.device_num_col(), batch_size=64,
                               layout="ell", max_nnz=NUM_COL)
        else:
            model = LinearLearner(NUM_COL, layout="ell", learning_rate=0.3, device="cpu")
            it = DeviceIter(create_parser(uri, 0, 1, "libsvm"),
                            num_col=model.device_num_col(), batch_size=64,
                            layout="ell", max_nnz=NUM_COL, device="cpu")
        losses = []
        model.fit(it, epochs=2, log_fn=lambda e, loss, nb, s: losses.append((loss, nb)))
        results.append((losses, model.accuracy(it)))
        it.close()
    (jl, jacc), (tl, tacc) = results
    assert [nb for _, nb in tl] == [nb for _, nb in jl] == [10, 10]
    np.testing.assert_allclose([x for x, _ in tl], [x for x, _ in jl], rtol=TOL, atol=TOL)
    assert abs(tacc - jacc) <= TOL and tacc > 0.8


def test_bf16_dense_margin_matches_reference():
    """A bfloat16 dense batch (as DeviceIter(x_dtype='bfloat16') ships it)
    widens to float32 before the margin, as JAX's type promotion does:
    three steps on the same batch give the reference's losses."""
    import ml_dtypes

    rng = np.random.default_rng(13)
    x = rng.normal(size=(B, NUM_COL + 1)).astype(np.float32)
    x[:, -1] = 0.0
    x16 = x.astype(ml_dtypes.bfloat16)
    label = rng.integers(0, 2, size=B).astype(np.float32)
    weight = np.ones(B, np.float32)
    ref = JaxLinearLearner(NUM_COL, layout="dense", learning_rate=0.3)
    port = LinearLearner(NUM_COL, layout="dense", learning_rate=0.3, device="cpu")
    jb = (jnp.asarray(x16), jnp.asarray(label), jnp.asarray(weight))
    tb = (torch.from_numpy(x16.view(np.int16)).view(torch.bfloat16),
          torch.from_numpy(label), torch.from_numpy(weight))
    want = [float(ref.step(jb)) for _ in range(3)]
    got = [float(port.step(tb)) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=TOL)
    assert got[0] != got[2]  # the steps moved the weights


@pytest.mark.parametrize("num_class", [1, 3])
def test_init_params_match_reference(num_class):
    got = init_params(NUM_COL + 1, num_class, device="cpu")
    want = jax_init_params(NUM_COL + 1, num_class)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        assert not g.any() and g.device.type == "cpu"
    assert init_params(4, dtype=torch.float64, device="cpu").weight.dtype == torch.float64


@pytest.mark.parametrize("layout,objective,l2,num_class", [
    ("ell", "logistic", 0.0, 1),
    ("dense", "logistic", 0.01, 1),
    ("ell", "softmax", 0.02, 3),
])
def test_loss_fn_matches_reference_and_the_step(layout, objective, l2, num_class):
    rng = np.random.default_rng(17)
    kw = dict(objective=objective, layout=layout, learning_rate=0.3, l2=l2,
              num_class=num_class)
    ref = JaxLinearLearner(NUM_COL, **kw)
    port = LinearLearner(NUM_COL, device="cpu", **kw)
    start = init_params(NUM_COL + 1, num_class, device="cpu")
    start = type(start)(start.weight + 0.05, start.bias)  # off zero, sink aside
    start.weight[-1] = 0.0
    port.set_params(start)
    ref.params = JaxLinearParams(*(jnp.asarray(t.numpy()) for t in start))
    ref.opt_state = ref.opt.init(ref.params)

    def pair(arrays):
        if layout == "ell":
            return (EllBatch(*(torch.from_numpy(a) for a in arrays)),
                    JaxEllBatch(*(jnp.asarray(a) for a in arrays)))
        return tuple(torch.from_numpy(a) for a in arrays), tuple(jnp.asarray(a) for a in arrays)

    def check(tb, jb):
        params = type(port.params)(*(t.detach().clone().requires_grad_(True)
                                     for t in port.params))
        loss = port.loss_fn(params, tb)
        loss.backward()
        jloss, jgrad = jax.value_and_grad(ref.loss_fn)(ref.params, jb)
        np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=TOL, atol=TOL)
        for g, w in zip(params, jgrad):
            np.testing.assert_allclose(g.grad.numpy(), np.asarray(w), rtol=TOL, atol=TOL)
        return loss.detach()

    batches = [pair(a) for a in _batches(rng, layout, objective, steps=10)]
    for tb, jb in batches:
        before = check(tb, jb)
        stepped = port.step(tb)
        ref.step(jb)
        assert stepped.dtype == before.dtype and bool(stepped == before)
    check(*batches[0])  # at the trained parameters
