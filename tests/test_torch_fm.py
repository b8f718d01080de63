"""Parity of the port's FMLearner with dmlc_tpu.models.fm.FMLearner.

On the CPU (``device="cpu"``):

- for each layout (dense, ell, bcoo; logistic, and squared with l2 on
  ell), the same corpus through both packages' ``create_parser`` ->
  ``DeviceIter``, 20 Adam steps from the JAX learner's initial parameters
  (carried over by ``convert.fm_params_from_jax``): per-step losses and
  the parameters within 1e-5; the padding sink stays exactly 0;
- the XOR corpus of the JAX package's ``test_fm_learns_interactions``
  trains to accuracy above 0.9 on each layout (a linear model cannot);
- ``optimizer=`` takes a factory, the parameters round-trip through
  ``convert``, and ``device=None`` raises without a card.

The libfm-format case (``tests/test_device.py``'s
``test_fm_libfm_format_end_to_end``) is in ``tests/test_torch_format_train.py``.
"""

import numpy as np
import pytest
import torch

from dmlc_tpu.data import create_parser as jax_create_parser
from dmlc_tpu.data.device import DeviceIter as JaxDeviceIter
from dmlc_tpu.models.fm import FMLearner as JaxFMLearner
from dmlc_tpu_torch import convert
from dmlc_tpu_torch.data import DeviceIter, create_parser
from dmlc_tpu_torch.models import FMLearner
from dmlc_tpu_torch.utils.check import DMLCError

TOL = 1e-5
NUM_COL = 10
ITER_KW = dict(batch_size=32, max_nnz=NUM_COL, drop_remainder=True, nnz_bucket=512,
               row_bucket=32)


def _corpus(tmp_path, n=320, d=NUM_COL):
    """Sparse rows whose label follows a pairwise interaction."""
    rng = np.random.default_rng(7)
    lines = []
    for _ in range(n):
        cols = np.sort(rng.choice(d, size=rng.integers(2, d), replace=False))
        x = rng.normal(size=len(cols))
        y = int(x[0] * x[-1] + 0.3 * x.sum() > 0)
        lines.append(f"{y} " + " ".join(f"{j}:{v:.5f}" for j, v in zip(cols, x)))
    path = tmp_path / "fm.libsvm"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _iters(uri, layout, num_col):
    port = DeviceIter(create_parser(uri, 0, 1, "libsvm", threaded=False), num_col=num_col,
                      layout=layout, device="cpu", **ITER_KW)
    jax = JaxDeviceIter(jax_create_parser(uri + "?engine=python", 0, 1, "libsvm",
                                          threaded=False),
                        num_col=num_col, layout=layout, **ITER_KW)
    return port, jax


@pytest.mark.parametrize("layout,objective,l2", [
    ("dense", "logistic", 0.0),
    ("ell", "logistic", 0.0),
    ("bcoo", "logistic", 0.0),
    ("ell", "squared", 0.01),
])
def test_twenty_adam_steps_match_reference(tmp_path, layout, objective, l2):
    uri = _corpus(tmp_path)
    kw = dict(num_factors=4, objective=objective, layout=layout, learning_rate=0.05,
              init_scale=0.1, l2=l2)
    jax = JaxFMLearner(NUM_COL, seed=3, **kw)
    port = FMLearner(NUM_COL, device="cpu", **kw)
    assert port.weight_dim == jax.weight_dim and port.device_num_col() == jax.device_num_col()
    port.set_params(convert.fm_params_from_jax(*(np.asarray(p) for p in jax.params), "cpu"))
    port_it, jax_it = _iters(uri, layout, port.device_num_col())
    got, want = [], []
    while len(got) < 20:
        for pb, jb in zip(port_it, jax_it):
            want.append(float(jax.step(jb)))
            got.append(float(port.step(pb)))
            if len(got) == 20:
                break
        port_it.reset()
        jax_it.reset()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    for name, p, j in zip(("w0", "w", "v"), convert.fm_params_to_jax(port.params), jax.params):
        np.testing.assert_allclose(p, np.asarray(j), rtol=TOL, atol=TOL, err_msg=name)
    w, v = port.params.w.detach(), port.params.v.detach()
    if layout == "bcoo":
        assert w[-1] != 0  # no sink: the last feature trains
    else:
        assert not w[-1].any() and not v[-1].any()
    assert got[-1] < got[0]
    port_it.close()
    jax_it.close()


def _xor_corpus(tmp_path, n=512):
    """``tests/test_device.py``'s XOR corpus: the label is x0 XOR x1, which
    only the second-order term can express."""
    rng = np.random.default_rng(3)
    lines = []
    for _ in range(n):
        a, b = int(rng.integers(0, 2)), int(rng.integers(0, 2))
        noise = " ".join(f"{j}:{rng.normal() * 0.01:.5f}" for j in range(2, 6))
        lines.append(f"{a ^ b} 0:{2 * a - 1} 1:{2 * b - 1} {noise}")
    path = tmp_path / "xor.libsvm"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("layout", ["dense", "ell", "bcoo"])
def test_learns_xor(tmp_path, layout):
    uri = _xor_corpus(tmp_path)
    model = FMLearner(num_col=6, num_factors=4, layout=layout, learning_rate=0.1, seed=1,
                      device="cpu")
    it = DeviceIter(create_parser(uri, 0, 1, "libsvm", threaded=False),
                    num_col=model.device_num_col(), batch_size=64, layout=layout, max_nnz=6,
                    drop_remainder=True, nnz_bucket=256, row_bucket=32, device="cpu")
    model.fit(it, epochs=40)
    acc = model.accuracy(it)
    it.close()
    assert acc > 0.9, f"layout={layout} acc={acc}"


def test_optimizer_factory_and_params_round_trip():
    model = FMLearner(NUM_COL, layout="ell", device="cpu",
                      optimizer=lambda params: torch.optim.SGD(params, lr=0.2))
    assert isinstance(model.opt, torch.optim.SGD) and model.opt.defaults["lr"] == 0.2
    assert isinstance(FMLearner(NUM_COL, device="cpu").opt, torch.optim.Adam)
    rng = np.random.default_rng(0)
    arrays = (np.float32(0.5), rng.normal(size=NUM_COL + 1).astype(np.float32),
              rng.normal(size=(NUM_COL + 1, 8)).astype(np.float32))
    model.set_params(convert.fm_params_from_jax(*arrays, device="cpu"))
    for got, want in zip(convert.fm_params_to_jax(model.params), arrays):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(DMLCError):
        FMLearner(NUM_COL, layout="csr", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(DMLCError, match="CUDA"):
            FMLearner(NUM_COL)
