"""Parity of the port's DeviceIter with dmlc_tpu.data.device.DeviceIter.

For the ``ell`` and ``dense`` layouts, with the epoch's tail padded
(``drop_remainder=False``) or dropped (``True``), every batch of two epochs
(with ``reset`` between them) is byte-equal to ``np.asarray`` of the JAX
pipeline's batch. The port runs on ``device="cpu"`` here.
"""

import numpy as np
import pytest

from dmlc_tpu.data import create_parser as jax_create_parser
from dmlc_tpu.data.device import DeviceIter as JaxDeviceIter
from dmlc_tpu_torch import DMLCError
from dmlc_tpu_torch.data import DeviceIter, create_parser

NUM_COL, BATCH, MAX_NNZ = 24, 64, 5


def _corpus(tmp_path, n=300):
    rng = np.random.default_rng(3)
    lines = []
    for i in range(n):
        # rows of 0..8 features: some longer than MAX_NNZ (truncated in ell)
        k = int(rng.integers(0, 9))
        idx = np.sort(rng.choice(NUM_COL, size=k, replace=False))
        lines.append(f"{i % 2}:{0.5 + i % 4} " + " ".join(
            f"{j}:{rng.normal():.5f}" for j in idx))
    path = tmp_path / "iter.libsvm"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _epochs(it, epochs=2):
    out = []
    for _ in range(epochs):
        out.append([[np.asarray(a) for a in batch] for batch in it])
        it.reset()
    it.close()
    return out


@pytest.mark.parametrize("layout", ["ell", "dense"])
@pytest.mark.parametrize("drop_remainder", [False, True])
def test_batches_byte_equal_to_reference(tmp_path, layout, drop_remainder):
    uri = _corpus(tmp_path)
    kw = dict(num_col=NUM_COL, batch_size=BATCH, layout=layout,
              max_nnz=MAX_NNZ, drop_remainder=drop_remainder)
    got = _epochs(DeviceIter(create_parser(uri, 0, 1, "libsvm"), device="cpu", **kw))
    want = _epochs(JaxDeviceIter(jax_create_parser(uri, 0, 1, "libsvm"), **kw))
    assert len(got[0]) == (4 if drop_remainder else 5)
    assert len(got) == len(want) == 2
    for ge, we in zip(got, want):
        assert len(ge) == len(we)
        for gb, wb in zip(ge, we):
            assert len(gb) == len(wb)
            for g, w in zip(gb, wb):
                assert g.dtype == w.dtype and g.shape == w.shape
                assert g.tobytes() == w.tobytes()


def test_stats_and_counters(tmp_path):
    uri = _corpus(tmp_path)
    it = DeviceIter(create_parser(uri, 0, 1, "libsvm"), num_col=NUM_COL,
                    batch_size=BATCH, layout="ell", max_nnz=MAX_NNZ, device="cpu")
    n = sum(1 for _ in it)
    stats = it.stats()
    assert n == 5 and stats["batches_fed"] == 5
    # int32 indices + float32 values [B, K], float32 label + weight [B]
    assert stats["bytes_to_device"] == 5 * (BATCH * MAX_NNZ * 8 + BATCH * 8)
    assert stats["stall_seconds"] >= 0.0
    it.reset()
    assert it.stats()["batches_fed"] == 0
    # a mid-epoch reset restarts the source: the next epoch is whole
    next(it)
    it.reset()
    assert sum(1 for _ in it) == 5
    it.close()


def test_ell_rejects_feature_beyond_num_col(tmp_path):
    path = tmp_path / "wide.libsvm"
    path.write_text("1 0:1 30:2\n")
    it = DeviceIter(create_parser(str(path), 0, 1, "libsvm"), num_col=NUM_COL,
                    batch_size=4, layout="ell", max_nnz=MAX_NNZ, device="cpu")
    with pytest.raises(DMLCError, match="num_col"):
        next(it)
    it.close()


def test_c8_ell_without_max_nnz_trains_as_the_reference(tmp_path):
    """Fault C8: ``layout="ell"`` without ``max_nnz`` takes K from each
    batch's longest row, as the JAX package does (``block_to_ell(max_nnz=
    None)``), and trains a 4-row file to its epoch losses; the batches
    equal JAX's byte for byte, and K varies between them."""
    import torch

    from dmlc_tpu.models.linear import LinearLearner as JaxLinearLearner
    from dmlc_tpu_torch import convert
    from dmlc_tpu_torch.models import LinearLearner

    path = tmp_path / "c8.libsvm"
    path.write_text("1 0:1 1:1 2:1\n0 3:1\n1 0:1 2:1 3:0.5\n0 1:1 3:1\n")
    kw = dict(num_col=4, batch_size=2, layout="ell")
    got = _epochs(DeviceIter(create_parser(str(path)), device="cpu", **kw), epochs=1)[0]
    want = _epochs(JaxDeviceIter(jax_create_parser(str(path)), **kw), epochs=1)[0]
    assert [b[0].shape for b in got] == [(2, 3), (2, 3)]
    for gb, wb in zip(got, want):
        for g, w in zip(gb, wb):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    path2 = tmp_path / "c8b.libsvm"
    path2.write_text("1 0:1 1:1 2:1\n0 3:1\n1 2:1\n0 1:1\n")
    ks = [b[0].shape[1] for b in
          _epochs(DeviceIter(create_parser(str(path2)), device="cpu", **kw), epochs=1)[0]]
    assert ks == [3, 1]
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        losses = {}
        for name, uri in (("4rows", str(path)), ("ragged", str(path2))):
            jax = JaxLinearLearner(4, layout="ell", learning_rate=0.5)
            port = LinearLearner(4, layout="ell", learning_rate=0.5, device="cpu")
            port.set_params(convert.linear_params_from_jax(
                *(np.asarray(p) for p in jax.params), device="cpu"))
            jl, pl = [], []
            jax.fit(JaxDeviceIter(jax_create_parser(uri), **kw), epochs=2,
                    log_fn=lambda e, loss, nb, s: jl.append(float(loss)))
            port.fit(DeviceIter(create_parser(uri), device="cpu", **kw), epochs=2,
                     log_fn=lambda e, loss, nb, s: pl.append(float(loss)))
            np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=1e-6)
            losses[name] = pl
    finally:
        torch.use_deterministic_algorithms(prev)
    assert losses["4rows"][1] < losses["4rows"][0] < np.log(2)
    # a snapshot still needs one [B, K] shape
    with pytest.raises(DMLCError, match="max_nnz"):
        DeviceIter(create_parser(str(path), snapshot=str(tmp_path / "s")), device="cpu",
                   **kw)
