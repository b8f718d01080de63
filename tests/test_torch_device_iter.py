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
