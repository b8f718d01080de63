"""The port's row blocks against the JAX package's ``data/row_block.py``.

- ``RowBlock.to_dense`` gives JAX's float32 array (binary features, ids at
  or past ``num_col``, the width from the block or given);
- ``RowBlockContainer(index_dtype=)`` builds JAX's block from the same
  pushes (blocks and rows, optional arrays on some parts only), with its
  ``max_index``, and keeps the dtype across ``clear``;
- ``RowBlockContainer.save`` / ``load``: files written by either package
  load in the other to equal blocks, several records to a stream.
"""

import io

import numpy as np
import pytest

from dmlc_tpu.data.row_block import RowBlock as JaxRowBlock
from dmlc_tpu.data.row_block import RowBlockContainer as JaxRowBlockContainer
from dmlc_tpu_torch.data.row_block import RowBlock, RowBlockContainer

FIELDS = ("offset", "label", "index", "value", "weight", "qid", "field")


def _parts(seed=0, dtype=np.uint64):
    """Block arrays with optional arrays present on some parts only."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(4):
        n = int(rng.integers(1, 6))
        lens = rng.integers(0, 4, size=n)
        nnz = int(lens.sum())
        out.append(dict(
            offset=np.concatenate([[0], np.cumsum(lens)]).astype(np.int64),
            label=rng.integers(0, 2, size=n).astype(np.float32),
            index=rng.integers(0, 40, size=nnz).astype(dtype),
            value=rng.normal(size=nnz).astype(np.float32) if i != 1 else None,
            weight=rng.random(size=n).astype(np.float32) if i == 2 else None,
            qid=np.arange(n, dtype=np.int64) if i % 2 else None,
            field=rng.integers(0, 3, size=nnz).astype(dtype) if i != 3 else None))
    return out


def _same(a, b):
    for name in FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), name


@pytest.mark.parametrize("num_col", [None, 12, 40, 64])
@pytest.mark.parametrize("binary", [False, True])
def test_to_dense_matches_reference(num_col, binary):
    for arrays in _parts(1):
        if binary:
            arrays = dict(arrays, value=None)
        got = RowBlock(**arrays).to_dense(num_col)
        want = JaxRowBlock(**arrays).to_dense(num_col)
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_container_builds_the_reference_block(dtype):
    port, ref = RowBlockContainer(index_dtype=dtype), JaxRowBlockContainer(index_dtype=dtype)
    assert len(port.to_block()) == 0 and port.to_block().index.dtype == dtype
    for arrays in _parts(2, np.uint64):
        port.push_block(RowBlock(**arrays))
        ref.push_block(JaxRowBlock(**arrays))
    port.push_row(1.0, [3, 7], value=[0.5, 1.5], weight=2.0, qid=9, field=[0, 1])
    ref.push_row(1.0, [3, 7], value=[0.5, 1.5], weight=2.0, qid=9, field=[0, 1])
    assert len(port) == len(ref) and port.max_index == ref.max_index
    got, want = port.to_block(), ref.to_block()
    _same(got, want)
    assert got.index.dtype == dtype  # a field keeps its pushed type, as in JAX
    port.clear()
    ref.clear()
    assert len(port) == 0 and port.index_dtype == ref.index_dtype == dtype
    assert port.max_index == ref.max_index == 0


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_container_files_cross_the_packages(writer, dtype):
    containers = {"port": (RowBlockContainer, RowBlock),
                  "jax": (JaxRowBlockContainer, JaxRowBlock)}
    reader = "jax" if writer == "port" else "port"
    stream = io.BytesIO()
    written = []
    for seed in (3, 4):
        cls, block_cls = containers[writer]
        c = cls(index_dtype=dtype)
        for arrays in _parts(seed, dtype):
            c.push_block(block_cls(**arrays))
        c.save(stream)
        written.append(c.to_block())
    # the two packages write the same bytes
    other = io.BytesIO()
    for seed in (3, 4):
        cls, block_cls = containers[reader]
        c = cls(index_dtype=dtype)
        for arrays in _parts(seed, dtype):
            c.push_block(block_cls(**arrays))
        c.save(other)
    assert stream.getvalue() == other.getvalue()
    stream.seek(0)
    load = containers[reader][0].load
    for want in written:
        got = load(stream)
        assert type(got).__name__ == "RowBlock"
        _same(got, want)
    assert stream.read() == b""
