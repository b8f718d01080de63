"""The port's row scatter-add and the gather whose gradient it is, on the CPU.

``dmlc_tpu_torch.ops.row_scatter`` takes the place of the JAX package's
XLA scatter-adds (``.at[idx].add``): the ALS gram and rhs, the FM factor
gathers' gradients and the bcoo gradient. On the CPU it is the plain
version (``index_add_``); the card's kernel (``csrc/row_scatter.cu``) is
held against it by ``chip_smoke.py``. Here:

- ``row_scatter_add`` equals JAX's ``zeros.at[idx].add(src)`` for vector,
  row and matrix entries, repeated ids and ids left out;
- ``row_scatter_add_`` accumulates into a table in place, as the ALS
  epoch's normal equations do;
- ``gather_rows`` gives ``table[idx]`` and, through its backward, JAX's
  ``jax.grad`` of a gather, for int32 and int64 ids;
- the kernel's wrapper refuses CPU tensors, and mismatched shapes raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlc_tpu_torch.ops import row_scatter as rs
from dmlc_tpu_torch.utils.check import DMLCError


@pytest.mark.parametrize("row", [(), (3,), (4, 4)])
def test_row_scatter_add_matches_jax_scatter(row):
    rng = np.random.default_rng(len(row))
    rows, n = 9, 200
    idx = rng.integers(0, rows - 2, size=n).astype(np.int32)  # rows 7, 8 get nothing
    idx[:40] = 3                                               # a long run
    src = rng.normal(size=(n, *row)).astype(np.float32)
    want = jnp.zeros((rows, *row), jnp.float32).at[jnp.asarray(idx)].add(jnp.asarray(src))
    got = rs.row_scatter_add((rows, *row), torch.from_numpy(idx), torch.from_numpy(src))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert not got[rows - 2:].any()
    plain = rs.row_scatter_add_plain((rows, *row), torch.from_numpy(idx).long(),
                                     torch.from_numpy(src))
    assert torch.equal(got, plain)


def test_row_scatter_add_accumulates_in_place():
    rng = np.random.default_rng(1)
    table = torch.from_numpy(rng.normal(size=(5, 2)).astype(np.float32))
    before = table.clone()
    idx = torch.tensor([4, 0, 4, 1], dtype=torch.int32)
    src = torch.from_numpy(rng.normal(size=(4, 2)).astype(np.float32))
    out = rs.row_scatter_add_(table, idx, src)
    assert out is table
    want = before.clone()
    for i, d in enumerate(idx.tolist()):
        want[d] += src[i]
    torch.testing.assert_close(table, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("width", [None, 3])
def test_gather_rows_gradient_matches_jax(dtype, width):
    rng = np.random.default_rng(2)
    shape = (7,) if width is None else (7, width)
    table = rng.normal(size=shape).astype(np.float32)
    idx = rng.integers(0, 7, size=(5, 4))
    g = rng.normal(size=(5, 4, *shape[1:])).astype(np.float32)

    def loss(t):
        return jnp.sum(jnp.take(t, jnp.asarray(idx), axis=0) * jnp.asarray(g))

    want = jax.grad(loss)(jnp.asarray(table))
    t = torch.tensor(table, requires_grad=True)
    out = rs.gather_rows(t, torch.from_numpy(idx).to(dtype))
    assert torch.equal(out.detach(), torch.from_numpy(table)[torch.from_numpy(idx)])
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    with torch.no_grad():  # no graph: plain indexing
        assert torch.equal(rs.gather_rows(t, torch.from_numpy(idx)), out.detach())


def test_argument_checks():
    table = torch.zeros(4, 2)
    with pytest.raises(DMLCError, match="do not fit"):
        rs.row_scatter_add_(table, torch.zeros(3, dtype=torch.int64), torch.zeros(3, 3))
    with pytest.raises(DMLCError, match="do not fit"):
        rs.row_scatter_add((4, 2), torch.zeros(3, 1, dtype=torch.int64), torch.zeros(3, 2))
    with pytest.raises(DMLCError, match="CUDA"):
        rs.row_scatter_cuda_(table, torch.zeros(3, dtype=torch.int64), torch.zeros(3, 2))
