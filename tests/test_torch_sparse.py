"""Parity of the port's sparse layer (dmlc_tpu_torch.ops) with dmlc_tpu.ops.

The same numpy inputs, made from a seeded generator, go through the JAX
function and its port:

- host converters ``block_to_ell`` / ``block_to_dense``: byte-equal;
- the plain ``ell_matvec`` (kernel K1's reference version, the CPU route)
  against the Pallas kernel ``ell_matvec_pallas`` run in interpret mode,
  and against the JAX gather for 2-D tables: rtol 1e-5, atol 1e-5 (float32
  sums taken in another order);
- K1's backward (dw, dval) against ``jax.grad`` through the Pallas custom
  VJP: same tolerance.

Kernel K1 itself runs only on the card (chip_smoke.py holds it against the
plain version there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlc_tpu.data.row_block import RowBlock as JaxRowBlock
from dmlc_tpu.ops import sparse as jsparse
from dmlc_tpu.ops.pallas_sparse import _ell_matvec_pallas_ad, ell_matvec_pallas
from dmlc_tpu_torch.data.row_block import RowBlock
from dmlc_tpu_torch.ops import sparse
from dmlc_tpu_torch.ops.ell_matvec import ell_matvec_auto, ell_matvec_backward

RTOL = ATOL = 1e-5


def _csr(rng, n, num_col, max_len, binary=False, weighted=False):
    lens = rng.integers(0, max_len + 1, size=n)
    offset = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    nnz = int(offset[-1])
    index = rng.integers(0, num_col, size=nnz).astype(np.uint64)
    value = None if binary else rng.normal(size=nnz).astype(np.float32)
    label = rng.integers(0, 2, size=n).astype(np.float32)
    weight = rng.uniform(0.5, 2, size=n).astype(np.float32) if weighted else None
    return offset, label, index, value, weight


def _pair(arrays):
    offset, label, index, value, weight = arrays
    return (RowBlock(offset, label, index, value=value, weight=weight),
            JaxRowBlock(offset, label, index, value=value, weight=weight))


def _assert_bytes_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("binary,weighted,max_nnz,pad", [
    (False, False, 5, None),     # truncates rows longer than 5
    (True, True, 9, 48),         # binary features, weights, row padding
    (False, True, None, None),   # K from the batch's longest row
])
def test_block_to_ell_byte_equal(binary, weighted, max_nnz, pad):
    rng = np.random.default_rng(1)
    port, ref = _pair(_csr(rng, 40, 30, 9, binary=binary, weighted=weighted))
    got = sparse.block_to_ell(port, 30, max_nnz=max_nnz, pad_rows_to=pad)
    want = jsparse.block_to_ell(ref, 30, max_nnz=max_nnz, pad_rows_to=pad)
    for g, w in zip(got, want):
        _assert_bytes_equal(g, w)


@pytest.mark.parametrize("dense_in_sparse,pad", [(True, None), (True, 32),
                                                 (False, None), (False, 32)])
def test_block_to_dense_byte_equal(dense_in_sparse, pad):
    rng = np.random.default_rng(2)
    if dense_in_sparse:
        # HIGGS-shaped: every row has features 0..k-1 (the fast path)
        n, k = 20, 6
        arrays = (np.arange(0, n * k + 1, k, dtype=np.int64),
                  rng.integers(0, 2, size=n).astype(np.float32),
                  np.tile(np.arange(k, dtype=np.uint64), n),
                  rng.normal(size=n * k).astype(np.float32), None)
    else:
        arrays = _csr(rng, 20, 12, 6, weighted=True)
    port, ref = _pair(arrays)
    got = sparse.block_to_dense(port, 8 if dense_in_sparse else 10, pad_rows_to=pad)
    want = jsparse.block_to_dense(ref, 8 if dense_in_sparse else 10, pad_rows_to=pad)
    for g, w in zip(got, want):
        _assert_bytes_equal(g, w)


def _ell_inputs(rng, b, k, w):
    """A [w] table with the sink w[-1] = 0, and [b, k] slots of which about
    a third are padded to the sink (index w-1, value 0)."""
    table = rng.normal(size=w).astype(np.float32)
    table[-1] = 0.0
    idx = rng.integers(0, w - 1, size=(b, k)).astype(np.int32)
    val = rng.normal(size=(b, k)).astype(np.float32)
    pad = rng.random(size=(b, k)) < 0.3
    idx[pad] = w - 1
    val[pad] = 0.0
    return table, idx, val


@pytest.mark.parametrize("b,k,w", [(64, 7, 29), (128, 64, 65), (256, 28, 29)])
def test_ell_matvec_matches_pallas_interpret(b, k, w):
    rng = np.random.default_rng(b + k)
    table, idx, val = _ell_inputs(rng, b, k, w)
    want = np.asarray(ell_matvec_pallas(jnp.asarray(table), jnp.asarray(idx),
                                        jnp.asarray(val), block_b=64, interpret=True))
    batch = sparse.EllBatch(torch.from_numpy(idx), torch.from_numpy(val), None, None)
    got = sparse.ell_matvec(torch.from_numpy(table), batch)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # the CPU route of the auto entry is the plain version
    auto = ell_matvec_auto(torch.from_numpy(table), batch)
    assert torch.equal(auto, got)


@pytest.mark.parametrize("k", [5, 64])
def test_ell_matvec_2d_table_matches_jax_gather(k):
    rng = np.random.default_rng(k)
    table, idx, val = _ell_inputs(rng, 32, k, 41)
    table2 = rng.normal(size=(41, 3)).astype(np.float32)
    table2[-1] = 0.0
    jbatch = jsparse.EllBatch(jnp.asarray(idx), jnp.asarray(val), None, None)
    want = np.asarray(jsparse.ell_matvec(jnp.asarray(table2), jbatch))
    batch = sparse.EllBatch(torch.from_numpy(idx), torch.from_numpy(val), None, None)
    got = ell_matvec_auto(torch.from_numpy(table2), batch)
    assert got.shape == (32, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("b,k,w", [(64, 7, 29), (64, 64, 65)])
def test_ell_matvec_grads_match_pallas_vjp(b, k, w):
    rng = np.random.default_rng(7 * k)
    table, idx, val = _ell_inputs(rng, b, k, w)
    g = rng.normal(size=b).astype(np.float32)

    def f(tw, tv):
        return jnp.sum(_ell_matvec_pallas_ad(tw, jnp.asarray(idx), tv, True) * g)

    jdw, jdval = jax.grad(f, argnums=(0, 1))(jnp.asarray(table), jnp.asarray(val))
    # the kernel's backward formula, as EllMatvec.backward applies it
    dw, dval = ell_matvec_backward(torch.from_numpy(table), torch.from_numpy(idx),
                                   torch.from_numpy(val), torch.from_numpy(g))
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dval.numpy(), np.asarray(jdval), rtol=RTOL, atol=ATOL)
    # autograd through the plain route agrees with the hand-written backward
    tw = torch.from_numpy(table).requires_grad_()
    tv = torch.from_numpy(val).requires_grad_()
    out = sparse.ell_matvec(tw, sparse.EllBatch(torch.from_numpy(idx), tv, None, None))
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tw.grad.numpy(), dw.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tv.grad.numpy(), dval.numpy(), rtol=RTOL, atol=ATOL)
