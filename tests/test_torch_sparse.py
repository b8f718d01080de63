"""Parity of the port's sparse layer (dmlc_tpu_torch.ops) with dmlc_tpu.ops.

The same numpy inputs, made from a seeded generator, go through the JAX
function and its port:

- host converters ``block_to_ell`` / ``block_to_dense``: byte-equal;
- the plain ``ell_matvec`` (kernel K1's reference version, the CPU route)
  against the Pallas kernel ``ell_matvec_pallas`` run in interpret mode,
  and against the JAX gather for 2-D tables: rtol 1e-5, atol 1e-5 (float32
  sums taken in another order);
- K1's gradient, the plain ``ell_matvec_grads`` (the CPU route, and the
  reference of the ``dw`` kernel), against ``jax.grad`` through the Pallas
  custom VJP run in interpret mode: same tolerance;
- the ``dw`` route by table width, and the kernels' refusal of CPU tensors;
- the names the earlier slices left out: ``EllBatch.batch_size`` /
  ``max_nnz``, ``block_to_dense(copy=False)``'s view,
  ``block_to_bcoo_host(unit_values_as_none=)``, ``block_to_bcoo`` (dense
  form equal to the JAX BCOO's ``todense()``), ``ell_matmul`` on a
  ``[D+1, H]`` table and ``segment_csr_matvec`` (``tests/test_device.py``'s
  cases, duplicate ids, rows with no entries, ids the JAX segment sum
  drops, and the gradients) against the JAX functions: rtol 1e-5.

The kernels themselves run only on the card (chip_smoke.py holds them
against the plain versions there).
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
from dmlc_tpu_torch.ops.ell_matvec import (DW_MAX_TABLE, dw_route, ell_matvec_auto,
                                           ell_matvec_cuda, ell_matvec_dw_cuda,
                                           ell_matvec_grads)
from dmlc_tpu_torch.utils.check import DMLCError

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


@pytest.mark.parametrize("b,k,w", [(64, 7, 29), (64, 64, 65), (128, 28, 29),
                                   (64, 3, 1001), (192, 33, 97)])
def test_ell_matvec_grads_match_pallas_vjp(b, k, w):
    rng = np.random.default_rng(7 * k)
    table, idx, val = _ell_inputs(rng, b, k, w)
    g = rng.normal(size=b).astype(np.float32)

    def f(tw, tv):
        return jnp.sum(_ell_matvec_pallas_ad(tw, jnp.asarray(idx), tv, True) * g)

    jdw, jdval = jax.grad(f, argnums=(0, 1))(jnp.asarray(table), jnp.asarray(val))
    # the plain gradient: the CPU route, and the dw kernel's reference
    dw, dval = ell_matvec_grads(torch.from_numpy(table), torch.from_numpy(idx),
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


def test_ell_matvec_grads_without_dval():
    rng = np.random.default_rng(11)
    table, idx, val = _ell_inputs(rng, 32, 5, 17)
    g = torch.from_numpy(rng.normal(size=32).astype(np.float32))
    args = (torch.from_numpy(table), torch.from_numpy(idx), torch.from_numpy(val), g)
    dw, dval = ell_matvec_grads(*args, need_dval=False)
    assert dval is None
    assert torch.equal(dw, ell_matvec_grads(*args)[0])


@pytest.mark.parametrize("table_size,route", [
    (1, "cuda"), (29, "cuda"), (2049, "cuda"), (DW_MAX_TABLE, "cuda"),
    (DW_MAX_TABLE + 1, "index_add"), ((1 << 20) + 1, "index_add"),
])
def test_dw_route_by_table_width(table_size, route):
    assert DW_MAX_TABLE >= 2049
    assert dw_route(table_size) == route


def test_kernels_refuse_cpu_tensors():
    idx = torch.zeros((4, 3), dtype=torch.int32)
    val, g = torch.zeros((4, 3)), torch.zeros(4)
    with pytest.raises(DMLCError, match="CUDA"):
        ell_matvec_dw_cuda(idx, val, g, 5)
    with pytest.raises(DMLCError, match="CUDA"):
        ell_matvec_cuda(torch.zeros(5), idx, val)


def _device_block(pkg_cls):
    """``tests/test_device.py``'s block."""
    return pkg_cls(offset=[0, 2, 3, 6], label=[1.0, 0.0, 1.0],
                   index=np.array([0, 3, 1, 0, 2, 4], dtype=np.uint64),
                   value=np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0], dtype=np.float32),
                   weight=np.array([1.0, 0.5, 2.0], dtype=np.float32))


def test_ell_batch_properties_match_reference():
    rng = np.random.default_rng(5)
    port, ref = _pair(_csr(rng, 12, 9, 4))
    got = sparse.block_to_ell(port, 9, max_nnz=4, pad_rows_to=16)
    want = jsparse.block_to_ell(ref, 9, max_nnz=4, pad_rows_to=16)
    assert (got.batch_size, got.max_nnz) == (want.batch_size, want.max_nnz) == (16, 4)
    on_device = sparse.EllBatch(*(torch.from_numpy(a) for a in got))
    assert (on_device.batch_size, on_device.max_nnz) == (16, 4)


@pytest.mark.parametrize("num_col,pad", [(6, None), (6, 24), (8, None)])
def test_block_to_dense_copy_false_views_as_reference(num_col, pad):
    rng = np.random.default_rng(2)
    n, k = 20, 6
    arrays = (np.arange(0, n * k + 1, k, dtype=np.int64),
              rng.integers(0, 2, size=n).astype(np.float32),
              np.tile(np.arange(k, dtype=np.uint64), n),
              rng.normal(size=n * k).astype(np.float32), None)
    port, ref = _pair(arrays)
    got = sparse.block_to_dense(port, num_col, pad_rows_to=pad, copy=False)
    want = jsparse.block_to_dense(ref, num_col, pad_rows_to=pad, copy=False)
    for g, w in zip(got, want):
        _assert_bytes_equal(g, w)
    # a view exactly where JAX gives one: full width, no row padding
    assert np.shares_memory(got[0], port.value) == np.shares_memory(want[0], ref.value) == (
        num_col == k and pad is None)


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("pad_nnz", [None, 64])
def test_block_to_bcoo_host_unit_values_as_none(binary, pad_nnz):
    rng = np.random.default_rng(9)
    offset, label, index, value, weight = _csr(rng, 20, 30, 5, binary=binary)
    ones = np.ones_like(value) if value is not None else None
    for vals in (value, ones):
        port, ref = _pair((offset, label, index, vals, weight))
        got = sparse.block_to_bcoo_host(port, 30, 24, True, pad_nnz)
        want = jsparse.block_to_bcoo_host(ref, 30, 24, True, pad_nnz)
        assert (got[1] is None) == (want[1] is None) == (vals is None or vals is ones)
        nnz = len(index)
        _assert_bytes_equal(got[0][:nnz], want[0][:nnz])
        if got[1] is not None:
            _assert_bytes_equal(got[1][:nnz], want[1][:nnz])
    # an id past num_col keeps its values: its zero marks the masked slot
    port, ref = _pair((offset, label, index, ones, weight))
    coords, vals, _, _, _ = sparse.block_to_bcoo_host(port, 20, unit_values_as_none=True)
    assert vals is not None and (vals[index >= 20] == 0).all() and (vals[index < 20] == 1).all()


@pytest.mark.parametrize("unsorted", [False, True])
def test_block_to_bcoo_dense_form_matches_reference(unsorted):
    block, ref = _device_block(RowBlock), _device_block(JaxRowBlock)
    if unsorted:  # row 2's ids out of order, and an id past num_col
        for b in (block, ref):
            b.index = np.array([0, 3, 1, 4, 2, 7], dtype=np.uint64)
    got = sparse.block_to_bcoo(block, 5, device="cpu")
    want = jsparse.block_to_bcoo(ref, 5)
    assert got.is_sparse and tuple(got.shape) == tuple(want.shape) == (3, 5)
    assert got.is_coalesced() == (not unsorted)
    np.testing.assert_allclose(got.to_dense().numpy(), np.asarray(want.todense()), rtol=RTOL)
    np.testing.assert_allclose(got.to_dense().numpy(), block.to_dense(5), rtol=RTOL)


def test_ell_matmul_matches_reference():
    rng = np.random.default_rng(3)
    table = rng.normal(size=(30, 8)).astype(np.float32)
    table[-1] = 0.0
    port, ref = _pair(_csr(rng, 40, 29, 6))
    ell = sparse.block_to_ell(port, 29, pad_rows_to=48)
    jell = jsparse.block_to_ell(ref, 29, pad_rows_to=48)
    got = sparse.ell_matmul(torch.from_numpy(table),
                            sparse.EllBatch(*(torch.from_numpy(a) for a in ell)))
    want = jsparse.ell_matmul(jnp.asarray(table), jell)
    assert tuple(got.shape) == (48, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    with pytest.raises(DMLCError, match="table"):
        sparse.ell_matmul(torch.from_numpy(table[:, 0]), sparse.EllBatch(
            *(torch.from_numpy(a) for a in ell)))


def _segment_case(name):
    """``(weights [D], index, value, row_ids, num_rows)``."""
    if name == "device":  # tests/test_device.py
        blk = _device_block(RowBlock)
        rows = np.repeat(np.arange(3), np.diff(blk.offset))
        return (np.arange(1.0, 6.0, dtype=np.float32), blk.index.astype(np.int32), blk.value,
                rows, 3)
    rng = np.random.default_rng(4)
    n = 300
    index = rng.integers(0, 50, size=n)
    value = rng.normal(size=n).astype(np.float32)
    rows = np.sort(rng.integers(0, 40, size=n))
    rows[rows % 7 == 3] = 5              # rows with no entries, one row of many
    if name == "dropped":                # ids the segment sum drops
        rows[:7] = -1
        rows[-9:] = 40
    return rng.normal(size=50).astype(np.float32), index, value, rows, 40


@pytest.mark.parametrize("name", ["device", "duplicates", "dropped"])
def test_segment_csr_matvec_matches_reference(name):
    w, index, value, rows, num_rows = _segment_case(name)
    tw = torch.from_numpy(w).requires_grad_(True)
    tv = torch.from_numpy(value).requires_grad_(True)
    got = sparse.segment_csr_matvec(tw, torch.from_numpy(index.astype(np.int64)), tv,
                                    torch.from_numpy(rows.astype(np.int64)), num_rows)

    def f(jw, jv):
        return jsparse.segment_csr_matvec(jw, jnp.asarray(index), jv, jnp.asarray(rows),
                                          num_rows)

    want = f(jnp.asarray(w), jnp.asarray(value))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    if name == "device":
        blk = _device_block(RowBlock)
        np.testing.assert_allclose(got.detach().numpy(),
                                   blk.to_dense(5) @ np.arange(1.0, 6.0, dtype=np.float32),
                                   rtol=1e-6)
    g = np.random.default_rng(8).normal(size=num_rows).astype(np.float32)
    (got * torch.from_numpy(g)).sum().backward()
    jgw, jgv = jax.grad(lambda a, b: jnp.sum(f(a, b) * g), argnums=(0, 1))(
        jnp.asarray(w), jnp.asarray(value))
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(jgv), rtol=RTOL, atol=ATOL)
