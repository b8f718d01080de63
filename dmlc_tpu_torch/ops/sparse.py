"""Sparse batch layouts and the plain products over them.

Three device layouts for a parsed RowBlock (host CSR):

- **padded dense** ``[B, D]`` — low-dimensional dense-ish data (HIGGS);
- **ELL** ``indices/values [B, K]`` — rows padded to K nonzeros with the
  sink index ``D``, value 0;
- **bcoo** — the nonzeros as coordinates and values, a torch sparse
  tensor ``[rows, D]`` on the device.

The host converters :func:`block_to_ell` and :func:`block_to_dense` are
copies of the JAX package's (``dmlc_tpu/ops/sparse.py``) and emit the same
bytes. :func:`ell_matvec` is the plain PyTorch version of kernel K1
(``ops/ell_matvec.py``): the CPU route, and the reference the kernel is
held against on the card; the gradient of its 2-D gather is a row
scatter (:mod:`dmlc_tpu_torch.ops.row_scatter`), the same bits on every
run.
:func:`coo_matmul` is the bcoo product, its weight gradient a row scatter
too.

**The bcoo pad scheme.** :func:`block_to_bcoo_host` pads the nnz dimension
to a bucket so that batch shapes repeat. JAX pads with out-of-bounds
coordinates ``(rows_out, num_col)``, which every BCOO op masks; torch
masks nothing (an out-of-bounds index is a memory error once invariant
checks are off). So the port pads with **value 0 at the in-bounds
coordinate** ``(rows_out - 1, num_col - 1)``: inert in any product and in
its gradient, and placed after every real entry, so the coordinates stay
in row-major order. The host arrays differ from JAX's only in the pad
slots' coordinates. (Synthesized unit values, JAX's ``elide_unit_values``,
would make those slots count, so the port does not elide.) The slots share
one coordinate, so a tensor marked coalesced must not hold them: torch's
``to_dense`` keeps one of a coalesced tensor's duplicates, not their sum.
``DeviceIter`` ships them, so transfer sizes repeat, and builds its sparse
tensor on the real entries.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from dmlc_tpu_torch.data.row_block import RowBlock
from dmlc_tpu_torch.ops.row_scatter import gather_rows, row_scatter_add
from dmlc_tpu_torch.utils.check import check


class EllBatch(NamedTuple):
    """Row-padded sparse batch.

    indices: int32 [B, K] — feature ids, ``D`` (=num_col) marks padding
    values:  float32 [B, K] — zeros at padding
    label:   float32 [B]
    weight:  float32 [B] — ones when the source had no weights
    """

    indices: torch.Tensor | np.ndarray
    values: torch.Tensor | np.ndarray
    label: torch.Tensor | np.ndarray
    weight: torch.Tensor | np.ndarray


def block_to_ell(
    block: RowBlock,
    num_col: int,
    max_nnz: Optional[int] = None,
    pad_rows_to: Optional[int] = None,
) -> EllBatch:
    """CSR -> ELL with numpy scatter (host side, no Python loops).

    Rows longer than ``max_nnz`` are truncated; short rows pad with
    index=num_col, value=0. ``pad_rows_to`` pads the batch dimension with
    empty zero-weight rows so every batch has one shape.
    """
    n = len(block)
    lens = np.diff(block.offset)
    k = int(max_nnz if max_nnz is not None else (lens.max() if n else 1))
    k = max(k, 1)
    rows_out = int(pad_rows_to if pad_rows_to is not None else n)
    indices = np.full((rows_out, k), num_col, dtype=np.int32)
    values = np.zeros((rows_out, k), dtype=np.float32)
    if n:
        nnz = len(block.index)
        rows_all = np.repeat(np.arange(n), lens)                   # row of each entry
        pos = np.arange(nnz) - np.repeat(block.offset[:-1], lens)  # slot within row
        mask = pos < k                                             # truncate long rows
        vals = block.value if block.value is not None else np.ones(nnz, np.float32)
        indices[rows_all[mask], pos[mask]] = block.index[mask].astype(np.int32)
        values[rows_all[mask], pos[mask]] = vals[mask]
    label = np.zeros(rows_out, np.float32)
    label[:n] = block.label
    weight = np.zeros(rows_out, np.float32)
    weight[:n] = block.weight if block.weight is not None else 1.0
    return EllBatch(indices, values, label, weight)


def block_to_dense(
    block: RowBlock, num_col: int, pad_rows_to: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CSR -> padded dense [B, D] (+ label, weight), batch-padded like ELL."""
    n = len(block)
    rows_out = int(pad_rows_to if pad_rows_to is not None else n)
    x = np.zeros((rows_out, num_col), dtype=np.float32)
    if n:
        lens = np.diff(block.offset)
        vals = block.value if block.value is not None else np.ones(len(block.index), np.float32)
        k = int(lens[0])
        # fast path for dense-in-sparse data (HIGGS/CSV-shaped): every row has
        # the same k features 0..k-1, so the values are already a dense matrix
        if (
            0 < k <= num_col
            and len(block.index) == n * k
            and bool((lens == k).all())
            and bool((block.index.reshape(n, k) == np.arange(k, dtype=block.index.dtype)).all())
        ):
            x[:n, :k] = vals.reshape(n, k)
        else:
            rows = np.repeat(np.arange(n), lens)
            keep = block.index < num_col
            x[rows[keep], block.index[keep].astype(np.int64)] = vals[keep]
    label = np.zeros(rows_out, np.float32)
    label[:n] = block.label
    weight = np.zeros(rows_out, np.float32)
    weight[:n] = block.weight if block.weight is not None else 1.0
    return x, label, weight


def block_to_bcoo_host(
    block: RowBlock, num_col: int, pad_rows_to: Optional[int] = None,
    pad_nnz_to: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, Tuple[int, int]]:
    """CSR -> host COO arrays ``(coords [nnz_out, 2], vals, label, weight,
    shape)``, the JAX package's function but for its pad slots (module
    docstring).

    Coordinates are int32 while ``rows_out + 1`` and ``num_col + 1`` fit.
    ``pad_rows_to`` pads the batch dimension with empty zero-weight rows;
    ``pad_nnz_to`` pads the nnz dimension with value-0 slots at
    ``(rows_out - 1, num_col - 1)``.
    """
    n = len(block)
    nnz = len(block.index)
    rows_out = int(pad_rows_to if pad_rows_to is not None else n)
    nnz_out = int(pad_nnz_to) if pad_nnz_to is not None and pad_nnz_to > nnz else nnz
    check(nnz_out == nnz or (rows_out > 0 and num_col > 0),
          "block_to_bcoo_host: nnz padding needs a row and a column to pad into")
    idx_dtype = np.int32 if max(rows_out + 1, num_col + 1) < (1 << 31) else np.int64
    coords = np.empty((nnz_out, 2), idx_dtype)
    coords[:nnz, 0] = np.repeat(np.arange(n, dtype=idx_dtype), np.diff(block.offset))
    coords[:nnz, 1] = block.index
    coords[nnz:, 0] = rows_out - 1   # in-bounds pad, value 0
    coords[nnz:, 1] = num_col - 1
    vals = np.zeros(nnz_out, np.float32)
    vals[:nnz] = block.value if block.value is not None else 1.0
    label = np.zeros(rows_out, np.float32)
    label[:n] = block.label
    weight = np.zeros(rows_out, np.float32)
    weight[:n] = block.weight if block.weight is not None else 1.0
    return coords, vals, label, weight, (rows_out, num_col)


def ell_matvec(weights: torch.Tensor, batch: EllBatch) -> torch.Tensor:
    """Batched sparse dot: out[b] = sum_k w[idx[b,k]] * val[b,k].

    The batched analog of Row::SDot (data.h:146-161), in plain PyTorch.
    ``weights`` is [D+1]; the final slot is the padding sink (index=num_col)
    and must be 0. A 2-D table [D+1, C] broadcasts the values over the class
    dim and returns [B, C]; its gather's gradient is :func:`row_scatter_add`.
    A 1-D table keeps indexing's own backward, the reference K1's ``dw``
    kernel is held against.
    """
    if weights.dim() == 1:
        return (weights[batch.indices.long()] * batch.values).sum(dim=1)
    gathered = gather_rows(weights, batch.indices)  # [B, K, C]
    return (gathered * batch.values[..., None]).sum(dim=1)


class _CooMatmul(torch.autograd.Function):
    """``x @ w`` for a sparse COO ``x [R, D]`` and a dense ``w [D, C]``.

    Forward is torch's sparse product. The weight gradient ``x^T g`` is a
    gather and a :func:`row_scatter_add` over the entries (the same bits on
    every run): torch's own backward coalesces the transposed ``x``, which
    on CUDA sorts the entries and reads their unique count back to the
    host, a sync in every step that CUDA's sync debug mode does not see (it
    happens inside thrust)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x)
        return torch.sparse.mm(x, w)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        rows, cols = x._indices()
        return None, row_scatter_add((x.shape[1], g.shape[1]), cols,
                                     x._values()[:, None] * g[rows])


def coo_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a sparse COO batch ``x`` and a ``[D]`` or ``[D, C]``
    table, differentiable in ``w`` with no host sync when ``x`` is marked
    coalesced (a ``DeviceIter`` bcoo batch in row-major order)."""
    if w.dim() == 1:
        return _CooMatmul.apply(x, w[:, None])[:, 0]
    return _CooMatmul.apply(x, w)
