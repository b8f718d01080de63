"""Sparse batch layouts and the plain products over them.

Two device layouts for a parsed RowBlock (host CSR):

- **padded dense** ``[B, D]`` — low-dimensional dense-ish data (HIGGS);
- **ELL** ``indices/values [B, K]`` — rows padded to K nonzeros with the
  sink index ``D``, value 0.

The host converters :func:`block_to_ell` and :func:`block_to_dense` are
copies of the JAX package's (``dmlc_tpu/ops/sparse.py``) and emit the same
bytes. :func:`ell_matvec` is the plain PyTorch version of kernel K1
(``ops/ell_matvec.py``): the CPU route, and the reference the kernel is
held against on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from dmlc_tpu_torch.data.row_block import RowBlock


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


def ell_matvec(weights: torch.Tensor, batch: EllBatch) -> torch.Tensor:
    """Batched sparse dot: out[b] = sum_k w[idx[b,k]] * val[b,k].

    The batched analog of Row::SDot (data.h:146-161), in plain PyTorch.
    ``weights`` is [D+1]; the final slot is the padding sink (index=num_col)
    and must be 0. A 2-D table [D+1, C] broadcasts the values over the class
    dim and returns [B, C].
    """
    gathered = weights[batch.indices.long()]  # [B, K] or [B, K, C]
    vals = batch.values if weights.dim() == 1 else batch.values[..., None]
    return (gathered * vals).sum(dim=1)
