"""Row scatter-adds that give the same bits on every run, and the gather
whose gradient is one.

``out[d] = Σ_{i: idx[i] = d} src[i]`` for ``idx [N]`` and ``src [N, *R]``:
the scatter-add of the JAX package's XLA scatters (``.at[idx].add``): the
ALS gram and rhs (``models/als.py:169-171``), the gradients of the FM
factor gathers (``models/fm.py:64-69``) and of the bcoo product
(``bcoo_dot_general``'s transpose). No Pallas kernel sits behind any of
them.

- :func:`row_scatter_add_plain` is ``index_add_``: on the CPU it sums each
  row's entries in their order, the same bits every run; it is the CPU
  route and the reference the kernel is held against on the card.
- On the card ``index_add_`` sums with float atomics, whose order, and so
  whose bits, change from run to run; ``index_put_(accumulate=True)`` is
  deterministic but ran 38-132x slower than ``index_add_`` at the ALS
  shapes (NVIDIA H100, ``chip_smoke.py`` ``row_scatter_ab``; PERF.md §6).
  So :func:`row_scatter_cuda_` puts the entries in a stable order by row
  id (the kernel library's counting sort for tables of up to 4,095 rows,
  ``torch.sort(stable=True)`` above: the same order, an id outside
  ``[0, D)`` after every row) and launches the hand-written kernel
  ``csrc/row_scatter.cu``, which sums each row's run of entries in a fixed
  order, long runs by fixed 32-entry chunks, with no float atomics and no
  host sync: one launch walks each chunk (short runs written, partials of
  the runs that cross chunks), one adds each long run's partials. Both see
  only the N entries, so the cost follows the ids and not the D table
  rows: without ``accumulate`` the table's one zeroing write
  (``cudaMemsetAsync``) bounds it, then ``src`` read once; the sort is the
  largest cost at small shapes. On an H100 (``row_scatter_ab``, PERF.md
  §6) it took 0.17 ms for 81,920 ids into 50,000,001 words and
  0.59 ms into ``[50,000,001, 8]``, against 1.31 and 4.89 ms for the
  table-driven version before it and 0.13 and 0.55 ms for zeros +
  ``index_add_``; at the ALS shapes at most 6% over the version before
  and at the FM shapes level with it, with its bits. Every launch adds one
  to :data:`launches`.
- :func:`row_scatter_add_ordered_plain` sums in the kernel's exact order
  (stable sort, 32-entry chunks, head and tail partials) in plain torch:
  the kernel equals it bit for bit. The tests and ``chip_smoke.py`` use it;
  no step does.
- :func:`row_scatter_add_` / :func:`row_scatter_add` route: the plain
  version for CPU tensors, the kernel for CUDA tensors (nothing falls back
  quietly: a kernel that fails to build or launch raises).
- :func:`gather_rows` is ``table[idx]`` with a backward through
  :func:`row_scatter_add`.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

import torch

from dmlc_tpu_torch.ops import _build
from dmlc_tpu_torch.utils.check import DMLCError, check

# sorted entries a partial of the kernel sums at most (kChunk)
CHUNK = 32

# kernel launches since the last reset (chip_smoke.py zeroes it before a
# path and reads it after, to show the path's scatters took the kernel)
launches = 0


def _check_args(table: torch.Tensor, idx: torch.Tensor, src: torch.Tensor) -> None:
    check(idx.dim() == 1 and src.shape[0] == idx.shape[0]
          and tuple(src.shape[1:]) == tuple(table.shape[1:]),
          f"row_scatter_add: idx {tuple(idx.shape)} and src {tuple(src.shape)} do not "
          f"fit a {tuple(table.shape)} table")
    check(table.device == idx.device == src.device,
          "row_scatter_add: tensors must share one device")
    check(src.dtype == table.dtype, "row_scatter_add: src and table must share a dtype")


def row_scatter_add_plain_(table: torch.Tensor, idx: torch.Tensor,
                           src: torch.Tensor) -> torch.Tensor:
    """``table[idx[i]] += src[i]`` in place, by ``index_add_``."""
    _check_args(table, idx, src)
    return table.index_add_(0, idx.long(), src)


def row_scatter_add_plain(table_shape: Sequence[int], idx: torch.Tensor,
                          src: torch.Tensor) -> torch.Tensor:
    """The plain version: ``zeros(table_shape).index_add_(0, idx, src)``."""
    table = torch.zeros(tuple(table_shape), dtype=src.dtype, device=src.device)
    return row_scatter_add_plain_(table, idx, src)


def row_scatter_add_ordered_plain(table_shape: Sequence[int], idx: torch.Tensor,
                                  src: torch.Tensor,
                                  table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's result, summed in its exact order in plain torch: a new
    tensor that equals ``row_scatter_cuda_(table.clone(), idx, src)`` bit
    for bit (a row no entry hits keeps ``table``'s word), or, without
    ``table``, ``row_scatter_add(table_shape, idx, src)`` (such a row +0.0).

    The order: the entries sorted stably by row id (an id outside
    ``[0, rows)`` after every row, adding to none); the sorted order cut
    into chunks of :data:`CHUNK`; each run's piece in a chunk summed entry
    by entry from +0.0; a run's pieces then added in chunk order, the first
    piece first. (The kernel sums a run inside one chunk entry by entry,
    and a longer one as the tail partial of its first chunk, the partials
    of the chunks inside it, and the head partial of its last: the same
    sums in the same order.)"""
    shape = tuple(table_shape)
    rows, width, n = shape[0], math.prod(shape[1:]), idx.shape[0]
    dev = src.device
    out = (torch.zeros(shape, dtype=src.dtype, device=dev) if table is None
           else table.clone(memory_format=torch.contiguous_format))
    if n == 0 or width == 0:
        return out
    keys, perm = torch.sort(_sort_keys(idx.long(), rows), stable=True)
    vals = src.reshape(n, width)[perm]
    pos = torch.arange(n, device=dev)
    # pieces: the entries of one run inside one chunk
    new_piece = torch.ones(n, dtype=torch.bool, device=dev)
    new_piece[1:] = (keys[1:] != keys[:-1]) | (pos[1:] % CHUNK == 0)
    piece = torch.cumsum(new_piece, 0) - 1
    piece_start = pos[new_piece]
    offset = pos - piece_start[piece]
    sums = torch.zeros((piece_start.shape[0], width), dtype=src.dtype, device=dev)
    for t in range(CHUNK):
        at = offset == t  # one entry a piece at most
        sums[piece[at]] += vals[at]
    # runs: a row's pieces, added in order; the runs sorted by their piece
    # count, longest first, so the runs still adding at step t are a prefix
    piece_keys = keys[piece_start]
    new_run = torch.ones(piece_keys.shape[0], dtype=torch.bool, device=dev)
    new_run[1:] = piece_keys[1:] != piece_keys[:-1]
    first = torch.nonzero(new_run).flatten()
    count = torch.diff(first, append=first.new_tensor([piece_keys.shape[0]]))
    count, by_count = torch.sort(count, descending=True, stable=True)
    first = first[by_count]
    acc = sums[first]
    longest_first = -count.cpu().numpy()
    for t in range(1, -int(longest_first[0])):
        m = int(np.searchsorted(longest_first, -t))  # runs of more than t pieces
        acc[:m] += sums[first[:m] + t]
    run_keys = piece_keys[first]
    keep = run_keys < rows
    flat, d = out.view(rows, width), run_keys[keep]
    flat[d] = acc[keep] if table is None else flat[d] + acc[keep]
    return out


def _raise_on(lib, rc: int) -> None:
    if rc != 0:
        raise DMLCError("row_scatter kernel launch failed: "
                        + lib.dmlc_cuda_error_string(rc).decode())


def stable_order(idx: torch.Tensor, rows: int):
    """``(sorted ids, perm)``: the entries of ``idx [N]`` (on a CUDA device)
    in a stable order by row id, ids as int32 and ``perm`` int64, an id
    outside ``[0, rows)`` read as ``rows``, after every row. For a table of
    up to 4,095 rows it is the kernel library's counting sort (three
    launches), above it ``torch.sort(stable=True)``: the same order. An
    int64 id outside ``[-1, rows]`` is clamped into it first, so that the
    int32 cast cannot wrap it onto a row of the table."""
    lib = _build.load_kernels()
    n, dev = idx.shape[0], idx.device
    counts = lib.dmlc_row_sort_counts(n, rows)
    if not counts:
        return torch.sort(_sort_keys(idx, rows).to(torch.int32), stable=True)
    if idx.dtype == torch.int64:
        idx = idx.clamp(-1, rows)
    idx = idx.to(torch.int32).contiguous()
    sorted_idx = torch.empty(n, dtype=torch.int32, device=dev)
    perm = torch.empty(n, dtype=torch.int64, device=dev)
    scratch = torch.empty(counts, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.dmlc_row_sort(idx.data_ptr(), n, rows, scratch.data_ptr(),
                               sorted_idx.data_ptr(), perm.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, rc)
    return sorted_idx, perm


def _sort_keys(idx: torch.Tensor, rows: int) -> torch.Tensor:
    """``idx`` with every id outside ``[0, rows)`` as ``rows`` (its dtype
    kept): the key the entries are sorted by."""
    return idx.clamp(-1, rows).remainder_(rows + 1)


def row_scatter_cuda_(table: torch.Tensor, idx: torch.Tensor, src: torch.Tensor,
                      accumulate: bool = True) -> torch.Tensor:
    """Launch the kernel on the current stream: ``table[d] (+)= Σ src[i]``
    over ``idx[i] == d``, in place. With ``accumulate`` a row no entry hits
    is not touched; without it every row of ``table`` is overwritten (a row
    no entry hits gets +0.0, the table first zeroed by
    ``cudaMemsetAsync``). Takes a contiguous float32 table and ``src``
    and an integer ``idx`` on one CUDA device, and raises on anything else.
    Ids belong in ``[0, rows)``: one outside adds nothing here, where the
    plain version raises."""
    global launches
    _check_args(table, idx, src)
    check(table.is_cuda, "row_scatter_cuda_: tensors must be on a CUDA device")
    check(table.dtype == torch.float32 and table.is_contiguous(),
          "row_scatter_cuda_: needs a contiguous float32 table")
    check(not idx.is_floating_point() and not idx.is_complex(),
          "row_scatter_cuda_: idx must be an integer tensor")
    rows, n = table.shape[0], idx.shape[0]
    width = math.prod(table.shape[1:])
    check(rows < 2 ** 31 - 1 and width > 0,
          f"row_scatter_cuda_: a {tuple(table.shape)} table is out of the kernel's range")
    lib = _build.load_kernels()
    dev = table.device
    with torch.cuda.device(dev):
        # stable: each row's entries keep their order in the sorted run
        sorted_idx, perm = stable_order(idx, rows)
        src = src.contiguous()
        partials = torch.empty((2, lib.dmlc_row_scatter_chunks(n), width),
                               dtype=torch.float32, device=dev)
        rc = lib.dmlc_row_scatter_f32(
            sorted_idx.data_ptr(), perm.data_ptr(), src.data_ptr(), table.data_ptr(),
            partials[0].data_ptr(), partials[1].data_ptr(), n, width, rows,
            int(accumulate), torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, rc)
    launches += 1
    return table


def row_scatter_add_(table: torch.Tensor, idx: torch.Tensor,
                     src: torch.Tensor) -> torch.Tensor:
    """``table[idx[i]] += src[i]`` in place: the plain version for CPU
    tensors, the kernel for CUDA tensors."""
    if not table.is_cuda:
        return row_scatter_add_plain_(table, idx, src)
    return row_scatter_cuda_(table, idx, src)


def row_scatter_add(table_shape: Sequence[int], idx: torch.Tensor,
                    src: torch.Tensor) -> torch.Tensor:
    """``out [*table_shape]`` with ``out[d] = Σ_{idx[i] = d} src[i]``."""
    if not src.is_cuda:
        return row_scatter_add_plain(table_shape, idx, src)
    table = torch.empty(tuple(table_shape), dtype=src.dtype, device=src.device)
    return row_scatter_cuda_(table, idx, src, accumulate=False)


class _GatherRows(torch.autograd.Function):
    """``table[idx]``, whose gradient scatters back by :func:`row_scatter_add`
    (in place of indexing's own backward)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_shape = table.shape
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        shape = ctx.table_shape
        dtable = row_scatter_add(shape, idx.reshape(-1), g.reshape(-1, *shape[1:]))
        return dtable, None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for an int32 or int64 ``idx`` of any shape:
    ``[*idx.shape, *table.shape[1:]]``, differentiable in ``table``."""
    if not (torch.is_grad_enabled() and table.requires_grad):
        return table[idx]
    return _GatherRows.apply(table, idx)
