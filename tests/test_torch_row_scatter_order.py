"""The row scatter's summation order, on the CPU.

The card's kernel (``dmlc_tpu_torch/csrc/row_scatter.cu``) sums each table
row's entries in a fixed order: the entries sorted stably by row id, the
sorted order cut into 32-entry chunks, a run inside one chunk summed entry
by entry, a longer one as its first chunk's tail partial, the partials of
the chunks inside it and its last chunk's head partial (the order of the
kernel's first, table-driven version, kept through its redesign).
``row_scatter_add_ordered_plain`` is the plain-torch version of that order,
which ``chip_smoke.py`` holds the kernel to bit for bit. Here:

- it equals, bit for bit, ``_kernel_model``: a line-by-line transcription
  of the kernel's two launches in float32 scalars (each chunk's runs and
  partials, then the runs that span chunks), over runs of 1, 31, 32, 33 and 100 entries, a sink run
  of a quarter of the entries, ids outside ``[0, D)`` on both sides, rows
  ``()``, ``(8,)`` and ``(16, 16)``, and both ``accumulate`` settings with
  a -0.0 word in a touched and in an untouched row; and at the bcoo
  forward's pattern (ten row-ordered ids a row into ``[rows, 1]``, a pad
  tail of an eighth of the entries on the last row);
- it agrees with the JAX package's ``.at[idx].add`` within 1e-5 relative
  (float32 sums in another order);
- on small-integer-valued floats, where every order is exact, it equals
  ``index_add_`` bit for bit;
- the sort key puts an id outside ``[0, D)`` after every row, as the
  kernel's counting sort does;
- the row scatter of ``val * g``, the candidate for K1's ``dw`` above
  ``DW_MAX_TABLE`` that ``chip_smoke.py`` times against that route
  (``index_add_``, which it kept), equals ``jax.grad`` through the Pallas
  VJP in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlc_tpu.ops.pallas_sparse import _ell_matvec_pallas_ad
from dmlc_tpu_torch.ops import row_scatter as rs
from dmlc_tpu_torch.ops.ell_matvec import DW_MAX_TABLE, dw_route

CHUNK = 32


def _kernel_model(rows, idx, src, table=None):
    """The kernel's arithmetic, transcribed: ``src [N, R]`` float32,
    ``table [D, R]`` or None (accumulate False). Returns ``[D, R]``."""
    f32 = np.float32
    n, width = src.shape
    keys = np.where((idx < 0) | (idx >= rows), rows, idx)
    perm = np.argsort(keys, kind="stable")
    srt = keys[perm]
    out = np.zeros((rows, width), f32) if table is None else table.copy()
    chunks = -(-n // CHUNK)
    head = np.full((chunks, width), np.nan, f32)
    tail = np.full((chunks, width), np.nan, f32)

    def write_row(d, col, acc):
        if 0 <= d < rows:
            out[d, col] = acc if table is None else f32(out[d, col] + acc)

    for c in range(chunks):  # launch 1: chunk_runs
        lo, hi = c * CHUNK, min(c * CHUNK + CHUNK, n)
        for col in range(width):
            cur = srt[lo]
            head_run = lo > 0 and srt[lo - 1] == cur
            goes_on = hi < n and srt[hi] == srt[hi - 1]
            acc = f32(0.0)
            for j in range(lo, hi):
                if srt[j] != cur:
                    if head_run:
                        head[c, col] = acc
                    else:
                        write_row(cur, col, acc)
                    head_run, cur, acc = False, srt[j], f32(0.0)
                acc = f32(acc + src[perm[j], col])
            if goes_on:
                tail[c, col] = acc
            if head_run:
                head[c, col] = acc
            elif not goes_on:
                write_row(cur, col, acc)
    for c in range(chunks):  # launch 2: long_runs
        lo, hi = c * CHUNK, c * CHUNK + CHUNK
        if hi >= n:
            continue
        d = srt[hi - 1]
        if srt[hi] != d or (lo > 0 and srt[lo - 1] == d) or not 0 <= d < rows:
            continue
        last = c + 1
        while last + 1 < chunks and srt[(last + 1) * CHUNK] == d:
            last += 1
        for col in range(width):
            acc = tail[c, col]
            for k in range(c + 1, last):
                acc = f32(acc + tail[k, col])
            write_row(d, col, f32(acc + head[last, col]))
    return out


def _case(rng, rows, row, runs, sink=False, outside=False, integer=False):
    """Ids with a run of each length in ``runs`` on rows 1, 3, ..., a
    sprinkle on the rows after them (row 0 gets nothing), optionally the
    last row as a sink holding a quarter of the entries and ids outside
    ``[0, rows)`` (negative and past the end), in a shuffled order; and
    their ``src`` rows."""
    ids = [np.full(length, 1 + 2 * i) for i, length in enumerate(runs)]
    ids.append(rng.integers(2 * len(runs) + 1, rows - 1, size=rows // 2))
    if outside:
        ids.append(np.array([-1, -7, rows, rows + 3, -1, rows]))
    idx = np.concatenate(ids)
    if sink:
        idx = np.concatenate([idx, np.full(len(idx) // 3, rows - 1)])
    idx = rng.permutation(idx).astype(np.int64)
    shape = (len(idx), *row)
    src = (rng.integers(-4, 5, size=shape) if integer else rng.normal(size=shape))
    return idx, src.astype(np.float32)


CASES = [  # (runs, sink, outside)
    ((1, 31, 32, 33, 100), False, False),
    ((1, 31, 32, 33, 100), True, False),
    ((33, 100, 31), True, True),
    ((64, 65, 2), False, True),
]


def _table(rng, rows, row):
    """A base table with a -0.0 word in row 0 (no entry hits it) and in
    row 1 (the run of one entry)."""
    table = rng.normal(size=(rows, *row)).astype(np.float32)
    flat = table.reshape(rows, -1)
    flat[0, 0] = flat[1, 0] = np.float32(-0.0)
    return table


@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("row", [(), (8,), (16, 16)])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_ordered_plain_equals_kernel_model(case, row, accumulate):
    runs, sink, outside = CASES[case]
    rng = np.random.default_rng(100 * case + len(row))
    rows = 2 * len(runs) + 40
    idx, src = _case(rng, rows, row, runs, sink, outside)
    table = _table(rng, rows, row) if accumulate else None
    got = rs.row_scatter_add_ordered_plain(
        (rows, *row), torch.from_numpy(idx), torch.from_numpy(src),
        None if table is None else torch.from_numpy(table))
    want = _kernel_model(rows, idx, src.reshape(len(idx), -1),
                         None if table is None else table.reshape(rows, -1))
    assert got.shape == (rows, *row)
    assert got.numpy().reshape(rows, -1).tobytes() == want.tobytes()
    if accumulate:  # the untouched -0.0 word stays -0.0
        assert np.signbit(got.numpy().reshape(rows, -1)[0, 0])


@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("rows", [64, 200])
def test_ordered_plain_equals_kernel_model_on_the_bcoo_forward(rows, accumulate):
    """The bcoo forward's scatter (``coo_matmul`` on an unordered batch):
    ten ids a row in row order into ``[rows, 1]``, the last eighth of the
    entries the nnz bucket's tail on the pad row (a run across chunks)."""
    rng = np.random.default_rng(rows)
    idx = np.repeat(np.arange(rows), 10).astype(np.int64)
    src = rng.normal(size=(len(idx), 1)).astype(np.float32)
    tail = len(idx) // 8
    idx[-tail:] = rows - 1
    src[-tail:] = 0.0
    table = _table(rng, rows, (1,)) if accumulate else None
    got = rs.row_scatter_add_ordered_plain(
        (rows, 1), torch.from_numpy(idx), torch.from_numpy(src),
        None if table is None else torch.from_numpy(table))
    want = _kernel_model(rows, idx, src, None if table is None else table.reshape(rows, -1))
    assert got.numpy().reshape(rows, -1).tobytes() == want.tobytes()


@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("row", [(), (8,), (16, 16)])
def test_ordered_plain_matches_jax_scatter(row, accumulate):
    rng = np.random.default_rng(7 + len(row))
    rows = 50
    idx, src = _case(rng, rows, row, (1, 31, 32, 33, 100), sink=True, outside=True)
    table = _table(rng, rows, row) if accumulate else np.zeros((rows, *row), np.float32)
    keep = (idx >= 0) & (idx < rows)  # JAX wraps a negative id: outsiders add nothing
    want = jnp.asarray(table).at[jnp.asarray(idx[keep])].add(jnp.asarray(src[keep]))
    got = rs.row_scatter_add_ordered_plain(
        (rows, *row), torch.from_numpy(idx.astype(np.int32)), torch.from_numpy(src),
        torch.from_numpy(table) if accumulate else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("row", [(), (8,), (16, 16)])
def test_ordered_plain_bit_equal_to_index_add_on_integers(row, accumulate):
    rng = np.random.default_rng(3 + len(row))
    rows = 60
    idx, src = _case(rng, rows, row, (1, 31, 32, 33, 100), sink=True, integer=True)
    base = (rng.integers(-8, 9, size=(rows, *row)).astype(np.float32) if accumulate
            else np.zeros((rows, *row), np.float32))
    want = torch.from_numpy(base.copy()).index_add_(0, torch.from_numpy(idx),
                                                    torch.from_numpy(src))
    got = rs.row_scatter_add_ordered_plain(
        (rows, *row), torch.from_numpy(idx), torch.from_numpy(src),
        torch.from_numpy(base) if accumulate else None)
    assert got.numpy().tobytes() == want.numpy().tobytes()
    if not accumulate:
        assert torch.equal(got, rs.row_scatter_add((rows, *row), torch.from_numpy(idx),
                                                   torch.from_numpy(src)))


def test_ordered_plain_empty_and_all_outside():
    src = torch.ones((3, 2))
    table = torch.full((4, 2), -0.0)
    for idx in (torch.tensor([-1, 4, 9]), torch.tensor([4, 4, 4], dtype=torch.int32)):
        got = rs.row_scatter_add_ordered_plain((4, 2), idx, src)
        assert torch.equal(got, torch.zeros(4, 2))
        kept = rs.row_scatter_add_ordered_plain((4, 2), idx, src, table)
        assert torch.signbit(kept).all()
    empty = rs.row_scatter_add_ordered_plain((4, 2), torch.zeros(0, dtype=torch.int64),
                                             torch.zeros((0, 2)))
    assert torch.equal(empty, torch.zeros(4, 2))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_sort_key_puts_outsiders_after_every_row(dtype):
    idx = torch.tensor([3, -1, 0, 7, 5, -9, 2 ** 31 - 1 if dtype == torch.int32 else 2 ** 40],
                       dtype=dtype)
    keys = rs._sort_keys(idx, 5)
    assert keys.dtype == dtype
    assert keys.tolist() == [3, 5, 0, 5, 5, 5, 5]


@pytest.mark.parametrize("b,k,w", [(64, 8, DW_MAX_TABLE + 1), (96, 10, 20_011)])
def test_wide_dw_by_row_scatter_matches_pallas_vjp(b, k, w):
    # the candidate for K1's dw above DW_MAX_TABLE that chip_smoke.py's
    # row_scatter_ab times against the route there (index_add_)
    assert dw_route(w) == "index_add"
    rng = np.random.default_rng(w)
    table = rng.normal(size=w).astype(np.float32)
    table[-1] = 0.0
    idx = rng.integers(0, w - 1, size=(b, k)).astype(np.int32)
    idx[:, :3] = rng.integers(0, 5, size=(b, 3))  # hot ids: runs of many entries
    val = rng.normal(size=(b, k)).astype(np.float32)
    pad = rng.random((b, k)) < 0.25
    idx[pad], val[pad] = w - 1, 0.0
    g = rng.normal(size=b).astype(np.float32)

    def f(tw):
        return jnp.sum(_ell_matvec_pallas_ad(tw, jnp.asarray(idx), jnp.asarray(val), True) * g)

    want = np.asarray(jax.grad(f)(jnp.asarray(table)))
    flat_idx = torch.from_numpy(idx).flatten()
    prod = (torch.from_numpy(val) * torch.from_numpy(g)[:, None]).flatten()
    for got in (rs.row_scatter_add((w,), flat_idx, prod),
                rs.row_scatter_add_ordered_plain((w,), flat_idx, prod)):
        assert got.shape == (w,)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
