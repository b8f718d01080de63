"""The frozen arithmetic: the card's published peaks and the bytes and
operations a step and its row scatter need. Later changes to the program
leave this file alone, so that their numbers stay comparable.

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit:
3.35 TB/s of HBM3, 67 TFLOP/s of float32 outside the tensor cores. A card
set below 700 W reaches less; the result line carries its power limit."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
F32 = 4


def param_count(num_col: int, factors: int) -> int:
    """P: ``w0``, and ``w`` and ``V`` over ``num_col`` columns plus the
    padding sink row: ``(num_col + 1) * (1 + factors) + 1`` floats."""
    return (num_col + 1) * (1 + factors) + 1


def batch_bytes(batch: int, k: int) -> int:
    """One ELL batch's slots: int32 ids and float32 values ``[B, K]``, and
    float32 label and weight ``[B]``."""
    return batch * k * 2 * F32 + batch * 2 * F32


def step_bytes(num_col: int, factors: int, batch: int, k: int) -> int:
    """The least bytes an FM step with Adam moves: the parameters,
    ``exp_avg`` and ``exp_avg_sq`` each read once and written once
    (6 x 4 B x P), and the batch read once. The dense gradient is an
    intermediate and not counted."""
    return 6 * F32 * param_count(num_col, factors) + batch_bytes(batch, k)


def step_ops(num_col: int, factors: int, batch: int, k: int) -> int:
    """float32 operations of a step: 12 an element for Adam (two moment
    updates, the square root, the bias corrections, the division and the
    update), and for each of the batch's slots 4 an element of its
    ``1 + factors`` gathered words forward and 8 backward."""
    return 12 * param_count(num_col, factors) + 12 * batch * k * (1 + factors)


def least_seconds(nbytes: int, ops: int) -> float:
    """The bytes at the memory rate or the operations at the float32 rate,
    whichever takes longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S)


def row_scatter_bytes(batch: int, k: int, hit_rows: float, n_row: int) -> float:
    """The least bytes of one row scatter of ``batch * k`` entries of
    ``n_row`` words: each entry's int32 id and its ``n_row`` float32 source
    words read once, and each of the ``hit_rows`` distinct rows the entries
    name written once with its sum: ``b*k*(4 + 4*n_row) + hit_rows*n_row*4``.
    The rows no entry names are not counted: the gradient table they lie in
    is an intermediate (as in :func:`step_bytes`), and zeroing it whole is
    one way of building it, not work the scatter needs. Nor is a sort
    permutation: it is one way of grouping the entries by row."""
    return batch * k * (F32 + F32 * n_row) + hit_rows * n_row * F32


def step_row_scatter_bytes(factors: int, batch: int, k: int, hit_rows: float) -> float:
    """An FM step's two row scatters over the same ids: ``w``'s gradient
    (one word a row) and ``V``'s (``factors`` words), each writing the
    ``hit_rows`` rows the batch names."""
    return (row_scatter_bytes(batch, k, hit_rows, 1)
            + row_scatter_bytes(batch, k, hit_rows, factors))


def widen_span_bytes(batch: int, k: int) -> int:
    """Kernel K2 decoding one warm ELL batch: its float32 values ``[B, K]``
    read from the raw span and written once (the int32 ids, the label and
    the weight are views of the span, which the kernel does not touch):
    ``2 * B * K * 4``."""
    return 2 * batch * k * F32
