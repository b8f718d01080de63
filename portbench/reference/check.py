"""The numbers that decide ``correct``, each the gap between the program's
reading and the reference's, and the comparison with their limits. A cell
compares every number its ``limits`` name with a limit that is not null;
the learner's module (``learners/<model>.py``) says which numbers it
reads. The harness reads the feed's two for every cell; the FM learner
adds the three step gaps below.

- ``feed_mismatch``: ids, labels and weights of the compared batches that
  differ from the reference's parse (each row's entries sorted by id and
  value: the FM sum does not depend on their order). Exact: limit 0. In
  ragged (CSR) batches a row whose length differs from the reference's
  counts the larger row's entries.
- ``feed_value_gap``: the largest ``|value - reference| / max(|reference|, 1)``.
- ``loss_gap``: the largest ``|loss - reference| / |reference|`` over the
  followed steps.
- ``grad_norm_gap`` and ``change_norm_gap``: for each leaf (``w0``, ``w``,
  ``V``) the gap between the program's norm and the reference's, over the
  larger of the reference's norm of that leaf and of the median leaf; the
  worst leaf. A leaf whose first gradient in the reference is under a
  thousandth of the median leaf's moves under Adam by rounding alone, and
  is left out of ``change_norm_gap``."""

from __future__ import annotations

import statistics

import numpy as np


def _canonical(ids: np.ndarray, vals: np.ndarray):
    order = np.lexsort((vals, ids), axis=1)
    return np.take_along_axis(ids, order, 1), np.take_along_axis(vals, order, 1)


def feed_gaps(program: list, reference: list) -> dict:
    """``feed_mismatch`` and ``feed_value_gap`` over pairs of batches."""
    mismatch, value_gap = 0, 0.0
    for (pi, pv, pl, pw), (ri, rv, rl, rw) in zip(program, reference):
        if pi.shape != ri.shape:
            mismatch += max(pi.size, ri.size)
            continue
        pi, pv = _canonical(pi.astype(np.int64), pv.astype(np.float32))
        ri, rv = _canonical(ri.astype(np.int64), rv.astype(np.float32))
        mismatch += int((pi != ri).sum() + (pl != rl).sum() + (pw != rw).sum())
        gap = np.abs(pv.astype(np.float64) - rv) / np.maximum(np.abs(rv), 1.0)
        value_gap = max(value_gap, float(gap.max(initial=0.0)))
    return {"feed_mismatch": mismatch, "feed_value_gap": value_gap}


def _csr_canonical(offsets: np.ndarray, ids: np.ndarray, vals: np.ndarray):
    """Each row's entries sorted by id and value, rows in order."""
    row = np.repeat(np.arange(len(offsets) - 1), np.diff(offsets))
    order = np.lexsort((vals, ids, row))
    return ids[order], vals[order]


def feed_gaps_csr(program: list, reference: list) -> dict:
    """``feed_mismatch`` and ``feed_value_gap`` over pairs of ragged
    batches ``(offsets, ids, values, label, weight)``: rows of equal length
    compared entry by entry, each row of another length counted whole."""
    mismatch, value_gap = 0, 0.0
    for (po, pi, pv, pl, pw), (ro, ri, rv, rl, rw) in zip(program, reference):
        if len(po) != len(ro):
            mismatch += max(pi.size, ri.size) + max(pl.size, rl.size)
            continue
        plen, rlen = np.diff(po), np.diff(ro)
        same = plen == rlen
        mismatch += int(np.maximum(plen, rlen)[~same].sum()
                        + (pl != rl).sum() + (pw != rw).sum())
        pi, pv = _csr_canonical(po, pi.astype(np.int64), pv.astype(np.float32))
        ri, rv = _csr_canonical(ro, ri.astype(np.int64), rv.astype(np.float32))
        pi, pv = pi[np.repeat(same, plen)], pv[np.repeat(same, plen)]
        ri, rv = ri[np.repeat(same, rlen)], rv[np.repeat(same, rlen)]
        mismatch += int((pi != ri).sum())
        gap = np.abs(pv.astype(np.float64) - rv) / np.maximum(np.abs(rv), 1.0)
        value_gap = max(value_gap, float(gap.max(initial=0.0)))
    return {"feed_mismatch": mismatch, "feed_value_gap": value_gap}


MOVED = 1e-3  # a leaf moves when its first gradient is at least this share of the median's


def _leaf_gap(program: list, reference: list, keep: list) -> float:
    floor = statistics.median(reference)
    return max(abs(p - r) / max(r, floor) if max(r, floor) > 0 else abs(p - r)
               for p, r, k in zip(program, reference, keep) if k)


def step_gaps(program: dict, reference: dict) -> dict:
    """``loss_gap``, ``grad_norm_gap`` and ``change_norm_gap``."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(program["losses"], reference["losses"]))
    grads = reference["grad_norms"]
    moved = [g >= MOVED * statistics.median(grads) for g in grads]
    return {"loss_gap": loss_gap,
            "grad_norm_gap": _leaf_gap(program["grad_norms"], grads, [True] * len(grads)),
            "change_norm_gap": _leaf_gap(program["change_norms"], reference["change_norms"],
                                         moved)}


def compared(limits: dict) -> list:
    """The numbers a cell compares, in the order its ``limits`` give them:
    those whose limit is not null. A number whose control and faults all
    read as its sound runs do has no upper reading, and a cell leaves it
    uncompared (PERF.md names it)."""
    return [name for name, limit in limits.items() if limit is not None]


def verdict(readings: dict, limits: dict) -> bool:
    """True when every compared reading is within its limit (a missing or
    non-finite reading fails)."""
    return all(name in readings and np.isfinite(readings[name])
               and readings[name] <= limits[name] for name in compared(limits))
