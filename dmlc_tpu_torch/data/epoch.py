"""Deterministic epoch planner: shuffled, pod-sharded, resumable warm epochs.

Own copy of the JAX package's ``data/epoch.py`` (numpy only; the port
imports nothing of that package). Every order is a pure function of ``(seed, epoch)``:

- :func:`block_permutation`: the seeded visitation order of the cached
  block indices for one epoch;
- :func:`row_permutation`: a windowed intra-block row shuffle whose rng is
  keyed by ``(seed, epoch, block_index)``, so any block's row order is
  computable without streaming its predecessors (what mid-epoch resume
  and pod sharding rely on);
- :class:`EpochPlan`: one epoch's plan for one host, its disjoint
  round-robin shard of the global permutation plus the row orders.

Each decision draws from a ``numpy.random.Generator`` over a
counter-based :class:`numpy.random.Philox` stream whose 128-bit key is
built from ``(seed, domain, epoch[, block_index])``; no rng object is
carried across blocks, epochs or hosts. Two processes, or two packages,
that agree on ``(seed, epoch, num_blocks, num_hosts)`` agree on every
byte of the epoch.

Pod sharding deals the global permutation round-robin
(``order[host_id::num_hosts]``): the shards are disjoint, their union is
the epoch, and their sizes differ by at most one block. ``host_id`` /
``num_hosts`` come from
:func:`dmlc_tpu_torch.parallel.distributed.pod_identity`.

Consumed by :class:`dmlc_tpu_torch.data.parsers.BlockCacheIter` (warm
epochs in plan order, behind ``create_parser``'s ``shuffle_seed`` /
``shuffle_window`` / ``pod_sharding``) and by ``DeviceIter``'s
``snapshot_shuffle_seed`` (the same permutation over stored snapshot
batches, ``unit="batch"``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from dmlc_tpu_torch.data.row_block import RowBlock
from dmlc_tpu_torch.utils.check import check

_MASK64 = (1 << 64) - 1
_MASK32 = (1 << 32) - 1
# domain tag of the block-permutation stream in the key's high word —
# row streams put the epoch there, so the two can only collide at
# epoch == 2**32 - 1 (epochs are checked below that)
_BLOCK_DOMAIN = _MASK32


def _rng(seed: int, hi: int, lo: int) -> np.random.Generator:
    """Generator over a Philox stream keyed by ``(seed, hi, lo)``.

    Philox keys are 2x64 bits: word 0 carries the seed, word 1 packs
    ``hi``/``lo`` as two 32-bit halves. Counter-based, so construction is
    O(1) — the planner builds one throwaway generator per decision.
    """
    key = np.array([seed & _MASK64,
                    ((hi & _MASK32) << 32) | (lo & _MASK32)],
                   dtype=np.uint64)
    return np.random.Generator(np.random.Philox(key=key))


def block_permutation(seed: int, epoch: int, num_blocks: int) -> np.ndarray:
    """The epoch's global visitation order of cached block indices —
    a seeded permutation of ``arange(num_blocks)``, a pure function of
    ``(seed, epoch)``."""
    check(0 <= epoch < _MASK32, f"epoch {epoch} out of the planner's range")
    if num_blocks <= 1:
        return np.arange(max(0, int(num_blocks)), dtype=np.int64)
    return _rng(seed, _BLOCK_DOMAIN, epoch).permutation(
        int(num_blocks)).astype(np.int64, copy=False)


def row_permutation(seed: int, epoch: int, block_index: int, rows: int,
                    window: int) -> Optional[np.ndarray]:
    """The windowed intra-block row order of one block, or ``None`` for
    identity (``window <= 1`` disables the row shuffle — the epoch then
    shuffles at block granularity only).

    Rows are shuffled within consecutive windows of ``window`` rows
    (``window >= rows`` = a full-block shuffle), so the shuffle quality /
    memory-locality trade-off is one knob, exactly tf.data's
    ``shuffle(buffer_size)`` dial. The rng is keyed by
    ``(seed, epoch, block_index)``: block k's order never depends on
    blocks 0..k-1 having been streamed.
    """
    check(0 <= epoch < _MASK32, f"epoch {epoch} out of the planner's range")
    if window <= 1 or rows <= 1:
        return None
    rng = _rng(seed, epoch, block_index)
    if window >= rows:
        return rng.permutation(int(rows)).astype(np.int64, copy=False)
    perm = np.arange(int(rows), dtype=np.int64)
    for start in range(0, int(rows), int(window)):
        rng.shuffle(perm[start:start + int(window)])
    return perm


def uniform_column_pattern(block: RowBlock) -> bool:
    """True when every row has the SAME feature-column pattern (identical
    nnz AND identical ``index``/``field`` entries row for row) — the
    dense-text common case (HIGGS/Criteo-like corpora). Such a block's
    nnz-id arrays are invariant under any row permutation, so
    :func:`permute_block_rows` can skip their gathers entirely — they are
    the widest arrays (uint64), so this removes ~2/3 of the shuffle's
    copy traffic. One read-only ufunc pass; callers memoize per block."""
    n = len(block)
    if n <= 1:
        return True
    nnz = np.diff(block.offset)
    if int(nnz.min()) != int(nnz.max()):
        return False
    k = int(nnz[0])
    if k == 0:
        return True
    idx2d = block.index.reshape(n, k)
    if not np.array_equal(idx2d, np.broadcast_to(idx2d[0], idx2d.shape)):
        return False
    if block.field is not None:
        f2d = block.field.reshape(n, k)
        return bool(np.array_equal(f2d, np.broadcast_to(f2d[0], f2d.shape)))
    return True


def permute_block_rows(block: RowBlock, perm: np.ndarray,
                       uniform_columns: bool = False) -> RowBlock:
    """A new RowBlock whose row ``i`` is ``block[perm[i]]`` — one
    vectorized CSR gather (no per-row Python loop). Gathered arrays own
    fresh memory, which is deliberate: a shuffled warm block is
    materialized off the cache mmap inside the caller's timed
    ``cache_read`` region, so permuted-pattern page faults are attributed
    to the cache, not to whichever later stage first touched the views.

    ``uniform_columns=True`` is the caller's assertion (via
    :func:`uniform_column_pattern`, typically memoized) that every row's
    index/field pattern is identical — those arrays then pass through
    un-gathered (they are permutation-invariant), keeping the shuffle's
    copy cost to the value/label arrays.
    """
    check(len(perm) == len(block), "permute_block_rows: perm/rows mismatch")
    offset = block.offset
    nnz = np.diff(offset)
    new_offset = np.zeros(len(perm) + 1, np.int64)
    np.cumsum(nnz[perm], out=new_offset[1:])
    if len(nnz) and int(nnz.min()) == int(nnz.max()):
        # uniform rows (the dense-corpus common case): the nnz gather is
        # an axis-0 np.take over the (n, k) view, with no gather index
        # to build as the ragged branch below does
        k = int(nnz[0])

        def g(arr):
            return np.take(arr.reshape(len(perm), k), perm,
                           axis=0).reshape(-1)
    else:
        uniform_columns = False  # ragged rows always gather
        # source position of each nnz entry: row r's span starts at
        # offset[perm[r]] and lands at new_offset[r]
        gather = (np.repeat(offset[:-1][perm] - new_offset[:-1], nnz[perm])
                  + np.arange(int(new_offset[-1]), dtype=np.int64))

        def g(arr):
            return np.take(arr, gather)

    def g_ids(arr):
        return arr if uniform_columns else g(arr)

    return RowBlock(
        offset=new_offset,
        label=block.label[perm],
        index=g_ids(block.index),
        value=g(block.value) if block.value is not None else None,
        weight=block.weight[perm] if block.weight is not None else None,
        qid=block.qid[perm] if block.qid is not None else None,
        field=g_ids(block.field) if block.field is not None else None,
        hold=block.hold,
    )


def plan_state_dict(seed: Optional[int], window: int, epoch: int, pos: int,
                    host_id: int, num_hosts: int,
                    unit: str = "block") -> dict:
    """THE ``kind='epoch_plan'`` resume-annotation shape — ``(seed,
    epoch, plan position)`` plus the sharding identity, made here alone:
    delivered-block annotations (:meth:`EpochPlan.state`), checkpoint
    states, and the sharded-cold wrapping all come through here, so the
    shape cannot drift between producers
    (``BlockCacheIter._load_plan_state`` adopts every field).

    ``unit`` names what the plan permutes: ``'block'`` (the block cache's
    cached parser blocks — the default, omitted from the state so
    pre-existing checkpoints stay byte-identical) or ``'batch'`` (the
    device-native snapshot store's fixed-geometry batches,
    :mod:`dmlc_tpu_torch.io.snapshot` — the SAME permutation machinery one tier
    up, consumed by ``DeviceIter``'s ``snapshot_shuffle_seed``). The two
    streams' positions are not interchangeable, so each consumer rejects
    the other's unit loudly instead of restoring a wrong position."""
    state = {"kind": "epoch_plan",
             "seed": None if seed is None else int(seed),
             "window": int(window), "epoch": int(epoch), "pos": int(pos),
             "host_id": int(host_id), "num_hosts": int(num_hosts)}
    if unit != "block":
        state["unit"] = str(unit)
    return state


class EpochPlan:
    """One epoch's deterministic serving plan for one host.

    ``seed=None`` plans a *sequential* epoch (identity order, no row
    shuffle) — the degenerate plan pod sharding without shuffling rides
    on. ``num_hosts > 1`` restricts :attr:`order` to this host's
    round-robin shard of the global order; the shards of one
    ``(seed, epoch)`` are disjoint and union to the whole epoch.
    """

    __slots__ = ("seed", "epoch", "num_blocks", "num_hosts", "host_id",
                 "window", "_order")

    def __init__(self, seed: Optional[int], epoch: int, num_blocks: int,
                 num_hosts: int = 1, host_id: int = 0, window: int = 0):
        check(num_hosts >= 1, "EpochPlan: num_hosts must be >= 1")
        check(0 <= host_id < num_hosts,
              f"EpochPlan: host_id {host_id} not in [0, {num_hosts})")
        self.seed = None if seed is None else int(seed)
        self.epoch = int(epoch)
        self.num_blocks = int(num_blocks)
        self.num_hosts = int(num_hosts)
        self.host_id = int(host_id)
        self.window = int(window)
        self._order: Optional[np.ndarray] = None

    @property
    def order(self) -> np.ndarray:
        """This host's block visitation order (read-only)."""
        if self._order is None:
            if self.seed is None:
                full = np.arange(self.num_blocks, dtype=np.int64)
            else:
                full = block_permutation(self.seed, self.epoch,
                                         self.num_blocks)
            order = full[self.host_id::self.num_hosts]
            order.flags.writeable = False
            self._order = order
        return self._order

    def __len__(self) -> int:
        return len(self.order)

    @property
    def permuted(self) -> bool:
        """True when blocks serve out of sequential order (a seeded
        permutation is armed) — the signal for materializing mmap views
        inside the ``cache_read`` stage."""
        return self.seed is not None and self.num_blocks > 1

    def block_at(self, pos: int) -> int:
        """Cache block index at local plan position ``pos``."""
        return int(self.order[pos])

    def row_order(self, block_index: int, rows: int) -> Optional[np.ndarray]:
        """The intra-block row order of ``block_index`` (None = identity).
        Keyed by ``(seed, epoch, block_index)`` — host-independent, so
        sharded and unsharded serves of one block are byte-identical."""
        if self.seed is None:
            return None
        return row_permutation(self.seed, self.epoch, block_index, rows,
                               self.window)

    def state(self, pos: int) -> dict:
        """The resume annotation for plan position ``pos`` — everything a
        fresh pipeline needs to replay the stream byte-identically
        (``BlockCacheIter.load_state`` adopts these fields wholesale)."""
        return plan_state_dict(self.seed, self.window, self.epoch, pos,
                               self.host_id, self.num_hosts)
