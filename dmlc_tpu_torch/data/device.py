"""Async host->device batch pipeline — ``DeviceIter``.

The PyTorch counterpart of the JAX package's ``data/device.py`` for the
``dense``, ``ell`` and ``bcoo`` layouts. Parsed RowBlocks are rebatched to
one fixed shape on the host (or, for bcoo, kept as they come), converted to
the device layout into a ring of pinned staging buffers, and copied to the
device ``prefetch`` batches ahead of consumption:

- each batch is copied with ``.to(device, non_blocking=True)`` on a
  dedicated copy stream, and a per-batch ``torch.cuda.Event`` is recorded
  after the copy;
- the consumer's stream waits on that event before the step, and the
  batch's tensors are ``record_stream``-ed onto it, so the caching
  allocator cannot hand their memory out while the step still reads it;
- a staging slot is refilled only after its copy event has completed: a
  pinned buffer rewritten while its async copy is in flight would corrupt
  the batch.

**The convert pool.** A cold epoch runs on an
:class:`~dmlc_tpu_torch.io.threaded_iter.OrderedWorkerPool`, as in the JAX
package. Its serial stage pulls the source's blocks, rebatches them, keeps
the checkpoint annotations and plans bcoo's nnz pads in stream order, and
marks the batches a count restore skips; its parallel stage, on
``convert_workers`` threads (``DMLC_TPU_CONVERT_WORKERS``, default 2),
converts a batch, takes a free staging slot and packs the batch into it.
At most ``convert_ahead`` batches (``DMLC_TPU_CONVERT_AHEAD``, default 4)
are pulled and not yet delivered; the ring holds more slots than that, so
the oldest batch always finds one. Batches are delivered in stream order,
the same bytes at every width. Natural-block bcoo (``batch_size=None``)
keeps one producer thread, as the JAX package does. The ring never
allocates past its depth: a worker waits for a slot (counted as a miss in
``stats()["staging_ring"]``). Its depth can grow while the workers run:
the worker whose acquire finds no free slot and room under the depth
allocates the new pinned slot itself (the consumer never waits on a host
allocation); a smaller depth only stops new slots, and no slot is freed
while the iterator lives (freeing pinned memory synchronizes the device).

Dense batches are :class:`PackedDenseBatch` (one ``[B, num_col + 2]``
slab: features | label | weight) when ``pack_aux`` is on, the default for
float32; ``x_dtype="bfloat16"`` ships the features (and, packed, the
label and weight, which must then be bf16-exact) in bfloat16. At
construction a dense pipeline asks its source for dense blocks
(``set_emit_dense``, as the JAX package does): the fused native reader
then repacks the rows into exact ``batch_size`` blocks in its C++ threads,
packed ``[B, num_col + 2]`` slabs under a float32 ``pack_aux`` (one copy
into the staging slot a batch), bfloat16 features with float32 label and
weight under a bfloat16 one (so that their cast stays checked here); a
registry-stack libsvm or float32 csv parser on the native engine emits
:class:`DenseBlock`s a chunk. The serial stage groups the ``DenseBlock``
and ``RowBlock`` parts of a batch by views and a worker packs them into
the batch's staging slot in one pass (a ``RowBlock`` part densified on the
way); the batches are the same bytes on every route.

``ell`` batches are ``[B, max_nnz]``; without ``max_nnz`` each batch's K
is its longest row's, as in the JAX package, and the batch crosses as one
u8 span (its K changes from batch to batch). A feature id at or past
``num_col`` raises on ``ell`` (its pad id ``num_col`` addresses the sink);
``dense`` drops it, as the JAX package does.

**Snapshot store.** With ``snapshot=`` (or a parser from
``create_parser(..., snapshot=path)``) the first complete epoch
shadow-writes every batch it ships (:mod:`dmlc_tpu_torch.io.snapshot`),
on the consumer's side in delivery order, and later epochs serve them from
the file with no parse and no convert, read on a
:class:`~dmlc_tpu_torch.io.snapshot.SnapshotIter` pool of
``snapshot_read_workers`` threads (``DMLC_TPU_SNAPSHOT_READ_WORKERS``,
default 2) in stored or plan order:

- host decode (default): each batch's segments are read as mmap views,
  copied into pinned staging slots and copied to the device as in a cold
  epoch;
- ``device_decode=True``: each batch's raw container bytes go through one
  pinned u8 staging slot, cross as one async u8 copy, and
  :func:`~dmlc_tpu_torch.ops.device_decode.decode_batch` turns them into
  the batch on the consumer's stream after the copy's event, in one launch
  of kernel K2 (float slabs copied, an int8 slab dequantized, a bfloat16
  packed slab's label and weight widened to float32 in the same pass).

The same flag acts on a data-service snapshot frame (a packed
:class:`~dmlc_tpu_torch.data.row_block.DenseBlock` of exactly
``batch_size`` rows carrying a ``device_span``, from
:class:`~dmlc_tpu_torch.service.client.ServiceParser`), with or without a
snapshot file, as long as no snapshot tee is writing: the frame's
verbatim payload is staged as one u8 span and decoded on the device by
one K2 launch, as a warm batch is. Any other block takes the host copy.

**Counters and stage attribution.** ``stall_seconds`` is the consumer's
time inside ``__next__`` (waiting for the pipeline, issuing copies, and in
device-decode epochs the decode's dispatch, also counted alone in
``device_decode_seconds``); ``host_stall_seconds`` the part of it spent
waiting on the pool; ``input_wait_seconds`` the wait for the batch handed
out, the wait on the pool in the refill behind it (in a steady epoch the
refill is where the consumer waits: the batch it hands out was copied a
call earlier) and the sampled transfer landings — the autotuner's input
wait; ``bytes_to_device`` counts the
bytes copied, ``device_decode_bytes`` those that crossed as raw spans.
``source_wait_seconds`` is the serial stage's time blocked on the parser.
The busy seconds of each stage are ``stats()["stage_busy"]`` (read,
cache_read and parse from the source's own ``stage_seconds()`` during each
pull, else all of the pull as parse; convert the serial stage's own work
and the workers' convert and pack, summed over threads, also
``convert_seconds``; snapshot_read a warm epoch's reads and copies into
staging, also ``snapshot_read_seconds``; dispatch the consumer's copy
issue; device_decode). ``stats()["stages"]`` splits the consumer's wall
(``wall_seconds``, first pull to the last) among them: dispatch and
device_decode as measured, the time blocked on the pipeline over the busy
stages of the same window, scaled down where the threads overlapped, and
``transfer``, every ``transfer_sample``-th batch
(``DMLC_TPU_TRANSFER_SAMPLE``, default 32) a wait on that batch's copy
event (never on a compute stream). Every stage records spans and every
counter is a registry counter under ``pipeline_label``
(:mod:`dmlc_tpu_torch.utils.telemetry`); under a recording
``torch.profiler`` the convert, dispatch and transfer work opens
``dmlc_tpu.*`` ranges, and so does the consumer's wait on the producer in
the refill (``dmlc_tpu.input_wait``); ``DMLC_TPU_TRACE=chrome:<path>`` (or
:meth:`DeviceIter.dump_trace`) exports the spans. ``snapshot_write_seconds``
is the cold epoch's shadow write. A warm epoch adds nothing to
``convert_seconds``.

**Checkpoints.** :meth:`DeviceIter.state_dict` is the JAX package's state,
key for key. Each batch carries the annotation of the last source block
boundary it crossed, ``{"source": <the parser's state there>, "skip_rows":
<rows of the batch past it>}``; a state is ``{"kind": "source", "batches":
n, **annotation}`` once a delivered batch has one, else ``{"kind":
"batches", "batches": n}``. :meth:`~DeviceIter.load_state` seeks the source
for a ``source`` state and drops the rows into the block, or replays a
``batches`` count on the producer, which skips that many batches without
converting or copying them; the batches in flight at the checkpoint are
dropped. With a snapshot the cold shadow write stores each batch's
annotation as its ``resume`` entry, and a state of at most the stored
batch count restores into warm serving at that batch (a cold state into a
warm pipeline, a warm one into a cold pipeline, the same bytes); a larger
one restores cold, aborting the shadow writer and serving cold until the
next :meth:`~DeviceIter.reset`. A state taken in either package restores
in the other.

**Shuffled snapshot epochs.** ``snapshot_shuffle_seed`` serves each warm
snapshot epoch in the epoch planner's order over the stored batches,
``block_permutation(seed, epoch, num_batches)``
(:mod:`dmlc_tpu_torch.data.epoch`), the epoch advancing at each
:meth:`~DeviceIter.reset` that follows a delivered batch. Such a batch's
annotation is ``{"source": plan_state_dict(seed, 0, epoch, pos, 0, 1,
unit="batch"), "skip_rows": 0}``, ``pos`` the plan position after it; a
state of that shape restores the plan (seed and epoch included) at that
position, and a snapshot that has vanished is first rebuilt by one silent
cold pass (the same batches, byte for byte). A sequential state restored
into a shuffled pipeline serves the rest of its epoch in stored order. A
*block*-plan state (the block cache's ``epoch_plan``, no ``unit``) goes to
the source, which replays its plan; the snapshot then sits out the rest of
the epoch. A source whose ``plan_state`` has a seed is refused under
``snapshot=``: the snapshot freezes one epoch's order.

**Healing.** A retryable error that reaches the consumer
(:func:`~dmlc_tpu_torch.io.resilience.classify`) re-arms the pipeline at
the batch after the last one delivered, through
``load_state(state_dict())`` as in the JAX package: a seek where the
annotation allows, a replay by count otherwise, within the restart budget
(:mod:`dmlc_tpu_torch.io.resilience`: ``max_attempts - 1`` restarts an
epoch, ``DMLC_RETRY_MAX_ATTEMPTS``, default 4) and after the policy's
backoff. A warm batch that fails its crc32 first removes the file, so the
epoch goes on cold (no backoff: there is nothing to wait for).
``stats()["resilience"]["pipeline_restarts"]`` counts the restarts; past
the budget, or for a fatal error, the error propagates. The next epoch runs
cold and writes the snapshot anew.

**Autotuning.** ``autotune=True`` (or ``DMLC_TPU_AUTOTUNE=1``) arms the
online autotuner (:mod:`dmlc_tpu_torch.data.autotune`): at each
:meth:`~DeviceIter.reset` after a delivered batch, and every
``autotune_interval`` delivered batches (``DMLC_TPU_AUTOTUNE_INTERVAL``,
default 0: epoch boundaries only), one controller step reads the window's
registry counters (busy seconds by stage, the input wait, the sampled
transfer wall, the resilience events and this iterator's lifetime restart
tally) and may move one knob: ``prefetch`` and ``convert_ahead`` always,
``parse_workers`` and ``plan_read_workers`` where the source chain can
resize them, ``snapshot_read_workers`` under a snapshot.
``convert_workers`` stays as built (one knob a stage: convert pressure
grows ``convert_ahead``, as in the JAX package). A knob that widens a
window raises the staging ring's depth first. A step reads counters and
clocks only: it never waits on the card. The batches are the same,
whatever the knobs do. ``stats()["autotune"]`` is the controller's
:meth:`~dmlc_tpu_torch.data.autotune.AutoTuner.snapshot`, None when it is
not armed.

**bcoo.** ``layout="bcoo"`` batches are ``(x, label, weight)`` with ``x`` a
torch sparse COO tensor ``[rows, num_col]`` on the device (pad scheme in
:mod:`dmlc_tpu_torch.ops.sparse`): a fixed ``batch_size``, with nnz padded
to multiples of ``nnz_bucket`` (planned in stream order, so the tail batch
pads into a shape already emitted), or natural blocks (``batch_size=None``,
rows rounded up to ``row_bucket``). A batch's coordinates, values, label
and weight cross as one u8 span, pad slots included, so transfer sizes
repeat; on the device ``x`` is built on views of the real entries only
(the count is the host's, no device read). An id at or past ``num_col``
becomes a value-0 entry at an in-bounds column, as JAX's BCOO masks it.
With ``elide_unit_values`` an all-ones batch ships no values and the card
makes them. Natural blocks from the fused native reader come as
:class:`~dmlc_tpu_torch.data.row_block.CooBlock`s (``set_emit_coo``): the
convert is done in its C++ parse threads, the block crosses as it came,
and the card maps the native pad scheme to the port's
(:func:`~dmlc_tpu_torch.ops.sparse.native_coo_to_port`), rebuilding the
row ids of the CSR wire (``csr_wire``, the default, which needs both
buckets) with :func:`~dmlc_tpu_torch.ops.sparse.csr_coords`. Pad or masked
slots inside ``x`` may share a coordinate, and torch assumes unique
coordinates in a tensor marked coalesced: ``to_dense`` then keeps one of
the duplicates, not their sum. ``x`` is marked coalesced when its real
coordinates are in bounds and in strict row-major order (a host check),
so torch's product takes it as it is; the product of another ``x`` is a
row scatter (:func:`~dmlc_tpu_torch.ops.sparse.coo_matmul`), so no batch
coalesces (a host sync) on the card. ``nnz_shapes`` collects the nnz
capacities the delivered spans had. Snapshots store fixed shapes only and
refuse bcoo.

**Meshes.** With ``mesh=`` (:mod:`dmlc_tpu_torch.parallel`) this rank's
pipeline feeds its slice of each global batch: ``batch_size`` is the
rank's own row count, batches land on the mesh's device for this rank,
and the global batch is the ranks' batches concatenated in rank order (the
JAX package's ``make_array_from_process_local_data`` layout). As there,
bcoo and snapshots are refused under a mesh, and dense batches ship
unpacked (``pack_aux`` off). ``shardings`` (a learner's
``batch_shardings()``) must split every array's rows over the data axis;
a dense ``x`` may also split its columns over a model axis (``(data,
model)``, a feature-sharded ``LinearLearner``'s): the rank then ships its
model coordinate's slice, ``num_col / M`` columns, cut on the host before
the pinned staging, so ``bytes_to_device`` counts only what this rank
copies. The ranks of one model group read the same part and so build the
same batch: under feature sharding each model rank repeats the parse and
the convert of its group's rows, a cost of running one process a rank (a
JAX process feeds all its devices from one pipeline), not a fault.

On a CPU device the same pipeline runs without pinning, streams or events
(the copy is synchronous).
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import threading
import time
from collections import deque
from typing import Iterator, List, Optional

import numpy as np
import torch

from dmlc_tpu_torch.data import autotune as _autotune
from dmlc_tpu_torch.data import epoch as _epoch
from dmlc_tpu_torch.data.row_block import CooBlock, DenseBlock, RowBlock, RowBlockContainer
from dmlc_tpu_torch.io import block_cache as _block_cache
from dmlc_tpu_torch.io import resilience as _resilience
from dmlc_tpu_torch.io import snapshot as _snapshot
from dmlc_tpu_torch.io.block_cache import torch_dtype
from dmlc_tpu_torch.io.threaded_iter import OrderedWorkerPool, ThreadedIter
from dmlc_tpu_torch.ops import device_decode as _device_decode
from dmlc_tpu_torch.ops.device_decode import PackedDenseBatch  # noqa: F401 (re-exported)
from dmlc_tpu_torch.ops.sparse import (EllBatch, block_to_bcoo_host, block_to_dense,
                                       block_to_ell, csr_coords, native_coo_to_port)
from dmlc_tpu_torch.parallel.mesh import rank_device
from dmlc_tpu_torch.store.manager import store_counters
from dmlc_tpu_torch.utils import knobs as _knobs
from dmlc_tpu_torch.utils import telemetry as _telemetry
from dmlc_tpu_torch.utils.check import CacheCorruptionError, DMLCError, check, get_logger
from dmlc_tpu_torch.utils.timer import StageMeter, get_time

_X_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the derived bcoo nnz bucket's ceiling: the bucket is also a batch's worst
# pad, and batch_size * max_nnz is a ceiling, not a density
_NNZ_BUCKET_CAP = 512 * 1024
_SPAN_ALIGN = 64
# batch kinds that cross as one u8 span with no device decode
_SPAN_KINDS = ("bcoo", "bcoo_native", "ell_span")


def rebatch_blocks(blocks: Iterator[RowBlock], batch_size: int,
                   drop_remainder: bool = False) -> Iterator[RowBlock]:
    """Re-slice a stream of variable-size RowBlocks into fixed-size batches.
    The final partial batch is emitted as-is (callers pad it) unless
    ``drop_remainder``."""
    pending = RowBlockContainer()
    pending_rows = 0
    for block in blocks:
        pending.push_block(block)
        pending_rows += len(block)
        if pending_rows >= batch_size:
            merged = pending.to_block()
            pos = 0
            while pos + batch_size <= len(merged):
                yield merged.slice(pos, pos + batch_size)
                pos += batch_size
            pending = RowBlockContainer()
            pending_rows = len(merged) - pos
            if pending_rows:
                pending.push_block(merged.slice(pos, len(merged)))
    if pending_rows and not drop_remainder:
        yield pending.to_block()


def _dense_batches(blocks, batch_size: int, drop_remainder: bool = False):
    """Group a stream of :class:`DenseBlock` and :class:`RowBlock` parts
    into lists of parts of exactly ``batch_size`` rows, by views (``slice``),
    copying nothing; the final partial list is emitted unless
    ``drop_remainder``."""
    parts: list = []
    pending = 0
    for block in blocks:
        parts.append(block)
        pending += len(block)
        while pending >= batch_size:
            take, need = [], batch_size
            while need > 0:
                n = len(parts[0])
                if n <= need:
                    take.append(parts.pop(0))
                    need -= n
                else:
                    take.append(parts[0].slice(0, need))
                    parts[0] = parts[0].slice(need, n)
                    need = 0
            pending -= batch_size
            yield take
    if pending and not drop_remainder:
        yield parts


def _require_bf16_exact(packed_col: torch.Tensor, src: np.ndarray, what: str) -> None:
    """``packed_col`` is a just-packed bfloat16 aux column, ``src`` its
    float32 source: raise when the cast lost precision."""
    if not np.array_equal(packed_col.to(torch.float32).numpy(), src):
        raise DMLCError(
            f"bfloat16 aux packing: this batch's {what}s are not bf16-exact — "
            f"packing would silently corrupt them. Keep the {what}s "
            "float32-packable (pack_aux=False locally, or an f32 snapshot "
            "geometry on the service) or use x_dtype='float32' "
            "(docs/data.md pack_aux)")


def pack_dense_batches(blocks, batch_size: int, num_col: int,
                       dtype=None, drop_remainder: bool = False):
    """Pack a RowBlock stream into fixed-geometry ``[B, num_col + 2]``
    slabs (features | label | weight), the layout a packed dense batch
    ships and the snapshot store persists, as CPU tensors. Yields
    ``(packed, resume_annotation)`` per batch; the epoch tail is
    row-padded to ``B`` (pad rows carry weight 0, masked downstream) unless
    ``drop_remainder``. ``dtype`` None or float32 packs float32;
    ``"bfloat16"`` (or ``torch.bfloat16``) rounds to nearest even, as
    ``ml_dtypes`` does, and checks each batch's labels and weights for
    losslessness. Used by the data service's snapshot frames (the worker
    packs, :mod:`dmlc_tpu_torch.service.worker`)."""
    B, nc = int(batch_size), int(num_col)
    bf16 = dtype is not None and (dtype is torch.bfloat16 or str(dtype) == "bfloat16")
    check(bf16 or dtype is None or np.dtype(dtype) == np.float32,
          f"pack_dense_batches: dtype {dtype!r} is not float32 or bfloat16")
    for block in rebatch_blocks(iter(blocks), B, drop_remainder=drop_remainder):
        x, y, w = block_to_dense(block, nc,
                                 pad_rows_to=(B if len(block) != B else None))
        packed = torch.empty((B, nc + 2), dtype=torch.bfloat16 if bf16 else torch.float32)
        packed[:, :nc] = torch.from_numpy(x)
        packed[:, nc] = torch.from_numpy(y)
        packed[:, nc + 1] = torch.from_numpy(w)
        if bf16:
            _require_bf16_exact(packed[:, nc], y, "label")
            _require_bf16_exact(packed[:, nc + 1], w, "weight")
        yield packed, getattr(block, "resume_state", None)


def _as_tensor(arr: np.ndarray) -> torch.Tensor:
    """A host array as a tensor with no copy; a ``uint16`` array holds
    bfloat16 bits (the native repack's bf16 payload) and comes back as
    ``torch.bfloat16``."""
    if arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class _Slot:
    """Pinned staging buffers and what the consumer needs to ship them:
    the batch ``kind``, its checkpoint annotation ``annot``, and for one u8
    span (a raw snapshot span, a bcoo batch) its ``layout`` and
    ``nbytes``. ``raw`` is a dense slot's own u8 span buffer, made at the
    first data-service snapshot frame it stages (the span route), and
    ``use_raw`` says whether the batch staged now is in it."""

    __slots__ = ("bufs", "event", "kind", "layout", "nbytes", "annot", "raw", "use_raw")

    def __init__(self, bufs: List[torch.Tensor]):
        self.bufs = bufs
        self.event: Optional[torch.cuda.Event] = None  # copy out of bufs
        self.kind = ""
        self.layout = None
        self.nbytes = 0
        self.annot: Optional[dict] = None
        self.raw: Optional[torch.Tensor] = None
        self.use_raw = False


class _Skipped:
    """A batch the producer skipped, unconverted, for a count restore;
    it carries the batch's annotation only."""

    __slots__ = ("annot",)

    def __init__(self, annot: Optional[dict]):
        self.annot = annot


class _StagingRing:
    """Host staging buffers the convert (or read) workers pack batches into.

    A slot cycles free -> taken by a worker -> copied by the consumer ->
    free again; the consumer records the copy's event on the slot when it
    hands it back, and :meth:`acquire` waits on that event before a worker
    may rewrite the buffers. An acquire with no slot free and room under
    the depth (:meth:`set_depth`) makes a slot with ``make()`` on the
    acquiring thread; with no room it waits for one (``misses`` counts
    those, and ``hits`` the acquires that found one free). A smaller depth
    only stops new slots: the ring never frees one. :meth:`close` wakes
    every waiting worker, which then gets None."""

    def __init__(self, slots: List[_Slot], make=None):
        self._slots = list(slots)
        self._make = make
        self._depth = len(self._slots)
        self._growing = 0  # slots being made by acquirers
        self._cond = threading.Condition()
        self._free: deque = deque(self._slots)
        self._closed = False
        self.hits = 0
        self.misses = 0

    def _can_grow(self) -> bool:
        return self._make is not None and len(self._slots) + self._growing < self._depth

    def acquire(self) -> Optional[_Slot]:
        with self._cond:
            if self._free:
                self.hits += 1
            elif not self._closed and not self._can_grow():
                self.misses += 1
                self._cond.wait_for(lambda: self._free or self._closed or self._can_grow())
            if self._closed:
                return None
            if not self._free:
                self._growing += 1
                slot = None
            else:
                slot = self._free.popleft()
        if slot is None:
            # a live growth: the pinned allocation on this worker's thread
            try:
                slot = self._make()
            finally:
                with self._cond:
                    self._growing -= 1
                    if slot is not None:
                        self._slots.append(slot)
                    self._cond.notify_all()
            with self._cond:
                # a closed ring hands out no slot; reopen() frees this one
                return None if self._closed else slot
        if slot.event is not None:
            slot.event.synchronize()
        return slot

    def release(self, slot: _Slot, event: Optional[torch.cuda.Event]) -> None:
        with self._cond:
            slot.event = event
            self._free.append(slot)
            self._cond.notify()

    def close(self) -> None:
        """Wake every waiter: a closed ring hands out no slot."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def reopen(self) -> None:
        """Every slot free again (the workers are stopped)."""
        with self._cond:
            self._closed = False
            self._free = deque(self._slots)

    def set_depth(self, depth: int) -> None:
        """The most slots the ring may hold: a larger depth lets the next
        acquires that find no free slot make one; a smaller one only stops
        new slots."""
        with self._cond:
            self._depth = max(1, int(depth))
            self._cond.notify_all()

    def grow(self, depth: int) -> None:
        """Raise the depth to at least ``depth`` and make the missing slots
        now (no worker runs)."""
        with self._cond:
            self._depth = max(self._depth, int(depth))
            while len(self._slots) < self._depth:
                slot = self._make()
                self._slots.append(slot)
                self._free.append(slot)

    def stats(self) -> dict:
        with self._cond:
            return {"depth": len(self._slots), "hits": self.hits, "misses": self.misses}


def _adopt_pipeline_scope(source, label: str, max_depth: int = 8) -> None:
    """Stamp ``label`` on the thread primitives a parser chain built before
    its ``DeviceIter`` existed: walk the chain's wrapper attributes and
    call ``adopt_scope`` where there is one (a primitive that has a scope
    keeps it). A property is not followed: it may be a lazy builder (the
    block cache's parser chain, the chunk cache's source split, which a
    warm pass must never build); what it built sits under ``_base``."""
    seen = set()
    stack = [(source, 0)]
    while stack:
        obj, depth = stack.pop()
        if obj is None or id(obj) in seen or depth > max_depth:
            continue
        seen.add(id(obj))
        adopt = getattr(obj, "adopt_scope", None)
        if callable(adopt):
            adopt(label)
        for name in ("source", "base", "_base", "_iter", "_pool", "_plan_pool"):
            if isinstance(inspect.getattr_static(obj, name, None), property):
                continue
            stack.append((getattr(obj, name, None), depth + 1))


def _align(n: int) -> int:
    return -(-n // _SPAN_ALIGN) * _SPAN_ALIGN


def _bcoo_offsets(index_bytes: int, nnz: int, rows: int, has_values: bool = True):
    """Where a bcoo batch's segments lie in its span: coordinates ``[2,
    nnz]`` (rows, then columns), values ``[nnz]`` f32 unless elided, label
    and weight ``[rows]`` f32, each 64-byte aligned. Returns the four
    offsets and the span's size."""
    o_val = _align(2 * nnz * index_bytes)
    o_label = o_val + (_align(4 * nnz) if has_values else 0)
    o_weight = o_label + _align(4 * rows)
    return o_val, o_label, o_weight, o_weight + 4 * rows


def _native_coo_offsets(csr: bool, nnz: int, rows: int, has_values: bool):
    """Where a :class:`CooBlock`'s segments lie in its span: the
    coordinates (``[nnz, 2]`` pairs, or the columns ``[nnz]``), on the CSR
    wire ``row_ptr`` ``[rows + 1]``, the values unless elided, label and
    weight, each 64-byte aligned, all int32 or float32. Returns the
    offsets of row_ptr, values, label and weight, and the span's size."""
    o_ptr = _align((1 if csr else 2) * 4 * nnz)
    o_val = o_ptr + (_align(4 * (rows + 1)) if csr else 0)
    o_label = o_val + (_align(4 * nnz) if has_values else 0)
    o_weight = o_label + _align(4 * rows)
    return o_ptr, o_val, o_label, o_weight, o_weight + 4 * rows


def _ell_offsets(rows: int, k: int):
    """Where an ELL batch of a per-batch K lies in its span: indices and
    values ``[rows, k]``, label and weight ``[rows]``, each 64-byte
    aligned. Returns the three later offsets and the span's size."""
    o_val = _align(4 * rows * k)
    o_label = o_val + _align(4 * rows * k)
    o_weight = o_label + _align(4 * rows)
    return o_val, o_label, o_weight, o_weight + 4 * rows


def _row_major(cols: np.ndarray, starts: np.ndarray, num_col: int) -> bool:
    """Whether a batch's entries are unique, in bounds and in row-major
    order: ``cols`` strictly increasing within each row, where ``starts``
    are the entries that begin a row (rows ascend by construction)."""
    if len(cols) and int(cols.max()) >= num_col:
        return False  # a masked id's slot may share a coordinate
    if len(cols) < 2:
        return True
    out_of_order = np.diff(cols.astype(np.int64)) <= 0  # entry i + 1 vs entry i
    starts = starts[(starts > 0) & (starts < len(cols))]
    out_of_order[starts - 1] = False  # a row starts anywhere
    return not bool(out_of_order.any())


def _coo_row_major(block: CooBlock) -> bool:
    """:func:`_row_major` of a :class:`CooBlock`'s real entries."""
    nnz = block.nnz
    if block.row_ptr is not None:
        return _row_major(block.coords[:nnz], block.row_ptr[1:block.n_rows], block.num_col)
    rows = block.coords[:nnz, 0]
    return _row_major(block.coords[:nnz, 1], np.flatnonzero(np.diff(rows)) + 1,
                      block.num_col)


class DeviceIter:
    """Prefetching host->device batch iterator for the ``dense``, ``ell``
    and ``bcoo`` layouts, with the snapshot store and its device-decode
    tier, and mid-epoch checkpoints (module docstring).

    ``dense`` batches are :class:`PackedDenseBatch` with ``pack_aux`` (the
    default for ``x_dtype="float32"``), else ``(x [B, num_col], label [B],
    weight [B])``; ``ell`` batches are
    :class:`~dmlc_tpu_torch.ops.sparse.EllBatch` with ``[B, max_nnz]`` int32
    indices (pad index ``num_col``; without ``max_nnz``, K is each batch's
    longest row) and float32 values; ``bcoo`` batches are
    ``(x, label, weight)`` with ``x`` a sparse COO tensor. Every batch has
    ``batch_size`` rows: the epoch's last partial batch is padded with
    zero-weight rows, or dropped with ``drop_remainder``. ``batch_size=None``
    (bcoo only) ships each parsed block as it comes, its rows rounded up to
    ``row_bucket``. ``nnz_bucket`` rounds a bcoo batch's nnz up to its
    multiples (default ``min(batch_size * max_nnz, 512 Ki)``, 4096 without
    ``max_nnz``, 16384 for natural blocks; 0 keeps exact shapes).
    ``elide_unit_values`` ships no values for an all-ones bcoo batch (the
    card makes them); ``csr_wire`` (natural blocks from the fused native
    reader, both buckets above 0) ships a block's columns and ``row_ptr``
    in place of its (row, col) pairs.

    ``snapshot`` names the snapshot file (default: the source's
    ``snapshot_path``, stamped by ``create_parser(..., snapshot=)``, with its
    ``snapshot_signature``); ``snapshot_quant="int8"`` stores packed dense
    batches as int8 plus a per-column scale; ``device_decode=True`` decodes
    warm batches, and a data-service snapshot frame's span with or without
    a snapshot, on the device; ``snapshot_shuffle_seed`` serves warm
    snapshot epochs in a seeded order (module docstring). ``prefetch`` and
    ``device_decode`` left at None read the environment knobs
    ``DMLC_TPU_PREFETCH`` (default 2) and ``DMLC_TPU_DEVICE_DECODE``
    (:mod:`dmlc_tpu_torch.utils.knobs`). ``device=None`` means
    the CUDA device and raises on a host without one; pass ``device="cpu"``
    for the CPU. ``mesh`` / ``data_axis`` / ``shardings`` make this the
    rank's slice of a data-parallel feed (module docstring); the device is
    then the mesh's.
    """

    def __init__(
        self,
        source,
        num_col: int,
        batch_size: Optional[int],
        layout: str = "dense",
        *,
        mesh=None,
        data_axis: str = "data",
        shardings=None,
        max_nnz: Optional[int] = None,
        prefetch: Optional[int] = None,
        convert_ahead: Optional[int] = None,
        convert_workers: Optional[int] = None,
        transfer_sample: Optional[int] = None,
        drop_remainder: bool = False,
        device=None,
        x_dtype: str = "float32",
        pack_aux: Optional[bool] = None,
        nnz_bucket: Optional[int] = None,
        row_bucket: int = 1024,
        elide_unit_values: bool = False,
        csr_wire: bool = True,
        pipeline_label: Optional[str] = None,
        snapshot: Optional[str] = None,
        snapshot_signature: Optional[dict] = None,
        snapshot_quant: Optional[str] = None,
        device_decode: Optional[bool] = None,
        snapshot_shuffle_seed: Optional[int] = None,
        snapshot_read_workers: Optional[int] = None,
        autotune: Optional[bool] = None,
        autotune_interval: Optional[int] = None,
    ):
        check(layout in ("dense", "ell", "bcoo"), f"unknown layout {layout!r}")
        check(batch_size is not None or layout == "bcoo",
              "batch_size=None (natural blocks) requires layout='bcoo'")
        check(batch_size is None or batch_size > 0,
              "DeviceIter: batch_size must be a positive integer")
        check(layout != "ell" or max_nnz is None or max_nnz > 0,
              "DeviceIter: max_nnz must be a positive integer")
        check(x_dtype in _X_DTYPES, f"unknown x_dtype {x_dtype!r}")
        check(x_dtype == "float32" or layout == "dense",
              "x_dtype='bfloat16' applies to the dense layout only")
        check(layout != "bcoo" or (mesh is None and shardings is None),
              "layout='bcoo' emits single-device batches; mesh/shardings "
              "sharding is supported for 'dense' and 'ell' only")
        self.mesh = mesh
        self.data_axis = data_axis
        self.shardings = tuple(shardings) if shardings is not None else None
        self.device = rank_device(mesh, device, data_axis=data_axis, who="DeviceIter")
        self.num_col = int(num_col)
        # the columns of a dense x this rank ships (all but under feature
        # sharding, _check_shardings)
        self._x_cols = slice(0, self.num_col)
        if mesh is not None and self.shardings is not None:
            self._check_shardings(layout)
        self.source = source
        self.batch_size = None if batch_size is None else int(batch_size)
        self.layout = layout
        self.max_nnz = None if max_nnz is None else int(max_nnz)
        self.prefetch = _knobs.prefetch(prefetch)
        self.convert_workers = _knobs.resolve("convert_workers", convert_workers)
        self._convert_ahead = _knobs.resolve("convert_ahead", convert_ahead)
        self.snapshot_read_workers = _knobs.resolve("snapshot_read_workers",
                                                    snapshot_read_workers)
        self.transfer_sample = _knobs.transfer_sample(transfer_sample)
        self.drop_remainder = bool(drop_remainder)
        self.x_dtype = x_dtype
        # aux packing: label/weight as two trailing columns of x, one copy
        # per dense batch. On by default for float32 (always lossless); a
        # bfloat16 pack is checked per batch to be exact
        # mesh batches ship unpacked, as in the JAX package
        if pack_aux is None:
            pack_aux = layout == "dense" and mesh is None and x_dtype == "float32"
        self.pack_aux = bool(pack_aux) and layout == "dense" and mesh is None
        self._aux_exact_check = self.pack_aux and x_dtype == "bfloat16"
        # bcoo shape buckets (the JAX package's derivation)
        if nnz_bucket is None:
            if batch_size is not None and max_nnz:
                nnz_bucket = min(int(batch_size) * int(max_nnz), _NNZ_BUCKET_CAP)
            else:
                nnz_bucket = 4096 if batch_size is not None else 16384
        self.nnz_bucket = int(nnz_bucket)
        self.row_bucket = int(row_bucket)
        # unit-value elision: an all-ones batch ships no values and the card
        # makes them (the mask of in-bounds columns on the native COO emit)
        self.elide_unit_values = bool(elide_unit_values)
        # nnz values fixed-batch bcoo batches emitted: the tail pads into it
        self._emitted_nse: set = set()
        self.nnz_shapes: set = set()  # nnz capacities of the bcoo spans delivered
        # snapshot store: the parser's stamp unless given here
        if snapshot is None:
            snapshot = getattr(source, "snapshot_path", None)
            if snapshot is not None and snapshot_signature is None:
                snapshot_signature = getattr(source, "snapshot_signature", None)
        self.snapshot_path = snapshot
        self._snap_sig = snapshot_signature
        self._snap_quant = snapshot_quant
        self._snap_seed = None if snapshot_shuffle_seed is None else int(snapshot_shuffle_seed)
        self._snap_epoch = 0            # advances at each reset() after a batch
        self._snap_seq_restore = False  # a sequential state owns this epoch's rest
        self.device_decode = _knobs.device_decode(device_decode)
        check(snapshot is None or (mesh is None and shardings is None),
              "snapshot= serves single-put batches; mesh/shardings "
              "pipelines are not snapshot-servable")
        check(snapshot is None or layout != "bcoo",
              "snapshot v1 stores fixed-geometry batches: layout 'dense' or "
              "'ell', not 'bcoo'")
        check(snapshot is None or layout != "ell" or max_nnz,
              "snapshot v1 stores fixed-geometry batches: 'ell' needs max_nnz "
              "pinned (one [B, K] shape)")
        check(snapshot_quant in (None, "int8"), f"unknown snapshot_quant {snapshot_quant!r}")
        check(snapshot_quant is None or (snapshot is not None and self.pack_aux),
              "snapshot_quant='int8' applies to snapshotted packed dense "
              "batches (layout='dense' with pack_aux)")
        # without a snapshot the flag acts on the blocks that carry a
        # device_span (a data-service snapshot frame's), as in the JAX package
        check(snapshot is None
              or (getattr(source, "plan_state", None) or {}).get("shuffle_seed") is None,
              "snapshot= cannot combine with a source-side epoch "
              "plan (shuffle_seed on the block cache): the snapshot "
              "freezes one epoch's batch order — shuffle snapshot "
              "epochs with snapshot_shuffle_seed= instead "
              "(docs/data.md)")
        if layout == "dense" and hasattr(source, "set_emit_dense"):
            # dense blocks straight from the scanner, no CSR block; the
            # fused native reader also repacks them to batch_size rows off
            # the interpreter lock. A bfloat16 pack_aux takes its features
            # in bf16 and label and weight in float32, so that the
            # producer's one packing pass can check their cast to bf16
            # (the native repack would round them unchecked)
            source.set_emit_dense(self.num_col, batch_rows=self.batch_size, dtype=x_dtype,
                                  pack_aux=self.pack_aux and not self._aux_exact_check)
        if layout == "bcoo" and batch_size is None and hasattr(source, "set_emit_coo"):
            # device-ready COO blocks from the fused native reader: the
            # convert moves into its C++ parse threads. The CSR wire ships
            # columns + row_ptr (half the coordinate bytes) and needs both
            # buckets, as in the JAX package
            source.set_emit_coo(self.num_col, row_bucket=self.row_bucket,
                                nnz_bucket=self.nnz_bucket,
                                elide_unit=self.elide_unit_values,
                                csr_wire=bool(csr_wire and self.nnz_bucket > 0
                                              and self.row_bucket > 0))
        self._snap_reader: Optional[_snapshot.SnapshotReader] = None
        self._snap_writer: Optional[_snapshot.SnapshotWriter] = None
        self._snap_serving = False  # the current producer is the warm feed
        self._shadow_write = True   # a cold pass from the epoch start may write
        self._snap_suspend = False  # a cold restore owns the rest of the epoch
        self._snap_pos0 = 0         # the warm feed's first batch (a restore)
        # restore: what the next producer starts from — batches to skip
        # (a count restore), rows to drop after a seek, and whether the
        # source already stands at the resume position
        self._skip_batches = 0
        self._drop_rows = 0
        self._seeked = False
        self._last_resume: Optional[dict] = None  # the last delivered batch's
        # healing: the restart budget (read once, as the JAX package reads
        # its policy), this epoch's restarts and gives-up, and their
        # lifetime tally (the autotuner's sensor: reset() zeroes the
        # epoch's counts, and a new epoch's early restarts must still show)
        self._retry_policy = _resilience.RetryPolicy.from_env()
        self.pipeline_restarts = 0
        self.pipeline_giveups = 0
        self._faults_lifetime = 0
        self._batches_total = 0  # delivered over the iterator's life
        self.stall_seconds = 0.0
        self.host_stall_seconds = 0.0
        self.batches_fed = 0
        self.bytes_to_device = 0
        self.device_decode_bytes = 0
        self.device_decode_seconds = 0.0
        self.snapshot_write_seconds = 0.0
        # written by the serial stage (one thread at a time)
        self.source_wait_seconds = 0.0
        # the trace context of the last source block that carried one (a
        # data-service block's grant): the dispatch span joins it
        self._last_trace_ctx: Optional[tuple] = None
        # the telemetry scope of everything this pipeline records; thread
        # primitives the parser chain built already take it now
        self.pipeline_label = pipeline_label or _telemetry.new_pipeline_label()
        _adopt_pipeline_scope(source, self.pipeline_label)
        mode, path = _telemetry.trace_mode()
        self._trace_export = path if mode == "chrome" else None
        # the stages' busy seconds, added by the pipeline's threads, and
        # the consumer's wall split among them (module docstring)
        self._busy = StageMeter("read", "cache_read", "snapshot_read", "parse", "convert",
                                "dispatch", "device_decode",
                                metric=_telemetry.STAGE_BUSY_METRIC, scope=self.pipeline_label)
        self._attr = StageMeter("read", "cache_read", "snapshot_read", "parse", "convert",
                                "dispatch", "device_decode", "transfer",
                                metric=_telemetry.STAGE_WALL_METRIC, scope=self.pipeline_label)
        self._input_wait = _telemetry.REGISTRY.counter(_telemetry.INPUT_WAIT_METRIC,
                                                       pipeline=self.pipeline_label)
        self._convert_cpu = _telemetry.REGISTRY.counter(_telemetry.CONVERT_CPU_METRIC,
                                                        pipeline=self.pipeline_label)
        # the serial stage's thread CPU seconds inside the source's pulls
        self._source_cpu = 0.0
        self._res_base = _resilience.counters_snapshot(self.pipeline_label)
        self._transfer_samples = 0
        self._t_first: Optional[float] = None  # the first pull
        self._t_last: Optional[float] = None   # the latest consumer activity
        self._cuda = self.device.type == "cuda"
        self._copy_stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._rings: dict = {}  # staging rings by buffer spec, kept across epochs
        self._ring: Optional[_StagingRing] = None  # the current producer's
        self._host = None  # the convert pool, the natural-block producer or the warm feed
        self._inflight: deque = deque()
        # the online autotuner (module docstring), armed by autotune=True or
        # DMLC_TPU_AUTOTUNE=1
        self.autotuner: Optional[_autotune.AutoTuner] = None
        self._autotune_interval = 0
        self._tune_mark: Optional[dict] = None
        if _knobs.autotune_enabled(autotune):
            self._autotune_interval = _knobs.autotune_interval(autotune_interval)
            self.autotuner = _autotune.AutoTuner(self._autotune_knobs(),
                                                 scope=self.pipeline_label)

    def _check_shardings(self, layout: str) -> None:
        """A learner's ``batch_shardings()`` must split every array of a
        batch by rows over this mesh's data axis, and nothing else, but for
        a dense ``x`` whose columns may split over another axis of the mesh
        (``(data, model)``): this rank then ships its coordinate's slice."""
        want = 4 if layout == "ell" else 3
        shardings = list(self.shardings)
        model_axis = None
        if layout == "dense" and len(shardings) == want:
            spec = getattr(shardings[0], "spec", ())
            if len(spec) == 2 and spec[1] is not None and spec[1] in self.mesh.shape \
                    and spec[1] != self.data_axis:
                model_axis = spec[1]
                shardings[0] = shardings[0]._replace(spec=(spec[0], None))
        rows_split = all(
            getattr(sh, "mesh", None) is self.mesh and len(sh.spec) >= 1
            and sh.spec[0] == self.data_axis and not any(sh.spec[1:])
            for sh in shardings)
        check(len(shardings) == want and rows_split,
              f"DeviceIter: shardings must be {want} row splits over the mesh's "
              f"{self.data_axis!r} axis (a learner's batch_shardings()), a dense x's "
              f"columns over another of its axes, got {self.shardings}")
        if model_axis is not None:
            parts = self.mesh.shape[model_axis]
            check(self.num_col % parts == 0,
                  f"DeviceIter: num_col {self.num_col} does not split over the "
                  f"{parts} ranks of {model_axis!r}")
            width = self.num_col // parts
            lo = self.mesh.coords[model_axis] * width
            self._x_cols = slice(lo, lo + width)

    # ---------------- staging ----------------

    def _ring_depth(self, ahead: int, workers: int) -> int:
        """A slot for each of ``ahead`` batches pulled and not yet delivered
        (at most one slot each, so the oldest always finds one),
        ``prefetch`` copies, each worker and two spare, as the JAX package
        sizes its ring."""
        return ahead + self.prefetch + workers + 2

    def _ring_for(self, spec, ahead: int, workers: int) -> _StagingRing:
        """The staging ring for ``spec``, a tuple of ``(shape, dtype)``, its
        slots made now up to :meth:`_ring_depth` (no worker runs)."""
        spec = tuple(spec)
        ring = self._rings.get(spec)
        if ring is None:
            ring = self._rings[spec] = _StagingRing([], make=lambda: _Slot(
                [torch.empty(shape, dtype=dt, pin_memory=self._cuda) for shape, dt in spec]))
        ring.grow(self._ring_depth(ahead, workers))
        return ring

    def _refresh_ring_depth(self) -> None:
        """The current ring's depth for the knobs as they are now: a window
        that widens finds its slots (made by the workers that need them)."""
        if self._ring is None:
            return
        if self._snap_serving:
            w = self.snapshot_read_workers
            self._ring.set_depth(self._ring_depth(2 * w, w))
        else:
            workers = 1 if self.batch_size is None else self.convert_workers
            self._ring.set_depth(self._ring_depth(self._convert_ahead, workers))

    def _cold_kind(self) -> str:
        if self.layout == "ell" and self.max_nnz is None:
            return "ell_span"  # K follows each batch's longest row
        if self.layout != "dense":
            return self.layout
        return "dense_packed" if self.pack_aux else "dense"

    def _cold_spec(self):
        B, f32 = self.batch_size, torch.float32
        if self.layout == "bcoo":
            # one u8 span a batch, grown in place when a batch needs more
            rows = B or self.row_bucket or 1024
            return [((_bcoo_offsets(4, self.nnz_bucket or 4096, rows)[-1],), torch.uint8)]
        if self.layout == "ell" and self.max_nnz is None:
            # one u8 span a batch, grown in place when a batch's K needs more
            return [((_ell_offsets(B, 1)[-1],), torch.uint8)]
        if self.layout == "ell":
            K = self.max_nnz
            return [((B, K), torch.int32), ((B, K), f32), ((B,), f32), ((B,), f32)]
        xdt = _X_DTYPES[self.x_dtype]
        if self.pack_aux:
            return [((B, self.num_col + 2), xdt)]
        cols = self._x_cols.stop - self._x_cols.start
        return [((B, cols), xdt), ((B,), f32), ((B,), f32)]

    # ---------------- cold epochs (the convert pool) ----------------

    def _blocks(self, seeked: bool) -> Iterator[RowBlock]:
        """The source's blocks, each pull's wait added to the supply
        stages: read, cache_read and parse from the source's own
        ``stage_seconds()`` over the pull, the rest as parse. The part of
        a pull that is not a warm cache read and that no span of the
        source covers (all of it for the fused native reader, which reports
        no stages; the chain's own overhead otherwise) is recorded as a
        parse span at the pull's end, so the trace's parse spans add up to
        the parse stage less the block cache's writes (``cache_write``
        spans of their own)."""
        if not seeked:  # a seek-restored source already stands at the resume point
            self.source.before_first()
        stage_fn = getattr(self.source, "stage_seconds", None)
        has_writes = hasattr(self.source, "cache_write_seconds")
        while True:
            s0 = stage_fn() if stage_fn is not None else None
            w0 = self.source.cache_write_seconds if has_writes else 0.0
            t0 = get_time()
            c0 = time.thread_time()
            blk = self.source.next_block()
            self._source_cpu += time.thread_time() - c0
            dt = get_time() - t0
            self.source_wait_seconds += dt
            read = cache_read = parse = 0.0
            if s0 is not None:
                s1 = stage_fn()
                read = min(max(0.0, s1["read"] - s0["read"]), dt)
                cache_read = min(max(0.0, s1.get("cache_read", 0.0) - s0.get("cache_read", 0.0)),
                                 dt - read)
                parse = max(0.0, s1.get("parse", 0.0) - s0.get("parse", 0.0))
            writes = self.source.cache_write_seconds - w0 if has_writes else 0.0
            rest = dt - read - cache_read - parse - writes
            if rest > 0.0 and cache_read <= 0.0:  # a warm read's overhead gets no span
                _telemetry.record_span("parse", t0 + dt - rest, rest)
            self._busy.add("read", read)
            self._busy.add("cache_read", cache_read)
            self._busy.add("parse", dt - read - cache_read)
            if blk is None:
                return
            ctx = getattr(blk, "trace_ctx", None)
            if ctx is not None:
                self._last_trace_ctx = ctx
            yield blk

    def _tracked_blocks(self, boundaries: deque, drop: int,
                        seeked: bool) -> Iterator[RowBlock]:
        """Source blocks after dropping the first ``drop`` rows (a seek
        lands on a block boundary before the resume row), with ``(rows
        since the stream start, annotation)`` appended to ``boundaries``
        for every annotated block."""
        rows = 0
        for block in self._blocks(seeked):
            # read before any drop-slice: the tail still ends where it points
            annot = block.resume_state
            if drop > 0:
                if drop >= len(block):
                    drop -= len(block)
                    continue
                block = block.slice(drop, len(block))
                drop = 0
            rows += len(block)
            if annot is not None:
                boundaries.append((rows, annot))
            yield block

    def _source_batches(self, drop: int, seeked: bool):
        """``(batch, annotation, bcoo nnz pad)`` in stream order, a batch
        one RowBlock (a dense batch: its list of parts), with the
        annotation of the last block boundary at or before the batch's end
        (None before the first), and the nnz pad planned here, in order, so
        the tail batch pads into a shape already emitted."""
        if self.batch_size is None:  # natural blocks: no annotations
            for block in self._blocks(seeked):
                yield block, None, self._plan_bcoo_pad_nnz(block)
            return
        boundaries: deque = deque()
        cur, emitted = None, 0
        tracked = self._tracked_blocks(boundaries, drop, seeked)
        regroup = _dense_batches if self.layout == "dense" else rebatch_blocks
        for block in regroup(tracked, self.batch_size, self.drop_remainder):
            # a dense batch is its list of parts
            emitted += sum(map(len, block)) if self.layout == "dense" else len(block)
            while boundaries and boundaries[0][0] <= emitted:
                cur = boundaries.popleft()
            annot = None if cur is None else {"source": cur[1], "skip_rows": emitted - cur[0]}
            pad_nnz = self._plan_bcoo_pad_nnz(block) if self.layout == "bcoo" else None
            yield block, annot, pad_nnz

    def _plan_bcoo_pad_nnz(self, block: RowBlock) -> Optional[int]:
        """A bcoo batch's nnz pad: up to the bucket multiple; a fixed-batch
        tail pads up to the smallest nnz full batches already emitted that
        fits it, so an epoch adds no shape on its last batch. A
        :class:`CooBlock` comes padded by the native emit."""
        if not self.nnz_bucket or isinstance(block, CooBlock):
            return None
        pad_nnz = -(-max(len(block.index), 1) // self.nnz_bucket) * self.nnz_bucket
        if self.batch_size is not None:
            if len(block) < self.batch_size:
                fits = [s for s in self._emitted_nse if s >= pad_nnz]
                if fits:
                    pad_nnz = min(fits)
            self._emitted_nse.add(pad_nnz)
        return pad_nnz

    def _convert(self, block: RowBlock, pad_nnz: Optional[int]):
        if isinstance(block, CooBlock):
            # the native COO emit: device-ready but for the pad scheme,
            # which the card maps; the host only reads its order
            return block, _coo_row_major(block)
        if self.batch_size is not None:
            pad = self.batch_size if len(block) != self.batch_size else None
        else:  # natural blocks: round the rows up too
            pad = -(-len(block) // self.row_bucket) * self.row_bucket if self.row_bucket else None
        if self.layout == "dense":
            return block  # its parts are packed in one pass (_pack_dense)
        if self.layout == "bcoo":
            # an id >= num_col becomes a value-0 slot (JAX's BCOO masks it),
            # and its block keeps its values
            arrays = block_to_bcoo_host(block, self.num_col, pad_rows_to=pad,
                                        unit_values_as_none=self.elide_unit_values,
                                        pad_nnz_to=pad_nnz)
            return arrays + (len(block.index),
                             _row_major(block.index, block.offset[1:-1], self.num_col),
                             arrays[1] is None)
        if len(block.index) and int(block.index.max()) >= self.num_col:
            # ell's pad index num_col addresses the sink: a larger index
            # would read outside the weight table (JAX's ell path gives NaN)
            raise DMLCError(
                f"DeviceIter: feature index {int(block.index.max())} >= "
                f"num_col {self.num_col}")
        return tuple(block_to_ell(block, self.num_col, max_nnz=self.max_nnz,
                                  pad_rows_to=pad))

    def _pack(self, slot: _Slot, arrays) -> None:
        """Copy a converted batch into its staging slot; torch casts to a
        bfloat16 slot with round-to-nearest-even."""
        if self.layout == "bcoo":
            if isinstance(arrays[0], CooBlock):
                self._pack_native_coo(slot, *arrays)
            else:
                self._pack_bcoo(slot, arrays)
            return
        if self.layout == "dense":
            span = self._span_ready(arrays)
            if span is not None:
                self._pack_device_span(slot, *span)
                return
            self._pack_dense(slot, arrays)
            return
        if self.max_nnz is None:
            self._pack_ell_span(slot, arrays)
            return
        for buf, arr in zip(slot.bufs, arrays):
            buf.copy_(torch.from_numpy(arr))

    def _span_ready(self, parts):
        """A dense batch's ``device_span`` when the batch is one full packed
        :class:`DenseBlock` that carries one (a data-service snapshot
        frame's) and ``device_decode`` is on with no snapshot tee, else None
        (the JAX package's ``span_ready`` route: with a tee the shadow
        writer needs the host arrays, so the block takes the copy)."""
        if not self.device_decode or self.snapshot_path is not None or len(parts) != 1:
            return None
        part = parts[0]
        if not (isinstance(part, DenseBlock) and part.packed and len(part) == self.batch_size):
            return None
        return part.device_span

    def _pack_device_span(self, slot: _Slot, raw: np.ndarray, layout, kind: str) -> None:
        """A snapshot frame's verbatim payload into the slot's own u8 span
        buffer (grown when a frame needs more): the consumer ships it and
        decodes it on the device with one K2 launch, as a warm snapshot
        batch, with no host decode."""
        if slot.raw is None or slot.raw.numel() < raw.size:
            slot.raw = torch.empty(raw.size, dtype=torch.uint8, pin_memory=self._cuda)
        slot.raw[: raw.size].numpy()[...] = raw
        slot.use_raw = True
        slot.kind, slot.layout, slot.nbytes = kind, layout, raw.size

    def _pack_dense(self, slot: _Slot, parts) -> None:
        """A dense batch's parts into its staging slot in one pass (the JAX
        package's ``_pack_dense_parts``): a packed ``DenseBlock`` (the
        native repack's ``[n, num_col + 2]`` slab) copied whole into a
        packed slot, so a full packed batch is one copy; another
        ``DenseBlock`` part copied as it is; a ``RowBlock`` part densified
        first; an absent weight is 1; rows past the parts (the epoch's tail)
        are zeros, so their weight 0 masks them. The copy into a bfloat16
        slot rounds to nearest even; a bfloat16 part's bits are copied.
        Under feature sharding only this rank's columns are copied."""
        nc, cols = self.num_col, self._x_cols
        if self.pack_aux:
            packed = slot.bufs[0]
            xb, yb, wb = packed[:, :nc], packed[:, nc], packed[:, nc + 1]
        else:
            xb, yb, wb = slot.bufs
        pos = 0
        for part in parts:
            n = len(part)
            if isinstance(part, DenseBlock) and part.packed:
                slab = _as_tensor(part.x)
                if self.pack_aux:
                    packed[pos:pos + n].copy_(slab)
                else:
                    xb[pos:pos + n].copy_(slab[:, cols])
                    yb[pos:pos + n].copy_(slab[:, nc])
                    wb[pos:pos + n].copy_(slab[:, nc + 1])
                pos += n
                continue
            if isinstance(part, DenseBlock):
                x, y, w = part.x, part.label, part.weight
            else:
                x, y, w = block_to_dense(part, nc)
            xb[pos:pos + n].copy_(_as_tensor(x)[:, cols])
            yb[pos:pos + n].copy_(torch.from_numpy(y))
            if w is None:
                wb[pos:pos + n] = 1.0
            else:
                wb[pos:pos + n].copy_(torch.from_numpy(w))
            if self._aux_exact_check:
                _require_bf16_exact(yb[pos:pos + n], y, "label")
                if w is not None:
                    _require_bf16_exact(wb[pos:pos + n], w, "weight")
            pos += n
        for buf in (xb, yb, wb):
            buf[pos:] = 0

    def _span(self, slot: _Slot, nbytes: int) -> np.ndarray:
        """The slot's u8 span as numpy, grown first when a batch needs more
        bytes (the ring handed the slot out after its last copy
        completed)."""
        if slot.bufs[0].numel() < nbytes:
            slot.bufs[0] = torch.empty(max(nbytes, 2 * slot.bufs[0].numel()),
                                       dtype=torch.uint8, pin_memory=self._cuda)
        slot.nbytes = nbytes
        return slot.bufs[0].numpy()

    def _pack_bcoo(self, slot: _Slot, arrays) -> None:
        """A bcoo batch into the slot's u8 span (:func:`_bcoo_offsets`);
        elided values are not shipped."""
        coords, vals, label, weight, (rows, _), real_nnz, row_major, elide = arrays
        nnz, isz = len(coords), coords.dtype.itemsize
        o_val, o_label, o_weight, nbytes = _bcoo_offsets(isz, nnz, rows, not elide)
        span = self._span(slot, nbytes)
        span[: 2 * nnz * isz].view(coords.dtype).reshape(2, nnz)[...] = coords.T
        if not elide:
            span[o_val: o_val + 4 * nnz].view(np.float32)[...] = vals
        span[o_label: o_label + 4 * rows].view(np.float32)[...] = label
        span[o_weight: nbytes].view(np.float32)[...] = weight
        slot.layout = (isz, nnz, real_nnz, rows, row_major, elide)

    def _pack_native_coo(self, slot: _Slot, block: CooBlock, row_major: bool) -> None:
        """A :class:`CooBlock` into the slot's u8 span as it came
        (:func:`_native_coo_offsets`): one copy a segment, no convert."""
        csr, has_values = block.row_ptr is not None, block.values is not None
        nnz, rows = len(block.coords), len(block.label)
        o_ptr, o_val, o_label, o_weight, nbytes = _native_coo_offsets(
            csr, nnz, rows, has_values)
        span = self._span(slot, nbytes)
        span[: (1 if csr else 2) * 4 * nnz].view(np.int32)[...] = block.coords.reshape(-1)
        if csr:
            span[o_ptr: o_ptr + 4 * (rows + 1)].view(np.int32)[...] = block.row_ptr
        if has_values:
            span[o_val: o_val + 4 * nnz].view(np.float32)[...] = block.values
        span[o_label: o_label + 4 * rows].view(np.float32)[...] = block.label
        span[o_weight: nbytes].view(np.float32)[...] = block.weight
        slot.kind = "bcoo_native"
        slot.layout = (csr, nnz, block.nnz, rows, row_major, has_values)

    def _pack_ell_span(self, slot: _Slot, arrays) -> None:
        """An ELL batch whose K is its longest row's into the slot's u8 span
        (:func:`_ell_offsets`)."""
        indices, values, label, weight = arrays
        rows, k = indices.shape
        o_val, o_label, o_weight, nbytes = _ell_offsets(rows, k)
        span = self._span(slot, nbytes)
        span[: 4 * rows * k].view(np.int32)[...] = indices.reshape(-1)
        span[o_val: o_val + 4 * rows * k].view(np.float32)[...] = values.reshape(-1)
        span[o_label: o_label + 4 * rows].view(np.float32)[...] = label
        span[o_weight: nbytes].view(np.float32)[...] = weight
        slot.layout = (rows, k)

    def _write_snapshot_batch(self, slot: _Slot) -> None:
        kind, arrays = slot.kind, slot.bufs
        if self._snap_quant == "int8":
            q, scale = _device_decode.quantize_int8(arrays[0].to(torch.float32).numpy())
            kind, arrays = "dense_packed_q8", (q, scale)
        self._snap_writer.add_batch(kind, arrays, rows=self.batch_size, resume=slot.annot)

    def _serial_batches(self, skip: int, drop: int, seeked: bool) -> Iterator:
        """The convert pool's serial stage: ``("skip", annotation)`` for
        each of the first ``skip`` batches (a count restore), then
        ``("convert", batch, annotation, bcoo nnz pad)`` in stream order.
        Its time beyond the source's pulls (the rebatch) is convert busy,
        and its thread CPU time beyond theirs convert CPU."""
        inner = self._source_batches(drop, seeked)
        while True:
            b0 = self._busy.seconds()
            t0 = get_time()
            c0, sc0 = time.thread_time(), self._source_cpu
            try:
                block, annot, pad_nnz = next(inner)
            except StopIteration:
                return
            cpu = time.thread_time() - c0 - (self._source_cpu - sc0)
            dt = get_time() - t0
            b1 = self._busy.seconds()
            supply = sum(b1[k] - b0[k] for k in ("read", "parse", "cache_read"))
            residue = max(0.0, dt - supply)
            self._busy.add("convert", residue)
            self._convert_cpu.inc(min(residue, max(0.0, cpu)))
            _telemetry.record_span("convert", t0, residue)
            if skip:
                skip -= 1
                yield ("skip", annot)
            else:
                yield ("convert", block, annot, pad_nnz)

    def _convert_work(self, item):
        """The convert pool's parallel stage: a skipped batch as
        :class:`_Skipped`; else the batch converted, a staging slot taken
        (None once the ring closed: the epoch is being torn down) and the
        batch packed into it. The convert and the pack are convert busy,
        the wait for a slot is not. The thread CPU time over the whole
        call, capped at that busy time, is convert CPU: the wait for a
        slot blocks off the CPU."""
        if item[0] == "skip":
            return _Skipped(item[1])
        _, block, annot, pad_nnz = item
        t0 = get_time()
        c0 = time.thread_time()
        with _telemetry.profiler_annotation("dmlc_tpu.convert"):
            arrays = self._convert(block, pad_nnz)
            t_acquire = get_time()
            slot = self._ring.acquire()
            if slot is None:
                return None
            t_pack = get_time()
            slot.kind, slot.layout, slot.annot = self._cold_kind(), None, annot
            slot.use_raw = False
            self._pack(slot, arrays)
        c1 = time.thread_time()
        t1 = get_time()
        busy = (t_acquire - t0) + (t1 - t_pack)
        self._busy.add("convert", busy)
        self._convert_cpu.inc(min(busy, c1 - c0))
        _telemetry.record_span("convert", t0, busy)
        return slot

    def _cold_feed(self, skip: int, drop: int, seeked: bool):
        """A cold epoch's producer: the convert pool, or for natural blocks
        the same two stages on one thread (module docstring)."""
        self._ring = self._ring_for(self._cold_spec(), self._convert_ahead,
                                    1 if self.batch_size is None else self.convert_workers)
        if self.batch_size is None:
            return ThreadedIter.from_factory(
                lambda: map(self._convert_work, self._serial_batches(skip, drop, seeked)),
                max_capacity=self._convert_ahead)
        return OrderedWorkerPool(lambda: self._serial_batches(skip, drop, seeked),
                                 self._convert_work, num_workers=self.convert_workers,
                                 max_ahead=self._convert_ahead, counter_label="convert")

    # ---------------- the online autotuner ----------------

    def _autotune_knobs(self) -> list:
        """The knobs this pipeline can move live: the queue depths always,
        the parse fan-out and the plan read pool where the source chain
        can resize them, the snapshot read pool under a snapshot (the JAX
        package's set)."""
        knobs = [_autotune.Knob("prefetch", lambda: self.prefetch, self._apply_prefetch),
                 _autotune.Knob("convert_ahead", lambda: self._convert_ahead,
                                self._apply_convert_ahead)]
        if callable(getattr(self.source, "resize_parse_workers", None)):
            fn = getattr(self.source, "parallel_stats", None)
            pstats = fn() if callable(fn) else None
            # the live pool's width, else the width a lazily built base
            # will use, else the table's default
            self._knob_parse_workers = int(
                (pstats or {}).get("parse_workers")
                or getattr(self.source, "parse_workers_hint", 0)
                or _knobs.resolve("parse_workers"))
            knobs.append(_autotune.Knob("parse_workers", lambda: self._knob_parse_workers,
                                        self._apply_parse_workers))
        if callable(getattr(self.source, "resize_plan_read_workers", None)):
            knobs.append(_autotune.Knob(
                "plan_read_workers",
                lambda: int(getattr(self.source, "plan_read_workers", 0)
                            or _knobs.resolve("plan_read_workers")),
                lambda n: bool(self.source.resize_plan_read_workers(int(n)))))
        if self.snapshot_path is not None:
            knobs.append(_autotune.Knob("snapshot_read_workers",
                                        lambda: self.snapshot_read_workers,
                                        self._apply_snapshot_read_workers))
        if callable(getattr(self.source, "resize_pipeline_depth", None)):
            # a service-fed pipeline: the read stage's relief knob is the
            # client's pipelined fetch window (there is no local parse
            # fan-out to widen)
            knobs.append(_autotune.Knob(
                "service_pipeline_depth",
                lambda: int(getattr(self.source, "pipeline_depth", 0)
                            or _knobs.resolve("service_pipeline_depth")),
                self.source.resize_pipeline_depth))
        return knobs

    def _apply_prefetch(self, n: int) -> bool:
        # the ring first; the consumer's next _fill copies further ahead
        self.prefetch = max(1, int(n))
        self._refresh_ring_depth()
        return True

    def _apply_convert_ahead(self, n: int) -> bool:
        self._convert_ahead = max(1, int(n))
        self._refresh_ring_depth()  # before the window opens
        if isinstance(self._host, OrderedWorkerPool):
            self._host.set_max_ahead(self._convert_ahead)
        elif isinstance(self._host, ThreadedIter):
            self._host.set_capacity(self._convert_ahead)
        return True

    def _apply_parse_workers(self, n: int) -> bool:
        if not self.source.resize_parse_workers(int(n)):
            return False  # no parse tier now (a warm block cache)
        self._knob_parse_workers = max(1, int(n))
        return True

    def _apply_snapshot_read_workers(self, n: int) -> bool:
        self.snapshot_read_workers = max(1, int(n))
        if isinstance(self._host, _snapshot.SnapshotIter):
            self._refresh_ring_depth()  # before the 2n window opens
            self._host.resize(self.snapshot_read_workers)
        return True

    def _autotune_mark_now(self) -> dict:
        """One sensor reading: the controller's windows are the deltas of
        two marks, all from counters that never rewind (the restart tally
        is the lifetime one)."""
        res = _resilience.counters_snapshot(self.pipeline_label)
        return {"t": get_time(), "batches": self._batches_total,
                "busy": self._busy.seconds(),
                "transfer_wall": self._attr.seconds().get("transfer", 0.0),
                "input_wait": self._input_wait.value,
                "res": sum(res.values()) + self._faults_lifetime}

    def _autotune_step(self) -> None:
        """One controller step over the window since the last mark (at each
        reset() after a delivered batch, and every ``autotune_interval``
        delivered batches); the first call only takes the mark."""
        if self.autotuner is None:
            return
        mark, now = self._tune_mark, self._autotune_mark_now()
        self._tune_mark = now
        if mark is None:
            return
        busy = {k: max(0.0, now["busy"].get(k, 0.0) - mark["busy"].get(k, 0.0))
                for k in now["busy"]}
        self.autotuner.step({
            "wall": now["t"] - mark["t"],
            "batches": now["batches"] - mark["batches"],
            "input_wait": max(0.0, now["input_wait"] - mark["input_wait"]),
            "busy": busy,
            # the sampled landings scaled to the whole window
            "transfer_est": max(0.0, now["transfer_wall"] - mark["transfer_wall"])
            * max(1, self.transfer_sample),
            "resilience_events": max(0, now["res"] - mark["res"]),
        })

    # ---------------- warm epochs (the read pool) ----------------

    def _snapshot_geometry(self) -> dict:
        """The batch-shape identity a snapshot is bound to (the JAX
        package's dict, key for key)."""
        return {
            "v": _snapshot.SNAPSHOT_VERSION,
            "batch_size": self.batch_size,
            "num_col": self.num_col,
            "layout": self.layout,
            "x_dtype": self.x_dtype,
            "pack_aux": self.pack_aux,
            "quant": self._snap_quant,
            "drop_remainder": self.drop_remainder,
            "max_nnz": self.max_nnz if self.layout == "ell" else None,
        }

    def _open_snapshot(self) -> bool:
        if self._snap_reader is None:
            self._snap_reader = _snapshot.open_snapshot(
                self.snapshot_path, signature=self._snap_sig,
                geometry=self._snapshot_geometry())
        return self._snap_reader is not None

    def _stage_warm(self, plan_annot, pos: int, host_batch, resume,
                    nbytes) -> Optional[_Slot]:
        """A read pool worker's copy of the batch read at serving position
        ``pos`` into a staging slot (None once the ring closed): the raw
        span into a u8 slot, or each segment view into its typed buffer.
        Its annotation is the stored one, or in plan order
        ``plan_annot(pos + 1)``. The copy is snapshot read busy; the wait
        for a slot is not."""
        slot = self._ring.acquire()
        if slot is None:
            return None
        t0 = get_time()
        if self.device_decode:
            _, span, layout, kind = host_batch
            slot.bufs[0][: span.size].numpy()[...] = span
            slot.layout, slot.nbytes = layout, span.size
        else:
            kind, *arrays = host_batch
            check(len(arrays) == len(slot.bufs) and all(
                a.shape == tuple(b.shape) for a, b in zip(arrays, slot.bufs)),
                f"snapshot {self.snapshot_path}: batch shapes differ from the first batch's")
            for buf, arr in zip(slot.bufs, arrays):
                buf.view(torch.uint8).numpy()[...] = arr.view(np.uint8)
            slot.layout = None
        slot.kind = kind
        slot.annot = resume if plan_annot is None else plan_annot(pos + 1)
        self._busy.add("snapshot_read", get_time() - t0)
        return slot

    def _warm_feed(self, start: int) -> _snapshot.SnapshotIter:
        """The warm epoch's producer: each stored batch from position
        ``start`` on, in stored order or, with ``snapshot_shuffle_seed``,
        in the epoch's plan order, read (crc included) and copied into a
        staging slot on the ``snapshot_read_workers`` threads of a
        :class:`~dmlc_tpu_torch.io.snapshot.SnapshotIter`, delivered in
        that order."""
        reader = self._snap_reader
        n = reader.num_batches
        if self.device_decode:
            size = max((reader.batch_nbytes(i) for i in range(n)), default=0)
            spec = [((size,), torch.uint8)]
        else:
            layout = reader.layout(0) if n else ()
            spec = [(shape, torch_dtype(dt)) for _, dt, _, _, shape in layout]
        workers = self.snapshot_read_workers
        self._ring = self._ring_for(spec, 2 * workers, workers)
        order = plan_annot = None
        seed, epoch = self._snap_seed, self._snap_epoch
        if seed is not None and not self._snap_seq_restore:
            order = _epoch.block_permutation(seed, epoch, n)

            def plan_annot(pos: int) -> dict:
                return {"source": _epoch.plan_state_dict(seed, 0, epoch, pos, 0, 1, unit="batch"),
                        "skip_rows": 0}
        return _snapshot.SnapshotIter(
            reader, order=order, start=start, read_workers=workers,
            on_read=lambda dt: self._busy.add("snapshot_read", dt), raw=self.device_decode,
            stage=functools.partial(self._stage_warm, plan_annot))

    # ---------------- device side (consumer thread) ----------------

    def _host_iter(self):
        if self._host is None:
            if (self.snapshot_path is not None and not self._snap_suspend
                    and self._open_snapshot()):
                start, self._snap_pos0 = self._snap_pos0, 0
                self._host = self._warm_feed(start)
                self._snap_serving = True
            else:
                if (self.snapshot_path is not None and self._snap_writer is None
                        and self._shadow_write):
                    # cold epoch: shadow-write what it ships, publish at its end
                    self._snap_writer = _snapshot.SnapshotWriter(
                        self.snapshot_path, signature=self._snap_sig,
                        geometry=self._snapshot_geometry())
                skip, drop, seeked = self._skip_batches, self._drop_rows, self._seeked
                self._skip_batches = self._drop_rows = 0
                self._seeked = False
                self._host = self._cold_feed(skip, drop, seeked)
        return self._host

    def _put(self, slot: _Slot):
        """Issue a slot's copy to the device on the copy stream and hand the
        slot back to the ring with the copy's event; the issue is dispatch
        busy."""
        t0 = get_time()
        ctx = (torch.cuda.stream(self._copy_stream) if self._cuda
               else contextlib.nullcontext())
        if slot.layout is None:
            bufs = slot.bufs
        else:
            bufs = [(slot.raw if slot.use_raw else slot.bufs[0])[: slot.nbytes]]
        event = None
        with ctx, _telemetry.profiler_annotation("dmlc_tpu.dispatch"):
            out = [b.to(self.device, non_blocking=self._cuda, copy=True) for b in bufs]
            if self._cuda:
                event = torch.cuda.Event()
                event.record(self._copy_stream)
        dt = get_time() - t0
        self._busy.add("dispatch", dt)
        ctx = self._last_trace_ctx
        if ctx is not None:
            # the copy joins the (job, part) trace the source block carried:
            # grant -> parse -> recv -> decode -> dispatch as one chain
            _telemetry.record_span("dispatch", t0, dt, trace_id=ctx[0], parent_id=ctx[1])
        else:
            _telemetry.record_span("dispatch", t0, dt)
        nbytes = sum(b.numel() * b.element_size() for b in bufs)
        self.bytes_to_device += nbytes
        if slot.layout is not None and slot.kind not in _SPAN_KINDS:
            self.device_decode_bytes += nbytes
        entry = (out, event, slot.kind, slot.layout, slot.annot)
        self._ring.release(slot, event)
        return entry

    def _bcoo_batch(self, span: torch.Tensor, layout):
        """``(x, label, weight)`` viewed from a bcoo batch's span on the
        device, ``x`` on its real entries: one widening of the coordinates
        to int64 (and ones for elided values), no other work."""
        isz, nnz, real, rows, row_major, elide = layout
        o_val, o_label, o_weight, nbytes = _bcoo_offsets(isz, nnz, rows, not elide)
        idx_dtype = torch.int32 if isz == 4 else torch.int64
        coords = span[: 2 * nnz * isz].view(idx_dtype).view(2, nnz)[:, :real]
        vals = (torch.ones(real, dtype=torch.float32, device=span.device) if elide
                else span[o_val: o_val + 4 * real].view(torch.float32))
        x = torch.sparse_coo_tensor(
            coords.to(torch.int64, memory_format=torch.contiguous_format), vals,
            (rows, self.num_col), is_coalesced=row_major, check_invariants=False)
        self.nnz_shapes.add(nnz)
        return (x, span[o_label: o_label + 4 * rows].view(torch.float32),
                span[o_weight: nbytes].view(torch.float32))

    def _native_bcoo_batch(self, span: torch.Tensor, layout):
        """``(x, label, weight)`` from a :class:`CooBlock`'s span on the
        device: the CSR wire's row ids rebuilt (:func:`csr_coords`), the
        native pad scheme mapped to the port's with values masked by the
        raw columns (:func:`native_coo_to_port`), ``x`` on the real entries
        (the block's host count, no device read)."""
        csr, nnz, real, rows, row_major, has_values = layout
        o_ptr, o_val, o_label, o_weight, nbytes = _native_coo_offsets(
            csr, nnz, rows, has_values)
        if csr:
            cols = span[: 4 * real].view(torch.int32)
            coords = csr_coords(cols, span[o_ptr: o_ptr + 4 * (rows + 1)].view(torch.int32))
        else:
            coords = span[: 8 * real].view(torch.int32).view(real, 2)
        vals = span[o_val: o_val + 4 * real].view(torch.float32) if has_values else None
        coords, vals = native_coo_to_port(coords, vals, self.num_col, rows)
        x = torch.sparse_coo_tensor(
            coords.T.to(torch.int64, memory_format=torch.contiguous_format), vals,
            (rows, self.num_col), is_coalesced=row_major, check_invariants=False)
        self.nnz_shapes.add(nnz)
        return (x, span[o_label: o_label + 4 * rows].view(torch.float32),
                span[o_weight: nbytes].view(torch.float32))

    @staticmethod
    def _ell_span_batch(span: torch.Tensor, layout) -> EllBatch:
        """An :class:`EllBatch` viewed from a per-batch-K span."""
        rows, k = layout
        o_val, o_label, o_weight, nbytes = _ell_offsets(rows, k)
        return EllBatch(span[: 4 * rows * k].view(torch.int32).view(rows, k),
                        span[o_val: o_val + 4 * rows * k].view(torch.float32).view(rows, k),
                        span[o_label: o_label + 4 * rows].view(torch.float32),
                        span[o_weight: nbytes].view(torch.float32))

    def _fill(self) -> float:
        """Copy batches until ``prefetch`` are in flight (or the epoch
        ends); returns the seconds spent waiting on the producer."""
        waited = 0.0
        while len(self._inflight) < self.prefetch:
            t0 = get_time()
            try:
                with _telemetry.profiler_annotation("dmlc_tpu.input_wait"):
                    slot = self._host_iter().next()
            except BaseException as exc:  # noqa: BLE001 - classified below
                corrupt = self._snap_serving and isinstance(exc, CacheCorruptionError)
                if corrupt:
                    # the file goes first, so the restart runs cold
                    self._invalidate_snapshot()
                if self._maybe_restart_pipeline(exc, backoff=not corrupt):
                    continue
                raise
            waited += get_time() - t0
            if slot is None:
                # a complete cold pass publishes its shadow snapshot here
                self._finish_snapshot_writer()
                return waited
            if self._snap_writer is not None:
                # the shadow write follows delivery order, whatever order
                # the workers packed in
                t0 = get_time()
                self._write_snapshot_batch(slot)
                self.snapshot_write_seconds += get_time() - t0
            self._inflight.append(self._put(slot))
        return waited

    def __iter__(self):
        return self

    def _account_window(self, t0: float, busy0: dict, t1: float, write0: float) -> None:
        """Split the consumer's window ``[t0, t1]`` among the stages: the
        dispatch and device_decode measured on this thread as they are;
        the rest, less the shadow write, over the busy seconds the
        pipeline's threads added in the window, scaled down where they
        overlapped (workers running at once can add more than the window
        holds). What they do not explain stays unattributed."""
        busy1 = self._busy.seconds()
        d_disp = busy1["dispatch"] - busy0["dispatch"]
        d_decode = busy1["device_decode"] - busy0["device_decode"]
        window = ((t1 - t0) - d_disp - d_decode
                  - (self.snapshot_write_seconds - write0))
        weights = {k: busy1[k] - busy0[k]
                   for k in ("read", "cache_read", "snapshot_read", "parse", "convert")}
        wsum = sum(weights.values())
        if wsum > 0 and window > 0:
            scale = min(1.0, window / wsum)
            for k, v in weights.items():
                if v > 0:
                    self._attr.add(k, v * scale)
        self._attr.add("dispatch", d_disp)
        if d_decode > 0:
            self._attr.add("device_decode", d_decode)

    def __next__(self):
        # every consumer step runs under the pipeline's scope, so the pools
        # it creates take the label
        with _telemetry.scope(self.pipeline_label):
            return self._next_scoped()

    def _next_scoped(self):
        t0 = get_time()
        if self._t_first is None:
            self._t_first = t0
        busy0, write0 = self._busy.seconds(), self.snapshot_write_seconds
        self._fill()
        if not self._inflight:
            t_end = get_time()
            self.stall_seconds += t_end - t0
            self._account_window(t0, busy0, t_end, write0)
            self._t_last = t_end
            raise StopIteration
        out, event, kind, layout, annot = self._inflight.popleft()
        self._input_wait.inc(get_time() - t0)
        if self._host is not None:
            self.host_stall_seconds += self._host.stall_seconds
            self._host.stall_seconds = 0.0
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in out:
                t.record_stream(stream)
        if layout is None:
            batch = _device_decode.wrap_batch(kind, out, self.num_col)
        elif kind == "bcoo":
            batch = self._bcoo_batch(out[0], layout)
        elif kind == "bcoo_native":
            batch = self._native_bcoo_batch(out[0], layout)
        elif kind == "ell_span":
            batch = self._ell_span_batch(out[0], layout)
        else:
            # device decode, on the consumer's stream after the copy's event:
            # one K2 launch for the whole batch
            t_decode = get_time()
            batch = _device_decode.decode_batch(out[0], layout, kind, self.num_col)
            dt = get_time() - t_decode
            self.device_decode_seconds += dt
            self._busy.add("device_decode", dt)
            _telemetry.record_span("device_decode", t_decode, dt)
        # counted as delivered before the refill, which may heal the epoch
        # from this batch's state
        self.batches_fed += 1
        self._batches_total += 1
        self._last_resume = annot
        # issue the replacement copy before handing the batch out; a wait
        # on the producer here holds the consumer up as much as one above
        self._input_wait.inc(self._fill())
        t1 = get_time()
        self.stall_seconds += t1 - t0
        self._account_window(t0, busy0, t1, write0)
        if self.transfer_sample and self.batches_fed % self.transfer_sample == 0:
            # the sampled landing: a host wait on this batch's copy event
            # alone, never on a compute stream
            ts = get_time()
            if event is not None:
                with _telemetry.profiler_annotation("dmlc_tpu.transfer"):
                    event.synchronize()
            dt = get_time() - ts
            self._attr.add("transfer", dt)
            self._input_wait.inc(dt)
            _telemetry.record_span("transfer", ts, dt)
            self._transfer_samples += 1
        if self._autotune_interval and self._batches_total % self._autotune_interval == 0:
            self._autotune_step()
        self._t_last = get_time()
        return batch

    # ---------------- checkpoints ----------------

    def state_dict(self) -> dict:
        """The resume point after the last delivered batch: a seek where
        that batch carries a source annotation, else the batch count."""
        if self._last_resume is not None:
            return {"kind": "source", "batches": self.batches_fed, **self._last_resume}
        return {"kind": "batches", "batches": self.batches_fed}

    def load_state(self, state: dict) -> None:
        """Restore a :meth:`state_dict` (of either package): warm serving
        at the state's batch when a snapshot holds it, else a seek of the
        source or a replay of the count (module docstring)."""
        with _telemetry.scope(self.pipeline_label):
            self._load_state_scoped(state)

    def _load_state_scoped(self, state: dict) -> None:
        if self.snapshot_path is not None:
            if self._load_snapshot_state(state):
                return
            # the seeked source owns the rest of this epoch, and a pass
            # joined mid-epoch cannot write a whole snapshot
            self._abort_snapshot_writer()
            self._shadow_write = False
            self._snap_suspend = True
        self._teardown()
        if state.get("kind") == "source":
            self.source.load_state(state["source"])
            self._drop_rows = int(state["skip_rows"])
            self._seeked = True
            self._last_resume = {k: state[k] for k in ("source", "skip_rows")}
            self.batches_fed = int(state["batches"])
            return
        n = int(state["batches"])
        self._skip_batches, self._drop_rows, self._seeked = n, 0, False
        self._last_resume = None
        for _ in range(n):
            skipped = self._host_iter().next()
            if skipped is None:
                break
            # the replayed batch's annotation makes a later state a seek
            self._last_resume = skipped.annot
        self.batches_fed = n

    def _load_snapshot_state(self, state: dict) -> bool:
        """Restore into warm serving at batch ``n`` when the snapshot holds
        it: snapshot batches are 1:1 with pipeline batches at one geometry,
        so the delivered count is the warm position. A batch-plan state
        (``unit="batch"`` under ``source``) adopts its plan and position,
        rebuilding a vanished snapshot first. False hands the state to the
        cold machinery: a block-plan state, which the source replays, or
        a state the snapshot does not hold."""
        kind, n = state.get("kind"), int(state.get("batches", 0))
        src = state.get("source") if kind == "source" else None
        if isinstance(src, dict) and src.get("kind") == "epoch_plan":
            if src.get("unit") != "batch":
                return False
            self._teardown()
            self._abort_snapshot_writer()
            self._shadow_write = False
            self._snap_suspend = False
            self._snap_seq_restore = False
            seed = src.get("seed")
            self._snap_seed = None if seed is None else int(seed)
            self._snap_epoch = int(src.get("epoch", 0))
            pos = int(src.get("pos", n))
            if not self._open_snapshot():
                self._rebuild_snapshot()
            self._snap_pos0 = pos
            self.batches_fed = n
            self._last_resume = {"source": dict(src), "skip_rows": 0} if pos else None
            return True
        if kind not in ("source", "batches") or not self._open_snapshot():
            return False
        if n > self._snap_reader.num_batches:
            return False
        self._teardown()
        self._abort_snapshot_writer()
        self._shadow_write = False
        self._snap_suspend = False
        # a position in the stored order: the rest of this epoch serves in it
        self._snap_seq_restore = self._snap_seed is not None
        self._snap_pos0 = self.batches_fed = n
        if kind == "source":
            self._last_resume = {k: state[k] for k in ("source", "skip_rows")}
        else:
            self._last_resume = self._snap_reader.resume(n - 1) if n else None
        return True

    # ---------------- epochs and the snapshot's life ----------------

    def _finish_snapshot_writer(self) -> None:
        writer, self._snap_writer = self._snap_writer, None
        if writer is not None:
            writer.finish()

    def _abort_snapshot_writer(self) -> None:
        writer, self._snap_writer = self._snap_writer, None
        if writer is not None:
            writer.abort()

    def _drop_snap_reader(self) -> None:
        reader, self._snap_reader = self._snap_reader, None
        if reader is not None:
            reader.close()

    def _invalidate_snapshot(self) -> None:
        """A warm batch failed its crc: remove the file, so the next epoch
        runs cold and writes it anew."""
        _resilience.record_event("snapshot_corruptions")
        self._drop_snap_reader()  # releases the reader's pin first
        _block_cache._artifact_store(self.snapshot_path).discard(self.snapshot_path)

    def _rebuild_snapshot(self) -> None:
        """Rebuild a vanished snapshot in one silent cold pass: every batch
        converted and written, none delivered. Parsing and packing are
        deterministic, so the rebuilt batches are the lost ones, byte for
        byte."""
        _resilience.record_event("snapshot_rebuilds")
        self._drop_snap_reader()  # releases the reader's pin first
        _block_cache._artifact_store(self.snapshot_path).discard(self.snapshot_path)
        self._abort_snapshot_writer()
        self._snap_writer = _snapshot.SnapshotWriter(
            self.snapshot_path, signature=self._snap_sig, geometry=self._snapshot_geometry())
        feed = self._cold_feed(0, 0, False)
        try:
            while True:
                slot = feed.next()
                if slot is None:
                    break
                self._write_snapshot_batch(slot)
                self._ring.release(slot, None)  # written, never copied
            self._finish_snapshot_writer()
        except BaseException:
            self._abort_snapshot_writer()
            raise
        finally:
            feed.destroy()
        check(self._open_snapshot(),
              f"snapshot {self.snapshot_path}: rebuild did not publish a readable snapshot")

    def _maybe_restart_pipeline(self, exc: BaseException, backoff: bool = True) -> bool:
        """Re-arm the epoch at the batch after the last one delivered,
        through the checkpoint machinery, for a retryable ``exc`` within
        the epoch's budget (the JAX package's rule), after the policy's
        backoff unless ``backoff`` is off. False: ``exc`` must propagate (a
        fatal error, or the budget is spent). A replay that fails again is
        judged the same way."""
        verdict = _resilience.restart_verdict(self._retry_policy, self.pipeline_restarts, exc)
        if verdict == "giveup":
            self.pipeline_giveups += 1
            self._faults_lifetime += 1
            return False
        if verdict != "restart":
            return False
        used = self.pipeline_restarts
        self.pipeline_restarts += 1
        self._faults_lifetime += 1
        if backoff:
            _resilience.restart_backoff(self._retry_policy, used, exc)
        try:
            self.load_state(self.state_dict())
        except BaseException as nxt:  # noqa: BLE001 - judged as the first
            return self._maybe_restart_pipeline(nxt, backoff)
        return True

    def _teardown(self) -> None:
        self._inflight.clear()
        if self._host is not None:
            self._ring.close()     # unblocks a producer waiting for a slot
            self._host.destroy()
            self._host = None
            self._ring.reopen()
        self._snap_serving = False

    def reset(self) -> None:
        """New epoch: stop the producer; the next pull restarts the source,
        or serves the snapshot once a complete pass has published it. A
        cold pass cut short here is not published. After a delivered batch
        the snapshot plan's epoch advances, and an armed autotuner takes a
        step over the finished window (its changes reach the pools the next
        epoch builds, and the live ones)."""
        if self.batches_fed > 0:
            self._autotune_step()
            self._snap_epoch += 1
        self._snap_seq_restore = False
        self._teardown()
        self._abort_snapshot_writer()
        self.batches_fed = 0
        self.pipeline_restarts = 0  # a fresh budget an epoch
        self.pipeline_giveups = 0
        self._skip_batches = self._drop_rows = self._snap_pos0 = 0
        self._seeked = False
        self._last_resume = None
        self._shadow_write = True
        self._snap_suspend = False

    def close(self) -> None:
        self._teardown()
        self._abort_snapshot_writer()
        self._drop_snap_reader()
        self.source.close()
        if self._trace_export:
            # DMLC_TPU_TRACE=chrome:<path>: every stage has written its spans
            try:
                self.dump_trace(self._trace_export)
            except OSError as exc:
                get_logger().warning("trace export to %s failed: %s", self._trace_export, exc)

    def dump_trace(self, path: str) -> int:
        """Export the span rings as Chrome-trace JSON at ``path``; returns
        the spans written. The trace covers the process: filter by the
        ``pipeline`` arg for this iterator's spans."""
        return _telemetry.export_chrome_trace(path)

    def stats(self) -> dict:
        """The pipeline's counters. Every key of the JAX package's
        ``stats()`` is here with its value type (``batches`` first; the port's own ``batches_fed`` is the same
        count). ``stages`` splits ``wall_seconds`` (first pull to the
        latest) among read / cache_read / snapshot_read / parse / convert /
        dispatch / device_decode / transfer, its sum never above the wall;
        ``stage_busy`` holds the busy seconds it is scaled from, summed
        over threads (so they may exceed the wall); ``transfer`` is the
        sampled copy landings, ``transfer_samples`` their count (module
        docstring). ``input_wait_seconds`` is the consumer's wait inside
        ``__next__`` for the batch it hands out and on the pool in the
        refill behind it, plus those landings;
        ``host_stall_seconds`` its wait on the pool. ``convert_cpu_seconds``
        (the port's own) is the convert pool's thread CPU time, each
        call's capped at the seconds it adds to ``convert_seconds``: the
        difference is the
        convert pool's time off the CPU (waiting for the interpreter lock,
        or preempted). ``staging_ring`` is
        ``{"depth", "hits", "misses"}`` of the current ring (None before
        the first epoch); a miss is an acquire that waited for a free slot.
        ``shuffle_seed`` and ``epoch`` are the source's epoch plan (None
        without one), ``snapshot_seed`` and ``snapshot_epoch`` the snapshot
        plan's (None without a snapshot). ``parse_workers`` and
        ``parse_parallelism_efficiency`` (the whole ``parse_parallel``
        sideband beside them) are the source chain's parse fan-out, as the
        JAX package reports them. ``resilience`` holds the I/O events
        recorded under this pipeline's label since it was built
        (:mod:`dmlc_tpu_torch.io.resilience`) and its own restarts.
        ``autotune`` is the autotuner's snapshot (knobs, steps, adjustments,
        convergence, the last decisions), None when it is not armed.
        ``store`` is the tiered artifact store's counters
        (:func:`~dmlc_tpu_torch.store.manager.store_counters`): the live
        managed bytes of every store this process opened, and the
        process-wide evictions and eviction-triggered rebuilds, since a
        budget squeeze from any pipeline can evict this one's files."""
        plan_state = getattr(self.source, "plan_state", None) or {}
        snap = self.snapshot_path is not None
        # the source chain's parse fan-out (ParallelTextParser); a
        # one-lane source reports one worker and no efficiency
        fn = getattr(self.source, "parallel_stats", None)
        pstats = fn() if fn is not None else None
        wall = 0.0
        if self._t_first is not None and self._t_last is not None:
            wall = max(0.0, self._t_last - self._t_first)
        resilience = _resilience.counters_delta(self._res_base, self.pipeline_label)
        resilience["pipeline_restarts"] = self.pipeline_restarts
        resilience["pipeline_giveups"] = self.pipeline_giveups
        busy = self._busy.seconds()
        return {"batches": self.batches_fed,
                "batches_fed": self.batches_fed,
                "bytes_to_device": self.bytes_to_device,
                "pipeline": self.pipeline_label,
                "stall_seconds": self.stall_seconds,
                "host_stall_seconds": self.host_stall_seconds,
                "source_wait_seconds": self.source_wait_seconds,
                "convert_seconds": busy["convert"],
                "convert_cpu_seconds": self._convert_cpu.value,
                # None: no snapshot armed; 'cold': converting and
                # shadow-writing; 'warm': serving the stored batches
                "snapshot_state": (None if self.snapshot_path is None
                                   else "warm" if self._snap_serving else "cold"),
                # the parse-once block cache of the source chain: None
                # without one, else 'cold' or 'warm'
                "cache_state": getattr(self.source, "cache_state", None),
                "shuffle_seed": plan_state.get("shuffle_seed"),
                "epoch": plan_state.get("epoch"),
                "snapshot_seed": self._snap_seed if snap else None,
                "snapshot_epoch": self._snap_epoch if snap else None,
                "input_wait_seconds": self._input_wait.value,
                "snapshot_write_seconds": self.snapshot_write_seconds,
                "snapshot_read_seconds": busy["snapshot_read"],
                "device_decode": self.device_decode,
                "device_decode_bytes": self.device_decode_bytes,
                "device_decode_seconds": self.device_decode_seconds,
                "stages": self._attr.seconds(),
                "stage_busy": busy,
                "wall_seconds": wall,
                "transfer_samples": self._transfer_samples,
                "convert_workers": self.convert_workers,
                "parse_workers": (pstats or {}).get("parse_workers", 1),
                "parse_parallelism_efficiency": (pstats or {}).get(
                    "parse_parallelism_efficiency"),
                "parse_parallel": pstats,
                "staging_ring": self._ring.stats() if self._ring is not None else None,
                "autotune": self.autotuner.snapshot() if self.autotuner is not None else None,
                "resilience": resilience,
                "store": store_counters()}
