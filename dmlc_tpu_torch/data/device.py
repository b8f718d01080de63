"""Async host->device batch pipeline — ``DeviceIter``.

The PyTorch counterpart of the JAX package's ``data/device.py`` for the
``dense``, ``ell`` and ``bcoo`` layouts. Parsed RowBlocks are rebatched to
one fixed shape on the host (or, for bcoo, kept as they come), converted to
the device layout on a producer thread into a ring of pinned staging
buffers, and copied to the device ``prefetch`` batches ahead of
consumption:

- each batch is copied with ``.to(device, non_blocking=True)`` on a
  dedicated copy stream, and a per-batch ``torch.cuda.Event`` is recorded
  after the copy;
- the consumer's stream waits on that event before the step, and the
  batch's tensors are ``record_stream``-ed onto it, so the caching
  allocator cannot hand their memory out while the step still reads it;
- a staging slot is refilled only after its copy event has completed: a
  pinned buffer rewritten while its async copy is in flight would corrupt
  the batch.

Dense batches are :class:`PackedDenseBatch` (one ``[B, num_col + 2]``
slab: features | label | weight) when ``pack_aux`` is on, the default for
float32; ``x_dtype="bfloat16"`` ships the features (and, packed, the
label and weight, which must then be bf16-exact) in bfloat16.

**Snapshot store.** With ``snapshot=`` (or a parser from
``create_parser(..., snapshot=path)``) the first complete epoch
shadow-writes every batch it ships (:mod:`dmlc_tpu_torch.io.snapshot`),
and later epochs serve them from the file with no parse and no convert:

- host decode (default): each batch's segments are read as mmap views,
  copied into pinned staging slots and copied to the device as in a cold
  epoch;
- ``device_decode=True``: each batch's raw container bytes go through one
  pinned u8 staging slot, cross as one async u8 copy, and
  :func:`~dmlc_tpu_torch.ops.device_decode.decode_batch` turns them into
  the batch on the consumer's stream after the copy's event, in one launch
  of kernel K2 (float slabs copied, an int8 slab dequantized, a bfloat16
  packed slab's label and weight widened to float32 in the same pass).

Counters: ``stall_seconds`` is the consumer's time inside ``__next__``
(waiting for the producer, issuing copies, and in device-decode epochs the
decode's dispatch, also counted alone in ``device_decode_seconds``);
``bytes_to_device`` counts the bytes copied, ``device_decode_bytes`` those
that crossed as raw spans. On the producer side, ``source_wait_seconds`` is
the time blocked on the parser, ``convert_seconds`` the time spent
rebatching, converting and packing, ``snapshot_write_seconds`` the cold
epoch's shadow write, and ``snapshot_read_seconds`` a warm epoch's reads
(crc included) and copies into staging. A warm epoch adds nothing to
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

**Healing.** A warm batch that fails its crc32 removes the file. Within the
restart budget (:mod:`dmlc_tpu_torch.io.resilience`: ``max_attempts - 1``
restarts an epoch, ``DMLC_RETRY_MAX_ATTEMPTS``, default 4) the epoch then
goes on cold from the batch after the last one delivered, through
``load_state(state_dict())`` as in the JAX package: a seek where the stored
annotation allows, a replay by count otherwise.
``stats()["resilience"]["pipeline_restarts"]`` counts the restarts; past
the budget the ``CacheCorruptionError`` propagates. The next epoch runs
cold and writes the snapshot anew.

**bcoo.** ``layout="bcoo"`` batches are ``(x, label, weight)`` with ``x`` a
torch sparse COO tensor ``[rows, num_col]`` on the device (pad scheme in
:mod:`dmlc_tpu_torch.ops.sparse`): a fixed ``batch_size``, with nnz padded
to multiples of ``nnz_bucket`` (planned in stream order, so the tail batch
pads into a shape already emitted), or natural blocks (``batch_size=None``,
rows rounded up to ``row_bucket``). A batch's coordinates, values, label
and weight cross as one u8 span, pad slots included, so transfer sizes
repeat; on the device ``x`` is built on views of the real entries only.
Pad slots inside ``x`` would share a coordinate, and torch assumes unique
coordinates in a tensor marked coalesced: ``to_dense`` then keeps one of
the duplicates, not their sum. ``x`` is marked coalesced when its
coordinates are in strict row-major order, so a product with it does not
coalesce (a host sync) on the card. ``nnz_shapes`` collects the nnz
capacities the delivered spans had. Snapshots store fixed shapes only and
refuse bcoo.

**Meshes.** With ``mesh=`` (:mod:`dmlc_tpu_torch.parallel`) this rank's
pipeline feeds its slice of each global batch: ``batch_size`` is the
rank's own row count, batches land on the mesh's device for this rank,
and the global batch is the ranks' batches concatenated in rank order (the
JAX package's ``make_array_from_process_local_data`` layout). As there,
bcoo and snapshots are refused under a mesh, and dense batches ship
unpacked (``pack_aux`` off). ``shardings`` (a learner's
``batch_shardings()``) must split every array's rows over the data axis.

On a CPU device the same pipeline runs without pinning, streams or events
(the copy is synchronous). Not ported yet: feature-sharded placement and
autotuning.
"""

from __future__ import annotations

import contextlib
import queue
from collections import deque
from typing import Iterator, List, Optional

import numpy as np
import torch

from dmlc_tpu_torch.data import epoch as _epoch
from dmlc_tpu_torch.data.row_block import RowBlock, RowBlockContainer
from dmlc_tpu_torch.io import resilience as _resilience
from dmlc_tpu_torch.io import snapshot as _snapshot
from dmlc_tpu_torch.io.block_cache import remove_quietly, torch_dtype
from dmlc_tpu_torch.io.threaded_iter import ThreadedIter
from dmlc_tpu_torch.ops import device_decode as _device_decode
from dmlc_tpu_torch.ops.device_decode import PackedDenseBatch  # noqa: F401 (re-exported)
from dmlc_tpu_torch.ops.sparse import block_to_bcoo_host, block_to_dense, block_to_ell
from dmlc_tpu_torch.parallel.mesh import rank_device
from dmlc_tpu_torch.utils import knobs as _knobs
from dmlc_tpu_torch.utils.check import CacheCorruptionError, DMLCError, check
from dmlc_tpu_torch.utils.timer import get_time

# converted batches the producer may hold ready ahead of the consumer
_CONVERT_AHEAD = 2
_X_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the derived bcoo nnz bucket's ceiling: the bucket is also a batch's worst
# pad, and batch_size * max_nnz is a ceiling, not a density
_NNZ_BUCKET_CAP = 512 * 1024
_SPAN_ALIGN = 64


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


def _require_bf16_exact(packed_col: torch.Tensor, src: np.ndarray, what: str) -> None:
    """``packed_col`` is a just-packed bfloat16 aux column, ``src`` its
    float32 source: raise when the cast lost precision."""
    if not np.array_equal(packed_col.to(torch.float32).numpy(), src):
        raise DMLCError(
            f"bfloat16 aux packing: this batch's {what}s are not bf16-exact — "
            f"packing would silently corrupt them. Keep the {what}s "
            "float32-packable (pack_aux=False) or use x_dtype='float32'")


class _Slot:
    """Pinned staging buffers and what the consumer needs to ship them:
    the batch ``kind``, its checkpoint annotation ``annot``, and for one u8
    span (a raw snapshot span, a bcoo batch) its ``layout`` and
    ``nbytes``."""

    __slots__ = ("bufs", "event", "kind", "layout", "nbytes", "annot")

    def __init__(self, bufs: List[torch.Tensor]):
        self.bufs = bufs
        self.event: Optional[torch.cuda.Event] = None  # copy out of bufs
        self.kind = ""
        self.layout = None
        self.nbytes = 0
        self.annot: Optional[dict] = None


class _Skipped:
    """A batch the producer skipped, unconverted, for a count restore;
    it carries the batch's annotation only."""

    __slots__ = ("annot",)

    def __init__(self, annot: Optional[dict]):
        self.annot = annot


class _StagingRing:
    """Host staging buffers a producer packs batches into.

    A slot cycles free -> filled by the producer -> copied by the consumer
    -> free again; the consumer records the copy's event on the slot when it
    hands it back, and :meth:`acquire` waits on that event before the
    producer may rewrite the buffers. :meth:`close` unblocks a producer
    waiting for a slot (it then gets None)."""

    def __init__(self, slots: List[_Slot]):
        self._slots = slots
        self._free: "queue.Queue[Optional[_Slot]]" = queue.Queue()
        self.reopen()

    def acquire(self) -> Optional[_Slot]:
        slot = self._free.get()
        if slot is not None and slot.event is not None:
            slot.event.synchronize()
        return slot

    def release(self, slot: _Slot, event: Optional[torch.cuda.Event]) -> None:
        slot.event = event
        self._free.put(slot)

    def close(self) -> None:
        self._free.put(None)

    def reopen(self) -> None:
        """Every slot free again (the producer is stopped)."""
        self._free = queue.Queue()
        for slot in self._slots:
            self._free.put(slot)


def _align(n: int) -> int:
    return -(-n // _SPAN_ALIGN) * _SPAN_ALIGN


def _bcoo_offsets(index_bytes: int, nnz: int, rows: int):
    """Where a bcoo batch's segments lie in its span: coordinates ``[2,
    nnz]`` (rows, then columns), values ``[nnz]`` f32, label and weight
    ``[rows]`` f32, each 64-byte aligned. Returns the four offsets and the
    span's size."""
    o_val = _align(2 * nnz * index_bytes)
    o_label = o_val + _align(4 * nnz)
    o_weight = o_label + _align(4 * rows)
    return o_val, o_label, o_weight, o_weight + 4 * rows


def _row_major(block: RowBlock) -> bool:
    """Whether the block's coordinates are unique and in row-major order:
    columns strictly increasing within each row (rows ascend by
    construction)."""
    idx = block.index
    if len(idx) < 2:
        return True
    out_of_order = np.diff(idx.astype(np.int64)) <= 0  # entry i + 1 vs entry i
    starts = block.offset[1:-1]
    starts = starts[(starts > 0) & (starts < len(idx))]
    out_of_order[starts - 1] = False  # a row starts anywhere
    return not bool(out_of_order.any())


class DeviceIter:
    """Prefetching host->device batch iterator for the ``dense``, ``ell``
    and ``bcoo`` layouts, with the snapshot store and its device-decode
    tier, and mid-epoch checkpoints (module docstring).

    ``dense`` batches are :class:`PackedDenseBatch` with ``pack_aux`` (the
    default for ``x_dtype="float32"``), else ``(x [B, num_col], label [B],
    weight [B])``; ``ell`` batches are
    :class:`~dmlc_tpu_torch.ops.sparse.EllBatch` with ``[B, max_nnz]`` int32
    indices (pad index ``num_col``) and float32 values; ``bcoo`` batches are
    ``(x, label, weight)`` with ``x`` a sparse COO tensor. Every batch has
    ``batch_size`` rows: the epoch's last partial batch is padded with
    zero-weight rows, or dropped with ``drop_remainder``. ``batch_size=None``
    (bcoo only) ships each parsed block as it comes, its rows rounded up to
    ``row_bucket``. ``nnz_bucket`` rounds a bcoo batch's nnz up to its
    multiples (default ``min(batch_size * max_nnz, 512 Ki)``, 4096 without
    ``max_nnz``, 16384 for natural blocks; 0 keeps exact shapes).

    ``snapshot`` names the snapshot file (default: the source's
    ``snapshot_path``, stamped by ``create_parser(..., snapshot=)``, with its
    ``snapshot_signature``); ``snapshot_quant="int8"`` stores packed dense
    batches as int8 plus a per-column scale; ``device_decode=True`` decodes
    warm batches on the device; ``snapshot_shuffle_seed`` serves warm
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
        drop_remainder: bool = False,
        device=None,
        x_dtype: str = "float32",
        pack_aux: Optional[bool] = None,
        nnz_bucket: Optional[int] = None,
        row_bucket: int = 1024,
        snapshot: Optional[str] = None,
        snapshot_signature: Optional[dict] = None,
        snapshot_quant: Optional[str] = None,
        device_decode: Optional[bool] = None,
        snapshot_shuffle_seed: Optional[int] = None,
    ):
        check(layout in ("dense", "ell", "bcoo"), f"unknown layout {layout!r}")
        check(batch_size is not None or layout == "bcoo",
              "batch_size=None (natural blocks) requires layout='bcoo'")
        check(batch_size is None or batch_size > 0,
              "DeviceIter: batch_size must be a positive integer")
        check(layout != "ell" or (max_nnz is not None and max_nnz > 0),
              "DeviceIter: layout='ell' needs max_nnz (one fixed [B, K] shape)")
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
        if mesh is not None and self.shardings is not None:
            self._check_shardings(layout)
        self.source = source
        self.num_col = int(num_col)
        self.batch_size = None if batch_size is None else int(batch_size)
        self.layout = layout
        self.max_nnz = None if max_nnz is None else int(max_nnz)
        self.prefetch = _knobs.prefetch(prefetch)
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
        check(snapshot_quant in (None, "int8"), f"unknown snapshot_quant {snapshot_quant!r}")
        check(snapshot_quant is None or (snapshot is not None and self.pack_aux),
              "snapshot_quant='int8' applies to snapshotted packed dense "
              "batches (layout='dense' with pack_aux)")
        # an explicit request needs a snapshot; the environment's arms the
        # decode only where one is present, as in the JAX package
        check(not device_decode or snapshot is not None,
              "device_decode=True decodes warm snapshot batches: it needs snapshot=")
        check(snapshot is None
              or (getattr(source, "plan_state", None) or {}).get("shuffle_seed") is None,
              "snapshot= cannot combine with a source-side epoch "
              "plan (shuffle_seed on the block cache): the snapshot "
              "freezes one epoch's batch order — shuffle snapshot "
              "epochs with snapshot_shuffle_seed= instead "
              "(docs/data.md)")
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
        # its policy) and this epoch's restarts
        self._max_attempts = _resilience.max_attempts_from_env()
        self.pipeline_restarts = 0
        self.pipeline_giveups = 0
        self.stall_seconds = 0.0
        self.input_wait_seconds = 0.0
        self.batches_fed = 0
        self.bytes_to_device = 0
        self.device_decode_bytes = 0
        self.device_decode_seconds = 0.0
        # written by the producer thread only
        self.source_wait_seconds = 0.0
        self.convert_seconds = 0.0
        self.snapshot_write_seconds = 0.0
        self.snapshot_read_seconds = 0.0
        self._cuda = self.device.type == "cuda"
        self._copy_stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._rings: dict = {}  # staging rings by buffer spec, kept across epochs
        self._ring: Optional[_StagingRing] = None  # the current producer's
        self._host: Optional[ThreadedIter] = None  # cold convert or warm read
        self._inflight: deque = deque()

    def _check_shardings(self, layout: str) -> None:
        """A learner's ``batch_shardings()`` must split every array of a
        batch by rows over this mesh's data axis, and nothing else."""
        want = 4 if layout == "ell" else 3
        rows_split = all(
            getattr(sh, "mesh", None) is self.mesh and len(sh.spec) >= 1
            and sh.spec[0] == self.data_axis and not any(sh.spec[1:])
            for sh in self.shardings)
        check(len(self.shardings) == want and rows_split,
              f"DeviceIter: shardings must be {want} row splits over the mesh's "
              f"{self.data_axis!r} axis (a learner's batch_shardings()), got "
              f"{self.shardings}")

    # ---------------- staging ----------------

    def _ring_for(self, spec) -> _StagingRing:
        """The staging ring for ``spec``, a tuple of ``(shape, dtype)``."""
        spec = tuple(spec)
        if spec not in self._rings:
            depth = _CONVERT_AHEAD + self.prefetch + 2
            self._rings[spec] = _StagingRing([
                _Slot([torch.empty(shape, dtype=dt, pin_memory=self._cuda)
                       for shape, dt in spec])
                for _ in range(depth)])
        return self._rings[spec]

    def _cold_kind(self) -> str:
        if self.layout != "dense":
            return self.layout
        return "dense_packed" if self.pack_aux else "dense"

    def _cold_spec(self):
        B, f32 = self.batch_size, torch.float32
        if self.layout == "bcoo":
            # one u8 span a batch, grown in place when a batch needs more
            rows = B or self.row_bucket or 1024
            return [((_bcoo_offsets(4, self.nnz_bucket or 4096, rows)[-1],), torch.uint8)]
        if self.layout == "ell":
            K = self.max_nnz
            return [((B, K), torch.int32), ((B, K), f32), ((B,), f32), ((B,), f32)]
        xdt = _X_DTYPES[self.x_dtype]
        if self.pack_aux:
            return [((B, self.num_col + 2), xdt)]
        return [((B, self.num_col), xdt), ((B,), f32), ((B,), f32)]

    # ---------------- cold epochs (producer thread) ----------------

    def _blocks(self, seeked: bool) -> Iterator[RowBlock]:
        if not seeked:  # a seek-restored source already stands at the resume point
            self.source.before_first()
        while True:
            t0 = get_time()
            blk = self.source.next_block()
            self.source_wait_seconds += get_time() - t0
            if blk is None:
                return
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
        """``(batch block, annotation, bcoo nnz pad)`` in stream order: the
        annotation of the last block boundary at or before the batch's end
        (None before the first), and the nnz pad planned here, in order, so
        the tail batch pads into a shape already emitted."""
        if self.batch_size is None:  # natural blocks: no annotations
            for block in self._blocks(seeked):
                yield block, None, self._plan_bcoo_pad_nnz(block)
            return
        boundaries: deque = deque()
        cur, emitted = None, 0
        for block in rebatch_blocks(self._tracked_blocks(boundaries, drop, seeked),
                                    self.batch_size, self.drop_remainder):
            emitted += len(block)
            while boundaries and boundaries[0][0] <= emitted:
                cur = boundaries.popleft()
            annot = None if cur is None else {"source": cur[1], "skip_rows": emitted - cur[0]}
            pad_nnz = self._plan_bcoo_pad_nnz(block) if self.layout == "bcoo" else None
            yield block, annot, pad_nnz

    def _plan_bcoo_pad_nnz(self, block: RowBlock) -> Optional[int]:
        """A bcoo batch's nnz pad: up to the bucket multiple; a fixed-batch
        tail pads up to the smallest nnz full batches already emitted that
        fits it, so an epoch adds no shape on its last batch."""
        if not self.nnz_bucket:
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
        if self.batch_size is not None:
            pad = self.batch_size if len(block) != self.batch_size else None
        else:  # natural blocks: round the rows up too
            pad = -(-len(block) // self.row_bucket) * self.row_bucket if self.row_bucket else None
        if self.layout == "dense":
            return block_to_dense(block, self.num_col, pad_rows_to=pad)
        if len(block.index) and int(block.index.max()) >= self.num_col:
            # ell's pad index num_col addresses the sink, and torch's sparse
            # tensors mask nothing: a larger index would read outside the
            # weight table
            raise DMLCError(
                f"DeviceIter: feature index {int(block.index.max())} >= "
                f"num_col {self.num_col}")
        if self.layout == "bcoo":
            return block_to_bcoo_host(block, self.num_col, pad_rows_to=pad,
                                      pad_nnz_to=pad_nnz) + (len(block.index),
                                                             _row_major(block))
        return tuple(block_to_ell(block, self.num_col, max_nnz=self.max_nnz,
                                  pad_rows_to=pad))

    def _pack(self, slot: _Slot, arrays) -> None:
        """Copy a converted batch into its staging slot; torch casts to a
        bfloat16 slot with round-to-nearest-even."""
        if self.layout == "bcoo":
            self._pack_bcoo(slot, arrays)
            return
        if not self.pack_aux:
            for buf, arr in zip(slot.bufs, arrays):
                buf.copy_(torch.from_numpy(arr))
            return
        x, y, w = arrays
        packed, nc = slot.bufs[0], self.num_col
        packed[:, :nc].copy_(torch.from_numpy(x))
        packed[:, nc].copy_(torch.from_numpy(y))
        packed[:, nc + 1].copy_(torch.from_numpy(w))
        if self._aux_exact_check:
            _require_bf16_exact(packed[:, nc], y, "label")
            _require_bf16_exact(packed[:, nc + 1], w, "weight")

    def _pack_bcoo(self, slot: _Slot, arrays) -> None:
        """A bcoo batch into the slot's u8 span (:func:`_bcoo_offsets`),
        the span grown first when the batch needs more bytes."""
        coords, vals, label, weight, (rows, _), real_nnz, row_major = arrays
        nnz, isz = len(vals), coords.dtype.itemsize
        o_val, o_label, o_weight, nbytes = _bcoo_offsets(isz, nnz, rows)
        if slot.bufs[0].numel() < nbytes:
            # the ring handed the slot out after its last copy completed
            slot.bufs[0] = torch.empty(max(nbytes, 2 * slot.bufs[0].numel()),
                                       dtype=torch.uint8, pin_memory=self._cuda)
        span = slot.bufs[0].numpy()
        span[: 2 * nnz * isz].view(coords.dtype).reshape(2, nnz)[...] = coords.T
        span[o_val: o_val + 4 * nnz].view(np.float32)[...] = vals
        span[o_label: o_label + 4 * rows].view(np.float32)[...] = label
        span[o_weight: nbytes].view(np.float32)[...] = weight
        slot.layout = (isz, nnz, real_nnz, rows, row_major)
        slot.nbytes = nbytes

    def _write_snapshot_batch(self, slot: _Slot) -> None:
        kind, arrays = slot.kind, slot.bufs
        if self._snap_quant == "int8":
            q, scale = _device_decode.quantize_int8(arrays[0].to(torch.float32).numpy())
            kind, arrays = "dense_packed_q8", (q, scale)
        self._snap_writer.add_batch(kind, arrays, rows=self.batch_size, resume=slot.annot)

    def _host_batches(self, skip: int, drop: int, seeked: bool) -> Iterator:
        """The cold producer: each batch converted and packed into a
        staging slot, after ``skip`` batches yielded unconverted as
        :class:`_Skipped` (a count restore)."""
        kind = self._cold_kind()
        t0, wait0 = get_time(), self.source_wait_seconds
        for block, annot, pad_nnz in self._source_batches(drop, seeked):
            if skip:
                skip -= 1
                yield _Skipped(annot)
                t0, wait0 = get_time(), self.source_wait_seconds
                continue
            arrays = self._convert(block, pad_nnz)
            t_acquire = get_time()
            slot = self._ring.acquire()
            if slot is None:  # the ring closed: the epoch is being torn down
                return
            t_pack = get_time()
            slot.kind, slot.layout, slot.annot = kind, None, annot
            self._pack(slot, arrays)
            t_write = get_time()
            if self._snap_writer is not None:
                self._write_snapshot_batch(slot)
                self.snapshot_write_seconds += get_time() - t_write
            # this batch's host work, without the waits on the parser and
            # on a free staging slot
            self.convert_seconds += ((t_acquire - t0) + (t_write - t_pack)
                                     - (self.source_wait_seconds - wait0))
            yield slot
            t0, wait0 = get_time(), self.source_wait_seconds

    # ---------------- warm epochs (reader thread) ----------------

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

    def _warm_batches(self, start: int) -> Iterator[_Slot]:
        """Each stored batch from position ``start`` on, in stored order or,
        with ``snapshot_shuffle_seed``, in the epoch's plan order, read (crc
        included) and copied into a pinned staging slot with its
        annotation: the raw span into a u8 slot, or each segment view into
        its typed buffer. The read and the copy count as snapshot read
        time; the wait for a free slot does not."""
        reader = self._snap_reader
        order, seed, epoch = None, self._snap_seed, self._snap_epoch
        if seed is not None and not self._snap_seq_restore:
            order = _epoch.block_permutation(seed, epoch, reader.num_batches)
        for pos in range(start, reader.num_batches):
            i = pos if order is None else int(order[pos])
            t0 = get_time()
            if self.device_decode:
                kind, span, layout = reader.batch_span(i)
            else:
                kind, *arrays = reader.load_batch(i)
            t_read = get_time()
            slot = self._ring.acquire()
            if slot is None:  # the ring closed: the epoch is being torn down
                return
            t_copy = get_time()
            if self.device_decode:
                slot.bufs[0][: span.size].numpy()[...] = span
                slot.layout, slot.nbytes = layout, span.size
            else:
                check(len(arrays) == len(slot.bufs) and all(
                    a.shape == tuple(b.shape) for a, b in zip(arrays, slot.bufs)),
                    f"snapshot {self.snapshot_path}: batch shapes differ from the first batch's")
                for buf, arr in zip(slot.bufs, arrays):
                    buf.view(torch.uint8).numpy()[...] = arr.view(np.uint8)
                slot.layout = None
            slot.kind = kind
            slot.annot = reader.resume(i) if order is None else {
                "source": _epoch.plan_state_dict(seed, 0, epoch, pos + 1, 0, 1, unit="batch"),
                "skip_rows": 0}
            self.snapshot_read_seconds += (t_read - t0) + (get_time() - t_copy)
            yield slot

    def _warm_feed(self, start: int) -> ThreadedIter:
        """The warm epoch's producer: :meth:`_warm_batches` on one reader
        thread, so batch N+1's read overlaps the use of batch N."""
        reader = self._snap_reader
        n = reader.num_batches
        if self.device_decode:
            size = max((reader.batch_nbytes(i) for i in range(n)), default=0)
            spec = [((size,), torch.uint8)]
        else:
            layout = reader.layout(0) if n else ()
            spec = [(shape, torch_dtype(dt)) for _, dt, _, _, shape in layout]
        self._ring = self._ring_for(spec)
        return ThreadedIter.from_factory(lambda: self._warm_batches(start),
                                         max_capacity=_CONVERT_AHEAD)

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
                self._ring = self._ring_for(self._cold_spec())
                self._host = ThreadedIter.from_factory(
                    lambda: self._host_batches(skip, drop, seeked),
                    max_capacity=_CONVERT_AHEAD)
        return self._host

    def _put(self, slot: _Slot):
        ctx = (torch.cuda.stream(self._copy_stream) if self._cuda
               else contextlib.nullcontext())
        bufs = slot.bufs if slot.layout is None else [slot.bufs[0][: slot.nbytes]]
        event = None
        with ctx:
            out = [b.to(self.device, non_blocking=self._cuda, copy=True) for b in bufs]
            if self._cuda:
                event = torch.cuda.Event()
                event.record(self._copy_stream)
        nbytes = sum(b.numel() * b.element_size() for b in bufs)
        self.bytes_to_device += nbytes
        if slot.layout is not None and slot.kind != "bcoo":
            self.device_decode_bytes += nbytes
        entry = (out, event, slot.kind, slot.layout, slot.annot)
        self._ring.release(slot, event)
        return entry

    def _bcoo_batch(self, span: torch.Tensor, layout):
        """``(x, label, weight)`` viewed from a bcoo batch's span on the
        device, ``x`` on its real entries: one widening of the coordinates
        to int64, no other work."""
        isz, nnz, real, rows, row_major = layout
        o_val, o_label, o_weight, nbytes = _bcoo_offsets(isz, nnz, rows)
        idx_dtype = torch.int32 if isz == 4 else torch.int64
        coords = span[: 2 * nnz * isz].view(idx_dtype).view(2, nnz)[:, :real]
        x = torch.sparse_coo_tensor(
            coords.to(torch.int64, memory_format=torch.contiguous_format),
            span[o_val: o_val + 4 * real].view(torch.float32),
            (rows, self.num_col), is_coalesced=row_major, check_invariants=False)
        self.nnz_shapes.add(nnz)
        return (x, span[o_label: o_label + 4 * rows].view(torch.float32),
                span[o_weight: nbytes].view(torch.float32))

    def _fill(self) -> None:
        while len(self._inflight) < self.prefetch:
            try:
                slot = self._host_iter().next()
            except CacheCorruptionError:
                if not self._snap_serving:
                    raise
                self._invalidate_snapshot()
                if not self._heal():
                    raise
                continue
            if slot is None:
                # a complete cold pass publishes its shadow snapshot here
                self._finish_snapshot_writer()
                return
            self._inflight.append(self._put(slot))

    def __iter__(self):
        return self

    def __next__(self):
        t0 = get_time()
        self._fill()
        if not self._inflight:
            self.stall_seconds += get_time() - t0
            raise StopIteration
        out, event, kind, layout, annot = self._inflight.popleft()
        self.input_wait_seconds += get_time() - t0
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in out:
                t.record_stream(stream)
        if layout is None:
            batch = _device_decode.wrap_batch(kind, out, self.num_col)
        elif kind == "bcoo":
            batch = self._bcoo_batch(out[0], layout)
        else:
            # device decode, on the consumer's stream after the copy's event:
            # one K2 launch for the whole batch
            t_decode = get_time()
            batch = _device_decode.decode_batch(out[0], layout, kind, self.num_col)
            self.device_decode_seconds += get_time() - t_decode
        # counted as delivered before the refill, which may heal the epoch
        # from this batch's state
        self.batches_fed += 1
        self._last_resume = annot
        # issue the replacement copy before handing the batch out; a wait
        # on the producer here holds the consumer up as much as one above
        self._fill()
        self.stall_seconds += get_time() - t0
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
        self._drop_snap_reader()
        remove_quietly(self.snapshot_path)

    def _rebuild_snapshot(self) -> None:
        """Rebuild a vanished snapshot in one silent cold pass: every batch
        converted and written, none delivered. Parsing and packing are
        deterministic, so the rebuilt batches are the lost ones, byte for
        byte."""
        self._drop_snap_reader()
        remove_quietly(self.snapshot_path)
        self._abort_snapshot_writer()
        self._snap_writer = _snapshot.SnapshotWriter(
            self.snapshot_path, signature=self._snap_sig, geometry=self._snapshot_geometry())
        self._ring = self._ring_for(self._cold_spec())
        try:
            for slot in self._host_batches(0, 0, False):
                self._ring.release(slot, None)  # written, never copied
            self._finish_snapshot_writer()
        except BaseException:
            self._abort_snapshot_writer()
            raise
        check(self._open_snapshot(),
              f"snapshot {self.snapshot_path}: rebuild did not publish a readable snapshot")

    def _heal(self) -> bool:
        """Re-arm the epoch cold at the batch after the last one delivered
        (a warm batch failed its crc and the file is gone), through the
        checkpoint machinery. Returns False, and restarts nothing, once the
        epoch's restart budget is spent."""
        if not _resilience.restart_allowed(self.pipeline_restarts, self._max_attempts):
            self.pipeline_giveups += 1
            return False
        self.pipeline_restarts += 1
        self.load_state(self.state_dict())
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
        the snapshot plan's epoch advances."""
        if self.batches_fed > 0:
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

    def stats(self) -> dict:
        """The pipeline's counters. Keys the JAX package's ``stats()`` also
        has carry its names and value types (``batches`` first; the port's
        own ``batches_fed`` is the same count). ``input_wait_seconds`` is
        the consumer's wait inside ``__next__`` for the batch it hands out
        (the part of ``stall_seconds`` before the refill); the JAX package
        adds sampled transfer landings to it, which the port does not
        sample. ``shuffle_seed`` and ``epoch`` are the source's epoch plan
        (None without one), ``snapshot_seed`` and ``snapshot_epoch`` the
        snapshot plan's (None without a snapshot)."""
        plan_state = getattr(self.source, "plan_state", None) or {}
        snap = self.snapshot_path is not None
        return {"batches": self.batches_fed,
                "batches_fed": self.batches_fed,
                "bytes_to_device": self.bytes_to_device,
                "stall_seconds": self.stall_seconds,
                "source_wait_seconds": self.source_wait_seconds,
                "convert_seconds": self.convert_seconds,
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
                "input_wait_seconds": self.input_wait_seconds,
                "snapshot_write_seconds": self.snapshot_write_seconds,
                "snapshot_read_seconds": self.snapshot_read_seconds,
                "device_decode": self.device_decode,
                "device_decode_bytes": self.device_decode_bytes,
                "device_decode_seconds": self.device_decode_seconds,
                "resilience": {"pipeline_restarts": self.pipeline_restarts,
                               "pipeline_giveups": self.pipeline_giveups}}
