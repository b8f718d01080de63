"""Async host->device batch pipeline — ``DeviceIter``.

The PyTorch counterpart of the JAX package's ``data/device.py`` for the
``dense`` and ``ell`` layouts. Parsed RowBlocks are rebatched to one fixed
shape on the host, converted to the device layout on a producer thread into
a ring of pinned staging buffers, and copied to the device ``prefetch``
batches ahead of consumption:

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
  :func:`~dmlc_tpu_torch.ops.device_decode.decode_span` slices and types
  them on the consumer's stream after the copy's event — its 2-D
  float32/bfloat16 segments through kernel K2.

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

**Healing.** A warm batch that fails its crc32 removes the file. Within the
restart budget (:mod:`dmlc_tpu_torch.io.resilience`: ``max_attempts - 1``
restarts an epoch, ``DMLC_RETRY_MAX_ATTEMPTS``, default 4) the epoch then
goes on cold from the batch after the last one delivered, as the JAX
package's does: the warm feed and the batches in flight are dropped, the
source restarts with no shadow writer (a pass joined mid-epoch cannot
write a whole snapshot), and its first ``batches_fed`` batches are
discarded unconverted. ``stats()["resilience"]["pipeline_restarts"]``
counts the restarts; past the budget the ``CacheCorruptionError``
propagates. The next epoch runs cold and writes the snapshot anew.

On a CPU device the same pipeline runs without pinning, streams or events
(the copy is synchronous). Not ported yet: the bcoo layout, the block
cache, snapshot plan order (``snapshot_shuffle_seed``), mesh placement,
autotuning and checkpoint ``state_dict``.
"""

from __future__ import annotations

import contextlib
import queue
from collections import deque
from typing import Iterator, List, Optional

import numpy as np
import torch

from dmlc_tpu_torch._device import resolve_device
from dmlc_tpu_torch.data.row_block import RowBlock, RowBlockContainer
from dmlc_tpu_torch.io import resilience as _resilience
from dmlc_tpu_torch.io import snapshot as _snapshot
from dmlc_tpu_torch.io.block_cache import remove_quietly, torch_dtype
from dmlc_tpu_torch.io.threaded_iter import ThreadedIter
from dmlc_tpu_torch.ops import device_decode as _device_decode
from dmlc_tpu_torch.ops.sparse import EllBatch, block_to_dense, block_to_ell
from dmlc_tpu_torch.utils.check import CacheCorruptionError, DMLCError, check
from dmlc_tpu_torch.utils.timer import get_time

# converted batches the producer may hold ready ahead of the consumer
_CONVERT_AHEAD = 2
_X_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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


class PackedDenseBatch:
    """One ``[B, num_col + 2]`` device tensor: features in columns
    ``[:num_col]``, label in column ``num_col``, weight in ``num_col + 1``.

    ``x, y, w = batch`` works, as does ``batch[0]``; ``x`` is a view in the
    packed dtype, while ``y`` and ``w`` are widened to float32
    (:func:`~dmlc_tpu_torch.ops.device_decode.widen_f32`), so consumers see
    the dtypes of the unpacked path.
    """

    __slots__ = ("packed", "num_col")

    def __init__(self, packed: torch.Tensor, num_col: int):
        self.packed = packed
        self.num_col = int(num_col)

    @property
    def x(self) -> torch.Tensor:
        return self.packed[:, : self.num_col]

    @property
    def y(self) -> torch.Tensor:
        return _device_decode.widen_f32(self.packed[:, self.num_col])

    @property
    def w(self) -> torch.Tensor:
        return _device_decode.widen_f32(self.packed[:, self.num_col + 1])

    def __iter__(self):
        return iter((self.x, self.y, self.w))

    def __getitem__(self, i):
        return (self.x, self.y, self.w)[i]

    def __len__(self) -> int:
        return 3


class _Slot:
    """Pinned staging buffers and what the consumer needs to ship them:
    the batch ``kind``, and for a raw span its ``layout`` and ``nbytes``."""

    __slots__ = ("bufs", "event", "kind", "layout", "nbytes")

    def __init__(self, bufs: List[torch.Tensor]):
        self.bufs = bufs
        self.event: Optional[torch.cuda.Event] = None  # copy out of bufs
        self.kind = ""
        self.layout = None
        self.nbytes = 0


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


class DeviceIter:
    """Prefetching host->device batch iterator for the ``dense`` and
    ``ell`` layouts, with the snapshot store and its device-decode tier.

    ``dense`` batches are :class:`PackedDenseBatch` with ``pack_aux`` (the
    default for ``x_dtype="float32"``), else ``(x [B, num_col], label [B],
    weight [B])``; ``ell`` batches are
    :class:`~dmlc_tpu_torch.ops.sparse.EllBatch` with ``[B, max_nnz]`` int32
    indices (pad index ``num_col``) and float32 values. Every batch has
    ``batch_size`` rows: the epoch's last partial batch is padded with
    zero-weight rows, or dropped with ``drop_remainder``.

    ``snapshot`` names the snapshot file (default: the source's
    ``snapshot_path``, stamped by ``create_parser(..., snapshot=)``, with its
    ``snapshot_signature``); ``snapshot_quant="int8"`` stores packed dense
    batches as int8 plus a per-column scale; ``device_decode=True`` decodes
    warm batches on the device (module docstring). ``device=None`` means
    the CUDA device and raises on a host without one; pass ``device="cpu"``
    for the CPU.
    """

    def __init__(
        self,
        source,
        num_col: int,
        batch_size: int,
        layout: str = "dense",
        *,
        max_nnz: Optional[int] = None,
        prefetch: int = 2,
        drop_remainder: bool = False,
        device=None,
        x_dtype: str = "float32",
        pack_aux: Optional[bool] = None,
        snapshot: Optional[str] = None,
        snapshot_signature: Optional[dict] = None,
        snapshot_quant: Optional[str] = None,
        device_decode: bool = False,
    ):
        check(layout in ("dense", "ell"), f"unknown layout {layout!r}")
        check(batch_size is not None and batch_size > 0,
              "DeviceIter: batch_size must be a positive integer")
        check(layout != "ell" or (max_nnz is not None and max_nnz > 0),
              "DeviceIter: layout='ell' needs max_nnz (one fixed [B, K] shape)")
        check(prefetch >= 1, "DeviceIter: prefetch must be >= 1")
        check(x_dtype in _X_DTYPES, f"unknown x_dtype {x_dtype!r}")
        check(x_dtype == "float32" or layout == "dense",
              "x_dtype='bfloat16' applies to the dense layout only")
        self.device = resolve_device(device)
        self.source = source
        self.num_col = int(num_col)
        self.batch_size = int(batch_size)
        self.layout = layout
        self.max_nnz = None if max_nnz is None else int(max_nnz)
        self.prefetch = int(prefetch)
        self.drop_remainder = bool(drop_remainder)
        self.x_dtype = x_dtype
        # aux packing: label/weight as two trailing columns of x, one copy
        # per dense batch. On by default for float32 (always lossless); a
        # bfloat16 pack is checked per batch to be exact
        if pack_aux is None:
            pack_aux = layout == "dense" and x_dtype == "float32"
        self.pack_aux = bool(pack_aux) and layout == "dense"
        self._aux_exact_check = self.pack_aux and x_dtype == "bfloat16"
        # snapshot store: the parser's stamp unless given here
        if snapshot is None:
            snapshot = getattr(source, "snapshot_path", None)
            if snapshot is not None and snapshot_signature is None:
                snapshot_signature = getattr(source, "snapshot_signature", None)
        self.snapshot_path = snapshot
        self._snap_sig = snapshot_signature
        self._snap_quant = snapshot_quant
        self.device_decode = bool(device_decode)
        check(snapshot_quant in (None, "int8"), f"unknown snapshot_quant {snapshot_quant!r}")
        check(snapshot_quant is None or (snapshot is not None and self.pack_aux),
              "snapshot_quant='int8' applies to snapshotted packed dense "
              "batches (layout='dense' with pack_aux)")
        check(not self.device_decode or snapshot is not None,
              "device_decode=True decodes warm snapshot batches: it needs snapshot=")
        self._snap_reader: Optional[_snapshot.SnapshotReader] = None
        self._snap_writer: Optional[_snapshot.SnapshotWriter] = None
        self._snap_serving = False  # the current producer is the warm feed
        # healing: the restart budget (read once, as the JAX package reads
        # its policy), this epoch's restarts, the cold batches a restarted
        # source discards, and whether a cold pass may shadow-write
        self._max_attempts = _resilience.max_attempts_from_env()
        self.pipeline_restarts = 0
        self.pipeline_giveups = 0
        self._cold_skip = 0
        self._shadow_write = True
        self.stall_seconds = 0.0
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
        if self.layout == "ell":
            return "ell"
        return "dense_packed" if self.pack_aux else "dense"

    def _cold_spec(self):
        B, f32 = self.batch_size, torch.float32
        if self.layout == "ell":
            K = self.max_nnz
            return [((B, K), torch.int32), ((B, K), f32), ((B,), f32), ((B,), f32)]
        xdt = _X_DTYPES[self.x_dtype]
        if self.pack_aux:
            return [((B, self.num_col + 2), xdt)]
        return [((B, self.num_col), xdt), ((B,), f32), ((B,), f32)]

    # ---------------- cold epochs (producer thread) ----------------

    def _blocks(self) -> Iterator[RowBlock]:
        self.source.before_first()
        while True:
            t0 = get_time()
            blk = self.source.next_block()
            self.source_wait_seconds += get_time() - t0
            if blk is None:
                return
            yield blk

    def _convert(self, block: RowBlock):
        pad = self.batch_size if len(block) != self.batch_size else None
        if self.layout == "dense":
            return block_to_dense(block, self.num_col, pad_rows_to=pad)
        if len(block.index) and int(block.index.max()) >= self.num_col:
            # the pad index num_col addresses the sink; anything above it
            # would read outside the weight table
            raise DMLCError(
                f"DeviceIter: feature index {int(block.index.max())} >= "
                f"num_col {self.num_col}")
        return tuple(block_to_ell(block, self.num_col, max_nnz=self.max_nnz,
                                  pad_rows_to=pad))

    def _pack(self, slot: _Slot, arrays) -> None:
        """Copy a converted batch into its staging slot; torch casts to a
        bfloat16 slot with round-to-nearest-even."""
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

    def _write_snapshot_batch(self, slot: _Slot) -> None:
        kind, arrays = slot.kind, slot.bufs
        if self._snap_quant == "int8":
            q, scale = _device_decode.quantize_int8(arrays[0].to(torch.float32).numpy())
            kind, arrays = "dense_packed_q8", (q, scale)
        self._snap_writer.add_batch(kind, arrays, rows=self.batch_size)

    def _host_batches(self) -> Iterator[_Slot]:
        kind = self._cold_kind()
        skip = self._cold_skip  # batches a restarted epoch already delivered
        t0, wait0 = get_time(), self.source_wait_seconds
        for block in rebatch_blocks(self._blocks(), self.batch_size,
                                    self.drop_remainder):
            if skip:
                skip -= 1
                t0, wait0 = get_time(), self.source_wait_seconds
                continue
            arrays = self._convert(block)
            t_acquire = get_time()
            slot = self._ring.acquire()
            if slot is None:  # the ring closed: the epoch is being torn down
                return
            t_pack = get_time()
            slot.kind, slot.layout = kind, None
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

    def _warm_batches(self) -> Iterator[_Slot]:
        """Each stored batch, read (crc included) and copied into a pinned
        staging slot: the raw span into a u8 slot, or each segment view into
        its typed buffer. The read and the copy count as snapshot read
        time; the wait for a free slot does not."""
        reader = self._snap_reader
        for i in range(reader.num_batches):
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
            self.snapshot_read_seconds += (t_read - t0) + (get_time() - t_copy)
            yield slot

    def _warm_feed(self) -> ThreadedIter:
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
        return ThreadedIter.from_factory(self._warm_batches, max_capacity=_CONVERT_AHEAD)

    # ---------------- device side (consumer thread) ----------------

    def _host_iter(self):
        if self._host is None:
            if self.snapshot_path is not None and self._open_snapshot():
                self._host = self._warm_feed()
                self._snap_serving = True
            else:
                if (self.snapshot_path is not None and self._snap_writer is None
                        and self._shadow_write):
                    # cold epoch: shadow-write what it ships, publish at its end
                    self._snap_writer = _snapshot.SnapshotWriter(
                        self.snapshot_path, signature=self._snap_sig,
                        geometry=self._snapshot_geometry())
                self._ring = self._ring_for(self._cold_spec())
                self._host = ThreadedIter.from_factory(self._host_batches,
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
        if slot.layout is not None:
            self.device_decode_bytes += nbytes
        entry = (out, event, slot.kind, slot.layout)
        self._ring.release(slot, event)
        return entry

    def _fill(self) -> None:
        while len(self._inflight) < self.prefetch:
            try:
                slot = self._host_iter().next()
            except CacheCorruptionError:
                if not self._snap_serving:
                    raise
                self._invalidate_snapshot()
                if not self._restart_cold():
                    raise
                continue
            if slot is None:
                # a complete cold pass publishes its shadow snapshot here
                self._finish_snapshot_writer()
                return
            self._inflight.append(self._put(slot))

    def _wrap(self, kind: str, out: List[torch.Tensor]):
        if kind == "ell":
            return EllBatch(*out)
        if kind == "dense_packed":
            return PackedDenseBatch(out[0], self.num_col)
        if kind == "dense_packed_q8":
            return PackedDenseBatch(_device_decode.dequant_q8(out[0], out[1]), self.num_col)
        return tuple(out)  # "dense": (x, y, w)

    def __iter__(self):
        return self

    def __next__(self):
        t0 = get_time()
        self._fill()
        if not self._inflight:
            self.stall_seconds += get_time() - t0
            raise StopIteration
        out, event, kind, layout = self._inflight.popleft()
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in out:
                t.record_stream(stream)
        if layout is None:
            batch = self._wrap(kind, out)
        else:
            # device decode, on the consumer's stream after the copy's event
            t_decode = get_time()
            segs = _device_decode.decode_span(out[0], layout)
            batch = self._wrap(kind, [segs[name] for name, *_ in layout])
            self.device_decode_seconds += get_time() - t_decode
        # counted as delivered before the refill, which may restart the
        # epoch cold after this batch
        self.batches_fed += 1
        # issue the replacement copy before handing the batch out; a wait
        # on the producer here holds the consumer up as much as one above
        self._fill()
        self.stall_seconds += get_time() - t0
        return batch

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

    def _restart_cold(self) -> bool:
        """Re-arm the epoch cold at the batch after the last one delivered
        (a warm batch failed its crc and the file is gone). Returns False,
        and restarts nothing, once the epoch's restart budget is spent."""
        if not _resilience.restart_allowed(self.pipeline_restarts, self._max_attempts):
            self.pipeline_giveups += 1
            return False
        self.pipeline_restarts += 1
        self._teardown()  # the warm feed and the batches in flight
        self._cold_skip = self.batches_fed
        self._shadow_write = False
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
        cold pass cut short here is not published."""
        self._teardown()
        self._abort_snapshot_writer()
        self.batches_fed = 0
        self.pipeline_restarts = 0  # a fresh budget an epoch
        self.pipeline_giveups = 0
        self._cold_skip = 0
        self._shadow_write = True

    def close(self) -> None:
        self._teardown()
        self._abort_snapshot_writer()
        self._drop_snap_reader()
        self.source.close()

    def stats(self) -> dict:
        return {"batches_fed": self.batches_fed,
                "bytes_to_device": self.bytes_to_device,
                "stall_seconds": self.stall_seconds,
                "source_wait_seconds": self.source_wait_seconds,
                "convert_seconds": self.convert_seconds,
                # None: no snapshot armed; 'cold': converting and
                # shadow-writing; 'warm': serving the stored batches
                "snapshot_state": (None if self.snapshot_path is None
                                   else "warm" if self._snap_serving else "cold"),
                "snapshot_write_seconds": self.snapshot_write_seconds,
                "snapshot_read_seconds": self.snapshot_read_seconds,
                "device_decode": self.device_decode,
                "device_decode_bytes": self.device_decode_bytes,
                "device_decode_seconds": self.device_decode_seconds,
                "resilience": {"pipeline_restarts": self.pipeline_restarts,
                               "pipeline_giveups": self.pipeline_giveups}}
