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

The loop never synchronises the device per step. ``stall_seconds`` is the
consumer's time inside ``__next__`` — waiting for the producer, plus issuing
the copies; ``bytes_to_device`` counts the bytes copied. On the producer
side, ``source_wait_seconds`` is the time blocked on the parser and
``convert_seconds`` the time spent rebatching, converting and packing.

On a CPU device the same pipeline runs without pinning, streams or events
(the copy is synchronous). Not ported yet: the bcoo layout, the snapshot
and block-cache tiers, device decode, mesh placement, autotuning and
checkpoint ``state_dict``.
"""

from __future__ import annotations

import contextlib
import queue
from collections import deque
from typing import Iterator, List, Optional

import torch

from dmlc_tpu_torch._device import resolve_device
from dmlc_tpu_torch.data.row_block import RowBlock, RowBlockContainer
from dmlc_tpu_torch.io.threaded_iter import ThreadedIter
from dmlc_tpu_torch.ops.sparse import EllBatch, block_to_dense, block_to_ell
from dmlc_tpu_torch.utils.check import DMLCError, check
from dmlc_tpu_torch.utils.timer import get_time

# converted batches the producer may hold ready ahead of the consumer
_CONVERT_AHEAD = 2


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


class _Slot:
    __slots__ = ("bufs", "event")

    def __init__(self, bufs: List[torch.Tensor]):
        self.bufs = bufs
        self.event: Optional[torch.cuda.Event] = None  # copy out of bufs


class _StagingRing:
    """Host staging buffers the producer packs batches into.

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
    ``ell`` layouts.

    ``dense`` batches are ``(x [B, num_col], label [B], weight [B])``;
    ``ell`` batches are :class:`~dmlc_tpu_torch.ops.sparse.EllBatch` with
    ``[B, max_nnz]`` int32 indices (pad index ``num_col``) and float32
    values. Every batch has ``batch_size`` rows: the epoch's last partial
    batch is padded with zero-weight rows, or dropped with
    ``drop_remainder``. ``device=None`` means the CUDA device and raises on
    a host without one; pass ``device="cpu"`` for the CPU.
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
    ):
        check(layout in ("dense", "ell"), f"unknown layout {layout!r}")
        check(batch_size is not None and batch_size > 0,
              "DeviceIter: batch_size must be a positive integer")
        check(layout != "ell" or (max_nnz is not None and max_nnz > 0),
              "DeviceIter: layout='ell' needs max_nnz (one fixed [B, K] shape)")
        check(prefetch >= 1, "DeviceIter: prefetch must be >= 1")
        self.device = resolve_device(device)
        self.source = source
        self.num_col = int(num_col)
        self.batch_size = int(batch_size)
        self.layout = layout
        self.max_nnz = None if max_nnz is None else int(max_nnz)
        self.prefetch = int(prefetch)
        self.drop_remainder = bool(drop_remainder)
        self.stall_seconds = 0.0
        self.batches_fed = 0
        self.bytes_to_device = 0
        # written by the producer thread only
        self.source_wait_seconds = 0.0
        self.convert_seconds = 0.0
        self._cuda = self.device.type == "cuda"
        self._copy_stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._ring: Optional[_StagingRing] = None
        self._host: Optional[ThreadedIter] = None
        self._inflight: deque = deque()

    # ---------------- host side (producer thread) ----------------

    def _make_ring(self) -> _StagingRing:
        B = self.batch_size
        if self.layout == "ell":
            K = self.max_nnz
            shapes = [((B, K), torch.int32), ((B, K), torch.float32),
                      ((B,), torch.float32), ((B,), torch.float32)]
        else:
            shapes = [((B, self.num_col), torch.float32),
                      ((B,), torch.float32), ((B,), torch.float32)]
        depth = _CONVERT_AHEAD + self.prefetch + 2
        return _StagingRing([
            _Slot([torch.empty(shape, dtype=dt, pin_memory=self._cuda)
                   for shape, dt in shapes])
            for _ in range(depth)])

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

    def _host_batches(self) -> Iterator[_Slot]:
        t0, wait0 = get_time(), self.source_wait_seconds
        for block in rebatch_blocks(self._blocks(), self.batch_size,
                                    self.drop_remainder):
            arrays = self._convert(block)
            t_acquire = get_time()
            slot = self._ring.acquire()
            if slot is None:  # the ring closed: the epoch is being torn down
                return
            t_pack = get_time()
            for buf, arr in zip(slot.bufs, arrays):
                buf.numpy()[...] = arr
            # this batch's host work, without the waits on the parser and
            # on a free staging slot
            self.convert_seconds += ((t_acquire - t0) + (get_time() - t_pack)
                                     - (self.source_wait_seconds - wait0))
            yield slot
            t0, wait0 = get_time(), self.source_wait_seconds

    def _host_iter(self) -> ThreadedIter:
        if self._host is None:
            if self._ring is None:
                self._ring = self._make_ring()
            self._host = ThreadedIter.from_factory(self._host_batches,
                                                   max_capacity=_CONVERT_AHEAD)
        return self._host

    # ---------------- device side (consumer thread) ----------------

    def _put(self, slot: _Slot):
        ctx = (torch.cuda.stream(self._copy_stream) if self._cuda
               else contextlib.nullcontext())
        event = None
        with ctx:
            out = [b.to(self.device, non_blocking=self._cuda, copy=True)
                   for b in slot.bufs]
            if self._cuda:
                event = torch.cuda.Event()
                event.record(self._copy_stream)
        self.bytes_to_device += sum(b.numel() * b.element_size() for b in slot.bufs)
        self._ring.release(slot, event)
        return out, event

    def _fill(self) -> None:
        while len(self._inflight) < self.prefetch:
            slot = self._host_iter().next()
            if slot is None:
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
        out, event = self._inflight.popleft()
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in out:
                t.record_stream(stream)
        # issue the replacement copy before handing the batch out; a wait
        # on the producer here holds the consumer up as much as one above
        self._fill()
        self.stall_seconds += get_time() - t0
        self.batches_fed += 1
        return EllBatch(*out) if self.layout == "ell" else tuple(out)

    def _teardown(self) -> None:
        self._inflight.clear()
        if self._host is not None:
            self._ring.close()     # unblocks a producer waiting for a slot
            self._host.destroy()
            self._host = None
            self._ring.reopen()

    def reset(self) -> None:
        """New epoch: stop the producer; the next pull restarts the source."""
        self._teardown()
        self.batches_fed = 0

    def close(self) -> None:
        self._teardown()
        self.source.close()

    def stats(self) -> dict:
        return {"batches_fed": self.batches_fed,
                "bytes_to_device": self.bytes_to_device,
                "stall_seconds": self.stall_seconds,
                "source_wait_seconds": self.source_wait_seconds,
                "convert_seconds": self.convert_seconds}
