"""Device-side decode: raw container spans -> typed batches on the card.

The PyTorch counterpart of the JAX package's ``ops/device_decode.py``. A
warm snapshot epoch with ``device_decode=True`` copies each batch's raw
``[pos, end)`` container bytes to the card as one u8 span, and
:func:`decode_span` slices and types it there:

- 2-D float32 / bfloat16 segments (packed dense slabs, ELL values) go
  through kernel K2, :func:`widen_span`: on a CUDA span the hand-written
  kernel ``csrc/widen_span.cu`` (:func:`widen_span_cuda`, which replaces
  the TPU kernel ``widen_span_pallas``); on a CPU span its plain version
  :func:`widen_span_plain`. The TPU kernel ran only for ``cols % 128 == 0``
  and ``rows % 32 == 0`` (Mosaic's tiles, ``pallas_decode_eligible``);
  Hopper has no such constraint, so every 2-D f32/bf16 segment goes to K2
  at its own shape.
- every other segment (int32 indices, int8 quantized slabs, 1-D label,
  weight and scale columns, u8) is a ``view(dtype).reshape(shape)`` of the
  span, as the JAX package bitcasts them.

Both routes give tensors byte-identical to the host ``np.frombuffer``
views. :func:`quantize_int8` is the host half of the int8 snapshot path;
:func:`dequant_q8` and :func:`widen_f32` are plain torch ops, as they are
plain XLA (not Pallas) in the JAX package.

A CUDA span goes to the kernel or the call raises; only a CPU span takes
the plain version.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from dmlc_tpu_torch.io.block_cache import torch_dtype
from dmlc_tpu_torch.ops import _build
from dmlc_tpu_torch.utils.check import DMLCError, check

# a span layout: ((name, dtype_str, rel_offset, nbytes, shape), ...), built
# by io.block_cache.span_layout from a container's footer
Layout = Tuple[Tuple[str, str, int, int, Tuple[int, ...]], ...]

_WIDE = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}

# kernel launches since the last reset (chip_smoke.py zeroes it before a
# path and reads it after, to show the path went through the kernel)
launches = 0


def quantize_int8(arr) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-column int8 quantization of a 2-D float batch:
    ``(q8, scale)`` with float32 ``scale = absmax / 127`` per column (zero
    columns get 1.0, so they dequantize to exact zeros)."""
    a = np.asarray(arr, dtype=np.float32)
    check(a.ndim == 2, "quantize_int8: expected a 2-D [rows, cols] batch")
    scale = np.abs(a).max(axis=0) / 127.0
    scale[scale == 0.0] = 1.0
    q = np.clip(np.rint(a / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def dequant_q8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 ``q [B, C]`` widened to float32 and scaled per column."""
    return q.to(torch.float32) * scale


def widen_f32(col: torch.Tensor) -> torch.Tensor:
    """A (bfloat16) column widened to float32; float32 passes unchanged."""
    return col.to(torch.float32)


def _check_segment(seg: torch.Tensor, rows: int, cols: int, dtype: torch.dtype) -> int:
    check(dtype in _WIDE, f"widen_span: dtype {dtype} is not float32 or bfloat16")
    check(seg.dtype == torch.uint8 and seg.dim() == 1,
          f"widen_span: needs a 1-D uint8 segment, got {seg.dtype} {tuple(seg.shape)}")
    k = _ITEMSIZE[dtype]
    check(seg.numel() == rows * cols * k,
          f"widen_span: segment of {seg.numel()} bytes is not {rows}x{cols}x{k}")
    return k


def widen_span_plain(seg: torch.Tensor, rows: int, cols: int,
                     dtype: torch.dtype) -> torch.Tensor:
    """The plain version of K2, with the TPU kernel's arithmetic: split the
    ``[rows, cols, k]`` byte planes, join them with shift/or in int64, mask
    to the word, narrow to the signed word type and view as ``dtype``."""
    k = _check_segment(seg, rows, cols, dtype)
    planes = seg.reshape(rows, cols, k).to(torch.int64)
    bits = torch.zeros((rows, cols), dtype=torch.int64, device=seg.device)
    for j in range(k):
        bits |= planes[:, :, j] << (8 * j)
    width = 8 * k
    bits &= (1 << width) - 1
    # the top plane shifted by 24 (or 8) sets the word's sign bit: fold the
    # unsigned word into the signed range before narrowing
    bits = torch.where(bits >= 1 << (width - 1), bits - (1 << width), bits)
    return bits.to(_WIDE[dtype]).view(dtype)


def widen_span_cuda(seg: torch.Tensor, rows: int, cols: int,
                    dtype: torch.dtype) -> torch.Tensor:
    """Launch K2 on the current stream; returns a fresh contiguous
    ``[rows, cols]`` tensor of ``dtype``. Takes a contiguous 1-D uint8
    CUDA segment of ``rows * cols * itemsize`` bytes and raises on
    anything else."""
    global launches
    check(seg.is_cuda, "widen_span_cuda: the segment must be on a CUDA device")
    k = _check_segment(seg, rows, cols, dtype)
    check(seg.is_contiguous(), "widen_span_cuda: the segment must be contiguous")
    lib = _build.load_kernels()
    out = torch.empty((rows, cols), dtype=dtype, device=seg.device)
    with torch.cuda.device(seg.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.dmlc_widen_span(seg.data_ptr(), out.data_ptr(), rows, cols, k, stream)
    if rc != 0:
        raise DMLCError("widen_span kernel launch failed: "
                        + lib.dmlc_cuda_error_string(rc).decode())
    launches += 1
    return out


def widen_span(seg: torch.Tensor, rows: int, cols: int,
               dtype: torch.dtype) -> torch.Tensor:
    """K2's route: the kernel for a CUDA segment, the plain version for a
    CPU one."""
    if seg.is_cuda:
        return widen_span_cuda(seg, rows, cols, dtype)
    return widen_span_plain(seg, rows, cols, dtype)


def decode_span(span: torch.Tensor, layout: Layout) -> Dict[str, torch.Tensor]:
    """{segment name: typed tensor} for a u8 span holding one batch's
    ``[pos, end)`` bytes, per its ``layout``
    (:func:`dmlc_tpu_torch.io.block_cache.span_layout`). 2-D float32 /
    bfloat16 segments go through :func:`widen_span`; the others are views
    of ``span``."""
    check(span.dtype == torch.uint8 and span.dim() == 1,
          "decode_span: needs a 1-D uint8 span")
    out: Dict[str, torch.Tensor] = {}
    for name, dtype_str, off, nbytes, shape in layout:
        seg = span[off: off + nbytes]
        dt = torch_dtype(dtype_str)
        if len(shape) == 2 and dt in _WIDE:
            out[name] = widen_span(seg, shape[0], shape[1], dt)
        else:
            out[name] = seg.view(dt).reshape(shape)
    return out
