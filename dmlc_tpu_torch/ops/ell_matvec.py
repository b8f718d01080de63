"""Kernel K1: the ELL matvec on Hopper, its gradient, its autograd wrapper
and its routes.

``out[b] = sum_k w[idx[b, k]] * val[b, k]`` for a 1-D table ``w [W]``.

- :func:`ell_matvec_cuda` launches the hand-written CUDA kernel
  (``dmlc_tpu_torch/csrc/ell_matvec.cu``), which replaces the TPU kernel
  ``ell_matvec_pallas`` (``dmlc_tpu/ops/pallas_sparse.py``). It is bound by
  bytes: ``w`` staged in shared memory, double-buffered bulk tile copies,
  rows packed across a warp's lanes (the source's header has the design).
  Every launch adds one to :data:`launches`.
- :func:`ell_matvec_dw_cuda` launches the hand-written gradient kernel
  (``csrc/ell_matvec_dw.cu``), which replaces the scatter-add of the JAX
  package's backward (``_ell_ad_bwd``): ``dw`` summed per block in shared
  memory and over the blocks in a fixed order, with no float atomics, so
  ``dw`` has the same bits on every run. Every launch adds one to
  :data:`dw_launches`.
- :class:`EllMatvec` is the differentiable form: the kernel forward, and a
  backward whose ``dw`` takes the route :func:`dw_route` picks by table
  width (the kernel up to :data:`DW_MAX_TABLE` words, ``index_add_`` above,
  as the JAX package's XLA scatter), and whose ``dval = w[idx] * g`` is
  computed only when the values ask for a gradient.
- :func:`ell_matvec_grads` is the plain version of the gradient, the CPU
  route and the reference the kernel is held against on the card.
- :func:`ell_matvec_auto` routes: a 1-D table on a CUDA device goes to the
  kernels; CPU tensors and 2-D tables go to the plain version
  (:func:`dmlc_tpu_torch.ops.sparse.ell_matvec`). A kernel that fails to
  build or launch raises; nothing falls back to the plain version quietly.

**The shard window** (feature sharding, ``LinearLearner(model_axis=)``):
every function here takes ``lo``, the first global word of a table that
holds words ``[lo, lo + W)`` of a model-sharded table. The forward sums
``w[idx - lo] * val`` over the slots whose id falls in the window (the
rank's partial margin), and ``dw`` bins only those slots, at ``idx - lo``.
Both kernels take the window as two integers: no second ``[B, K]`` id
tensor, no copy of ``w``. ``lo=None`` is the unsharded call (``lo = 0`` to
the kernels, the same bits as before); the plain versions then keep their
unmasked arithmetic. Above :data:`DW_MAX_TABLE` words ``dw`` is
``index_add_`` with the slots outside the window sent to word 0 with value
0 by ``torch.where`` (:func:`~dmlc_tpu_torch.ops.sparse.window_slots`),
never by boolean indexing, which would read a count back to the host.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dmlc_tpu_torch.ops import _build
from dmlc_tpu_torch.ops.sparse import EllBatch, ell_matvec, window_slots
from dmlc_tpu_torch.utils.check import DMLCError, check

# kernel launches since the last reset (chip_smoke.py zeroes them before
# the main path and reads them after, to show the path went through the
# kernels): the forward's, and the dw kernel's
launches = 0
dw_launches = 0

# the widest table whose dw goes to the kernel: eight warps' shared-memory
# bins of W floats fit a block (csrc/ell_matvec_dw.cu, kDwMaxTable)
DW_MAX_TABLE = 4096

def _check_ell(name: str, indices: torch.Tensor, values: torch.Tensor, *others) -> None:
    tensors = (indices, values) + others
    check(all(t.is_cuda for t in tensors), f"{name}: tensors must be on a CUDA device")
    check(all(t.device == indices.device for t in tensors),
          f"{name}: tensors must share one device")
    check(indices.dim() == 2 and indices.shape == values.shape,
          f"{name}: indices {tuple(indices.shape)} and values "
          f"{tuple(values.shape)} must be one [B, K] shape")
    check(indices.dtype == torch.int32 and all(t.dtype == torch.float32 for t in tensors[1:]),
          f"{name}: needs int32 indices and float32 values")
    check(all(t.is_contiguous() for t in tensors), f"{name}: tensors must be contiguous")


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise DMLCError(f"{what} kernel launch failed: "
                        + lib.dmlc_cuda_error_string(rc).decode())


def _check_window(name: str, lo: int, width: int) -> None:
    # ids are int32: the kernels read word id - lo as an unsigned 32-bit
    # offset, which needs the window inside [0, 2^31)
    check(0 <= lo and lo + width <= 1 << 31,
          f"{name}: the window [{lo}, {lo + width}) must lie in [0, 2^31)")


def ell_matvec_cuda(weights: torch.Tensor, indices: torch.Tensor,
                    values: torch.Tensor, lo: int = 0) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; returns ``out [B]``.

    Takes a contiguous float32 ``[W]`` table, holding words ``[lo, lo + W)``
    (module docstring), and contiguous int32/float32 ``[B, K]``
    indices/values on one CUDA device, and raises on anything else (the
    caller converts once, outside any loop).
    """
    global launches
    _check_ell("ell_matvec_cuda", indices, values, weights)
    check(weights.dim() == 1, f"ell_matvec_cuda: weights must be [W], got {tuple(weights.shape)}")
    _check_window("ell_matvec_cuda", lo, weights.shape[0])
    lib = _build.load_kernels()
    num_b, num_k = indices.shape
    out = torch.empty(num_b, dtype=torch.float32, device=weights.device)
    with torch.cuda.device(weights.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.dmlc_ell_matvec_f32(
            weights.data_ptr(), indices.data_ptr(), values.data_ptr(),
            out.data_ptr(), num_b, num_k, lo, weights.shape[0], stream)
    _raise_on(lib, rc, "ell_matvec")
    launches += 1
    return out


def dw_route(table_size: int) -> str:
    """How ``dw`` of a ``[table_size]`` table is computed on the card:
    ``"cuda"`` (the deterministic kernel) up to :data:`DW_MAX_TABLE` words,
    ``"index_add"`` above, where the per-warp bins would not fit a block.
    (The row-scatter kernel gives the same bits there too, but took twice
    ``index_add_``'s time at 1,048,577 words on an H100, above the 1.2×
    it was allowed: ``chip_smoke.py``'s ``row_scatter_ab``, PERF.md §6.)"""
    return "cuda" if table_size <= DW_MAX_TABLE else "index_add"


def ell_matvec_dw_cuda(indices: torch.Tensor, values: torch.Tensor, g: torch.Tensor,
                       table_size: int, lo: int = 0) -> torch.Tensor:
    """Launch the dw kernel on the current stream; returns ``dw [W]`` for
    the cotangent ``g [B]``, the gradient of a table holding words ``[lo,
    lo + W)`` (module docstring). Takes contiguous int32/float32 ``[B, K]``
    indices/values and a float32 ``g`` on one CUDA device, and a table of at
    most :data:`DW_MAX_TABLE` words; raises on anything else."""
    global dw_launches
    _check_ell("ell_matvec_dw_cuda", indices, values, g)
    check(g.dim() == 1 and g.shape[0] == indices.shape[0],
          f"ell_matvec_dw_cuda: g must be [B], got {tuple(g.shape)}")
    check(dw_route(table_size) == "cuda",
          f"ell_matvec_dw_cuda: a table of {table_size} words is wider than "
          f"{DW_MAX_TABLE}; its dw takes the index_add route")
    _check_window("ell_matvec_dw_cuda", lo, table_size)
    lib = _build.load_kernels()
    num_b, num_k = indices.shape
    dw = torch.empty(table_size, dtype=torch.float32, device=indices.device)
    with torch.cuda.device(indices.device):
        scratch = torch.empty(
            lib.dmlc_ell_dw_scratch_floats(indices.data_ptr(), values.data_ptr(), num_b,
                                           num_k, table_size),
            dtype=torch.float32, device=indices.device)
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.dmlc_ell_matvec_dw_f32(
            indices.data_ptr(), values.data_ptr(), g.data_ptr(), dw.data_ptr(),
            scratch.data_ptr(), num_b, num_k, lo, table_size, stream)
    _raise_on(lib, rc, "ell_matvec_dw")
    dw_launches += 1
    return dw


def ell_matvec_grads(weights: torch.Tensor, indices: torch.Tensor,
                     values: torch.Tensor, g: torch.Tensor, need_dval: bool = True,
                     lo: Optional[int] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The plain version of K1's gradient (``_ell_ad_bwd`` in the JAX
    package): ``(dw, dval)`` of ``out = ell_matvec(w, idx, val)`` for the
    cotangent ``g [B]`` — a scatter-add of ``val * g`` into the ``idx``
    rows, and ``w[idx] * g`` (``None`` unless ``need_dval``). With ``lo``,
    of the shard holding words ``[lo, lo + W)``: the slots outside it add
    nothing to ``dw`` and get a ``dval`` of 0."""
    keep = None
    if lo is not None:
        indices, values, keep = window_slots(indices, values, lo, weights.shape[0])
    dw = torch.zeros_like(weights).index_add_(
        0, indices.long().flatten(), (values * g[:, None]).flatten())
    return dw, _dval(weights, indices, g, keep) if need_dval else None


def _dval(weights, indices, g, keep) -> torch.Tensor:
    """``w[idx] * g``, 0 where ``keep`` (the window's mask; None: every
    slot) is False."""
    dval = weights[indices.long()] * g[:, None]
    return dval if keep is None else torch.where(keep, dval, 0.0)


class EllMatvec(torch.autograd.Function):
    """Kernel forward; backward with ``dw`` on the route :func:`dw_route`
    picks and ``dval`` only when the values need a gradient. ``lo`` is the
    table's shard window (None: unsharded; module docstring)."""

    @staticmethod
    def forward(ctx, weights, indices, values, lo=None):
        ctx.save_for_backward(weights, indices, values)
        ctx.lo = lo
        return ell_matvec_cuda(weights, indices, values, 0 if lo is None else lo)

    @staticmethod
    def backward(ctx, g):
        weights, indices, values = ctx.saved_tensors
        lo, width = ctx.lo, weights.shape[0]
        g = g.contiguous()
        dw = dval = None
        if ctx.needs_input_grad[0]:
            if dw_route(width) == "cuda":
                dw = ell_matvec_dw_cuda(indices, values, g, width, 0 if lo is None else lo)
            else:
                dw, _ = ell_matvec_grads(weights, indices, values, g, need_dval=False, lo=lo)
        if ctx.needs_input_grad[2]:
            keep = None
            if lo is not None:
                indices, _, keep = window_slots(indices, values, lo, width)
            dval = _dval(weights, indices, g, keep)
        return dw, None, dval, None


def ell_matvec_auto(weights: torch.Tensor, batch: EllBatch,
                    use_kernel: Optional[bool] = None, lo: Optional[int] = None) -> torch.Tensor:
    """ELL matvec: the CUDA kernels for a 1-D table on a CUDA device, the
    plain version for CPU tensors and 2-D tables. ``use_kernel`` forces a
    route (True on a CPU tensor or a 2-D table raises). ``lo``: the table
    holds words ``[lo, lo + W)`` of a sharded table (module docstring)."""
    if use_kernel is None:
        use_kernel = weights.is_cuda and weights.dim() == 1
    if not use_kernel:
        return ell_matvec(weights, batch, lo=lo)
    return EllMatvec.apply(weights, batch.indices, batch.values, lo)
