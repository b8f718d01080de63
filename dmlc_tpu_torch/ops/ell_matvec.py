"""Kernel K1: the ELL matvec on Hopper, its autograd wrapper and its route.

``out[b] = sum_k w[idx[b, k]] * val[b, k]`` for a 1-D table ``w [W]``.

- :func:`ell_matvec_cuda` launches the hand-written CUDA kernel
  (``dmlc_tpu_torch/csrc/ell_matvec.cu``), which replaces the TPU kernel
  ``ell_matvec_pallas`` (``dmlc_tpu/ops/pallas_sparse.py``). It is bound by
  bytes: a direct gather, one warp per row (the source's header has the
  design). Every launch adds one to :data:`launches`.
- :class:`EllMatvec` is the differentiable form: the kernel forward, and a
  plain PyTorch backward, as the JAX package's backward is plain XLA
  (``_ell_ad_bwd``): ``dw`` is a scatter-add (``index_add_``, which uses
  atomics on CUDA, so ``dw`` is not bit-deterministic there) and
  ``dval = w[idx] * g``.
- :func:`ell_matvec_auto` routes: a 1-D table on a CUDA device goes to the
  kernel; CPU tensors and 2-D tables go to the plain version
  (:func:`dmlc_tpu_torch.ops.sparse.ell_matvec`). A kernel that fails to
  build or launch raises; nothing falls back to the plain version quietly.
"""

from __future__ import annotations

from typing import Optional

import torch

from dmlc_tpu_torch.ops import _build
from dmlc_tpu_torch.ops.sparse import EllBatch, ell_matvec
from dmlc_tpu_torch.utils.check import DMLCError, check

# kernel launches since the last reset (chip_smoke.py zeroes it before the
# main path and reads it after, to show the path went through the kernel)
launches = 0


def ell_matvec_cuda(weights: torch.Tensor, indices: torch.Tensor,
                    values: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; returns ``out [B]``.

    Takes a contiguous float32 ``[W]`` table and contiguous int32/float32
    ``[B, K]`` indices/values on one CUDA device, and raises on anything
    else (the caller converts once, outside any loop).
    """
    global launches
    check(weights.is_cuda and indices.is_cuda and values.is_cuda,
          "ell_matvec_cuda: tensors must be on a CUDA device")
    check(weights.device == indices.device == values.device,
          "ell_matvec_cuda: tensors must share one device")
    check(weights.dim() == 1, f"ell_matvec_cuda: weights must be [W], got {tuple(weights.shape)}")
    check(indices.dim() == 2 and indices.shape == values.shape,
          f"ell_matvec_cuda: indices {tuple(indices.shape)} and values "
          f"{tuple(values.shape)} must be one [B, K] shape")
    check(weights.dtype == torch.float32 and values.dtype == torch.float32
          and indices.dtype == torch.int32,
          "ell_matvec_cuda: needs float32 weights/values and int32 indices")
    check(weights.is_contiguous() and indices.is_contiguous() and values.is_contiguous(),
          "ell_matvec_cuda: tensors must be contiguous")
    lib = _build.load_kernels()
    num_b, num_k = indices.shape
    out = torch.empty(num_b, dtype=torch.float32, device=weights.device)
    with torch.cuda.device(weights.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.dmlc_ell_matvec_f32(
            weights.data_ptr(), indices.data_ptr(), values.data_ptr(),
            out.data_ptr(), num_b, num_k, weights.shape[0], stream)
    if rc != 0:
        raise DMLCError("ell_matvec kernel launch failed: "
                        + lib.dmlc_cuda_error_string(rc).decode())
    launches += 1
    return out


class EllMatvec(torch.autograd.Function):
    """Kernel forward, plain PyTorch backward."""

    @staticmethod
    def forward(ctx, weights, indices, values):
        ctx.save_for_backward(weights, indices, values)
        return ell_matvec_cuda(weights, indices, values)

    @staticmethod
    def backward(ctx, g):
        dw, dval = ell_matvec_backward(*ctx.saved_tensors, g)
        return dw, None, dval


def ell_matvec_backward(weights: torch.Tensor, indices: torch.Tensor,
                        values: torch.Tensor, g: torch.Tensor):
    """(dw, dval) of ``out = ell_matvec(w, idx, val)`` for the cotangent
    ``g [B]``: a scatter-add of ``val * g`` into the ``idx`` rows, and
    ``w[idx] * g`` (``_ell_ad_bwd`` in the JAX package)."""
    idx = indices.long()
    dw = torch.zeros_like(weights).index_add_(
        0, idx.flatten(), (values * g[:, None]).flatten())
    dval = weights[idx] * g[:, None]
    return dw, dval


def ell_matvec_auto(weights: torch.Tensor, batch: EllBatch,
                    use_kernel: Optional[bool] = None) -> torch.Tensor:
    """ELL matvec: the CUDA kernel for a 1-D table on a CUDA device, the
    plain version for CPU tensors and 2-D tables. ``use_kernel`` forces a
    route (True on a CPU tensor or a 2-D table raises)."""
    if use_kernel is None:
        use_kernel = weights.is_cuda and weights.dim() == 1
    if not use_kernel:
        return ell_matvec(weights, batch)
    return EllMatvec.apply(weights, batch.indices, batch.values)
