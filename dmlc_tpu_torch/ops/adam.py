"""Adam's dense update in one pass: the FM learner's default optimizer.

``torch.optim.Adam``'s default update on the card is its foreach route:
seven passes over the parameters and moments (lerp, mul, addcmul, sqrt
into a full-size temporary, div, add, addcdiv), about 72 bytes a
parameter and one more tensor of the parameters' size. The JAX learner's
``optax.adam`` is the same update, left to XLA. Here:

- :func:`adam_step_` updates each leaf in place: the plain version for CPU
  tensors, the hand-written kernel ``csrc/adam_step.cu`` for CUDA tensors
  (one launch for up to eight leaves; it reads p, g, m and v and writes
  p, m and v once, 28 bytes a parameter, allocates nothing and does not
  synchronise). A kernel that fails to build or launch raises; nothing
  falls back quietly. Every launch adds one to :data:`launches`.
- :func:`adam_step_ordered_plain_` is the kernel's arithmetic as separate
  float32 PyTorch operations, in its order::

      m = m·β1 + g·(1−β1)
      v = v·β2 + (g·g)·(1−β2)
      d = sqrt(v) / sqrt(1−β2^t) + ε
      p = p − (m / d)·(lr / (1−β1^t))

  each rounded on its own (no ``alpha=`` or ``value=`` argument, which may
  fuse a multiply-add, and no division by a Python number, which the card
  turns into a multiply by its reciprocal; the square root taken in
  float64 and rounded once, as torch's float32 one on the CPU is not
  IEEE's). The kernel equals it bit for bit; it rounds otherwise than
  torch's Adam and ``optax.adam`` do.
- :class:`FusedAdam` is a ``torch.optim.Adam`` whose step is
  :func:`adam_step_`: torch's state layout (a CPU float32 ``"step"``,
  ``"exp_avg"``, ``"exp_avg_sq"``) and hyperparameters, so state dicts
  load both ways, and its step recorded under
  ``Optimizer.step#FusedAdam.step``. The bias corrections come from the
  CPU step count, as in torch with ``capturable=False``: nothing is read
  back from the card.
- **Row marks.** ``FusedAdam.step(rows={param: ids})`` names, for a
  parameter, the rows (first dimension) whose gradient may be non-zero;
  the caller promises +0.0 on every other row, as the row scatter of a
  gather's gradient leaves it. On the card each distinct id tensor is
  marked once into a bitmap of one bit a row (:func:`mark_rows_cuda_`,
  ``dmlc_adam_mark_rows``: one launch, counted in :data:`mark_launches`),
  and the kernel loads g only where a covered row is marked, taking +0.0
  elsewhere: the same bits, 24 bytes a parameter instead of 28. Adam's
  update stays dense (m and v decay on every row, as in ``optax.adam``).
  The plain version reads the whole gradient, which gives the same bits,
  so the CPU route takes no mark.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np

import torch

from dmlc_tpu_torch.ops import _build
from dmlc_tpu_torch.utils.check import DMLCError, check

# kernel launches since the last reset (chip_smoke.py zeroes it before a
# path and reads it after, to show the path's updates took the kernel);
# the row mark's launches are counted apart
launches = 0
mark_launches = 0

# options of torch.optim.Adam that FusedAdam does not compute, and the
# value each must hold
_REFUSED = {"amsgrad": False, "maximize": False, "weight_decay": 0, "capturable": False,
            "differentiable": False, "fused": None}


def _f32(x: float) -> float:
    return float(np.float32(x))


class _Moments(NamedTuple):
    """The float32 numbers every leaf's update takes."""

    b1: float
    c1: float  # 1 - b1
    b2: float
    c2: float  # 1 - b2
    eps: float


def _moments(betas: Sequence[float], eps: float) -> _Moments:
    """Each number computed in double on the host, then rounded to float32
    once: the values the kernel and the plain version both take."""
    b1, b2 = float(betas[0]), float(betas[1])
    return _Moments(_f32(b1), _f32(1.0 - b1), _f32(b2), _f32(1.0 - b2), _f32(eps))


def _bias_terms(step: float, lr: float, betas: Sequence[float]) -> tuple:
    """``(sqrt(1 - b2^t), lr / (1 - b1^t))`` for step count ``t``, computed
    as :func:`_moments` computes its numbers."""
    b1, b2 = float(betas[0]), float(betas[1])
    return _f32((1.0 - b2 ** step) ** 0.5), _f32(float(lr) / (1.0 - b1 ** step))


def _check_leaves(params, grads, exp_avgs, exp_avg_sqs, steps) -> None:
    check(len(params) == len(grads) == len(exp_avgs) == len(exp_avg_sqs) == len(steps),
          "adam_step_: the lists differ in length")
    for p, g, m, v in zip(params, grads, exp_avgs, exp_avg_sqs):
        check(p.shape == g.shape == m.shape == v.shape,
              f"adam_step_: a leaf of {tuple(p.shape)} with state of another shape")
        check(p.device == g.device == m.device == v.device,
              "adam_step_: a leaf's tensors must share one device")
        check(all(t.dtype == torch.float32 for t in (p, g, m, v)),
              "adam_step_: needs float32 parameters, gradients and moments")
        check(not g.is_sparse, "adam_step_: sparse gradients are not supported")


def adam_step_ordered_plain_(params, grads, exp_avgs, exp_avg_sqs, steps, *, lr: float,
                             betas=(0.9, 0.999), eps: float = 1e-8) -> None:
    """The kernel's update in separate float32 PyTorch operations, each
    leaf in place. ``steps[i]`` is leaf i's step count, this step
    included."""
    _check_leaves(params, grads, exp_avgs, exp_avg_sqs, steps)
    c = _moments(betas, eps)
    for p, g, m, v, t in zip(params, grads, exp_avgs, exp_avg_sqs, steps):
        bias2_sqrt, step_size = _bias_terms(t, lr, betas)
        m.mul_(c.b1).add_(g * c.c1)
        v.mul_(c.b2).add_((g * g).mul_(c.c2))
        # the square root of the float64 value, rounded once: IEEE's float32
        # square root (torch's float32 one on the CPU is not always); the
        # divisor a tensor on p's device, so the division stays a division
        d = torch.sqrt(v.double()).float().div_(
            torch.full((), bias2_sqrt, dtype=torch.float32, device=p.device)).add_(c.eps)
        p.sub_(torch.div(m, d).mul_(step_size))


def adam_step_(params, grads, exp_avgs, exp_avg_sqs, steps, *, lr: float,
               betas=(0.9, 0.999), eps: float = 1e-8,
               masks: Optional[Sequence[Optional[torch.Tensor]]] = None) -> None:
    """Adam's update of each leaf in place (``steps[i]`` is leaf i's step
    count, this step included): the plain version for CPU tensors; for
    CUDA tensors the kernel, launched on the current stream over every
    non-empty leaf, up to ``dmlc_adam_max_leaves()`` leaves a launch. The
    kernel takes contiguous float32 tensors on one device and raises on
    anything else.

    ``masks[i]``, where given and not None, is leaf i's row mark (int32
    words, bit ``r % 32`` of word ``r // 32`` for row ``r``, as
    :func:`mark_rows_cuda_` writes them): the kernel reads the gradient
    only on marked rows and takes +0.0 on the others. The caller promises
    the gradient is +0.0 there, so the bits are those of the full read,
    which the CPU route makes."""
    global launches
    if not (params and params[0].is_cuda):
        adam_step_ordered_plain_(params, grads, exp_avgs, exp_avg_sqs, steps, lr=lr,
                                 betas=betas, eps=eps)
        return
    _check_leaves(params, grads, exp_avgs, exp_avg_sqs, steps)
    masks = [None] * len(params) if masks is None else masks
    check(len(masks) == len(params), "adam_step_: the lists differ in length")
    dev = params[0].device
    leaves = []
    for p, g, m, v, t, mask in zip(params, grads, exp_avgs, exp_avg_sqs, steps, masks):
        check(p.device == dev, "adam_step_: tensors must share one device")
        check(all(x.is_contiguous() for x in (p, g, m, v)),
              "adam_step_: the kernel needs contiguous parameters, gradients and moments")
        if not p.numel():
            continue
        mask_ptr, width = None, 1
        if mask is not None:
            check(p.dim() >= 1, "adam_step_: a row mark needs a leaf with rows")
            check(mask.device == dev and mask.dtype == torch.int32 and mask.is_contiguous()
                  and mask.numel() >= _mask_words(p.shape[0]),
                  f"adam_step_: a {tuple(p.shape)} leaf's row mark must be "
                  f"{_mask_words(p.shape[0])} contiguous int32 words on its device")
            mask_ptr, width = mask.data_ptr(), p.numel() // p.shape[0]
        leaves.append(_build.AdamLeaf(p.data_ptr(), g.data_ptr(), m.data_ptr(),
                                      v.data_ptr(), p.numel(), *_bias_terms(t, lr, betas),
                                      mask_ptr, width))
    if not leaves:
        return
    lib = _build.load_kernels()
    c = _moments(betas, eps)
    per = lib.dmlc_adam_max_leaves()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for lo in range(0, len(leaves), per):
            batch = leaves[lo:lo + per]
            rc = lib.dmlc_adam_step_f32((_build.AdamLeaf * len(batch))(*batch), len(batch),
                                        c.b1, c.c1, c.b2, c.c2, c.eps, stream)
            if rc != 0:
                raise DMLCError("adam_step kernel launch failed: "
                                + lib.dmlc_cuda_error_string(rc).decode())
            launches += 1


def _mask_words(rows: int) -> int:
    return (rows + 31) // 32


def mark_rows_plain(ids: torch.Tensor, rows: int) -> Tuple[torch.Tensor, int]:
    """The row mark of ``ids`` over ``rows`` rows in plain PyTorch: the
    int32 words (bit ``r % 32`` of word ``r // 32`` set for each id ``r``
    in ``[0, rows)``; ids outside mark nothing) and the number of rows
    marked."""
    r = ids.reshape(-1).to(torch.int64)
    r = torch.unique(r[(r >= 0) & (r < rows)])
    bits = torch.zeros(_mask_words(rows) * 32, dtype=torch.int64, device=ids.device)
    bits[r] = 1
    words = (bits.view(-1, 32) << torch.arange(32, device=ids.device)).sum(dim=1)
    # the low 32 bits as int32 (two's complement), as the kernel's words
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32), int(r.numel())


def mark_rows_cuda_(mask: torch.Tensor, ids: torch.Tensor, rows: int) -> torch.Tensor:
    """Launch ``dmlc_adam_mark_rows`` on the current stream: the first
    ``ceil(rows / 32)`` int32 words of ``mask`` zeroed, then the bit of each
    id in ``[0, rows)`` set (:func:`mark_rows_plain`'s words). Integer
    ``ids`` of any shape on ``mask``'s CUDA device; no sync, no allocation
    but an id copy for ids that are neither int32 nor int64 or not
    contiguous."""
    global mark_launches
    check(mask.is_cuda and mask.device == ids.device,
          "mark_rows_cuda_: mask and ids must share one CUDA device")
    check(mask.dtype == torch.int32 and mask.is_contiguous()
          and mask.numel() >= _mask_words(rows) and rows >= 1,
          f"mark_rows_cuda_: needs {_mask_words(rows)} contiguous int32 words for {rows} rows")
    if ids.dtype not in (torch.int32, torch.int64):
        ids = ids.to(torch.int64)
    ids = ids.contiguous()
    lib = _build.load_kernels()
    with torch.cuda.device(mask.device):
        rc = lib.dmlc_adam_mark_rows(ids.data_ptr(), ids.numel(), ids.element_size(), rows,
                                     mask.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise DMLCError("adam row mark launch failed: " + lib.dmlc_cuda_error_string(rc).decode())
    mark_launches += 1
    return mask


def _check_rows(rows: dict, params: list) -> None:
    known = {id(p) for p in params}
    for p, ids in rows.items():
        check(id(p) in known, "FusedAdam.step: rows names a tensor that is not a parameter")
        check(p.dim() >= 1, "FusedAdam.step: rows needs a parameter with rows, not a 0-d one")
        check(isinstance(ids, torch.Tensor) and not ids.is_floating_point()
              and not ids.is_complex() and ids.dtype != torch.bool,
              "FusedAdam.step: rows must map a parameter to an integer id tensor")
        check(ids.device == p.device,
              f"FusedAdam.step: ids on {ids.device} for a parameter on {p.device}")


def _refuse(options: dict) -> None:
    bad = [k for k, ok in _REFUSED.items() if options.get(k, ok) not in (ok, False)]
    check(not bad, f"FusedAdam: {', '.join(bad)} is not supported")


class FusedAdam(torch.optim.Adam):
    """``torch.optim.Adam`` (β, ε, no weight decay) stepped by
    :func:`adam_step_`: one kernel launch a step on the card. ``amsgrad``,
    ``maximize``, ``weight_decay``, ``capturable``, ``differentiable`` and
    ``fused`` raise, here and in a group that :meth:`add_param_group` or
    :meth:`load_state_dict` brings. A parameter whose ``grad`` is None is
    skipped.

    :meth:`step`'s ``rows`` takes the row marks (the module's note); their
    bitmaps are this optimizer's own buffers, made at the first marked step
    on the card and reused, and not part of its state dict."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0, amsgrad: bool = False, *, foreach=None,
                 maximize: bool = False, capturable: bool = False,
                 differentiable: bool = False, fused=None):
        _refuse({"amsgrad": amsgrad, "maximize": maximize, "weight_decay": weight_decay,
                 "capturable": capturable, "differentiable": differentiable, "fused": fused})
        super().__init__(params, lr=lr, betas=betas, eps=eps, foreach=foreach)
        self._bitmaps: list = []  # one int32 tensor a distinct id tensor of a step

    def _mark(self, rows: dict) -> Dict[int, torch.Tensor]:
        """Each distinct CUDA id tensor of ``rows`` marked once into a bitmap
        over the most rows of the parameters it serves; ``{id(param):
        bitmap}``. CPU parameters take none."""
        served: Dict[int, tuple] = {}
        for p, ids in rows.items():
            if p.is_cuda:
                served.setdefault(id(ids), (ids, []))[1].append(p)
        out = {}
        for slot, (ids, params) in enumerate(served.values()):
            n_rows = max(p.shape[0] for p in params)
            if slot == len(self._bitmaps):
                self._bitmaps.append(None)
            bitmap = self._bitmaps[slot]
            if (bitmap is None or bitmap.device != ids.device
                    or bitmap.numel() < _mask_words(n_rows)):
                bitmap = torch.empty(_mask_words(n_rows), dtype=torch.int32, device=ids.device)
                self._bitmaps[slot] = bitmap
            mark_rows_cuda_(bitmap, ids, n_rows)
            out.update((id(p), bitmap) for p in params)
        return out

    @torch.no_grad()
    def step(self, closure=None, *, rows: Optional[Dict[torch.Tensor, torch.Tensor]] = None):
        """One update of every parameter with a gradient. ``rows`` maps a
        parameter to an integer id tensor on its device naming every row
        (first dimension) whose gradient may be non-zero; the gradient must
        be +0.0 on every other row. Ids outside ``[0, rows)`` mark nothing.
        A 0-d parameter, a tensor that is not a parameter, ids that are
        not integers or that lie on another device raise."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        rows = rows or {}
        _check_rows(rows, [p for group in self.param_groups for p in group["params"]])
        bitmaps = self._mark(rows)
        for group in self.param_groups:
            _refuse(group)
            leaves = ([], [], [], [], [], [])
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = torch.tensor(0.0, dtype=torch.float32)
                    state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    state["exp_avg_sq"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                state["step"] += 1
                for out, x in zip(leaves, (p, p.grad, state["exp_avg"], state["exp_avg_sq"],
                                           float(state["step"]), bitmaps.get(id(p)))):
                    out.append(x)
            adam_step_(*leaves[:5], lr=float(group["lr"]), betas=group["betas"],
                       eps=group["eps"], masks=leaves[5])
        return loss
