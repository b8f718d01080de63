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
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np

import torch

from dmlc_tpu_torch.ops import _build
from dmlc_tpu_torch.utils.check import DMLCError, check

# kernel launches since the last reset (chip_smoke.py zeroes it before a
# path and reads it after, to show the path's updates took the kernel)
launches = 0

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
               betas=(0.9, 0.999), eps: float = 1e-8) -> None:
    """Adam's update of each leaf in place (``steps[i]`` is leaf i's step
    count, this step included): the plain version for CPU tensors; for
    CUDA tensors the kernel, launched on the current stream over every
    non-empty leaf, up to ``dmlc_adam_max_leaves()`` leaves a launch. The
    kernel takes contiguous float32 tensors on one device and raises on
    anything else."""
    global launches
    if not (params and params[0].is_cuda):
        adam_step_ordered_plain_(params, grads, exp_avgs, exp_avg_sqs, steps, lr=lr,
                                 betas=betas, eps=eps)
        return
    _check_leaves(params, grads, exp_avgs, exp_avg_sqs, steps)
    dev = params[0].device
    leaves = []
    for p, g, m, v, t in zip(params, grads, exp_avgs, exp_avg_sqs, steps):
        check(p.device == dev, "adam_step_: tensors must share one device")
        check(all(x.is_contiguous() for x in (p, g, m, v)),
              "adam_step_: the kernel needs contiguous parameters, gradients and moments")
        if p.numel():
            leaves.append(_build.AdamLeaf(p.data_ptr(), g.data_ptr(), m.data_ptr(),
                                          v.data_ptr(), p.numel(), *_bias_terms(t, lr, betas)))
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


def _refuse(options: dict) -> None:
    bad = [k for k, ok in _REFUSED.items() if options.get(k, ok) not in (ok, False)]
    check(not bad, f"FusedAdam: {', '.join(bad)} is not supported")


class FusedAdam(torch.optim.Adam):
    """``torch.optim.Adam`` (β, ε, no weight decay) stepped by
    :func:`adam_step_`: one kernel launch a step on the card. ``amsgrad``,
    ``maximize``, ``weight_decay``, ``capturable``, ``differentiable`` and
    ``fused`` raise, here and in a group that :meth:`add_param_group` or
    :meth:`load_state_dict` brings. A parameter whose ``grad`` is None is
    skipped."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0, amsgrad: bool = False, *, foreach=None,
                 maximize: bool = False, capturable: bool = False,
                 differentiable: bool = False, fused=None):
        _refuse({"amsgrad": amsgrad, "maximize": maximize, "weight_decay": weight_decay,
                 "capturable": capturable, "differentiable": differentiable, "fused": fused})
        super().__init__(params, lr=lr, betas=betas, eps=eps, foreach=foreach)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            _refuse(group)
            leaves = ([], [], [], [], [])
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
                                           float(state["step"]))):
                    out.append(x)
            adam_step_(*leaves, lr=float(group["lr"]), betas=group["betas"], eps=group["eps"])
        return loss
