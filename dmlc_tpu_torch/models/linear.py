"""Linear learners (logistic / least-squares / multinomial softmax).

The PyTorch counterpart of the JAX package's ``models/linear.py`` for the
``dense``, ``ell`` and ``bcoo`` layouts on one device:

- the ell margin goes through :func:`~dmlc_tpu_torch.ops.ell_matvec.
  ell_matvec_auto` — kernel K1 for the 1-D table on a CUDA device, the
  plain gather for CPU tensors and for the softmax objective's 2-D table;
- the dense margin is ``x @ w + b``, with a bfloat16 ``x`` widened to
  float32 first; the bcoo margin is the sparse product
  :func:`~dmlc_tpu_torch.ops.sparse.coo_matmul` of the COO batch and
  ``w``, plus ``b`` (outside any kernel of the JAX package too: there it
  is XLA's ``bcoo_dot_general``);
- updates are ``torch.optim.SGD`` in place (or the optimizer an
  ``optimizer=`` factory builds, the counterpart of the JAX learner's
  optax transformation); for dense and ell, after every
  step the padding sink ``weight[-1]`` is pinned back to 0 so ELL pad
  slots stay inert. bcoo has no sink: ``weight_dim == num_col``, and its
  batches hold their real entries only.

With ``mesh=`` (:mod:`dmlc_tpu_torch.parallel`) the dense and ell layouts
train data-parallel: each rank steps on its slice of the global batch
(K1 and its ``dw`` on every rank), the step's loss is the weighted mean
over the global batch (``_loop.TrainLoopMixin._global_mean_backward``:
one ``[S, D]`` all-reduce, one flat gradient all-reduce), the ``l2`` term
and its gradient are added once after the reduction, and every rank runs
the same optimizer step on the same gradient, so the parameters stay
replicated. bcoo raises under a mesh, as in JAX.

**Feature sharding** (``mesh=`` with ``model_axis=``, the JAX learner's
tensor-parallel path for a very wide hashed table), on dense and ell:

- ``weight_dim`` is ``num_col + 1`` rounded up to a multiple of the model
  axis's size M, as in JAX, and each rank holds its shard: words ``[lo, lo
  + weight_dim / M)`` at its model coordinate (``P(model)``, or
  ``P(model, None)`` for the softmax ``[W, C]`` table). The bias is
  replicated. The padding sink ``weight_dim - 1`` lies on the last model
  shard, and only that rank pins it to 0.
- The margin is this rank's partial, summed over the model axis, plus the
  bias once: ``x_local @ w_local`` on dense (the rank's column slice of
  ``x``, which its ``DeviceIter`` ships, ``(data, model)``), K1 on the
  shard's window on ell (``ell_matvec_auto(lo=)``; the softmax table takes
  the plain masked gather). The sum is :class:`_ModelSum`: forward, one
  all-reduce over the model axis; backward, the identity, since every
  model rank holds the same loss and the gradient of each partial is that
  loss's gradient. (``torch.distributed.nn.functional.all_reduce`` would
  all-reduce the gradient again and scale each shard's by M.)
- The ``l2`` term sums the shards' ``Σw²`` over the model axis; its
  gradient stays local. The step's other collectives are the data axis's
  (``_loop``). ``predict`` and ``accuracy`` go through the same margin.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from dmlc_tpu_torch.models._loop import TrainLoopMixin
from dmlc_tpu_torch.ops.ell_matvec import ell_matvec_auto
from dmlc_tpu_torch.parallel.mesh import rank_device, shard_window
from dmlc_tpu_torch.ops.sparse import coo_matmul
from dmlc_tpu_torch.utils.check import check


class LinearParams(NamedTuple):
    weight: torch.Tensor  # [W] or [W, C]; the last row is the padding sink, pinned to 0
    bias: torch.Tensor    # scalar, or [C]


def _per_example(margin, label, objective: str) -> torch.Tensor:
    if objective == "logistic":
        return F.binary_cross_entropy_with_logits(margin, label, reduction="none")
    if objective == "squared":
        return 0.5 * (margin - label) ** 2
    # softmax: margin is [B, C]; labels are class ids in the float label
    return F.cross_entropy(margin, label.long(), reduction="none")


def _loss_from_margin(margin, label, weight, objective: str) -> torch.Tensor:
    """The batch's weighted mean loss, without ``l2``."""
    per = _per_example(margin, label, objective)
    return (per * weight).sum() / torch.clamp(weight.sum(), min=1.0)


class _ModelSum(torch.autograd.Function):
    """The full margin from this rank's partial: forward, a SUM
    all-reduce over the model axis; backward, the identity (module
    docstring)."""

    @staticmethod
    def forward(ctx, part, mesh, axis):
        return mesh.all_reduce_(part.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class LinearLearner(TrainLoopMixin):
    """Logistic / least-squares / multinomial-softmax learner.

    ``layout`` must match the DeviceIter layout ('dense', 'ell' or 'bcoo');
    ``objective='softmax'`` needs ``num_class >= 2``. ``optimizer`` is a
    factory ``params -> torch.optim.Optimizer``; ``None`` means
    ``torch.optim.SGD(lr=learning_rate)``. ``device=None`` means the CUDA
    device and raises on a host without one; on a ``mesh``, the mesh's
    device. ``mesh`` trains data-parallel over ``data_axis``, and with
    ``model_axis`` shards the table over that axis (module docstring).
    ``shard_lo`` / ``shard_width`` are this rank's words of the table.
    """

    def __init__(self, num_col: int, objective: str = "logistic",
                 layout: str = "dense",
                 optimizer: Optional[Callable[[list], torch.optim.Optimizer]] = None,
                 learning_rate: float = 0.1, l2: float = 0.0, mesh=None,
                 data_axis: str = "data", model_axis: Optional[str] = None,
                 num_class: int = 1, device=None):
        check(layout in ("dense", "ell", "bcoo"),
              "LinearLearner: layout must be dense|ell|bcoo")
        check(layout != "bcoo" or mesh is None,
              "layout='bcoo' is single-device (matches DeviceIter bcoo)")
        check(objective in ("logistic", "squared", "softmax"),
              f"unknown objective {objective!r}")
        check((objective == "softmax") == (num_class > 1),
              "softmax objective iff num_class > 1")
        self.mesh = mesh
        self.data_axis = data_axis
        self.model_axis = model_axis
        self.device = rank_device(mesh, device, data_axis=data_axis, model_axis=model_axis,
                                  who="LinearLearner")
        self.num_col = num_col
        self.objective = objective
        self.layout = layout
        self.l2 = float(l2)
        self.num_class = num_class
        # num_col features + 1 padding sink, rounded up so the model axis
        # divides it evenly; bcoo batches need no sink
        self._sharded = mesh is not None and model_axis is not None
        model_size = mesh.shape[model_axis] if self._sharded else 1
        self.weight_dim = (num_col if layout == "bcoo"
                           else -(-(num_col + 1) // model_size) * model_size)
        self.shard_lo, self.shard_width = shard_window(
            mesh, model_axis if self._sharded else None, self.weight_dim)
        # the sink is the table's last word: on the last model shard
        self._pins_sink = (layout != "bcoo"
                           and self.shard_lo + self.shard_width == self.weight_dim)
        shape = (self.shard_width, num_class) if num_class > 1 else (self.shard_width,)
        self.params = LinearParams(
            weight=torch.zeros(shape, dtype=torch.float32, device=self.device,
                               requires_grad=True),
            bias=torch.zeros(shape[1:], dtype=torch.float32, device=self.device,
                             requires_grad=True))
        if optimizer is None:
            self.opt = torch.optim.SGD(list(self.params), lr=learning_rate)
        else:
            self.opt = optimizer(list(self.params))

    def device_num_col(self) -> int:
        """The ``num_col`` a DeviceIter must use to feed this learner:
        dense batches are [B, weight_dim]; ell pads with weight_dim - 1,
        the pinned-zero sink; bcoo takes the true column count."""
        return self.weight_dim - 1 if self.layout == "ell" else self.weight_dim

    @torch.no_grad()
    def set_params(self, params: LinearParams) -> None:
        """Copy ``params`` into this learner's tensors (in place, so the
        optimizer keeps tracking them): this rank's shard under feature
        sharding (``convert.linear_params_from_jax(..., mesh=,
        model_axis=)``)."""
        self.params.weight.copy_(params.weight)
        self.params.bias.copy_(params.bias)

    def _margin(self, batch):
        w, b = self.params
        if self.layout == "ell":
            lo = self.shard_lo if self._sharded else None
            part, label, weight = ell_matvec_auto(w, batch, lo=lo), batch.label, batch.weight
        else:
            x, label, weight = batch
            if self.layout == "bcoo":
                return coo_matmul(x, w) + b, label, weight
            # a bfloat16 batch widens to the weight's float32 first, as JAX's
            # type promotion does for `x @ w` (bf16 -> f32 is exact); under
            # feature sharding x is this rank's column slice
            part = x.to(w.dtype) @ w
        if self._sharded:
            part = _ModelSum.apply(part, self.mesh, self.model_axis)
        return part + b, label, weight

    def _pred_from_margin(self, margin: torch.Tensor) -> torch.Tensor:
        if self.num_class > 1:
            return margin.argmax(dim=-1).to(torch.float32)
        return (margin > 0).to(torch.float32)

    def _step(self, batch) -> torch.Tensor:
        self.opt.zero_grad(set_to_none=True)
        margin, label, weight = self._margin(batch)
        per = _per_example(margin, label, self.objective)
        loss = self._global_mean_backward((per * weight).sum(), weight.sum())
        if self.l2 > 0.0:
            # once, after any reduction (the same on every rank); the
            # padding sink is pinned to 0, so it adds nothing here. A
            # shard's Σw² is summed over the model axis; its gradient is
            # its own
            w = self.params.weight.detach()
            sq = (w ** 2).sum()
            if self._sharded:
                sq = self.mesh.all_reduce_(sq.reshape(1), self.model_axis)[0]
            loss = loss + 0.5 * self.l2 * sq
            self.params.weight.grad.add_(w, alpha=self.l2)
        self.opt.step()
        if self._pins_sink:
            with torch.no_grad():
                # keep the padding sink at zero so ELL gathers of pad slots
                # are inert; zero_() on the view is a device fill, where
                # assigning a Python float copies a host scalar over and
                # stalls the host
                self.params.weight[-1].zero_()
        return loss.detach()

    @torch.no_grad()
    def predict(self, batch) -> torch.Tensor:
        return self._margin(batch)[0]
