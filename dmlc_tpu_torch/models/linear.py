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
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from dmlc_tpu_torch._device import resolve_device
from dmlc_tpu_torch.models._loop import TrainLoopMixin
from dmlc_tpu_torch.ops.ell_matvec import ell_matvec_auto
from dmlc_tpu_torch.ops.sparse import coo_matmul
from dmlc_tpu_torch.utils.check import check


class LinearParams(NamedTuple):
    weight: torch.Tensor  # [W] or [W, C]; the last row is the padding sink, pinned to 0
    bias: torch.Tensor    # scalar, or [C]


def _loss_from_margin(margin, label, weight, objective: str, l2: float,
                      w: torch.Tensor) -> torch.Tensor:
    if objective == "logistic":
        per = F.binary_cross_entropy_with_logits(margin, label, reduction="none")
    elif objective == "squared":
        per = 0.5 * (margin - label) ** 2
    else:  # softmax: margin is [B, C]; labels are class ids in the float label
        per = F.cross_entropy(margin, label.long(), reduction="none")
    den = torch.clamp(weight.sum(), min=1.0)
    loss = (per * weight).sum() / den
    if l2 > 0.0:
        # the padding sink is pinned to 0, so it adds nothing here
        loss = loss + 0.5 * l2 * (w ** 2).sum()
    return loss


class LinearLearner(TrainLoopMixin):
    """Logistic / least-squares / multinomial-softmax learner.

    ``layout`` must match the DeviceIter layout ('dense', 'ell' or 'bcoo');
    ``objective='softmax'`` needs ``num_class >= 2``. ``optimizer`` is a
    factory ``params -> torch.optim.Optimizer``; ``None`` means
    ``torch.optim.SGD(lr=learning_rate)``. ``device=None`` means the CUDA
    device and raises on a host without one.
    """

    def __init__(self, num_col: int, objective: str = "logistic",
                 layout: str = "dense",
                 optimizer: Optional[Callable[[list], torch.optim.Optimizer]] = None,
                 learning_rate: float = 0.1, l2: float = 0.0, num_class: int = 1,
                 device=None):
        check(layout in ("dense", "ell", "bcoo"),
              "LinearLearner: layout must be dense|ell|bcoo")
        check(objective in ("logistic", "squared", "softmax"),
              f"unknown objective {objective!r}")
        check((objective == "softmax") == (num_class > 1),
              "softmax objective iff num_class > 1")
        self.device = resolve_device(device)
        self.num_col = num_col
        self.objective = objective
        self.layout = layout
        self.l2 = float(l2)
        self.num_class = num_class
        # num_col features + 1 padding sink; bcoo batches need no sink
        self.weight_dim = num_col if layout == "bcoo" else num_col + 1
        shape = (self.weight_dim, num_class) if num_class > 1 else (self.weight_dim,)
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
        optimizer keeps tracking them)."""
        self.params.weight.copy_(params.weight)
        self.params.bias.copy_(params.bias)

    def _margin(self, batch):
        w, b = self.params
        if self.layout == "ell":
            return ell_matvec_auto(w, batch) + b, batch.label, batch.weight
        x, label, weight = batch
        if self.layout == "bcoo":
            return coo_matmul(x, w) + b, label, weight
        # a bfloat16 batch widens to the weight's float32 first, as JAX's
        # type promotion does for `x @ w` (bf16 -> f32 is exact)
        return x.to(w.dtype) @ w + b, label, weight

    def _pred_from_margin(self, margin: torch.Tensor) -> torch.Tensor:
        if self.num_class > 1:
            return margin.argmax(dim=-1).to(torch.float32)
        return (margin > 0).to(torch.float32)

    def loss_fn(self, batch) -> torch.Tensor:
        margin, label, weight = self._margin(batch)
        return _loss_from_margin(margin, label, weight, self.objective,
                                 self.l2, self.params.weight)

    def _step(self, batch) -> torch.Tensor:
        self.opt.zero_grad(set_to_none=True)
        loss = self.loss_fn(batch)
        loss.backward()
        self.opt.step()
        if self.layout != "bcoo":
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
