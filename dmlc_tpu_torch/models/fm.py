"""Second-order factorization machine fed by ``DeviceIter``.

The PyTorch counterpart of the JAX package's ``models/fm.py``:

    margin(x) = w0 + <w, x> + 0.5 * Σ_f [ <V[:, f], x>² - <V[:, f]², x²> ]

- **dense** ``[B, W]`` batches: ``x @ w`` and the two products
  ``(x @ V)²`` and ``(x²) @ (V²)``, plain matmuls;
- **ell** batches: gathers ``w[idx]`` and ``V[idx]`` (``[B, K, F]``),
  whose gradients scatter back through
  :func:`~dmlc_tpu_torch.ops.row_scatter.row_scatter_add` (the same bits on
  every run on the card); pad slots carry value 0 and the sink index;
- **bcoo** batches: :func:`~dmlc_tpu_torch.ops.sparse.coo_matmul` for
  ``x @ w`` and ``x @ V``, and for ``x² @ V²`` a second COO tensor on the
  same coordinates with squared values.

Updates are :class:`~dmlc_tpu_torch.ops.adam.FusedAdam` at
``learning_rate`` by default: a ``torch.optim.Adam`` (β 0.9 / 0.999, ε
1e-8; the update of the JAX learner's ``optax.adam`` and of torch's Adam)
whose step is one pass over all three leaves, one kernel launch on the
card (``csrc/adam_step.cu``). An ``optimizer=`` factory builds any other.
On ell batches the step hands that Adam the batch's ids as the rows of
``w`` and ``V`` whose gradient may be non-zero (the gathers' scatter
writes +0.0 on every other row), so the kernel reads the gradient there
only: the same bits. Not where another term reaches every row (``l2``, a
mesh's all-reduce of other ranks' rows), on the dense and bcoo layouts
(matmul gradients), or with another optimizer.
On dense and ell, the padding sink ``w[-1]`` and ``V[-1]`` is pinned to 0
after every step with a device fill; bcoo batches need no sink
(``weight_dim == num_col``).

With ``mesh=`` the dense and ell layouts train data-parallel as
``LinearLearner`` does (``_loop.TrainLoopMixin._global_mean_backward``:
the global batch's weighted mean loss, one flat all-reduce of the
``w0``/``w``/``V`` gradients, the ``l2`` gradient added once after it),
with Adam run identically on every rank; bcoo raises. Every collective
reduces over the data axis alone, so on a mesh with other axes
(``{"data": D, "model": M}``) the learner is replicated over them, as the
JAX learner is there.

The JAX package's ``jax.random`` init cannot be reproduced: ``V`` starts
from ``torch.Generator(device).manual_seed(seed)``, and a parity run
loads the reference's initial parameters through :meth:`FMLearner.set_params`
(``dmlc_tpu_torch.convert.fm_params_from_jax``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from dmlc_tpu_torch.models._loop import TrainLoopMixin
from dmlc_tpu_torch.ops.adam import FusedAdam
from dmlc_tpu_torch.ops.row_scatter import gather_rows
from dmlc_tpu_torch.ops.sparse import coo_matmul
from dmlc_tpu_torch.parallel.mesh import rank_device
from dmlc_tpu_torch.utils.check import check
from dmlc_tpu_torch.utils.telemetry import profiler_annotation


class FMParams(NamedTuple):
    w0: torch.Tensor  # scalar bias
    w: torch.Tensor   # [W] linear weights; the last slot is the ELL padding sink
    v: torch.Tensor   # [W, F] factor rows; the sink row pinned to 0


def _interaction(s: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.sum(s * s - s2, dim=-1)


def _margin_dense(params: FMParams, x: torch.Tensor) -> torch.Tensor:
    x = x.to(params.w.dtype)
    linear = x @ params.w + params.w0
    return linear + _interaction(x @ params.v, (x * x) @ (params.v * params.v))


def _margin_bcoo(params: FMParams, mat: torch.Tensor) -> torch.Tensor:
    linear = coo_matmul(mat, params.w) + params.w0
    # the squared operand: the same coordinates (still row-major, so still
    # coalesced) with squared values
    mat2 = torch.sparse_coo_tensor(mat._indices(), mat._values() * mat._values(),
                                   mat.shape, is_coalesced=mat.is_coalesced(),
                                   check_invariants=False)
    return linear + _interaction(coo_matmul(mat, params.v),
                                 coo_matmul(mat2, params.v * params.v))


def _margin_ell(params: FMParams, batch) -> torch.Tensor:
    w_g = gather_rows(params.w, batch.indices)          # [B, K]
    v_g = gather_rows(params.v, batch.indices)          # [B, K, F]
    val = batch.values
    linear = torch.sum(w_g * val, dim=-1) + params.w0
    s = torch.einsum("bkf,bk->bf", v_g, val)             # Σ_k v_k x_k
    s2 = torch.einsum("bkf,bk->bf", v_g * v_g, val * val)  # Σ_k v_k² x_k²
    return linear + _interaction(s, s2)


class FMLearner(TrainLoopMixin):
    """Second-order factorization machine (logistic or squared objective).

    ``layout`` matches the DeviceIter layout ('dense', 'ell' or 'bcoo').
    ``optimizer`` is a factory ``params -> torch.optim.Optimizer``; None
    means :class:`FusedAdam` at ``learning_rate``. ``device=None`` means the CUDA device
    and raises on a host without one; on a ``mesh``, the mesh's device.
    ``mesh`` trains data-parallel over ``data_axis``."""

    def __init__(self, num_col: int, num_factors: int = 8, objective: str = "logistic",
                 layout: str = "dense",
                 optimizer: Optional[Callable[[list], torch.optim.Optimizer]] = None,
                 learning_rate: float = 0.05, init_scale: float = 0.01, l2: float = 0.0,
                 seed: int = 0, mesh=None, data_axis: str = "data", device=None):
        check(layout in ("dense", "ell", "bcoo"), "FMLearner: layout must be dense|ell|bcoo")
        check(layout != "bcoo" or mesh is None,
              "layout='bcoo' is single-device (matches DeviceIter bcoo)")
        check(objective in ("logistic", "squared"),
              f"FMLearner: unknown objective {objective!r}")
        check(num_factors >= 1, "FMLearner: num_factors must be >= 1")
        self.mesh = mesh
        self.data_axis = data_axis
        self.device = rank_device(mesh, device, data_axis=data_axis, who="FMLearner")
        self.num_col = num_col
        self.num_factors = num_factors
        self.objective = objective
        self.layout = layout
        self.l2 = float(l2)
        # +1: the ELL/dense padding sink; bcoo batches hold real entries only
        self.weight_dim = num_col if layout == "bcoo" else num_col + 1
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        v = init_scale * torch.randn((self.weight_dim, num_factors), generator=gen, device=dev)
        if layout != "bcoo":
            v[-1].zero_()
        self.params = FMParams(w0=torch.zeros((), device=dev),
                               w=torch.zeros(self.weight_dim, device=dev), v=v)
        for t in self.params:
            t.requires_grad_(True)
        if optimizer is None:
            self.opt = FusedAdam(list(self.params), lr=learning_rate)
        else:
            self.opt = optimizer(list(self.params))

    def device_num_col(self) -> int:
        """The ``num_col`` a DeviceIter must use to feed this learner."""
        return self.weight_dim - 1 if self.layout == "ell" else self.weight_dim

    @torch.no_grad()
    def set_params(self, params: FMParams) -> None:
        """Copy ``params`` into this learner's tensors (in place, so the
        optimizer keeps tracking them)."""
        for dst, src in zip(self.params, params):
            dst.copy_(src)

    def _margin(self, batch, params: Optional[FMParams] = None):
        params = self.params if params is None else params
        if self.layout == "ell":
            return _margin_ell(params, batch), batch.label, batch.weight
        x, label, weight = batch
        if self.layout == "bcoo":
            return _margin_bcoo(params, x), label, weight
        return _margin_dense(params, x), label, weight

    def _pred_from_margin(self, margin: torch.Tensor) -> torch.Tensor:
        return (margin > 0).to(torch.float32)

    def _per_example(self, margin, label) -> torch.Tensor:
        if self.objective == "logistic":
            return F.binary_cross_entropy_with_logits(margin, label, reduction="none")
        return 0.5 * (margin - label) ** 2

    def _data_terms(self, params: FMParams, batch):
        """This rank's ``(Σ per·w, Σ w)`` over ``batch`` at ``params``."""
        margin, label, weight = self._margin(batch, params)
        per = self._per_example(margin, label)
        return (per * weight).sum(), weight.sum()

    def _l2_term(self, w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return 0.5 * self.l2 * (torch.sum(w ** 2) + torch.sum(v ** 2))

    def loss_fn(self, params: FMParams, batch) -> torch.Tensor:
        """The scalar loss at ``params`` on ``batch``: the weighted mean
        loss plus ``0.5 · l2 · (Σw² + Σv²)``, differentiable in ``params``
        (JAX's ``FMLearner.loss_fn``, ``dmlc_tpu/models/fm.py:152``).
        :meth:`step` computes the same terms with the same functions and
        returns this value; on a mesh it takes the mean over the global
        batch, and it adds the ``l2`` gradient after the reduction."""
        num, den = self._data_terms(params, batch)
        loss = num / torch.clamp(den, min=1.0)
        if self.l2 > 0.0:
            loss = loss + self._l2_term(params.w, params.v)
        return loss

    def _step(self, batch) -> torch.Tensor:
        # three profiler ranges tile the step (``dmlc_tpu.step.*``)
        with profiler_annotation("dmlc_tpu.step.forward"):
            self.opt.zero_grad(set_to_none=True)
            terms = self._data_terms(self.params, batch)
        with profiler_annotation("dmlc_tpu.step.backward"):
            loss = self._global_mean_backward(*terms)
            if self.l2 > 0.0:
                # once, after any reduction (the same on every rank)
                w, v = self.params.w.detach(), self.params.v.detach()
                loss = loss + self._l2_term(w, v)
                self.params.w.grad.add_(w, alpha=self.l2)
                self.params.v.grad.add_(v, alpha=self.l2)
        with profiler_annotation("dmlc_tpu.step.optimizer"):
            self.opt.step(**self._grad_rows(batch))
            if self.layout != "bcoo":
                with torch.no_grad():
                    # keep the padding sink inert; zero_() is a device fill
                    self.params.w[-1].zero_()
                    self.params.v[-1].zero_()
        return loss.detach()

    def _grad_rows(self, batch) -> dict:
        """``{"rows": ...}`` for :class:`FusedAdam`'s step where the batch's
        ids name every row of ``w`` and ``V`` whose gradient may be non-zero
        (ell, no mesh, no ``l2``, the default optimizer); else nothing."""
        if (self.layout != "ell" or self.mesh is not None or self.l2 != 0.0
                or type(self.opt) is not FusedAdam):
            return {}
        return {"rows": {self.params.w: batch.indices, self.params.v: batch.indices}}

    @torch.no_grad()
    def predict(self, batch) -> torch.Tensor:
        """The raw margin of a batch (a sigmoid gives probabilities)."""
        return self._margin(batch)[0]
