"""Second-order factorization machine fed by ``DeviceIter``.

The PyTorch counterpart of the JAX package's ``models/fm.py`` on one
device (no mesh yet):

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

Updates are ``torch.optim.Adam(lr=learning_rate)`` by default (β 0.9 /
0.999, ε 1e-8: the JAX learner's ``optax.adam``), or what an
``optimizer=`` factory builds. On dense and ell, the padding sink
``w[-1]`` and ``V[-1]`` is pinned to 0 after every step with a device
fill; bcoo batches need no sink (``weight_dim == num_col``).

The JAX package's ``jax.random`` init cannot be reproduced: ``V`` starts
from ``torch.Generator(device).manual_seed(seed)``, and a parity run
loads the reference's initial parameters through :meth:`FMLearner.set_params`
(``dmlc_tpu_torch.convert.fm_params_from_jax``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from dmlc_tpu_torch._device import resolve_device
from dmlc_tpu_torch.models._loop import TrainLoopMixin
from dmlc_tpu_torch.ops.row_scatter import gather_rows
from dmlc_tpu_torch.ops.sparse import coo_matmul
from dmlc_tpu_torch.utils.check import check


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
    means Adam at ``learning_rate``. ``device=None`` means the CUDA device
    and raises on a host without one."""

    def __init__(self, num_col: int, num_factors: int = 8, objective: str = "logistic",
                 layout: str = "dense",
                 optimizer: Optional[Callable[[list], torch.optim.Optimizer]] = None,
                 learning_rate: float = 0.05, init_scale: float = 0.01, l2: float = 0.0,
                 seed: int = 0, device=None):
        check(layout in ("dense", "ell", "bcoo"), "FMLearner: layout must be dense|ell|bcoo")
        check(objective in ("logistic", "squared"),
              f"FMLearner: unknown objective {objective!r}")
        check(num_factors >= 1, "FMLearner: num_factors must be >= 1")
        self.device = resolve_device(device)
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
            self.opt = torch.optim.Adam(list(self.params), lr=learning_rate)
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

    def _margin(self, batch):
        if self.layout == "ell":
            return _margin_ell(self.params, batch), batch.label, batch.weight
        x, label, weight = batch
        if self.layout == "bcoo":
            return _margin_bcoo(self.params, x), label, weight
        return _margin_dense(self.params, x), label, weight

    def _pred_from_margin(self, margin: torch.Tensor) -> torch.Tensor:
        return (margin > 0).to(torch.float32)

    def loss_fn(self, batch) -> torch.Tensor:
        margin, label, weight = self._margin(batch)
        if self.objective == "logistic":
            per = F.binary_cross_entropy_with_logits(margin, label, reduction="none")
        else:
            per = 0.5 * (margin - label) ** 2
        loss = (per * weight).sum() / torch.clamp(weight.sum(), min=1.0)
        if self.l2 > 0.0:
            loss = loss + 0.5 * self.l2 * (torch.sum(self.params.w ** 2)
                                           + torch.sum(self.params.v ** 2))
        return loss

    def _step(self, batch) -> torch.Tensor:
        self.opt.zero_grad(set_to_none=True)
        loss = self.loss_fn(batch)
        loss.backward()
        self.opt.step()
        if self.layout != "bcoo":
            with torch.no_grad():
                # keep the padding sink inert; zero_() is a device fill
                self.params.w[-1].zero_()
                self.params.v[-1].zero_()
        return loss.detach()

    @torch.no_grad()
    def predict(self, batch) -> torch.Tensor:
        """The raw margin of a batch (a sigmoid gives probabilities)."""
        return self._margin(batch)[0]
