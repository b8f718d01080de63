"""Alternating least squares fed by ``DeviceIter`` (ELL batches).

The PyTorch counterpart of the JAX package's ``models/als.py`` on one
device (no mesh yet):

- **Data.** Each corpus row is one user's ratings in libsvm form: the
  label carries the user id, the ``item:rating`` features the observed
  entries. ELL pad slots carry index ``num_items``, the item table's sink
  row, pinned to zero, so they add nothing to a sum.
- **User half-step, per batch** (:meth:`AlsLearner.step`). For each row
  ``A_u = V_uᵀ V_u + reg·I`` from a gather of the item table and
  ``b_u = V_uᵀ r_u`` through the plain 2-D ELL matvec; the rows are solved
  by ``torch.linalg.solve_ex`` (LU, as ``jnp.linalg.solve``; never
  ``torch.linalg.solve``, which synchronises the host on CUDA to check
  its info) and copied into the user table (``index_copy_``: a batch's
  user ids are distinct, so feed it with ``drop_remainder=True``, whose
  batches carry no pad rows).
- **Item half-step, per epoch** (:meth:`AlsLearner.finalize_items`). The
  item side's normal equations accumulate over the epoch in a
  ``[D+1, F, F]`` gram and a ``[D+1, F]`` rhs, by one
  :func:`~dmlc_tpu_torch.ops.row_scatter.row_scatter_add_` a step (the two
  are views of one ``[D+1, F*F + F]`` buffer, so one sort of the batch's
  item ids serves both), whose card route gives the same bits on every
  run; then one batched solve, and the sink row is pinned again with a
  device fill.

Steps run under ``torch.no_grad()`` and update the tables in place, the
counterpart of the JAX step's donated buffers. The loss of a step is the
weighted mean squared error of the freshly solved rows. With fixed inputs
the trajectory is deterministic, on the card too, so a mid-epoch
checkpoint (:meth:`state_dict` with ``DeviceIter.state_dict()``) replays
the loss stream byte for byte. Host syncs: one per ``fit_epoch``, none in
``finalize_items``, two per ``eval_loss``.

The JAX package's ``jax.random`` init cannot be reproduced here: the item
table starts from ``torch.Generator(device).manual_seed(seed)``, and a
parity run loads the reference's initial state through
:meth:`load_state_dict`.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from dmlc_tpu_torch._device import resolve_device
from dmlc_tpu_torch.models import _loop
from dmlc_tpu_torch.models._loop import TrainLoopMixin
from dmlc_tpu_torch.ops.ell_matvec import ell_matvec_auto
from dmlc_tpu_torch.ops.row_scatter import row_scatter_add_
from dmlc_tpu_torch.utils.check import check

STATE_KEYS = ("users", "items", "gram", "rhs")


class AlsParams(NamedTuple):
    users: torch.Tensor  # [num_users, F], solved exactly per batch
    items: torch.Tensor  # [num_items + 1, F]; the last row is the ELL pad sink, pinned 0


class AlsOptState(NamedTuple):
    gram: torch.Tensor  # [num_items + 1, F, F]: Σ u uᵀ per observation
    rhs: torch.Tensor   # [num_items + 1, F]: Σ r·u per observation


class AlsLearner(TrainLoopMixin):
    """ALS over ELL batches whose label carries the user id
    (``DeviceIter(layout="ell", num_col=model.device_num_col(), ...)``).
    ``fit_epoch`` runs the user sweep and then :meth:`finalize_items`, so
    ``fit(epochs=N)`` runs N alternations. ``device=None`` means the CUDA
    device and raises on a host without one."""

    def __init__(self, num_users: int, num_items: int, num_factors: int = 8,
                 reg: float = 0.1, init_scale: float = 0.1, seed: int = 0,
                 device=None):
        check(num_users > 0 and num_items > 0 and num_factors > 0,
              "AlsLearner: num_users/num_items/num_factors must be positive")
        self.device = resolve_device(device)
        self.num_users = num_users
        self.num_items = num_items
        self.num_factors = num_factors
        self.reg = float(reg)
        dev, f = self.device, num_factors
        gen = torch.Generator(device=dev).manual_seed(seed)
        items = init_scale * torch.randn((num_items + 1, f), generator=gen, device=dev)
        items[-1].zero_()
        self.params = AlsParams(users=torch.zeros((num_users, f), device=dev), items=items)
        # each item's gram row and rhs row side by side: one scatter a step
        self._normal_eq = torch.zeros((num_items + 1, f * f + f), device=dev)
        self.opt_state = AlsOptState(gram=self._normal_eq[:, :f * f].view(num_items + 1, f, f),
                                     rhs=self._normal_eq[:, f * f:])
        self._reg_eye = self.reg * torch.eye(f, device=dev)

    def device_num_col(self) -> int:
        """The ``num_col`` a DeviceIter must use: the pad index is
        ``num_items``, the item table's pinned-zero sink row."""
        return self.num_items

    @torch.no_grad()
    def _step(self, batch) -> torch.Tensor:
        users, items = self.params
        idx = batch.indices                          # [B, K], pad = num_items
        vals, w = batch.values, batch.weight         # [B, K], [B]
        v_g = items[idx]                             # [B, K, F]; 0 at pads
        b = ell_matvec_auto(items, batch)            # [B, F]: V_uᵀ r_u
        a = torch.einsum("bkf,bkg->bfg", v_g, v_g) + self._reg_eye
        u = torch.linalg.solve_ex(a, b[..., None])[0][..., 0]   # [B, F]
        users.index_copy_(0, batch.label.long(), u)
        wk = (idx != self.num_items) * w[:, None]                   # [B, K]
        row_scatter_add_(self._normal_eq, *self.normal_eq_rows(batch, u, wk))
        # weighted MSE of the freshly solved rows (pads are exact zeros on
        # both sides, so only the count needs the mask)
        err = torch.einsum("bkf,bf->bk", v_g, u) - vals
        return torch.dot((err * err).reshape(-1), wk.reshape(-1)) / torch.clamp(wk.sum(), min=1.0)

    def normal_eq_rows(self, batch, u: torch.Tensor, wk=None):
        """``(ids [B*K], rows [B*K, F*F + F])``: what a step with solved
        users ``u [B, F]`` scatter-adds into the item side's normal
        equations, each observation's gram row and rhs row side by side.
        Pad slots land in the sink row (masked for the gram, rating 0 for
        the rhs), which :meth:`finalize_items` pins to zero."""
        idx, f = batch.indices, self.num_factors
        if wk is None:
            wk = (idx != self.num_items) * batch.weight[:, None]
        gram = wk[..., None, None] * (u[:, None, :, None] * u[:, None, None, :])
        rhs = (batch.weight[:, None] * batch.values)[..., None] * u[:, None, :]   # [B, K, F]
        return idx.reshape(-1), torch.cat([gram.reshape(-1, f * f), rhs.reshape(-1, f)], dim=1)

    @torch.no_grad()
    def finalize_items(self) -> None:
        """Solve the item half from the epoch's normal equations, pin the
        sink row, and zero the accumulators, in place and with no host
        sync."""
        gram, rhs = self.opt_state
        items = torch.linalg.solve_ex(gram + self._reg_eye, rhs[..., None])[0][..., 0]
        self.params.items.copy_(items)
        self.params.items[-1].zero_()  # a device fill: no host scalar crosses
        self._normal_eq.zero_()

    def fit_epoch(self, device_iter, max_steps=None) -> Tuple[float, int]:
        """The user sweep (one host sync) and then the item solve."""
        loss, n = super().fit_epoch(device_iter, max_steps=max_steps)
        self.finalize_items()
        return loss, n

    @torch.no_grad()
    def _eval(self, batch):
        users, items = self.params
        idx = batch.indices
        u = users[batch.label.long()]                # [B, F]
        pred = torch.einsum("bkf,bf->bk", items[idx], u)
        wk = (idx != self.num_items) * batch.weight[:, None]
        err = pred - batch.values
        return ((err * err) * wk).sum(), wk.sum()

    def eval_loss(self, device_iter, max_steps=None) -> float:
        """Weighted MSE over one pass (at most ``max_steps`` batches); the
        partial sums stay on the device, two host syncs in all."""
        se, wsum, n = None, None, 0
        for batch in device_iter:
            s, t = self._eval(batch)
            se = s if se is None else se + s
            wsum = t if wsum is None else wsum + t
            n += 1
            if max_steps is not None and n >= max_steps:
                break
        device_iter.reset()
        if n == 0:
            return 0.0
        return _loop.host_scalar(se) / max(_loop.host_scalar(wsum), 1.0)

    def state_dict(self) -> dict:
        """The whole training state as float32 numpy arrays, under the JAX
        package's keys: with ``DeviceIter.state_dict()`` a mid-epoch
        checkpoint, which replays the loss stream byte for byte."""
        tensors = dict(zip(STATE_KEYS, (*self.params, *self.opt_state)))
        return {k: t.cpu().numpy().copy() for k, t in tensors.items()}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Load a :meth:`state_dict` of either package, in place."""
        for key, t in zip(STATE_KEYS, (*self.params, *self.opt_state)):
            arr = np.array(state[key], dtype=np.float32)
            check(arr.shape == tuple(t.shape),
                  f"AlsLearner.load_state_dict: {key} is {arr.shape}, the learner's "
                  f"{tuple(t.shape)}")
            t.copy_(torch.from_numpy(arr))
