"""Shared training-loop surface for the learners (step/fit_epoch/fit/accuracy).

Copy of the JAX package's ``models/_loop.py`` contracts in PyTorch idiom:

* **In-place updates.** A learner's ``_step(batch)`` updates its parameter
  tensors in place through its optimizer — the counterpart of the JAX
  step's ``donate_argnums=(0, 1)``: no second copy of the parameters.
* **No per-step host sync.** Losses and metric partials accumulate as
  device scalars and cross to the host once per epoch through
  :func:`host_scalar`, the loop's single sanctioned sync point (once per
  ``fit_epoch``, twice per ``accuracy``).
* **The step-count cap.** ``fit_epoch(max_steps)``, ``fit(steps_per_epoch)``
  and ``accuracy(max_steps)`` stop a pass after that many batches and
  reset the iterator, as the JAX package's loop does: the SPMD contract in
  which every process runs the same number of steps an epoch.

**Data parallelism** (``mesh=``): each rank steps on its slice of the
global batch, and the learner keeps the JAX package's global-batch
semantics with collectives of its own (:meth:`TrainLoopMixin.
_global_mean_backward`): the loss is the weighted mean over the global
batch on every rank, and the parameters stay replicated. ``accuracy``
reduces its two partials over the ranks once, at the end of the pass,
before its two host syncs.

Every one of these collectives reduces over the **data axis only**. On a
mesh with other axes (``{"data": D, "model": M}``) the ranks of one model
group hold the same rows, so a sum over every rank would count each batch
M times: a learner without a model axis is replicated over the others,
and a feature-sharded one (``LinearLearner(model_axis=)``) sums its
partial margins over the model axis itself, in its margin.

Learners provide ``_step(batch) -> loss``, ``_margin(batch) -> (margin,
label, weight)``, ``_pred_from_margin(margin)``, ``layout``, ``mesh`` (None
on one device) and ``data_axis``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dmlc_tpu_torch.ops.sparse import EllBatch
from dmlc_tpu_torch.parallel.mesh import Sharding
from dmlc_tpu_torch.utils.timer import get_time


def host_scalar(x: torch.Tensor) -> float:
    """Bring one device scalar to the host — the loop's sanctioned sync.
    Tests monkeypatch this name to count blocking syncs."""
    return float(x.item())


class TrainLoopMixin:
    def step(self, batch) -> torch.Tensor:
        """One update. Returns the loss as a DEVICE scalar — no host sync."""
        return self._step(batch)

    @torch.no_grad()
    def _accuracy(self, batch):
        margin, label, weight = self._margin(batch)
        pred = self._pred_from_margin(margin)
        return ((pred == label) * weight).sum(), weight.sum()

    def batch_shardings(self):
        """Batch placement for a DeviceIter feeding this learner (None
        without a mesh): every array's rows split over the data axis, and a
        feature-sharded dense ``x``'s columns over the model axis (the JAX
        package's ``(data, model)``)."""
        if self.mesh is None:
            return None
        row = Sharding(self.mesh, (self.data_axis, None))
        vec = Sharding(self.mesh, (self.data_axis,))
        if self.layout == "ell":
            return EllBatch(indices=row, values=row, label=vec, weight=vec)
        model_axis = getattr(self, "model_axis", None)
        x = row if model_axis is None else Sharding(self.mesh, (self.data_axis, model_axis))
        return (x, vec, vec)

    def _sum_over_ranks(self, *parts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Device scalars summed over the data axis in one all-reduce; as
        given without a mesh."""
        if self.mesh is None:
            return parts
        return self.mesh.all_reduce_(torch.stack(parts), self.data_axis).unbind()

    def _global_mean_backward(self, num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
        """Gradients of the (global) batch's weighted mean loss.

        ``num`` is this rank's ``Σ per·w`` (with its graph) and ``den`` its
        ``Σ w``. On a mesh, one 2-word SUM all-reduce over the data axis
        gives the global ``[S, D]``; this rank backpropagates ``num /
        max(D, 1)``; one SUM all-reduce over the data axis of every
        parameter's gradient, flat, sums them into the global gradient (of
        this rank's shard, under feature sharding). Not
        ``DistributedDataParallel``, which averages the ranks' own means:
        that differs from the global weighted mean whenever the ranks'
        weight sums differ (weighted rows, a short last batch). Without a
        mesh there is no collective. Returns the loss ``S / max(D, 1)``, a
        device scalar; no host sync."""
        s, d = self._sum_over_ranks(num.detach(), den.detach())
        total = torch.clamp(d, min=1.0)
        (num / total).backward()
        if self.mesh is not None:
            params = list(self.params)
            flat = self.mesh.all_reduce_(torch.cat([p.grad.reshape(-1) for p in params]),
                                         self.data_axis)
            for p, g in zip(params, flat.split([p.numel() for p in params])):
                p.grad.copy_(g.view_as(p))
        return s / total

    def fit_epoch(self, device_iter, max_steps=None) -> Tuple[float, int]:
        """One pass over a DeviceIter, at most ``max_steps`` batches;
        returns (mean loss, batches)."""
        total, n = None, 0
        for batch in device_iter:
            loss = self.step(batch)
            total = loss if total is None else total + loss
            n += 1
            if max_steps is not None and n >= max_steps:
                break
        device_iter.reset()
        if n == 0:
            return 0.0, 0
        return host_scalar(total) / n, n

    def fit(self, device_iter, epochs: int = 1, log_fn=None, steps_per_epoch=None):
        for epoch in range(epochs):
            t0 = get_time()
            loss, nb = self.fit_epoch(device_iter, max_steps=steps_per_epoch)
            if log_fn:
                log_fn(epoch, loss, nb, get_time() - t0)
        return self

    def accuracy(self, device_iter, max_steps=None) -> float:
        """Weighted accuracy over one pass (at most ``max_steps`` batches),
        reduced on the device (and, on a mesh, over the ranks once at the
        end); the two :func:`host_scalar` calls are the pass's only syncs."""
        correct, total = None, None
        n = 0
        for batch in device_iter:
            c, t = self._accuracy(batch)
            correct = c if correct is None else correct + c
            total = t if total is None else total + t
            n += 1
            if max_steps is not None and n >= max_steps:
                break
        device_iter.reset()
        return self._pass_ratio(n, correct, total)

    def _pass_ratio(self, n: int, a, b) -> float:
        """A pass's ``Σa / max(Σb, 1)`` from its two partial sums over
        ``n`` batches, summed over the data axis in one all-reduce on a mesh;
        the two :func:`host_scalar` calls are the pass's only syncs. A
        rank that saw no batch adds zeros (it takes part all the same, or
        its peers would wait for it)."""
        if n == 0:
            if self.mesh is None:
                return 0.0
            a = b = torch.zeros((), device=self.device)
        a, b = self._sum_over_ranks(a, b)
        return host_scalar(a) / max(host_scalar(b), 1.0)
