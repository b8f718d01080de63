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

Learners provide ``_step(batch) -> loss``, ``_margin(batch) -> (margin,
label, weight)`` and ``_pred_from_margin(margin)``.
"""

from __future__ import annotations

from typing import Tuple

import torch

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
        reduced on the device; the two :func:`host_scalar` calls at the end
        are the pass's only syncs."""
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
        if n == 0:
            return 0.0
        return host_scalar(correct) / max(host_scalar(total), 1.0)
