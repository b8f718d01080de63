"""Carry learner states between the JAX package and the port.

Both sides meet as numpy arrays: ``np.asarray`` of a JAX learner's
parameters (or an ``AlsLearner.state_dict()``) goes in, and the same
arrays come out, so one state can be trained by both packages and
compared, or a checkpoint of one restored into the other. A
feature-sharded ``LinearLearner`` takes its rank's shard of the JAX table
(:func:`linear_params_from_jax` with ``mesh=`` / ``model_axis=``), and
:func:`linear_params_gather_to_jax` all-gathers the shards back into the
global table, as ``np.asarray`` of a sharded JAX array does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from dmlc_tpu_torch._device import resolve_device
from dmlc_tpu_torch.models.als import STATE_KEYS as ALS_STATE_KEYS
from dmlc_tpu_torch.models.fm import FMParams
from dmlc_tpu_torch.models.linear import LinearParams
from dmlc_tpu_torch.parallel.mesh import shard_window
from dmlc_tpu_torch.utils.check import check


def linear_params_from_jax(weight: np.ndarray, bias: np.ndarray, device=None, *,
                           mesh=None, model_axis: Optional[str] = None) -> LinearParams:
    """float32 tensors on ``device`` (default: the CUDA device; the
    mesh's with ``mesh=``). Under feature sharding (``model_axis``), this
    rank's shard of the global table, the rows at its coordinate on that
    axis (``LinearLearner.shard_lo`` / ``shard_width``); the bias whole."""
    dev = mesh.device if mesh is not None and device is None else resolve_device(device)
    weight = np.asarray(weight, np.float32)
    lo, width = shard_window(mesh, model_axis, weight.shape[0])
    return LinearParams(
        weight=torch.tensor(weight[lo:lo + width], device=dev),
        bias=torch.tensor(np.asarray(bias, np.float32), device=dev))


def linear_params_to_jax(params: LinearParams) -> Tuple[np.ndarray, np.ndarray]:
    """(weight, bias) as float32 numpy arrays, for ``jnp.asarray``."""
    return (params.weight.detach().cpu().numpy().astype(np.float32),
            params.bias.detach().cpu().numpy().astype(np.float32))


def linear_params_gather_to_jax(params: LinearParams, mesh,
                                model_axis: str) -> Tuple[np.ndarray, np.ndarray]:
    """(weight, bias) of a feature-sharded learner as float32 numpy
    arrays: the global table, its shards all-gathered over ``model_axis``
    in coordinate order (a collective: every rank of the model group calls
    it), the counterpart of ``np.asarray(model.params.weight)`` on a
    sharded JAX array."""
    weight = mesh.all_gather(params.weight.detach(), model_axis)
    return linear_params_to_jax(LinearParams(weight, params.bias))


def fm_params_from_jax(w0: np.ndarray, w: np.ndarray, v: np.ndarray,
                       device=None) -> FMParams:
    """float32 tensors on ``device`` (default: the CUDA device), for
    ``FMLearner.set_params``."""
    dev = resolve_device(device)
    return FMParams(*(torch.tensor(np.asarray(a, np.float32), device=dev)
                      for a in (w0, w, v)))


def fm_params_to_jax(params: FMParams) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(w0, w, v) as float32 numpy arrays, for ``jnp.asarray``."""
    return tuple(t.detach().cpu().numpy().astype(np.float32) for t in params)


def _als_state(state: dict, who: str) -> dict:
    missing = [k for k in ALS_STATE_KEYS if k not in state]
    check(not missing, f"{who}: the ALS state lacks {missing}")
    return {k: np.array(state[k], dtype=np.float32) for k in ALS_STATE_KEYS}


def als_state_from_jax(state: dict) -> dict:
    """A JAX ``AlsLearner.state_dict()`` as the port's
    ``AlsLearner.load_state_dict`` takes it: the same keys
    (``users``, ``items``, ``gram``, ``rhs``), float32 numpy copies."""
    return _als_state(state, "als_state_from_jax")


def als_state_to_jax(state: dict) -> dict:
    """The port's ``AlsLearner.state_dict()`` as the JAX learner's
    ``load_state_dict`` takes it (the same keys, float32 numpy copies)."""
    return _als_state(state, "als_state_to_jax")
