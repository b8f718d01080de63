"""Carry linear-learner parameters between the JAX package and the port.

Both sides meet as numpy arrays: ``np.asarray`` of a JAX ``LinearParams``'
fields goes in, and the same arrays come out, so one initial state can be
trained by both packages and compared.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from dmlc_tpu_torch._device import resolve_device
from dmlc_tpu_torch.models.linear import LinearParams


def linear_params_from_jax(weight: np.ndarray, bias: np.ndarray,
                           device=None) -> LinearParams:
    """float32 tensors on ``device`` (default: the CUDA device)."""
    dev = resolve_device(device)
    return LinearParams(
        weight=torch.tensor(np.asarray(weight, np.float32), device=dev),
        bias=torch.tensor(np.asarray(bias, np.float32), device=dev))


def linear_params_to_jax(params: LinearParams) -> Tuple[np.ndarray, np.ndarray]:
    """(weight, bias) as float32 numpy arrays, for ``jnp.asarray``."""
    return (params.weight.detach().cpu().numpy().astype(np.float32),
            params.bias.detach().cpu().numpy().astype(np.float32))
