"""Learners of the port."""

from dmlc_tpu_torch.models.linear import LinearLearner, LinearParams

__all__ = ["LinearLearner", "LinearParams"]
