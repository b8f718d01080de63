"""Learners of the port."""

from dmlc_tpu_torch.models.als import AlsLearner, AlsOptState, AlsParams
from dmlc_tpu_torch.models.fm import FMLearner, FMParams
from dmlc_tpu_torch.models.linear import LinearLearner, LinearParams

__all__ = ["AlsLearner", "AlsOptState", "AlsParams", "FMLearner", "FMParams",
           "LinearLearner", "LinearParams"]
