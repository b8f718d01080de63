"""Parallelism of the port: meshes over ranks, batch placement, and the
``torch.distributed`` bootstrap from the ``DMLC_*`` env contract.

The JAX package's mesh and XLA collectives become a process group (NCCL on
the card, gloo on the CPU) and collectives the learners issue themselves;
the names below are the JAX package's ``dmlc_tpu.parallel.__all__``.
"""

from dmlc_tpu_torch.parallel.mesh import (
    data_sharding, host_shard_info, local_batch_to_global, make_mesh, replicated,
)
from dmlc_tpu_torch.parallel.distributed import (
    EnvContract, init_from_env, pod_identity, sync_min,
)

__all__ = [
    "make_mesh", "data_sharding", "replicated", "local_batch_to_global",
    "host_shard_info", "init_from_env", "EnvContract", "pod_identity",
    "sync_min",
]
