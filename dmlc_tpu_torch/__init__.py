"""dmlc_tpu_torch — the PyTorch / NVIDIA H100 port of dmlc_tpu.

The JAX package ``dmlc_tpu`` is the reference; this package imports none of
it (nor JAX) and keeps its own copies of the host layers it needs. Its main
path so far: ``create_parser`` (libsvm, byte-range shards, native or numpy
parse) -> ``DeviceIter`` (dense, ELL or sparse COO batches, pinned
staging, async copies) -> ``LinearLearner`` (SGD; the ELL margin on the
hand-written CUDA kernel ``csrc/ell_matvec.cu``) -> ``fit`` /
``accuracy``, with mid-epoch checkpoints (``state_dict`` / ``load_state``,
the JAX package's states). With
``create_parser(..., snapshot=path)`` the first epoch writes its batches
to a snapshot file and later epochs serve them from it; with
``DeviceIter(device_decode=True)`` each served batch crosses as raw bytes
and is decoded on the card in one launch of ``csrc/widen_span.cu``. The
``AlsLearner`` and ``FMLearner`` train on the same ``DeviceIter``; every
row scatter-add of their steps gives the same bits on every run. With
``mesh=`` (:mod:`dmlc_tpu_torch.parallel`, on ``torch.distributed``:
``init_from_env`` from the DMLC_* contract, ``make_mesh``, ``sync_min``)
the three learners train data-parallel with the JAX package's
global-batch semantics. ``create_parser(..., block_cache=path)`` parses
once and serves later epochs from a columnar cache, in a seeded, resumable
and pod-sharded order with ``shuffle_seed`` / ``pod_sharding``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a card the default raises ``DMLCError``.
"""

from dmlc_tpu_torch.data import DeviceIter, create_parser
from dmlc_tpu_torch.models import AlsLearner, FMLearner, LinearLearner
from dmlc_tpu_torch.utils.check import DMLCError

__all__ = ["AlsLearner", "DMLCError", "DeviceIter", "FMLearner", "LinearLearner",
           "create_parser"]
