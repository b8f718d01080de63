"""dmlc_tpu_torch — the PyTorch / NVIDIA H100 port of dmlc_tpu.

The JAX package ``dmlc_tpu`` is the reference; this package imports none of
it (nor JAX) and keeps its own copies of the host layers it needs. Its main
path so far: ``create_parser`` (libsvm, csv or libfm, byte-range shards;
for a plain local file the fused native reader, read, chunked and parsed
in C++ threads, else the registry stack, native or numpy parse fanned out
over ``parse_workers`` threads) -> ``DeviceIter`` (dense batches straight
from the reader's batch repack or the parser's dense emit, ELL or sparse
COO batches, the reader's COO blocks as they come, pinned
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
global-batch semantics, on two-axis meshes too, and
``LinearLearner(model_axis=)`` shards its table over a model axis (its
ELL margin on K1 over the rank's window). ``create_parser(..., block_cache=path)`` parses
once and serves later epochs from a columnar cache, in a seeded, resumable
and pod-sharded order with ``shuffle_seed`` / ``pod_sharding``. Every
registered filesystem serves (:mod:`dmlc_tpu_torch.io.filesystem`:
``file://``, ``mem://``), a ``mem://`` corpus through the native chunk
feeder; ``engine="native-batch"`` parses chunks straight into block-cache
spans; ``create_row_block_iter`` gives the in-memory and page-cached row
iterators, which feed ``DeviceIter`` as a parser does.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a card the default raises ``DMLCError``.
"""

__version__ = "0.1.0"

from dmlc_tpu_torch.data import DeviceIter, create_parser
from dmlc_tpu_torch.models import AlsLearner, FMLearner, LinearLearner
from dmlc_tpu_torch.utils.check import DMLCError
from dmlc_tpu_torch.utils.params import Parameter
from dmlc_tpu_torch.utils.registry import Registry

__all__ = ["AlsLearner", "DMLCError", "DeviceIter", "FMLearner", "LinearLearner", "Parameter",
           "Registry", "__version__", "create_parser"]
