"""Sparse layouts and their plain products (``ops.sparse``), and the
hand-written kernels with their routes (``ops.ell_matvec``, K1;
``ops.device_decode``, K2; ``ops.row_scatter``). The plain ELL matvec is
``ops.sparse.ell_matvec``: the name ``ops.ell_matvec`` is K1's module."""

from dmlc_tpu_torch.ops.ell_matvec import ell_matvec_auto
from dmlc_tpu_torch.ops.sparse import (EllBatch, block_to_bcoo, block_to_dense, block_to_ell,
                                       ell_matmul, segment_csr_matvec)

__all__ = ["EllBatch", "block_to_bcoo", "block_to_dense", "block_to_ell", "ell_matmul",
           "segment_csr_matvec", "ell_matvec_auto"]
