"""Data layer of the port: row blocks, the libsvm, csv and libfm parsers
with the dense emit, the parse fan-out, the fused native reader (its
packed dense repack and COO emit), its chunk feeder and the engine
selection, the chunk-batch engine, the parse-once block cache and the
epoch planner, the row iterators, the online autotuner, and the device
feed (with the snapshot store and its device-decode tier, and mid-epoch
checkpoints from the split up)."""

from dmlc_tpu_torch.data.autotune import AutoTuner, Knob, ParseTierTuner
from dmlc_tpu_torch.data.device import DeviceIter, PackedDenseBatch
from dmlc_tpu_torch.data.epoch import (EpochPlan, block_permutation, permute_block_rows,
                                       row_permutation)
from dmlc_tpu_torch.data.iterators import (BasicRowIter, DiskRowIter, RowBlockIter,
                                           create_row_block_iter)
from dmlc_tpu_torch.data.native_parser import NativeStreamParser
from dmlc_tpu_torch.data.parsers import (BlockCacheIter, CSVParser, LibFMParser, LibSVMParser,
                                         ParallelTextParser, Parser, ThreadedParser,
                                         create_parser)
from dmlc_tpu_torch.data.row_block import (CooBlock, DenseBlock, Row, RowBlock,
                                           RowBlockContainer)

__all__ = ["AutoTuner", "BasicRowIter", "BlockCacheIter", "CSVParser", "CooBlock",
           "DenseBlock", "DeviceIter", "DiskRowIter", "EpochPlan", "Knob", "LibFMParser",
           "LibSVMParser", "NativeStreamParser", "PackedDenseBatch", "ParallelTextParser",
           "ParseTierTuner", "Parser", "Row", "RowBlock", "RowBlockContainer", "RowBlockIter",
           "ThreadedParser", "block_permutation", "create_parser", "create_row_block_iter",
           "permute_block_rows", "row_permutation"]
