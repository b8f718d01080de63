"""Data layer of the port: row blocks, the libsvm, csv and libfm parsers
with the dense emit, the parse fan-out, the fused native reader (its
packed dense repack and COO emit) and the engine selection, the parse-once
block cache and the epoch planner, the device feed (with the snapshot
store and its device-decode tier, and mid-epoch checkpoints from the split
up)."""

from dmlc_tpu_torch.data.device import DeviceIter, PackedDenseBatch
from dmlc_tpu_torch.data.parsers import (CSVParser, LibFMParser, LibSVMParser,
                                         ParallelTextParser, Parser, ThreadedParser,
                                         create_parser)
from dmlc_tpu_torch.data.native_parser import NativeStreamParser
from dmlc_tpu_torch.data.row_block import CooBlock, DenseBlock, RowBlock, RowBlockContainer

__all__ = ["CSVParser", "CooBlock", "DenseBlock", "DeviceIter", "LibFMParser",
           "LibSVMParser", "NativeStreamParser", "PackedDenseBatch", "ParallelTextParser",
           "Parser", "RowBlock", "RowBlockContainer", "ThreadedParser", "create_parser"]
