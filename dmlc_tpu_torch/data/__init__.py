"""Data layer of the port: row blocks, the libsvm parser, the device feed
(with the snapshot store and its device-decode tier, and mid-epoch
checkpoints from the split up)."""

from dmlc_tpu_torch.data.device import DeviceIter, PackedDenseBatch
from dmlc_tpu_torch.data.parsers import LibSVMParser, Parser, ThreadedParser, create_parser
from dmlc_tpu_torch.data.row_block import RowBlock, RowBlockContainer

__all__ = ["DeviceIter", "LibSVMParser", "PackedDenseBatch", "Parser", "RowBlock",
           "RowBlockContainer", "ThreadedParser", "create_parser"]
