"""Data layer of the port: row blocks, the libsvm parser, the device feed."""

from dmlc_tpu_torch.data.device import DeviceIter
from dmlc_tpu_torch.data.parsers import LibSVMParser, Parser, ThreadedParser, create_parser
from dmlc_tpu_torch.data.row_block import RowBlock, RowBlockContainer

__all__ = ["DeviceIter", "LibSVMParser", "Parser", "RowBlock",
           "RowBlockContainer", "ThreadedParser", "create_parser"]
