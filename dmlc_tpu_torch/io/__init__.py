"""Host I/O of the port: URIs, local files, the split layer (splitters,
the prefetch and shuffle decorators, the chunk cache, RecordIO), prefetch
threads and the ordered worker pool, the segment container with the block
cache, and the snapshot store."""

from dmlc_tpu_torch.io.input_split import (DEFAULT_CHUNK_BYTES, IndexedRecordIOSplitter,
                                           InputSplit, InputSplitBase, LineSplitter,
                                           MmapLineSplit, RecordIOSplitter, ShuffledInputSplit,
                                           SingleFileSplit, ThreadedInputSplit,
                                           create_input_split, create_mmap_text_split)
from dmlc_tpu_torch.io.threaded_iter import ThreadedIter
from dmlc_tpu_torch.io.uri import URI, URISpec

__all__ = ["DEFAULT_CHUNK_BYTES", "IndexedRecordIOSplitter", "InputSplit", "InputSplitBase",
           "LineSplitter", "MmapLineSplit", "RecordIOSplitter", "ShuffledInputSplit",
           "SingleFileSplit", "ThreadedInputSplit", "ThreadedIter", "URI", "URISpec",
           "create_input_split", "create_mmap_text_split"]
