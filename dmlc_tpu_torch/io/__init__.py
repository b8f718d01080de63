"""Host I/O of the port: URIs, local files, line splits, prefetch threads
and the ordered worker pool, the segment container with the block cache,
and the snapshot store."""

from dmlc_tpu_torch.io.input_split import (DEFAULT_CHUNK_BYTES, LineSplitter, MmapLineSplit,
                                           create_mmap_text_split)
from dmlc_tpu_torch.io.threaded_iter import ThreadedIter
from dmlc_tpu_torch.io.uri import URI, URISpec

__all__ = ["DEFAULT_CHUNK_BYTES", "LineSplitter", "MmapLineSplit", "ThreadedIter", "URI",
           "URISpec", "create_mmap_text_split"]
