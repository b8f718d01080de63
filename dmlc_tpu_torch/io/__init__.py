"""Host I/O of the port: URIs, the filesystem registry (``file://``,
``mem://``) and its streams, the resilience rules, RecordIO, the split
layer (splitters, the native RecordIO engines, the prefetch and shuffle
decorators, the chunk cache), prefetch threads and the ordered worker
pool, the segment container with the block cache, and the snapshot
store."""

from dmlc_tpu_torch.io.block_cache import (BlockCacheReader, BlockCacheWriter,
                                           open_block_cache, source_signature)
from dmlc_tpu_torch.io.cached_split import CachedInputSplit
from dmlc_tpu_torch.io.filesystem import (FileInfo, FileSystem, LocalFileSystem,
                                          MemoryFileSystem, get_filesystem)
from dmlc_tpu_torch.io.input_split import (DEFAULT_CHUNK_BYTES, IndexedRecordIOSplitter,
                                           InputSplit, InputSplitBase, LineSplitter,
                                           MmapLineSplit, RecordIOSplitter, ShuffledInputSplit,
                                           SingleFileSplit, ThreadedInputSplit,
                                           create_input_split, create_mmap_text_split)
from dmlc_tpu_torch.io.recordio import (RECORDIO_MAGIC, RecordIOChunkReader, RecordIOReader,
                                        RecordIOWriter, read_index_file, write_indexed_recordio)
from dmlc_tpu_torch.io.resilience import (ResilientStream, RetryPolicy, classify,
                                          default_policy)
from dmlc_tpu_torch.io.stream import open_stream, read_all, write_all
from dmlc_tpu_torch.io.threaded_iter import ThreadedIter
from dmlc_tpu_torch.io.uri import URI, URISpec

__all__ = ["BlockCacheReader", "BlockCacheWriter", "CachedInputSplit", "DEFAULT_CHUNK_BYTES",
           "FileInfo", "FileSystem", "IndexedRecordIOSplitter", "InputSplit", "InputSplitBase",
           "LineSplitter", "LocalFileSystem", "MemoryFileSystem", "MmapLineSplit",
           "RECORDIO_MAGIC", "RecordIOChunkReader", "RecordIOReader", "RecordIOSplitter",
           "RecordIOWriter", "ResilientStream", "RetryPolicy", "ShuffledInputSplit",
           "SingleFileSplit", "ThreadedInputSplit", "ThreadedIter", "URI", "URISpec",
           "classify", "create_input_split", "create_mmap_text_split", "default_policy",
           "get_filesystem", "open_block_cache", "open_stream", "read_all", "read_index_file",
           "source_signature", "write_all", "write_indexed_recordio"]
