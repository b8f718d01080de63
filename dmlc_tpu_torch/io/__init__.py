"""Host I/O of the port: URIs, local files, line splits, prefetch threads,
the segment container and the snapshot store."""

from dmlc_tpu_torch.io.input_split import DEFAULT_CHUNK_BYTES, LineSplitter
from dmlc_tpu_torch.io.threaded_iter import ThreadedIter
from dmlc_tpu_torch.io.uri import URI, URISpec

__all__ = ["DEFAULT_CHUNK_BYTES", "LineSplitter", "ThreadedIter", "URI", "URISpec"]
