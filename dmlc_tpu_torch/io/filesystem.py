"""Local filesystem — analog of src/io/local_filesys.cc.

Own copy of the local part of the JAX package's ``io/filesystem.py``; the
port reads local files only (no protocol registry, no cloud members).
"""

from __future__ import annotations

import os
from typing import BinaryIO, List

from dmlc_tpu_torch.io.uri import URI
from dmlc_tpu_torch.utils.check import DMLCError

FILE_TYPE = "file"
DIR_TYPE = "directory"


class FileInfo:
    """path + size + type — analog of dmlc::io::FileInfo (io.h:560-570)."""

    def __init__(self, path: URI, size: int, type_: str):
        self.path = path
        self.size = size
        self.type = type_


class LocalFileSystem:
    """POSIX filesystem."""

    def get_path_info(self, path: URI) -> FileInfo:
        name = path.name
        try:
            st = os.stat(name)
        except OSError as exc:
            raise DMLCError(f"LocalFileSystem.get_path_info: {name!r}: {exc}") from exc
        type_ = DIR_TYPE if os.path.isdir(name) else FILE_TYPE
        return FileInfo(URI(name), st.st_size, type_)

    def list_directory(self, path: URI) -> List[FileInfo]:
        name = path.name
        try:
            entries = sorted(os.listdir(name))
        except OSError as exc:
            raise DMLCError(f"LocalFileSystem.list_directory: {name!r}: {exc}") from exc
        out = []
        for entry in entries:
            try:
                out.append(self.get_path_info(URI(os.path.join(name, entry))))
            except DMLCError:
                # tolerate dangling symlinks like local_filesys.cc:99-145
                continue
        return out

    def list_directory_recursive(self, path: URI) -> List[FileInfo]:
        """BFS recursive listing — analog of filesys.cc:8-25."""
        out: List[FileInfo] = []
        queue = [path]
        while queue:
            for info in self.list_directory(queue.pop(0)):
                if info.type == DIR_TYPE:
                    queue.append(info.path)
                else:
                    out.append(info)
        return out

    def open_for_read(self, path: URI) -> BinaryIO:
        try:
            return open(path.name, "rb")
        except OSError as exc:
            raise DMLCError(f"LocalFileSystem.open: {path.name!r}: {exc}") from exc


def get_filesystem(uri: URI | str) -> LocalFileSystem:
    """The filesystem for ``uri``; only local paths are served here."""
    if isinstance(uri, str):
        uri = URI(uri)
    if uri.protocol != "file://":
        raise DMLCError(
            f"unknown filesystem protocol {uri.protocol!r}: dmlc_tpu_torch "
            "reads local files only")
    return LocalFileSystem()
