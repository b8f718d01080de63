"""FileSystem abstraction with a protocol registry.

Own copy of the JAX package's ``io/filesystem.py``: the equivalent of
reference io.h:582-631 (the FileSystem interface), src/io.cc:30-71 (the
protocol dispatch), src/io/local_filesys.cc (the local member) and
src/io/filesys.cc:8-25 (the recursive listing). :class:`MemoryFileSystem`
serves ``mem://`` from a process-wide dict, for hermetic corpora.

:func:`get_filesystem` dispatches on the URI's protocol through a locked
factory map; :func:`register_filesystem` adds or replaces a member. This
module registers ``file://`` and ``mem://``; the cloud members register
themselves when :mod:`dmlc_tpu_torch.io` imports them, as in the JAX
package: ``http://`` and ``https://`` (:mod:`~dmlc_tpu_torch.io.http_filesys`),
``s3://`` (:mod:`~dmlc_tpu_torch.io.s3_filesys`), ``gs://``
(:mod:`~dmlc_tpu_torch.io.gcs_filesys`), ``hdfs://`` and ``viewfs://``
(:mod:`~dmlc_tpu_torch.io.hdfs_filesys`) and ``azure://``
(:mod:`~dmlc_tpu_torch.io.azure_filesys`). An unregistered protocol raises
with the known list, in the JAX package's words.
"""

from __future__ import annotations

import io as _pyio
import os
import threading
from typing import BinaryIO, Callable, Dict, List

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

    def __repr__(self) -> str:  # pragma: no cover
        return f"FileInfo({self.path}, size={self.size}, type={self.type})"


class FileSystem:
    """Abstract filesystem — analog of dmlc::io::FileSystem (io.h:582)."""

    # True for filesystems whose read streams already retry and resume at
    # the current byte offset themselves: open_stream(resilient=True) then
    # adds no ResilientStream (a second budget would multiply the retries)
    native_resilience = False

    def get_path_info(self, path: URI) -> FileInfo:
        raise NotImplementedError

    def list_directory(self, path: URI) -> List[FileInfo]:
        raise NotImplementedError

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

    def open(self, path: URI, mode: str) -> BinaryIO:
        """A binary stream; ``mode`` in ``r``, ``w``, ``a`` (io.h:57)."""
        raise NotImplementedError

    def open_for_read(self, path: URI) -> BinaryIO:
        return self.open(path, "r")

    def exists(self, path: URI) -> bool:
        try:
            self.get_path_info(path)
            return True
        except (DMLCError, OSError):
            return False


_FS_FACTORIES: Dict[str, Callable[[URI], FileSystem]] = {}
_FS_LOCK = threading.Lock()


def register_filesystem(protocol: str, factory: Callable[[URI], FileSystem]) -> None:
    """Serve ``protocol`` (``"mem://"``) with ``factory(uri)``."""
    with _FS_LOCK:
        _FS_FACTORIES[protocol] = factory


def get_filesystem(uri: URI | str) -> FileSystem:
    """Protocol dispatch — analog of FileSystem::GetInstance (src/io.cc:30-71)."""
    if isinstance(uri, str):
        uri = URI(uri)
    with _FS_LOCK:
        factory = _FS_FACTORIES.get(uri.protocol)
    if factory is None:
        raise DMLCError(
            f"unknown filesystem protocol {uri.protocol!r}; "
            f"known: {sorted(_FS_FACTORIES)}"
        )
    return factory(uri)


class LocalFileSystem(FileSystem):
    """POSIX filesystem — analog of src/io/local_filesys.cc."""

    _instance: "LocalFileSystem | None" = None

    @classmethod
    def instance(cls, uri: URI | None = None) -> "LocalFileSystem":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

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

    def open(self, path: URI, mode: str) -> BinaryIO:
        name = path.name
        if name == "stdin" and mode == "r":
            return _pyio.BufferedReader(_pyio.FileIO(0, "rb", closefd=False))
        if name == "stdout" and mode in ("w", "a"):
            return _pyio.BufferedWriter(_pyio.FileIO(1, "wb", closefd=False))
        pymode = {"r": "rb", "w": "wb", "a": "ab"}.get(mode)
        if pymode is None:
            raise DMLCError(f"LocalFileSystem.open: bad mode {mode!r}")
        try:
            return open(name, pymode)
        except OSError as exc:
            raise DMLCError(f"LocalFileSystem.open: {name!r}: {exc}") from exc


class _MemFile(_pyio.BytesIO):
    """A BytesIO that stores its bytes under its key on close."""

    def __init__(self, store: Dict[str, bytes], key: str, data: bytes = b""):
        super().__init__(data)
        self._store = store
        self._key = key

    def close(self) -> None:
        if self.closed:
            return
        self._store[self._key] = self.getvalue()
        super().close()


class MemoryFileSystem(FileSystem):
    """``mem://`` files in one process-wide dict, keyed by host + path
    (``mem://bucket/a.txt`` is ``"bucket/a.txt"``); a directory is any
    prefix ending at a ``/``. Not in the reference, which tests against
    temporary directories (filesystem.h:54)."""

    _instance: "MemoryFileSystem | None" = None

    def __init__(self):
        self.store: Dict[str, bytes] = {}

    @classmethod
    def instance(cls, uri: URI | None = None) -> "MemoryFileSystem":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    @classmethod
    def reset(cls) -> None:
        """Forget every ``mem://`` file (the next access starts empty)."""
        cls._instance = None

    def _key(self, path: URI) -> str:
        return path.host + path.name

    def get_path_info(self, path: URI) -> FileInfo:
        key = self._key(path)
        if key in self.store:
            return FileInfo(URI("mem://" + key), len(self.store[key]), FILE_TYPE)
        prefix = key.rstrip("/") + "/"
        if any(k.startswith(prefix) for k in self.store):
            return FileInfo(URI("mem://" + key), 0, DIR_TYPE)
        raise DMLCError(f"MemoryFileSystem: no such path {key!r}")

    def list_directory(self, path: URI) -> List[FileInfo]:
        prefix = self._key(path).rstrip("/") + "/"
        seen: Dict[str, FileInfo] = {}
        for key, data in sorted(self.store.items()):
            if not key.startswith(prefix):
                continue
            rest = key[len(prefix):]
            if "/" in rest:
                sub = rest.split("/", 1)[0]
                seen.setdefault(sub, FileInfo(URI("mem://" + prefix + sub), 0, DIR_TYPE))
            else:
                seen[rest] = FileInfo(URI("mem://" + key), len(data), FILE_TYPE)
        if not seen:
            raise DMLCError(f"MemoryFileSystem: no such directory {path.raw!r}")
        return list(seen.values())

    def open(self, path: URI, mode: str) -> BinaryIO:
        key = self._key(path)
        if mode == "r":
            if key not in self.store:
                raise DMLCError(f"MemoryFileSystem: no such file {key!r}")
            return _pyio.BytesIO(self.store[key])
        if mode == "w":
            return _MemFile(self.store, key)
        if mode == "a":
            f = _MemFile(self.store, key, self.store.get(key, b""))
            f.seek(0, 2)
            return f
        raise DMLCError(f"MemoryFileSystem.open: bad mode {mode!r}")


register_filesystem("file://", LocalFileSystem.instance)
register_filesystem("mem://", MemoryFileSystem.instance)
