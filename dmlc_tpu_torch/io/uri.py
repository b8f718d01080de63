"""URI parsing + the dmlc URI sugar ``path?k=v#cachefile`` (uri_spec.h:42-75).

Own copy of the JAX package's ``io/uri.py``: ``protocol://host/path``
(``file://`` when there is no protocol) with ``?key=value`` arguments and
three fragments: ``#<cachefile>`` names the
split layer's chunk cache (``URISpec.cache_file``, with the
``.split<N>.part<K>`` suffix for one of several parts, uri_spec.h:47-53;
:mod:`dmlc_tpu_torch.io.cached_split`), ``#blockcache=<path>`` the
parse-once block cache and ``#snapshot=<path>`` the snapshot store (both
qualified per part by :func:`dmlc_tpu_torch.data.parsers.create_parser`).
The JAX package's ``#service=`` fragment names its data service, which is
not ported, and is rejected.
"""

from __future__ import annotations

from typing import Dict

from dmlc_tpu_torch.utils.check import DMLCError


class URI:
    """``protocol://host/path`` split — analog of dmlc::io::URI (io.h:539)."""

    def __init__(self, uri: str):
        self.raw = uri
        pos = uri.find("://")
        if pos < 0:
            self.protocol = "file://"
            self.host = ""
            self.name = uri
        else:
            self.protocol = uri[: pos + 3]
            rest = uri[pos + 3:]
            slash = rest.find("/")
            if slash < 0:
                self.host, self.name = rest, ""
            else:
                self.host, self.name = rest[:slash], rest[slash:]

    def str_nohost(self) -> str:
        """protocol + name, host dropped (io.h: used for FS-relative paths)."""
        return self.protocol + self.name if self.protocol != "file://" else self.name

    def __str__(self) -> str:
        if self.protocol == "file://" and not self.host:
            return self.name
        return f"{self.protocol}{self.host}{self.name}"

    def __repr__(self) -> str:  # pragma: no cover
        return f"URI({str(self)!r})"


class URISpec:
    """URI sugar: ``real_uri?k=v&k2=v2#cache_file`` (uri_spec.h:42-75).
    Exactly one of ``cache_file``, ``block_cache`` and ``snapshot`` is set
    by a fragment (module docstring)."""

    def __init__(self, uri: str, part_index: int = 0, num_parts: int = 1):
        name_cache = uri.split("#")
        self.cache_file: str | None = None
        self.block_cache: str | None = None
        self.snapshot: str | None = None
        if len(name_cache) > 2:
            raise DMLCError("only one `#` is allowed in file path for cachefile specification")
        if len(name_cache) == 2:
            cache = name_cache[1]
            if cache.startswith("blockcache="):
                self.block_cache = cache[len("blockcache="):]
                if not self.block_cache:
                    raise DMLCError("empty path in `#blockcache=` URI suffix")
            elif cache.startswith("snapshot="):
                self.snapshot = cache[len("snapshot="):]
                if not self.snapshot:
                    raise DMLCError("empty path in `#snapshot=` URI suffix")
            elif cache.startswith("service="):
                raise DMLCError(
                    f"{uri!r}: the '#service=' fragment names the JAX package's "
                    "data service, which dmlc_tpu_torch does not support")
            else:
                if num_parts != 1:
                    cache = f"{cache}.split{num_parts}.part{part_index}"
                self.cache_file = cache
        name_args = name_cache[0].split("?")
        self.args: Dict[str, str] = {}
        if len(name_args) == 2:
            for i, kv in enumerate(name_args[1].split("&")):
                if "=" not in kv:
                    raise DMLCError(f"Invalid uri argument format for arg {i + 1}: {kv!r}")
                key, value = kv.split("=", 1)
                self.args[key] = value
        elif len(name_args) != 1:
            raise DMLCError("only one `?` is allowed in file path for argument specification")
        self.uri = name_args[0]
