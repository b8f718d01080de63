"""URI parsing + the dmlc URI sugar ``path?k=v#blockcache=p`` (uri_spec.h:42-75).

Own copy of the JAX package's ``io/uri.py``, trimmed to local paths with
``?key=value`` arguments and the ``#blockcache=<path>`` fragment, which
names the parse-once block cache (``URISpec.block_cache``; the resolver in
:func:`dmlc_tpu_torch.data.parsers.create_parser` qualifies it per part).
The chunk cache-file, snapshot and service fragments are not part of this
port yet and are rejected.
"""

from __future__ import annotations

from typing import Dict

from dmlc_tpu_torch.utils.check import DMLCError


class URI:
    """``protocol://host/path`` split — analog of dmlc::io::URI (io.h:539)."""

    def __init__(self, uri: str):
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


class URISpec:
    """URI sugar: ``real_uri?k=v&k2=v2#blockcache=path`` (uri_spec.h:42-75)."""

    def __init__(self, uri: str):
        name_cache = uri.split("#")
        self.block_cache: str | None = None
        if len(name_cache) > 2:
            raise DMLCError("only one `#` is allowed in file path for cachefile specification")
        if len(name_cache) == 2:
            cache = name_cache[1]
            if not cache.startswith("blockcache="):
                raise DMLCError(
                    f"{uri!r}: '#' fragments other than '#blockcache=' (cache "
                    "files, snapshot, service) are not supported by dmlc_tpu_torch yet")
            self.block_cache = cache[len("blockcache="):]
            if not self.block_cache:
                raise DMLCError("empty path in `#blockcache=` URI suffix")
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
