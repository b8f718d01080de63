"""Global factory registry — analog of include/dmlc/registry.h.

Own copy of the JAX package's ``utils/registry.py``: named process-wide
registries of factory entries with ``register`` / ``find`` / ``add_alias``
/ ``list_names`` (Registry<E>::__REGISTER__ / Find / AddAlias / ListAllNames,
registry.h:48-126), one per kind under a lock (``Registry.get``,
registry.h:78-89). A decorator stands in for the static-init macro
(DMLC_REGISTRY_REGISTER, registry.h:229-235). The error texts are the JAX
package's.

``create_parser`` dispatches its formats through ``Registry.get("parser")``
(:data:`dmlc_tpu_torch.data.parsers.PARSER_REGISTRY`), so a format
registered there reaches it.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Generic, Iterable, Optional, TypeVar

from dmlc_tpu_torch.utils.check import DMLCError

T = TypeVar("T")

_REGISTRIES: Dict[str, "Registry"] = {}
_REGISTRIES_LOCK = threading.Lock()


class RegistryEntry(Generic[T]):
    """A factory entry — analog of FunctionRegEntryBase (registry.h:150-226)."""

    def __init__(self, name: str, body: T, description: str = ""):
        self.name = name
        self.body = body
        self.description = description
        self.arguments: list[tuple[str, str, str]] = []  # (name, type, description)

    def describe(self, description: str) -> "RegistryEntry[T]":
        self.description = description
        return self

    def add_argument(self, name: str, type_str: str, description: str) -> "RegistryEntry[T]":
        self.arguments.append((name, type_str, description))
        return self

    def __repr__(self) -> str:  # pragma: no cover
        return f"RegistryEntry({self.name!r})"


class Registry(Generic[T]):
    """A named registry of factories — analog of Registry<EntryType>
    (registry.h:26-126)."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, RegistryEntry[T]] = {}
        self._lock = threading.Lock()

    @staticmethod
    def get(kind: str) -> "Registry":
        """The one registry of ``kind`` in this process (Registry::Get)."""
        with _REGISTRIES_LOCK:
            reg = _REGISTRIES.get(kind)
            if reg is None:
                reg = _REGISTRIES[kind] = Registry(kind)
            return reg

    def register(self, name: str, description: str = "",
                 override: bool = False) -> Callable[[T], T]:
        """A decorator registering its ``body`` under ``name``; a second
        registration of a name raises unless ``override``."""
        def deco(body: T) -> T:
            with self._lock:
                if name in self._entries and not override:
                    raise DMLCError(f"{self.kind}: entry {name!r} already registered")
                self._entries[name] = RegistryEntry(name, body, description)
            return body

        return deco

    def add_alias(self, name: str, alias: str) -> None:
        """Serve ``name``'s entry under ``alias`` too (AddAlias, registry.h:63-72)."""
        with self._lock:
            if name not in self._entries:
                raise DMLCError(f"{self.kind}: cannot alias unknown entry {name!r}")
            if alias in self._entries:
                raise DMLCError(f"{self.kind}: alias {alias!r} already registered")
            self._entries[alias] = self._entries[name]

    def find(self, name: str) -> Optional[RegistryEntry[T]]:
        """The entry, or None (Find, registry.h:55-61)."""
        with self._lock:
            return self._entries.get(name)

    def lookup(self, name: str) -> RegistryEntry[T]:
        """The entry; a missing name raises with the known names."""
        entry = self.find(name)
        if entry is None:
            raise DMLCError(f"{self.kind}: unknown entry {name!r}; known: {sorted(self._entries)}")
        return entry

    def create(self, name: str, *args, **kwargs):
        """Call ``name``'s factory."""
        return self.lookup(name).body(*args, **kwargs)

    def list_names(self) -> Iterable[str]:
        with self._lock:
            return sorted(self._entries)
