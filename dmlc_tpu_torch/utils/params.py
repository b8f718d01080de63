"""Declarative parameter structs — analog of include/dmlc/parameter.h.

Own copy of the JAX package's ``utils/params.py``, trimmed to what the
text parsers' parameter structs use: typed fields with defaults, ranges,
enums and aliases (DMLC_DECLARE_FIELD, parameter.h:265-298, 549-900), and
``init`` from a string dict with the unknown-key policy
(parameter.h:77-84, 140-165). The error texts are the JAX package's.

Usage::

    class CSVParserParam(Parameter):
        format = field(str, default="csv")
        label_column = field(int, default=-1, help="Column index of the label.")

    p = CSVParserParam()
    unknown = p.init({"label_column": "3", "junk": "1"}, allow_unknown=True)
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Type

from dmlc_tpu_torch.utils.check import DMLCError


def _parse_bool(s: str) -> bool:
    t = s.strip().lower()
    if t in ("1", "true", "yes", "on"):
        return True
    if t in ("0", "false", "no", "off"):
        return False
    raise ValueError(f"cannot parse bool from {s!r}")


class Field:
    """One declared parameter — analog of FieldEntry<T> (parameter.h:549+)."""

    def __init__(self, type_: Type, default: Any = ..., *, lower_bound: Any = None,
                 upper_bound: Any = None, enum: Optional[Iterable[Any]] = None,
                 aliases: Iterable[str] = (), help: str = ""):
        self.type = type_
        self.default = default
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound
        self.enum = list(enum) if enum is not None else None
        self.aliases = list(aliases)
        self.help = help
        self.name: str = "<unbound>"

    def parse(self, value: Any) -> Any:
        """String (or typed value) -> the field's type, validated
        (FieldEntry::Set)."""
        if isinstance(value, self.type) and not (self.type is int and isinstance(value, bool)):
            out = value
        elif self.type is bool:
            out = _parse_bool(str(value))
        else:
            try:
                out = self.type(value)
            except (TypeError, ValueError) as exc:
                raise DMLCError(
                    f"parameter {self.name}: cannot parse {value!r} as {self.type.__name__}"
                ) from exc
        self.validate(out)
        return out

    def validate(self, value: Any) -> None:
        """Range and enum constraints (set_range / add_enum)."""
        if self.lower_bound is not None and value < self.lower_bound:
            raise DMLCError(
                f"parameter {self.name}: value {value!r} below lower bound {self.lower_bound!r}")
        if self.upper_bound is not None and value > self.upper_bound:
            raise DMLCError(
                f"parameter {self.name}: value {value!r} above upper bound {self.upper_bound!r}")
        if self.enum is not None and value not in self.enum:
            raise DMLCError(
                f"parameter {self.name}: value {value!r} not in allowed set {self.enum!r}")


def field(type_: Type, default: Any = ..., **kwargs) -> Field:
    """Declare a parameter field — analog of DMLC_DECLARE_FIELD (parameter.h:265)."""
    return Field(type_, default, **kwargs)


class Parameter:
    """Base class for declarative parameter structs (parameter.h:104-298)."""

    __fields__: Dict[str, Field]
    __alias_map__: Dict[str, str]

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        fields: Dict[str, Field] = {}
        for base in reversed(cls.__mro__[1:]):
            if isinstance(base, type) and issubclass(base, Parameter) and base is not Parameter:
                fields.update(getattr(base, "__fields__", {}))
        for name, value in list(cls.__dict__.items()):
            if isinstance(value, Field):
                value.name = name
                fields[name] = value
                delattr(cls, name)
        cls.__fields__ = fields
        alias_map: Dict[str, str] = {}
        for name, f in fields.items():
            for alias in f.aliases:
                if alias in fields or alias in alias_map:
                    raise DMLCError(f"parameter alias {alias!r} collides")
                alias_map[alias] = name
        cls.__alias_map__ = alias_map

    def __init__(self, **kwargs):
        for name, f in self.__fields__.items():
            if f.default is not ...:
                object.__setattr__(self, name, f.default)
        self.init(kwargs)

    def init(self, kwargs: Dict[str, Any], *, allow_unknown: bool = False) -> Dict[str, Any]:
        """Set fields from a string/any dict; returns the unknown leftovers.
        ``allow_unknown=False`` raises on an unknown key (kAllowUnknown);
        a field without a default that stays unset raises too."""
        unknown: Dict[str, Any] = {}
        for key, value in kwargs.items():
            name = self.__alias_map__.get(key, key)
            f = self.__fields__.get(name)
            if f is None:
                if not allow_unknown:
                    raise DMLCError(
                        f"{type(self).__name__}: unknown parameter {key!r}; "
                        f"known: {sorted(self.__fields__)}")
                unknown[key] = value
                continue
            object.__setattr__(self, name, f.parse(value))
        for name in self.__fields__:
            if not hasattr(self, name):
                raise DMLCError(f"{type(self).__name__}: required parameter {name!r} not set")
        return unknown

    def to_dict(self) -> Dict[str, Any]:
        return {name: getattr(self, name) for name in self.__fields__}

    def __repr__(self) -> str:  # pragma: no cover
        items = ", ".join(f"{k}={v!r}" for k, v in self.to_dict().items())
        return f"{type(self).__name__}({items})"
