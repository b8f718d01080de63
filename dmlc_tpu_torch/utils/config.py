"""``key = value`` configuration text — analog of include/dmlc/config.h.

Own copy of the JAX package's ``utils/config.py``: the tokenizer of
src/config.cc:30-80 (bare words, quoted strings with escaped quotes, ``#``
comments), single- and multi-value modes (a repeated key keeps its last
value, or every value, config.h:63-70), and the proto-text rendering
(``ToProtoString``, config.h:102). The error texts are the JAX package's.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

from dmlc_tpu_torch.utils.check import DMLCError


def _tokenize(text: str) -> Iterator[str]:
    """Bare words, ``=``, and quoted strings (yielded with a leading ``"``
    as their mark); ``#`` starts a comment outside a string."""
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if ch == "#":
            while i < n and text[i] != "\n":
                i += 1
        elif ch == '"':
            j = i + 1
            out = []
            while j < n:
                if text[j] == "\\" and j + 1 < n and text[j + 1] == '"':
                    out.append('"')
                    j += 2
                elif text[j] == '"':
                    break
                else:
                    out.append(text[j])
                    j += 1
            if j >= n:
                raise DMLCError("config: unterminated quoted string")
            yield '"' + "".join(out)
            i = j + 1
        elif ch == "=":
            yield "="
            i += 1
        elif ch.isspace():
            i += 1
        else:
            j = i
            while j < n and not text[j].isspace() and text[j] not in "=#":
                j += 1
            yield text[i:j]
            i = j


def _is_number(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


class Config:
    """An ordered ``key = value`` configuration — analog of dmlc::Config
    (config.h:40-175)."""

    def __init__(self, text: str = "", multi_value: bool = False):
        self.multi_value = multi_value
        self._order: List[Tuple[str, str]] = []
        self._map: Dict[str, List[str]] = {}
        if text:
            self.load(text)

    def load(self, text: str) -> None:
        tokens = list(_tokenize(text))
        if len(tokens) % 3 != 0:
            raise DMLCError(f"config: dangling tokens {tokens[-(len(tokens) % 3):]!r}")
        for i in range(0, len(tokens), 3):
            key, eq, value = tokens[i], tokens[i + 1], tokens[i + 2]
            if eq != "=" or key == "=" or value == "=":
                raise DMLCError(f"config: expected 'key = value' near {tokens[i:i+3]!r}")
            self.set(key[1:] if key.startswith('"') else key,
                     value[1:] if value.startswith('"') else value)

    def set(self, key: str, value: str) -> None:
        if not self.multi_value and key in self._map:
            # single-value mode: the last assignment wins (SetParam, config.h:63)
            self._map[key] = [value]
            self._order = [(k, v) for (k, v) in self._order if k != key]
        else:
            self._map.setdefault(key, []).append(value)
        self._order.append((key, value))

    def get(self, key: str) -> str:
        """The key's last value (GetParam, config.h:56)."""
        if key not in self._map:
            raise DMLCError(f"config: key {key!r} not found")
        return self._map[key][-1]

    def get_all(self, key: str) -> List[str]:
        return list(self._map.get(key, []))

    def __contains__(self, key: str) -> bool:
        return key in self._map

    def items(self) -> List[Tuple[str, str]]:
        """The ``(key, value)`` pairs in insertion order."""
        return list(self._order)

    def to_proto_string(self) -> str:
        """Proto text: numbers bare, other values quoted (config.h:102)."""
        out = [f"{key} : {value}" if _is_number(value) else f'{key} : "{value}"'
               for key, value in self._order]
        return "\n".join(out) + ("\n" if out else "")
