"""Config: JSON files or dicts, dotted overrides, attribute access.

Port of ``anemoi_tpu.utils.config`` without YAML: the port reads configs
as JSON files or Python dicts (compose a packaged preset with the JAX
package's ``load_config`` and ``json.dump`` it to get one).  Overrides
``a.b.c=value`` are parsed by :func:`_parse_value`, which reads the scalar
and flow forms an override uses as YAML 1.1 would (``yaml.safe_load`` in
the JAX package): decimal ints, floats (also ``1e-3``),
``true``/``false``/``null`` in YAML 1.1's spellings, quoted strings,
``[a, b]`` and ``{k: v}``; any other text (dates, hex or sexagesimal
numbers, block collections) stays a string.
"""

from __future__ import annotations

import copy
import json
import re
from typing import Any, Dict, List, Optional, Tuple


class DotDict(dict):
    """Dict with attribute access, recursively wrapping nested dicts."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        for k, v in list(self.items()):
            self[k] = self._wrap(v)

    @classmethod
    def _wrap(cls, v: Any) -> Any:
        if isinstance(v, dict) and not isinstance(v, DotDict):
            return cls(v)
        if isinstance(v, (list, tuple)):
            return type(v)(cls._wrap(x) for x in v)
        return v

    def __getattr__(self, k: str) -> Any:
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k: str, v: Any) -> None:
        self[k] = self._wrap(v)

    def __setitem__(self, k: Any, v: Any) -> None:
        super().__setitem__(k, self._wrap(v))

    def __deepcopy__(self, memo: dict) -> "DotDict":
        return DotDict({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_dict(self) -> Dict[str, Any]:
        def unwrap(v: Any) -> Any:
            if isinstance(v, dict):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [unwrap(x) for x in v]
            return v

        return unwrap(self)


def deep_update(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    """Recursively merge ``override`` into ``base`` (override wins); returns base."""
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            deep_update(base[k], v)
        else:
            base[k] = v
    return base


# YAML 1.1 scalars (the resolver of PyYAML's SafeLoader), the forms an
# override uses: decimal ints, floats, booleans, nulls
_BOOL = {s: True for s in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")}
_BOOL.update({s: False for s in ("no", "No", "NO", "false", "False", "FALSE",
                                 "off", "Off", "OFF")})
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^[-+]?(?:[0-9][0-9_]*)?\.[0-9_]*(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"^[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"^\.(?:nan|NaN|NAN)$")


def _scalar(text: str) -> Any:
    """One plain (unquoted) scalar; text of no other form stays a string."""
    s = text.strip()
    if s in _NULL:
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _INT.match(s):
        return int(s.replace("_", ""))
    if _FLOAT.match(s) and any(c.isdigit() for c in s):
        return float(s.replace("_", ""))
    if _INF.match(s):
        return float("-inf") if s.startswith("-") else float("inf")
    if _NAN.match(s):
        return float("nan")
    return s


class _FlowParser:
    """Recursive-descent reader of one YAML flow node: a flow sequence,
    a flow mapping, a quoted string or a plain scalar."""

    def __init__(self, text: str) -> None:
        self.s = text
        self.i = 0

    def _ws(self) -> None:
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def node(self, stops: str) -> Any:
        self._ws()
        if self.i >= len(self.s):
            return None
        c = self.s[self.i]
        if c == "[":
            return self._seq()
        if c == "{":
            return self._map()
        if c in "'\"":
            return self._quoted(c)
        start = self.i
        while self.i < len(self.s) and self.s[self.i] not in stops:
            if self.s[self.i] == ":" and ":" in stops and (
                self.i + 1 == len(self.s) or self.s[self.i + 1] in " ,]}"
            ):
                break
            self.i += 1
        return _scalar(self.s[start : self.i])

    def _quoted(self, q: str) -> str:
        self.i += 1
        out = []
        while True:
            if self.i >= len(self.s):
                raise ValueError("unterminated quoted string")
            c = self.s[self.i]
            if q == "'" and c == "'":
                if self.s[self.i + 1 : self.i + 2] == "'":
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return "".join(out)
            if q == '"' and c == "\\":
                nxt = self.s[self.i + 1 : self.i + 2]
                out.append({"n": "\n", "t": "\t", '"': '"', "\\": "\\", "/": "/"}.get(nxt, "\\" + nxt))
                self.i += 2
                continue
            if q == '"' and c == '"':
                self.i += 1
                return "".join(out)
            out.append(c)
            self.i += 1

    def _expect(self, c: str) -> None:
        self._ws()
        if self.i >= len(self.s) or self.s[self.i] != c:
            raise ValueError(f"expected {c!r} at {self.i} in {self.s!r}")
        self.i += 1

    def _seq(self) -> list:
        self.i += 1
        out = []
        self._ws()
        if self.s[self.i : self.i + 1] == "]":
            self.i += 1
            return out
        while True:
            out.append(self.node(",]"))
            self._ws()
            if self.s[self.i : self.i + 1] == ",":
                self.i += 1
                self._ws()
                if self.s[self.i : self.i + 1] == "]":
                    self.i += 1
                    return out
                continue
            self._expect("]")
            return out

    def _map(self) -> dict:
        self.i += 1
        out = {}
        self._ws()
        if self.s[self.i : self.i + 1] == "}":
            self.i += 1
            return out
        while True:
            key = self.node(":,}")
            self._ws()
            value = None
            if self.s[self.i : self.i + 1] == ":":
                self.i += 1
                value = self.node(",}")
            out[key] = value
            self._ws()
            if self.s[self.i : self.i + 1] == ",":
                self.i += 1
                self._ws()
                if self.s[self.i : self.i + 1] == "}":
                    self.i += 1
                    return out
                continue
            self._expect("}")
            return out

    def parse(self) -> Tuple[Any, bool]:
        """(value, whether the whole text was one node)."""
        value = self.node("")
        self._ws()
        return value, self.i == len(self.s)


def _parse_value(text: str) -> Any:
    """An override's value as ``yaml.safe_load`` reads the forms above, with
    scientific floats YAML 1.1 misses (``1e-3``) as floats; text that is not
    one such node stays a string."""
    s = text.strip()
    if s[:1] in ("[", "{", "'", '"'):
        try:
            value, whole = _FlowParser(s).parse()
        except (ValueError, IndexError):
            return text
        if not whole:
            return text
    else:
        value = _scalar(s)
    if isinstance(value, str):
        try:
            return float(value)
        except ValueError:
            return value
    return value


def apply_overrides(cfg: Dict[str, Any], overrides: List[str]) -> Dict[str, Any]:
    """Apply ``key.path=value`` dotted overrides (values parsed by
    :func:`_parse_value`)."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"Override must look like a.b.c=value, got: {item}")
        path, _, raw = item.partition("=")
        keys = path.strip().split(".")
        node = cfg
        for k in keys[:-1]:
            node = node.setdefault(k, {})
            if not isinstance(node, dict):
                raise TypeError(f"Cannot override through non-dict at '{k}' in '{path}'")
        node[keys[-1]] = _parse_value(raw)
    return cfg


def load_config(path_or_dict, overrides: Optional[List[str]] = None) -> DotDict:
    """A config from a JSON file or a dict (deep-copied), with overrides.
    A ``defaults:`` list (the JAX package's YAML composition) is refused:
    compose with the JAX package and save the result as JSON."""
    if isinstance(path_or_dict, dict):
        cfg = copy.deepcopy(dict(path_or_dict))
    else:
        with open(path_or_dict) as f:
            cfg = json.load(f)
    if "defaults" in cfg:
        raise ValueError(
            "anemoi_tpu_torch reads composed configs only (JSON or dicts); compose the "
            "'defaults:' list with anemoi_tpu.utils.config.load_config and json.dump it"
        )
    if overrides:
        apply_overrides(cfg, list(overrides))
    return DotDict(cfg)

