"""Config: YAML or JSON files with ``defaults:`` composition, dotted
overrides, attribute access.

Port of ``anemoi_tpu.utils.config`` without PyYAML.  :func:`read_yaml`
reads the subset of YAML the packaged presets use (``config/``, byte-equal
copies of the JAX package's): block mappings and sequences, flow ``[...]``
and ``{...}`` collections (also over several lines), comments, single- and
double-quoted strings, and ``&anchor``/``*alias``.  Plain scalars resolve
as YAML 1.1 resolves them (PyYAML's ``safe_load``): decimal ints, floats,
``true``/``false``/``null`` in YAML 1.1's spellings, anything else a
string.  What lies outside the subset -- block scalars (``|``, ``>``),
tags, several documents, complex keys, multi-line plain scalars, and plain
scalars that YAML 1.1 reads as dates or as binary, octal, hex or
sexagesimal numbers -- raises :class:`YAMLSubsetError` with the file and
line.  :func:`dump_yaml` writes data that :func:`read_yaml` reads back
equal.

Overrides ``a.b.c=value`` are parsed by :func:`_parse_value`, which reads
the scalar and flow forms an override uses as ``yaml.safe_load`` would in
the JAX package, and scientific floats YAML 1.1 misses (``1e-3``) as
floats; any other text (dates, hex or sexagesimal numbers, block
collections) stays a string.
"""

from __future__ import annotations

import copy
import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

PACKAGED_CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                   "config")


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
_FLOAT = re.compile(r"^(?:[-+]?[0-9][0-9_]*\.[0-9_]*|\.[0-9_]+)(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"^[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"^\.(?:nan|NaN|NAN)$")
# plain scalars that YAML 1.1 reads as something _scalar does not: binary,
# octal, hex and sexagesimal numbers, dates and times, the value and merge keys
_UNREAD = re.compile(
    r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
    r"|[0-9]{4}-[0-9]{2}-[0-9]{2}"
    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt]|[ \t]+)[0-9]{1,2}:[0-9]{2}:[0-9]{2}(?:\.[0-9]*)?"
    r"(?:[ \t]*(?:Z|[-+][0-9]{1,2}(?::[0-9]{2})?))?|=|<<)$"
)


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


# double-quoted escapes of YAML (PyYAML's scanner), besides \x, \u, \U
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


class _FlowParser:
    """Recursive-descent reader of one YAML flow node: a flow sequence,
    a flow mapping, a quoted string or a plain scalar.

    ``anchors`` (a file's ``&name`` -> node table) makes it read anchors and
    aliases and be strict: an escape or a plain scalar outside the subset
    raises ``ValueError``.  Without it (an override's value) ``&`` and ``*``
    raise, and unknown escapes are kept as they are written."""

    def __init__(self, text: str, anchors: Optional[Dict[str, Any]] = None) -> None:
        self.s = text
        self.i = 0
        self.anchors = anchors

    def _ws(self) -> None:
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def _name(self) -> str:
        start = self.i
        while self.i < len(self.s) and self.s[self.i] not in " \t,[]{}":
            self.i += 1
        if self.anchors is None or self.i == start:
            raise ValueError(f"anchor or alias at {start} in {self.s!r}")
        return self.s[start : self.i]

    def node(self, stops: str) -> Any:
        self._ws()
        if self.i >= len(self.s):
            return None
        c = self.s[self.i]
        if c == "*":
            self.i += 1
            name = self._name()
            if name not in self.anchors:
                raise ValueError(f"undefined alias *{name}")
            return self.anchors[name]
        if c == "&":
            self.i += 1
            name = self._name()
            value = self.anchors[name] = self.node(stops)
            return value
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
        return self._plain(self.s[start : self.i])

    def _plain(self, text: str) -> Any:
        if self.anchors is not None and _UNREAD.match(text.strip()):
            raise ValueError(f"plain scalar {text.strip()!r}: YAML 1.1 reads it as a date, "
                             "a non-decimal number or a special key, which is not supported")
        return _scalar(text)

    def _escape(self) -> str:
        """The escape after a backslash at ``self.i``."""
        nxt = self.s[self.i + 1 : self.i + 2]
        if nxt in _ESCAPES:
            self.i += 2
            return _ESCAPES[nxt]
        width = _HEX_ESCAPES.get(nxt)
        digits = self.s[self.i + 2 : self.i + 2 + (width or 0)]
        if width and re.fullmatch(r"[0-9a-fA-F]+", digits) and len(digits) == width:
            self.i += 2 + width
            return chr(int(digits, 16))
        if self.anchors is not None:
            raise ValueError(f"escape \\{nxt} is not supported")
        self.i += 2
        return "\\" + nxt

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
                out.append(self._escape())
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


class YAMLSubsetError(ValueError):
    """YAML outside the subset :func:`read_yaml` reads, or malformed YAML;
    the message starts with ``file:line``."""


def _strip_comment(line: str) -> str:
    """``line`` without its comment: a ``#`` at the start or after a blank,
    outside quoted strings (a quote opens one only where a scalar starts)."""
    quote = None
    i = 0
    while i < len(line):
        c = line[i]
        if quote == '"' and c == "\\":
            i += 2
            continue
        if quote is not None:
            if c == quote:
                if quote == "'" and line[i + 1 : i + 2] == "'":
                    i += 2
                    continue
                quote = None
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
        elif c in "'\"" and (i == 0 or line[i - 1] in " \t[{,"):
            quote = c
        i += 1
    return line


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


class _BlockReader:
    """Indentation-driven reader of the block structure; each line is
    ``[line number, indent, text]`` with comments and blank lines gone.  A
    sequence item's content is read as a line of its own at its column."""

    def __init__(self, text: str, path: str) -> None:
        self.path = path
        self.anchors: Dict[str, Any] = {}
        self.lines: List[list] = []
        for n, raw in enumerate(text.splitlines(), 1):
            body = _strip_comment(raw).rstrip()
            stripped = body.lstrip(" ")
            if not stripped:
                continue
            if stripped[0] == "\t":
                self.error(n, "tab in indentation")
            if body.startswith(("---", "...", "%")):
                self.error(n, "directives and document markers are not supported")
            self.lines.append([n, len(body) - len(stripped), stripped])
        self.i = 0

    def error(self, n: int, msg: str):
        raise YAMLSubsetError(f"{self.path}:{n}: {msg}")

    def _next_indent(self) -> int:
        return self.lines[self.i][1] if self.i < len(self.lines) else -1

    def document(self) -> Any:
        if not self.lines:
            return None
        node = self.block(self.lines[0][1])
        if self.i < len(self.lines):
            self.error(self.lines[self.i][0], "content after the end of the document "
                                              "(bad indentation?)")
        return node

    def block(self, indent: int) -> Any:
        n, _, text = self.lines[self.i]
        if _is_item(text):
            return self.sequence(indent)
        if self.split_key(text, n) is not None:
            return self.mapping(indent)
        self.i += 1
        return self.value(text, n, indent)

    def sequence(self, indent: int) -> list:
        out = []
        while self.i < len(self.lines) and self.lines[self.i][1] == indent \
                and _is_item(self.lines[self.i][2]):
            n, _, text = self.lines[self.i]
            rest = text[1:].lstrip(" ")
            if rest and (_is_item(rest) or self.split_key(rest, n) is not None):
                # a collection that starts on the item's line: read from its
                # column as a line of its own
                self.lines[self.i] = [n, indent + len(text) - len(rest), rest]
                out.append(self.block(self.lines[self.i][1]))
            else:
                self.i += 1
                out.append(self.value(rest, n, indent))
        if self._next_indent() > indent:
            self.error(self.lines[self.i][0], "unexpected indentation")
        return out

    def mapping(self, indent: int) -> dict:
        out = {}
        while self.i < len(self.lines) and self.lines[self.i][1] == indent:
            n, _, text = self.lines[self.i]
            split = self.split_key(text, n)
            if split is None:
                self.error(n, f"expected 'key: value', got {text!r}")
            key, rest = split
            self.i += 1
            # a sequence may sit at its key's indent
            out[key] = self.value(rest, n, indent, items_at_indent=True)
        if self._next_indent() > indent:
            self.error(self.lines[self.i][0], "unexpected indentation")
        return out

    def split_key(self, text: str, n: int) -> Optional[Tuple[Any, str]]:
        """``(key, rest)`` of a ``key: rest`` line, or None for a line that
        holds no key."""
        if text[0] in "[{*&!|>":
            if text[0] == "&" and re.match(r"&\S+\s+\S.*:(\s|$)", text):
                self.error(n, "an anchor on a mapping that starts on its line is not supported")
            return None
        if text.startswith("? "):
            self.error(n, "complex keys are not supported")
        if text[0] in "'\"":
            parser = _FlowParser(text, self.anchors)
            try:
                key = parser._quoted(text[0])
            except ValueError as e:
                self.error(n, str(e))
            parser._ws()
            if text[parser.i : parser.i + 1] != ":":
                return None
            rest = text[parser.i + 1 :]
            if rest and rest[0] not in " \t":
                return None
            return key, rest.strip()
        m = re.search(r":(\s|$)", text)
        if m is None:
            return None
        key_text = text[: m.start()]
        try:
            key = _FlowParser(key_text, self.anchors)._plain(key_text)
        except ValueError as e:
            self.error(n, str(e))
        return key, text[m.end() :].strip()

    def value(self, rest: str, n: int, indent: int, items_at_indent: bool = False) -> Any:
        """The node that follows a key or a ``- ``: ``rest`` on the line, or
        the block below it."""
        anchor = None
        if rest.startswith("&"):
            anchor, _, rest = rest[1:].partition(" ")
            rest = rest.strip()
            if not anchor:
                self.error(n, "anchor without a name")
        if rest:
            node = self.inline(rest, n)
            if self._next_indent() > indent:
                self.error(self.lines[self.i][0], "unexpected indentation (multi-line "
                                                  "plain scalars are not supported)")
        elif self._next_indent() > indent or (
                items_at_indent and self._next_indent() == indent
                and _is_item(self.lines[self.i][2])):
            node = self.block(self._next_indent())
        else:
            node = None
        if anchor is not None:
            self.anchors[anchor] = node
        return node

    def inline(self, text: str, n: int) -> Any:
        """A node written on its line: an alias, a flow collection (its
        continuation lines joined), a quoted string or a plain scalar."""
        if text[0] in "|>":
            self.error(n, "block scalars (| and >) are not supported")
        if text[0] in "!%@`" or text == "?" or text.startswith("? "):
            self.error(n, f"{text[0]!r} (tags, directives, reserved or complex keys) is not "
                          "supported")
        if _is_item(text) or (text[0] not in "[{'\"" and re.search(r":(\s|$)", text)):
            self.error(n, f"{text!r}: a sequence or mapping cannot start inside a value")
        if text[0] in "[{":
            while not self._flow_closed(text) and self.i < len(self.lines):
                text += " " + self.lines[self.i][2]
                self.i += 1
        try:
            value, whole = _FlowParser(text, self.anchors).parse()
        except (ValueError, IndexError) as e:
            self.error(n, f"{e} in {text!r}")
        if not whole:
            self.error(n, f"cannot read {text!r} as one node (a 'key: value' inside a "
                          "value, or text after a closing quote or bracket)")
        return value

    @staticmethod
    def _flow_closed(text: str) -> bool:
        depth, quote, i = 0, None, 0
        while i < len(text):
            c = text[i]
            if quote == '"' and c == "\\":
                i += 2
                continue
            if quote is not None:
                if c == quote:
                    quote = None
            elif c in "'\"" and (i == 0 or text[i - 1] in " \t[{,:"):
                quote = c
            elif c in "[{":
                depth += 1
            elif c in "]}":
                depth -= 1
            i += 1
        return depth <= 0


def read_yaml(text: str, path: str = "<string>") -> Any:
    """The YAML document ``text`` (from ``path``, named in errors) as
    ``yaml.safe_load`` reads it, for the subset in the module's docstring;
    anything else raises :class:`YAMLSubsetError`.  Aliases are the same
    object as their anchor's node, as in PyYAML."""
    return _BlockReader(text, path).document()


def _plain_safe(text: str) -> bool:
    """Whether ``text`` reads back as itself when written unquoted."""
    return (text.isprintable() and text == text.strip() and text != ""
            and text[0] not in "-?:,[]{}#&*!|>'\"%@`" and not text.endswith(":")
            and ": " not in text and " #" not in text and not _UNREAD.match(text)
            and _scalar(text) == text)


def _dump_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (float("inf"), float("-inf")):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v)
        # YAML 1.1 floats need a dot: 1e-05 -> 1.0e-05 (as PyYAML writes them)
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(v, str):
        return v if _plain_safe(v) else json.dumps(v, ensure_ascii=False)
    if isinstance(v, dict) and not v:
        return "{}"
    if isinstance(v, (list, tuple)) and not v:
        return "[]"
    raise TypeError(f"cannot write {type(v).__name__} {v!r} as YAML")


def dump_yaml(data: Any) -> str:
    """``data`` (dicts, lists, strings, numbers, booleans, None) as block
    YAML that :func:`read_yaml` (and ``yaml.safe_load``) read back equal."""
    lines: List[str] = []

    def emit(node: Any, indent: int) -> None:
        pad = " " * indent
        if isinstance(node, dict) and node:
            for k, v in node.items():
                if isinstance(v, (dict, list, tuple)) and v:
                    lines.append(f"{pad}{_dump_scalar(k)}:")
                    emit(v, indent + 2)
                else:
                    lines.append(f"{pad}{_dump_scalar(k)}: {_dump_scalar(v)}")
        elif isinstance(node, (list, tuple)) and node:
            for v in node:
                if isinstance(v, (dict, list, tuple)) and v:
                    lines.append(f"{pad}-")
                    emit(v, indent + 2)
                else:
                    lines.append(f"{pad}- {_dump_scalar(v)}")
        else:
            lines.append(pad + _dump_scalar(node))

    emit(data, 0)
    return "\n".join(lines) + "\n"


def _read_file(path: str) -> Any:
    with open(path) as f:
        text = f.read()
    if path.endswith(".json"):
        return json.loads(text)
    return read_yaml(text, path)


def load_config(path_or_dict, overrides: Optional[List[str]] = None,
                search_paths: Optional[List[str]] = None) -> DotDict:
    """A config from a YAML or JSON file (or a dict, deep-copied), with
    Hydra-style ``defaults:`` composition and overrides, as the JAX
    package's ``load_config``.

    ``defaults`` lists ``group/name`` strings or ``{group: name}`` entries,
    each the file ``<group>/<name>.yaml`` merged under the key ``group``
    (``a/b`` -> ``cfg["a"]["b"]``), searched in the file's folder, then in
    ``search_paths`` (the CLI passes :data:`PACKAGED_CONFIG_DIR`); a group
    file may have defaults of its own.  ``_self_`` places the file's own
    keys (default: last)."""
    search = list(search_paths or [])
    if isinstance(path_or_dict, dict):
        raw = copy.deepcopy(dict(path_or_dict))
    else:
        base_dir = os.path.dirname(os.path.abspath(path_or_dict))
        if base_dir not in search:
            search.insert(0, base_dir)
        raw = _read_file(path_or_dict) or {}
    if not isinstance(raw, dict):
        raise ValueError(f"{path_or_dict}: a config is a mapping, got {type(raw).__name__}")

    defaults = raw.pop("defaults", None)
    if defaults is None:
        merged = raw
    else:
        merged: Dict[str, Any] = {}
        self_seen = False
        for entry in defaults:
            if entry == "_self_":
                deep_update(merged, raw)
                self_seen = True
                continue
            if isinstance(entry, dict):
                [(group, name)] = entry.items()
            else:
                group, _, name = str(entry).rpartition("/")
            sub = _find_and_load(group, str(name), search)
            if group:
                keys = group.split("/")
                node: Dict[str, Any] = merged
                for k in keys[:-1]:
                    node = node.setdefault(k, {})
                deep_update(node.setdefault(keys[-1], {}), sub)
            else:
                deep_update(merged, sub)
        if not self_seen:
            deep_update(merged, raw)

    if overrides:
        apply_overrides(merged, list(overrides))
    return DotDict(merged)


def _find_and_load(group: str, name: str, search: List[str]) -> Dict[str, Any]:
    rel = os.path.join(group, f"{name}.yaml") if group else f"{name}.yaml"
    for root in search:
        candidate = os.path.join(root, rel)
        if os.path.exists(candidate):
            return load_config(candidate, search_paths=search).to_dict()
    raise FileNotFoundError(f"Config group file not found: {rel} (searched {search})")


def save_config(cfg: Any, path: str) -> None:
    """Write ``cfg`` as YAML (:func:`dump_yaml`)."""
    if isinstance(cfg, DotDict):
        cfg = cfg.to_dict()
    with open(path, "w") as f:
        f.write(dump_yaml(cfg))
