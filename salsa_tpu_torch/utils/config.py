"""Config handling (counterpart of `salsa_tpu.utils.config`): YAML -> attribute-
accessible dict, dotted CLI overrides, and `save_config`, a YAML writer for the
subset read here (its output reads back equal here and through `yaml.safe_load`).

`salsa_tpu` reads configs with PyYAML, which the GPU host does not have. This module
reads the YAML subset that experiment configs use and that `yaml.safe_dump` writes:
block mappings by indentation, block lists (`- x`, also at the parent key's
indentation), `#` comments, single- and double-quoted and plain scalars, and
one-line flow lists `[a, b]`. Plain scalars are typed as PyYAML's YAML 1.1
resolver types them (`yaml.safe_load`): null, booleans (`true`, `yes`, `on`, ...),
ints (decimal, octal, hex, binary, base 60) and floats, so `3.0e-4` is a float and
`3e-4` a string. Anything outside the subset (anchors, aliases, tags, `|`/`>`
blocks, flow mappings, multi-line scalars, timestamps, documents markers) raises
ValueError naming the line: it is never read wrongly.
"""
from __future__ import annotations

import copy
import re
from dataclasses import dataclass
from typing import Any, Mapping


class AttrDict(dict):
    """dict subclass with attribute access, recursively wrapping nested mappings."""

    def __init__(self, mapping: Mapping | None = None, **kwargs):
        super().__init__()
        if mapping:
            for k, v in mapping.items():
                self[k] = v
        for k, v in kwargs.items():
            self[k] = v

    def __setitem__(self, key, value):
        if isinstance(value, Mapping) and not isinstance(value, AttrDict):
            value = AttrDict(value)
        elif isinstance(value, list):
            value = [AttrDict(v) if isinstance(v, Mapping) else v for v in value]
        super().__setitem__(key, value)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __deepcopy__(self, memo):
        return AttrDict({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_dict(self) -> dict:
        out = {}
        for k, v in self.items():
            if isinstance(v, AttrDict):
                out[k] = v.to_dict()
            elif isinstance(v, list):
                out[k] = [x.to_dict() if isinstance(x, AttrDict) else x for x in v]
            else:
                out[k] = v
        return out


# PyYAML's implicit resolvers (yaml/resolver.py), the YAML 1.1 types of plain scalars
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
# types this reader does not construct: timestamps, merge and value keys, yaml tags
_UNSUPPORTED = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?
                    |<<|=|!|&|\*)$""", re.X)
# characters a plain scalar may not start with here (YAML indicators)
_INDICATORS = set("&*!|>%@`{}],")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(text: str, cast) -> Any:
    value = cast(0)
    for part in text.split(":"):
        value = value * 60 + cast(part)
    return value


def _resolve_plain(text: str, where: str) -> Any:
    """A plain scalar's value as `yaml.safe_load` constructs it."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _INT.match(text) or _FLOAT.match(text):
        is_int = bool(_INT.match(text))
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v[1:] if v[0] in "+-" else v
        if not is_int:
            v = v.lower()
            if v == ".inf":
                return sign * float("inf")
            if v == ".nan":
                return float("nan")
            return sign * (_sexagesimal(v, float) if ":" in v else float(v))
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v != "0" and v[0] == "0":
            return sign * int(v, 8)
        return sign * (_sexagesimal(v, int) if ":" in v else int(v))
    if _UNSUPPORTED.match(text):
        raise ValueError(f"{where}: '{text}' is a YAML type this reader does not construct "
                         "(timestamp, merge key, value key or tag)")
    return text


@dataclass
class _Line:
    number: int  # 1-based, for messages
    indent: int
    text: str    # without the indentation; may end in a comment


def _comment_start(text: str) -> int:
    """Index of a `#` comment in `text` (a `#` at the start or after whitespace),
    or len(text)."""
    for i in range(len(text)):
        if text[i] == "#" and (i == 0 or text[i - 1] in " \t"):
            return i
    return len(text)


class _Reader:
    def __init__(self, text: str, name: str):
        self.name = name
        self.lines: list[_Line] = []
        for number, raw in enumerate(text.splitlines(), start=1):
            stripped = raw.lstrip(" ")
            if not stripped.strip() or stripped.startswith("#"):
                continue
            if stripped[0] == "\t":
                raise ValueError(f"{self.where(number)}: tab in indentation")
            indent = len(raw) - len(stripped)
            if indent == 0 and stripped.startswith(("---", "...", "%")):
                raise ValueError(f"{self.where(number)}: document markers and directives "
                                 "are outside the YAML subset this reader takes")
            self.lines.append(_Line(number, indent, stripped.rstrip()))
        self.i = 0

    def where(self, number: int) -> str:
        return f"{self.name}, line {number}"

    def fail(self, line: _Line, why: str):
        raise ValueError(f"{self.where(line.number)}: {why}: {line.text!r}")

    # -- scalars -----------------------------------------------------------

    def quoted(self, text: str, p: int, line: _Line) -> tuple[str, int]:
        """The quoted scalar starting at text[p]; returns (value, index after it)."""
        q, out, p = text[p], [], p + 1
        while p < len(text):
            c = text[p]
            if q == "'" and c == "'":
                if text[p + 1:p + 2] == "'":
                    out.append("'")
                    p += 2
                    continue
                return "".join(out), p + 1
            if q == '"' and c == '"':
                return "".join(out), p + 1
            if q == '"' and c == "\\":
                e = text[p + 1:p + 2]
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    p += 2
                elif e in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[e]
                    digits = text[p + 2:p + 2 + n]
                    if len(digits) != n or not all(d in "0123456789abcdefABCDEF"
                                                   for d in digits):
                        self.fail(line, "bad escape in a double-quoted scalar")
                    out.append(chr(int(digits, 16)))
                    p += 2 + n
                else:
                    self.fail(line, "escape or line break in a double-quoted scalar is "
                                    "outside the YAML subset this reader takes")
                continue
            out.append(c)
            p += 1
        self.fail(line, "a quoted scalar that does not close on its line (multi-line "
                        "scalars are outside the YAML subset this reader takes)")

    def plain(self, text: str, line: _Line, flow: bool) -> Any:
        """A plain scalar, stripped, typed as PyYAML types it."""
        if text and (text[0] in _INDICATORS or text[0] in "'\"["
                     or text[:2] in ("- ", "? ", ": ") or text in ("-", "?", ":")):
            self.fail(line, f"'{text[0]}' starts an anchor, alias, tag, block scalar, flow "
                            "mapping or other YAML outside the subset this reader takes")
        if ": " in text or text.endswith(":") or (flow and any(c in text for c in "[]{}")):
            self.fail(line, "a mapping inside a scalar is outside the YAML subset this "
                            "reader takes")
        return _resolve_plain(text, self.where(line.number))

    def flow_list(self, text: str, p: int, line: _Line) -> tuple[list, int]:
        """The one-line flow list starting at text[p] == '['."""
        items, p = [], p + 1
        while True:
            while p < len(text) and text[p] == " ":
                p += 1
            if p >= len(text) or text[p] == "#":
                self.fail(line, "a flow list that does not close on its line")
            if text[p] == "]":
                return items, p + 1
            if text[p] == "[":
                item, p = self.flow_list(text, p, line)
            elif text[p] in "'\"":
                item, p = self.quoted(text, p, line)
            else:
                end = p
                while end < len(text) and text[end] not in ",]" and not (
                        text[end] == "#" and text[end - 1] == " "):
                    end += 1
                raw = text[p:end].strip()
                if not raw:
                    self.fail(line, "an empty entry in a flow list")
                item, p = self.plain(raw, line, flow=True), end
            items.append(item)
            while p < len(text) and text[p] == " ":
                p += 1
            if p < len(text) and text[p] == ",":
                p += 1
            elif p >= len(text) or text[p] != "]":
                self.fail(line, "expected ',' or ']' in a flow list")

    def inline(self, text: str, line: _Line) -> Any:
        """The value written on a line after its key or `- `: a quoted scalar, a flow
        list or a plain scalar, then at most a comment."""
        if text[0] in "'\"[":
            value, end = (self.flow_list if text[0] == "[" else self.quoted)(text, 0, line)
            rest = text[end:]
            if rest.strip() and not (rest[0] in " \t" and rest.lstrip().startswith("#")):
                self.fail(line, "text after a quoted scalar or flow list")
            return value
        return self.plain(text[:_comment_start(text)].rstrip(), line, flow=False)

    def split_key(self, text: str, line: _Line) -> tuple[Any, str] | None:
        """(key, the rest after ': ') when the line holds a mapping entry, else None."""
        if text[0] in "'\"":
            key, end = self.quoted(text, 0, line)
            rest = text[end:].lstrip(" ")
            if rest == ":" or rest.startswith((": ", ":\t")):
                return key, rest[1:].strip()
            return None
        if text[0] in "[{" or text[:2] == "? ":
            return None
        body = text[:_comment_start(text)].rstrip()
        for i, c in enumerate(body):
            if c == ":" and (i + 1 == len(body) or body[i + 1] in " \t"):
                raw = body[:i].rstrip()
                if not raw:
                    self.fail(line, "an empty key")
                return self.plain(raw, line, flow=False), body[i + 1:].strip()
        return None

    # -- blocks ------------------------------------------------------------

    def at(self, indent: int) -> _Line | None:
        """The next line if it is at `indent`; None at the end or at a shallower one."""
        if self.i >= len(self.lines):
            return None
        line = self.lines[self.i]
        if line.indent > indent:
            self.fail(line, "unexpected indentation")
        return line if line.indent == indent else None

    @staticmethod
    def is_entry(text: str) -> bool:
        return text == "-" or text.startswith("- ")

    def node(self, indent: int) -> Any:
        line = self.lines[self.i]
        if self.is_entry(line.text):
            return self.sequence(indent)
        if self.split_key(line.text, line) is not None:
            return self.mapping(indent)
        self.i += 1
        value = self.inline(line.text, line)
        self.at(indent - 1)  # a scalar continued on the next line is refused there
        return value

    def nested(self, indent: int, allow_indentless: bool) -> Any:
        """The block value of a key or entry whose line ends after its indicator."""
        if self.i < len(self.lines):
            nxt = self.lines[self.i]
            if nxt.indent > indent:
                return self.node(nxt.indent)
            if allow_indentless and nxt.indent == indent and self.is_entry(nxt.text):
                return self.sequence(indent)
        return None

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while (line := self.at(indent)) is not None and not self.is_entry(line.text):
            kv = self.split_key(line.text, line)
            if kv is None:
                self.fail(line, "expected 'key: value'")
            key, rest = kv
            self.i += 1
            if rest and not rest.startswith("#"):
                out[key] = self.inline(rest, line)
                self.at(indent)  # deeper lines after an inline value are refused
            else:
                out[key] = self.nested(indent, allow_indentless=True)
        return out

    def sequence(self, indent: int) -> list:
        out: list = []
        while (line := self.at(indent)) is not None and self.is_entry(line.text):
            body = line.text[1:]
            content = body.lstrip(" ")
            if not content or content.startswith("#"):
                self.i += 1
                out.append(self.nested(indent, allow_indentless=False))
                continue
            col = indent + 1 + len(body) - len(content)
            if self.is_entry(content) or self.split_key(content, line) is not None:
                # "- key: v" or "- - x": the entry's node starts at its content's column
                self.lines[self.i] = _Line(line.number, col, content)
                out.append(self.node(col))
            else:
                self.i += 1
                out.append(self.inline(content, line))
                self.at(indent)
        return out

    def document(self) -> Any:
        if not self.lines:
            return None
        value = self.node(self.lines[0].indent)
        if self.i < len(self.lines):
            self.fail(self.lines[self.i], "unexpected indentation")
        return value


def parse_yaml(text: str, name: str = "<string>") -> Any:
    """`yaml.safe_load(text)` for the subset described in the module docstring."""
    return _Reader(text, name).document()


def load_config(path: str) -> AttrDict:
    """Load a YAML config file into an AttrDict."""
    with open(path, "r") as f:
        cfg = parse_yaml(f.read(), path)
    return AttrDict(cfg or {})


def _yaml_scalar(v: Any) -> str:
    """A scalar as YAML that this reader and yaml.safe_load read back as `v`."""
    if hasattr(v, "item") and not isinstance(v, (str, bytes)):  # a numpy scalar
        v = v.item()
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
        mant, e, exp = repr(v).partition("e")
        if "." not in mant:  # YAML 1.1 floats need a dot: 1e-10 -> 1.0e-10
            mant += ".0"
        return mant + (f"e{exp}" if e else "")
    if isinstance(v, str):
        if not v.isprintable():
            raise ValueError(f"save_config: {v!r} holds characters outside the YAML subset "
                             "this package writes")
        return "'" + v.replace("'", "''") + "'"
    raise TypeError(f"save_config: cannot write a {type(v).__name__} ({v!r})")


def _yaml_key(k: Any) -> str:
    if isinstance(k, str) and re.fullmatch(r"[A-Za-z_][A-Za-z0-9_.\-]*", k) and isinstance(
            _resolve_plain(k, "key"), str):
        return k
    return _yaml_scalar(k)


def _yaml_flow(v: list | tuple) -> str:
    return "[" + ", ".join(_yaml_flow(x) if isinstance(x, (list, tuple)) else _yaml_scalar(x)
                           for x in v) + "]"


def _is_flow(v: list | tuple) -> bool:
    return all(_is_flow(x) if isinstance(x, (list, tuple)) else not isinstance(x, Mapping)
               for x in v)


def _yaml_lines(node: Any, indent: int, out: list[str]) -> None:
    pad = " " * indent
    if isinstance(node, Mapping):
        if not node:
            raise ValueError("save_config: an empty mapping is outside the YAML subset "
                             "this package writes")
        for k, v in node.items():
            key = _yaml_key(k)
            if isinstance(v, Mapping) or (isinstance(v, (list, tuple)) and not _is_flow(v)):
                out.append(f"{pad}{key}:")
                _yaml_lines(v, indent + 2, out)
            elif isinstance(v, (list, tuple)):
                out.append(f"{pad}{key}: {_yaml_flow(v)}")
            else:
                out.append(f"{pad}{key}: {_yaml_scalar(v)}")
        return
    for item in node:  # a block sequence
        if isinstance(item, Mapping) or (isinstance(item, (list, tuple)) and not _is_flow(item)):
            sub: list[str] = []
            _yaml_lines(item, indent + 2, sub)
            out.append(f"{pad}- {sub[0][indent + 2:]}")
            out.extend(sub[1:])
        elif isinstance(item, (list, tuple)):
            out.append(f"{pad}- {_yaml_flow(item)}")
        else:
            out.append(f"{pad}- {_yaml_scalar(item)}")


def dump_yaml(cfg: Mapping) -> str:
    """YAML text of a mapping of mappings, lists and scalars (None, bool, int,
    float, str), in the subset `parse_yaml` reads: block mappings, flow lists of
    scalars, block lists of mappings, single-quoted strings. Raises on what the
    subset cannot hold (an empty mapping, a non-printable string, another type)."""
    out: list[str] = []
    _yaml_lines(cfg.to_dict() if isinstance(cfg, AttrDict) else cfg, 0, out)
    return "\n".join(out) + "\n"


def save_config(cfg: Mapping, path: str) -> None:
    """Write `cfg` as YAML (`dump_yaml`), as `salsa_tpu.utils.config.save_config`."""
    with open(path, "w") as f:
        f.write(dump_yaml(cfg))


def apply_overrides(cfg: AttrDict, overrides: list[str]) -> AttrDict:
    """Apply 'dotted.key=value' CLI overrides in place; values parsed as YAML."""
    for ov in overrides:
        key, _, raw = ov.partition("=")
        if not _:
            raise ValueError(f"override '{ov}' must look like key=value")
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            if p not in node:
                node[p] = AttrDict()
            node = node[p]
        value = parse_yaml(raw, f"override '{ov}'")
        if isinstance(value, str):
            # YAML 1.1 only floats '3.0e-4', not '3e-4' — accept plain numerics too
            try:
                value = float(value) if any(c in value for c in ".eE") else int(value)
            except ValueError:
                pass
        node[parts[-1]] = value
    return cfg
