"""A YAML reader and writer for the subset the GPV configs use.

The card machine has no pyyaml, so the port reads `configs/` and the CLI
overrides with this module. It covers block mappings and lists (a list
item may open a mapping, `- task: coco_learning_tasks`), comments, plain,
single- and double-quoted scalars, and flow lists and mappings
(`[1, 1, 1, 1]`, `{num_layers: 1, hidden: 32}`), nested. Scalars resolve
as pyyaml's `SafeLoader` resolves them (YAML 1.1: `null`/`~`/empty,
`true`/`yes`/`on` and their capitalised forms, decimal/hex/octal/binary
ints, floats with a dot); `floats12=True` adds YAML 1.2 floats such as
`1e-4`, as the JAX package's config loader does. Anchors, aliases, tags,
block scalars (`|`, `>`), multi-document streams and timestamps are not
supported and raise `YamlError`, as does anything malformed.

`dump` writes block style that this reader and pyyaml read back to the
same value.
"""
from __future__ import annotations

import json
import math
import re
from typing import Any, List, Tuple

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+)$""", re.X)
_FLOAT11 = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
_FLOAT12 = re.compile(r"""^(?:
    [-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
   |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
   |\.[0-9_]+(?:[eE][-+][0-9]+)?
   |[-+]?\.(?:inf|Inf|INF)
   |\.(?:nan|NaN|NAN))$""", re.X)
_UNSUPPORTED_START = tuple("&*!|>%@`")


class YamlError(ValueError):
    """Malformed input, or YAML outside the supported subset."""


def _to_int(s: str) -> int:
    s = s.replace("_", "")
    sign = -1 if s.startswith("-") else 1
    s = s.lstrip("-+")
    if s.startswith("0b"):
        return sign * int(s[2:], 2)
    if s.startswith("0x"):
        return sign * int(s[2:], 16)
    if len(s) > 1 and s.startswith("0"):
        return sign * int(s, 8)
    return sign * int(s)


def _to_float(s: str) -> float:
    s = s.replace("_", "").lower()
    if s.endswith(".inf"):
        return -math.inf if s.startswith("-") else math.inf
    if s.endswith(".nan"):
        return math.nan
    return float(s)


def resolve_plain(s: str, floats12: bool = False) -> Any:
    """The value of a plain (unquoted) scalar, as SafeLoader resolves it;
    `floats12` adds the YAML 1.2 float forms after the 1.1 ones."""
    if s in _NULL:
        return None
    if s in _TRUE:
        return True
    if s in _FALSE:
        return False
    if _INT.match(s):
        return _to_int(s)
    if _FLOAT11.match(s) or (floats12 and _FLOAT12.match(s)):
        return _to_float(s)
    return s


def _strip_comment(line: str) -> str:
    """`line` without a trailing comment: `#` at the start or after
    whitespace, outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t:[{,-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _quoted(s: str) -> Tuple[str, int]:
    """Parse the quoted scalar at the start of `s`; (value, chars used)."""
    q = s[0]
    i, out = 1, []
    while i < len(s):
        ch = s[i]
        if q == "'" and ch == "'":
            if s[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and ch == "\\":
            end = i + 2
            if s[i + 1:i + 2] == "u":
                end = i + 6
            try:
                out.append(json.loads('"' + s[i:end] + '"'))
            except ValueError:
                raise YamlError(f"bad escape in {s!r}") from None
            i = end
            continue
        if q == '"' and ch == '"':
            return "".join(out), i + 1
        out.append(ch)
        i += 1
    raise YamlError(f"unterminated quoted scalar: {s!r}")


def _find_colon(s: str) -> int:
    """Index of the mapping colon of `s` (a colon followed by a space or
    ending the text, outside quotes and brackets), or -1."""
    quote, depth = None, 0
    for i, ch in enumerate(s):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or s[i - 1] in " \t[{,:"):
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == ":" and depth == 0 and (i + 1 == len(s) or s[i + 1] == " "):
            return i
    return -1


class _Flow:
    """Recursive-descent parser of one flow value (`[...]`, `{...}` or a
    scalar inside them)."""

    def __init__(self, text: str, floats12: bool):
        self.s, self.i, self.floats12 = text, 0, floats12

    def _ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def parse(self) -> Any:
        value = self.value()
        self._ws()
        if self.i != len(self.s):
            raise YamlError(f"trailing text after a flow value: {self.s!r}")
        return value

    def value(self) -> Any:
        self._ws()
        if self.i >= len(self.s):
            raise YamlError(f"missing flow value: {self.s!r}")
        ch = self.s[self.i]
        if ch == "[":
            return self._seq()
        if ch == "{":
            return self._map()
        if ch in "'\"":
            val, n = _quoted(self.s[self.i:])
            self.i += n
            return val
        start = self.i
        while self.i < len(self.s) and self.s[self.i] not in ",[]{}":
            if self.s[self.i] == ":" and (self.i + 1 == len(self.s)
                                          or self.s[self.i + 1] in " ,]}"):
                break
            self.i += 1
        text = self.s[start:self.i].strip()
        if text.startswith(_UNSUPPORTED_START):
            raise YamlError(f"unsupported YAML: {text!r}")
        return resolve_plain(text, self.floats12)

    def _seq(self) -> list:
        self.i += 1
        out = []
        self._ws()
        if self.s[self.i:self.i + 1] == "]":
            self.i += 1
            return out
        while True:
            out.append(self.value())
            self._ws()
            ch = self.s[self.i:self.i + 1]
            self.i += 1
            if ch == "]":
                return out
            if ch != ",":
                raise YamlError(f"expected ',' or ']' in {self.s!r}")
            self._ws()
            if self.s[self.i:self.i + 1] == "]":  # trailing comma
                self.i += 1
                return out

    def _map(self) -> dict:
        self.i += 1
        out = {}
        self._ws()
        if self.s[self.i:self.i + 1] == "}":
            self.i += 1
            return out
        while True:
            key = self.value()
            self._ws()
            if self.s[self.i:self.i + 1] == ":":
                self.i += 1
                self._ws()
                val = (None if self.s[self.i:self.i + 1] in (",", "}")
                       else self.value())
            else:
                val = None
            out[key] = val
            self._ws()
            ch = self.s[self.i:self.i + 1]
            self.i += 1
            if ch == "}":
                return out
            if ch != ",":
                raise YamlError(f"expected ',' or '}}' in {self.s!r}")
            self._ws()
            if self.s[self.i:self.i + 1] == "}":
                self.i += 1
                return out


def _scalar(text: str, floats12: bool) -> Any:
    """A value written after `key:` or `- ` on one line."""
    if not text:
        return None
    if text[0] in "[{":
        return _Flow(text, floats12).parse()
    if text[0] in "'\"":
        val, n = _quoted(text)
        if text[n:].strip():
            raise YamlError(f"text after a quoted scalar: {text!r}")
        return val
    if text.startswith(_UNSUPPORTED_START):
        raise YamlError(f"unsupported YAML: {text!r}")
    if ": " in text or text.endswith(":"):
        raise YamlError(f"mapping values are not allowed here: {text!r}")
    return resolve_plain(text, floats12)


class _Block:
    def __init__(self, lines: List[Tuple[int, str]], floats12: bool):
        self.lines, self.i, self.floats12 = lines, 0, floats12

    def parse(self, indent: int) -> Any:
        _, text = self.lines[self.i]
        if text == "-" or text.startswith("- "):
            return self._seq(indent)
        if _find_colon(text) >= 0:
            return self._map(indent)
        # a lone scalar (a whole document, or a value on its own line)
        self.i += 1
        if self.i < len(self.lines) and self.lines[self.i][0] > indent:
            raise YamlError(f"unexpected indentation after {text!r}")
        return _scalar(text, self.floats12)

    def _child(self, indent: int, seq_ok: bool) -> Any:
        """The block under a `key:` or `-` with nothing after it."""
        if self.i >= len(self.lines):
            return None
        ind, text = self.lines[self.i]
        if ind > indent or (seq_ok and ind == indent
                            and (text == "-" or text.startswith("- "))):
            return self.parse(ind)
        return None

    def _map(self, indent: int) -> dict:
        out = {}
        while self.i < len(self.lines):
            ind, text = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent:
                raise YamlError(f"bad indentation: {text!r}")
            c = _find_colon(text)
            if c < 0:
                raise YamlError(f"expected 'key: value': {text!r}")
            key = _scalar(text[:c].strip(), self.floats12)
            if isinstance(key, (dict, list)):
                raise YamlError(f"unhashable key: {text!r}")
            rest = text[c + 1:].strip()
            self.i += 1
            out[key] = (_scalar(rest, self.floats12) if rest
                        else self._child(indent, seq_ok=True))
        return out

    def _seq(self, indent: int) -> list:
        out = []
        while self.i < len(self.lines):
            ind, text = self.lines[self.i]
            if ind < indent or not (text == "-" or text.startswith("- ")):
                if ind > indent:
                    raise YamlError(f"bad indentation: {text!r}")
                break
            if ind > indent:
                raise YamlError(f"bad indentation: {text!r}")
            rest = text[1:].strip()
            if not rest:
                self.i += 1
                out.append(self._child(indent, seq_ok=False))
                continue
            # the item's content, at its own column, may open a mapping or
            # a list that continues on the next lines
            col = ind + len(text) - len(rest)
            self.lines[self.i] = (col, rest)
            if rest == "-" or rest.startswith("- "):
                out.append(self._seq(col))
            elif _find_colon(rest) >= 0 and rest[0] not in "[{'\"":
                out.append(self._map(col))
            else:
                self.i += 1
                out.append(_scalar(rest, self.floats12))
        return out


def load(text: str, floats12: bool = False) -> Any:
    """Parse one YAML document of the supported subset."""
    lines = []
    for raw in text.splitlines():
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise YamlError("tabs in indentation")
        body = _strip_comment(raw)
        if not body.strip():
            continue
        if body.strip() in ("---", "..."):
            raise YamlError("document markers are not supported")
        lines.append((len(body) - len(body.lstrip()), body.strip()))
    if not lines:
        return None
    block = _Block(lines, floats12)
    value = block.parse(lines[0][0])
    if block.i != len(lines):
        raise YamlError(f"unexpected line: {lines[block.i][1]!r}")
    return value


def _plain_ok(s: str) -> bool:
    """Whether a string can be written unquoted and read back as itself."""
    return (s != "" and s == s.strip() and "\n" not in s
            and not s.startswith(("-", "?", "[", "{", "'", '"', "#")
                                 + _UNSUPPORTED_START)
            and not any(c in s for c in ":#,[]{}")
            and resolve_plain(s) == s and resolve_plain(s, True) == s)


def _scalar_text(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        mant, _, exp = r.partition("e")
        if "." not in mant:
            mant += ".0"
        return mant + ("e" + exp if exp else "")
    if isinstance(v, str):
        return v if _plain_ok(v) else json.dumps(v)
    raise TypeError(f"cannot write {type(v).__name__} as YAML")


def dump(value: Any) -> str:
    """Block-style YAML for nested dicts, lists and scalars."""
    out: List[str] = []

    def emit(v: Any, indent: int) -> None:
        pad = " " * indent
        if isinstance(v, dict):
            for k, x in v.items():
                key = _scalar_text(k)
                if isinstance(x, (dict, list)) and x:
                    out.append(f"{pad}{key}:")
                    emit(x, indent + 2)
                else:
                    out.append(f"{pad}{key}: {inline(x)}")
        else:
            for x in v:
                if isinstance(x, (dict, list)) and x:
                    out.append(f"{pad}-")
                    emit(x, indent + 2)
                else:
                    out.append(f"{pad}- {inline(x)}")

    def inline(x: Any) -> str:
        if isinstance(x, dict):
            return "{}"
        if isinstance(x, list):
            return "[]"
        return _scalar_text(x)

    if isinstance(value, (dict, list)) and value:
        emit(value, 0)
    else:
        out.append(inline(value))
    return "\n".join(out) + "\n"
