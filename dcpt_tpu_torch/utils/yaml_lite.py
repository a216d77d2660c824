"""A loader for the YAML subset the shipped option files use, so the port needs no PyYAML.

Covers block mappings nested by indentation, flow lists and flow mappings
(``[1, 1, 28]``, ``{type: disk}``, ``{}``), single- and double-quoted scalars,
comments, and PyYAML's YAML 1.1 resolution of plain scalars: null (``~``,
``null``, empty), bool (``true``/``false``/``yes``/``no``/``on``/``off`` in
three casings), int (decimal, ``0x``, ``0b``, leading-zero octal) and float
(``1.0e-4``, ``.inf``, ``.nan``).  Anything else it raises on: block
sequences, anchors, tags, multi-document streams, block scalars.
"""

from __future__ import annotations

import re
from typing import Any

_NULL = {"~", "null", "Null", "NULL", ""}
_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF")})
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_INT_OTHER = re.compile(r"[-+]?(?:0b[0-1_]+|0[0-7_]+|0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")


class YamlError(ValueError):
    pass


def resolve_plain(text: str) -> Any:
    """A plain (unquoted) scalar as PyYAML's SafeLoader resolves it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _INT_OTHER.match(text):
        sign = -1 if text[0] == "-" else 1
        body = text.lstrip("+-").replace("_", "")
        if body.startswith("0b"):
            return sign * int(body[2:], 2)
        if body.startswith("0x"):
            return sign * int(body[2:], 16)
        return sign * int(body, 8)
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _INF.match(text):
        return float("-inf") if text[0] == "-" else float("inf")
    if _NAN.match(text):
        return float("nan")
    if text[0] in "&*!|>%@`" or text.startswith("- ") or text == "-":
        raise YamlError(f"unsupported YAML syntax: {text!r}")
    return text


def _strip_comment(line: str) -> str:
    quote, skip = None, False
    for i, ch in enumerate(line):
        if skip:
            skip = False
        elif quote:
            if (ch == quote == "'" and line[i + 1 : i + 2] == "'") or (quote == '"' and ch == "\\"):
                skip = True  # '' in a single-quoted scalar, \x in a double-quoted one
            elif ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t:[{,"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


class _Flow:
    """Recursive descent over one flow value (``[...]``, ``{...}``, a scalar)."""

    def __init__(self, text: str):
        self.s, self.i = text, 0

    def _ws(self) -> None:
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def _quoted(self) -> str:
        q = self.s[self.i]
        self.i += 1
        out = []
        while self.i < len(self.s):
            ch = self.s[self.i]
            if q == "'" and ch == "'":
                if self.s[self.i + 1 : self.i + 2] == "'":
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return "".join(out)
            if q == '"' and ch == "\\":
                esc = self.s[self.i + 1 : self.i + 2]
                out.append({"n": "\n", "t": "\t", '"': '"', "\\": "\\", "/": "/"}.get(esc, "\\" + esc))
                self.i += 2
                continue
            if q == '"' and ch == '"':
                self.i += 1
                return "".join(out)
            out.append(ch)
            self.i += 1
        raise YamlError(f"unterminated quoted scalar in {self.s!r}")

    def value(self, in_flow: bool) -> Any:
        self._ws()
        if self.i >= len(self.s):
            return None
        ch = self.s[self.i]
        if ch == "[":
            return self._list()
        if ch == "{":
            return self._map()
        if ch in "'\"":
            return self._quoted()
        start = self.i
        if not in_flow:
            self.i = len(self.s)
            return resolve_plain(self.s[start:].strip())
        while self.i < len(self.s) and self.s[self.i] not in ",]}":
            if self.s[self.i] == ":" and self.s[self.i + 1 : self.i + 2] in (" ", ""):
                break
            self.i += 1
        return resolve_plain(self.s[start : self.i].strip())

    def _list(self) -> list:
        self.i += 1
        out: list = []
        while True:
            self._ws()
            if self.s[self.i : self.i + 1] == "]":
                self.i += 1
                return out
            out.append(self.value(True))
            self._ws()
            ch = self.s[self.i : self.i + 1]
            if ch == ",":
                self.i += 1
            elif ch != "]":
                raise YamlError(f"bad flow sequence: {self.s!r}")

    def _map(self) -> dict:
        self.i += 1
        out: dict = {}
        while True:
            self._ws()
            if self.s[self.i : self.i + 1] == "}":
                self.i += 1
                return out
            key = self.value(True)
            self._ws()
            if self.s[self.i : self.i + 1] != ":":
                raise YamlError(f"bad flow mapping: {self.s!r}")
            self.i += 1
            out[key] = self.value(True)
            self._ws()
            ch = self.s[self.i : self.i + 1]
            if ch == ",":
                self.i += 1
            elif ch != "}":
                raise YamlError(f"bad flow mapping: {self.s!r}")

    def parse(self) -> Any:
        v = self.value(False)
        self._ws()
        if self.i != len(self.s):
            raise YamlError(f"trailing text after a flow value: {self.s!r}")
        return v


def _split_key(text: str) -> tuple[str, str]:
    """``key: value`` -> (key, value); the colon is the first one followed by a space or the end."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and i == 0:
            quote = ch
        elif ch == ":" and (i + 1 == len(text) or text[i + 1] == " "):
            return text[:i].strip(), text[i + 1 :].strip()
    raise YamlError(f"expected 'key: value', got {text!r}")


def _lines(text: str) -> list[tuple[int, str]]:
    out: list[tuple[int, str]] = []
    pending = ""
    for raw in text.splitlines():
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise YamlError("tab indentation is not YAML")
        line = _strip_comment(raw)
        if pending:  # a flow collection continued over several lines
            pending += " " + line.strip()
        elif not line.strip():
            continue
        elif line.strip() in ("---", "..."):
            raise YamlError("multi-document YAML is not supported")
        else:
            indent = len(line) - len(line.lstrip())
            pending = line.strip()
        if pending.count("[") + pending.count("{") > pending.count("]") + pending.count("}"):
            continue
        out.append((indent, pending))
        pending = ""
    if pending:
        raise YamlError("unterminated flow collection")
    return out


def _block(lines: list[tuple[int, str]], pos: int, indent: int) -> tuple[dict, int]:
    out: dict = {}
    while pos < len(lines):
        ind, text = lines[pos]
        if ind < indent:
            break
        if ind > indent:
            raise YamlError(f"unexpected indentation at {text!r}")
        if text.startswith("- ") or text == "-":
            raise YamlError("block sequences are not supported; use a flow list [a, b]")
        key_text, rest = _split_key(text)
        key = _Flow(key_text).parse()
        if key in out:
            raise YamlError(f"duplicate key {key!r}")
        pos += 1
        if rest:
            out[key] = _Flow(rest).parse()
        elif pos < len(lines) and lines[pos][0] > indent:
            out[key], pos = _block(lines, pos, lines[pos][0])
        else:
            out[key] = None
    return out, pos


def loads(text: str) -> Any:
    """Parse YAML text of the supported subset (a mapping at the top, or nothing)."""
    lines = _lines(text)
    if not lines:
        return None
    if lines[0][0] != 0:
        raise YamlError("the document must start at column 0")
    if len(lines) == 1 and not re.match(r"[^\[{'\"]*:( |$)", lines[0][1]):
        return _Flow(lines[0][1]).parse()
    out, pos = _block(lines, 0, 0)
    if pos != len(lines):
        raise YamlError(f"unexpected text at {lines[pos][1]!r}")
    return out
